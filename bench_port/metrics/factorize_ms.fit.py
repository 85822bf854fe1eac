"""The refit's factorisation: from the start of the program's
``fit.factorize`` span (``_factorize``: K in float64, its Cholesky
factor and the weights) to the end of the last device operation
launched in it, mean ms over the window's fits."""
from bench_port import program_spans as ps

ps.recorder()


def read(run):
    w = ps.window(run, "fit", traced=True)
    if w is None or run.device.type != "cuda" or not run.trace.ops:
        return None
    ms = []
    for s in w.spans("fit.factorize"):
        ops = ps.ops_started_in(run.trace.ops, [s])
        if ops:
            ms.append(1e-6 * (max(b for _, _, b in ops) - s.start_ns))
    return sum(ms) / len(ms) if ms else None
