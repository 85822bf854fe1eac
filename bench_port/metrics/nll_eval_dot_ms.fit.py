"""One NLL and gradient evaluation of a Dot ``GP.fit(opt=True)``: the
program's ``nll.eval`` spans (``models.gp.GP._objective``, each ending
with its value and gradient on the host), each from its start to the end
of the last device operation started in it, mean ms over the traced
window's fits."""
from bench_port import program_spans as ps

ps.recorder()


def read(run):
    w = ps.window(run, "fit", traced=True)
    if w is None or run.device.type != "cuda" or not run.trace.ops:
        return None
    ms = []
    for s in w.spans("nll.eval"):
        ops = ps.ops_started_in(run.trace.ops, [s])
        if ops:
            ms.append(1e-6 * (max(b for _, _, b in ops) - s.start_ns))
    return sum(ms) / len(ms) if ms else None
