"""The served variance's device time a request: the device busy time of
the operations launched under the program's ``predict.solve`` span (the
prior and the triangular solve against the float64 factor in
``_predict_packed``), per profiled request, ms.  On the CPU, where an
operation runs as it is launched, the span's own time."""
from bench_port import program_spans as ps

ps.recorder()


def read(run):
    w = ps.window(run, "serve", traced=True)
    if w is None:
        return None
    if run.device.type == "cpu":
        return w.total_ms("predict.solve") / len(w.roots)
    if not run.trace.ops:
        return None
    ops = ps.ops_started_in(run.trace.ops, w.spans("predict.solve"))
    return 1e-6 * sum(b - a for _, a, b in ops) / len(w.roots)
