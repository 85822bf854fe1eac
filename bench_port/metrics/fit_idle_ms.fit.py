"""The device's idle time a fit outside the NLL: the time inside the
program's ``fit`` spans and outside its ``nll.eval`` spans in which no
operation ran on the device (``_pack``, the L-BFGS-B host steps, the
host side of ``_factorize``), mean ms a fit."""
import numpy as np

from bench_port import program_spans as ps

ps.recorder()


def read(run):
    w = ps.window(run, "fit", traced=True)
    if w is None or run.device.type != "cuda" or not run.trace.ops:
        return None
    busy = np.asarray(run.trace.busy_intervals, dtype=np.int64)
    idle = 0
    for fit in w.roots:
        idle += ps.idle_ns(busy, fit.start_ns, fit.end_ns)
        for e in w.spans("nll.eval", within=fit):
            idle -= ps.idle_ns(busy, e.start_ns, e.end_ns)
    return 1e-6 * idle / len(w.roots)
