"""The Dot training covariance's share of its roofline: the least time of
the Dot NLL's build (K1-dot, K2-dot in float32, K_EE in float64, counted
from the training set's env pairs by ``work.py``) over the mean device
time of the program's ``nll.k_self`` spans, %.  The host leaves that span
long before the card has run the build, so a span's device time is read
from the two timing events the program records on the card's stream at
its ends (``utils_profiling.device_ms``): the work launched inside it.
Nothing where the program has no such span or events."""
from bench_port import program_spans as ps
from bench_port import work

up = ps.recorder()


def read(run):
    w = ps.window(run, "fit", traced=True)
    device_ms = getattr(up, "device_ms", None)
    if w is None or device_ms is None or run.device.type != "cuda" \
            or not run.inputs:
        return None
    ms = [device_ms(s) for s in w.spans("nll.k_self")]
    ms = [t for t in ms if t]
    if not ms:
        return None
    mean_s = 1e-3 * sum(ms) / len(ms)
    return 100.0 * work.cov_bound_s(run.inputs, dual=False) / mean_s
