"""The training covariance's share of its roofline: the least time of
``ops/kernels.k_self_dual``'s blocks (K1-dual, K2-dual in float32, K_EE
in float64, counted from the training set's env pairs by ``work.py``) over
the mean time of the span around it, %."""
from bench_port import work

SPANS = {"k_self_dual": "gpr_calculator_tpu_torch.ops.kernels:k_self_dual"}


def read(run):
    if run.device.type != "cuda":
        return None
    ms = run.spans.mean_ms("k_self_dual")
    if not ms or not run.inputs:
        return None
    return 100.0 * work.cov_bound_s(run.inputs, dual=True) / (ms * 1e-3)
