"""The whole fit's share of the card's peaks: the least time of a fit's
work (its NLL evaluations, counted by the harness, and one
factorisation: ``work.fit_bound_s``) over the mean time of the span
around ``GP.fit``, %."""
from bench_port import work

SPANS = {"fit": "gpr_calculator_tpu_torch.models.gp:GP.fit"}


def read(run):
    if run.device.type != "cuda":
        return None
    ms = run.spans.mean_ms("fit")
    fits = run.counters.get("fits")
    if not ms or not fits or not run.inputs:
        return None
    evals = run.counters["nll_evals"] / fits
    return 100.0 * work.fit_bound_s(run.inputs, evals) / (ms * 1e-3)
