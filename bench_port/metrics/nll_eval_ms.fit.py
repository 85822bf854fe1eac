"""One NLL and gradient evaluation of ``GP.fit(opt=True)``: the span
around ``models.gp._nll_rbf_analytic``, mean ms."""
SPANS = {"nll_eval": "gpr_calculator_tpu_torch.models.gp:_nll_rbf_analytic"}


def read(run):
    return run.spans.mean_ms("nll_eval")
