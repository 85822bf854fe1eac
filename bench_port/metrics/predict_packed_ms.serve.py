"""The served block, GEMV and variance solve a request: the span around
``models.gp._predict_packed`` (K2/K3 through ``ops/kernels.k_block``),
mean ms."""
SPANS = {"predict_packed":
         "gpr_calculator_tpu_torch.models.gp:_predict_packed"}


def read(run):
    return run.spans.mean_ms("predict_packed")
