"""Descriptor time a request: the span around ``SO3.calculate_many_device``
(one call a served structure), mean ms."""
SPANS = {"descriptor":
         "gpr_calculator_tpu_torch.ops.so3:SO3.calculate_many_device"}


def read(run):
    return run.spans.mean_ms("descriptor")
