"""Device kernels a request (memory copies and sets not counted), from
the profiler's trace of the traced requests."""


def read(run):
    t = run.trace
    if t is None or not t.items or not t.kernels:
        return None
    return len(t.kernels) / t.items
