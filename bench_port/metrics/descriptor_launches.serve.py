"""Device kernels a request launched under the program's ``descriptor``
span (``SO3.calculate_many_device`` and the rounding of its output:
``descriptor.prep`` and ``descriptor.core`` inside it), per profiled
request; memory copies and sets not counted, as ``launches.serve``."""
from bench_port import program_spans as ps

ps.recorder()


def read(run):
    w = ps.window(run, "serve", traced=True)
    if w is None or not run.trace.kernels:
        return None
    ops = ps.ops_started_in(run.trace.kernels, w.spans("descriptor"))
    return len(ops) / len(w.roots)
