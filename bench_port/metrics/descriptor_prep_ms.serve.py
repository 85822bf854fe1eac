"""The descriptor's host preparation a request: the program's
``descriptor.prep`` spans (``SO3._prep_structure``: neighbour list and
index maps, host only), summed over each request of the window, mean
ms."""
from bench_port import program_spans as ps

ps.recorder()


def read(run):
    w = ps.window(run, "serve")
    if w is None:
        return None
    return w.total_ms("descriptor.prep") / len(w.roots)
