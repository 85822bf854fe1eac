"""What the readers of the program's own spans and counters share.

While its recorder is on, the program keeps a record of each span and
counter bump in ``gpr_calculator_tpu_torch.utils_profiling``: (name,
start_ns, end_ns, depth, id, n) on the clock of the device trace's
operations (Unix-epoch ns), the records of one served call or one fit
sharing an id.  A reader calls ``recorder()`` when it is loaded, which
switches the recorder on; the harness loads readers for traced runs
only, so the runs that give the end-to-end metrics record nothing.  A
program without the recorder gives None here, and its readers read
nothing.

A device operation of ``run.trace.ops`` belongs to the program span open
at the operation's start.  The trace holds no runtime-API record of the
launch, so an operation that waited in the stream behind another counts
for the span open when it started, not the one that launched it.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

# the outermost span of a request or fit, and the run counter of how
# many the window made (the drivers' ``requests`` / ``fits``)
ROOTS = {"serve": "requests", "fit": "fits"}

_up = None


def recorder():
    """The program's span recorder, switched on; None where the program
    has none."""
    global _up
    try:
        from gpr_calculator_tpu_torch import utils_profiling as up
    except ImportError:
        return None
    if not hasattr(up, "records"):
        return None
    up.enable()
    _up = up
    return up


class Window:
    """A window's outermost spans (``roots``, in order) and every record
    that shares an id with one of them."""

    def __init__(self, roots, recs):
        self.roots = roots
        ids = {r.id for r in roots}
        self.by_name = defaultdict(list)
        for r in recs:
            if r.id in ids:
                self.by_name[r.name].append(r)

    def spans(self, name, within=None):
        """The records named ``name``, those of the root ``within`` only
        when it is given."""
        out = self.by_name.get(name, [])
        return out if within is None else [r for r in out
                                           if r.id == within.id]

    def total_ms(self, name):
        """The durations of the spans named ``name`` summed, ms."""
        return 1e-6 * sum(r.end_ns - r.start_ns for r in self.spans(name))


def window(run, root, traced=False):
    """The Window of the run's requests (root "serve") or fits ("fit"):
    the last roots the program recorded, as many as the driver counted in
    the window; traced=True: the first ``run.trace.items`` of them, which
    the profiler saw.  None without the recorder, the count or, for
    traced, the trace."""
    if _up is None:
        return None
    n = run.counters.get(ROOTS[root])
    if not n or traced and (run.trace is None or not run.trace.items):
        return None
    recs = _up.records()
    roots = [r for r in recs if r.name == root and r.depth == 0]
    if len(roots) < n:
        return None
    roots = roots[-n:]
    if traced:
        roots = roots[:run.trace.items]
    return Window(roots, recs)


def ops_started_in(ops, spans):
    """The operations (name, start, end) whose start lies inside one of
    the spans (which do not overlap one another)."""
    if not ops or not spans:
        return []
    starts = np.array([o[1] for o in ops], dtype=np.int64)
    out = []
    for s in spans:
        lo = np.searchsorted(starts, s.start_ns, "left")
        hi = np.searchsorted(starts, s.end_ns, "right")
        out.extend(ops[lo:hi])
    return out


def idle_ns(busy, a, b):
    """The time in [a, b] not covered by the merged busy intervals."""
    if b <= a:
        return 0
    if len(busy) == 0:
        return b - a
    lo = np.clip(busy[:, 0], a, b)
    hi = np.clip(busy[:, 1], a, b)
    return int((b - a) - (hi - lo).sum())
