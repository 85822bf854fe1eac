"""Tracing / profiling helpers (the JAX package's ``utils_profiling.py``).

The reference's observability is per-rank cProfile dumps
(examples/test_mpi.py:10-11,32-37) and ad-hoc wall-clock prints.  Here:
structured phase timers plus optional ``torch.profiler`` traces of the
host and, where a card is present, the device.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    with timer.phase("descriptor"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        out = []
        for name, tot in rows:
            n = self.counts[name]
            out.append(f"{name:<24s} {tot:10.3f}s  x{n:<6d} "
                       f"{tot / n * 1e3:9.2f} ms/call")
        return "\n".join(out)

    def json(self) -> str:
        return json.dumps({k: {"total_s": v, "calls": self.counts[k]}
                           for k, v in self.totals.items()})


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the block (the CPU activity, and the
    CUDA activity when a card is present), written to ``logdir`` as a
    Chrome trace (open in chrome://tracing or Perfetto) when the block
    ends; logdir None traces nothing.  Yields the profiler (None when
    off), whose ``key_averages()`` sums the time by operation."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
