"""Tracing / profiling: the port's span recorder and ``torch.profiler``
traces (the JAX package's ``utils_profiling.py``).

The reference's observability is per-rank cProfile dumps
(examples/test_mpi.py:10-11,32-37) and ad-hoc wall-clock prints.  Here:

- a span recorder, off by default (``enable()`` / ``disable()``).  The
  program opens a span at each layer boundary (``with span("predict"):``)
  and bumps a counter where it learns a count (``count("lbfgs.nfev",
  res.nfev)``).  Off, ``span`` checks one flag and returns a shared no-op
  context: no clock read, no allocation, no record.  On, a span keeps a
  ``Record`` (name, start_ns, end_ns, depth, id, n) in a buffer of the
  last ``CAP`` records and, while a ``torch.profiler`` profile is open,
  opens ``torch.profiler.record_function(name)``, so its trace shows the
  program's layers above the device operations.
  Its clock is ``time.time_ns`` (Unix-epoch ns), the clock of the kineto
  events' ``start_ns()`` that ``torch.profiler`` gives for host and
  device operations alike, so a span and the device operations it
  launched compare directly.  A span never synchronises: a layer's device
  time comes from the device trace.  Where the host leaves a span before
  the card has run what it launched there, the trace gives those
  operations to later spans; a span opened with ``device=`` also records
  a timing CUDA event on the card's stream as it opens and as it closes
  (no wait), and ``device_ms(record)`` reads, once the window is over,
  the device time of the work launched inside it.  Spans nested in one
  another share the outermost one's id (one a served call, one a fit);
  ``n`` is a number the span carries (structures served, an evaluation's
  index).
  A counter is a plain integer in ``counters``; each bump is also kept
  as a record whose start and end are the moment of the bump and whose
  ``n`` is the amount added.
- ``device_trace``: a ``torch.profiler`` Chrome trace of a block.
"""
from __future__ import annotations

import collections
import contextlib
import json as _json
import os
import time
from typing import NamedTuple, Optional

import torch

# the last CAP records are kept, and a reader needs every request of a
# window: a served request makes 13 (9 spans, 4 counters), and a 30 s
# window of 2.6 ms requests ~150 000 of them (NVIDIA H100 80GB HBM3,
# 700.00 W), where 2^17 lost the oldest requests' records
CAP = 1 << 19
clock = time.time_ns


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    depth: int
    id: int
    n: Optional[int]
    marks: Optional[tuple] = None   # a span's two CUDA events (device=)


_profiling = torch._C._autograd._profiler_enabled
_on = False
_records: collections.deque = collections.deque(maxlen=CAP)
_stack: list = []
_last_id = 0
counters: dict = {}


def enable():
    """Switch the recorder on."""
    global _on
    _on = True


def disable():
    """Switch the recorder off (what it recorded stays)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear():
    """Forget every record and counter."""
    _records.clear()
    counters.clear()


def records() -> list:
    """The kept records, oldest first."""
    return list(_records)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "device", "marks", "start_ns", "end_ns",
                 "depth", "id", "_rf")

    def __init__(self, name, n, device):
        self.name, self.n, self.device = name, n, device

    def __enter__(self):
        global _last_id
        if _stack:
            self.id = _stack[-1].id
        else:
            _last_id += 1
            self.id = _last_id
        self.depth = len(_stack)
        _stack.append(self)
        # a record_function costs ~9 us: opened only where a profiler
        # records it
        self._rf = torch.profiler.record_function(self.name) \
            if _profiling() else None
        if self._rf is not None:
            self._rf.__enter__()
        self.start_ns = clock()
        self.marks = None if self.device is None \
            else device_mark(self.device)
        return self

    def __exit__(self, *exc):
        if self.marks is not None:
            self.marks = (self.marks, device_mark(self.device))
        self.end_ns = clock()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack.pop()
        _records.append(Record(self.name, self.start_ns, self.end_ns,
                               self.depth, self.id, self.n, self.marks))
        return False


def span(name: str, n: Optional[int] = None, device=None):
    """A context that records the block as span ``name`` when the
    recorder is on; ``with span(...) as s`` gives the span (its
    ``start_ns`` / ``end_ns`` once closed), or None when off.  device: on
    a card, the span's record also keeps a timing event recorded on the
    device's current stream at each end (``device_ms``)."""
    if not _on:
        return _OFF
    return _Span(name, n, device)


def device_ms(record) -> Optional[float]:
    """The device ms between the two events of a span opened with
    ``device=`` on a card: the work launched inside it, from where the
    stream reached the span's start to where it reached its end (waits
    for the later event); None for a span without them."""
    if record.marks is None:
        return None
    start, end = record.marks
    end.synchronize()
    return start.elapsed_time(end)


def count(name: str, n: int = 1):
    """Add n to counter ``name`` when the recorder is on."""
    if not _on:
        return
    counters[name] = counters.get(name, 0) + n
    t = clock()
    _records.append(Record(name, t, t, len(_stack),
                           _stack[-1].id if _stack else 0, n))


def device_mark(device):
    """A timing CUDA event recorded now on ``device``'s current stream, or
    None on the CPU: with another, ``elapsed_time`` reads the device time
    between them once the later one is waited for.  Recording it does not
    wait."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def summary() -> dict:
    """By span name, calls, total ms and ms a call over the kept records;
    the counters beside them."""
    calls = collections.Counter()
    total = collections.defaultdict(int)
    for r in _records:
        if r.name not in counters:
            calls[r.name] += 1
            total[r.name] += r.end_ns - r.start_ns
    spans = {k: {"calls": c, "total_ms": total[k] * 1e-6,
                 "ms_per_call": total[k] * 1e-6 / c}
             for k, c in calls.items()}
    return {"spans": spans, "counters": dict(counters)}


def report() -> str:
    """The summary as a table, the longest total first."""
    s = summary()
    rows = sorted(s["spans"].items(), key=lambda kv: -kv[1]["total_ms"])
    out = [f"{name:<24s} {v['total_ms']:12.3f} ms  x{v['calls']:<7d} "
           f"{v['ms_per_call']:10.3f} ms/call" for name, v in rows]
    out += [f"{name:<24s} {v:d}" for name, v in sorted(s["counters"].items())]
    return "\n".join(out)


def json() -> str:
    """The summary as JSON."""
    return _json.dumps(summary())


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the block (the CPU activity, and the
    CUDA activity when a card is present), written to ``logdir`` as a
    Chrome trace (open in chrome://tracing or Perfetto) when the block
    ends; logdir None traces nothing.  Yields the profiler (None when
    off), whose ``key_averages()`` sums the time by operation.  With the
    recorder on, the program's spans show in it above the operations."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
