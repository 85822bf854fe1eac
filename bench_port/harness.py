"""The benchmark's machinery, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
whose ``kind`` picks the module of ``systems/`` that makes its inputs
from the seed) and a traffic mix (``traffic/<name>.json``, whose ``kind``
picks the driver of ``drivers/`` that runs it); its limits are in
``limits/<cell>.json`` and each per-layer metric is a reader of its own,
``metrics/<metric>.py``.  ``run_cell`` makes the inputs, sets the program
up, measures the window, reads the peak memory, frees the program and
then holds what the window produced against the plain reference.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import tempfile
import time
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpr_calculator_tpu")


def forbidden_modules(modules) -> list:
    """The names in ``modules`` whose top-level package (the part before
    the first dot, compared whole) is JAX or the JAX package."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def cell_spec(bench, workload):
    """(cell, config file, traffic file, limits) of a workload name."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return cell, cfg, traffic, limits


def cell_metrics(bench, workload, trace: bool):
    """The metric entries a run of ``workload`` reports: its end-to-end
    ones (``--trace 0``) or its per-layer ones (``--trace 1``)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def load_reader(name):
    """The module ``metrics/<name>.py``: ``SPANS`` (span name -> "module:
    attribute path" of the function whose calls it times) and
    ``read(run)`` -> a number, or None when the run has nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log_file():
    """The program's log, under TMPDIR."""
    return os.path.join(tempfile.gettempdir(), "bench_port_gp.log")


def sync(device):
    """Wait for the card (nothing on the CPU)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# spans: wrappers around the program's functions, installed for traced runs
# ---------------------------------------------------------------------------

class Spans:
    """Host-clock spans around functions of the program, each ended by a
    synchronise on both edges: durations (s) by span name, and (name,
    start, end) in time.time_ns for labelling the trace's idle gaps."""

    def __init__(self, device):
        self.device = device
        self.durations = defaultdict(list)
        self.intervals = []
        self._patched = []
        self.depth = 0

    def wrap(self, name, fn):
        spans = self

        def wrapped(*args, **kwargs):
            sync(spans.device)
            t0, w0 = time.perf_counter(), time.time_ns()
            spans.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                sync(spans.device)
                spans.depth -= 1
                spans.durations[name].append(time.perf_counter() - t0)
                spans.intervals.append((name, w0, time.time_ns(),
                                        spans.depth))
        wrapped.__wrapped__ = fn
        return wrapped

    def install(self, spans: dict):
        """spans: {name: "module:attr.path"}."""
        for name, target in spans.items():
            mod_name, path = target.split(":")
            parent = importlib.import_module(mod_name)
            *owners, attr = path.split(".")
            for owner in owners:
                parent = getattr(parent, owner)
            orig = parent.__dict__[attr] if isinstance(parent, type) \
                else getattr(parent, attr)
            setattr(parent, attr, self.wrap(name, orig))
            self._patched.append((parent, attr, orig))

    def remove(self):
        for parent, attr, orig in reversed(self._patched):
            setattr(parent, attr, orig)
        self._patched.clear()

    def mean_ms(self, name):
        d = self.durations.get(name)
        return 1e3 * statistics.fmean(d) if d else None


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

class Trace:
    """What ``torch.profiler`` saw on the device over a traced part of the
    window: device operations (name, start ns, end ns), ``items`` the
    requests or fits it covered, ``window_s`` its length."""

    def __init__(self, ops, window_s, items, spans=()):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.window_s = window_s
        self.items = items
        self.spans = list(spans)
        self.busy_intervals = self._merge()
        self.busy_s = sum(b - a for a, b in self.busy_intervals) * 1e-9

    def _merge(self):
        out = []
        for _, a, b in self.ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def kernels(self):
        return [o for o in self.ops if not o[0].startswith(("Memcpy",
                                                            "Memset"))]

    def idle_pct(self):
        if self.window_s <= 0 or not self.ops:
            return None
        return 100.0 * max(0.0, 1.0 - self.busy_s / self.window_s)

    def top_ops(self, n=10):
        tot = defaultdict(float)
        for name, a, b in self.ops:
            tot[name] += (b - a) * 1e-9
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """Idle time between device operations, summed by the innermost
        host span open at each gap's middle ("no span": the client's own
        work between calls)."""
        b = np.asarray(self.busy_intervals, dtype=np.int64).reshape(-1, 2)
        if len(b) < 2:
            return []
        mid = (b[:-1, 1] + b[1:, 0]) // 2
        gap = (b[1:, 0] - b[:-1, 1]) * 1e-9
        names = ["no span"]
        label = np.zeros(len(mid), int)
        lo, hi = b[0, 0], b[-1, 1]
        spans = [s for s in self.spans if s[2] >= lo and s[1] <= hi]
        if spans:
            names += [s[0] for s in spans]
            s0 = np.array([s[1] for s in spans])
            s1 = np.array([s[2] for s in spans])
            dep = np.array([s[3] for s in spans])
            m = mid[:, None]
            inside = (s0[None, :] <= m) & (m <= s1[None, :])
            score = np.where(inside, dep[None, :], -1)
            best = score.argmax(1)
            label = np.where(score.max(1) >= 0, best + 1, 0)
        tot = defaultdict(float)
        for i, g in zip(label, gap):
            tot[names[i]] += float(g)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]


class Profiler:
    """torch.profiler over the device alone (CUDA activity): CUPTI's
    records, little cost on the host.  On the CPU (the tests) it records
    the host's operations, and ``ops`` finds no device operation."""

    def __init__(self, device):
        self.device = device
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        sync(self.device)
        act = ProfilerActivity.CUDA if self.device.type == "cuda" \
            else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self.prof.__exit__(*exc)
        return False

    def ops(self):
        """(name, start ns, end ns) of every device operation."""
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type().name != "CUDA":
                continue
            a = ev.start_ns()
            out.append((ev.name(), a, a + ev.duration_ns()))
        return out


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

class Run:
    """One run of a cell: its spec, seed and settings, and what it
    recorded for the metric readers (``spans``, ``trace``, ``counters``,
    ``inputs``)."""

    def __init__(self, traffic, seed, seconds, trace, device):
        self.traffic = traffic
        self.seed, self.seconds, self.traced = int(seed), seconds, trace
        self.device = device
        self.spans = Spans(device)
        self.trace = None
        self.counters = {}
        self.inputs = {}


def system_module(cfg):
    return importlib.import_module(f"bench_port.systems.{cfg['kind']}")


def driver_module(traffic):
    return importlib.import_module(f"bench_port.drivers.{traffic['kind']}")


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    file names: each within its limit; one the check did not produce, or
    that is not finite, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = values.get(name, math.nan)
        out[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or value > limit:
            ok = False
    return ok, out


def run_cell(bench, workload, seed, seconds, trace, device, t_start,
             backend=None, counters=None):
    """Run one cell and return its result dict (the contract's keys, the
    checks last).  backend: None for the program; the control and the
    fault tests put another object in the program's place.  counters: a
    dict that receives the run's counters."""
    import torch
    cell, cfg, traffic, limits = cell_spec(bench, workload)
    run = Run(traffic, seed, seconds, trace, torch.device(device))
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics} \
        if trace else {}
    system = system_module(cfg).System(cfg, run.seed, run.device)
    driver = driver_module(traffic)
    state = driver.setup(run, system, backend)
    spans = {}
    for reader in readers.values():
        spans.update(getattr(reader, "SPANS", {}))
    run.spans.install(spans)
    sync(run.device)
    setup_s = time.perf_counter() - t_start
    try:
        e2e, attempted, failed = driver.window(run, state)
    finally:
        run.spans.remove()
    mem_peak = (torch.cuda.max_memory_allocated(run.device)
                if run.device.type == "cuda" else 0)
    driver.release(state)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    values = driver.check(run, state, system)
    if counters is not None:
        counters.update(run.counters, check_values=values)
    correct, checks = judge(values, limits)

    units = {m["name"]: m["unit"] for m in metrics}
    out = {}
    if trace:
        for name, reader in readers.items():
            v = reader.read(run)
            if v is not None:
                out[name] = {"value": v, "unit": units[name]}
    else:
        e2e["setup_s"] = setup_s
        out = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()
               if k in units}
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct and failed == 0),
              "attempted": attempted, "failed": failed, "metrics": out,
              "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = checks
    return result
