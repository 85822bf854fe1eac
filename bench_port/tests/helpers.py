"""Tiny versions of the benchmark's cells for the CPU tests: the real
configuration, traffic and limit files with the sizes cut (the synthetic
training set to 12 E + 30 F points of 6 envs; few requests, a short
sample) and the program on the CPU (its plain versions in place of the
card's kernels).  ``family="Dot"`` runs a cell's Dot variant: its
configuration with the Dot kernel at the program's defaults;
``draw_seed`` fixes a synthetic configuration's draw (``data.draw_seed``)."""
from __future__ import annotations

import copy
import functools
import time

from bench_port import harness

_CELL_SPEC = harness.cell_spec

# The fit cell's limits at the tiny size: the card's limits are set at
# n = 10 000, where float32 rounding and TF32 both read ~100x larger.
# Readings here (seed 7, CPU): the program 1.1e-9 / 3.3e-8 / 1.4e-7 /
# 6.4e-7, the control 5.9e-6 / 2.0e-5 / 1.2e-4 / 4.5e-4.
TINY_LIMITS = {"bench10k.fit": {"nll0_rel": 2e-7, "grad0_rel": 1e-6,
                                "theta_rel": 4e-6, "alpha_rel": 2e-5}}


# The Dot kernel of gpr_calculator_tpu_torch's models/kernels.py defaults.
DOT_KERNEL = {"name": "Dot", "zeta": 3, "theta0": [1.0, 1.0],
              "bounds": [[0.01, 50.0], [0.01, 10.0]]}


def tiny_spec(bench, workload, family=None, draw_seed=None):
    cell, cfg, traffic, limits = _CELL_SPEC(bench, workload)
    cfg, traffic = copy.deepcopy(cfg), dict(traffic)
    if family == "Dot":
        cfg["kernel"] = dict(DOT_KERNEL)
    if cfg["kind"] == "synthetic":
        cfg["data"].update(m_e=12, m_f=30, envs=6)
        if draw_seed is not None:
            cfg["data"]["draw_seed"] = draw_seed
    if traffic["kind"] == "serve":
        traffic.update(sample=3, max_requests=400, warmup=1,
                       trace_requests=3)
    return cell, cfg, traffic, TINY_LIMITS.get(workload, limits)


def run_tiny(monkeypatch, workload, seed=7, seconds=0.5, trace=False,
             backend=None, family=None, draw_seed=None):
    """One run of a tiny cell (its ``family`` variant, its draw fixed by
    ``draw_seed``) on the CPU: the result dict."""
    from gpr_calculator_tpu_torch import config
    monkeypatch.setattr(harness, "cell_spec",
                        functools.partial(tiny_spec, family=family,
                                          draw_seed=draw_seed))
    monkeypatch.setattr(config, "_DEVICE", None)
    config.set_device("cpu")
    return harness.run_cell(harness.benchmark(), workload, seed, seconds,
                            trace, "cpu", time.perf_counter(),
                            backend=backend)
