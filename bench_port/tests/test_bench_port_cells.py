"""CPU tests of the benchmark: every cell's traffic and a whole run at a
tiny size with the program's plain versions, also as the cell's Dot
variant, the result's keys, the control and the planted faults coming
out not correct, and the module checks (no JAX, a reference that imports
nothing of the program)."""
from __future__ import annotations

import copy
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import harness
from bench_port.backends import Port, Reference
from bench_port.tests.helpers import TINY_LIMITS, run_tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
# every cell as it is (None: the configuration's family) and its Dot variant
VARIANTS = [(w, f) for w in CELLS for f in (None, "Dot")]
VARIANT_IDS = [w if f is None else f"{w}-{f}" for w, f in VARIANTS]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,family", VARIANTS, ids=VARIANT_IDS)
def test_tiny_run_is_correct(monkeypatch, workload, family):
    r = run_tiny(monkeypatch, workload, family=family)
    assert list(r) == KEYS
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(BENCH, workload, False)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    limits = harness.load_json(
        harness.HERE / "limits" / f"{workload}.json")
    assert set(r["checks"]) == set(limits)
    assert set(TINY_LIMITS.get(workload, limits)) == set(limits)


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_traced_run_reads_spans(monkeypatch, workload):
    r = run_tiny(monkeypatch, workload, trace=True)
    assert list(r) == KEYS[:5] + ["breakdown", "checks"]
    assert r["correct"], r["checks"]
    per_layer = {m["name"] for m in harness.cell_metrics(BENCH, workload,
                                                         True)}
    # on the CPU only the host spans have something to read
    assert set(r["metrics"]) <= per_layer
    spans = {n for n in per_layer if n.endswith("_ms.serve")
             or n == "nll_eval_ms.fit"}
    assert spans <= set(r["metrics"])


@pytest.mark.parametrize("workload,family", VARIANTS, ids=VARIANT_IDS)
def test_control_is_not_correct(monkeypatch, workload, family):
    """The reference in TF32, with the configuration's family, in the
    program's place."""
    r = run_tiny(monkeypatch, workload,
                 backend=functools.partial(Reference, prec="tf32"),
                 family=family)
    assert not r["correct"], r["checks"]


class _AlteredAnswer(Port):
    """Each answer altered where it is produced: E off by 0.1 eV, the
    first free atom's force lost."""

    def serve(self, positions):
        E, F, sE, sF = super().serve(positions)
        F = F.copy()
        F[0] = 0.0
        return E + 0.1, F, sE, sF


class _StateUnchanged(Port):
    """L-BFGS-B's step returns theta0: the fit leaves the state."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        import types

        def still(gp, fun, theta0, bounds, maxiter=10):
            fun(theta0)
            return types.SimpleNamespace(x=np.asarray(theta0, float),
                                         fun=0.0, status=0)
        self.gp._minimize = types.MethodType(still, self.gp)


class _HalfBatch(Port):
    """Half the training set's force points left out of the fit."""

    def __init__(self, system, *args, **kwargs):
        super().__init__(system, *args, **kwargs)
        gp = self.gp
        keep = {"energy": [(x, e, z) for (x, z), e in
                           zip(gp._energy_pts, gp._energy_y)],
                "force": [(x, dx, f, z) for (x, dx, z), f in
                          zip(gp._force_pts, gp._force_y)][::2]}
        gp.set_train_pts(keep)


class _WrongFamily(Port):
    """The program's GP built with the RBF kernel where the configuration
    names the Dot kernel (theta0, bounds and zeta as it states them)."""

    def __init__(self, system, *args, **kwargs):
        assert system.family == "Dot"
        wrong = copy.copy(system)
        wrong.family = "RBF"
        super().__init__(wrong, *args, **kwargs)
        assert self.gp.kernel.name == "RBF"


FAULTS = [("auAl13.serve", _AlteredAnswer, None),
          ("auAl13.serve", _StateUnchanged, None),
          ("bench10k.serve", _AlteredAnswer, None),
          ("bench10k.serve", _HalfBatch, None),
          ("bench10k.fit", _StateUnchanged, None),
          ("bench10k.fit", _HalfBatch, None)] + [
    (w, _WrongFamily, "Dot") for w in CELLS]


@pytest.mark.parametrize("workload,fault,family", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f, _ in FAULTS])
def test_fault_is_not_correct(monkeypatch, workload, fault, family):
    r = run_tiny(monkeypatch, workload, backend=fault, family=family)
    assert not r["correct"], r["checks"]


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["gpr_calculator_tpu_torch", "gpr_calculator_tpu_torch.ops.kff",
            "jaxtyping", "numpy", "bench_port.run"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(
        mods + ["jax.numpy", "jaxlib", "flax.linen", "gpr_calculator_tpu",
                "gpr_calculator_tpu.ops"]) == [
        "flax.linen", "gpr_calculator_tpu", "gpr_calculator_tpu.ops",
        "jax.numpy", "jaxlib"]


def _python(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax():
    """A whole tiny run of every cell, in a fresh process: nothing loaded
    has JAX or the JAX package as its top-level name."""
    code = (
        "import sys, time, json\n"
        "import torch; torch.set_num_threads(2)\n"
        "from bench_port import harness\n"
        "from bench_port.tests import helpers\n"
        "from gpr_calculator_tpu_torch import config\n"
        "config.set_device('cpu')\n"
        "harness.cell_spec = helpers.tiny_spec\n"
        "b = harness.benchmark()\n"
        "for c in b['workloads']:\n"
        "    harness.run_cell(b, c['name'], 3, 0.3, True, 'cpu',"
        " time.perf_counter())\n"
        "print(json.dumps(harness.forbidden_modules(sys.modules)))\n")
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys, importlib, pkgutil, json\n"
        "import bench_port.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module('bench_port.reference.' + m.name)\n"
        "print(json.dumps(sorted(k for k in sys.modules"
        " if k.split('.')[0].startswith('gpr_calculator_tpu'))))\n")
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""

