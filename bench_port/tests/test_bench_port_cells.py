"""CPU tests of the benchmark: every cell's traffic and a whole run at a
tiny size with the program's plain versions, also as the cell's Dot
variant and, for a fit cell, with its draw fixed (``data.draw_seed``),
the result's keys, the control and the planted faults coming out not
correct, the synthetic draws, and the module checks (no JAX, a reference
that imports nothing of the program)."""
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
from bench_port.drivers import fit
from bench_port.systems import synthetic
from bench_port.tests.helpers import TINY_LIMITS, run_tiny, tiny_spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
FIT_CELLS = [w for w in CELLS if harness.cell_spec(BENCH, w)[2]["kind"]
             == "fit"]
# every cell as it is (None: the configuration's family) and its Dot
# variant; each fit cell also with its draw fixed (draw_seed 0)
VARIANTS = [(w, f, None) for w in CELLS for f in (None, "Dot")] + [
    (w, f, 0) for w in FIT_CELLS for f in (None, "Dot")]
VARIANT_IDS = ["-".join([w] + ([f] if f else [])
                        + ([f"draw{d}"] if d is not None else []))
               for w, f, d in VARIANTS]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload,family,draw_seed", VARIANTS,
                         ids=VARIANT_IDS)
def test_tiny_run_is_correct(monkeypatch, workload, family, draw_seed):
    r = run_tiny(monkeypatch, workload, family=family, draw_seed=draw_seed)
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


@pytest.mark.parametrize("workload,family,draw_seed", VARIANTS,
                         ids=VARIANT_IDS)
def test_control_is_not_correct(monkeypatch, workload, family, draw_seed):
    """The reference in TF32, with the configuration's family, in the
    program's place."""
    r = run_tiny(monkeypatch, workload,
                 backend=functools.partial(Reference, prec="tf32"),
                 family=family, draw_seed=draw_seed)
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


FAULTS = [("auAl13.serve", _AlteredAnswer, None, None),
          ("auAl13.serve", _StateUnchanged, None, None),
          ("bench10k.serve", _AlteredAnswer, None, None),
          ("bench10k.serve", _HalfBatch, None, None),
          ("bench10k.fit", _StateUnchanged, None, None),
          ("bench10k.fit", _HalfBatch, None, None)] + [
    (w, _WrongFamily, "Dot", None) for w in CELLS] + [
    (w, _WrongFamily, "Dot", 0) for w in FIT_CELLS]
FAULT_IDS = ["-".join([w, f.__name__] + ([f"draw{d}"] if d is not None
                                         else []))
             for w, f, _, d in FAULTS]


@pytest.mark.parametrize("workload,fault,family,draw_seed", FAULTS,
                         ids=FAULT_IDS)
def test_fault_is_not_correct(monkeypatch, workload, fault, family,
                              draw_seed):
    r = run_tiny(monkeypatch, workload, backend=fault, family=family,
                 draw_seed=draw_seed)
    assert not r["correct"], r["checks"]


def _parents_draw(dat, seed):
    """The training set as drawn before ``data.draw_seed`` existed, copied:
    the configuration without the key must still get exactly this."""
    m_e, m_f, envs, d = dat["m_e"], dat["m_f"], dat["envs"], dat["d"]
    rs = np.random.RandomState(int(seed) % 2 ** 32)
    f32 = np.float32
    ex = rs.uniform(*dat["x_range"], (m_e, envs, d)).astype(f32)
    ee = rs.choice(dat["elements"], (m_e, envs))
    fx = rs.uniform(*dat["x_range"], (m_f, envs, d)).astype(f32)
    fd = rs.uniform(*dat["dxdr_range"], (m_f, envs, d, 3)).astype(f32)
    fe = rs.choice(dat["elements"], (m_f, envs))
    rl = np.random.RandomState((int(seed) + 100) % 2 ** 32)
    sd = dat["label_std"]
    ye = np.array([rl.normal(0.0, sd) for _ in range(m_e)])
    yf = np.stack([rl.normal(0.0, sd, 3) for _ in range(m_f)])
    return {"ex": ex, "ee": ee, "fx": fx, "fd": fd, "fe": fe, "ye": ye,
            "yf": yf}


SYNTHETIC = next(cfg for cfg in (harness.cell_spec(BENCH, w)[1]
                                  for w in CELLS)
                 if cfg["kind"] == "synthetic")


def _synthetic(seed, draw_seed=None):
    """A synthetic configuration's system at its own sizes, without the key
    or with ``draw_seed``."""
    cfg = copy.deepcopy(SYNTHETIC)
    cfg["data"].pop("draw_seed", None)
    if draw_seed is not None:
        cfg["data"]["draw_seed"] = draw_seed
    return cfg, synthetic.System(cfg, seed, torch.device("cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_synthetic_draw_without_the_key_is_the_seeds(seed):
    cfg, system = _synthetic(seed)
    want = _parents_draw(cfg["data"], seed)
    for name, a in want.items():
        b = getattr(system, name)
        assert b.dtype == a.dtype and np.array_equal(b, a), name


def _rows(system):
    """Each side's points as rows (descriptors, Jacobians, elements) and
    their labels, both sorted by the rows."""
    m_e, m_f = len(system.ex), len(system.fx)
    e = np.c_[system.ex.reshape(m_e, -1), system.ee]
    f = np.c_[system.fx.reshape(m_f, -1), system.fd.reshape(m_f, -1),
              system.fe]

    def order(rows):
        return np.array(sorted(range(len(rows)),
                               key=lambda i: rows[i].tobytes()))
    oe, of = order(e), order(f)
    return e[oe], system.ye[oe], f[of], system.yf[of]


def test_synthetic_draw_seed_fixes_the_points():
    """With ``draw_seed`` the run's seeds draw one training set: the same
    points (``draw_seed`` 0: seed 0's draw), each side in an order of the
    run's seed, every label times one sign of the run's seed."""
    _, base = _synthetic(0)
    be, bye, bf, byf = _rows(base)
    signs, orders = set(), {(base.ex[:, 0, 0].tobytes(),
                             base.fx[:, 0, 0].tobytes())}
    seeds = (1, 2, 3, 4, 5, 6, 2 ** 31 + 9)
    for seed in seeds:
        _, s = _synthetic(seed, draw_seed=0)
        e, ye, f, yf = _rows(s)
        assert np.array_equal(e, be) and np.array_equal(f, bf)
        sign = ye[0] / bye[0]
        assert sign in (-1.0, 1.0)
        assert np.array_equal(ye, sign * bye)
        assert np.array_equal(yf, sign * byf)
        signs.add(sign)
        orders.add((s.ex[:, 0, 0].tobytes(), s.fx[:, 0, 0].tobytes()))
    assert signs == {-1.0, 1.0}
    # each seed its own order of each side, none the draw's own
    assert len({e for e, _ in orders}) == len({f for _, f in orders}) \
        == len(seeds) + 1


# float32: the K blocks' rounding follows the GEMM's tiling, so the order
# of the points moves theta* and the NLL by float32 rounding (read here:
# 8e-8 and 2e-9); float64: the factorisation's rounding alone
SAME_FIT_TOL = {"float32": (1e-6, 1e-7), "float64": (1e-9, 1e-12)}


@pytest.mark.parametrize("dtype", sorted(SAME_FIT_TOL))
@pytest.mark.parametrize("family", [None, "Dot"])
@pytest.mark.parametrize("workload", FIT_CELLS)
def test_draw_seed_gives_every_seed_the_same_fit(monkeypatch, workload,
                                                 family, dtype):
    """The tiny fit cell with its draw fixed, through the driver's set-up
    fit, on 4 run seeds: the same evaluation count, theta* and first NLL
    (to rounding)."""
    from gpr_calculator_tpu_torch import config
    monkeypatch.setattr(config, "_DEVICE", None)
    config.set_device("cpu")
    _, cfg, traffic, _ = tiny_spec(BENCH, workload, family=family,
                                   draw_seed=0)
    cfg["dtype"] = dtype
    fits = []
    for seed in (11, 12, 13, 2 ** 31 + 14):
        run = harness.Run(traffic, seed, 0.0, False, torch.device("cpu"))
        st = fit.setup(run, harness.system_module(cfg).System(
            cfg, seed, run.device))
        evals = st.backend.evals[-1]
        fits.append((len(evals), st.backend.theta(), evals[0][1]))
    theta_tol, nll_tol = SAME_FIT_TOL[dtype]
    n0, theta0, nll0 = fits[0]
    for n, theta, nll in fits[1:]:
        assert n == n0
        assert np.max(np.abs(theta - theta0) / np.abs(theta0)) < theta_tol
        assert abs(nll - nll0) / abs(nll0) < nll_tol


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

