"""The served variance from the kept inverse factor L^-1 (``GP.Linv_``, one
GEMM a request) against the triangular solve it replaces, on the CPU:
both paths of ``predict_structure`` and ``predict`` (float64 and float32
models, a well- and an ill-conditioned K), L^-1 extended by appends
against the inverse of the extended factor, its invalidation by a
refactorisation, the fallback to the solve when its buffers do not fit,
and the counters.  Variances are held at 1e-10 of the largest prior.
The ``gpu`` test does the same on the card at 3000 rows:

    python -m pytest --noconftest -m gpu tests/test_torch_variance_inverse.py -q -s

JAX is not imported: both paths are the port's own."""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import config, utils_profiling
from gpr_calculator_tpu_torch.models import gp as gp_mod
from gpr_calculator_tpu_torch.models.gp import GP
from gpr_calculator_tpu_torch.models.posterior import Posterior

from test_torch_kff import _on_cpu, make_points  # noqa: F401 (fixture)

VAR_TOL = 1e-10
# (sigma, l) and the noise (energy, force): sigma^2 / noise_e^2 2.25e4 and
# 2.5e9; the force noise stays 0.05, as the float32 model's K_FF (summed
# in float32) is not positive definite at 3e-5
CONDITIONING = {"well": ((1.5, 1.1), (0.01, 0.1)),
                "ill": ((1.5, 1.1), (3e-5, 0.05))}


@pytest.fixture(autouse=True)
def recorder():
    utils_profiling.clear()
    utils_profiling.enable()
    yield utils_profiling.counters
    utils_profiling.disable()
    utils_profiling.clear()


def _labelled(n=7, natoms=5, seed=21):
    """EMT-labelled jittered near-fcc Cu clusters."""
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a]])[:natoms]
    out = []
    for _ in range(n):
        s = T.Atoms(numbers=[29] * natoms,
                    positions=grid + 0.12 * rng.randn(natoms, 3),
                    cell=np.eye(3) * 12, pbc=False)
        s.calc = T.EMT()
        e, f = s.get_potential_energy(), s.get_forces()
        s.calc = None
        out.append((s, e, f))
    return out


def _model(labels, conditioning="well", dtype=torch.float64, device="cpu"):
    """A GP fitted (opt=False) on the labelled structures."""
    para, (ne, nf) = CONDITIONING[conditioning]
    gp = GP(kernel=T.RBF(para=list(para), zeta=2),
            descriptor=T.SO3(nmax=2, lmax=2, rcut=4.0), noise_e=ne,
            noise_f=nf, log_file=None, device=device, dtype=dtype)
    for lab in labels:
        gp.add_structure(lab)
    gp.fit(show=False, opt=False)
    return gp


def _structure_std(gp, strucs):
    out = [gp.predict_structure(s, return_std=True) for s in strucs]
    return np.concatenate([np.r_[o[3], o[4].ravel()] for o in out])


def _points_std(gp):
    """predict(return_std=True) on the model's own training points."""
    X = {"energy": [(x, y, ele) for (x, ele), y
                    in zip(gp._energy_pts, gp._energy_y)],
         "force": [(x, dx, y, ele) for (x, dx, ele), y
                   in zip(gp._force_pts, gp._force_y)]}
    return gp.predict(X, return_std=True)[1]


def _both_paths(gp, serve, monkeypatch):
    """(std from L^-1, std from the triangular solve, the largest served
    prior): ``serve(gp)`` twice, the second time with no inverse."""
    priors = []
    prior = gp_mod._prior

    def kept(*a):
        p = prior(*a)
        priors.append(float(p.max()))
        return p

    monkeypatch.setattr(gp_mod, "_prior", kept)
    std_inv = serve(gp)
    assert gp.Linv_ is not None
    with monkeypatch.context() as m:
        m.setattr(Posterior, "inverse", lambda self: None)
        std_trsm = serve(gp)
    return std_inv, std_trsm, max(priors)


def _same_var(a, b, prior):
    np.testing.assert_allclose(a ** 2, b ** 2, rtol=0, atol=VAR_TOL * prior)


@pytest.mark.parametrize("serve", ["predict_structure", "predict"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("conditioning", list(CONDITIONING))
def test_inverse_serves_the_solves_variance(conditioning, dtype, serve,
                                            monkeypatch, recorder):
    """The stds served from L^-1 equal the triangular solve's, within
    1e-10 of the largest prior in variance."""
    labels = _labelled()
    gp = _model(labels[:5], conditioning, dtype)
    strucs = [s for s, _, _ in labels]
    fn = ((lambda g: _structure_std(g, strucs))
          if serve == "predict_structure" else _points_std)
    std_inv, std_trsm, prior = _both_paths(gp, fn, monkeypatch)
    assert np.all(std_inv >= 0) and np.any(std_inv > 0)
    _same_var(std_inv, std_trsm, prior)
    assert recorder["factor_inv.build"] == 1
    assert recorder["predict.solve_inv"] == recorder["predict.solve_trsm"]


def test_appends_extend_the_inverse(recorder):
    """Each fit(opt=False) append extends L^-1 (no rebuild): it equals
    the inverse of the extended factor, and the stds equal a from-scratch
    refit's (1e-8 of the largest, as the incremental refit is held)."""
    labels = _labelled()
    strucs = [s for s, _, _ in labels]
    gp = _model(labels[:3])
    _structure_std(gp, strucs[:1])
    for lo, hi in ((3, 5), (5, 6), (6, 7)):
        for lab in labels[lo:hi]:
            gp.add_structure(lab)
        gp.fit(show=False, opt=False)
        ref = torch.linalg.solve_triangular(
            gp.L_, torch.eye(gp.L_.shape[0], dtype=torch.float64),
            upper=False)
        np.testing.assert_allclose(gp.Linv_.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12 * float(ref.abs().max()))
        _structure_std(gp, strucs[:1])
    assert gp.refit_stats["incremental"] == 3
    assert recorder["factor_inv.build"] == 1
    assert recorder["factor_inv.extend"] == 3
    full = _model(labels)
    std, std_full = _structure_std(gp, strucs), _structure_std(full, strucs)
    np.testing.assert_allclose(std, std_full, rtol=0,
                               atol=1e-8 * np.abs(std_full).max())


@pytest.mark.parametrize("refit", ["theta", "opt"])
def test_refactorisation_drops_the_inverse(refit, recorder):
    """A from-scratch refit at new hyperparameters (another theta with
    fit(opt=False), or fit(opt=True)) drops L^-1; the next request builds
    the new one and serves as a fresh model of the same data and theta."""
    labels = _labelled()
    strucs = [s for s, _, _ in labels]
    gp = _model(labels[:4])
    _structure_std(gp, strucs)
    old = gp.Linv_
    gp.add_structure(labels[4])
    if refit == "theta":
        gp.kernel.update([1.4, 1.0])
        gp.fit(show=False, opt=False)
    else:
        gp.fit(show=False, opt=True, maxiter=2)
    assert gp.refit_stats["full"] == 2 and gp.Linv_ is None
    std = _structure_std(gp, strucs)
    assert recorder["factor_inv.build"] == 2 and gp.Linv_ is not old
    fresh = _model(labels[:5])
    fresh.kernel.update(gp.kernel.parameters())
    fresh.fit(show=False, opt=False)
    np.testing.assert_allclose(std, _structure_std(fresh, strucs), rtol=0,
                               atol=1e-12 * np.abs(std).max())


@pytest.mark.parametrize("short_at", ["build", "append"])
def test_no_room_serves_by_the_solve(short_at, monkeypatch, recorder):
    """Where L^-1 and its second buffer would take more than MEMORY_SHARE
    of the free memory, at its build or at an append, the variance is
    served by the triangular solve, and equals the inverse's."""
    labels = _labelled()
    strucs = [s for s, _, _ in labels]
    gp, ref = _model(labels[:5]), _model(labels[:5])
    if short_at == "build":
        monkeypatch.setattr(config, "free_bytes", lambda device: 1)
    else:
        for m in (ref, gp):
            m.add_structure(labels[5])
        ref.fit(show=False, opt=False)
        _structure_std(gp, strucs[:1])
        monkeypatch.setattr(config, "free_bytes", lambda device: 1)
        gp.fit(show=False, opt=False)
        assert gp.refit_stats["incremental"] == 1
    recorder.clear()
    std = _structure_std(gp, strucs)
    assert gp.Linv_ is None
    assert recorder.get("predict.solve_trsm") == len(strucs)
    assert "predict.solve_inv" not in recorder
    monkeypatch.undo()
    std_ref = _structure_std(ref, strucs)
    assert ref.Linv_ is not None
    np.testing.assert_allclose(std ** 2, std_ref ** 2, rtol=0,
                               atol=VAR_TOL * float(np.max(std_ref ** 2)))


def test_counters_and_no_build_without_std(recorder):
    """Requests without stds build no inverse and count no solve; each
    request with stds counts one ``predict.solve_inv`` (a batched call of
    several structures is one request), after one build, which is the
    span ``predict.inverse`` inside the first such request's
    ``predict``."""
    labels = _labelled()
    strucs = [s for s, _, _ in labels]
    gp = _model(labels[:5])
    for s in strucs[:3]:
        gp.predict_structure(s)
    gp.predict_structures(strucs)
    assert gp.Linv_ is None
    assert not {"factor_inv.build", "predict.solve_inv",
                "predict.solve_trsm"} & set(recorder)
    _structure_std(gp, strucs[:4])
    gp.predict_structures(strucs, return_std=True)
    _points_std(gp)
    assert recorder["factor_inv.build"] == 1
    assert recorder["predict.solve_inv"] == 6
    assert "predict.solve_trsm" not in recorder
    recs = utils_profiling.records()
    inv = [r for r in recs if r.name == "predict.inverse"]
    assert len(inv) == 1
    outer = [r for r in recs if r.name == "predict" and r.id == inv[0].id]
    assert len(outer) == 1 and outer[0].depth == inv[0].depth - 1
    assert outer[0].start_ns <= inv[0].start_ns <= inv[0].end_ns \
        <= outer[0].end_ns


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_inverse_serves_the_solves_variance_on_the_card(card, monkeypatch):
    """3000 rows on the card (300 E + 900 F synthetic points, d = 30,
    float32 blocks, float64 factor): the stds of 48 query points (16 E,
    32 F: 112 rows) from L^-1 against the triangular solve, before and
    after a 200-row append, at 1e-10 of the largest prior in variance; the
    two paths' device times for V of 112 columns printed."""
    rng = np.random.RandomState(5)
    fp = make_points(rng, 900 + 50, 8, 30)
    ep = make_points(rng, 300 + 50, 8, 30)
    data = {"energy": [(x, rng.randn(), el) for x, _, el in ep],
            "force": [(x, dx, rng.randn(3), el) for x, dx, el in fp]}
    gp = GP(kernel=T.RBF(para=[1.5, 1.1], zeta=2), noise_e=0.01,
            noise_f=0.1, log_file=None, device=card, dtype=torch.float32)
    first = {"energy": data["energy"][:300], "force": data["force"][:900]}
    gp.set_train_pts(first)
    gp.fit(show=False, opt=False)
    q = make_points(rng, 48, 8, 30)
    X = {"energy": [(x, 0.0, el) for x, _, el in q[:16]],
         "force": [(x, dx, np.zeros(3), el) for x, dx, el in q[16:]]}
    for step in ("built", "extended"):
        if step == "extended":
            gp.set_train_pts({"energy": data["energy"][300:],
                              "force": data["force"][900:]}, mode="a")
            gp.fit(show=False, opt=False)
            assert gp.refit_stats["incremental"] == 1
        std_inv, std_trsm, prior = _both_paths(
            gp, lambda g: g.predict(X, return_std=True)[1], monkeypatch)
        monkeypatch.undo()
        err = float(np.max(np.abs(std_inv ** 2 - std_trsm ** 2)))
        ms = {}
        KtT = torch.randn(gp.L_.shape[0], len(std_inv), dtype=torch.float64,
                          device=card)
        for path, L_inv in (("trsm", None), ("inv", gp.Linv_)):
            go = ((lambda: torch.linalg.solve_triangular(gp.L_, KtT,
                                                         upper=False))
                  if L_inv is None else (lambda: L_inv @ KtT))
            go()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
            a.record()
            for _ in range(50):
                go()
            b.record()
            torch.cuda.synchronize()
            ms[path] = a.elapsed_time(b) / 50
        print(f"\n[{torch.cuda.get_device_name(0)}] {step} L^-1, "
              f"n = {gp.L_.shape[0]}: max|dvar| {err:.3g}, "
              f"{err / prior:.3g} of the largest prior {prior:.4g}; "
              f"V for {len(std_inv)} columns: trsm {ms['trsm']:.4f} ms, "
              f"L^-1 GEMM {ms['inv']:.4f} ms")
        assert np.all(np.isfinite(std_inv)) and np.any(std_inv > 0)
        _same_var(std_inv, std_trsm, prior)
