"""The lifecycle of what a fit leaves behind (``models/posterior.py``), on
the CPU in float64: after a full fit, three appends, an append where L^-1
no longer fits, a replaced training set, a precision change and
``convert.gp_from_state``, the GP's factor, weights, row order, L^-1 and
kept operands all belong to one fit, and ``predict_structure(
return_std=True)`` serves as a from-scratch ``_factorize`` of the same
rows (E, F within 1e-10 of the largest, the variances within 1e-10 of
the largest).  JAX is not imported."""
import copy

import numpy as np
import pytest
import torch

from gpr_calculator_tpu_torch import config, convert, utils_profiling
from gpr_calculator_tpu_torch.models.gp import _factorize, _noise_diag
from gpr_calculator_tpu_torch.models.posterior import Posterior
from gpr_calculator_tpu_torch.ops import kernels as K_ops

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)
from test_torch_variance_inverse import _labelled, _model

TOL = 1e-10


@pytest.fixture
def recorder():
    utils_profiling.clear()
    utils_profiling.enable()
    yield utils_profiling.counters
    utils_profiling.disable()
    utils_profiling.clear()


def _served(gp, strucs):
    out = [gp.predict_structure(s, return_std=True) for s in strucs]
    return [np.array([o[0] for o in out]),
            np.concatenate([o[1].ravel() for o in out]),
            np.array([o[3] for o in out]) ** 2,
            np.concatenate([o[4].ravel() for o in out]) ** 2]


def _grow(gp, labels):
    for lab in labels:
        gp.add_structure(lab)
    gp.fit(show=False, opt=False)


def _scratch(gp):
    """The same model served from a from-scratch ``_factorize`` of its
    training rows."""
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    L, alpha = _factorize(e, f, y, gp.kernel.params(), gp.noise_e,
                          gp.noise_f, gp.kernel.zeta, gp.kernel.kind)
    ref = copy.copy(gp)
    ref.posterior = Posterior.from_packed(e, f, L, alpha)
    return ref


def _full(labels, strucs, monkeypatch, recorder):
    gp = _model(labels[:5])
    _served(gp, strucs[:1])
    assert gp.refit_stats["full"] == 1 and recorder["factor_inv.build"] == 1
    return gp


def _appends(labels, strucs, monkeypatch, recorder):
    gp = _model(labels[:3])
    _served(gp, strucs[:1])
    for lo, hi in ((3, 5), (5, 6), (6, 7)):
        _grow(gp, labels[lo:hi])
        _served(gp, strucs[:1])
    assert gp.refit_stats["incremental"] == 3
    assert [kE for kE, _ in gp.posterior.groups] == [3, 2, 1, 1]
    assert recorder["factor_inv.build"] == 1
    assert recorder["factor_inv.extend"] == 3
    return gp


def _no_room(labels, strucs, monkeypatch, recorder):
    """L^-1 is kept, then an append finds no room for the extended one:
    it is dropped, and the variance is served by the solve."""
    gp = _model(labels[:5])
    _served(gp, strucs[:1])
    assert gp.Linv_ is not None
    monkeypatch.setattr(config, "free_bytes", lambda device: 1)
    _grow(gp, labels[5:7])
    assert gp.refit_stats["incremental"] == 1 and gp.Linv_ is None
    recorder.clear()
    _served(gp, strucs)
    assert recorder["predict.solve_trsm"] == len(strucs)
    assert "predict.solve_inv" not in recorder and gp.Linv_ is None
    return gp


def _replaced(labels, strucs, monkeypatch, recorder):
    """A replaced training set: the old fit serves on, is not appended
    to, and the next fit(opt=False) refactorises."""
    gp = _model(labels[:4])
    before = _served(gp, strucs)
    old = gp.posterior
    other = _model(labels[3:7])
    gp.set_train_pts({
        "energy": [(x, y, ele) for (x, ele), y
                   in zip(other._energy_pts, other._energy_y)],
        "force": [(x, dx, y, ele) for (x, dx, ele), y
                  in zip(other._force_pts, other._force_y)]}, mode="w")
    assert gp.posterior is old and not old.appendable
    for a, b in zip(_served(gp, strucs), before):
        np.testing.assert_array_equal(a, b)
    gp.fit(show=False, opt=False)
    assert (gp.refit_stats["full"], gp.refit_stats["incremental"]) == (2, 0)
    assert gp.posterior is not old and gp.posterior.appendable
    return gp


def _precision(labels, strucs, monkeypatch, recorder):
    """Serving in another matmul precision builds the training operands
    once for it, kept beside the first precision's by the same fit."""
    gp = _model(labels[:5])
    _served(gp, strucs[:1])
    post = gp.posterior
    K_ops.reset_operand_builds()
    config.set_kff_precision("bf16x4")
    _served(gp, strucs)
    assert K_ops.operand_builds == {"query": len(strucs), "train": 1}
    assert gp.posterior is post and post.operands().mode == "bf16x4"
    return gp


def _from_state(labels, strucs, monkeypatch, recorder):
    """A model carried by ``convert.state_of`` / ``gp_from_state`` after
    appends: the factor in its insertion order, built by the one
    constructor."""
    gp = _model(labels[:3])
    _grow(gp, labels[3:6])
    carried = convert.gp_from_state(convert.state_of(gp), device="cpu",
                                    log_file=None)
    assert carried.fits == 0 and len(gp.posterior.groups) == 2
    assert carried.posterior.groups == gp.posterior.groups
    assert torch.equal(carried.posterior.cols, gp.posterior.cols)
    return carried


CASES = {"full": _full, "appends": _appends, "no_room": _no_room,
         "replaced": _replaced, "precision": _precision,
         "from_state": _from_state}


def _of_one_fit(gp):
    """The GP's L_, alpha_, Linv_ and snapshot are its Posterior's; L is
    the factor of the snapshot's covariance in the row order of ``cols``,
    alpha its weights (zero on padded rows), L^-1 its inverse, and the kept
    operands the snapshot's."""
    post = gp.posterior
    assert gp.L_ is post.L and gp.alpha_ is post.alpha
    assert gp.Linv_ is post.Linv and gp._fit_snapshot is post.snapshot
    e, f, nE, nF = post.snapshot
    assert (nE, nF) == (gp.N_energy, gp.N_forces) == (e.nreal, f.nreal)
    K = K_ops.k_self(e, f, gp.kernel.params(), gp.kernel.zeta,
                     gp.kernel.kind, dtype=torch.float64)
    K.diagonal().add_(_noise_diag(e, f, gp.noise_e, gp.noise_f))
    c = post.cols
    Kc = K[c[:, None], c[None, :]]
    np.testing.assert_allclose((post.L @ post.L.T).numpy(), Kc.numpy(),
                               rtol=0, atol=TOL * float(Kc.abs().max()))
    y = gp._y_vector(e, f, nE, nF).double()
    a = torch.cholesky_solve(y[c][:, None], post.L)[:, 0]
    np.testing.assert_allclose(post.alpha[c].numpy(), a.numpy(), rtol=0,
                               atol=TOL * float(a.abs().max()))
    pad = torch.ones(len(post.alpha), dtype=torch.bool)
    pad[c] = False
    assert torch.all(post.alpha[pad] == 0)
    if post.Linv is not None:
        eye = torch.eye(len(c), dtype=torch.float64)
        np.testing.assert_allclose((post.Linv @ post.L).numpy(), eye.numpy(),
                                   rtol=0, atol=TOL)
    ops = post.operands()
    assert post.operands() is ops
    fresh = K_ops.side_operands(e, f, config.kff_precision(), "train")
    for got, want in zip(ops, fresh):
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want)
        else:
            assert got == want


@pytest.mark.parametrize("case", list(CASES))
def test_fit_state_is_one_fit_and_serves_as_a_full_factorisation(
        case, monkeypatch, recorder):
    labels = _labelled()
    strucs = [s for s, _, _ in labels]
    try:
        gp = CASES[case](labels, strucs, monkeypatch, recorder)
        _of_one_fit(gp)
        ours, ref = _served(gp, strucs), _served(_scratch(gp), strucs)
    finally:
        config.set_kff_precision("highest")
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * np.abs(b).max())
