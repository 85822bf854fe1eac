"""The port's incremental rank-k refit against a full refactorisation and
against the JAX package, on the CPU in float64: ``ops/linalg``'s
``chol_append`` / ``chol_solve`` against a full Cholesky of the extended
matrix and against the JAX ``chol_append_buf``, and ``GP.fit(opt=False)``
after appends (RBF and Dot) served against a full ``_factorize`` at the
same hyperparameters, against the JAX package's ``_try_incremental_fit``
on the same appends, and under ``GP(mesh=)`` on virtual CPU shards.
E and F are held at 1e-10 of their largest magnitude, the standard
deviations at 1e-8 of theirs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu.ops.linalg import chol_append_buf
from gpr_calculator_tpu_torch import config, utils_profiling
from gpr_calculator_tpu_torch.models.gp import GP
from gpr_calculator_tpu_torch.ops import linalg

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

E_TOL, STD_TOL = 1e-10, 1e-8
KERNELS = {"RBF": ([1.5, 1.1], T.RBF, J.RBF),
           "Dot": ([1.2, 0.8], T.Dot, J.Dot)}


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n + 8)
    return A @ A.T + 0.5 * np.eye(n), rng.randn(n)


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _append_all(K, sizes):
    """Factor K[:n0, :n0], then append the blocks of ``sizes`` in turn:
    (the extended factor, the diagonals of each L_c)."""
    n = sizes[0]
    L = torch.linalg.cholesky(_t(K[:n, :n]))
    diags = []
    for k in sizes[1:]:
        L, d = linalg.chol_append(L, _t(K[:n, n:n + k]),
                                  _t(K[n:n + k, n:n + k]))
        diags.append(d)
        n += k
    return L, diags


@pytest.mark.parametrize("sizes", [(40, 1), (40, 3), (40, 8), (40, 25),
                                   (250, 3, 25)])
def test_chol_append_matches_full_cholesky(sizes):
    """The extended factor equals torch.linalg.cholesky of the extended
    matrix and chol_solve its solve, at 1e-12 -- also across two appends
    in a row."""
    n = sum(sizes)
    K, y = _spd(n, seed=n)
    L, diags = _append_all(K, sizes)
    assert L.shape == (n, n)
    L_full = torch.linalg.cholesky(_t(K))
    np.testing.assert_allclose(L.numpy(), L_full.numpy(), rtol=0,
                               atol=1e-12 * float(L_full.abs().max()))
    alpha = linalg.chol_solve(L, _t(y)).numpy()
    ref = np.linalg.solve(K, y)
    np.testing.assert_allclose(alpha, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max() * np.linalg.cond(K))
    for d in diags:
        assert torch.all(d > 0)


def test_chol_append_flags_a_non_pd_extension():
    """An extension that is not positive definite gives an L_c diagonal
    that is not finite or not positive."""
    K0, _ = _spd(12, seed=1)
    rng = np.random.RandomState(2)
    _, d = linalg.chol_append(torch.linalg.cholesky(_t(K0)),
                              _t(rng.randn(12, 3)), -_t(np.eye(3)))
    d = d.numpy()
    assert not (np.all(np.isfinite(d)) and np.all(d > 0)), d


def test_chol_append_matches_jax_chol_append_buf():
    """The same (L, B, C, y) through the JAX package's chol_append_buf
    (capacity buffer, ghost columns) and the port: factor and weights at
    1e-12."""
    n, k, cap = 30, 5, 64
    K, y = _spd(n + k, seed=7)
    L0 = np.linalg.cholesky(K[:n, :n])
    jbuf = np.eye(cap)
    jbuf[:n, :n] = L0
    k_pad = 8
    B_full = np.zeros((cap, k_pad))
    B_full[:n, :k] = K[:n, n:]
    C_pad = np.eye(k_pad)
    C_pad[:k, :k] = K[n:, n:]
    y_full = np.zeros(cap)
    y_full[:n + k] = y
    jL, jalpha, _ = chol_append_buf(jnp.asarray(jbuf), jnp.asarray(B_full),
                                    jnp.asarray(C_pad), jnp.asarray(y_full),
                                    n)
    L, _ = linalg.chol_append(_t(L0), _t(K[:n, n:]), _t(K[n:, n:]))
    alpha = linalg.chol_solve(L, _t(y))
    jL = np.asarray(jL)[:n + k, :n + k]
    np.testing.assert_allclose(L.numpy(), jL, rtol=0,
                               atol=1e-12 * np.abs(jL).max())
    ja = np.asarray(jalpha)[:n + k]
    np.testing.assert_allclose(alpha.numpy(), ja, rtol=0,
                               atol=1e-12 * np.abs(ja).max())


# -- GP ----------------------------------------------------------------------

def _structs(pkg, n=7, natoms=5, seed=21):
    """Jittered near-fcc Cu clusters (tests/test_gp.py's make_structs)."""
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a],
                     [0, 0.5 * a, 0.5 * a], [a, a, 0], [a, 0, a]])[:natoms]
    return [pkg.Atoms(numbers=[29] * natoms,
                      positions=grid + 0.12 * rng.randn(natoms, 3),
                      cell=np.eye(3) * 12, pbc=False) for _ in range(n)]


def _labelled(pkg):
    out = []
    for s in _structs(pkg):
        s.calc = pkg.EMT()
        e, f = s.get_potential_energy(), s.get_forces()
        s.calc = None
        out.append((s, e, f))
    return out


# the appended rounds after a fit on the first three structures
ROUNDS = ((3, 5), (5, 6), (6, 7))


def _fresh(pkg, kernel, **kw):
    para, tk, jk = KERNELS[kernel]
    k = (tk if pkg is T else jk)(para=list(para), zeta=2)
    return pkg.GP(kernel=k, descriptor=pkg.SO3(nmax=2, lmax=2, rcut=4.0),
                  noise_e=0.01, noise_f=0.1, log_file=None, **kw)


def _grown(pkg, kernel, **kw):
    """Fit on three structures, then append in three rounds, each
    followed by fit(opt=False)."""
    labels = _labelled(pkg)
    gp = _fresh(pkg, kernel, **kw)
    for lab in labels[:3]:
        gp.add_structure(lab)
    gp.fit(show=False, opt=False)
    for lo, hi in ROUNDS:
        for lab in labels[lo:hi]:
            gp.add_structure(lab)
        gp.fit(show=False, opt=False)
    return gp, [s for s, _, _ in labels]


def _full(gp):
    """A port model of the same training set refactorised from scratch."""
    ref = _fresh(T, gp.kernel.name)
    ref.set_train_pts({
        "energy": [(x, y, ele) for (x, ele), y
                   in zip(gp._energy_pts, gp._energy_y)],
        "force": [(x, dx, y, ele) for (x, dx, ele), y
                  in zip(gp._force_pts, gp._force_y)]}, mode="w")
    ref.fit(show=False, opt=False)
    assert ref.refit_stats["full"] == 1
    return ref


def _served(gp, strucs):
    out = [gp.predict_structure(s, return_std=True) for s in strucs]
    return [np.array([o[0] for o in out]), np.concatenate(
        [o[1].ravel() for o in out]), np.array([o[3] for o in out]),
        np.concatenate([o[4].ravel() for o in out])]


def _same(a, b, tols=(E_TOL, E_TOL, STD_TOL, STD_TOL)):
    for x, y, tol in zip(a, b, tols):
        np.testing.assert_allclose(x, y, rtol=0, atol=tol * np.abs(y).max())


@pytest.fixture(scope="module")
def grown():
    # refit_stats sums the refits' ms while the span recorder is on
    utils_profiling.enable()
    try:
        return {k: _grown(T, k) for k in KERNELS}
    finally:
        utils_profiling.disable()
        utils_profiling.clear()


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_incremental_fit_matches_a_full_refit(grown, kernel):
    """Three appends through the rank-k refit serve E, F, sigma_E and
    sigma_F as a full _factorize of the same rows does; refit_stats
    counts one full refit and three incremental ones."""
    gp, strucs = grown[kernel]
    assert gp.refit_stats["full"] == 1 and gp.refit_stats["incremental"] == 3
    assert gp.refit_stats["incremental_ms"] > 0
    assert [kE for kE, _ in gp.posterior.groups] == [3, 2, 1, 1]
    # the factor rows are in insertion order, not packed order
    cols = gp.posterior.cols
    assert not torch.equal(cols, torch.arange(len(cols)))
    _same(_served(gp, strucs), _served(_full(gp), strucs))


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_incremental_fit_matches_jax(grown, kernel):
    """The same appends in the JAX package (its _try_incremental_fit)
    serve the same E, F and standard deviations."""
    gp, strucs = grown[kernel]
    jgp, jstrucs = _grown(J, kernel)
    assert jgp.refit_stats["incremental"] == 3
    _same(_served(gp, strucs), _served(jgp, jstrucs),
          tols=(E_TOL,) * 4)


def test_validate_data_and_predict_after_appends(grown):
    """validate_data and predict go through the same insertion-order
    factor: equal to the full refit's."""
    gp, _ = grown["Dot"]
    ref = _full(gp)
    for a, b in zip(gp.validate_data(return_std=True),
                    ref.validate_data(return_std=True)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=E_TOL * max(np.abs(b).max(), 1e-300))


def test_opt_fit_and_replacement_invalidate_the_state():
    """fit(opt=True) refactorises and records the new signature;
    set_train_pts(mode="w") drops the factor, so the next fit(opt=False)
    is a full one, whose served results equal a fresh model's."""
    labels = _labelled(T)
    gp = _fresh(T, "RBF")
    for lab in labels[:3]:
        gp.add_structure(lab)
    gp.fit(show=False, opt=True, maxiter=2)
    assert gp.posterior.sig == gp._params_signature()
    gp.kernel.update([1.4, 1.0])
    gp.add_structure(labels[3])
    gp.fit(show=False, opt=False)          # another signature: full
    assert (gp.refit_stats["full"], gp.refit_stats["incremental"]) == (2, 0)

    other = _fresh(T, "RBF")
    for lab in labels[4:7]:
        other.add_structure(lab)
    gp.set_train_pts({
        "energy": [(x, y, ele) for (x, ele), y
                   in zip(other._energy_pts, other._energy_y)],
        "force": [(x, dx, y, ele) for (x, dx, ele), y
                  in zip(other._force_pts, other._force_y)]}, mode="w")
    assert not gp.posterior.appendable
    gp.kernel.update([1.5, 1.1])
    gp.fit(show=False, opt=False)
    assert gp.refit_stats["full"] == 3
    other.fit(show=False, opt=False)
    strucs = [s for s, _, _ in labels]
    _same(_served(gp, strucs), _served(other, strucs))


def test_non_pd_extension_refactorises_from_scratch(monkeypatch):
    """An extension that is not positive definite drops the state and
    refits from scratch, counted as a full refit; the model then serves
    as a full refit does."""
    labels = _labelled(T)
    gp = _fresh(T, "RBF")
    for lab in labels[:3]:
        gp.add_structure(lab)
    gp.fit(show=False, opt=False)
    blocks = GP._append_blocks
    monkeypatch.setattr(GP, "_append_blocks",
                        lambda self, *a: (blocks(self, *a)[0],
                                          -blocks(self, *a)[1]))
    gp.add_structure(labels[3])
    gp.fit(show=False, opt=False)
    assert gp.refit_stats["full"] == 2 and gp.refit_stats["incremental"] == 0
    assert len(gp.posterior.groups) == 1
    monkeypatch.undo()
    strucs = [s for s, _, _ in labels]
    _same(_served(gp, strucs), _served(_full(gp), strucs))


def test_incremental_fit_under_a_mesh_matches_unsharded(grown):
    """GP(mesh=) on four virtual CPU shards, with the sharded route
    forced: the cross block's K_FF and K_EF in stripes over the old
    training force axis; served results equal the unsharded model's."""
    from gpr_calculator_tpu_torch.parallel import make_mesh
    from gpr_calculator_tpu_torch.parallel import sharded_kernels as SK
    config.set_sharded_gate("off")
    try:
        SK.reset_builds()
        gp, strucs = _grown(T, "RBF", mesh=make_mesh(4, ["cpu"] * 4))
        assert SK.builds["k_block"] >= 3
    finally:
        config.set_sharded_gate("auto")
    assert gp.refit_stats["incremental"] == 3
    _same(_served(gp, strucs), _served(grown["RBF"][0], strucs))


def test_appended_rows_sort_as_a_full_refit(monkeypatch):
    """The blocks of an incremental refit sort the new rows' envs by the
    size of the side a full refit of all rows would pack
    (``kernels.gram_sorts``), not by the new rows' own: a new force side
    under SORT_MIN_ENVS joined to a training side that takes the whole
    over it is sorted; the appended model then serves as a full refit at
    that threshold does."""
    from gpr_calculator_tpu_torch.ops import kernels as K_ops
    from gpr_calculator_tpu_torch.ops import kff
    from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force
    labels = _labelled(T)
    gp = _fresh(T, "RBF")
    for lab in labels[:3]:
        gp.add_structure(lab)
    gp.fit(show=False, opt=False)
    te, tf, nE0, nF0 = gp._fit_snapshot
    gp.add_structure(labels[3])
    kw = dict(d=te.d, dtype=torch.float64)
    e_new = pack_energy(gp._energy_pts[nE0:gp.N_energy], **kw)
    f_new = pack_force(gp._force_pts[nF0:gp.N_forces], **kw)
    envs = f_new.m * f_new.x.shape[1]
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", envs + 1)
    assert not kff._sorts(None, f_new.m, f_new.x.shape[1])
    assert K_ops.gram_sorts(e_new, f_new) == (None, None)
    assert K_ops.gram_sorts(e_new, f_new, (te, tf))[1] is True
    gp.fit(show=False, opt=False)
    assert gp.refit_stats["incremental"] == 1
    strucs = [s for s, _, _ in labels]
    _same(_served(gp, strucs), _served(_full(gp), strucs))
