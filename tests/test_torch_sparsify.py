"""Sparsification, the predictive covariance and the rest of the GP API in
the port against the JAX package, on the CPU in float64: ``CUR``,
``GP.sparsify``, ``remove_train_pts``, ``predict(return_cov=True)``
(``_predict_cov``; also after an incremental append and with 9-column
points), their size guards, ``todict``, ``get_train_x``,
``add_train_pts_energy`` / ``_force``, ``update_y_train``, ``set_K_inv``,
``SO3.load_from_dict`` / ``clear_memory``, and the port copies of the
EMT examples.

Tolerances: 1e-10 of the largest magnitude compared; the training
points left (descriptors, labels) 1e-12, the packages' descriptors being
~2e-15 of themselves apart.  sparsify and remove_train_pts refit with
L-BFGS-B; sigma is bounded at 2 there (tests/test_gp.py's set runs it to
its default bound 50, where the two packages' float64 factorisations of
one K give weights 4e-10 of max|alpha| apart)."""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu.models.gp import CUR as JCUR
from gpr_calculator_tpu_torch import config, convert
from gpr_calculator_tpu_torch.models import gp as gp_mod

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

TOL = 1e-10


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(ours, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _structs(pkg, n, natoms, seed):
    """Jittered near-fcc Cu clusters (tests/test_gp.py's make_structs)."""
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a],
                     [0, 0.5 * a, 0.5 * a], [a, a, 0], [a, 0, a]])[:natoms]
    return [pkg.Atoms(numbers=[29] * natoms,
                      positions=grid + 0.12 * rng.randn(natoms, 3),
                      cell=np.eye(3) * 12, pbc=False) for _ in range(n)]


def _model(pkg, strucs, stress=False, bounds=((1e-2, 5e1), (1e-1, 1e1))):
    gp = pkg.GP(kernel=pkg.RBF(para=[1.0, 1.0], bounds=bounds),
                descriptor=pkg.SO3(nmax=2, lmax=2, rcut=4.0, stress=stress),
                noise_e=0.01, noise_f=0.1, log_file=None)
    for s in strucs:
        s.calc = pkg.EMT()
        e, f = s.get_potential_energy(), s.get_forces()
        s.calc = None
        gp.add_structure((s, e, f))
    gp.fit(show=False, opt=False)
    return gp


def _duplicated(pkg):
    """tests/test_gp.py's sparsify set: three clusters and a copy of the
    first, fitted at (1, 1), sigma bounded at 2."""
    strucs = _structs(pkg, 3, 4, 51)
    strucs.append(strucs[0].copy())
    return _model(pkg, strucs, bounds=((1e-2, 2.0), (1e-1, 1e1)))


def _same_points(ours, ref):
    """Point lists alike: elements equal, descriptors and labels at 1e-12
    (the packages' descriptors differ by ~2e-15 of themselves)."""
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        for x, y in zip(a, b):
            _close(x, y, 1e-12)


def _same_training_set(ours, ref):
    assert (ours.N_energy, ours.N_forces) == (ref.N_energy, ref.N_forces)
    _same_points(ours._energy_pts + ours._force_pts,
                 ref._energy_pts + ref._force_pts)
    _close(ours._energy_y, ref._energy_y, 1e-12)
    _close(np.asarray(ours._force_y), np.asarray(ref._force_y), 1e-12)
    assert [tuple(r[3:]) for r in ours.train_db] == \
        [(r[3], list(r[4])) for r in ref.train_db]


def _same_refit(ours, ref):
    """theta within 1e-8 of the JAX model's (L-BFGS-B on NLLs ~1e-13
    apart) and the weights within 1e-10."""
    np.testing.assert_allclose(ours.kernel.parameters(),
                               ref.kernel.parameters(), rtol=1e-8)
    _close(convert.state_of(ours)["alpha"], convert.state_of(ref)["alpha"])


# -- CUR and sparsify --------------------------------------------------------

@pytest.mark.parametrize("rank,rows", [(3, 10), (5, 12)])
def test_cur_matches_jax(rank, rows):
    """CUR's redundant rows equal the JAX package's on the same K, Grams
    of ``rows`` rows and rank ``rank``.  (Exact twin rows tie: which twin
    either package picks is then decided by the rounding of its eigh.)"""
    A = np.random.RandomState(rank).randn(rows, rank)
    K = A @ A.T
    ids = gp_mod.CUR(torch.as_tensor(K), 1e-8)
    np.testing.assert_array_equal(ids, JCUR(K, 1e-8))
    assert len(ids) == rows - rank


@pytest.fixture(scope="module")
def sparsified():
    """The duplicated set sparsified by both packages (each refits)."""
    ours, ref = _duplicated(T), _duplicated(J)
    sizes = (ours.N_energy, ours.N_forces)
    assert sizes == (ref.N_energy, ref.N_forces)
    ours.sparsify(1e-6, 1e-6)
    ref.sparsify(1e-6, 1e-6)
    return ours, ref, sizes


def test_sparsify_removes_jax_ids(sparsified):
    """The points sparsify removes from the set with a duplicated
    structure are the JAX package's: the same training set and database
    flags remain, and fewer points than before."""
    ours, ref, (n_e, n_f) = sparsified
    assert ours.N_energy + ours.N_forces < n_e + n_f
    _same_training_set(ours, ref)


def test_sparsify_refits_to_jax_weights(sparsified):
    """After sparsify both models refit (L-BFGS-B) alike: theta at 1e-8,
    the weights at 1e-10, and the refit serves."""
    ours, ref, _ = sparsified
    _same_refit(ours, ref)
    E, F, _ = ours.predict_structure(_structs(T, 1, 4, 51)[0])
    assert np.isfinite(E) and np.all(np.isfinite(F))


def test_remove_train_pts_matches_jax():
    """remove_train_pts of given energy and force points keeps the JAX
    package's training set and database flags, and refits to its
    weights."""
    ours, ref = _duplicated(T), _duplicated(J)
    for gp in (ours, ref):
        gp.remove_train_pts([1], [0, 3])
    _same_training_set(ours, ref)
    assert ours.N_energy == 3
    _same_refit(ours, ref)


# -- the predictive covariance -----------------------------------------------

def _points_of(pkg, gp, struc, stress):
    """The energy point and every atom's force point (9 columns with
    ``stress``) of one structure, as predict's dict."""
    d = gp.descriptor.calculate(struc, **({"dtype": torch.float64}
                                          if pkg is T else {}))
    ele = np.full(len(struc), 29)
    fp = gp_mod._group_force_points(d, ele, range(len(struc)), stress)
    return {"energy": [(d["x"], ele)], "force": fp}


@pytest.mark.parametrize("stress", [False, True])
def test_predict_cov_matches_jax(stress):
    """predict(return_cov=True): mean and covariance equal the JAX
    package's (1e-10), for 3- and 9-column force points, also after an
    incremental append (the factor in insertion order); the square root
    of its diagonal is predict's std."""
    strucs = {pkg: _structs(pkg, 4, 5, 61) for pkg in (T, J)}
    models = {pkg: _model(pkg, strucs[pkg][:3], stress=True)
              for pkg in (T, J)}
    for rounds in range(2):
        X = {pkg: _points_of(pkg, models[pkg], strucs[pkg][3], stress)
             for pkg in (T, J)}
        mean, cov = models[T].predict(X[T], return_cov=True)
        jmean, jcov = models[J].predict(X[J], return_cov=True)
        assert cov.shape == (1 + (9 if stress else 3) * 5,) * 2
        _close(mean, jmean)
        _close(cov, jcov)
        _, std = models[T].predict(X[T], return_std=True)
        var = np.diag(cov)
        _close(var, std ** 2, 1e-8)
        for pkg in (T, J):      # one more structure, appended
            s = _structs(pkg, 1, 5, 62 + rounds)[0]
            s.calc = pkg.EMT()
            models[pkg].add_structure((s, s.get_potential_energy(),
                                       s.get_forces()))
            s.calc = None
            models[pkg].fit(show=False, opt=False)
    assert models[T].refit_stats["incremental"] == 2


def test_size_guards_raise(monkeypatch):
    """_predict_cov, CUR and sparsify raise ValueError before they
    allocate when their float64 buffers exceed MEMORY_SHARE of the
    device's free memory (here a monkeypatched 1 KB)."""
    gp = _duplicated(T)
    X = _points_of(T, gp, _structs(T, 1, 4, 51)[0], False)
    gp.predict(X, return_cov=True)
    monkeypatch.setattr(config, "free_bytes", lambda device: 1024)
    with pytest.raises(ValueError, match="predictive covariance"):
        gp.predict(X, return_cov=True)
    with pytest.raises(ValueError, match="CUR"):
        gp_mod.CUR(torch.eye(400), 1e-10)
    n = gp.N_energy + gp.N_forces
    with pytest.raises(ValueError, match="sparsify"):
        gp.sparsify()
    assert gp.N_energy + gp.N_forces == n


def test_free_bytes_reads_the_device():
    """The CPU's free memory is the host's available physical memory."""
    assert config.free_bytes("cpu") > 2 ** 20


# -- the small methods -------------------------------------------------------

def test_small_methods_match_jax():
    """todict, get_train_x (queued points left out), add_train_pts_energy
    / _force, update_y_train and set_K_inv against the JAX package's."""
    rng = np.random.RandomState(0)
    e_pts = [(rng.uniform(0.2, 1.0, (3, 6)), -0.5, np.array([13, 13, 79]))]
    f_pts = [(rng.uniform(0.2, 1.0, (4, 6)), rng.uniform(-1, 1, (4, 6, 3)),
              rng.uniform(-1, 1, 3), np.array([13, 79, 13, 79]))]
    gps = {}
    for pkg in (T, J):
        gp = _duplicated(pkg)
        s = _structs(pkg, 1, 4, 52)[0]
        s.calc = pkg.EMT()
        gp.add_structure((s, s.get_potential_energy(), s.get_forces()))
        gps[pkg] = gp
    for pkg in (T, J):
        assert gps[pkg].todict() == {}
        assert gps[pkg].set_K_inv() is None
    tx, jx = (gps[pkg].get_train_x() for pkg in (T, J))
    assert len(tx["energy"]) == gps[T].N_energy - gps[T].N_energy_queue
    for key in ("energy", "force"):
        _same_points(tx[key], jx[key])
    for pkg in (T, J):
        gps[pkg].add_train_pts_energy(e_pts)
        gps[pkg].add_train_pts_force(f_pts)
    _same_training_set(gps[T], gps[J])
    _close(gps[T].update_y_train(), gps[J].update_y_train(), 1e-12)
    assert gps[T].y_train.shape == (gps[T].N_energy + 3 * gps[T].N_forces,
                                    1)


def test_so3_load_from_dict_and_clear_memory():
    """SO3.load_from_dict re-initialises from save_dict's dict (stress
    included) and computes what the JAX package's does; clear_memory
    changes nothing."""
    ours, ref = T.SO3(), J.SO3()
    d = T.SO3(nmax=2, lmax=3, rcut=3.7, alpha=1.5, stress=True).save_dict()
    ours.load_from_dict(d)
    ref.load_from_dict(d)
    assert ours.save_dict() == ref.save_dict() == d
    ours.clear_memory()
    ref.clear_memory()
    struc = {pkg: _structs(pkg, 1, 4, 9)[0] for pkg in (T, J)}
    a = ours.calculate(struc[T], dtype=torch.float64)
    b = ref.calculate(struc[J])
    for key in ("x", "dxdr", "rdxdr"):
        _close(a[key], b[key])


# -- the examples ------------------------------------------------------------

def test_examples_run_on_the_cpu(tmp_path):
    """examples/emt_serial.py and emt_batched.py run a few NEB steps on
    the CPU (images built in code): finite barriers, the figure written,
    the surrogate answering."""
    from gpr_calculator_tpu_torch.examples import emt_batched, emt_serial
    fig = tmp_path / "neb.png"
    out = emt_serial.run(steps=2, figname=str(fig))
    assert fig.exists() and len(out) == 3
    assert all(np.isfinite(b) for _, b, _ in out)
    barrier, neb, gp = emt_batched.run(steps=2)
    assert np.isfinite(barrier) and not neb.converged
    assert gp.use_surrogate > 0
