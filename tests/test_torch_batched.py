"""The batched paths of the port against its own one-at-a-time paths and
against the JAX package, on the CPU in float64: ``GP.predict_structures``
(a band served by one batched descriptor call and one served block),
``SO3.calculate_many`` (the batched descriptor ingest, greedy groups
under a pair budget) and ``convert_train_data`` of many structures.  The
batched on-the-fly NEBs are in test_torch_batched_neb.py, so that
``--dist loadfile`` can run them on another worker than these tests."""
import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu.calculators import LJ as JLJ
from gpr_calculator_tpu_torch.calculators import LJ

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)
from test_torch_neb import NOISE_E, NOISE_F, _images


# (sigma, l) of the JAX package's set_GPR on au_on_al100_images()
SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527
LJ_PARAMS = {"rc": 5.0, "sigma": 2.2, "epsilon": 0.1}


def _band(pkg, fixed=None):
    """The five Au/Al(100) images and three perturbed copies of the
    interior ones, as ``pkg``'s Atoms; ``fixed``: every atom fixed."""
    rng = np.random.RandomState(5)
    ends = T.au_on_al100_images()
    structs = list(ends)
    for k in (1, 2, 3):
        a = ends[k].copy()
        free = np.setdiff1d(np.arange(len(a)), a.fixed_indices())
        a.positions[free] += rng.normal(0.0, 0.05, (len(free), 3))
        structs.append(a)
    out = []
    for a in structs:
        ids = np.arange(len(a)) if fixed else a.fixed_indices()
        out.append(pkg.Atoms(numbers=a.numbers, positions=a.positions,
                             cell=a.cell.array, pbc=a.pbc,
                             constraints=[pkg.FixAtoms(indices=ids)]))
    return out


def _labels():
    """EMT energies and raw forces of images 0, 4, 2 (the port's EMT)."""
    out = []
    for a in (T.au_on_al100_images()[k] for k in (0, 4, 2)):
        a.calc = T.EMT()
        out.append((a.get_potential_energy(),
                    a.get_forces(apply_constraint=False)))
        a.calc = None
    return out


def _model(pkg, kernel="RBF", base=False):
    """A model of ``pkg`` trained on images 0, 4, 2 at fixed
    hyperparameters (the same training set in both packages)."""
    kern = (pkg.RBF(para=[SIGMA, L_SCALE], zeta=2) if kernel == "RBF"
            else pkg.Dot(para=[0.6, 1.7], zeta=2))
    lj = (JLJ if pkg is J else LJ)(LJ_PARAMS) if base else None
    gp = pkg.GP(kernel=kern, descriptor=pkg.SO3(nmax=3, lmax=4, rcut=5.0),
                base_potential=lj, noise_e=NOISE_E, noise_f=NOISE_F,
                log_file=None)
    images = _images(pkg)
    for k, (e, f) in zip((0, 4, 2), _labels()):
        gp.add_structure((images[k], e, f))
    gp.fit(opt=False, show=False)
    return gp


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours, float), np.asarray(ref, float)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("kernel,base", [("RBF", False), ("Dot", False),
                                         ("RBF", True)])
def test_predict_structures_matches_single_and_jax(kernel, base):
    """A band served batched equals the images served one at a time (the
    JAX package's test_batched.py limits), and the JAX package's batched
    serving of the same training set (1e-10)."""
    gp, jgp = _model(T, kernel, base), _model(J, kernel, base)
    band = _band(T)
    batch = gp.predict_structures(band, return_std=True)
    assert len(batch) == len(band)
    for s, (E, F, E_std, F_std) in zip(band, batch):
        E1, F1, _, E_std1, F_std1 = gp.predict_structure(s, return_std=True)
        np.testing.assert_allclose(E, E1, rtol=1e-10)
        np.testing.assert_allclose(F, F1, rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(E_std, E_std1, rtol=1e-6, atol=1e-10)
        np.testing.assert_allclose(F_std, F_std1, rtol=1e-6, atol=1e-10)
        np.testing.assert_array_equal(F[s.fixed_indices()], 0.0)
    ref = jgp.predict_structures(_band(J), return_std=True)
    for (E, F, E_std, F_std), (Ej, Fj, E_stdj, F_stdj) in zip(batch, ref):
        _close(E, Ej, 1e-10)
        _close(F, Fj, 1e-10)
        # variances against the band's largest (components with zero
        # prior variance sit at the rounding floor)
        _close(E_std ** 2, E_stdj ** 2, 1e-10)
        _close(F_std ** 2, F_stdj ** 2, 1e-10)
    plain = gp.predict_structures(band)
    for (E, F), (Eb, Fb, _, _) in zip(plain, batch):
        assert E == Eb
        np.testing.assert_array_equal(F, Fb)


def test_predict_structures_with_every_atom_fixed():
    """The degenerate band with no free atom stays on the batched path:
    zero forces and force stds, the energies of predict_structure and of
    the JAX package."""
    gp, jgp = _model(T), _model(J)
    band = _band(T, fixed=True)
    batch = gp.predict_structures(band, return_std=True)
    ref = jgp.predict_structures(_band(J, fixed=True), return_std=True)
    for s, (E, F, E_std, F_std), (Ej, _, E_stdj, _) in zip(band, batch, ref):
        E1, _, _, E_std1, _ = gp.predict_structure(s, return_std=True)
        np.testing.assert_array_equal(F, 0.0)
        np.testing.assert_array_equal(F_std, 0.0)
        np.testing.assert_allclose(E, E1, rtol=1e-10)
        np.testing.assert_allclose(E_std, E_std1, rtol=1e-6, atol=1e-10)
        _close(E, Ej, 1e-10)
        _close(E_std ** 2, E_stdj ** 2, 1e-10)


def test_float32_band_serves_as_one_at_a_time():
    """A float32 model serves from float64 descriptors rounded once, K_EE
    rounded once from float64 and a float64 variance against its float64
    factor: a band agrees with its structures served one at a time within
    1e-3 of the noise (E and sigma_E of the structure, F and sigma_F),
    and with the float64 model of the same training set within a tenth."""
    import torch
    from gpr_calculator_tpu_torch import convert
    gp = _model(T)
    state = convert.state_of(gp)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key)
    g32 = convert.gp_from_state(state, device="cpu", dtype=torch.float32,
                                log_file=None)
    g32.fit(opt=False, show=False)
    assert g32.L_.dtype == torch.float64
    band = _band(T)
    batch = g32.predict_structures(band, return_std=True)
    ref = gp.predict_structures(band, return_std=True)
    for s, (E, F, E_std, F_std), other in zip(band, batch, ref):
        E1, F1, _, E_std1, F_std1 = g32.predict_structure(s, return_std=True)
        n = len(s)
        for tol, (E2, F2, E_std2, F_std2) in (
                (1e-3, (E1, F1, E_std1, F_std1)), (1e-1, other)):
            assert abs(E - E2) <= tol * NOISE_E * n
            assert abs(E_std - E_std2) * n <= tol * NOISE_E * n
            assert np.abs(F - F2).max() <= tol * NOISE_F
            assert np.abs(F_std - F_std2).max() <= tol * NOISE_F


@pytest.mark.parametrize("pair_budget", [None, 300, 1])
def test_calculate_many_matches_calculate_and_jax(pair_budget):
    """One core call per group of structures under the pair budget
    (None: one group; 300: two structures a group; 1: one a group)
    against one calculate a structure (1e-12) and the JAX package's
    calculate_many (1e-10); the device half keeps calculate_device's
    zero pad row."""
    band = _band(T)
    so3 = T.SO3(nmax=3, lmax=4, rcut=5.0)
    many = so3.calculate_many(band, pair_budget=pair_budget)
    ref = J.SO3(nmax=3, lmax=4, rcut=5.0).calculate_many(
        _band(J), pair_budget=pair_budget)
    dev = so3.calculate_many_device(band, pair_budget=pair_budget)
    for a, m, r, d in zip(band, many, ref, dev):
        one = so3.calculate(a)
        for key in ("x", "dxdr"):
            _close(m[key], one[key], 1e-12)
            _close(m[key], r[key], 1e-10)
        np.testing.assert_array_equal(m["seq"], one["seq"])
        assert m["elements"] == one["elements"] and m["rdxdr"] is None
        nseq = d["nseq"]
        assert d["dxdr"].shape[0] == nseq + 1
        np.testing.assert_array_equal(d["dxdr"][nseq].numpy(), 0.0)
        _close(d["dxdr"][:nseq].numpy(), one["dxdr"], 1e-12)
        _close(d["x"].numpy(), one["x"], 1e-12)


def test_default_pair_budget_on_the_cpu():
    assert T.SO3().default_pair_budget("cpu") == 262144


def test_convert_train_data_of_many_matches_one_at_a_time():
    gp = _model(T)
    images = T.au_on_al100_images()
    data = [(images[k], e, f) for k, (e, f) in zip((0, 4, 2), _labels())]
    many = gp.convert_train_data(data)
    ones = [gp.convert_train_data([d]) for d in data]
    assert len(many["energy"]) == 3
    assert len(many["force"]) == sum(len(o["force"]) for o in ones)
    for k, one in enumerate(ones):
        x, e, ele = many["energy"][k]
        _close(x, one["energy"][0][0], 1e-12)
        assert e == one["energy"][0][1]
        np.testing.assert_array_equal(ele, one["energy"][0][2])
        assert many["db"][k][4] == one["db"][0][4]
    flat = [p for o in ones for p in o["force"]]
    for p, q in zip(many["force"], flat):
        for u, v in zip(p, q):
            _close(u, v, 1e-12)
