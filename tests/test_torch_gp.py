"""The port's GP against the JAX package's GP at the same hyperparameters,
through convert.py: the training covariance, the serving cross-covariance,
the weights of fit(opt=False) and predict_structure, float64, 1e-8
relative.  Standard deviations are compared as variances against the
largest variance of the request: sigma = sqrt(max(var, 0)), and
components with zero prior variance (symmetry) leave var at the rounding
floor, whose square root is not reproducible."""
import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu.ops import kernels as JK
from gpr_calculator_tpu_torch import convert
from gpr_calculator_tpu_torch.ops import kernels as TK

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)


# (sigma, l) of the JAX package's GP.set_GPR(images, EMT(),
# noise_e=0.05/13, noise_f=0.05) on au_on_al100_images(), CPU float64
SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527
NOISE_E, NOISE_F = 0.05 / 13, 0.05
RTOL = 1e-8


def _jax_atoms(a):
    return J.Atoms(numbers=a.numbers, positions=a.positions,
                   cell=a.cell.array, pbc=a.pbc,
                   constraints=[J.FixAtoms(indices=a.fixed_indices())])


@pytest.fixture(scope="module")
def models():
    images = T.au_on_al100_images()
    jgp = J.GP(kernel=J.RBF(para=[SIGMA, L_SCALE], zeta=2),
               descriptor=J.SO3(nmax=3, lmax=4, rcut=5.0),
               noise_e=NOISE_E, noise_f=NOISE_F, log_file=None)
    for k in (0, 1, 2):
        a = _jax_atoms(images[k])
        a.calc = J.EMT()
        e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
        a.calc = None
        jgp.add_structure((a, e, f))
    jgp.fit(opt=False, show=False)
    state = convert.state_of(jgp)
    fresh = {k: v for k, v in state.items()
             if k not in ("alpha", "L", "n_fit")}
    tgp = convert.gp_from_state(fresh, device="cpu", log_file=None)
    tgp.fit(opt=False, show=False)
    return images, jgp, tgp, state


def _close(ours, ref, rtol=RTOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _real(e, n_e, n_f):
    return np.r_[np.arange(n_e), e.m + np.arange(3 * n_f)]


def test_k_self_matches_jax(models):
    _, jgp, tgp, _ = models
    je, jf, n_e, n_f = jgp._train_view()
    te, tf, _, _ = tgp._fit_snapshot
    Kj = np.asarray(JK.k_self(je, jf, jgp.kernel.jax_params(), "rbf", 2))
    Kt = TK.k_self(te, tf, tgp.kernel.params(), 2).numpy()
    r = _real(je, n_e, n_f)
    _close(Kt, Kj[np.ix_(r, r)])


def test_k_block_matches_jax(models):
    images, jgp, tgp, _ = models
    d = tgp.descriptor.calculate(images[3])
    ele = np.asarray(images[3].numbers)
    from gpr_calculator_tpu_torch.models.gp import _group_force_points
    fpts = _group_force_points(d, ele, range(8, 13))
    epts = [(d["x"], ele)]
    je, jf, n_e, n_f = jgp._train_view()
    te, tf, _, _ = tgp._fit_snapshot
    from gpr_calculator_tpu.ops.packing import pack_energy, pack_force
    Kj = np.asarray(JK.k_block(pack_energy(epts), pack_force(fpts), je, jf,
                               jgp.kernel.jax_params(), "rbf", 2))
    from gpr_calculator_tpu_torch.ops.packing import (
        pack_energy as tpe, pack_force as tpf)
    Kt = TK.k_block(tpe(epts, device="cpu"), tpf(fpts, device="cpu"), te,
                    tf, tgp.kernel.params(), 2).numpy()
    _close(Kt, Kj[:, _real(je, n_e, n_f)])


def test_fit_weights_match_jax(models):
    _, _, tgp, state = models
    _close(tgp.alpha_.numpy(), state["alpha"])


def _same_prediction(ours, ref):
    E, F, _, sE, sF = ours
    Ej, Fj, _, sEj, sFj = ref
    assert abs(E - Ej) <= RTOL * abs(Ej)
    _close(F, Fj)
    _close(np.r_[sE, np.ravel(sF)] ** 2, np.r_[sEj, np.ravel(sFj)] ** 2)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_predict_structure_matches_jax(models, k):
    images, jgp, tgp, _ = models
    ours = tgp.predict_structure(images[k], return_std=True)
    ref = jgp.predict_structure(_jax_atoms(images[k]), return_std=True)
    _same_prediction(ours, ref)


def test_carried_weights_and_factor_serve_like_jax(models):
    images, jgp, _, state = models
    assert "L" in state
    carried = convert.gp_from_state(state, device="cpu", log_file=None)
    assert carried.fits == 0
    ours = carried.predict_structure(images[3], return_std=True)
    ref = jgp.predict_structure(_jax_atoms(images[3]), return_std=True)
    _same_prediction(ours, ref)


def test_fit_with_optimisation_raises(models):
    """fit(opt=True) trains the RBF and the Dot kernel (a Dot model on the
    RBF model's training set optimises (sigma, sigma0) and serves); a
    kernel family without an NLL raises."""
    images, _, tgp, state = models
    fresh = {k: v for k, v in state.items() if k not in ("alpha", "L",
                                                         "n_fit")}
    dot = convert.gp_from_state(fresh, device="cpu", log_file=None)
    dot.kernel = T.Dot(para=[2.0, 2.0], zeta=2)
    dot.fit(opt=True, show=False)
    assert dot.fits == 1 and dot.kernel.parameters() != [2.0, 2.0]
    E, F, _ = dot.predict_structure(images[3])
    assert np.isfinite(E) and np.all(np.isfinite(F))
    other = convert.gp_from_state(fresh, device="cpu", log_file=None)
    other.kernel.kind = "poly"
    with pytest.raises(NotImplementedError, match="no NLL"):
        other.fit(opt=True, show=False)
    assert other.fits == 0 and tgp.kernel.kind == "rbf"


def test_train_y_matches_jax(models):
    _, jgp, tgp, _ = models
    ours, ref = tgp.train_y, jgp.train_y
    assert ours.keys() == ref.keys()
    _close(ours["energy"], ref["energy"])
    _close(np.asarray(ours["force"]), np.asarray(ref["force"]))
    assert len(ours["force"]) == tgp.N_forces == jgp.N_forces
