"""The Dot kernel family of the PyTorch port (gpr_calculator_tpu_torch)
against the JAX package, on the CPU: the covariance blocks, count_ee, the
covariance ops, the kernel containers' block API, the analytic Dot NLL,
GP.set_GPR(kernel="Dot") and the on-the-fly NEB with the Dot kernel.

float32 plain versions are held against the Pallas kernels in interpret
mode at mm_precision="highest" (2e-5 relative, 1e-6 absolute: f32 with
the sums in another order); float64 against the JAX XLA builds and the
JAX NLL at 1e-10; the NLL gradient also against torch.autograd through
the plain float64 build.
"""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch.models import gp as gp_mod
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu, make_points  # noqa: F401 (fixture)


PARAMS = {"sigma": 1.3, "sigma0": 0.7}
NOISE_E, NOISE_F = 0.05 / 13, 0.05
# (sigma, sigma0) of the JAX package's GP.set_GPR(images, EMT(),
# kernel="Dot", zeta=2, noise_e=0.05/13, noise_f=0.05) on
# au_on_al100_images(), CPU float64
THETA = (0.5980691048753912, 1.6996223564233595)
# its on-the-fly NEB: neb_calc(images, GPR(base=EMT(), ff=gp, save=False),
# fmax=0.05, steps=150)
NSTEPS, BARRIER = 24, 0.3560402
COUNTS = (10, 64, 5, 15, 40)  # use_base, use_surrogate, fits, N_E, N_F


def _data(seed, dtype, m_e=3, m_f=5, m_f2=3):
    """Ragged energy/force blocks with padded envs and a padded point on
    each side, the same points for both packages, and labels on the real
    rows of the training covariance."""
    rng = np.random.RandomState(seed)
    fp1, fp2 = make_points(rng, m_f, 6, 30), make_points(rng, m_f2, 5, 30)
    ep = [(x, el) for x, _, el in make_points(rng, m_e, 7, 30)]
    shape = dict(e=dict(m_pad=m_e + 1, a_pad=8),
                 f1=dict(m_pad=m_f + 1, b_pad=8), f2=dict(b_pad=7))
    kw = dict(device="cpu", dtype=dtype)
    e = pack_energy(ep, **shape["e"], **kw)
    f1 = pack_force(fp1, **shape["f1"], **kw)
    f2 = pack_force(fp2, **shape["f2"], **kw)
    y = rng.randn(e.m + 3 * f1.m) * 0.1
    y[m_e] = 0.0
    y[-3:] = 0.0
    return e, f1, f2, y, (ep, fp1, fp2, shape)


def _jax_data(ep, fp1, fp2, shape):
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    return jpe(ep, **shape["e"]), jpf(fp1, **shape["f1"]), \
        jpf(fp2, **shape["f2"])


def _jax_params(dtype=None):
    import jax.numpy as jnp
    return {k: jnp.asarray(v, dtype) for k, v in PARAMS.items()}


def _ops(e, f1, f2):
    U, w = kff.energy_operand(e)
    X1, re1 = kff.force_operand(f1)
    X2, re2 = kff.force_operand(f2)
    return (U, w, e.x.shape[1]), (X1, re1, f1.x.shape[1]), \
        (X2, re2, f2.x.shape[1])


def _close(ours, ref, rtol=1e-10):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_plain_dot_f32_matches_pallas_interpret(zeta):
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops.kff_pallas import kef_pallas, kff_pallas
    e, f1, f2, _, raw = _data(110 + zeta, torch.float32)
    je, jf1, jf2 = _jax_data(*raw)
    p32 = _jax_params(jnp.float32)
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    kw = dict(zeta=zeta, interpret=True, mm_precision="highest",
              kind="dot")
    nf1, nf2, ne = 3 * f1.m, 3 * f2.m, e.m
    cases = [
        (kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, zeta, kind="dot"),
         np.asarray(kff_pallas(jf1, jf2, p32, **kw))[:nf1, :nf2]),
        (kff.kff_plain(X1, re1, B1, X1, re1, B1, PARAMS, zeta,
                       symmetric=True, kind="dot"),
         np.asarray(kff_pallas(jf1, jf1, p32, symmetric=True,
                               **kw))[:nf1, :nf1]),
        (kff.kef_plain(U, w, A, X2, re2, B2, PARAMS, zeta, kind="dot"),
         np.asarray(kef_pallas(je, jf2, p32, **kw))[:ne, :nf2]),
    ]
    for ours, ref in cases:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_plain_dot_f64_matches_xla(zeta):
    from gpr_calculator_tpu.ops import kernels as JK
    e, f1, f2, _, raw = _data(120 + zeta, torch.float64)
    je, jf1, jf2 = _jax_data(*raw)
    jp = _jax_params()
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    cases = [
        (kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, zeta, kind="dot"),
         JK.kff(jf1, jf2, jp, "dot", zeta)),
        (kff.kff_plain(X1, re1, B1, X1, re1, B1, PARAMS, zeta,
                       symmetric=True, kind="dot"),
         JK.kff(jf1, jf1, jp, "dot", zeta)),
        (kff.kef_plain(U, w, A, X2, re2, B2, PARAMS, zeta, kind="dot"),
         JK.kef(je, jf2, jp, "dot", zeta)),
        (kff.kee_from_ops(U, w, A, U, w, A, PARAMS, zeta, kind="dot"),
         JK.kee(je, je, jp, "dot", zeta)),
    ]
    for ours, ref in cases:
        _close(ours.numpy(), ref)


def test_dot_has_no_dual_pass_and_cpu_takes_plain():
    """The Dot kernel has no (K, dK/dsigma0) pass, as in the JAX package
    (sigma0 enters K_EE alone: count_ee); on CPU tensors the Dot wrappers
    take the plain versions and launch nothing."""
    e, f1, f2, _, _ = _data(130, torch.float64)
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    for call in (
            lambda: kff.kff_from_ops(X1, re1, B1, X1, re1, B1, PARAMS, 2,
                                     symmetric=True, dual=True, kind="dot"),
            lambda: kff.kef_from_ops(U, w, A, X1, re1, B1, PARAMS, 2,
                                     dual=True, kind="dot"),
            lambda: kff.kee_from_ops(U, w, A, U, w, A, PARAMS, 2, dual=True,
                                     kind="dot")):
        with pytest.raises(NotImplementedError, match="no dual pass"):
            call()
    with pytest.raises(ValueError, match="unknown kernel kind"):
        kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, 2, kind="poly")
    kff.reset_launches()
    assert torch.equal(
        kff.kff_from_ops(X1, re1, B1, X2, re2, B2, PARAMS, 2, kind="dot"),
        kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, 2, kind="dot"))
    assert torch.equal(
        kff.kff_from_ops(X1, re1, B1, X1, re1, B1, PARAMS, 2,
                         symmetric=True, kind="dot"),
        kff.kff_plain(X1, re1, B1, X1, re1, B1, PARAMS, 2, symmetric=True,
                      kind="dot"))
    assert torch.equal(
        kff.kef_from_ops(U, w, A, X2, re2, B2, PARAMS, 2, kind="dot"),
        kff.kef_plain(U, w, A, X2, re2, B2, PARAMS, 2, kind="dot"))
    assert all(n == 0 for n in kff.launches.values())


# ---------------------------------------------------------------------------
# covariance ops and the block API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zeta", [2, 3])
def test_dot_covariance_ops_match_jax(zeta):
    from gpr_calculator_tpu.ops import kernels as JK
    e, f1, f2, _, raw = _data(140 + zeta, torch.float64)
    je, jf1, jf2 = _jax_data(*raw)
    jp = _jax_params()
    _close(TK.count_ee(e).numpy(), JK.count_ee(je))
    K = TK.k_self(e, f1, PARAMS, zeta, "dot")
    _close(K.numpy(), JK.k_self(je, jf1, jp, "dot", zeta))
    m = e.m
    assert torch.equal(K[m:], K[:, m:].T)
    _close(TK.k_block(e, f2, e, f1, PARAMS, zeta, "dot").numpy(),
           JK.k_block(je, jf2, je, jf1, jp, "dot", zeta))
    _close(TK.diag_energy(e, PARAMS, zeta, "dot").numpy(),
           JK.diag_energy(je, jp, "dot", zeta))
    _close(TK.diag_force(f1, PARAMS, zeta, "dot").numpy(),
           JK.diag_force(jf1, jp, "dot", zeta))
    # count_ee is dK_EE/d(sigma0^2) / sigma^2, and a float64 result from
    # float32 operands keeps the float32 force blocks
    s2, s02 = PARAMS["sigma"] ** 2, PARAMS["sigma0"] ** 2
    ee = K[:m, :m] - TK.k_self(e, f1, {"sigma": PARAMS["sigma"],
                                       "sigma0": 0.0}, zeta, "dot")[:m, :m]
    _close(ee.numpy(), (s2 * s02 * TK.count_ee(e)).numpy(), 1e-14)
    e32, f32 = (type(d)(*[t.float() if torch.is_tensor(t)
                          and t.is_floating_point() else t for t in d])
                for d in (e, f1))
    K64 = TK.k_self(e32, f32, PARAMS, zeta, "dot", dtype=torch.float64)
    K32 = TK.k_self(e32, f32, PARAMS, zeta, "dot")
    assert K64.dtype == torch.float64
    assert torch.equal(K64[m:], K32[m:].double())
    _close(K64[:m, :m].numpy(), K[:m, :m].numpy(), 1e-6)


@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_block_api_matches_jax(kind):
    """k_total (self and cross), k_total_with_grad and diag of the kernel
    containers against the JAX package's."""
    _, _, _, _, (ep, fp1, fp2, _) = _data(150, torch.float64)
    para = [1.3, 0.9] if kind == "rbf" else [1.3, 0.7]
    name = "RBF" if kind == "rbf" else "Dot"
    ours = getattr(T, name)(para=para, zeta=2)
    ref = getattr(J, name)(para=para, zeta=2)
    d1 = {"energy": ep, "force": fp1}
    d2 = {"energy": ep[:2], "force": fp2}
    _close(ours.k_total(d1), ref.k_total(d1))
    _close(ours.k_total(d2, d1), ref.k_total(d2, d1))
    _close(ours.k_total({"force": fp2}, d1), ref.k_total({"force": fp2}, d1))
    K, dK = ours.k_total_with_grad(d1)
    Kj, dKj = ref.k_total_with_grad(d1)
    _close(K, Kj)
    for i in range(2):
        _close(dK[:, :, i], dKj[:, :, i])
    _close(ours.diag(d1), ref.diag(d1))
    # k_total_with_stress needs 9-column points (the strain rows
    # appended) in both packages; with them the two agree, as the
    # 9-column diagonal does
    for api in (ours, ref):
        with pytest.raises(ValueError, match="9-column"):
            api.k_total_with_stress(d1, d1)
    rng = np.random.RandomState(5)
    d9 = {"energy": ep[:2], "force": [
        (p[0], np.concatenate([p[1], rng.uniform(-1.0, 1.0, p[1].shape[:2]
                                                 + (6,))], axis=2), p[-1])
        for p in fp2]}
    for a, b in zip(ours.k_total_with_stress(d9, d1),
                    ref.k_total_with_stress(d9, d1)):
        _close(a, b)
    _close(ours.diag(d9), ref.diag(d9))


# ---------------------------------------------------------------------------
# the analytic Dot NLL
# ---------------------------------------------------------------------------

def _theta(noise_opt):
    return [1.7, 0.8] + ([0.02] if noise_opt else [])


@pytest.mark.parametrize("noise_opt", [False, True])
@pytest.mark.parametrize("zeta", [2, 3])
def test_nll_dot_matches_jax(zeta, noise_opt):
    import jax.numpy as jnp
    from gpr_calculator_tpu.models.gp import _nll_dot_analytic as jax_nll
    e, f, _, y, raw = _data(160 + zeta, torch.float64)
    je, jf, _ = _jax_data(*raw)
    theta = _theta(noise_opt)
    nll, g = gp_mod._nll_dot_analytic(theta, e, f, torch.as_tensor(y),
                                      (0.01, 0.1), 10.0, zeta, noise_opt)
    nll_j, g_j = jax_nll(jnp.asarray(theta), je, jf, jnp.asarray(y),
                         jnp.asarray([0.01, 0.1]), jnp.asarray(10.0), zeta,
                         noise_opt, 0)
    np.testing.assert_allclose(float(nll), float(nll_j), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-10)


@pytest.mark.parametrize("noise_opt", [False, True])
def test_nll_dot_gradient_matches_autograd(noise_opt):
    e, f, _, y, _ = _data(170, torch.float64)
    y = torch.as_tensor(y)
    theta = _theta(noise_opt)
    nll, g = gp_mod._nll_dot_analytic(theta, e, f, y, (0.01, 0.1), 10.0, 2,
                                      noise_opt, plain=True)
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    noise_e = t[2] if noise_opt else 0.01
    noise_f = 10.0 * t[2] if noise_opt else 0.1
    K = TK.k_self(e, f, {"sigma": t[0], "sigma0": t[1]}, 2, "dot",
                  plain=True)
    K = K + torch.diag(gp_mod._noise_diag(e, f, noise_e, noise_f))
    L = torch.linalg.cholesky(K)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    n_real = e.nreal + 3 * f.nreal
    ref = (0.5 * (y * alpha).sum() + torch.log(L.diagonal()).sum()
           + 0.5 * n_real * np.log(2 * np.pi))
    ref.backward()
    np.testing.assert_allclose(float(nll), float(ref.detach()),
                               rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-7,
                               atol=1e-9)


def test_nll_dot_non_pd_gives_inf(monkeypatch):
    e, f, _, y, _ = _data(175, torch.float64)
    monkeypatch.setattr(gp_mod, "_noise_diag",
                        lambda e, f, ne, nf: -torch.ones(
                            e.m + 3 * f.m, dtype=e.x.dtype))
    nll, g = gp_mod._nll_dot_analytic([1.0, 1.0, 0.01], e, f,
                                      torch.as_tensor(y), (0.01, 0.1), 10.0,
                                      2, True)
    assert float(nll) == np.inf and torch.equal(g, torch.zeros(3,
                                                               dtype=g.dtype))


# ---------------------------------------------------------------------------
# GP.set_GPR and the on-the-fly NEB with kernel="Dot"
# ---------------------------------------------------------------------------

def test_set_gpr_dot_reproduces_jax_theta():
    images = T.au_on_al100_images()
    gp = T.GP.set_GPR(images, T.EMT(), kernel="Dot", noise_e=NOISE_E,
                      noise_f=NOISE_F, log_file=None, device="cpu",
                      dtype=torch.float64)
    assert gp.kernel.kind == "dot" and gp.kernel.zeta == 2
    np.testing.assert_allclose(gp.kernel.parameters(), THETA, rtol=1e-6)
    assert (gp.N_energy, gp.N_forces, gp.fits) == (5, 15, 1)


def _images(pkg):
    return [pkg.Atoms(numbers=a.numbers, positions=a.positions,
                      cell=a.cell.array, pbc=a.pbc,
                      constraints=[pkg.FixAtoms(indices=a.fixed_indices())])
            for a in T.au_on_al100_images()]


def _run_neb(pkg):
    images = _images(pkg)
    gp = pkg.GP.set_GPR(images, pkg.EMT(), kernel="Dot", zeta=2,
                        noise_e=NOISE_E, noise_f=NOISE_F, log_file=None)
    band = pkg.neb_calc(images, pkg.GPR(base=pkg.EMT(), ff=gp, save=False),
                        fmax=0.05, steps=150)
    return dict(converged=bool(band.converged), nsteps=band.nsteps,
                counts=(gp.use_base, gp.use_surrogate, gp.fits,
                        gp.N_energy, gp.N_forces),
                theta=list(gp.kernel.parameters()),
                energies=np.asarray(band.energies, float))


def test_dot_onthefly_neb_matches_jax():
    ours, ref = _run_neb(T), _run_neb(J)
    for run in (ours, ref):
        assert run["converged"] and run["nsteps"] == NSTEPS
        assert run["counts"] == COUNTS
        e = run["energies"]
        assert abs(e.max() - e[0] - BARRIER) < 1e-6
    np.testing.assert_allclose(ours["theta"], ref["theta"], rtol=1e-6)
    np.testing.assert_allclose(ours["energies"], ref["energies"], rtol=0,
                               atol=1e-5)
