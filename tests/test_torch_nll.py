"""The port's training path (gpr_calculator_tpu_torch) against the JAX
package: the dual (K, dK/dgamma) blocks, k_self_dual, the analytic NLL
and its gradient, and GP.set_GPR's fitted hyperparameters.

CPU only: float32 plain versions against the Pallas kernels in interpret
mode at mode="highest" (the tolerances of tests/test_kff_pallas.py), and
float64 against the JAX XLA builds and the JAX NLL at 1e-10.  The
gradient is also held against torch.autograd of the NLL through the
plain blocks, as tests/test_analytic_grad.py does for the JAX package.
"""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch.models import gp as gp_mod
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu, PARAMS, make_points  # noqa: F401 (fixture)


# (sigma, l) of the JAX package's GP.set_GPR(images, EMT(),
# noise_e=0.05/13, noise_f=0.05) on au_on_al100_images(), CPU float64
SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527
NOISE_E, NOISE_F = 0.05 / 13, 0.05


def _data(seed, dtype, m_e=3, m_f=5):
    """Ragged energy/force blocks with padded envs and a padded point on
    each side, the same points for both packages."""
    rng = np.random.RandomState(seed)
    fp = make_points(rng, m_f, 6, 30)
    ep = [(x, el) for x, _, el in make_points(rng, m_e, 7, 30)]
    y = rng.randn(m_e + 1 + 3 * (m_f + 1)) * 0.1
    shape = dict(e=dict(m_pad=m_e + 1, a_pad=8), f=dict(m_pad=m_f + 1,
                                                        b_pad=8))
    kw = dict(device="cpu", dtype=dtype)
    e, f = pack_energy(ep, **shape["e"], **kw), pack_force(fp, **shape["f"],
                                                            **kw)
    # labels only on real rows, as GP._y_vector makes them
    y[m_e] = 0.0
    y[-3:] = 0.0
    return e, f, y, (ep, fp, shape)


def _jax_data(ep, fp, shape):
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    return jpe(ep, **shape["e"]), jpf(fp, **shape["f"])


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# dual blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_plain_dual_f32_matches_pallas_interpret(zeta):
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kff_pallas as P
    e, f, _, raw = _data(40 + zeta, torch.float32)
    je, jf = _jax_data(*raw)
    p32 = {"sigma": jnp.asarray(PARAMS["sigma"], jnp.float32),
           "l": jnp.asarray(PARAMS["l"], jnp.float32)}
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = kff.energy_operand(e)
    X, re = kff.force_operand(f)
    e_lhs, _, e_w = P.energy_operand(je, "highest")
    f_lhs, f_rhs, f_re = P.force_operand(jf, "highest", P.TPC)
    kw = dict(zeta=zeta, interpret=True, deriv=False, mode="highest",
              dual=True)
    ff = P.kff_from_ops(p32, f_lhs, f_re, f_rhs, f_re, B1=B, B2=B,
                        symmetric=True, **kw)
    ef = P.kef_from_ops(p32, e_lhs, e_w, f_rhs, f_re, A1=A, B2=B, **kw)
    ours_ff = kff.kff_plain(X, re, B, X, re, B, PARAMS, zeta,
                            symmetric=True, dual=True)
    ours_ef = kff.kef_plain(U, w, A, X, re, B, PARAMS, zeta, dual=True)
    nf, ne = 3 * f.m, e.m
    # 3e-5 max|ref|: the bound tests/test_kff_pallas.py:84-90 holds the
    # Pallas dK/dgamma build to (f32, sums in another order)
    for plane in range(2):
        _close(ours_ff[plane].numpy(), np.asarray(ff[plane])[:nf, :nf],
               3e-5)
        _close(ours_ef[plane].numpy(), np.asarray(ef[plane])[:ne, :nf],
               3e-5)


@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_plain_dual_f64_matches_xla(zeta):
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    e, f, _, raw = _data(50 + zeta, torch.float64)
    je, jf = _jax_data(*raw)
    jp = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = kff.energy_operand(e)
    X, re = kff.force_operand(f)
    ours = {
        "ff": kff.kff_plain(X, re, B, X, re, B, PARAMS, zeta,
                            symmetric=True, dual=True),
        "ef": kff.kef_plain(U, w, A, X, re, B, PARAMS, zeta, dual=True),
        "ee": kff.kee_from_ops(U, w, A, U, w, A, PARAMS, zeta, dual=True),
    }
    for plane, kind in enumerate(("rbf", "rbf_dgamma")):
        refs = {"ff": JK.kff(jf, jf, jp, kind, zeta),
                "ef": JK.kef(je, jf, jp, kind, zeta),
                "ee": JK.kee(je, je, jp, kind, zeta)}
        for name, ref in refs.items():
            _close(ours[name][plane].numpy(), ref, 1e-10)


def test_plain_dual_equals_separate_planes():
    """The K plane of a dual pass is the plain single pass, exactly."""
    e, f, _, _ = _data(61, torch.float64)
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = kff.energy_operand(e)
    X, re = kff.force_operand(f)
    assert torch.equal(
        kff.kff_plain(X, re, B, X, re, B, PARAMS, 2, symmetric=True,
                      dual=True)[0],
        kff.kff_plain(X, re, B, X, re, B, PARAMS, 2, symmetric=True))
    assert torch.equal(kff.kef_plain(U, w, A, X, re, B, PARAMS, 2,
                                     dual=True)[0],
                       kff.kef_plain(U, w, A, X, re, B, PARAMS, 2))
    assert torch.equal(kff.kee_from_ops(U, w, A, U, w, A, PARAMS, 2,
                                        dual=True)[0],
                       kff.kee_from_ops(U, w, A, U, w, A, PARAMS, 2))
    # the rectangular dual pass (K3-dual) gives the same planes, and a
    # dual pass with deriv=True (already in it) raises
    rect = kff.kff_from_ops(X, re, B, X, re, B, PARAMS, 2, dual=True)
    assert torch.equal(rect[0], kff.kff_plain(X, re, B, X, re, B, PARAMS, 2))
    with pytest.raises(ValueError, match="dual already includes"):
        kff.kff_from_ops(X, re, B, X, re, B, PARAMS, 2, dual=True,
                         deriv=True)


@pytest.mark.parametrize("zeta", [2, 3])
def test_k_self_dual_matches_jax(zeta):
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    e, f, _, raw = _data(70 + zeta, torch.float64)
    je, jf = _jax_data(*raw)
    jp = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    K, Kd = TK.k_self_dual(e, f, PARAMS, zeta)
    Kj, Kdj = JK.k_self_dual(je, jf, jp, zeta)
    _close(K.numpy(), Kj, 1e-10)
    _close(Kd.numpy(), Kdj, 1e-10)
    assert torch.equal(K, K.T) and torch.equal(Kd, Kd.T)
    _close(K.numpy(), TK.k_self(e, f, PARAMS, zeta).numpy(), 1e-14)


# ---------------------------------------------------------------------------
# the analytic NLL
# ---------------------------------------------------------------------------

def _theta(noise_opt):
    return [1.7, 0.8] + ([0.02] if noise_opt else [])


@pytest.mark.parametrize("noise_opt", [False, True])
@pytest.mark.parametrize("zeta", [2, 3])
def test_nll_matches_jax(zeta, noise_opt):
    import jax.numpy as jnp
    from gpr_calculator_tpu.models.gp import _nll_rbf_analytic as jax_nll
    e, f, y, raw = _data(80 + zeta, torch.float64)
    je, jf = _jax_data(*raw)
    theta = _theta(noise_opt)
    nll, g = gp_mod._nll_rbf_analytic(theta, e, f, torch.as_tensor(y),
                                      (0.01, 0.1), 10.0, zeta, noise_opt)
    nll_j, g_j = jax_nll(jnp.asarray(theta), je, jf, jnp.asarray(y),
                         jnp.asarray([0.01, 0.1]), jnp.asarray(10.0), zeta,
                         noise_opt, 0)
    np.testing.assert_allclose(float(nll), float(nll_j), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-10)


@pytest.mark.parametrize("noise_opt", [False, True])
def test_nll_gradient_matches_autograd(noise_opt):
    e, f, y, _ = _data(90, torch.float64)
    y = torch.as_tensor(y)
    theta = _theta(noise_opt)
    nll, g = gp_mod._nll_rbf_analytic(theta, e, f, y, (0.01, 0.1), 10.0,
                                      2, noise_opt)
    t = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    noise_e = t[2] if noise_opt else 0.01
    noise_f = 10.0 * t[2] if noise_opt else 0.1
    K = TK.k_self(e, f, {"sigma": t[0], "l": t[1]}, 2)
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


def test_non_pd_covariance_gives_inf_and_zero_gradient(monkeypatch):
    """A noise diagonal that makes K indefinite: cholesky_ex reports it,
    the NLL is +inf, and the L-BFGS-B objective and the LML back off."""
    e, f, y, raw = _data(95, torch.float64)
    gp = T.GP(kernel=T.RBF(para=[0.01, 1.0]), descriptor=None,
              log_file=None, device="cpu", dtype=torch.float64)
    ep, fp, _ = raw
    gp.set_train_pts({
        "energy": [(x, 0.1, el) for x, el in ep],
        "force": [(x, dx, np.full(3, 0.1), el) for x, dx, el in fp]})
    monkeypatch.setattr(gp_mod, "_noise_diag",
                        lambda e, f, ne, nf: -torch.ones(
                            e.m + 3 * f.m, dtype=e.x.dtype))
    nll, g = gp_mod._nll_rbf_analytic([0.01, 1.0], e, f, torch.as_tensor(y),
                                      (0.01, 0.1), 10.0, 2, False)
    assert float(nll) == np.inf and torch.equal(g, torch.zeros(2,
                                                               dtype=g.dtype))
    te, tf = gp._pack(gp.N_energy, gp.N_forces)
    ty = gp._y_vector(te, tf, gp.N_energy, gp.N_forces)
    val, grad = gp._objective(te, tf, ty, False)([0.01, 1.0])
    assert val == np.inf and np.array_equal(grad, np.zeros(2))
    lml, glml = gp.log_marginal_likelihood([0.01, 1.0], eval_gradient=True)
    assert lml == -np.inf and np.array_equal(glml, np.zeros(2))


def test_log_marginal_likelihood_matches_jax():
    """The LML and its gradient of a GP holding JAX-packed training data:
    the JAX package pads its blocks to buckets, the port does not; the
    LML must not see the padding."""
    import gpr_calculator_tpu as J
    _, _, _, (ep, fp, _) = _data(97, torch.float64)
    data = {"energy": [(x, 0.05 * k, el) for k, (x, el) in enumerate(ep)],
            "force": [(x, dx, np.linspace(-0.2, 0.2, 3) * k, el)
                      for k, (x, dx, el) in enumerate(fp)]}
    gps = []
    for pkg, kw in ((T, dict(device="cpu")), (J, {})):
        gp = pkg.GP(kernel=pkg.RBF(para=[1.2, 0.9]), descriptor=None,
                    noise_e=0.01, noise_f=0.1, log_file=None, **kw)
        gp.set_train_pts(data)
        gps.append(gp)
    for theta in ([1.2, 0.9], [0.7, 1.6]):
        lml, g = gps[0].log_marginal_likelihood(theta, eval_gradient=True)
        lml_j, g_j = gps[1].log_marginal_likelihood(theta,
                                                    eval_gradient=True)
        np.testing.assert_allclose(lml, lml_j, rtol=1e-10)
        np.testing.assert_allclose(g, g_j, rtol=1e-10)


def test_set_gpr_reproduces_jax_theta():
    images = T.au_on_al100_images()
    gp = T.GP.set_GPR(images, T.EMT(), noise_e=NOISE_E, noise_f=NOISE_F,
                      log_file=None, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(gp.kernel.parameters(), [SIGMA, L_SCALE],
                               rtol=1e-6)
    assert (gp.N_energy, gp.N_forces, gp.fits) == (5, 15, 1)
    assert all(im.calc is None for im in images)
    # the same training set under the Dot kernel: its analytic NLL
    gp.kernel = T.Dot(zeta=2)
    lml, g = gp.log_marginal_likelihood([2.0, 2.0], eval_gradient=True)
    assert np.isfinite(lml) and g.shape == (2,) and np.all(np.isfinite(g))
