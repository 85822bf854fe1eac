"""The Hutchinson estimate of the NLL gradient's traces in the port
(``GP(trace=, n_probe=)``, ``models/gp.py``) against the JAX package's
``trace_mode="hutch"`` and against the exact trace, on the CPU in
float64, and the RBF NLL's covariance assembled as ``_factorize``'s.

Tolerances: with the JAX package's own probe block passed as
``probes=`` both NLLs and their gradients equal JAX's at 1e-10 of the
largest magnitude; the NLL value of the estimate equals the exact one bit
for bit (only the gradient's traces are estimated); the estimated
gradient is within 5 % of the exact one at 2048 probes
(tests/test_hutch_trace.py's bound); the gate, its cache and the exact
rerun are checked by what they decide."""
import numpy as np
import pytest
import scipy.optimize
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch.models import gp as gp_mod
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

FNS = {"rbf": (gp_mod._nll_rbf_analytic, [1.7, 0.8]),
       "dot": (gp_mod._nll_dot_analytic, [1.7, 1.1])}


def _points(rng, n, envs, d=8):
    pts = []
    for _ in range(n):
        ne = rng.randint(envs - 1, envs + 1)
        pts.append((rng.uniform(0.2, 1.0, (ne, d)),
                    rng.uniform(-1.0, 1.0, (ne, d, 3)),
                    rng.choice([13, 79], ne)))
    return pts


def _data(seed=1, dtype=torch.float64):
    """6 energy and 40 force points padded to 8 and 48 (152 rows), the
    labels, and the raw points for the JAX package."""
    rng = np.random.RandomState(seed)
    ep = [(x, el) for x, _, el in _points(rng, 6, 6)]
    fp = _points(rng, 40, 6)
    e = pack_energy(ep, m_pad=8, a_pad=8, dtype=dtype)
    f = pack_force(fp, m_pad=48, b_pad=8, dtype=dtype)
    y = rng.randn(e.m + 3 * f.m) * 0.1
    return e, f, y, (ep, fp)


def _theta(kind, noise_opt):
    return FNS[kind][1] + ([0.02] if noise_opt else [])


@pytest.mark.parametrize("noise_opt", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_hutch_nll_matches_jax_with_its_probes(kind, noise_opt):
    """The JAX package's probe block (jax.random.rademacher(PRNGKey(0),
    (n, p))) passed as probes=: value and gradient equal JAX's
    trace_mode="hutch" at 1e-10."""
    import jax
    import jax.numpy as jnp
    from gpr_calculator_tpu.models import gp as jgp
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    e, f, y, (ep, fp) = _data()
    je, jf = jpe(ep, m_pad=8, a_pad=8), jpf(fp, m_pad=48, b_pad=8)
    n, p = len(y), 256
    Z = np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (n, p)),
                   np.float64)
    jfn = getattr(jgp, FNS[kind][0].__name__)
    th = _theta(kind, noise_opt)
    jv, jg = jfn(jnp.asarray(th), je, jf, jnp.asarray(y),
                 jnp.asarray([0.01, 0.1]), jnp.asarray(10.0), 2, noise_opt, 0,
                 trace_mode="hutch", n_probe=p)
    v, g = FNS[kind][0](th, e, f, torch.as_tensor(y), (0.01, 0.1), 10.0, 2,
                        noise_opt, trace="hutch", probes=torch.as_tensor(Z))
    jg = np.asarray(jg)
    assert abs(float(v) - float(jv)) <= 1e-10 * abs(float(jv))
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-10 * np.abs(jg).max())


@pytest.mark.parametrize("noise_opt", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_hutch_value_is_exact_and_gradient_close(kind, noise_opt,
                                                 monkeypatch):
    """With the port's own fixed probes (2048) the NLL value equals the
    exact trace's bit for bit, the gradient is within 5 % of it, and the
    estimate never forms K^-1 (cholesky_inverse would raise)."""
    e, f, y, _ = _data()
    fn, th = FNS[kind][0], _theta(kind, noise_opt)
    args = (th, e, f, torch.as_tensor(y), (0.01, 0.1), 10.0, 2, noise_opt)
    v_e, g_e = fn(*args)

    def no_inverse(*a, **k):
        raise AssertionError("the Hutchinson path formed K^-1")
    monkeypatch.setattr(torch, "cholesky_inverse", no_inverse)
    v_h, g_h = fn(*args, trace="hutch", n_probe=2048)
    assert float(v_h) == float(v_e)
    err = float((g_h - g_e).norm() / g_e.norm())
    assert err < 0.05, err


def test_probe_block_is_drawn_once_and_kept():
    """Z is a float64 +-1 block from a generator seeded 0 on the model's
    device, drawn once per (n, n_probe) and kept by the GP."""
    gp = T.GP(kernel=T.RBF(), descriptor=T.SO3(), log_file=None, n_probe=16)
    Z = gp._probe_block(40)
    assert Z.dtype == torch.float64 and tuple(Z.shape) == (40, 16)
    assert set(Z.unique().tolist()) == {-1.0, 1.0}
    assert gp._probe_block(40) is Z
    assert torch.equal(Z, gp_mod._probe_block(40, 16, "cpu"))
    assert gp._probe_block(41).shape == (41, 16)


def test_trace_mode_resolution():
    """"auto" takes the estimate from _HUTCH_MIN_N = 6144 rows (the JAX
    package's switch), "exact" and "hutch" at every size; anything else
    raises, in the GP's constructor too."""
    n0 = gp_mod._HUTCH_MIN_N
    assert n0 == 6144
    assert gp_mod._resolve_trace_mode(n0 - 1, "auto") == "exact"
    assert gp_mod._resolve_trace_mode(n0, "auto") == "hutch"
    assert gp_mod._resolve_trace_mode(10 ** 6, "exact") == "exact"
    assert gp_mod._resolve_trace_mode(8, "hutch") == "hutch"
    with pytest.raises(ValueError, match="trace"):
        gp_mod._resolve_trace_mode(8, "scan")
    with pytest.raises(ValueError, match="trace"):
        T.GP(log_file=None, trace="scan")
    assert T.GP(log_file=None).trace == "exact"


def _structs(n=4, natoms=5, seed=77):
    """Jittered near-fcc Cu clusters (tests/test_gp.py's make_structs)."""
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a],
                     [0, 0.5 * a, 0.5 * a], [a, a, 0], [a, 0, a]])[:natoms]
    return [T.Atoms(numbers=[29] * natoms,
                    positions=grid + 0.12 * rng.randn(natoms, 3),
                    cell=np.eye(3) * 12, pbc=False) for _ in range(n)]


def _small_gp(seed=77, **kw):
    """tests/test_hutch_trace.py's _small_gp on the port (RBF, 4 EMT Cu
    clusters)."""
    gp = T.GP(kernel=T.RBF(para=[1.0, 1.0]),
              descriptor=T.SO3(nmax=2, lmax=2, rcut=4.0),
              noise_e=0.01, noise_f=0.1, log_file=None, **kw)
    calc = T.EMT()
    for s in _structs(seed=seed):
        s.calc = calc
        e, f = s.get_potential_energy(), s.get_forces()
        s.calc = None
        gp.add_structure((s, e, f))
    return gp


def test_fit_gate_accepts_good_estimator(monkeypatch):
    """trace="auto" with enough probes: the gate keeps hutch, and the
    optimised hyperparameters reach an exact NLL within L-BFGS-B's ftol
    (1e-2) of an exact fit's.  (Here sigma sits at its bound and the NLL
    is flat in l: l moves with the probe draw, 1.79 with the JAX
    package's, 1.97 with the port's, 1.79 exact.)"""
    monkeypatch.setattr(gp_mod, "_HUTCH_MIN_N", 1)
    gp = _small_gp(trace="auto", n_probe=4096)
    gp.fit(show=False, opt=True, maxiter=8)
    assert gp._nll_trace_used == "hutch" and gp._trace_gate[1] == "hutch"
    ref = _small_gp()
    ref.fit(show=False, opt=True, maxiter=8)
    assert ref._nll_trace_used == "exact" and ref._trace_gate is None
    lml = ref.log_marginal_likelihood(gp.kernel.parameters())
    lml_ref = ref.log_marginal_likelihood(ref.kernel.parameters())
    assert abs(lml - lml_ref) <= 1e-2 * abs(lml_ref)


def test_fit_gate_rejects_bad_estimator(monkeypatch):
    """One probe cannot give the exact gradient: the gate measures the
    disagreement and the fit takes the exact trace."""
    monkeypatch.setattr(gp_mod, "_HUTCH_MIN_N", 1)
    monkeypatch.setattr(gp_mod.GP, "_HUTCH_GATE_RTOL", 1e-6)
    gp = _small_gp(trace="auto", n_probe=1)
    gp.fit(show=False, opt=True, maxiter=4)
    assert gp._nll_trace_used == "exact" and gp._trace_gate[1] == "exact"


def test_explicit_hutch_skips_gate():
    """trace="hutch" is an explicit choice: no exact comparison runs."""
    gp = _small_gp(trace="hutch", n_probe=2048)
    gp.fit(show=False, opt=True, maxiter=4)
    assert gp._nll_trace_used == "hutch" and gp._trace_gate is None


def _count_exact(gp, monkeypatch):
    """Count the GP's exact-trace NLL evaluations."""
    calls = {"exact": 0}
    real = gp._nll_fn

    def spy(trace="exact"):
        fn = real(trace)

        def call(*a):
            calls[trace] = calls.get(trace, 0) + 1
            return fn(*a)
        return call
    monkeypatch.setattr(gp, "_nll_fn", spy)
    return calls


def test_gate_verdict_goes_stale_with_new_data(monkeypatch):
    """The gate's verdict is kept for one training-data version and
    theta0: asked again it measures nothing; after a training set of the
    same size is put in its place (the case the JAX package's size-keyed
    cache got wrong) or a structure is added, it measures again."""
    monkeypatch.setattr(gp_mod, "_HUTCH_MIN_N", 1)
    gp = _small_gp(trace="auto", n_probe=512)
    calls = _count_exact(gp, monkeypatch)
    theta0, _, noise_opt = gp._theta()

    def gate():
        e, f = gp._pack(gp.N_energy, gp.N_forces)
        y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
        return gp._gated_trace_mode(e, f, y, theta0, noise_opt)
    gate()
    gate()
    assert calls["exact"] == 1
    # the same points with other labels: a set of the same size
    gp.set_train_pts({
        "energy": [(x, 1.1 * y, el) for (x, el), y
                   in zip(gp._energy_pts, gp._energy_y)],
        "force": [(x, dx, 1.1 * y, el) for (x, dx, el), y
                  in zip(gp._force_pts, gp._force_y)]}, mode="w")
    gate()
    assert calls["exact"] == 2
    s = _structs(n=1, seed=9)[0]
    s.calc = T.EMT()
    gp.add_structure((s, s.get_potential_energy(), s.get_forces()))
    gate()
    assert calls["exact"] == 3


def test_exact_rerun_after_line_search_failure(monkeypatch):
    """With the estimated traces L-BFGS-B pairs an exact value with an
    estimated gradient; a run that ends in a failed line search (status
    2) is run once more with the exact trace, and the fit records it."""
    gp = _small_gp(trace="hutch", n_probe=64)
    calls = _count_exact(gp, monkeypatch)
    runs = []

    def failing_first(fun, x0, **kw):
        res = scipy.optimize.minimize(fun, x0, **kw)
        runs.append(res.status)
        if len(runs) == 1:
            res.status, res.success = 2, False
            res.message = "ABNORMAL_TERMINATION_IN_LNSRCH"
        return res
    monkeypatch.setattr(gp_mod, "minimize", failing_first)
    gp.fit(show=False, opt=True, maxiter=4)
    assert len(runs) == 2 and calls["exact"] > 0
    assert gp._nll_trace_used == "exact"

    gp2 = _small_gp(trace="hutch", n_probe=64)
    runs.clear()
    monkeypatch.setattr(gp_mod, "minimize",
                        lambda fun, x0, **kw: runs.append(0)
                        or scipy.optimize.minimize(fun, x0, **kw))
    gp2.fit(show=False, opt=True, maxiter=4)
    assert len(runs) == 1 and gp2._nll_trace_used == "hutch"


def test_log_marginal_likelihood_stays_exact():
    """The user-facing LML never estimates: a trace="hutch" model gives
    the exact LML and gradient bit for bit."""
    th = [1.1, 0.9]
    lml, g = _small_gp(trace="hutch").log_marginal_likelihood(
        th, eval_gradient=True)
    lml2, g2 = _small_gp().log_marginal_likelihood(th, eval_gradient=True)
    assert lml == lml2
    np.testing.assert_array_equal(g, g2)


def test_rbf_nll_covariance_is_factorize_covariance(monkeypatch):
    """With float32 data (the card's working dtype) the RBF NLL factorises
    the K that _factorize does, bit for bit: K_EE computed in float64
    from the rounded operands, the force blocks cast, the noise added in
    float64 (k_self_dual(dtype=float64) against k_self(dtype=float64))."""
    e, f, y, _ = _data(3, torch.float32)
    seen = []
    real = gp_mod._chol_mesh

    def spy(K, mesh, chol_mode="replicated"):
        seen.append(K.clone())
        return real(K, mesh, chol_mode)
    monkeypatch.setattr(gp_mod, "_chol_mesh", spy)
    params = {"sigma": 1.7, "l": 0.8}
    gp_mod._nll_rbf_analytic([1.7, 0.8], e, f, torch.as_tensor(y).float(),
                             (0.01, 0.1), 10.0, 2, False)
    gp_mod._factorize(e, f, torch.as_tensor(y).float(), params, 0.01, 0.1, 2)
    assert len(seen) == 2 and seen[0].dtype == torch.float64
    assert torch.equal(seen[0], seen[1])
