"""``GP.fit(opt=True)`` serving from the float64 factor of its NLL
evaluation at theta* (``GP._objective``'s slot, ``GP._kept_factor``) in
place of ``_factorize``, on the CPU: both kernel families, float32 and
float64 data, the noise fixed and optimised.  The factor and weights
equal ``_factorize``'s at the fitted hyperparameters bit for bit, and so
do the served E, F and sigma; where L-BFGS-B's result is not the last
evaluation, or that evaluation was not positive definite, ``_factorize``
runs as before, and no kept factor outlives the fit.  Both NLLs free
their K before the traces while the kept factor lives on.  The
benchmark's reader ``factor_reuse.fit`` reads the counter
``fit.factor_reuse``.

The ``gpu`` test holds the reused factor to ``_factorize``'s at the
benchmark's 10 000-row shape on the card, where the RBF NLL's K (K1-dual's
K plane) is a few float32 ulps off ``_factorize``'s (K1's):

    python -m pytest --noconftest -m gpu tests/test_torch_fit_reuse.py -q
"""
import weakref

import numpy as np
import pytest
import scipy.optimize
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import utils_profiling as up
from gpr_calculator_tpu_torch.models import gp as gp_mod
from gpr_calculator_tpu_torch.models.posterior import Posterior

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

KINDS = ["rbf", "dot"]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(autouse=True)
def recording():
    """The recorder on and empty for the test; as it was, and empty,
    after (a benchmark reader switches it on when it is loaded)."""
    was = up.enabled()
    up.clear()
    up.enable()
    yield
    if not was:
        up.disable()
    up.clear()


def _labelled(n, natoms=5, seed=3):
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a]])[:natoms]
    calc = T.EMT()
    out = []
    for _ in range(n):
        s = T.Atoms(numbers=[29, 29, 79, 29, 79][:natoms],
                    positions=grid + 0.12 * rng.randn(natoms, 3),
                    cell=np.eye(3) * 12, pbc=False)
        s.calc = calc
        e, f = s.get_potential_energy(), s.get_forces()
        s.calc = None
        out.append((s, e, f))
    return out


def _gp(kind, dtype, noise_opt=False, n=4, **kw):
    """A GP of the family on n labelled Cu/Au clusters, not yet fitted."""
    kernel = T.RBF(para=[1.0, 0.5]) if kind == "rbf" \
        else T.Dot(para=[1.0, 1.0])
    gp = T.GP(kernel=kernel, descriptor=T.SO3(nmax=2, lmax=2, rcut=4.0),
              noise_e=0.01, noise_f=0.1, log_file=None, dtype=dtype, **kw)
    if noise_opt:
        gp.noise_bounds = (1e-3, 0.1)
    for lab in _labelled(n):
        gp.add_structure(lab)
    return gp


def _factorize_calls(monkeypatch, gp):
    """Count the ``_factorize`` calls; each finds the GP's slot empty."""
    calls = []
    real = gp_mod._factorize

    def spy(*a, **kw):
        assert gp._kept is None
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(gp_mod, "_factorize", spy)
    return calls


def _reference(gp):
    """The ``Posterior`` that ``_factorize`` gives at the GP's fitted
    hyperparameters and noise, from its training set packed anew."""
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    L, alpha = gp_mod._factorize(e, f, y, gp.kernel.params(), gp.noise_e,
                                 gp.noise_f, gp.kernel.zeta, gp.kernel.kind)
    return Posterior.from_packed(e, f, L, alpha)


def _assert_same_factor(gp):
    ref = _reference(gp)
    assert torch.equal(gp.posterior.L, ref.L)
    assert torch.equal(gp.posterior.alpha, ref.alpha)
    assert gp.posterior.L.dtype == torch.float64


def _kept_refs(monkeypatch, gp):
    """A weak reference to the L the slot holds after each evaluation."""
    refs = []
    real = gp._objective

    def recording(*a, **kw):
        obj = real(*a, **kw)

        def fun(theta):
            out = obj(theta)
            refs.append(None if gp._kept is None else weakref.ref(gp._kept.L))
            return out
        return fun
    monkeypatch.setattr(gp, "_objective", recording)
    return refs


@pytest.mark.parametrize("noise_opt", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_fit_serves_the_theta_star_evaluation(monkeypatch, kind, dtype,
                                              noise_opt):
    """The fit's factor and weights are _factorize's at the fitted
    hyperparameters and noise bit for bit, _factorize is not called, the
    counter reads one, every evaluation factors with the slot empty, and
    the GP keeps no slot after the fit."""
    gp = _gp(kind, dtype, noise_opt)
    calls = _factorize_calls(monkeypatch, gp)
    chol = gp_mod._chol_mesh

    def empty_slot_chol(K, mesh, chol_mode="replicated"):
        # each evaluation frees the last one's factor before its own K
        assert gp._kept is None
        return chol(K, mesh, chol_mode)
    monkeypatch.setattr(gp_mod, "_chol_mesh", empty_slot_chol)
    theta0 = list(gp.kernel.parameters()) + [gp.noise_e]
    gp.fit(show=False, opt=True, maxiter=4)
    moved = list(gp.kernel.parameters()) + [gp.noise_e]
    assert moved[:2] != theta0[:2]
    assert (moved[2] != theta0[2]) == noise_opt
    assert calls == [] and up.counters["fit.factor_reuse"] == 1
    assert gp._kept is None and gp.refit_stats["full"] == 1
    monkeypatch.undo()
    _assert_same_factor(gp)


def _last_theta_elsewhere(gp):
    """L-BFGS-B's result replaced by the first evaluated theta, which is
    not the last one evaluated."""
    real = gp._minimize

    def minimize(fun, theta0, bounds, maxiter=10):
        first = []

        def f(theta):
            first.append(np.array(theta, float))
            return fun(theta)
        res = real(f, theta0, bounds, maxiter)
        assert not np.array_equal(first[0], first[-1])
        res.x = first[0]
        return res
    return minimize


def _last_not_positive_definite(gp, monkeypatch):
    """One more evaluation at L-BFGS-B's result, after its last, where K
    is not positive definite."""
    real = gp._minimize

    def minimize(fun, theta0, bounds, maxiter=10):
        res = real(fun, theta0, bounds, maxiter)
        chol = gp_mod._chol_mesh
        with monkeypatch.context() as m:
            m.setattr(gp_mod, "_chol_mesh",
                      lambda K, mesh, mode="replicated":
                      (torch.full_like(K, np.nan), 1))
            assert fun(res.x)[0] == np.inf
        assert gp_mod._chol_mesh is chol
        return res
    return minimize


@pytest.mark.parametrize("case", ["elsewhere", "not_positive_definite"])
@pytest.mark.parametrize("kind", KINDS)
def test_fit_falls_back_to_factorize(monkeypatch, kind, case):
    """A result other than the last evaluated theta, or a last evaluation
    whose K is not positive definite: _factorize runs once, with the slot
    empty, nothing is counted, no kept factor outlives the fit, and the
    fit is _factorize's at the fitted hyperparameters."""
    gp = _gp(kind, torch.float32)
    refs = _kept_refs(monkeypatch, gp)
    if case == "elsewhere":
        monkeypatch.setattr(gp, "_minimize", _last_theta_elsewhere(gp))
    else:
        monkeypatch.setattr(gp, "_minimize",
                            _last_not_positive_definite(gp, monkeypatch))
    calls = _factorize_calls(monkeypatch, gp)
    gp.fit(show=False, opt=True, maxiter=4)
    assert calls == [1] and "fit.factor_reuse" not in up.counters
    assert gp._kept is None and gp.refit_stats["full"] == 1
    assert (refs[-1] is None) == (case == "not_positive_definite")
    assert all(r is None or r() is None for r in refs)
    monkeypatch.undo()
    _assert_same_factor(gp)


@pytest.mark.parametrize("kind", KINDS)
def test_exact_rerun_serves_its_last_evaluation(monkeypatch, kind):
    """A Hutchinson run that ends in a failed line search is run again
    with the exact trace; the fit serves from the rerun's evaluation at
    its result, _factorize's factor bit for bit."""
    gp = _gp(kind, torch.float64, trace="hutch", n_probe=64)
    runs = []

    def failing_first(fun, x0, **kw):
        res = scipy.optimize.minimize(fun, x0, **kw)
        runs.append(res.x)
        if len(runs) == 1:
            res.status, res.success = 2, False
            res.message = "ABNORMAL_TERMINATION_IN_LNSRCH"
        return res
    monkeypatch.setattr(gp_mod, "minimize", failing_first)
    calls = _factorize_calls(monkeypatch, gp)
    gp.fit(show=False, opt=True, maxiter=4)
    assert len(runs) == 2 and gp._nll_trace_used == "exact"
    assert np.array_equal(gp.kernel.parameters(), runs[1])
    assert calls == [] and up.counters["fit.factor_reuse"] == 1
    monkeypatch.undo()
    _assert_same_factor(gp)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_served_answers_equal_the_factorize_path(monkeypatch, kind, dtype):
    """E, F and their stds served by a model refit from its theta*
    evaluation equal those of the same model refit by _factorize, bit for
    bit."""
    kept, fresh = _gp(kind, dtype), _gp(kind, dtype)
    kept.fit(show=False, opt=True, maxiter=4)
    monkeypatch.setattr(fresh, "_kept_factor", lambda *a: None)
    fresh.fit(show=False, opt=True, maxiter=4)
    assert up.counters["fit.factor_reuse"] == 1
    assert kept.kernel.parameters() == fresh.kernel.parameters()
    for s, _, _ in _labelled(3, seed=11):
        a = kept.predict_structure(s, return_std=True)
        b = fresh.predict_structure(s, return_std=True)
        for x, z in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(z))


@pytest.mark.parametrize("kind", KINDS)
def test_nll_frees_k_before_the_traces(monkeypatch, kind):
    """The NLL's K (n^2 float64 words) is gone by the time K^-1 is formed,
    while the factor handed to ``keep`` lives on: the RBF NLL, like the
    Dot one, holds no reference of its own to K."""
    gp = _gp(kind, torch.float32)
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    factored, kept, seen = [], [], []
    chol, traces = gp_mod._chol_mesh, gp_mod._Traces.__init__

    def factor(K, mesh, chol_mode="replicated"):
        factored.append(weakref.ref(K))
        return chol(K, mesh, chol_mode)

    def at_traces(self, *a, **k):
        seen.append((factored[-1]() is None, kept[-1]() is not None))
        traces(self, *a, **k)
    monkeypatch.setattr(gp_mod, "_chol_mesh", factor)
    monkeypatch.setattr(gp_mod._Traces, "__init__", at_traces)
    fn = {"rbf": gp_mod._nll_rbf_analytic, "dot": gp_mod._nll_dot_analytic}
    fn[kind](gp.kernel.parameters(), e, f, y, (0.01, 0.1), 10.0,
             gp.kernel.zeta, False,
             keep=lambda L, alpha: kept.append(weakref.ref(L)))
    assert seen == [(True, True)]


def test_other_paths_count_no_reuse():
    """fit(opt=False), from scratch and appended to, counts no reuse and
    leaves no slot; nor does the objective called outside a fit."""
    gp = _gp("rbf", torch.float32)
    gp.fit(show=False, opt=False)
    for lab in _labelled(2, seed=5):
        gp.add_structure(lab)
    gp.fit(show=False, opt=False)
    assert gp.refit_stats["full"] == 1 and gp.refit_stats["incremental"] == 1
    assert "fit.factor_reuse" not in up.counters and gp._kept is None
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    nll, _ = gp._objective(e, f, y, False)(gp.kernel.parameters())
    assert np.isfinite(nll) and gp._kept is None


@pytest.mark.parametrize("workload", ["bench10k.fit", "bench10k-dot.fit"])
def test_factor_reuse_reader_reads_one_a_fit(monkeypatch, workload):
    """A tiny traced run of each fit cell on the CPU: factor_reuse.fit
    reads one a fit."""
    from bench_port.tests.helpers import run_tiny
    r = run_tiny(monkeypatch, workload, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["factor_reuse.fit"]["value"] == 1.0


def test_factor_reuse_reader_reads_nothing_uncounted(monkeypatch):
    """Without the recorder, or where the program never counted a reuse
    (a program without it), the reader gives None."""
    import types
    from bench_port import harness, program_spans
    reader = harness.load_reader("factor_reuse.fit")
    with up.span("fit"):
        pass
    run = types.SimpleNamespace(counters={"fits": 1}, trace=None,
                                device=torch.device("cpu"))
    assert reader.read(run) is None
    with up.span("fit"):
        up.count("fit.factor_reuse")
    assert reader.read(run) == 1.0
    monkeypatch.setattr(program_spans, "_up", None)
    assert reader.read(run) is None


# -- card --------------------------------------------------------------------

# The RBF fit on the card at bench10k.fit's shape (NVIDIA H100, highest):
# at theta* K1-dual's K plane read 9.77e-4 off K1's K, two float32 ulps of
# max|K| = 7896.87, and the reused factor 1.17e-4 off _factorize's L, its
# weights 4.60e-5 of max|alpha| off.  The limits leave about ten times
# that room; the Dot NLL's K is _factorize's own build, so bit for bit.
KPLANE_EPS = 8                 # float32 epsilons of max|K|
L_ABS, ALPHA_REL = 1.2e-3, 5e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["bench10k.fit", "bench10k-dot.fit"])
def test_bench_fit_reuse_on_the_card(card, workload):
    """The benchmark's fit (maxiter 3) on the card serves from its theta*
    evaluation, counted once; its L and alpha against _factorize's at
    theta*: the Dot pair bit for bit, the RBF pair within the limits
    above, as is K1-dual's K plane against K1's K at theta*."""
    from bench_port import harness
    from gpr_calculator_tpu_torch import config
    from gpr_calculator_tpu_torch.ops import kernels as K_ops
    _, cfg, _, _ = harness.cell_spec(harness.benchmark(), workload)
    config.set_kff_precision(cfg["precision"])
    system = harness.system_module(cfg).System(cfg, 2 ** 31 + 11, card)
    gp = system.port_model(T, None)
    gp.fit(show=False, opt=True, maxiter=3)
    assert up.counters["fit.factor_reuse"] == 1
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    params, kind, zeta = gp.kernel.params(), gp.kernel.kind, gp.kernel.zeta
    L, alpha = gp_mod._factorize(e, f, y, params, gp.noise_e, gp.noise_f,
                                 zeta, kind)
    ref = Posterior.from_packed(e, f, L, alpha)
    del L, alpha
    got = gp.posterior
    if kind == "dot":
        assert torch.equal(got.L, ref.L) and torch.equal(got.alpha, ref.alpha)
        return
    dl = float((got.L - ref.L).abs().max())
    da = float((got.alpha - ref.alpha).abs().max()
               / ref.alpha.abs().max())
    del ref
    Kk, _ = K_ops.k_self_dual(e, f, params, zeta, dtype=torch.float64)
    K = K_ops.k_self(e, f, params, zeta, kind, dtype=torch.float64)
    dk = float((Kk - K).abs().max())
    eps = torch.finfo(torch.float32).eps
    assert dk <= KPLANE_EPS * eps * float(K.abs().max()), dk
    assert dl <= L_ABS and da <= ALPHA_REL, (dl, da)
