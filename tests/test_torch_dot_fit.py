"""The Dot kernel's refit on the CPU: the pair counts as the factor S
(``ops.kernels.pair_counts``, W = S S^T) against the env-pair sum they
replaced, the sigma0 gradient taken from the factor against the one taken
from W (exact and Hutchinson traces), ``GP.fit(opt=True, maxiter=3)`` of
each fit cell of the benchmark at its tiny size against the benchmark's
plain reference (``bench_port.reference.gp``), and the readers of the
Dot cell's spans and counter.  The ``gpu`` test holds the Dot fit at the
cell's own size (n = 10 000) to its memory and to the pair-sum path:

    python -m pytest --noconftest -m gpu tests/test_torch_dot_fit.py -q

JAX is not imported."""
import types

import numpy as np
import pytest
import torch

from gpr_calculator_tpu_torch import utils_profiling as up
from gpr_calculator_tpu_torch.models import gp as gp_mod
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu, make_points  # noqa: F401 (fixture)

THETA = [1.7, 0.8]
MIXES = {"one": (13,), "two": (13, 79), "three": (1, 8, 79)}


def _pair_sum(e):
    """W[p, q] by the env-pair sum the factor replaced: every product
    w_a w_b of one element, (m A)^2 of them, summed by point pairs, in
    float64."""
    A = e.x.shape[1]
    _, w = kff.energy_operand(e, "highest")
    w0 = w[0].to(torch.float64)
    pair = w0[:, None] * w0[None, :] * (w[1][:, None] == w[1][None, :])
    return kff._point_sum(pair, A, A)


def _training(seed, elements=(13, 79), dtype=torch.float64):
    """Ragged energy and force points with padded envs and a padded point
    on each side, and labels on the real rows."""
    rng = np.random.RandomState(seed)
    fp = make_points(rng, 5, 6, 30, elements)
    ep = [(x, el) for x, _, el in make_points(rng, 4, 7, 30, elements)]
    kw = dict(device="cpu", dtype=dtype)
    e = pack_energy(ep, m_pad=5, a_pad=9, **kw)
    f = pack_force(fp, m_pad=6, b_pad=8, **kw)
    y = rng.randn(e.m + 3 * f.m) * 0.1
    y[4] = 0.0
    y[-3:] = 0.0
    return e, f, torch.as_tensor(y)


# ---------------------------------------------------------------------------
# the factor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", sorted(MIXES))
def test_pair_counts_factor_is_the_pair_sum(mix):
    """S S^T against the env-pair sum to 1e-15 of its largest entry (the
    same products summed in another order), S one column an element
    present, the padded point's row zero; count_ee is S S^T."""
    e, _, _ = _training(3, MIXES[mix])
    S = TK.pair_counts(e)
    W = _pair_sum(e)
    assert S.dtype == torch.float64
    assert S.shape == (e.m, len(MIXES[mix]))
    assert torch.all(S[e.nreal:] == 0)
    tol = 1e-15 * float(W.abs().max())
    assert float((S @ S.T - W).abs().max()) <= tol
    assert float((TK.count_ee(e) - W).abs().max()) <= tol
    # each real point's weights sum to 1 over its elements
    np.testing.assert_allclose(S[:e.nreal].sum(1).numpy(), 1.0, rtol=1e-15)


def test_pair_counts_of_a_point_with_no_env():
    """A point side with no valid env gives S of no column and W zero."""
    e = pack_energy([], m_pad=2, a_pad=3, d=30, device="cpu",
                    dtype=torch.float64)
    assert TK.pair_counts(e).shape == (2, 0)
    assert torch.equal(TK.count_ee(e), torch.zeros(2, 2,
                                                   dtype=torch.float64))


@pytest.mark.parametrize("noise_opt", [False, True])
@pytest.mark.parametrize("trace", ["exact", "hutch"])
def test_sigma0_gradient_from_the_factor(trace, noise_opt):
    """The Dot NLL with the factor against the same NLL with the sigma0
    trace taken from W (the pair sum), on the same K, factor and probes:
    the value bit for bit, the gradient to 1e-12 of its norm."""
    e, f, y = _training(5)
    n = e.m + 3 * f.m
    probes = gp_mod._probe_block(n, 16, "cpu") if trace == "hutch" else None
    theta = THETA + ([0.02] if noise_opt else [])
    kw = dict(trace=trace, n_probe=16, probes=probes)
    nll, g = gp_mod._nll_dot_analytic(theta, e, f, y, (0.01, 0.1), 10.0, 3,
                                      noise_opt, **kw)
    S = TK.pair_counts(e)
    nll_s, g_s = gp_mod._nll_dot_analytic(theta, e, f, y, (0.01, 0.1), 10.0,
                                          3, noise_opt, pair_counts=S, **kw)
    assert float(nll_s) == float(nll) and torch.equal(g_s, g)

    kp, noise_e, noise_f = gp_mod._split_theta(theta, (0.01, 0.1), 10.0,
                                               noise_opt)
    Kk = TK.k_self(e, f, {"sigma": kp[0], "sigma0": kp[1]}, 3, "dot",
                   dtype=torch.float64)
    W, m = _pair_sum(e), e.m

    def g_pair_sum(traces, alpha):
        a = alpha[:m]
        if traces.Kinv is None:
            tr = torch.sum(traces.W[:m] * (W @ traces.Z[:m])) / 16
        else:
            tr = (traces.Kinv[:m, :m] * W).sum()
        return kp[0] ** 2 * kp[1] * (tr - torch.dot(a, W @ a))
    nll_w, g_w = gp_mod._analytic_nll(Kk, e, f, y, kp[0], noise_e, noise_f,
                                      10.0, noise_opt, g_pair_sum, **kw)
    assert float(nll) == float(nll_w)
    assert float(torch.linalg.norm(g - g_w)) <= \
        1e-12 * float(torch.linalg.norm(g_w))
    assert abs(float(g[1] - g_w[1])) <= 1e-12 * abs(float(g_w[1]))


def test_dot_nll_frees_k_once_factored(monkeypatch):
    """The Dot NLL's K (n^2 float64 words) is gone by the time K^-1 is
    formed: the NLL holds no reference of its own to it."""
    import weakref
    e, f, y = _training(6)
    built, seen = [], []
    k_self, traces = TK.k_self, gp_mod._Traces.__init__

    def build(*a, **k):
        K = k_self(*a, **k)
        built.append(weakref.ref(K))
        return K

    def at_traces(self, *a, **k):
        seen.append(built[-1]() is None)
        traces(self, *a, **k)
    monkeypatch.setattr(TK, "k_self", build)
    monkeypatch.setattr(gp_mod._Traces, "__init__", at_traces)
    gp_mod._nll_dot_analytic(THETA, e, f, y, (0.01, 0.1), 10.0, 3, False)
    assert seen == [True]


# ---------------------------------------------------------------------------
# the fit against the benchmark's reference, and its records
# ---------------------------------------------------------------------------

def _fit_cells():
    from bench_port import harness
    bench = harness.benchmark()
    return [c["name"] for c in bench["workloads"]
            if harness.cell_spec(bench, c["name"])[2]["kind"] == "fit"]


# the largest relative distance of the first NLL, its gradient, theta* and
# the weights from the plain float64 reference: float64 blocks leave
# rounding alone; float32 ones round the descriptors' products (~1e-7 of
# a block entry), which the factor of K moves by its conditioning (the
# largest over seeds 7, 8 and 2^31 + 3 of both families: float32 1.3e-8 /
# 2.1e-8 / 8.2e-8 / 9.6e-7, float64 3.0e-16 / 2.5e-15 / 5.0e-13 / 2.0e-12)
FIT_TOL = {"float64": (1e-10, 1e-8, 1e-8, 1e-8),
           "float32": (1e-7, 1e-6, 4e-6, 4e-6)}


@pytest.fixture
def tiny_system():
    from bench_port import harness
    from bench_port.tests.helpers import tiny_spec

    def make(workload, dtype, seed=7):
        _, cfg, traffic, _ = tiny_spec(harness.benchmark(), workload)
        cfg["dtype"] = dtype
        return cfg, traffic, harness.system_module(cfg).System(
            cfg, seed, torch.device("cpu"))
    return make


@pytest.mark.parametrize("dtype", sorted(FIT_TOL))
@pytest.mark.parametrize("workload", _fit_cells())
def test_fit_matches_the_reference(tiny_system, workload, dtype):
    """GP.fit(opt=True, maxiter=3) from theta0 through the benchmark's
    program (``Port``) at the cell's tiny size, against the reference's
    own L-BFGS-B of the configuration's family: the first NLL and its
    gradient, theta* and the weights at the program's theta*."""
    from bench_port.backends import Port
    from bench_port.reference import gp as rgp
    cfg, traffic, system = tiny_system(workload, dtype)
    port = Port(system)
    maxiter = traffic["maxiter"]
    port.fit(opt=True, theta=system.theta0, maxiter=maxiter)
    assert port.gp.kernel.name == system.family
    data = system.ref_data("f64")
    theta, evals = rgp.fit(data, system.theta0, system.bounds, system.noise,
                           system.zeta, system.family, maxiter=maxiter)
    _, nll0, g0 = evals[0]
    _, nll_p, g_p = port.evals[-1][0]
    _, alpha = rgp.factorize(data, port.theta(), system.noise, system.zeta,
                             system.family)
    alpha = alpha.numpy()
    got = (abs(nll_p - nll0) / abs(nll0),
           np.linalg.norm(g_p - g0) / np.linalg.norm(g0),
           np.max(np.abs(port.theta() - theta) / np.abs(theta)),
           np.max(np.abs(port.alpha() - alpha)) / np.max(np.abs(alpha)))
    assert all(v <= t for v, t in zip(got, FIT_TOL[dtype])), got


@pytest.fixture
def recording():
    up.clear()
    up.enable()
    yield
    up.disable()
    up.clear()


def test_dot_fit_forms_no_w(tiny_system, recording, monkeypatch):
    """One Dot fit builds its pair counts before the gate and the search
    and never calls count_ee, which forms W (m, m); on the CPU its
    build's span keeps no device events."""
    from bench_port.backends import Port

    def no_w(*a, **k):
        raise AssertionError("the fit formed W")
    monkeypatch.setattr(TK, "count_ee", no_w)
    _, _, system = tiny_system("bench10k-dot.fit", "float32")
    Port(system).fit(opt=True, theta=system.theta0, maxiter=3)
    spans = [r for r in up.records() if r.name not in up.counters]
    first = {n: min(r.start_ns for r in spans if r.name == n)
             for n in ("fit.pair_counts", "fit.gate", "fit.lbfgs")}
    assert first["fit.pair_counts"] < first["fit.gate"] < first["fit.lbfgs"]
    assert up.counters["pair_counts.build"] == 1
    k_self = [r for r in spans if r.name == "nll.k_self"]
    assert k_self and all(r.marks is None and up.device_ms(r) is None
                          for r in k_self)


def test_dot_readers(monkeypatch, recording):
    """A tiny traced run of the Dot cell on the CPU: pair_counts_builds.fit
    reads 1, the readers that need the card's trace or events read
    nothing; without the counter (a program that counts no build) the
    builds' reader reads nothing."""
    from bench_port import harness
    from bench_port.tests.helpers import run_tiny
    r = run_tiny(monkeypatch, "bench10k-dot.fit", seed=2 ** 31 + 5,
                 trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["pair_counts_builds.fit"]["value"] == 1.0
    assert "nll_eval_dot_ms.fit" not in r["metrics"]
    assert "k_self_dot_roofline" not in r["metrics"]
    reader = harness.load_reader("pair_counts_builds.fit")
    up.counters.pop("pair_counts.build", None)
    run = types.SimpleNamespace(counters={"fits": 1})
    assert reader.read(run) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_dot_fit_at_the_cell_size_on_the_card(card):
    """The Dot cell's training set (n = 10 000) on the card: a whole
    GP.fit(opt=True, maxiter=3) adds under 4 GB to what the model holds
    (the pair-sum W of the (m A)^2 = 32 000^2 env pairs alone took 9.2
    GB), and at theta0 the
    NLL from the factor equals the pair-sum path's to 1e-12 and its
    gradient to 1e-10 (float64 sums of ~1e6 terms in another order; W is
    exact in float32 here, each weight 1/32)."""
    from bench_port import harness
    from bench_port.backends import Port
    bench = harness.benchmark()
    _, cfg, traffic, _ = harness.cell_spec(bench, "bench10k-dot.fit")
    system = harness.system_module(cfg).System(cfg, 2 ** 31 + 29, card)
    port = Port(system)
    port.fit(opt=True, theta=system.theta0, maxiter=traffic["maxiter"])
    torch.cuda.synchronize(card)
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    port.fit(opt=True, theta=system.theta0, maxiter=traffic["maxiter"])
    torch.cuda.synchronize(card)
    assert torch.cuda.max_memory_allocated(card) - base < 4e9
    gp = port.gp
    e, f = gp._pack(gp.N_energy, gp.N_forces)
    y = gp._y_vector(e, f, gp.N_energy, gp.N_forces)
    theta, fixed = list(system.theta0), (gp.noise_e, gp.noise_f)
    nll, g = gp_mod._nll_dot_analytic(theta, e, f, y, fixed, 1.0,
                                      system.zeta, False)
    W, m = _pair_sum(e), e.m
    s2s0 = theta[0] ** 2 * theta[1]

    def g_pair_sum(traces, alpha):
        a = alpha[:m]
        return s2s0 * ((traces.Kinv[:m, :m] * W).sum()
                       - torch.dot(a, W @ a))
    Kk = TK.k_self(e, f, {"sigma": theta[0], "sigma0": theta[1]},
                   system.zeta, "dot", dtype=torch.float64)
    nll_w, g_w = gp_mod._analytic_nll(Kk, e, f, y, theta[0], *fixed, 1.0,
                                      False, g_pair_sum)
    assert abs(float(nll - nll_w)) <= 1e-12 * abs(float(nll_w))
    assert float(torch.linalg.norm(g - g_w)) <= \
        1e-10 * float(torch.linalg.norm(g_w))
