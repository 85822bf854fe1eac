"""The port's span recorder (``utils_profiling``) on the CPU: the span
tree of a served call and of a fit, their shared ids, L-BFGS-B's counters
against the evaluations (the benchmark's ``Port.evals`` counts them too),
``refit_stats``' ms only while the recorder is on, and nothing recorded
or read while it is off.  The ``gpu`` test holds the recorder's clock to
the device trace's on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py -q
"""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import utils_profiling as up

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

# the span tree of one served call: name -> the name of its parent
SERVE_TREE = {"serve": None, "descriptor": "serve",
              "descriptor.prep": "descriptor", "descriptor.core": "descriptor",
              "pack": "serve", "predict": "serve",
              "predict.block": "predict", "predict.solve": "predict",
              "host_out": "serve"}
FIT_TREE = {"fit": None, "fit.pack": "fit", "fit.gate": "fit",
            "fit.lbfgs": "fit", "nll.eval": "fit.lbfgs",
            "nll.k_self_dual": "nll.eval", "nll.factor": "nll.eval",
            "nll.traces": "nll.eval", "fit.factorize": "fit"}
# a Dot fit: the build's own span, and the pair counts built once a fit
DOT_FIT_TREE = {**{k: v for k, v in FIT_TREE.items()
                   if k != "nll.k_self_dual"},
                "nll.k_self": "nll.eval", "fit.pair_counts": "fit"}
COUNTERS = ("serve.requests", "lbfgs.nfev", "lbfgs.nit",
            "predict.solve_inv", "predict.solve_trsm", "factor_inv.build",
            "factor_inv.extend", "predict.graph_replay",
            "predict.graph_capture", "pair_counts.build",
            "fit.factor_reuse")


@pytest.fixture
def recording():
    """The recorder on and empty for the test, off and empty after."""
    up.clear()
    up.enable()
    yield
    up.disable()
    up.clear()


def _structs(n, natoms=5, seed=21):
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a]])[:natoms]
    out = []
    for _ in range(n):
        s = T.Atoms(numbers=[29] * natoms,
                    positions=grid + 0.12 * rng.randn(natoms, 3),
                    cell=np.eye(3) * 12, pbc=False)
        s.calc = T.EMT()
        e, f = s.get_potential_energy(), s.get_forces()
        s.calc = None
        out.append((s, e, f))
    return out


@pytest.fixture(scope="module")
def model():
    gp = T.GP(kernel=T.RBF(para=[1.5, 1.1], zeta=2),
              descriptor=T.SO3(nmax=2, lmax=2, rcut=4.0), noise_e=0.01,
              noise_f=0.1, log_file=None)
    labelled = _structs(6)
    for lab in labelled[:3]:
        gp.add_structure(lab)
    gp.fit(show=False, opt=False)
    strucs = [s for s, _, _ in labelled[3:]]
    # the first request with stds builds the kept L^-1 (``predict.inverse``)
    gp.predict_structure(strucs[0], return_std=True)
    return gp, strucs


def _parents(recs):
    """name -> the name of the innermost other span that encloses it one
    level up (None at depth 0), over the span records."""
    out = {}
    for r in recs:
        up_ = [p for p in recs if p.depth == r.depth - 1
               and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns]
        assert len(up_) == (0 if r.depth == 0 else 1), r
        parent = up_[0].name if up_ else None
        assert out.setdefault(r.name, parent) == parent, r
    return out


def _spans(recs):
    return [r for r in recs if r.name not in COUNTERS]


@pytest.mark.parametrize("n", [1, 3])
def test_served_call_gives_the_span_tree(model, recording, n):
    """One served call (one structure, or a band of three in one call)
    leaves the serving tree: every span once but descriptor.prep once a
    structure, depths by nesting, one id shared by all, the serve span
    carrying the number of structures, serve.requests counted once, and
    the variance served from the kept L^-1 once."""
    gp, strucs = model
    if n == 1:
        gp.predict_structure(strucs[0], return_std=True)
    else:
        gp.predict_structures(strucs[:n], return_std=True)
    recs = up.records()
    spans = _spans(recs)
    assert _parents(spans) == SERVE_TREE
    names = [r.name for r in spans]
    assert {k: names.count(k) for k in SERVE_TREE} == {
        k: (n if k == "descriptor.prep" else 1) for k in SERVE_TREE}
    assert len({r.id for r in recs}) == 1
    assert [r.n for r in spans if r.name == "serve"] == [n]
    assert up.counters == {"serve.requests": 1, "predict.solve_inv": 1}


def _fit_port(workload):
    """The benchmark's program (``Port``) on a fit cell's tiny inputs."""
    from bench_port import harness
    from bench_port.backends import Port
    from bench_port.tests.helpers import tiny_spec
    _, cfg, _, _ = tiny_spec(harness.benchmark(), workload)
    system = harness.system_module(cfg).System(cfg, 7, torch.device("cpu"))
    return Port(system), system


@pytest.fixture(scope="module")
def fit_port():
    """The RBF fit cell's program."""
    return _fit_port("bench10k.fit")


@pytest.fixture(scope="module")
def dot_fit_port():
    """The Dot fit cell's program."""
    return _fit_port("bench10k-dot.fit")


def _two_fits_give_the_tree(port, system):
    """fit(opt=True) twice: each fit's records share one id of their
    own; the family's fit tree, an nll.eval span for each evaluation,
    carrying its index, and in it the covariance build's span;
    lbfgs.nfev equal to those spans and to the evaluations the
    benchmark's Port counted, lbfgs.nit at most the cap; a Dot fit's pair
    counts built once (one fit.pair_counts span, pair_counts.build 1);
    each fit's factor its theta* evaluation's (fit.factor_reuse 1)."""
    dot = system.family == "Dot"
    tree = DOT_FIT_TREE if dot else FIT_TREE
    build = "nll.k_self" if dot else "nll.k_self_dual"
    for _ in range(2):
        port.fit(opt=True, theta=system.theta0, maxiter=3)
    recs = up.records()
    ids = sorted({r.id for r in recs})
    assert len(ids) == 2
    for fit_id, evals in zip(ids, port.evals[-2:]):
        mine = [r for r in recs if r.id == fit_id]
        spans = _spans(mine)
        assert _parents(spans) == tree
        nfev = [r.n for r in mine if r.name == "lbfgs.nfev"]
        nit = [r.n for r in mine if r.name == "lbfgs.nit"]
        ev = [r.n for r in spans if r.name == "nll.eval"]
        names = [r.name for r in spans]
        assert nfev == [len(ev)] == [len(evals)] == [names.count(build)]
        assert ev == list(range(len(ev)))
        assert 1 <= nit[0] <= 3
        assert names.count("fit") == 1
        builds = [r.n for r in mine if r.name == "pair_counts.build"]
        assert builds == ([1] if dot else [])
        assert names.count("fit.pair_counts") == len(builds)
        assert [r.n for r in mine if r.name == "fit.factor_reuse"] == [1]
    assert up.counters["lbfgs.nfev"] == sum(len(e)
                                            for e in port.evals[-2:])
    assert up.counters["fit.factor_reuse"] == 2


def test_fit_gives_the_span_tree_and_lbfgs_counts(fit_port, recording):
    _two_fits_give_the_tree(*fit_port)


def test_dot_fit_gives_the_span_tree_and_lbfgs_counts(dot_fit_port,
                                                      recording):
    _two_fits_give_the_tree(*dot_fit_port)


def test_fit_without_opt_gives_pack_and_factorize(model, recording):
    gp, _ = model
    gp.fit(show=False, opt=False)
    assert _parents(_spans(up.records())) == {
        "fit": None, "fit.pack": "fit", "fit.factorize": "fit"}
    assert up.counters == {}


def test_refit_ms_are_summed_only_while_recording(model):
    """refit_stats counts every refit; its ms grow only with the recorder
    on (fit() itself never waits for the device to time itself)."""
    gp, _ = model
    before = dict(gp.refit_stats)
    gp.fit(show=False, opt=False)
    off = dict(gp.refit_stats)
    assert off["incremental"] == before["incremental"] + 1
    assert off["incremental_ms"] == before["incremental_ms"]
    up.enable()
    try:
        gp.fit(show=False, opt=False)
    finally:
        up.disable()
        up.clear()
    on = gp.refit_stats
    assert on["incremental"] == off["incremental"] + 1
    assert on["incremental_ms"] > off["incremental_ms"]


def test_recorder_off_records_and_reads_nothing(model, fit_port,
                                                dot_fit_port, monkeypatch):
    """Off, a request and a fit of each family leave no record and no
    counter, read no clock and open no record_function: every span is one
    shared no-op."""
    up.clear()
    up.disable()

    def boom(*a, **k):
        raise AssertionError("touched while the recorder is off")
    monkeypatch.setattr(up, "clock", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    gp, strucs = model
    gp.predict_structure(strucs[0], return_std=True)
    for port, system in (fit_port, dot_fit_port):
        port.fit(opt=True, theta=system.theta0, maxiter=2)
    assert up.records() == [] and up.counters == {}
    assert up.span("a") is up.span("b", n=3)
    with up.span("a") as s:
        assert s is None


def test_nested_roots_take_new_ids(recording):
    """Spans opened inside another share its id; each outermost span
    takes a new one; a counter bump outside any span has id 0."""
    with up.span("a"):
        with up.span("b", n=2):
            up.count("k", 3)
    with up.span("c"):
        pass
    up.count("k")
    a, b, c = (next(r for r in up.records() if r.name == x)
               for x in "abc")
    assert a.id == b.id != c.id and (a.depth, b.depth, c.depth) == (0, 1, 0)
    marks = [r for r in up.records() if r.name == "k"]
    assert [(m.n, m.depth, m.id) for m in marks] == [(3, 2, a.id), (1, 0, 0)]
    assert up.counters == {"k": 4}
    assert b.n == 2 and a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns


def test_spans_show_in_a_profile(recording):
    """Inside a torch.profiler profile a span is also a record_function,
    which the trace shows; outside one, none is opened."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with up.span("layer"):
            torch.ones(8) + 1
    assert "layer" in {e.name for e in prof.events()}
    with up.span("unseen") as s:
        assert s._rf is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the largest gap allowed between a span's clock and the device trace's,
# with the CPU activity on and with the CUDA activity alone (as the
# benchmark traces).  On an H100 with the CPU activity the kernel started
# 8-642 us after its span opened and ended 2.6-28 us before the wait
# returned, in 24 sessions of 8; with the CUDA activity alone 5 sessions
# of 30 drifted, the device times moving 20-40 us earlier against the
# host's a span, up to 0.35 ms in 8 spans (0.22 ms in 4)
CLOCK_TOL_NS = {True: 50_000, False: 500_000}


@pytest.mark.gpu
@pytest.mark.parametrize("cpu_activity", [True, False])
def test_span_clock_is_the_device_trace_clock(card, recording,
                                              cpu_activity):
    """Spans around a ~1 ms ``torch.cuda._sleep``, each followed by a
    wait: in the profiler's trace the kernel starts after its span opens
    and ends before the wait returns, within CLOCK_TOL_NS."""
    from torch.profiler import ProfilerActivity, profile
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    e0.record()
    torch.cuda._sleep(1_000_000)
    e1.record()
    torch.cuda.synchronize()
    cycles = int(1_000_000 / e0.elapsed_time(e1))
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if cpu_activity else [])
    tol = CLOCK_TOL_NS[cpu_activity]
    waits = []
    with profile(activities=acts) as prof:
        for _ in range(4):
            torch.cuda.synchronize()
            with up.span("sleep"):
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            waits.append(up.clock())
    kernels = [ev for ev in prof.profiler.kineto_results.events()
               if ev.device_type().name == "CUDA"
               and "spin" in ev.name() and not ev.is_user_annotation()]
    spans = [r for r in up.records() if r.name == "sleep"]
    assert len(kernels) == len(spans) == 4
    for k, s, w in zip(kernels, spans, waits):
        start, end = k.start_ns(), k.start_ns() + k.duration_ns()
        assert start >= s.start_ns - tol, (start, s)
        assert end <= w + tol, (end, w)
        assert 0.5e6 < end - start < 2e6
