"""The served chain replayed from CUDA graphs (``models/gp._predict_packed``,
``models/posterior.ServedGraphs``).  On the CPU: no graph is captured and
no graph counter bumps, the served call's counters stay those
``test_torch_tracing.py`` pins, the key tells apart what a graph bakes in,
and the cache is bounded and dies with its ``Posterior``.  The ``gpu``
tests hold each replay to the eager chain bit for bit (mean and std; three
b_pad values; with and without stds; by L^-1 and by the triangular solve;
float32 and float64 models), after a refit and an append, for a stress
request, a band of two structures and under ``torch.profiler``, and
check that a replay leaves the answers already returned alone:

    python -m pytest --noconftest -m gpu tests/test_torch_served_graph.py -q

JAX is not imported."""
import gc
import weakref

import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import config, utils_profiling
from gpr_calculator_tpu_torch.models import gp as gp_mod
from gpr_calculator_tpu_torch.models.gp import GP
from gpr_calculator_tpu_torch.models.posterior import ServedGraphs
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu, make_points  # noqa: F401 (fixture)
from test_torch_variance_inverse import _labelled, _model

D = 30
B_PADS = (6, 8, 11)


@pytest.fixture
def recorder():
    utils_profiling.clear()
    utils_profiling.enable()
    yield utils_profiling.counters
    utils_profiling.disable()
    utils_profiling.clear()


def _query(rng, b, ncart=3, device="cpu", dtype=torch.float64):
    """A request's packed points: one energy point of 13 envs and five
    force points, the first of b envs (so b_pad = b), ncart columns."""
    f = []
    for i in range(5):
        ne = b if i == 0 else rng.randint(max(1, b - 3), b + 1)
        f.append((rng.uniform(0.2, 1.0, (ne, D)),
                  rng.uniform(-1.0, 1.0, (ne, D, ncart)),
                  rng.choice((13, 79), ne)))
    e = [(rng.uniform(0.2, 1.0, (13, D)), rng.choice((13, 79), 13))]
    kw = dict(d=D, device=device, dtype=dtype)
    return pack_energy(e, **kw), pack_force(f, **kw)


def _key(pe, pf, params=None, return_std=True, inverse=True):
    return gp_mod._graph_key(pe, pf, params or {"sigma": 1.5, "l": 1.1}, 2,
                             "rbf", return_std, inverse)


# -- CPU ---------------------------------------------------------------------

def test_no_graphs_on_the_cpu(recorder):
    """Repeated requests of one shape on the CPU capture nothing, bump no
    graph counter, and each served call counts what the tracing tests pin:
    one request, one solve by L^-1."""
    labels = _labelled()
    gp = _model(labels[:5])
    strucs = [s for s, _, _ in labels]
    gp.predict_structure(strucs[5], return_std=True)     # builds L^-1
    for _ in range(3):
        recorder.clear()
        gp.predict_structure(strucs[5], return_std=True)
        assert recorder == {"serve.requests": 1, "predict.solve_inv": 1}
    for _ in range(3):
        gp.predict_structures(strucs[5:7], return_std=True)
        gp.predict_structure(strucs[6])
    assert not [k for k in recorder if k.startswith("predict.graph")]
    assert len(gp.posterior.graphs) == 0
    assert not gp.posterior.graphs.seen_before("any key")


def test_key_tells_apart_what_a_graph_bakes_in():
    """Two requests of one shape share a key whatever their values; the
    key moves with b_pad, the number of energy points, the columns, the
    dtype, return_std, the solve's path, the matmul precision and theta."""
    rng = np.random.RandomState(3)
    base = _key(*_query(rng, 8))
    assert _key(*_query(rng, 8)) == base
    other = [_key(*_query(rng, b)) for b in B_PADS if b != 8]
    other.append(_key(*_query(rng, 8, ncart=9)))
    other.append(_key(*_query(rng, 8, dtype=torch.float32)))
    pe, pf = _query(rng, 8)
    other.append(_key(pack_energy([(np.ones((13, D)), [13] * 13)] * 2, d=D,
                                  device="cpu", dtype=torch.float64), pf))
    other += [_key(pe, pf, return_std=False), _key(pe, pf, inverse=False),
              _key(pe, pf, params={"sigma": 1.5, "l": 1.2}),
              _key(pe, pf, params={"sigma": 1.6, "l": 1.1})]
    try:
        config.set_kff_precision("bf16x4")
        other.append(_key(pe, pf))
    finally:
        config.set_kff_precision("highest")
    assert base not in other and len(set(other)) == len(other)


def test_cache_is_bounded_least_recently_used():
    """At most CAP keys are kept, the least recently used dropped first;
    the keys of eager requests are remembered up to 4 CAP."""
    graphs = ServedGraphs()
    cap = ServedGraphs.CAP
    for k in range(cap):
        graphs._keep(k, object())
    assert graphs.get(0) is not None          # 0 is now the most recent
    graphs._keep(cap, object())
    assert len(graphs) == cap
    assert graphs.get(1) is None and graphs.get(0) is not None
    assert graphs.get(None) is None
    assert [graphs.seen_before(k) for k in ("a", "a", "b")] == \
        [False, True, False]
    for k in range(4 * cap):
        graphs.seen_before(k)
    assert not graphs.seen_before("a")        # forgotten, noted again
    assert graphs.seen_before(4 * cap - 1)


@pytest.mark.parametrize("refit", ["append", "full"])
def test_cache_dies_with_its_posterior(refit):
    """An append or a full refit gives the GP a new Posterior with an
    empty cache; the old cache goes with the old Posterior."""
    labels = _labelled()
    gp = _model(labels[:4])
    old = gp.posterior
    old.graphs._keep("key", object())
    gone = weakref.ref(old.graphs)
    gp.add_structure(labels[4])
    if refit == "full":
        gp.kernel.update([1.4, 1.0])
    gp.fit(show=False, opt=False)
    assert gp.refit_stats["incremental" if refit == "append" else "full"] \
        >= 1
    assert gp.posterior is not old and len(gp.posterior.graphs) == 0
    del old
    gc.collect()
    assert gone() is None


# -- card --------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_model(card, dtype, seed=5):
    """A GP on the card fitted (opt=False) on 40 E + 120 F synthetic
    points of d = 30."""
    rng = np.random.RandomState(seed)
    data = {"energy": [(x, rng.randn(), el)
                       for x, _, el in make_points(rng, 40, 8, D)],
            "force": [(x, dx, rng.randn(3), el)
                      for x, dx, el in make_points(rng, 120, 8, D)]}
    gp = GP(kernel=T.RBF(para=[1.5, 1.1], zeta=2), noise_e=0.01,
            noise_f=0.1, log_file=None, device=card, dtype=dtype)
    gp.set_train_pts(data)
    gp.fit(show=False, opt=False)
    return gp, rng


def _eager(monkeypatch, serve):
    """``serve()`` with the graphs out of the way: every request eager."""
    with monkeypatch.context() as m:
        m.setattr(gp_mod, "_graph_key", lambda *a: None)
        return serve()


def _same(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert torch.equal(g, w), float((g - w).abs().max())


def _serve_four(gp, monkeypatch, requests, return_std):
    """Each of the four requests (one shape) served and against its eager
    answer: the first eager, the second captures, two replays."""
    for pe, pf in requests:
        want = _eager(monkeypatch,
                      lambda: gp._serve_device(pe, pf, return_std))
        _same(gp._serve_device(pe, pf, return_std), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("served", ["mean", "std-inv", "std-trsm"])
def test_replay_is_the_eager_chain(card, dtype, served, monkeypatch,
                                   recorder):
    """Three b_pad values, four requests each: every answer, eager,
    captured or replayed, equals the eager chain's bit for bit; one
    capture and two replays a shape; the solve counted per request."""
    gp, rng = _card_model(card, dtype)
    return_std = served != "mean"
    if served == "std-trsm":
        monkeypatch.setattr(config, "free_bytes", lambda device: 1)
    for b in B_PADS:
        _serve_four(gp, monkeypatch,
                    [_query(rng, b, device=card, dtype=dtype)
                     for _ in range(4)], return_std)
    assert (gp.posterior.Linv is None) == (served != "std-inv")
    n = len(B_PADS)
    assert recorder.get("predict.graph_capture") == n
    assert recorder.get("predict.graph_replay") == 2 * n
    solves = {"std-inv": "predict.solve_inv",
              "std-trsm": "predict.solve_trsm"}
    if return_std:
        # four served and four eager references a shape
        assert recorder.get(solves[served]) == 8 * n
    assert len(gp.posterior.graphs) == n


@pytest.mark.gpu
@pytest.mark.parametrize("refit", ["append", "full"])
def test_new_posterior_captures_anew(card, refit, monkeypatch, recorder):
    """After an append or a full refit the new Posterior starts with no
    graph, captures its own, and serves as the eager chain of the new
    fit, bit for bit."""
    gp, rng = _card_model(card, torch.float32)
    _serve_four(gp, monkeypatch, [_query(rng, 8, device=card,
                                         dtype=torch.float32)
                                  for _ in range(4)], True)
    old = gp.posterior
    more = make_points(rng, 10, 8, D)
    gp.set_train_pts({"energy": [], "force": [(x, dx, rng.randn(3), el)
                                              for x, dx, el in more]},
                     mode="a")
    if refit == "full":
        gp.kernel.update([1.4, 1.0])
    gp.fit(show=False, opt=False)
    assert gp.posterior is not old and len(gp.posterior.graphs) == 0
    assert gp.refit_stats["incremental" if refit == "append" else "full"] \
        >= 1
    _serve_four(gp, monkeypatch, [_query(rng, 8, device=card,
                                         dtype=torch.float32)
                                  for _ in range(4)], True)
    assert recorder.get("predict.graph_capture") == 2
    assert recorder.get("predict.graph_replay") == 4
    assert len(gp.posterior.graphs) == 1


@pytest.mark.gpu
def test_stress_request_replays(card, monkeypatch, recorder):
    """Force points of 9 columns (the strain rows of a stress request):
    the column groups' K2/K3 launches and the permuting copy replay as
    the eager chain, bit for bit."""
    gp, rng = _card_model(card, torch.float32)
    _serve_four(gp, monkeypatch, [_query(rng, 8, ncart=9, device=card,
                                         dtype=torch.float32)
                                  for _ in range(4)], True)
    assert recorder.get("predict.graph_capture") == 1
    assert recorder.get("predict.graph_replay") == 2


@pytest.mark.gpu
def test_band_of_two_structures_replays(card, monkeypatch, recorder):
    """``predict_structures`` over two structures, four times with the
    atoms moved by 1e-3 A: every band's E, F and stds equal the eager
    chain's; the last two bands are replays."""
    labels = _labelled()
    gp = _model(labels[:5], device=card, dtype=torch.float32)
    rng = np.random.RandomState(8)
    for _ in range(4):
        band = []
        for s, _, _ in labels[5:7]:
            s = s.copy()
            s.positions = s.positions + 1e-3 * rng.randn(len(s), 3)
            band.append(s)
        want = _eager(monkeypatch,
                      lambda: gp.predict_structures(band, return_std=True))
        got = gp.predict_structures(band, return_std=True)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert recorder.get("predict.graph_capture") == 1
    assert recorder.get("predict.graph_replay") == 2


@pytest.mark.gpu
def test_replay_leaves_returned_answers_alone(card, recorder):
    """The tensors a replay returned do not change when the same key is
    replayed again for other points."""
    gp, rng = _card_model(card, torch.float32)
    reqs = [_query(rng, 8, device=card, dtype=torch.float32)
            for _ in range(4)]
    for pe, pf in reqs[:2]:
        gp._serve_device(pe, pf, True)
    first = gp._serve_device(*reqs[2], True)
    kept = [t.clone() for t in first]
    second = gp._serve_device(*reqs[3], True)
    assert recorder.get("predict.graph_replay") == 2
    _same(first, kept)
    assert not torch.equal(second[0], first[0])
    assert not torch.equal(second[1], first[1])


@pytest.mark.gpu
def test_capture_and_replay_under_the_profiler(card, monkeypatch, recorder):
    """A shape first seen while ``torch.profiler`` traces the card (as in
    the benchmark's traced window) is captured and replayed there, and
    the answers equal the eager chain's bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    gp, rng = _card_model(card, torch.float32)
    with profile(activities=[ProfilerActivity.CUDA]):
        _serve_four(gp, monkeypatch, [_query(rng, 8, device=card,
                                             dtype=torch.float32)
                                      for _ in range(4)], True)
    assert recorder.get("predict.graph_capture") == 1
    assert recorder.get("predict.graph_replay") == 2
