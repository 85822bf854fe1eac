"""The served block of the PyTorch port and what its kernels read, on the
CPU: element-sorted operands, the chunk ranges the rectangular kernels
skip by, ``k_block`` built in one buffer, and the training-side operands
a fitted model keeps.

Inputs come from a numpy seed and go through the JAX package and the
port.  Tolerances: float64 against the JAX package's XLA blocks 1e-10 of
the largest entry (the same sums in another order); float32 against the
Pallas kernels in interpret mode rtol 2e-5 / atol 1e-6, as
tests/test_torch_kff.py holds them; sorted against unsorted operands
1e-12 in float64 (a permutation of a point's envs moves only the order
of its sum); one buffer against the concatenated form: bit for bit.
The on-the-fly NEBs through element-sorted operands are held against the
JAX package's runs in tests/test_torch_neb.py.
"""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import config, convert
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

RBF = {"sigma": 1.3, "l": 0.9}
DOT = {"sigma": 1.3, "sigma0": 0.7}
ELEMENTS = {1: (13,), 2: (13, 79), 3: (13, 29, 79)}
# (zeta, number of elements)
ZETA_ELEMENTS = [(1, 1), (2, 2), (3, 3), (2, 3)]
NEVER = 10 ** 9


def _points(rng, n_pts, n_env, elements, d=30):
    pts = []
    for _ in range(n_pts):
        ne = rng.randint(max(1, n_env - 3), n_env + 1)
        pts.append((rng.uniform(0.2, 1.0, (ne, d)),
                    rng.uniform(-1.0, 1.0, (ne, d, 3)),
                    rng.choice(elements, ne)))
    return pts


def _data(seed, dtype, n_elements):
    """Two sides with padding envs (a_pad / b_pad above the largest env
    count) and an all-padding point each (m_pad above the point count)."""
    rng = np.random.RandomState(seed)
    el = ELEMENTS[n_elements]
    fp1, fp2 = _points(rng, 5, 9, el), _points(rng, 3, 7, el)
    ep1 = [(x, e) for x, _, e in _points(rng, 3, 10, el)]
    ep2 = [(x, e) for x, _, e in _points(rng, 2, 8, el)]
    shape = dict(e1=dict(m_pad=4, a_pad=12), f1=dict(m_pad=6, b_pad=11),
                 e2=dict(m_pad=3, a_pad=9), f2=dict(m_pad=4, b_pad=8))
    kw = dict(device="cpu", dtype=dtype)
    ours = (pack_energy(ep1, **shape["e1"], **kw),
            pack_force(fp1, **shape["f1"], **kw),
            pack_energy(ep2, **shape["e2"], **kw),
            pack_force(fp2, **shape["f2"], **kw))
    return ours, (ep1, fp1, ep2, fp2, shape)


def _jax_data(ep1, fp1, ep2, fp2, shape):
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    return (jpe(ep1, **shape["e1"]), jpf(fp1, **shape["f1"]),
            jpe(ep2, **shape["e2"]), jpf(fp2, **shape["f2"]))


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _blocks(data, params, zeta, kind):
    """k_self, k_block and (RBF) both planes of k_self_dual."""
    e1, f1, e2, f2 = data
    out = [TK.k_self(e1, f1, params, zeta, kind),
           TK.k_block(e2, f2, e1, f1, params, zeta, kind)]
    if kind == "rbf":
        out += list(TK.k_self_dual(e1, f1, params, zeta))
    return out


# ---------------------------------------------------------------------------
# (i) element-sorted operands
# ---------------------------------------------------------------------------

def test_operands_sorted_by_element_with_padding_last():
    data, _ = _data(3, torch.float64, 3)
    for side, operand in ((data[0], kff.energy_operand),
                          (data[1], kff.force_operand)):
        B = side.x.shape[1]
        X, re = operand(side, sort=True)
        Xu, reu = operand(side, sort=False)
        w, el = re[0].reshape(-1, B), re[1].reshape(-1, B)
        key = torch.where(w != 0, el, torch.full_like(el, 1e9))
        assert bool((key[:, 1:] >= key[:, :-1]).all())
        assert bool((w[-1] == 0).all())          # the all-padding point
        # the same envs, permuted within each point
        rows, rows_u = (t.reshape(-1, side.x.shape[0], B, kff.DP)
                        for t in (X, Xu))
        order = kff._env_order(side.ele, reu[0].reshape(-1, B) != 0)
        assert torch.equal(rows, torch.take_along_dim(
            rows_u, order[None, :, :, None], 2))
        # a permutation of each point's envs that keeps equal keys in
        # their packed order
        assert torch.equal(order.sort(1).values,
                           torch.arange(B).expand_as(order))
        same = key[:, 1:] == key[:, :-1]
        assert bool((order[:, 1:] > order[:, :-1])[same].all())
    # the default sorts the sides of SORT_MIN_ENVS envs or more
    assert kff._sorts(None, 256, 32) and not kff._sorts(None, 58, 13)
    assert kff._sorts(True, 1, 1) and not kff._sorts(False, 10 ** 6, 32)


@pytest.mark.parametrize("zeta,n_elements", ZETA_ELEMENTS)
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_sorted_blocks_match_xla_f64(kind, zeta, n_elements, monkeypatch):
    """k_self, k_block and k_self_dual from element-sorted operands
    against the JAX package's XLA blocks (1e-10) and against the blocks
    from unsorted operands (1e-12)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    data, raw = _data(10 * zeta + n_elements, torch.float64, n_elements)
    je1, jf1, je2, jf2 = _jax_data(*raw)
    params = RBF if kind == "rbf" else DOT
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    ours = _blocks(data, params, zeta, kind)
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", NEVER)
    unsorted = _blocks(data, params, zeta, kind)
    refs = [JK.k_self(je1, jf1, jp, kind, zeta, allow_pallas=False),
            JK.k_block(je2, jf2, je1, jf1, jp, kind, zeta,
                       allow_pallas=False)]
    if kind == "rbf":
        refs += list(JK.k_self_dual(je1, jf1, jp, zeta, allow_pallas=False))
    for o, u, r in zip(ours, unsorted, refs):
        _close(o.numpy(), r, 1e-10)
        _close(o.numpy(), u.numpy(), 1e-12)


@pytest.mark.parametrize("zeta,n_elements", ZETA_ELEMENTS[:3])
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_sorted_blocks_match_pallas_interpret_f32(kind, zeta, n_elements,
                                                  monkeypatch):
    """The float32 blocks from element-sorted operands against the Pallas
    kernels in interpret mode (highest): the training covariance against
    _pallas_self_blocks, the served block's K_FF, K_EF and K_FE against
    kff_pallas / kef_pallas."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    from gpr_calculator_tpu.ops.kff_pallas import kef_pallas, kff_pallas
    monkeypatch.setenv("GPR_CALC_TPU_KFF_INTERPRET", "1")
    monkeypatch.setenv("GPR_CALC_TPU_KFF_PRECISION", "highest")
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    data, raw = _data(40 + 10 * zeta + n_elements, torch.float32, n_elements)
    e1, f1, e2, f2 = data
    je1, jf1, je2, jf2 = _jax_data(*raw)
    params = RBF if kind == "rbf" else DOT
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    cases = [(TK.k_self(e1, f1, params, zeta, kind),
              JK._pallas_self_blocks(je1, jf1, jp, kind, zeta,
                                     dual=False)[0])]
    if kind == "rbf":
        cases += list(zip(TK.k_self_dual(e1, f1, params, zeta),
                          JK._pallas_self_blocks(je1, jf1, jp, "rbf", zeta,
                                                 dual=True)))
    Kt = TK.k_block(e2, f2, e1, f1, params, zeta, kind)
    kw = dict(zeta=zeta, interpret=True, mm_precision="highest", kind=kind)
    cases += [(Kt[e2.m:, e1.m:], kff_pallas(jf2, jf1, jp, **kw)),
              (Kt[:e2.m, e1.m:], kef_pallas(je2, jf1, jp, **kw)),
              (Kt[e2.m:, :e1.m], np.asarray(kef_pallas(je1, jf2, jp,
                                                       **kw)).T)]
    for ours, ref in cases:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=1e-6 * float(ours.abs().max()))


# ---------------------------------------------------------------------------
# (ii) the chunk ranges the rectangular kernels skip by
# ---------------------------------------------------------------------------

def _brute_ranges(re, B, points, envs):
    m = re.shape[1] // B
    w, el = re[0].reshape(m, B).numpy(), re[1].reshape(m, B).numpy()
    nt, nc = -(-m // points), -(-B // envs)
    out = np.empty((nt, nc, 2))
    for t in range(nt):
        for c in range(nc):
            vals = [el[p, e] for p in range(t * points,
                                            min(m, (t + 1) * points))
                    for e in range(c * envs, min(B, (c + 1) * envs))
                    if w[p, e] != 0]
            out[t, c] = (min(vals), max(vals)) if vals else (np.inf, -np.inf)
    return out


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("energy_lhs", [False, True], ids=["K3", "K2"])
def test_chunk_ranges_and_staged_pairs_match_brute_force(energy_lhs, sort):
    """chunk_ranges against a loop over the envs; a staged chunk pair is
    one whose ranges intersect; and no same-element env pair with weight
    lies in a pair that is skipped (counted pair by pair)."""
    rng = np.random.RandomState(5)
    kw = dict(device="cpu", dtype=torch.float64)
    f2 = pack_force(_points(rng, 19, 13, ELEMENTS[3]), m_pad=20, b_pad=14,
                    **kw)
    X2, re2 = kff.force_operand(f2, sort=sort)
    if energy_lhs:
        e1 = pack_energy([(x, e) for x, _, e in
                          _points(rng, 11, 21, ELEMENTS[3])], a_pad=23, **kw)
        _, re1 = kff.energy_operand(e1, sort=sort)
        B1, geo1 = 23, (kff.TP, 8)
    else:
        f1 = pack_force(_points(rng, 10, 9, ELEMENTS[2]), b_pad=11, **kw)
        _, re1 = kff.force_operand(f1, sort=sort)
        B1, geo1 = 11, (kff.TP, 4)
    r1, r2 = _brute_ranges(re1, B1, *geo1), _brute_ranges(re2, 14, kff.TP, 4)
    np.testing.assert_array_equal(
        kff.chunk_ranges(re1, B1, *geo1).numpy(), r1)
    np.testing.assert_array_equal(
        kff.chunk_ranges(re2, 14, kff.TP, 4).numpy(), r2)
    w1, el1 = re1[0].numpy(), re1[1].numpy()
    w2, el2 = re2[0].numpy(), re2[1].numpy()
    same = ((w1[:, None] != 0) & (w2[None, :] != 0)
            & (el1[:, None] == el2[None, :]))
    staged = n_pairs = covered = 0
    for t1 in range(r1.shape[0]):
        for c1 in range(r1.shape[1]):
            rows = [p * B1 + e
                    for p in range(t1 * geo1[0],
                                   min(re1.shape[1] // B1,
                                       (t1 + 1) * geo1[0]))
                    for e in range(c1 * geo1[1], min(B1, (c1 + 1) * geo1[1]))]
            for t2 in range(r2.shape[0]):
                for c2 in range(r2.shape[1]):
                    cols = [q * 14 + e
                            for q in range(t2 * kff.TP,
                                           min(f2.m, (t2 + 1) * kff.TP))
                            for e in range(c2 * 4, min(14, (c2 + 1) * 4))]
                    meet = not (r1[t1, c1, 1] < r2[t2, c2, 0]
                                or r2[t2, c2, 1] < r1[t1, c1, 0])
                    n_pairs += 1
                    staged += meet
                    inside = int(same[np.ix_(rows, cols)].sum())
                    assert meet or inside == 0
                    covered += inside
    assert covered == int(same.sum())
    assert kff.staged_pairs(re1, B1, re2, 14, energy_lhs=energy_lhs) == \
        (staged, n_pairs)
    if sort:
        assert staged < n_pairs


# ---------------------------------------------------------------------------
# (iii) the served block in one buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["highest", "bf16x4"])
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_k_block_in_one_buffer_equals_concatenated(kind, mode):
    (e1, f1, e2, f2), _ = _data(70, torch.float32, 2)
    params = RBF if kind == "rbf" else DOT
    K = TK.k_block(e2, f2, e1, f1, params, 2, kind, mm_precision=mode)
    q = TK.side_operands(e2, f2, mode)
    t = TK.side_operands(e1, f1, mode, "train")
    kw = dict(kind=kind, mm_precision=mode)
    ee = kff.kee_served(q.Ue, q.w, q.A, t.Ue, t.w, t.A, params, 2,
                        kind=kind)
    ef = kff.kef_from_ops(q.U, q.w, q.A, t.X, t.re, t.B, params, 2, **kw)
    fe = kff.kef_from_ops(t.U, t.w, t.A, q.X, q.re, q.B, params, 2, **kw).T
    ff = kff.kff_from_ops(q.X, q.re, q.B, t.X, t.re, t.B, params, 2, **kw)
    cat = torch.cat([torch.cat([ee, ef], 1), torch.cat([fe, ff], 1)], 0)
    assert K.is_contiguous() and torch.equal(K, cat)
    # the training side's operands, kept by the caller
    assert torch.equal(K, TK.k_block(e2, f2, e1, f1, params, 2, kind,
                                     mm_precision=mode, train_ops=t))
    other = "bf16" if mode == "highest" else "highest"
    with pytest.raises(ValueError, match="built in mode"):
        TK.k_block(e2, f2, e1, f1, params, 2, kind, mm_precision=other,
                   train_ops=t)


@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_kee_served_rounds_a_float64_product_once(kind):
    """The served K_EE: on float32 operands the float64 K_EE rounded once
    to float32; on float64 operands K_EE itself."""
    (e1, _, e2, _), _ = _data(73, torch.float32, 2)
    params = RBF if kind == "rbf" else DOT
    U1, w1 = kff.energy_operand(e1, "highest")
    U2, w2 = kff.energy_operand(e2, "highest")
    A1, A2 = e1.x.shape[1], e2.x.shape[1]
    ours = kff.kee_served(U1, w1, A1, U2, w2, A2, params, 2, kind=kind)
    f64 = torch.float64
    ref = kff.kee_from_ops(U1.to(f64), w1.to(f64), A1, U2.to(f64),
                           w2.to(f64), A2, params, 2, kind=kind)
    assert ours.dtype == torch.float32 and torch.equal(ours, ref.float())
    assert torch.equal(
        kff.kee_served(U1.to(f64), w1.to(f64), A1, U2.to(f64), w2.to(f64),
                       A2, params, 2, kind=kind), ref)


@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_k_block_in_float64_keeps_k_ee_unrounded(kind, gram):
    """k_block(dtype=float64) on float32 data: the float32 block's kernel
    parts cast, K_EE in float64 -- served, the float64 product not rounded
    (kee_served); of a training Gram (gram=True), computed in float64
    from the rounded operands, as k_self(dtype=float64) computes it."""
    (e1, f1, e2, f2), _ = _data(74, torch.float32, 2)
    params = RBF if kind == "rbf" else DOT
    f64 = torch.float64
    K32 = TK.k_block(e2, f2, e1, f1, params, 2, kind, gram=gram)
    K = TK.k_block(e2, f2, e1, f1, params, 2, kind, gram=gram, dtype=f64)
    m1, m2 = e2.m, e1.m
    assert K.dtype == f64 and K32.dtype == torch.float32
    rest = torch.ones_like(K, dtype=torch.bool)
    rest[:m1, :m2] = False
    assert torch.equal(K[rest], K32.double()[rest])
    U1, w1 = kff.energy_operand(e2, "highest")
    U2, w2 = kff.energy_operand(e1, "highest")
    ee = kff.kee_from_ops(U1.to(f64), w1.to(f64), e2.x.shape[1], U2.to(f64),
                          w2.to(f64), e1.x.shape[1], params, 2, kind=kind)
    assert torch.equal(K[:m1, :m2], ee)
    if not gram:
        # served in float32: the same product rounded once
        assert torch.equal(K32[:m1, :m2], ee.float())


def test_out_and_transpose_on_the_cpu():
    """out= and transpose= of the wrappers on CPU tensors: the plain
    version's block, written into a slice and nothing else."""
    (e1, f1, e2, f2), _ = _data(71, torch.float64, 2)
    q, t = TK.side_operands(e2, f2, "highest"), \
        TK.side_operands(e1, f1, "highest")
    ef = kff.kef_plain(t.U, t.w, t.A, q.X, q.re, q.B, RBF, 2)
    ff = kff.kff_plain(q.X, q.re, q.B, t.X, t.re, t.B, RBF, 2)
    buf = torch.full((ef.shape[1] + 3, ef.shape[0] + 2), float("nan"),
                     dtype=torch.float64)
    view = buf[1:1 + ef.shape[1], 2:]
    assert kff.kef_from_ops(t.U, t.w, t.A, q.X, q.re, q.B, RBF, 2, out=view,
                            transpose=True) is view
    assert torch.equal(view, ef.T)
    assert bool(torch.isnan(buf[0]).all() and torch.isnan(buf[:, :2]).all())
    assert torch.equal(kff.kef_from_ops(t.U, t.w, t.A, q.X, q.re, q.B, RBF,
                                        2, transpose=True), ef.T)
    out = torch.empty_like(ff)
    kff.kff_from_ops(q.X, q.re, q.B, t.X, t.re, t.B, RBF, 2, out=out)
    assert torch.equal(out, ff)
    with pytest.raises(ValueError):
        kff.kff_from_ops(q.X, q.re, q.B, q.X, q.re, q.B, RBF, 2,
                         symmetric=True, out=out)
    with pytest.raises(ValueError):
        kff.kef_from_ops(t.U, t.w, t.A, q.X, q.re, q.B, RBF, 2, dual=True,
                         transpose=True)


# ---------------------------------------------------------------------------
# (iv) the training-side operands a fitted model keeps
# ---------------------------------------------------------------------------

SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527


def _model(images, ks, dtype=torch.float64):
    gp = T.GP(kernel=T.RBF(para=[SIGMA, L_SCALE], zeta=2),
              descriptor=T.SO3(nmax=3, lmax=4, rcut=5.0), noise_e=0.05 / 13,
              noise_f=0.05, log_file=None, device="cpu", dtype=dtype)
    for k in ks:
        _add(gp, images[k])
    gp.fit(opt=False, show=False)
    return gp


def _add(gp, image):
    a = image.copy()
    a.calc = T.EMT()
    e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
    a.calc = None
    gp.add_structure((a, e, f))


def _served(gp, image):
    E, F, _, E_std, F_std = gp.predict_structure(image, return_std=True)
    return np.concatenate([[E, E_std], F.ravel(), F_std.ravel()])


def test_model_builds_training_operands_once_per_fit():
    """Serve, serve, refit with one more structure, serve: the training
    side is built once per fit, and every answer equals that of a fresh
    model of the same training set (whose operands are fresh too)."""
    images = T.au_on_al100_images()
    gp = _model(images, (0, 4))
    TK.reset_operand_builds()
    first = _served(gp, images[1])
    again = _served(gp, images[3])
    assert TK.operand_builds == {"query": 2, "train": 1}
    kept = gp.posterior.operands()
    assert gp.posterior.operands() is kept
    np.testing.assert_allclose(first, _served(_model(images, (0, 4)),
                                              images[1]), rtol=0, atol=1e-12)
    _add(gp, images[2])
    gp.fit(opt=False, show=False)
    assert gp.posterior.operands() is not kept
    TK.reset_operand_builds()
    after = _served(gp, images[3])
    assert TK.operand_builds == {"query": 1, "train": 0}
    # a fresh model of the same training set (the structure added to a
    # fitted model brought only the force points it was unsure about)
    state = {k: v for k, v in convert.state_of(gp).items()
             if k not in ("alpha", "L", "n_fit")}
    fresh = convert.gp_from_state(state, device="cpu", log_file=None)
    fresh.fit(opt=False, show=False)
    assert (fresh.N_energy, fresh.N_forces) == (gp.N_energy, gp.N_forces)
    np.testing.assert_allclose(after, _served(fresh, images[3]), rtol=0,
                               atol=1e-12)
    assert np.abs(after - again).max() > 1e-6      # the refit was served
    # a snapshot put in place from outside (convert.gp_from_state with the
    # factor carried over) is served from its own operands
    copy = convert.gp_from_state(convert.state_of(gp), device="cpu",
                                 log_file=None)
    np.testing.assert_allclose(_served(copy, images[3]), after, rtol=0,
                               atol=1e-9)


def test_set_kff_precision_between_requests_is_honoured():
    """A float32 model serves in highest, then in bf16x4: the kept
    operands are rebuilt in the new mode, and the answer is a fresh
    bf16x4 model's, not the highest one's."""
    images = T.au_on_al100_images()
    gp = _model(images, (0, 4, 2), torch.float32)
    try:
        hi = _served(gp, images[1])
        assert gp.posterior.operands().mode == "highest"
        config.set_kff_precision("bf16x4")
        TK.reset_operand_builds()
        x4 = _served(gp, images[1])
        assert TK.operand_builds["train"] == 1
        assert gp.posterior.operands().mode == "bf16x4"
        assert gp.posterior.operands().X.dtype == torch.bfloat16
        K_hi = TK.k_block(*_request(gp, images[1]), gp.kernel.params(), 2,
                          mm_precision="highest")
        K_x4 = TK.k_block(*_request(gp, images[1]), gp.kernel.params(), 2)
        assert not torch.equal(K_hi, K_x4)
        assert np.isfinite(x4).all() and np.abs(x4 - hi).max() < 1e-2
        config.set_kff_precision("highest")
        np.testing.assert_array_equal(_served(gp, images[1]), hi)
    finally:
        config.set_kff_precision("highest")


def _request(gp, image):
    from gpr_calculator_tpu_torch.atoms.atoms import ATOMIC_NUMBERS
    from gpr_calculator_tpu_torch.models.gp import _pack_from_device_descs
    dd = gp.descriptor.calculate_device(image, device=gp.device,
                                        dtype=gp.dtype)
    ele = np.asarray([ATOMIC_NUMBERS[s] for s in dd["elements"]])
    free = [i for i in range(len(ele))
            if i not in set(image.fixed_indices())]
    pe, pf = _pack_from_device_descs([dd], [ele], [free])
    te, tf, _, _ = gp._fit_snapshot
    return pe, pf, te, tf


def test_factorize_solves_float32_covariance_in_float64():
    """_factorize on float32 data: alpha is the float64 solve of the same
    K (float32 force blocks, K_EE and the noise in float64), kept in
    float64, which a float32 solve of this ill-conditioned K misses by
    far; L is K's factor, kept in float64 as well; the served mean is the
    float64 product of the served block (its K_EE in float64) with alpha,
    the variance a float64 solve against L."""
    from gpr_calculator_tpu_torch.models.gp import _factorize, _noise_diag
    from gpr_calculator_tpu_torch.ops.packing import EnergyData, ForceData
    rng = np.random.RandomState(11)
    f32 = torch.float32
    m_e, m_f, envs, d = 12, 40, 16, 30
    e = EnergyData(
        x=torch.as_tensor(rng.uniform(0.2, 1.0, (m_e, envs, d)), dtype=f32),
        ele=torch.as_tensor(rng.choice([13, 79], (m_e, envs)),
                            dtype=torch.int32),
        counts=torch.full((m_e,), float(envs), dtype=f32), nreal=m_e)
    f = ForceData(
        x=torch.as_tensor(rng.uniform(0.2, 1.0, (m_f, envs, d)), dtype=f32),
        dxdr=torch.as_tensor(rng.uniform(-1, 1, (m_f, envs, d, 3)),
                             dtype=f32),
        ele=torch.as_tensor(rng.choice([13, 79], (m_f, envs)),
                            dtype=torch.int32), nreal=m_f)
    params, noise = {"sigma": 2.0, "l": 1.0}, (1e-3, 1e-2)
    y = torch.as_tensor(rng.randn(m_e + 3 * m_f) * 0.1, dtype=f32)
    L, alpha = _factorize(e, f, y, params, *noise, 2, "rbf")
    assert L.dtype == torch.float64 and alpha.dtype == torch.float64
    K = TK.k_self(e, f, params, 2, dtype=torch.float64)
    K.diagonal().add_(_noise_diag(e, f, *noise))
    a64 = torch.cholesky_solve(y.double()[:, None],
                               torch.linalg.cholesky(K))[:, 0]
    a32 = torch.cholesky_solve(y[:, None],
                               torch.linalg.cholesky(K.float()))[:, 0]
    scale = float(a64.abs().max())
    ours = float((alpha.double() - a64).abs().max()) / scale
    plain32 = float((a32.double() - a64).abs().max()) / scale
    assert ours <= 1e-12 and plain32 > 1e-6
    _close((L.double() @ L.double().T).numpy(), K.double().numpy(), 1e-6)
    from gpr_calculator_tpu_torch.models.gp import _predict_packed
    from gpr_calculator_tpu_torch.models.posterior import Posterior
    mean, std = _predict_packed(e, f, Posterior.from_packed(e, f, L, alpha),
                                params, 2, "rbf", True)
    Kt = TK.k_block(e, f, e, f, params, 2, dtype=torch.float64)
    assert mean.dtype == torch.float64 and std.dtype == torch.float64
    assert torch.equal(mean, Kt @ alpha)
