"""The training covariance of the PyTorch port around K1 (the symmetric
K_FF kernel), on the CPU: ``k_self`` / ``k_self_dual`` from element-sorted
operands against the JAX package, the plain version's tile ranges, what a
K1 launch stages and multiplies (``staged_pairs`` in its triangle form),
and the covariance built in one buffer.

Inputs come from a numpy seed and go through the JAX package and the
port.  Tolerances: float64 against the JAX package's XLA blocks 1e-10 of
the largest entry (the same sums in another order); float32 against the
Pallas kernels in interpret mode rtol 2e-5 (atol 1e-6 of the largest
entry), as tests/test_torch_kff.py holds them; tile ranges and the one
buffer against the whole and the concatenated form: bit for bit.  The K1
kernels themselves run on the card (tests/test_torch_kff.py, ``-m gpu``).
"""
import numpy as np
import pytest
import torch

from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force
from gpr_calculator_tpu_torch.parallel import partition_tri_tiles

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

RBF = {"sigma": 1.3, "l": 0.9}
DOT = {"sigma": 1.3, "sigma0": 0.7}
ELEMENTS = {1: (13,), 2: (13, 79), 3: (13, 29, 79)}
# (zeta, number of elements)
ZETA_ELEMENTS = [(1, 2), (2, 2), (3, 3), (2, 1)]


def _points(rng, n_pts, n_env, elements, d=30):
    pts = []
    for _ in range(n_pts):
        ne = rng.randint(max(1, n_env - 4), n_env + 1)
        pts.append((rng.uniform(0.2, 1.0, (ne, d)),
                    rng.uniform(-1.0, 1.0, (ne, d, 3)),
                    rng.choice(elements, ne)))
    return pts


def _data(seed, dtype, n_elements):
    """A training set of 4 energy and 19 force points (three 8-point tiles
    a side, the last ragged), padding envs and an all-padding point on
    each side."""
    rng = np.random.RandomState(seed)
    el = ELEMENTS[n_elements]
    fp = _points(rng, 19, 10, el)
    ep = [(x, e) for x, _, e in _points(rng, 4, 11, el)]
    shape = dict(e=dict(m_pad=5, a_pad=13), f=dict(m_pad=20, b_pad=12))
    kw = dict(device="cpu", dtype=dtype)
    return ((pack_energy(ep, **shape["e"], **kw),
             pack_force(fp, **shape["f"], **kw)), (ep, fp, shape))


def _jax_data(ep, fp, shape):
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    return jpe(ep, **shape["e"]), jpf(fp, **shape["f"])


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _self(e, f, params, zeta, kind):
    """k_self and (RBF) both planes of k_self_dual."""
    out = [TK.k_self(e, f, params, zeta, kind)]
    if kind == "rbf":
        out += list(TK.k_self_dual(e, f, params, zeta))
    return out


def _flags(variant):
    return dict(dual=variant == "dual", deriv=variant == "deriv",
                kind="dot" if variant == "dot" else "rbf")


# ---------------------------------------------------------------------------
# (i) the training covariance from element-sorted operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zeta,n_elements", ZETA_ELEMENTS)
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_sorted_k_self_matches_xla_f64(kind, zeta, n_elements, monkeypatch):
    """k_self and k_self_dual with every side sorted by element against
    the JAX package's XLA builds (1e-10 of the largest entry)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    (e, f), raw = _data(10 * zeta + n_elements, torch.float64, n_elements)
    je, jf = _jax_data(*raw)
    params = RBF if kind == "rbf" else DOT
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    ours = _self(e, f, params, zeta, kind)
    refs = [JK.k_self(je, jf, jp, kind, zeta, allow_pallas=False)]
    if kind == "rbf":
        refs += list(JK.k_self_dual(je, jf, jp, zeta, allow_pallas=False))
    for o, r in zip(ours, refs):
        _close(o.numpy(), r, 1e-10)
        assert torch.equal(o, o.T)


@pytest.mark.parametrize("zeta,n_elements", ZETA_ELEMENTS[:3])
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_sorted_k_self_matches_pallas_interpret_f32(kind, zeta, n_elements,
                                                    monkeypatch):
    """The float32 training covariance from element-sorted operands
    against the Pallas kernels in interpret mode (highest,
    _pallas_self_blocks: K1 and K2 there)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    monkeypatch.setenv("GPR_CALC_TPU_KFF_INTERPRET", "1")
    monkeypatch.setenv("GPR_CALC_TPU_KFF_PRECISION", "highest")
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    (e, f), raw = _data(50 + 10 * zeta + n_elements, torch.float32,
                        n_elements)
    je, jf = _jax_data(*raw)
    params = RBF if kind == "rbf" else DOT
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    refs = list(JK._pallas_self_blocks(je, jf, jp, kind, zeta,
                                       dual=kind == "rbf"))
    if kind == "rbf":
        refs = [refs[0]] + refs
    for ours, ref in zip(_self(e, f, params, zeta, kind), refs):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=1e-6 * float(ours.abs().max()))


# ---------------------------------------------------------------------------
# (ii) the plain version's tile ranges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4, 7])
@pytest.mark.parametrize("variant", ["rbf", "dual", "deriv", "dot"])
def test_plain_tile_ranges_on_sorted_operands_sum_to_whole(variant, shards):
    """kff_plain(tiles=) over ranges that partition the upper-triangle
    tiles, on element-sorted operands: every element comes from exactly
    one range (the others hold zeros there), so the sum is the whole
    symmetric K_FF bit for bit; the wrapper on CPU tensors agrees, also
    written into a caller's view."""
    (_, f), _ = _data(7, torch.float64, 3)
    X, re = kff.force_operand(f, sort=True)
    B = f.x.shape[1]
    params = DOT if variant == "dot" else RBF
    fl = _flags(variant)
    args = (X, re, B, X, re, B, params, 2)

    def planes(x):
        return x if isinstance(x, tuple) else (x,)
    whole = planes(kff.kff_plain(*args, symmetric=True, **fl))
    total = [torch.zeros_like(w) for w in whole]
    ranges = partition_tri_tiles(kff.n_tri_tiles(f.m), shards)
    assert sum(nk for _, nk in ranges) == kff.n_tri_tiles(f.m) == 6
    for tiles in ranges:
        part = planes(kff.kff_plain(*args, symmetric=True, tiles=tiles,
                                    **fl))
        views = [torch.full_like(w, float("nan")) for w in whole]
        got = planes(kff.kff_from_ops(*args, symmetric=True, tiles=tiles,
                                      out=views[0],
                                      outd=views[-1] if fl["dual"] else None,
                                      **fl))
        for acc, p, g, v, w in zip(total, part, got, views, whole):
            assert g is v and torch.equal(g, p)
            own = kff.tile_mask(f.m, tiles)
            assert torch.equal(p[own], w[own]) and not bool(p[~own].any())
            acc.add_(p)
    for acc, w in zip(total, whole):
        assert torch.equal(acc, w)


# ---------------------------------------------------------------------------
# (iii) what a K1 launch stages and multiplies
# ---------------------------------------------------------------------------

def _brute_triangle(re, B):
    """(staged, chunk pairs) and (multiplied, lhs point x chunk pairs) of a
    K1 launch over upper-triangle tile pairs, by loops over the envs; and
    the same-element weighted env pairs that lie in staged chunk pairs,
    against all of them (every such pair must be staged)."""
    m = re.shape[1] // B
    w, el = re[0].reshape(m, B).numpy(), re[1].reshape(m, B).numpy()
    TP, CB = kff.TP, 4
    nt, nc = -(-m // TP), -(-B // CB)

    def rng(points, c):
        vals = [el[p, e] for p in points if p < m
                for e in range(c * CB, min(B, (c + 1) * CB)) if w[p, e] != 0]
        return (min(vals), max(vals)) if vals else (np.inf, -np.inf)
    staged = grid = mult = covered = needed = 0
    for t1 in range(nt):
        for t2 in range(t1, nt):
            pts1 = range(t1 * TP, (t1 + 1) * TP)
            pts2 = range(t2 * TP, (t2 + 1) * TP)
            for c1 in range(nc):
                r1 = rng(pts1, c1)
                for c2 in range(nc):
                    r2 = rng(pts2, c2)
                    grid += 1
                    meet = not (r1[1] < r2[0] or r2[1] < r1[0])
                    pairs = sum(
                        int(w[p, a] != 0 and w[q, b] != 0
                            and el[p, a] == el[q, b])
                        for p in pts1 if p < m for q in pts2 if q < m
                        for a in range(c1 * CB, min(B, (c1 + 1) * CB))
                        for b in range(c2 * CB, min(B, (c2 + 1) * CB)))
                    needed += pairs
                    if not meet:
                        continue
                    staged += 1
                    covered += pairs
                    for p in pts1:
                        lo, hi = rng([p], c1)
                        mult += not (hi < r2[0] or r2[1] < lo)
    return (staged, grid), (mult, TP * grid), (covered, needed)


@pytest.mark.parametrize("n_elements", [1, 2, 3])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_staged_pairs_triangle_matches_brute_force(sort, n_elements):
    rng = np.random.RandomState(20 + n_elements)
    f = pack_force(_points(rng, 19, 13, ELEMENTS[n_elements]), m_pad=20,
                   b_pad=14, device="cpu", dtype=torch.float64)
    _, re = kff.force_operand(f, sort=sort)
    (staged, grid), (mult, prods), (covered, needed) = _brute_triangle(re, 14)
    assert covered == needed
    assert kff.staged_pairs(re, 14, re, 14, triangle=True) == (staged, grid)
    assert kff.staged_pairs(re, 14, re, 14, triangle=True,
                            per_lhs_point=True) == (mult, prods)
    # three tiles a side: 6 of the 9 tile pairs, 4 x 4 chunk pairs each
    assert grid == 6 * 16
    if sort and n_elements > 1:
        assert staged < grid and mult < prods


@pytest.mark.parametrize("b_pad", [12, 13])
def test_tri_operand_is_the_k_major_copy(b_pad):
    """The copy the highest K1 kernels read through their tensor map: rows
    c DP + k hold X[c, p B + e, k], then the weights and the elements;
    envs padded to a multiple of 4 with zeros; built once per operand and
    rebuilt when the operand changes in place."""
    rng = np.random.RandomState(40 + b_pad)
    f = pack_force(_points(rng, 9, 10, ELEMENTS[2]), b_pad=b_pad,
                   device="cpu", dtype=torch.float32)
    X, re = kff.force_operand(f, sort=True)
    m, B = f.m, b_pad
    Xt = kff.tri_operand(X, re, B)
    assert Xt.shape == (kff.TROWS, m, -(-B // 4) * 4)
    rows = X.reshape(4, m, B, kff.DP).permute(0, 3, 1, 2)
    assert torch.equal(Xt[:4 * kff.DP, :, :B], rows.reshape(-1, m, B))
    assert torch.equal(Xt[4 * kff.DP:, :, :B], re.reshape(2, m, B))
    assert not bool(Xt[:, :, B:].any())
    kept = kff._tri_copy(X, re, B)
    assert torch.equal(kept, Xt) and kff._tri_copy(X, re, B) is kept
    X.mul_(2.0)
    again = kff._tri_copy(X, re, B)
    assert again is not kept
    assert torch.equal(again[:4 * kff.DP], 2.0 * Xt[:4 * kff.DP])


# ---------------------------------------------------------------------------
# (iv) the training covariance in one buffer
# ---------------------------------------------------------------------------

def _concatenated(e, f, params, zeta, kind, dtype=None):
    """The training covariance as the blocks concatenated: K_EE mirrored,
    K_EF, K_EF^T and the symmetric K_FF, each from the plain versions."""
    U, w = kff.energy_operand(e)
    X, re = kff.force_operand(f)
    A, B = e.x.shape[1], f.x.shape[1]
    Ud = kff.dense(U)
    dt = Ud.dtype if dtype is None else dtype
    if kind == "rbf_dual":
        ee = kff.kee_from_ops(Ud, w, A, Ud, w, A, params, zeta, dual=True)
        ef = kff.kef_plain(U, w, A, X, re, B, params, zeta, dual=True)
        ff = kff.kff_plain(X, re, B, X, re, B, params, zeta, symmetric=True,
                           dual=True)
    else:
        Ud, wd = Ud.to(dt), w.to(dt)
        ee = (kff.kee_from_ops(Ud, wd, A, Ud, wd, A, params, zeta,
                               kind=kind),)
        ef = (kff.kef_plain(U, w, A, X, re, B, params, zeta,
                            kind=kind).to(dt),)
        ff = (kff.kff_plain(X, re, B, X, re, B, params, zeta, symmetric=True,
                            kind=kind).to(dt),)
    return [torch.cat([torch.cat([kff._mirror(a), b], 1),
                       torch.cat([b.T, c], 1)], 0)
            for a, b, c in zip(ee, ef, ff)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["rbf", "dot", "rbf_dual"])
def test_k_self_in_one_buffer_equals_concatenated(kind, dtype):
    """k_self (RBF, Dot) and both planes of k_self_dual, built in one
    buffer, equal the concatenated blocks bit for bit, and come out
    contiguous and exactly symmetric; plain=True and a float64 result
    from float32 data (the Dot NLL's) too."""
    (e, f), _ = _data(33, dtype, 2)
    params = DOT if kind == "dot" else RBF
    if kind == "rbf_dual":
        ours = list(TK.k_self_dual(e, f, params, 2))
        again = list(TK.k_self_dual(e, f, params, 2, plain=True))
    else:
        ours = [TK.k_self(e, f, params, 2, kind)]
        again = [TK.k_self(e, f, params, 2, kind, plain=True)]
    for o, a, c in zip(ours, again, _concatenated(e, f, params, 2, kind)):
        assert o.is_contiguous() and o.dtype == dtype
        assert torch.equal(o, c) and torch.equal(a, c)
        assert torch.equal(o, o.T)
    if kind == "dot" and dtype == torch.float32:
        wide = TK.k_self(e, f, params, 2, kind, dtype=torch.float64)
        assert wide.dtype == torch.float64
        assert torch.equal(wide, _concatenated(e, f, params, 2, kind,
                                               torch.float64)[0])


def test_symmetric_and_dual_out_on_the_cpu():
    """out= and outd= of K1 and K2-dual on CPU tensors: the plain
    version's planes, written into slices of a NaN-filled buffer and
    nothing else; a view of the wrong shape, or outd= without a dual
    pass, is refused."""
    (e, f), _ = _data(34, torch.float64, 3)
    U, w = kff.energy_operand(e)
    X, re = kff.force_operand(f)
    A, B, n = e.x.shape[1], f.x.shape[1], 3 * f.m
    ff = kff.kff_plain(X, re, B, X, re, B, RBF, 2, symmetric=True, dual=True)
    ef = kff.kef_plain(U, w, A, X, re, B, RBF, 2, dual=True)
    bufs = [torch.full((n + 2, n + 5), float("nan"), dtype=torch.float64)
            for _ in range(2)]
    sl = (slice(1, 1 + n), slice(4, 4 + n))
    got = kff.kff_from_ops(X, re, B, X, re, B, RBF, 2, symmetric=True,
                           dual=True, out=bufs[0][sl], outd=bufs[1][sl])
    for g, buf, ref in zip(got, bufs, ff):
        assert torch.equal(g, ref) and torch.equal(buf[sl], ref)
        assert bool(torch.isnan(buf[0]).all() and torch.isnan(buf[:, :4]).all())
    views = [torch.empty_like(ef[0]) for _ in range(2)]
    got = kff.kef_from_ops(U, w, A, X, re, B, RBF, 2, dual=True,
                           out=views[0], outd=views[1])
    assert all(g is v and torch.equal(v, r)
               for g, v, r in zip(got, views, ef))
    with pytest.raises(ValueError):
        kff.kff_from_ops(X, re, B, X, re, B, RBF, 2, symmetric=True,
                         out=torch.empty((n, n - 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="dual"):
        kff.kff_from_ops(X, re, B, X, re, B, RBF, 2, symmetric=True,
                         out=torch.empty((n, n), dtype=torch.float64),
                         outd=torch.empty((n, n), dtype=torch.float64))
    with pytest.raises(ValueError, match="transpose"):
        kff.kef_from_ops(U, w, A, X, re, B, RBF, 2, dual=True,
                         transpose=True)
