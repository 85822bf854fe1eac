"""K1 (kff_tri*) in the bf16x4 and bf16 modes, on the CPU: what the mode K1
kernels of csrc/kff_tri_mma.cu compute, read and skip.

Every side's envs are sorted by element here (``monkeypatch`` of
``kff.SORT_MIN_ENVS`` to 0), the layout the kernels' element skip works on.
Inputs come from a numpy seed and go through the JAX package and the port.
Tolerances: the port's plain versions on its sorted operands against the
JAX ``_pallas_self_blocks`` in interpret mode at the same mode, each
package on its own operands, 2e-5 max|JAX| + 1e-6 (the tolerance of
tests/test_torch_precision.py: float32 with the sums in another order, and
the two packages' float32 rows may differ in the last bit); sorted against
packed operands 1e-5 max|K| (a permutation of a point's envs moves only the
order of a float32 sum); tile ranges against the whole, bit for bit.  The
kernels themselves are held against these plain versions on the card
(``-m gpu`` in tests/test_torch_kff.py, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops.packing import pack_force
from gpr_calculator_tpu_torch.parallel import partition_tri_tiles

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)
from test_torch_serving_block import _brute_ranges
from test_torch_tri_kernel import ELEMENTS, _data, _jax_data, _points

MODES = ("bf16x4", "bf16")
VARIANTS = ("rbf", "dual", "deriv", "dot")
RBF = {"sigma": 1.3, "l": 0.9}
DOT = {"sigma": 1.3, "sigma0": 0.7}


def _flags(variant):
    return dict(dual=variant == "dual", deriv=variant == "deriv",
                kind="dot" if variant == "dot" else "rbf")


def _planes(x):
    return x if isinstance(x, tuple) else (x,)


def _close(ours, ref):
    ref = np.asarray(ref, np.float64)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy().astype(np.float64), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max() + 1e-6)


def _k1(f, mode, variant, zeta, sort=None, tiles=None):
    """The planes of K1 (kff_plain(symmetric=True)) of one variant on the
    operand of ``f`` built in ``mode``."""
    X, re = kff.force_operand(f, mode, sort=sort)
    B = f.x.shape[1]
    return _planes(kff.kff_plain(X, re, B, X, re, B,
                                 DOT if variant == "dot" else RBF, zeta,
                                 symmetric=True, tiles=tiles,
                                 **_flags(variant)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_sorted_mode_k1_matches_pallas_self_blocks(mode, variant,
                                                  monkeypatch):
    """K1 of each variant and the training covariance around it (k_self,
    k_self_dual) from sorted operands in float32: the port's plain
    versions in a mode against the JAX training build at the same mode in
    interpret mode (GPR_CALC_TPU_KFF_INTERPRET=1, the mode from
    GPR_CALC_TPU_KFF_PRECISION), whose K1 is _kff_kernel_tri."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    monkeypatch.setenv("GPR_CALC_TPU_KFF_INTERPRET", "1")
    monkeypatch.setenv("GPR_CALC_TPU_KFF_PRECISION", mode)
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    (e, f), raw = _data(120 + VARIANTS.index(variant), torch.float32, 3)
    je, jf = _jax_data(*raw)
    params = DOT if variant == "dot" else RBF
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    zeta = 3 if variant == "deriv" else 2
    # the operand carries the sort: element ids in order, padding last
    _, re = kff.force_operand(f, mode)
    B = f.x.shape[1]
    el, wt = re[1].reshape(-1, B), re[0].reshape(-1, B)
    key = torch.where(wt != 0, el, torch.full_like(el, 1e9))
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    kind = {"rbf": "rbf", "dual": "rbf", "deriv": "rbf_dgamma",
            "dot": "dot"}[variant]
    refs = JK._pallas_self_blocks(je, jf, jp, kind, zeta,
                                  dual=variant == "dual")
    if variant == "dual":
        ours = TK.k_self_dual(e, f, params, zeta, mm_precision=mode)
    else:
        ours = (TK.k_self(e, f, params, zeta, kind, mm_precision=mode),)
    m = e.m
    k1 = _k1(f, mode, variant, zeta)
    assert len(ours) == len(refs) == len(k1)
    for whole, ff, ref in zip(ours, k1, refs):
        ref = np.asarray(ref)
        _close(whole, ref)
        _close(ff, ref[m:, m:])
        assert torch.equal(ff, ff.T) and torch.equal(whole, whole.T)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_sorted_and_packed_mode_k1_agree(mode, variant):
    """Sorting each point's envs moves only the order of its float32 sum:
    K1 from sorted and from packed operands in a mode agree to 1e-5
    max|K| on every plane."""
    (_, f), _ = _data(130 + VARIANTS.index(variant), torch.float32, 2)
    for a, b in zip(_k1(f, mode, variant, 2, sort=True),
                    _k1(f, mode, variant, 2, sort=False)):
        scale = float(b.abs().max())
        assert scale > 0
        assert float((a - b).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_mode_plain_tile_ranges_sum_to_whole(mode, variant):
    """kff_plain(tiles=) in a mode on sorted operands, over four ranges
    that partition the upper-triangle tiles: every element comes from
    exactly one range, so the ranges sum to the whole K1 bit for bit; the
    wrapper on CPU tensors writes the same into a caller's view."""
    (_, f), _ = _data(140 + VARIANTS.index(variant), torch.float32, 3)
    X, re = kff.force_operand(f, mode, sort=True)
    B = f.x.shape[1]
    whole = _k1(f, mode, variant, 2, sort=True)
    total = [torch.zeros_like(w) for w in whole]
    ranges = partition_tri_tiles(kff.n_tri_tiles(f.m), 4)
    assert sum(nk for _, nk in ranges) == kff.n_tri_tiles(f.m) == 6
    fl = _flags(variant)
    for tiles in ranges:
        part = _k1(f, mode, variant, 2, sort=True, tiles=tiles)
        views = [torch.full_like(w, float("nan")) for w in whole]
        got = _planes(kff.kff_from_ops(
            X, re, B, X, re, B, DOT if variant == "dot" else RBF, 2,
            symmetric=True, tiles=tiles, mm_precision=mode, out=views[0],
            outd=views[-1] if fl["dual"] else None, **fl))
        own = kff.tile_mask(f.m, tiles)
        for acc, p, g, v, w in zip(total, part, got, views, whole):
            assert g is v and torch.equal(g, p)
            assert torch.equal(p[own], w[own]) and not bool(p[~own].any())
            acc.add_(p)
    for acc, w in zip(total, whole):
        assert torch.equal(acc, w)


@pytest.mark.parametrize("n_elements", [1, 2, 3])
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "packed"])
def test_mma_pairs_triangle_matches_brute_force(sort, n_elements):
    """What a mode K1 launch stages and multiplies, counted by a loop over
    the upper-triangle tile pairs I <= J: chunks of CB envs of TP points on
    both sides, staged when their element ranges meet; inside, a warp
    product (4 lhs points x CB envs against 2 rhs points x CB envs)
    multiplied when one of its env pairs carries a weight on both sides
    and shares an element."""
    rng = np.random.RandomState(150 + n_elements)
    f = pack_force(_points(rng, 19, 13, ELEMENTS[n_elements]), m_pad=20,
                   b_pad=14, device="cpu", dtype=torch.float64)
    _, re = kff.force_operand(f, sort=sort)
    B, m, TP, CB = 14, 20, kff.TP, kff.CB
    r = _brute_ranges(re, B, TP, CB)
    w, el = re[0].numpy(), re[1].numpy()
    same = ((w[:, None] != 0) & (w[None, :] != 0)
            & (el[:, None] == el[None, :]))

    def envs(p0, n_points, c):
        return [p * B + e for p in range(p0, min(m, p0 + n_points))
                for e in range(c * CB, min(B, (c + 1) * CB))]
    staged = n_pairs = multiplied = n_products = 0
    for t1 in range(r.shape[0]):
        for t2 in range(t1, r.shape[0]):
            for c1 in range(r.shape[1]):
                for c2 in range(r.shape[1]):
                    meet = not (r[t1, c1, 1] < r[t2, c2, 0]
                                or r[t2, c2, 1] < r[t1, c1, 0])
                    n_pairs += 1
                    staged += meet
                    for g1 in range(TP // 4):
                        rows = envs(t1 * TP + 4 * g1, 4, c1)
                        for g2 in range(TP // 2):
                            cols = envs(t2 * TP + 2 * g2, 2, c2)
                            n_products += 1
                            hit = bool(same[np.ix_(rows, cols)].any()) \
                                if rows and cols else False
                            assert meet or not hit
                            multiplied += meet and hit
    # three tiles a side: 6 upper-triangle tile pairs, 4 x 4 chunk pairs
    # and 2 x 4 warp products each
    assert n_pairs == 6 * 16 and n_products == 8 * n_pairs
    assert kff.mma_pairs(re, B, re, B, triangle=True) == \
        (staged, n_pairs, multiplied, n_products)
    assert 0 < multiplied <= n_products
    if n_elements > 1:
        assert multiplied < n_products
        if sort:
            assert staged < n_pairs
