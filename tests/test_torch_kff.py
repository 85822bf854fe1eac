"""K_FF / K_EF blocks of the PyTorch port (gpr_calculator_tpu_torch.ops.kff)
against the JAX package, and the CUDA kernels against their plain versions.

CPU: the plain versions in float32 against the Pallas kernels in interpret
mode at mm_precision="highest" (tolerances of tests/test_kff_pallas.py),
and in float64 against the XLA builds of ops/kernels.py at 1e-10.  The
``gpu`` tests run the kernels on the card (skipped without one) and hold
them within 2e-5 max|plain| of the plain versions: float32 with the sums
taken in another order.  JAX is imported inside the CPU tests only, so
``pytest --noconftest -m gpu`` runs on a machine without it.
"""
import numpy as np
import pytest
import torch

from gpr_calculator_tpu_torch import config
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    """The port runs on the card unless asked: the port's test modules
    (each imports this fixture) ask for the CPU, and leave the default
    device and matmul precision as they found them.  They run torch on
    one thread: the suite runs in several worker processes at once, where
    the spinning OpenMP threads of each slowed the port's many small
    operations several-fold; the thread count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    config.set_device("cpu")
    yield
    config.set_device(None)
    config.set_kff_precision("highest")
    torch.set_num_threads(threads)


PARAMS = {"sigma": 1.3, "l": 0.9}


def make_points(rng, n_pts, n_env, d, elements=(13, 79)):
    """Ragged points: env counts vary per point, two elements."""
    pts = []
    for _ in range(n_pts):
        ne = rng.randint(max(1, n_env - 2), n_env + 1)
        pts.append((rng.uniform(0.2, 1.0, (ne, d)),
                    rng.uniform(-1.0, 1.0, (ne, d, 3)),
                    rng.choice(elements, ne)))
    return pts


def _data(seed, dtype, device="cpu"):
    """Energy/force blocks with padding envs (b_pad above the largest env
    count) and a padded energy point."""
    rng = np.random.RandomState(seed)
    fp1, fp2 = make_points(rng, 5, 6, 30), make_points(rng, 3, 5, 30)
    ep = [(x, el) for x, _, el in make_points(rng, 3, 7, 30)]
    kw = dict(device=device, dtype=dtype)
    return (pack_energy(ep, m_pad=4, a_pad=9, **kw),
            pack_force(fp1, b_pad=8, **kw), pack_force(fp2, b_pad=7, **kw),
            (ep, fp1, fp2))


def _jax_blocks(ep, fp1, fp2):
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    return (jpe(ep, m_pad=4, a_pad=9), jpf(fp1, b_pad=8),
            jpf(fp2, b_pad=7))


def _ops(e, f1, f2):
    U, w = kff.energy_operand(e)
    X1, re1 = kff.force_operand(f1)
    X2, re2 = kff.force_operand(f2)
    return (U, w, e.x.shape[1]), (X1, re1, f1.x.shape[1]), \
        (X2, re2, f2.x.shape[1])


@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_plain_f32_matches_pallas_interpret(zeta):
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops.kff_pallas import kef_pallas, kff_pallas
    e, f1, f2, raw = _data(11 + zeta, torch.float32)
    je, jf1, jf2 = _jax_blocks(*raw)
    p32 = {"sigma": jnp.asarray(PARAMS["sigma"], jnp.float32),
           "l": jnp.asarray(PARAMS["l"], jnp.float32)}
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    kw = dict(zeta=zeta, interpret=True, mm_precision="highest")
    cases = [
        (kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, zeta),
         kff_pallas(jf1, jf2, p32, **kw)),
        (kff.kff_plain(X1, re1, B1, X1, re1, B1, PARAMS, zeta,
                       symmetric=True),
         kff_pallas(jf1, jf1, p32, symmetric=True, **kw)),
        (kff.kef_plain(U, w, A, X2, re2, B2, PARAMS, zeta),
         kef_pallas(je, jf2, p32, **kw)),
    ]
    for ours, ref in cases:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_plain_f64_matches_xla(zeta):
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    e, f1, f2, raw = _data(21 + zeta, torch.float64)
    je, jf1, jf2 = _jax_blocks(*raw)
    jp = {k: jnp.asarray(v) for k, v in PARAMS.items()}
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    cases = [
        (kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, zeta),
         JK.kff(jf1, jf2, jp, "rbf", zeta)),
        (kff.kef_plain(U, w, A, X2, re2, B2, PARAMS, zeta),
         JK.kef(je, jf2, jp, "rbf", zeta)),
        (kff.kee_from_ops(U, w, A, U, w, A, PARAMS, zeta),
         JK.kee(je, je, jp, "rbf", zeta)),
    ]
    for ours, ref in cases:
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_triangular_equals_rectangular_and_is_symmetric(dtype):
    _, f1, _, _ = _data(5, dtype)
    X, re = kff.force_operand(f1)
    B = f1.x.shape[1]
    rect = kff.kff_plain(X, re, B, X, re, B, PARAMS, 2)
    tri = kff.kff_plain(X, re, B, X, re, B, PARAMS, 2, symmetric=True)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(tri.numpy(), rect.numpy(), rtol=0,
                               atol=tol * rect.abs().max().item())
    assert torch.equal(tri, tri.T)


def test_cpu_wrappers_take_the_plain_version():
    e, f1, f2, _ = _data(7, torch.float64)
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    kff.reset_launches()
    assert torch.equal(
        kff.kff_from_ops(X1, re1, B1, X2, re2, B2, PARAMS, 2),
        kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, 2))
    assert torch.equal(
        kff.kff_from_ops(X1, re1, B1, X1, re1, B1, PARAMS, 2,
                         symmetric=True),
        kff.kff_plain(X1, re1, B1, X1, re1, B1, PARAMS, 2, symmetric=True))
    assert torch.equal(kff.kef_from_ops(U, w, A, X2, re2, B2, PARAMS, 2),
                       kff.kef_plain(U, w, A, X2, re2, B2, PARAMS, 2))
    assert all(n == 0 for n in kff.launches.values())


def test_k_self_blocks_share_operands():
    """k_self assembles K_EE, K_EF and the symmetric K_FF from one operand
    set: the result is the block matrix of the three plain builds."""
    e, f1, _, _ = _data(9, torch.float64)
    (U, w, A), (X, re, B), _ = _ops(e, f1, f1)
    K = TK.k_self(e, f1, PARAMS, 2)
    m = e.m
    assert torch.equal(K[:m, :m], kff._mirror(
        kff.kee_from_ops(U, w, A, U, w, A, PARAMS, 2)))
    assert torch.equal(K[:m, m:], kff.kef_plain(U, w, A, X, re, B,
                                                PARAMS, 2))
    assert torch.equal(K[m:, :m], K[:m, m:].T)
    assert torch.equal(K[m:, m:], kff.kff_plain(X, re, B, X, re, B, PARAMS,
                                                2, symmetric=True))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(kern, plain):
    err = (kern - plain).abs().max().item()
    assert err <= 2e-5 * plain.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_kernels_match_plain_on_card(cuda, zeta):
    rng = np.random.RandomState(30 + zeta)
    # ragged edges: 13 / 10 points (not multiples of the 8-point tile),
    # env counts 5..11 padded to 11 / 9 (not multiples of 4)
    fp1, fp2 = make_points(rng, 13, 11, 30), make_points(rng, 10, 9, 30)
    ep = [(x, el) for x, _, el in make_points(rng, 6, 7, 30)]
    kw = dict(device=cuda, dtype=torch.float32)
    e = pack_energy(ep, m_pad=7, **kw)
    f1, f2 = pack_force(fp1, **kw), pack_force(fp2, **kw)
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    kff.reset_launches()
    tri = kff.kff_from_ops(X1, re1, B1, X1, re1, B1, PARAMS, zeta,
                           symmetric=True)
    _close(tri, kff.kff_plain(X1, re1, B1, X1, re1, B1, PARAMS, zeta,
                              symmetric=True))
    assert torch.equal(tri, tri.T)
    _close(kff.kff_from_ops(X1, re1, B1, X2, re2, B2, PARAMS, zeta),
           kff.kff_plain(X1, re1, B1, X2, re2, B2, PARAMS, zeta))
    _close(kff.kef_from_ops(U, w, A, X2, re2, B2, PARAMS, zeta),
           kff.kef_plain(U, w, A, X2, re2, B2, PARAMS, zeta))
    torch.cuda.synchronize()
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            "kff_tri": 1, "kef_rect": 1, "kff_rect": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_dual_kernels_match_plain_on_card(cuda, zeta):
    """K1-dual and K2-dual: both planes within 2e-5 max|plain| of the
    plain dual pass (and the K plane of the single-pass kernel's), both
    planes of K1-dual exactly symmetric."""
    rng = np.random.RandomState(40 + zeta)
    fp = make_points(rng, 13, 11, 30)
    ep = [(x, el) for x, _, el in make_points(rng, 6, 7, 30)]
    kw = dict(device=cuda, dtype=torch.float32)
    e, f = pack_energy(ep, m_pad=7, **kw), pack_force(fp, **kw)
    (U, w, A), (X, re, B), _ = _ops(e, f, f)
    kff.reset_launches()
    tri = kff.kff_from_ops(X, re, B, X, re, B, PARAMS, zeta, symmetric=True,
                           dual=True)
    ef = kff.kef_from_ops(U, w, A, X, re, B, PARAMS, zeta, dual=True)
    plain_tri = kff.kff_plain(X, re, B, X, re, B, PARAMS, zeta,
                              symmetric=True, dual=True)
    plain_ef = kff.kef_plain(U, w, A, X, re, B, PARAMS, zeta, dual=True)
    for plane in range(2):
        _close(tri[plane], plain_tri[plane])
        assert torch.equal(tri[plane], tri[plane].T)
        _close(ef[plane], plain_ef[plane])
    _close(tri[0], kff.kff_from_ops(X, re, B, X, re, B, PARAMS, zeta,
                                    symmetric=True))
    _close(ef[0], kff.kef_from_ops(U, w, A, X, re, B, PARAMS, zeta))
    torch.cuda.synchronize()
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            "kff_tri": 1, "kef_rect": 1,
                            "kff_tri_dual": 1, "kef_rect_dual": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_dot_kernels_match_plain_on_card(cuda, zeta):
    """K1-dot, K2-dot and K3-dot within 2e-5 max|plain| of the plain Dot
    versions at ragged edges; K1-dot exactly symmetric."""
    rng = np.random.RandomState(50 + zeta)
    fp1, fp2 = make_points(rng, 13, 11, 30), make_points(rng, 10, 9, 30)
    ep = [(x, el) for x, _, el in make_points(rng, 6, 7, 30)]
    kw = dict(device=cuda, dtype=torch.float32)
    e = pack_energy(ep, m_pad=7, **kw)
    f1, f2 = pack_force(fp1, **kw), pack_force(fp2, **kw)
    (U, w, A), (X1, re1, B1), (X2, re2, B2) = _ops(e, f1, f2)
    p = {"sigma": 1.3, "sigma0": 0.7}
    kff.reset_launches()
    tri = kff.kff_from_ops(X1, re1, B1, X1, re1, B1, p, zeta,
                           symmetric=True, kind="dot")
    _close(tri, kff.kff_plain(X1, re1, B1, X1, re1, B1, p, zeta,
                              symmetric=True, kind="dot"))
    assert torch.equal(tri, tri.T)
    _close(kff.kff_from_ops(X1, re1, B1, X2, re2, B2, p, zeta, kind="dot"),
           kff.kff_plain(X1, re1, B1, X2, re2, B2, p, zeta, kind="dot"))
    _close(kff.kef_from_ops(U, w, A, X2, re2, B2, p, zeta, kind="dot"),
           kff.kef_plain(U, w, A, X2, re2, B2, p, zeta, kind="dot"))
    torch.cuda.synchronize()
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            "kff_tri_dot": 1, "kef_rect_dot": 1,
                            "kff_rect_dot": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("base", kff.BASES)
@pytest.mark.parametrize("mode", ["bf16x4", "bf16"])
def test_mode_kernels_match_plain_on_card(cuda, mode, base):
    """Each tensor-core kernel of a precision mode (and its deriv and
    K3-dual variants) within 2e-5 max|plain| of its plain version on the
    same rounded operands, at ragged edges; K1 exactly symmetric; one
    launch of that kernel alone; the card's split of the float32 rows is
    the CPU's bit for bit."""
    rng = np.random.RandomState(60)
    fp1, fp2 = make_points(rng, 13, 11, 30), make_points(rng, 10, 9, 30)
    ep = [(x, el) for x, _, el in make_points(rng, 6, 7, 30)]
    kw = dict(device=cuda, dtype=torch.float32)
    e = pack_energy(ep, m_pad=7, **kw)
    f1, f2 = pack_force(fp1, **kw), pack_force(fp2, **kw)
    U, w = kff.energy_operand(e, mode)
    X1, re1 = kff.force_operand(f1, mode)
    X2, re2 = kff.force_operand(f2, mode)
    A, B1, B2 = e.x.shape[1], f1.x.shape[1], f2.x.shape[1]
    dot = base.endswith("_dot")
    p = {"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS
    flags = dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf")
    sym = base.startswith("kff_tri")
    kff.reset_launches()
    if base.startswith("kef"):
        args = (U, w, A, X2, re2, B2, p, 2)
        K = kff.kef_from_ops(*args, mm_precision=mode, **flags)
        P = kff.kef_plain(*args, **flags)
    else:
        args = (X1, re1, B1) + ((X1, re1, B1) if sym else (X2, re2, B2)) \
            + (p, 2)
        K = kff.kff_from_ops(*args, symmetric=sym, mm_precision=mode,
                             **flags)
        P = kff.kff_plain(*args, symmetric=sym, **flags)
    torch.cuda.synchronize()
    for k, plain in zip(*((K, P) if flags["dual"] else ((K,), (P,)))):
        _close(k, plain)
        if sym:
            assert torch.equal(k, k.T)
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            kff.kernel_name(base, mode): 1}
    Xh, _ = kff.force_operand(f1, "highest")
    assert torch.equal(X1.cpu().view(torch.int16),
                       kff.split(Xh.cpu(), mode).view(torch.int16))


@pytest.mark.gpu
def test_card_wrappers_raise_on_unsupported_input(cuda):
    e, f1, f2, _ = _data(3, torch.float64, device=cuda)
    (U, w, A), (X1, re1, B1), _ = _ops(e, f1, f2)
    with pytest.raises(TypeError):
        kff.kff_from_ops(X1, re1, B1, X1, re1, B1, PARAMS, 2)
    X32, re32 = X1.float(), re1.float()
    with pytest.raises(ValueError):
        kff.kff_from_ops(X32[:, ::2], re32[:, ::2], B1, X32, re32, B1,
                         PARAMS, 2)
    with pytest.raises(ValueError):
        kff.kef_from_ops(U.float(), w.float(), A, X32.cpu(), re32.cpu(), B1,
                         PARAMS, 2)
    with pytest.raises(TypeError):
        kff.kff_from_ops(X1, re1, B1, X1, re1, B1, PARAMS, 2, symmetric=True,
                         dual=True)
    with pytest.raises(TypeError):
        kff.kef_from_ops(U, w, A, X1, re1, B1, PARAMS, 2, dual=True)
    with pytest.raises(ValueError):
        kff.kef_from_ops(U.float(), w.float(), A, X32[:, ::2], re32[:, ::2],
                         B1, PARAMS, 2, dual=True)
    dot = {"sigma": 1.3, "sigma0": 0.7}
    with pytest.raises(TypeError):
        kff.kff_from_ops(X1, re1, B1, X1, re1, B1, dot, 2, symmetric=True,
                         kind="dot")
    with pytest.raises(ValueError):
        kff.kff_from_ops(X32[:, ::2], re32[:, ::2], B1, X32, re32, B1, dot,
                         2, kind="dot")
    with pytest.raises(TypeError):
        kff.kef_from_ops(U, w, A, X1, re1, B1, dot, 2, kind="dot")
    Xb, reb = kff.force_operand(
        f1._replace(x=f1.x.float(), dxdr=f1.dxdr.float()), "bf16x4")
    with pytest.raises(ValueError, match="operand built in mode"):
        kff.kff_from_ops(Xb, reb, B1, Xb, reb, B1, PARAMS, 2,
                         symmetric=True, mm_precision="bf16")


K1_BASES = [b for b in kff.BASES if b.startswith("kff_tri")]


@pytest.mark.gpu
@pytest.mark.parametrize("base", K1_BASES)
@pytest.mark.parametrize("mode", ["highest", "bf16x4", "bf16"])
def test_k1_tile_ranges_sum_to_single_launch_on_card(cuda, mode, base):
    """The tile-range form of each K1 variant in each mode: the outputs
    of four range launches that partition the upper-triangle tiles sum to
    the single launch bit for bit (every plane, exactly symmetric), each
    range within 2e-5 max|plain| of kff_plain(tiles=), one ``_range``
    launch counted per non-empty range and no other kernel."""
    from gpr_calculator_tpu_torch.parallel import partition_tri_tiles
    rng = np.random.RandomState(70)
    # 29 points: 4 tiles a side with a ragged edge, 10 upper-triangle
    # tiles over 4 ranges (3, 3, 2, 2)
    f = pack_force(make_points(rng, 29, 11, 30), device=cuda,
                   dtype=torch.float32)
    X, re = kff.force_operand(f, mode)
    B = f.x.shape[1]
    dot = base.endswith("_dot")
    p = {"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS
    flags = dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf")
    args = (X, re, B, X, re, B, p, 2)

    def planes(x):
        return x if isinstance(x, tuple) else (x,)
    single = planes(kff.kff_from_ops(*args, symmetric=True,
                                     mm_precision=mode, **flags))
    ranges = partition_tri_tiles(kff.n_tri_tiles(f.m), 4)
    assert [nk for _, nk in ranges] == [3, 3, 2, 2]
    kff.reset_launches()
    total = [torch.zeros_like(s) for s in single]
    for tiles in ranges + [(10, 0)]:
        part = planes(kff.kff_from_ops(*args, symmetric=True,
                                       mm_precision=mode, tiles=tiles,
                                       **flags))
        plain = planes(kff.kff_plain(*args, symmetric=True, tiles=tiles,
                                     **flags))
        for acc, k, pl in zip(total, part, plain):
            assert (k - pl).abs().max().item() \
                <= 2e-5 * max(pl.abs().max().item(), 1e-30)
            acc.add_(k)
    torch.cuda.synchronize()
    for acc, s in zip(total, single):
        assert torch.equal(acc, s)
        assert torch.equal(acc, acc.T)
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            kff.kernel_name(base + "_range", mode): 4}
    with pytest.raises(ValueError, match="tile range"):
        kff.kff_from_ops(*args, symmetric=True, mm_precision=mode,
                         tiles=(8, 3), **flags)
    with pytest.raises(ValueError, match="symmetric"):
        kff.kff_from_ops(*args, mm_precision=mode, tiles=(0, 1), **flags)


# ---------------------------------------------------------------------------
# the rectangular highest kernels (K3 kff_rect*, K2 kef_rect*)
# ---------------------------------------------------------------------------

RECT_BASES = [b for b in kff.BASES if "_rect" in b]
# (lhs points, lhs envs, rhs points, rhs envs, elements): point counts 1,
# 7, 8, 9, 13, 100 and env counts 1, 3, 4, 13, 32, 33 on either side
RECT_CASES = [(1, 1, 7, 3, (13,)), (7, 3, 8, 4, (13, 79)),
              (8, 4, 9, 13, (13, 29, 79)), (9, 13, 13, 32, (13, 79)),
              (13, 32, 100, 33, (13, 29, 79)), (100, 33, 1, 1, (13, 79))]


def _ragged(rng, n_pts, n_env, elements, d=30):
    """Points with 1..n_env envs each (the first has n_env), elements at
    random, in no order."""
    pts = []
    for i in range(n_pts):
        ne = n_env if i == 0 else rng.randint(max(1, n_env - 3), n_env + 1)
        pts.append((rng.uniform(0.2, 1.0, (ne, d)),
                    rng.uniform(-1.0, 1.0, (ne, d, 3)),
                    rng.choice(elements, ne)))
    return pts


def _untouched(buf, rows, cols):
    """Everything of the NaN-filled ``buf`` outside the slice is NaN."""
    mask = torch.ones_like(buf, dtype=torch.bool)
    mask[rows, cols] = False
    return bool(torch.isnan(buf[mask]).all()) and \
        not bool(torch.isnan(buf[rows, cols]).any())


@pytest.mark.gpu
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("case", range(len(RECT_CASES)))
@pytest.mark.parametrize("base", RECT_BASES)
def test_rect_kernels_match_plain_on_card(cuda, base, case, sort):
    """Each redesigned rectangular kernel within 2e-5 max|plain| of its
    plain version on the same operands, sorted by element or not, at
    ragged point and env counts; two runs bit-equal; out= writes a slice
    of a NaN-filled buffer (K2 also transposed) and nothing else."""
    m1, B1, m2, B2, elements = RECT_CASES[case]
    zeta = 1 + case % 3
    rng = np.random.RandomState(100 + case)
    kw = dict(device=cuda, dtype=torch.float32)
    f2 = pack_force(_ragged(rng, m2, B2, elements), **kw)
    X2, re2 = kff.force_operand(f2, sort=sort)
    dot = base.endswith("_dot")
    p = {"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS
    flags = dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf")
    if base.startswith("kef"):
        e1 = pack_energy([(x, el) for x, _, el in
                          _ragged(rng, m1, B1, elements)], **kw)
        lhs = kff.energy_operand(e1, sort=sort) + (e1.x.shape[1],)
        fn, plain, rows = kff.kef_from_ops, kff.kef_plain, e1.m
    else:
        f1 = pack_force(_ragged(rng, m1, B1, elements), **kw)
        lhs = kff.force_operand(f1, sort=sort) + (f1.x.shape[1],)
        fn, plain, rows = kff.kff_from_ops, kff.kff_plain, 3 * f1.m
    args = lhs + (X2, re2, f2.x.shape[1], p, zeta)
    kff.reset_launches()
    K, again, P = fn(*args, **flags), fn(*args, **flags), plain(*args, **flags)
    torch.cuda.synchronize()
    planes = (K, again, P) if flags["dual"] else ((K,), (again,), (P,))
    for k, k2, pl in zip(*planes):
        assert k.shape == (rows, 3 * f2.m)
        _close(k, pl)
        assert torch.equal(k, k2)
    n = 2
    if not flags["dual"]:
        buf = torch.full((rows + 5, 3 * f2.m + 7), float("nan"), **kw)
        sl = (slice(2, 2 + rows), slice(3, 3 + 3 * f2.m))
        fn(*args, out=buf[sl], **flags)
        assert torch.equal(buf[sl], K) and _untouched(buf, *sl)
        n += 1
        if base.startswith("kef"):
            buf = torch.full((3 * f2.m + 5, rows + 7), float("nan"), **kw)
            sl = (slice(1, 1 + 3 * f2.m), slice(4, 4 + rows))
            fn(*args, out=buf[sl], transpose=True, **flags)
            assert torch.equal(buf[sl], K.T) and _untouched(buf, *sl)
            assert torch.equal(fn(*args, transpose=True, **flags), K.T)
            n += 2
    assert kff.launches == {**dict.fromkeys(kff.launches, 0), base: n}


@pytest.mark.gpu
def test_rect_kernels_sorted_and_unsorted_agree_on_card(cuda):
    """Sorting a side's envs moves only the order of each point's sum:
    the blocks from sorted and unsorted operands agree to 2e-5."""
    rng = np.random.RandomState(7)
    kw = dict(device=cuda, dtype=torch.float32)
    f1 = pack_force(_ragged(rng, 13, 32, (13, 29, 79)), **kw)
    f2 = pack_force(_ragged(rng, 20, 33, (13, 29, 79)), **kw)
    out = []
    for sort in (True, False):
        X1, re1 = kff.force_operand(f1, sort=sort)
        X2, re2 = kff.force_operand(f2, sort=sort)
        out.append(kff.kff_from_ops(X1, re1, 32, X2, re2, 33, PARAMS, 2))
    _close(out[0], out[1])
    re1, re2 = (kff.force_operand(f, sort=True)[1] for f in (f1, f2))
    some, every = kff.staged_pairs(re1, 32, re2, 33)
    assert 0 < some < every


@pytest.mark.gpu
def test_rect_out_rejects_bad_views_on_card(cuda):
    rng = np.random.RandomState(8)
    kw = dict(device=cuda, dtype=torch.float32)
    f = pack_force(_ragged(rng, 5, 6, (13, 79)), **kw)
    X, re = kff.force_operand(f)
    args = (X, re, 6, X, re, 6, PARAMS, 2)
    good = torch.empty((15, 15), **kw)
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=good.T)
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=torch.empty((15, 14), **kw))
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=good.double())
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=good.cpu())
    # K1 (symmetric) takes out= and, for its dual pass, outd= too
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=good.T, symmetric=True)
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=torch.empty((15, 14), **kw),
                         symmetric=True)
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=good, outd=torch.empty_like(good),
                         symmetric=True)
    wide = torch.empty((15, 20), **kw)
    with pytest.raises(ValueError, match="leading dimension"):
        kff.kff_from_ops(*args, out=good, outd=wide[:, :15], symmetric=True,
                         dual=True)
    with pytest.raises(ValueError):
        kff.kff_from_ops(*args, out=good, outd=good.T, symmetric=True,
                         dual=True)
    assert kff.kff_from_ops(*args, out=good, symmetric=True) is good


# ---------------------------------------------------------------------------
# K1 in highest on rect_kernel (kff_tri, _dual, _deriv, _dot)
# ---------------------------------------------------------------------------

# (points, envs, elements): the slice's training side (ragged, a tile and
# a half) and the mid shape of chip_smoke.py (750 points of 32 envs, two
# elements at random)
K1_SHAPES = {"slice": (15, 13, (13, 79)), "mid": (750, 32, (13, 79))}


def _k1_side(cuda, shape, seed):
    n, envs, elements = K1_SHAPES[shape]
    rng = np.random.RandomState(seed)
    if shape == "slice":
        return pack_force(_ragged(rng, n, envs, elements), device=cuda,
                          dtype=torch.float32)
    from gpr_calculator_tpu_torch.ops.packing import ForceData
    f32 = torch.float32
    return ForceData(
        x=torch.as_tensor(rng.uniform(0.2, 1.0, (n, envs, 30)), dtype=f32,
                          device=cuda),
        dxdr=torch.as_tensor(rng.uniform(-1, 1, (n, envs, 30, 3)),
                             dtype=f32, device=cuda),
        ele=torch.as_tensor(rng.choice(elements, (n, envs)),
                            dtype=torch.int32, device=cuda), nreal=n)


@pytest.mark.gpu
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
@pytest.mark.parametrize("base", K1_BASES)
def test_k1_highest_matches_plain_on_card(cuda, base, shape, sort):
    """Each highest K1 kernel within 2e-5 max|plain| of its plain version
    on every plane, on operands sorted by element or not, at the slice
    and mid shapes; exactly symmetric; two runs bit-equal; out= (and outd=)
    write slices of NaN-filled buffers and nothing else."""
    f = _k1_side(cuda, shape, 80 + K1_BASES.index(base))
    X, re = kff.force_operand(f, sort=sort)
    B = f.x.shape[1]
    dot = base.endswith("_dot")
    p = {"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS
    flags = dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf")
    args = (X, re, B, X, re, B, p, 2)
    kff.reset_launches()
    K = kff.kff_from_ops(*args, symmetric=True, **flags)
    again = kff.kff_from_ops(*args, symmetric=True, **flags)
    P = kff.kff_plain(*args, symmetric=True, **flags)
    planes = (K, again, P) if flags["dual"] else ((K,), (again,), (P,))
    n = 3 * f.m
    bufs = [torch.full((n + 4, n + 9), float("nan"), device=cuda)
            for _ in planes[0]]
    sl = (slice(3, 3 + n), slice(5, 5 + n))
    views = [b[sl] for b in bufs]
    kff.kff_from_ops(*args, symmetric=True, out=views[0],
                     outd=views[-1] if flags["dual"] else None, **flags)
    torch.cuda.synchronize()
    for k, k2, pl, buf in zip(*planes, bufs):
        _close(k, pl)
        assert torch.equal(k, k.T) and torch.equal(k, k2)
        assert torch.equal(buf[sl], k) and _untouched(buf, *sl)
    assert kff.launches == {**dict.fromkeys(kff.launches, 0), base: 3}


@pytest.mark.gpu
@pytest.mark.parametrize("base", K1_BASES)
def test_k1_highest_sorted_and_unsorted_agree_on_card(cuda, base):
    """Sorting a side's envs by element moves only the order of each
    point pair's sum: K1 from sorted and from unsorted operands agree to
    2e-5 on every plane, and the sorted launch skips chunk pairs."""
    f = _k1_side(cuda, "mid", 90)
    dot = base.endswith("_dot")
    p = {"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS
    flags = dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf")
    out = []
    for sort in (True, False):
        X, re = kff.force_operand(f, sort=sort)
        K = kff.kff_from_ops(X, re, 32, X, re, 32, p, 2, symmetric=True,
                             **flags)
        out.append(K if flags["dual"] else (K,))
    for a, b in zip(*out):
        _close(a, b)
    re = kff.force_operand(f, sort=True)[1]
    some, every = kff.staged_pairs(re, 32, re, 32, triangle=True)
    assert 0 < some < every


@pytest.mark.gpu
@pytest.mark.parametrize("base", K1_BASES)
def test_k1_highest_tile_ranges_sum_to_single_launch_on_card(cuda, base):
    """At the mid shape on sorted operands (the skip engaged), four
    tile-range launches sum to the single launch bit for bit; a range
    written into a caller's view (out=, outd=) zeroes the rest of it."""
    from gpr_calculator_tpu_torch.parallel import partition_tri_tiles
    f = _k1_side(cuda, "mid", 91)
    X, re = kff.force_operand(f, sort=True)
    dot = base.endswith("_dot")
    p = {"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS
    flags = dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf")
    args = (X, re, 32, X, re, 32, p, 2)

    def planes(x):
        return x if isinstance(x, tuple) else (x,)
    single = planes(kff.kff_from_ops(*args, symmetric=True, **flags))
    total = [torch.zeros_like(s) for s in single]
    ranges = partition_tri_tiles(kff.n_tri_tiles(f.m), 4)
    for tiles in ranges:
        views = [torch.full_like(s, float("nan")) for s in single]
        part = planes(kff.kff_from_ops(
            *args, symmetric=True, tiles=tiles, out=views[0],
            outd=views[-1] if flags["dual"] else None, **flags))
        for acc, k, v in zip(total, part, views):
            assert k is v and not bool(torch.isnan(k).any())
            acc.add_(k)
    torch.cuda.synchronize()
    for acc, s in zip(total, single):
        assert torch.equal(acc, s)


@pytest.mark.gpu
def test_k1_tensor_map_is_never_reused_for_another_operand_on_card(cuda):
    """The highest K1 entry points read their operand through a tensor map
    of its k-major copy (X2), encoded once per (address, extents): a copy
    of another shape written at the same address gets a map of its own
    (the block is the new operand's), a misaligned copy or a re2 other
    than re1 is refused with an error code."""
    rng = np.random.RandomState(92)
    kw = dict(device=cuda, dtype=torch.float32)
    fA = pack_force(_ragged(rng, 29, 11, (13, 79)), **kw)
    fB = pack_force(_ragged(rng, 17, 14, (13, 29, 79)), **kw)
    fn = kff._lib()["kff_tri"]
    stream = torch.cuda.current_stream().cuda_stream
    buf = torch.zeros(kff.TROWS * 29 * 16 + 4, **kw)

    def launch(f, X2ptr, re2=None):
        X, re = kff.force_operand(f)
        m, B = f.m, f.x.shape[1]
        out = torch.full((3 * m, 3 * m), float("nan"), **kw)
        rc = fn(X.data_ptr(), re.data_ptr(), m, B, X2ptr(X, re, B),
                (re if re2 is None else re2).data_ptr(), m, B,
                out.data_ptr(), out.data_ptr(), PARAMS["sigma"] ** 2,
                1.0 / (2.0 * PARAMS["l"] ** 2), 2, 0,
                kff.n_tri_tiles(m), 3 * m, 0, stream)
        torch.cuda.synchronize()
        return rc, out, kff.kff_plain(X, re, B, X, re, B, PARAMS, 2,
                                      symmetric=True)

    def at_buf(X, re, B):
        Xt = kff.tri_operand(X, re, B).reshape(-1)
        buf[:Xt.numel()] = Xt
        return buf.data_ptr()
    for f in (fA, fB, fA):
        rc, out, plain = launch(f, at_buf)
        assert rc == 0
        _close(out, plain)
    rc, _, _ = launch(fA, lambda X, re, B: at_buf(X, re, B) + 4)
    assert rc != 0
    rc, _, _ = launch(fA, at_buf, re2=kff.force_operand(fA)[1].clone())
    assert rc != 0


# ---------------------------------------------------------------------------
# K1 kff_tri* in the bf16 modes (tri_mma_kernel)
# ---------------------------------------------------------------------------

MODE_K1 = [(b, m) for m in ("bf16x4", "bf16") for b in K1_BASES]


def _k1_flags(base):
    dot = base.endswith("_dot")
    return ({"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS,
            dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf"))


@pytest.mark.gpu
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "packed"])
@pytest.mark.parametrize("shape", list(K1_SHAPES))
@pytest.mark.parametrize("base,mode", MODE_K1)
def test_k1_mode_matches_plain_on_card(cuda, base, mode, shape, sort):
    """Each mode K1 kernel within 2e-5 max|plain| of its plain version on
    every plane, on the same rounded operands sorted by element or packed,
    at the slice and mid shapes; exactly symmetric; two runs bit-equal;
    out= (and outd=) write slices of NaN-filled buffers and nothing
    else."""
    f = _k1_side(cuda, shape, 100 + K1_BASES.index(base))
    X, re = kff.force_operand(f, mode, sort=sort)
    B = f.x.shape[1]
    p, flags = _k1_flags(base)
    args = (X, re, B, X, re, B, p, 2)
    kff.reset_launches()
    K = kff.kff_from_ops(*args, symmetric=True, mm_precision=mode, **flags)
    again = kff.kff_from_ops(*args, symmetric=True, mm_precision=mode,
                             **flags)
    P = kff.kff_plain(*args, symmetric=True, **flags)
    planes = (K, again, P) if flags["dual"] else ((K,), (again,), (P,))
    n = 3 * f.m
    bufs = [torch.full((n + 4, n + 9), float("nan"), device=cuda)
            for _ in planes[0]]
    sl = (slice(3, 3 + n), slice(5, 5 + n))
    views = [b[sl] for b in bufs]
    kff.kff_from_ops(*args, symmetric=True, mm_precision=mode, out=views[0],
                     outd=views[-1] if flags["dual"] else None, **flags)
    torch.cuda.synchronize()
    for k, k2, pl, buf in zip(*planes, bufs):
        _close(k, pl)
        assert torch.equal(k, k.T) and torch.equal(k, k2)
        assert torch.equal(buf[sl], k) and _untouched(buf, *sl)
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            kff.kernel_name(base, mode): 3}


@pytest.mark.gpu
@pytest.mark.parametrize("base,mode", MODE_K1)
def test_k1_mode_tile_ranges_sum_to_single_launch_on_card(cuda, base,
                                                          mode):
    """At the mid shape on sorted operands (the skip engaged), four
    tile-range launches of each mode K1 kernel, written into caller views,
    each within 2e-5 max|plain| of kff_plain(tiles=), sum to the single
    launch bit for bit; the sorted launch skips chunk pairs and warp
    products."""
    from gpr_calculator_tpu_torch.parallel import partition_tri_tiles
    f = _k1_side(cuda, "mid", 110 + K1_BASES.index(base))
    X, re = kff.force_operand(f, mode, sort=True)
    p, flags = _k1_flags(base)
    args = (X, re, 32, X, re, 32, p, 2)

    def planes(x):
        return x if isinstance(x, tuple) else (x,)
    single = planes(kff.kff_from_ops(*args, symmetric=True,
                                     mm_precision=mode, **flags))
    total = [torch.zeros_like(s) for s in single]
    for tiles in partition_tri_tiles(kff.n_tri_tiles(f.m), 4):
        views = [torch.full_like(s, float("nan")) for s in single]
        part = planes(kff.kff_from_ops(
            *args, symmetric=True, mm_precision=mode, tiles=tiles,
            out=views[0], outd=views[-1] if flags["dual"] else None,
            **flags))
        plain = planes(kff.kff_plain(*args, symmetric=True, tiles=tiles,
                                     **flags))
        for acc, k, v, pl in zip(total, part, views, plain):
            assert k is v and not bool(torch.isnan(k).any())
            _close(k, pl)
            acc.add_(k)
    torch.cuda.synchronize()
    for acc, s in zip(total, single):
        assert torch.equal(acc, s) and torch.equal(acc, acc.T)
    staged, pairs, mult, prods = kff.mma_pairs(re, 32, re, 32,
                                               triangle=True)
    assert 0 < staged < pairs and 0 < mult < prods


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16x4", "bf16"])
def test_k1_mode_entry_refuses_bad_arguments_on_card(cuda, mode):
    """The mode K1 entry points take one operand: an X2 or re2 other than
    X1 and re1, a transposed store, a misaligned operand or a tile range
    outside the triangle is refused with an error code, and nothing is
    launched."""
    rng = np.random.RandomState(120)
    f = pack_force(_ragged(rng, 17, 9, (13, 79)), device=cuda,
                   dtype=torch.float32)
    X, re = kff.force_operand(f, mode)
    m, B = f.m, f.x.shape[1]
    fn = kff._lib()[kff.kernel_name("kff_tri", mode)]
    out = torch.full((3 * m, 3 * m), float("nan"), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    nk = kff.n_tri_tiles(m)

    def launch(X1=X, X2=X, re2=re, k0=0, n=nk, trans=0, offset=0):
        return fn(X1.data_ptr() + offset, re.data_ptr(), m, B,
                  X2.data_ptr() + offset, re2.data_ptr(), m, B,
                  out.data_ptr(), out.data_ptr(), PARAMS["sigma"] ** 2,
                  1.0 / (2.0 * PARAMS["l"] ** 2), 2, k0, n, 3 * m, trans,
                  stream)
    for bad in (dict(X2=X.clone()), dict(re2=re.clone()), dict(trans=1),
                dict(offset=8), dict(k0=1), dict(n=0)):
        assert launch(**bad) != 0, bad
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).all())
    assert launch() == 0
    torch.cuda.synchronize()
    _close(out, kff.kff_plain(X, re, B, X, re, B, PARAMS, 2,
                              symmetric=True))


# ---------------------------------------------------------------------------
# K3 kff_rect* and K2 kef_rect* in the bf16 modes (rect_mma_kernel)
# ---------------------------------------------------------------------------

MODE_RECT = [(b, m) for m in ("bf16x4", "bf16") for b in RECT_BASES]


@pytest.mark.gpu
@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "packed"])
@pytest.mark.parametrize("case", range(len(RECT_CASES)))
@pytest.mark.parametrize("base,mode", MODE_RECT)
def test_mode_rect_kernels_match_plain_on_card(cuda, base, mode, case, sort):
    """Each mode K2/K3 kernel within 2e-5 max|plain| of its plain version
    on the same rounded operands, sorted by element or packed, at ragged
    point and env counts (K2's 32-point lhs tiles cut at 1, 7, 8, 9, 13 and
    100 points); two runs bit-equal; out= writes a slice of a NaN-filled
    buffer (K2 also transposed) and nothing else."""
    m1, B1, m2, B2, elements = RECT_CASES[case]
    zeta = 1 + case % 3
    rng = np.random.RandomState(200 + case)
    kw = dict(device=cuda, dtype=torch.float32)
    f2 = pack_force(_ragged(rng, m2, B2, elements), **kw)
    X2, re2 = kff.force_operand(f2, mode, sort=sort)
    dot = base.endswith("_dot")
    p = {"sigma": 1.3, "sigma0": 0.7} if dot else PARAMS
    flags = dict(dual=base.endswith("_dual"), deriv=base.endswith("_deriv"),
                 kind="dot" if dot else "rbf", mm_precision=mode)
    if base.startswith("kef"):
        e1 = pack_energy([(x, el) for x, _, el in
                          _ragged(rng, m1, B1, elements)], **kw)
        lhs = kff.energy_operand(e1, mode, sort=sort) + (e1.x.shape[1],)
        fn, plain, rows = kff.kef_from_ops, kff.kef_plain, e1.m
    else:
        f1 = pack_force(_ragged(rng, m1, B1, elements), **kw)
        lhs = kff.force_operand(f1, mode, sort=sort) + (f1.x.shape[1],)
        fn, plain, rows = kff.kff_from_ops, kff.kff_plain, 3 * f1.m
    args = lhs + (X2, re2, f2.x.shape[1], p, zeta)
    pflags = {k: v for k, v in flags.items() if k != "mm_precision"}
    kff.reset_launches()
    K, again = fn(*args, **flags), fn(*args, **flags)
    P = plain(*args, **pflags)
    torch.cuda.synchronize()
    planes = (K, again, P) if flags["dual"] else ((K,), (again,), (P,))
    for k, k2, pl in zip(*planes):
        assert k.shape == (rows, 3 * f2.m)
        _close(k, pl)
        assert torch.equal(k, k2)
    n = 2
    if not flags["dual"]:
        buf = torch.full((rows + 5, 3 * f2.m + 7), float("nan"), **kw)
        sl = (slice(2, 2 + rows), slice(3, 3 + 3 * f2.m))
        fn(*args, out=buf[sl], **flags)
        assert torch.equal(buf[sl], K) and _untouched(buf, *sl)
        n += 1
        if base.startswith("kef"):
            buf = torch.full((3 * f2.m + 5, rows + 7), float("nan"), **kw)
            sl = (slice(1, 1 + 3 * f2.m), slice(4, 4 + rows))
            fn(*args, out=buf[sl], transpose=True, **flags)
            assert torch.equal(buf[sl], K.T) and _untouched(buf, *sl)
            assert torch.equal(fn(*args, transpose=True, **flags), K.T)
            n += 2
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            kff.kernel_name(base, mode): n}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16x4", "bf16"])
def test_mode_rect_stripes_equal_single_launch_on_card(cuda, mode):
    """The K3 row stripes and the K2 energy-row stripes of the sharded
    builds (cut at 8-point tiles, across K2's 32-point lhs tiles) on four
    virtual shards of one card, concatenated, equal the single launch bit
    for bit, on sorted and packed operands."""
    from gpr_calculator_tpu_torch.parallel import make_mesh, sharded_kernels
    rng = np.random.RandomState(210)
    kw = dict(device=cuda, dtype=torch.float32)
    e = pack_energy([(x, el) for x, _, el in
                     _ragged(rng, 70, 13, (13, 29, 79))], **kw)
    f = pack_force(_ragged(rng, 29, 11, (13, 29, 79)), **kw)
    kw2 = dict(mm_precision=mode)
    mesh = make_mesh(4, ["cuda:0"] * 4)
    U, w = kff.energy_operand(e, mode)
    X, re = kff.force_operand(f, mode)
    for single, parts in (
            (kff.kff_from_ops(X, re, 11, X, re, 11, PARAMS, 2, **kw2),
             sharded_kernels.kff_sharded(f, PARAMS, mesh, 2, **kw2)),
            (kff.kef_from_ops(U, w, 13, X, re, 11, PARAMS, 2, **kw2),
             sharded_kernels.kef_sharded(e, f, PARAMS, mesh, 2, **kw2))):
        assert torch.equal(torch.cat([t.to(cuda) for t in parts]), single)
    for sort in (True, False):
        U, w = kff.energy_operand(e, mode, sort=sort)
        X, re = kff.force_operand(f, mode, sort=sort)
        ef = kff.kef_from_ops(U, w, 13, X, re, 11, PARAMS, 2, **kw2)
        ff = kff.kff_from_ops(X, re, 11, X, re, 11, PARAMS, 2, **kw2)
        for p0, p1 in sharded_kernels.partition_points(e.m, 4):
            part = kff.kef_from_ops(U[..., p0 * 13:p1 * 13, :].contiguous(),
                                    w[:, p0 * 13:p1 * 13].contiguous(), 13,
                                    X, re, 11, PARAMS, 2, **kw2)
            assert torch.equal(part, ef[p0:p1])
        for p0, p1 in sharded_kernels.partition_points(f.m, 4):
            part = kff.kff_from_ops(X[..., p0 * 11:p1 * 11, :].contiguous(),
                                    re[:, p0 * 11:p1 * 11].contiguous(), 11,
                                    X, re, 11, PARAMS, 2, **kw2)
            assert torch.equal(part, ff[3 * p0:3 * p1])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bf16x4", "bf16"])
def test_mode_rect_out_rejects_bad_views_on_card(cuda, mode):
    """The mode K2/K3 wrappers refuse an out= view that is transposed, of
    another shape, dtype or device, and a transposed K2 store into a view
    of the untransposed shape; a good view is filled and returned."""
    rng = np.random.RandomState(9)
    kw = dict(device=cuda, dtype=torch.float32)
    f = pack_force(_ragged(rng, 5, 6, (13, 79)), **kw)
    e = pack_energy([(x, el) for x, _, el in _ragged(rng, 3, 6, (13, 79))],
                    **kw)
    X, re = kff.force_operand(f, mode)
    U, w = kff.energy_operand(e, mode)
    args = (X, re, 6, X, re, 6, PARAMS, 2)
    eargs = (U, w, 6, X, re, 6, PARAMS, 2)
    good = torch.empty((15, 15), **kw)
    for bad in (good.T, torch.empty((15, 14), **kw), good.double(),
                good.cpu()):
        with pytest.raises(ValueError):
            kff.kff_from_ops(*args, out=bad, mm_precision=mode)
    ef = torch.empty((3, 15), **kw)
    for bad, tr in ((ef, True), (ef.T.contiguous(), False),
                    (torch.empty((15, 3), **kw).T, False)):
        with pytest.raises(ValueError):
            kff.kef_from_ops(*eargs, out=bad, transpose=tr,
                             mm_precision=mode)
    with pytest.raises(ValueError, match="transpose"):
        kff.kef_from_ops(*eargs, dual=True, transpose=True,
                         mm_precision=mode)
    assert kff.kff_from_ops(*args, out=good, mm_precision=mode) is good
    fe = torch.empty((15, 3), **kw)
    assert kff.kef_from_ops(*eargs, out=fe, transpose=True,
                            mm_precision=mode) is fe
    torch.cuda.synchronize()
    assert not bool(torch.isnan(good).any() or torch.isnan(fe).any())
