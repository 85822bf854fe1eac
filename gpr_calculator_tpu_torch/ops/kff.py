r"""K_FF / K_EF covariance blocks: operand builders, hand-written CUDA
kernels (the sources of ``csrc/``) and their plain PyTorch versions.

Port of the JAX package's ``ops/kff_pallas.py``.  Each block side is
first turned into matmul operands (``force_operand``/``energy_operand``):

    u  = x / |x|,   Jt_u = J_u - (J_u . u) u    (per environment)
    X  = [u; Jt_x; Jt_y; Jt_z]                  (4, N, DP), DP = 32
    re = [rinv, element id]                      (2, N)

which reduces the reference's force-force formula (rbf_kernel.cpp:342-473)
to c = u1.u2, p1_u = Jt1_u.u2, p2_v = u1.Jt2_v, m_uv = Jt1_u.Jt2_v and

    K_FF[(p,u),(q,v)] = sum_{a in p, b in q} A(c) m_uv + B(c) p1_u p2_v
    K_EF[p,(q,v)]     = sum_{a in p, b in q} A0(c) w_a rinv_b p2_v

with the coefficients of ``_coeffs`` for the kernel family ``kind``:

    rbf: k = s2 exp((c^z - 1) g),  A = k g z c^(z-1),
         B = k g (z(z-1) c^(z-2) + (z c^(z-1))^2 g),  A0 = -A
    dot: k = s2 (c^z + s0^2),      A = s2 z c^(z-1),
         B = s2 z(z-1) c^(z-2),                      A0 = -A

(gamma = 1 / (2 l^2)).  The Dot force blocks carry no exp, and sigma0
enters K_EE alone, through the additive constant s2 s0^2.  Padding and
|x| < EPS carry rinv = 0 (w = 0 on the energy side).  ``dual=True``
(RBF only, as in the JAX package) adds the same sums with the d/dgamma
coefficients, so one pass gives (K, dK/dgamma) for the analytic NLL
gradient; ``deriv=True`` (RBF only) gives dK/dgamma alone.  Every block
of one training covariance must consume the SAME operand tensors (PSD
contract, kff_pallas.py:448-459): build once, pass everywhere.

Matmul precision (``mm_precision``, default ``config.kff_precision()``;
the JAX package's ``_lhs_rhs``, kff_pallas.py:394-436).  For float32
data the operand rows are rounded once, before lane padding:

    highest  X itself, float32 (4, N, DP)
    bf16x4   bf16 parts (2, 4, N, DP): hi = the top 16 bits of X (an
             integer mask, exactly bf16), lo = bf16(X - hi), rounded to
             nearest even
    bf16     bf16 parts (1, 4, N, DP): bf16(X)

The parts tensor is the one operand object of its side: the kernels read
the bf16 parts and form hi.hi + hi.lo + lo.hi + lo.lo themselves (bf16
tensor-core products, float32 sums), while the plain versions and K_EE
read the recombined value ``dense(X)`` = hi + lo, which float32 holds
exactly, or bf16(X).  Every block is then the exact Gram of the same
rounded rows, and the covariance stays PSD by construction.  Float64
data ignores the mode.

Env order.  ``force_operand`` and ``energy_operand`` sort each point's
envs by element (a stable ``torch.argsort``), the envs without weight
(padding, |x| < EPS) last (``sort=True``; ``sort=False`` keeps the packed
order; the default sorts sides of ``SORT_MIN_ENVS`` envs or more).  A
block is a sum over a point's envs, so the order moves only the order of
that sum; every kernel (K1, K2, K3, in each mode) skips the env chunks
whose element ranges cannot meet, which a sorted side makes frequent.
Every kernel and plain version stays correct for any order.

Routes.  ``kff_from_ops`` and ``kef_from_ops`` take the plain version for
tensors on the CPU (any float dtype) and launch the CUDA kernels for
float32 or bf16-parts operands, or float64 operands, on a CUDA device;
anything else on CUDA (float16, float32 mixed with float64) raises.  The
kernels (K1 ``kff_tri``, K2 ``kef_rect``, K3 ``kff_rect`` with the
suffixes ``_dual``, ``_deriv`` (K1-K3; K3 also ``_dual``) and ``_dot``,
each also with ``_bf16x4`` and ``_bf16`` for the modes, and with
``_f64`` for float64 operands, which write float64 and ignore the mode:
the JAX package's default x64 mode) are built with nvcc at first use --
every ``csrc/*.cu`` compiled on its own, all at once, and linked into one
library -- into the package's git-ignored ``build/`` directory and bound
with ctypes.  ``launches`` counts each kernel launch, ``plain_calls``
each call of ``kff_plain`` / ``kef_plain``.
The ``highest`` K1 kernels read their operand through a tensor map of its
k-major copy (``tri_operand``, ~49 MB at 3000 points of 32 envs), which
the wrapper builds once per operand tensor and keeps on it.
``out=`` (and ``outd=``, the dK/dgamma plane of a dual pass) writes the
block into a caller's 2-D view (float32, or float64 for float64
operands) with unit column stride -- a slice of a larger buffer -- and
``transpose=True`` (K2, in every mode) stores
K_EF transposed there: the served block of ``ops/kernels.k_block`` and
the training covariance of ``k_self`` / ``k_self_dual`` are built in one
buffer this way.

The tile-range form of K1 (``tiles=(k0, nk)`` on ``kff_from_ops`` and
``kff_plain``): the symmetric K_FF is cut into TP x TP-point tiles, its
upper-triangle tiles (I <= J) numbered k = J (J + 1) / 2 + I, and a
range launch computes tiles [k0, k0 + nk) and their transposes into a
zeroed output.  Every element belongs to exactly one tile of the upper
triangle or its transpose, so ranges that partition the tiles sum to the
whole K_FF exactly (the mesh-sharded build of ``parallel/``, which
replaces the ``cells=``/``owned=`` form of the Pallas kernel,
kff_pallas.py:592-596, :703-711).  Range launches are counted under
names of their own (``kff_tri_range``, ``kff_tri_dual_range_bf16x4``,
``kff_tri_range_f64``, ...).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import config
from ..native import BUILD_DIR

DP = 32                  # padded descriptor width of the operand rows
_PAIR_BUDGET = 2 ** 24   # env pairs per chunk of the plain versions
CSRC = Path(__file__).resolve().parents[1] / "csrc"
TP = 8                   # points per tile side (csrc/kff_common.cuh)
CB = 4                   # envs per point in a K_FF chunk (csrc/kff_common.cuh)
# lhs points per tile of the mode K2 kernels (csrc/kff_rect_mma.cu: 8
# groups of 4 energy points); the mode K3 kernels take TP
TP_EF_MMA = 32
TROWS = 4 * DP + 2       # rows of the k-major copy K1 reads (tri_operand)
_MAX_POINTS = 65535 * TP  # grid.y limit at TP points per tile
_HI_MASK = -65536        # 0xFFFF0000 as int32: sign, exponent, 7 bits
# sides of this many envs are sorted by element.  On an NVIDIA H100 80GB
# HBM3 (700.00 W) sorting a side adds up to 0.6 ms to its build (host
# clock); one kff_rect launch between two sorted sides of 8192 envs saves
# 0.44 ms, of 4096 envs 0.09 ms, of 24000 envs 3.5 ms (chip_smoke.py (g))
SORT_MIN_ENVS = 8192

KINDS = ("rbf", "dot", "rbf_dgamma")
# kernel base names: K1 kff_tri, K2 kef_rect, K3 kff_rect and variants
BASES = ("kff_tri", "kff_tri_dual", "kff_tri_deriv", "kff_tri_dot",
         "kef_rect", "kef_rect_dual", "kef_rect_deriv", "kef_rect_dot",
         "kff_rect", "kff_rect_dual", "kff_rect_deriv", "kff_rect_dot")
# launch-counter names of the tile-range form of the K1 kernels
RANGE_BASES = tuple(b + "_range" for b in BASES if b.startswith("kff_tri"))
# the kernel set of float64 operands (the suffix of its names); it is no
# matmul precision: float64 operands ignore the configured one
F64 = "f64"
# every kernel set of the library: the matmul precisions of float32
# operands, then float64
KERNEL_MODES = config.PRECISIONS + (F64,)


def kernel_name(base: str, mode: str) -> str:
    """Launch-counter (and entry-point) name of ``base`` in ``mode`` (a
    matmul precision, or ``F64``)."""
    return base if mode == "highest" else f"{base}_{mode}"


# the library's entry points, and kernel name -> launches since the last
# reset_launches() (a range launch counts under its ``_range`` name only)
_ENTRIES = tuple(kernel_name(b, m) for m in KERNEL_MODES for b in BASES)
launches = {kernel_name(b, m): 0 for m in KERNEL_MODES
            for b in BASES + RANGE_BASES}
# calls of the plain versions K_FF / K_EF since the last reset_launches():
# a path on the card that counts none ran its blocks through the kernels
plain_calls = {"kff_plain": 0, "kef_plain": 0}


def reset_launches() -> None:
    for counts in (launches, plain_calls):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def _pad_lanes(a: torch.Tensor) -> torch.Tensor:
    d = a.shape[-1]
    width = -(-d // DP) * DP
    if width == d:
        return a.contiguous()
    return torch.nn.functional.pad(a, (0, width - d)).contiguous()


def split(x: torch.Tensor, mode: str) -> torch.Tensor:
    """bf16 parts (P, *x.shape) of float32 ``x`` in ``mode`` ("bf16x4":
    [hi, lo], "bf16": [bf16(x)]), bit for bit the JAX ``_lhs_rhs``.  hi
    masks the low 16 bits of the int32 view (no dtype round trip, which
    a compiler may fold away: kff_pallas.py:407-416)."""
    if mode == "bf16":
        return x.to(torch.bfloat16)[None]
    hi = (x.view(torch.int32) & _HI_MASK).view(torch.float32)
    return torch.stack([hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)])


def dense(X: torch.Tensor) -> torch.Tensor:
    """The float values an operand stands for: bf16 parts recombined
    (hi + lo, exact in float32), any other operand as it is."""
    if X.dtype != torch.bfloat16:
        return X
    return X.float().sum(0)


def operand_precision(X: torch.Tensor) -> str:
    """The mode an operand was built in ("highest" for float operands)."""
    if X.dtype != torch.bfloat16:
        return "highest"
    return "bf16x4" if X.shape[0] == 2 else "bf16"


def _rounded(X: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "highest" or X.dtype != torch.float32:
        return X
    return split(X.contiguous(), mode)


def _env_order(ele, valid):
    """Per-point env order (m, B): by element, envs without weight last,
    equal keys in their packed order."""
    last = torch.iinfo(ele.dtype).max
    key = torch.where(valid, ele, torch.full_like(ele, last))
    return torch.argsort(key, dim=1, stable=True)


def _sorts(sort, m: int, B: int) -> bool:
    """sort=None: sides of at least SORT_MIN_ENVS envs are sorted -- where
    one launch saves what a side's sort costs; a served request's few
    points are not (its block is one short chain of chunk pairs)."""
    return m * B >= SORT_MIN_ENVS if sort is None else bool(sort)


def force_operands(f, mm_precision: str | None = None,
                   sort: bool | None = None):
    """(Xs, re (2, N)) for a ForceData side, N = m * B: one operand X_g =
    [u; Jt of columns 3g..3g+2] a group of three cartesian columns of
    f.dxdr -- one group for a force point, three (the forces, then the
    strain rows xx, yy, zz and xy, xz, yz) for the 9 columns of a stress
    request -- each (4, N, DP) in the data's dtype, or its bf16 parts
    (P, 4, N, DP) for float32 data in a bf16 mode.  K_FF and K_EF are
    linear in a side's Jt rows, so each group is a side of its own for
    the kernels.  sort: each point's envs ordered by element, padding
    last, alike in every group (see the module docstring); None sorts
    sides of SORT_MIN_ENVS envs or more."""
    mode = config.kff_precision(mm_precision)
    m, B, d = f.x.shape
    x, J, ele = f.x, f.dxdr, f.ele
    ncart = J.shape[3]
    if ncart % 3:
        raise ValueError(f"{ncart} cartesian columns are not whole groups "
                         "of three")
    n = torch.sqrt(torch.sum(x * x, dim=2))
    valid = (n > config.EPS) & (ele > 0)
    if _sorts(sort, m, B):
        order = _env_order(ele, valid)
        x = torch.take_along_dim(x, order[:, :, None], 1)
        J = torch.take_along_dim(J, order[:, :, None, None], 1)
        ele, n, valid = (torch.gather(t, 1, order) for t in (ele, n, valid))
    x, J = x.reshape(m * B, d), J.reshape(m * B, d, ncart)
    ele, n, valid = ele.reshape(-1), n.reshape(-1), valid.reshape(-1)
    nsafe = torch.where(valid, n, torch.ones_like(n))
    u = x / nsafe[:, None]
    rinv = torch.where(valid, 1.0 / nsafe, torch.zeros_like(n))
    q = torch.einsum("ndu,nd->nu", J, u)
    Jt = J - u[:, :, None] * q[:, None, :]
    X = torch.cat([u[None], Jt.permute(2, 0, 1)], dim=0)  # (1 + ncart, N, d)
    groups = [X] if ncart == 3 else [
        X[[0, 1 + c, 2 + c, 3 + c]] for c in range(0, ncart, 3)]
    re = torch.stack([rinv, ele.to(x.dtype)])
    return ([_pad_lanes(_rounded(Xg, mode)) for Xg in groups],
            re.contiguous())


def force_operand(f, mm_precision: str | None = None,
                  sort: bool | None = None):
    """(X, re (2, N)) for a ForceData side of three cartesian columns, N
    = m * B: X (4, N, DP) in the data's dtype, or its bf16 parts (P, 4,
    N, DP) for float32 data in a bf16 mode (``force_operands``; a side
    with strain rows has one operand per group of three columns)."""
    Xs, re = force_operands(f, mm_precision, sort)
    if len(Xs) != 1:
        raise ValueError(f"a side of {f.ncart} cartesian columns has "
                         f"{len(Xs)} operands: use force_operands")
    return Xs[0], re


def energy_operand(e, mm_precision: str | None = None,
                   sort: bool | None = None):
    """(U (N, DP), w (2, N)) for an EnergyData side: unit descriptors (or
    their bf16 parts (P, N, DP), as in ``force_operand``) and [valid /
    count, element id], N = m * A; envs sorted as in ``force_operand``."""
    mode = config.kff_precision(mm_precision)
    m, A, d = e.x.shape
    x, ele = e.x, e.ele
    n = torch.sqrt(torch.sum(x * x, dim=2))
    valid = (n > config.EPS) & (ele > 0)
    if _sorts(sort, m, A):
        order = _env_order(ele, valid)
        x = torch.take_along_dim(x, order[:, :, None], 1)
        ele, n, valid = (torch.gather(t, 1, order) for t in (ele, n, valid))
    x = x.reshape(m * A, d)
    ele, n, valid = ele.reshape(-1), n.reshape(-1), valid.reshape(-1)
    u = x / torch.where(valid, n, torch.ones_like(n))[:, None]
    inv_count = torch.repeat_interleave(1.0 / e.counts, A)
    w = torch.stack([torch.where(valid, inv_count, torch.zeros_like(n)),
                     ele.to(x.dtype)])
    return _pad_lanes(_rounded(u, mode)), w.contiguous()


def tri_operand(X, re, B: int):
    """The k-major copy of a force operand that the ``highest`` K1 kernels
    read through a tensor map: (TROWS, m, Bp) float32 -- rows c DP + k hold
    X[c, p B + e, k] of point p, env e; the last two rows the weight and
    the element -- with Bp = B rounded up to the CB envs of a chunk and
    the envs past B zero.  One box of it (CB envs x TP points x TROWS rows)
    is one side's chunk in the kernel's shared-memory layout."""
    m = X.shape[1] // B
    rows = torch.cat([
        X.reshape(4, m, B, DP).permute(0, 3, 1, 2).reshape(4 * DP, m, B),
        re.reshape(2, m, B).to(X.dtype)])
    return torch.nn.functional.pad(rows, (0, -(-B // CB) * CB - B))


def _tri_copy(X, re, B: int):
    """``tri_operand`` of (X, re), built once per operand: kept on X while
    X, re and B stay the ones it was built from."""
    key = (X._version, re.data_ptr(), re._version, B)
    kept = getattr(X, "_kff_tri", None)
    if kept is None or kept[0] != key:
        kept = (key, tri_operand(X, re, B).contiguous())
        X._kff_tri = kept
    return kept[1]


def chunk_ranges(re, B: int, points: int, envs: int):
    """The element range [lo, hi] of the envs with a weight in every env
    chunk the kernels stage: (tiles, chunks, 2) for tiles of ``points``
    points and chunks of ``envs`` envs per point (K1, K3 and the rhs of
    K2: 8 and 4; the lhs of K2: 8 and 8, in the modes 32 and 4); (+inf,
    -inf) for a chunk of padding alone.  The kernels compute the same
    per block; this is their arithmetic in PyTorch, for tests and for
    counting what a launch skips."""
    m = re.shape[1] // B
    nt, nc = -(-m // points), -(-B // envs)
    w = re.new_zeros((nt * points, nc * envs))
    el = re.new_zeros((nt * points, nc * envs))
    w[:m, :B], el[:m, :B] = re[0].reshape(m, B), re[1].reshape(m, B)
    w = w.reshape(nt, points, nc, envs).permute(0, 2, 1, 3).reshape(nt, nc,
                                                                    -1)
    el = el.reshape(nt, points, nc, envs).permute(0, 2, 1, 3).reshape(nt, nc,
                                                                      -1)
    inf = torch.full_like(el, float("inf"))
    lo = torch.where(w != 0, el, inf).amin(dim=2)
    hi = torch.where(w != 0, el, -inf).amax(dim=2)
    return torch.stack([lo, hi], dim=2)


def _grid(c1, c2, triangle: bool):
    """(lhs tile x chunk, rhs tile x chunk) bool: the chunk pairs of a
    launch's grid, from the chunk ranges of its two sides -- every one,
    or (``triangle``, K1) those of the upper-triangle tile pairs I <= J."""
    t1, t2 = (torch.arange(c.shape[0], device=c.device)
              .repeat_interleave(c.shape[1]) for c in (c1, c2))
    return (t1[:, None] <= t2[None, :]) | (not triangle)


def staged_pairs(re1, B1: int, re2, B2: int, energy_lhs: bool = False,
                 per_lhs_point: bool = False, triangle: bool = False):
    """(chunk pairs a launch of a ``highest`` kernel on rect_kernel stages,
    all chunk pairs of its grid): a pair is staged when the element ranges
    of its two chunks intersect.  per_lhs_point counts instead the (lhs
    point, chunk pair) products a warp multiplies: inside a staged pair a
    warp skips when its own lhs point's envs cannot meet the rhs chunk.
    triangle: a K1 launch over one operand (re2 is re1), whose grid holds
    the upper-triangle tile pairs I <= J alone."""
    envs1 = 8 if energy_lhs else 4
    c1 = chunk_ranges(re1, B1, TP, envs1)                # (tiles, chunks, 2)
    c2 = chunk_ranges(re2, B2, TP, 4)
    r1, r2 = c1.reshape(-1, 2)[:, None, :], c2.reshape(-1, 2)[None, :, :]
    meet = ~((r1[..., 1] < r2[..., 0]) | (r2[..., 1] < r1[..., 0]))
    grid = _grid(c1, c2, triangle)
    meet = meet & grid
    if not per_lhs_point:
        return int(meet.sum()), int(grid.sum())
    m1 = re1.shape[1] // B1
    p1 = chunk_ranges(re1, B1, 1, envs1)                 # (m1, chunks, 2)
    pad = p1.new_empty((-(-m1 // TP) * TP - m1, p1.shape[1], 2))
    pad[..., 0], pad[..., 1] = float("inf"), -float("inf")
    p1 = torch.cat([p1, pad]).reshape(-1, TP, p1.shape[1], 2)
    p1 = p1.permute(0, 2, 1, 3).reshape(-1, TP, 2)       # (tile*chunk, TP, 2)
    r2 = r2[0]
    mine = ~((p1[:, :, None, 1] < r2[None, None, :, 0])
             | (r2[None, None, :, 1] < p1[:, :, None, 0]))
    return int((mine & meet[:, None, :]).sum()), TP * int(grid.sum())


def _held(re, B: int, group: int, tile: int, elements):
    """(tiles, chunks, tile / group, len(elements)) bool: the elements that
    the envs with a weight hold in each group of ``group`` points x CB envs
    of every chunk, for tiles of ``tile`` points."""
    m = re.shape[1] // B
    nt, nc = -(-m // tile), -(-B // CB)
    w = re.new_zeros((nt * tile, nc * CB))
    el = re.new_zeros((nt * tile, nc * CB))
    w[:m, :B], el[:m, :B] = re[0].reshape(m, B), re[1].reshape(m, B)
    has = (w != 0)[..., None] & (el[..., None] == elements)
    has = has.reshape(nt, tile // group, group, nc, CB, -1).any(4).any(2)
    return has.permute(0, 2, 1, 3)


def mma_pairs(re1, B1: int, re2, B2: int, energy_lhs: bool = False,
              triangle: bool = False):
    """What a launch of a mode K3 (or, ``energy_lhs``, K2) kernel on
    rect_mma_kernel stages and multiplies: (chunk pairs staged, all chunk
    pairs of its grid, warp products multiplied, all warp products).  Its
    chunks are CB envs of TP lhs points (K2: TP_EF_MMA energy points) and
    of TP rhs points; a chunk pair is staged when its element ranges
    intersect.  Inside it a warp multiplies one lhs group (4 points x CB
    envs) by each of its n-tiles (2 rhs points x CB envs), and skips a
    product in which no env pair carries a weight and shares an element
    (the lanes' vote).  triangle: a mode K1 launch on tri_mma_kernel over
    one operand (re2 is re1), whose grid holds the upper-triangle tile
    pairs I <= J alone."""
    tile1 = TP_EF_MMA if energy_lhs else TP
    c1 = chunk_ranges(re1, B1, tile1, CB)
    c2 = chunk_ranges(re2, B2, TP, CB)
    r1, r2 = c1.reshape(-1, 2)[:, None, :], c2.reshape(-1, 2)[None, :, :]
    meet = ~((r1[..., 1] < r2[..., 0]) | (r2[..., 1] < r1[..., 0]))
    grid = _grid(c1, c2, triangle)
    meet = meet & grid
    elements = torch.unique(torch.cat([re1[1][re1[0] != 0],
                                       re2[1][re2[0] != 0]]))
    h1 = _held(re1, B1, 4, tile1, elements)
    h2 = _held(re2, B2, 2, TP, elements)
    g1, g2, n = h1.shape[2], h2.shape[2], len(elements)
    hit = (h1.reshape(-1, n).float() @ h2.reshape(-1, n).float().T) > 0
    hit = hit.reshape(meet.shape[0], g1, meet.shape[1], g2) \
        & meet[:, None, :, None]
    pairs = int(grid.sum())
    return int(meet.sum()), pairs, int(hit.sum()), pairs * g1 * g2


def _family(kind: str, deriv: bool):
    """kind="rbf_dgamma" (the JAX ops/kernels.py kind) is RBF with
    deriv=True."""
    if kind == "rbf_dgamma":
        return "rbf", True
    return kind, deriv


def _scalars(params, kind: str = "rbf", dual: bool = False,
             deriv: bool = False):
    """(sigma^2, gamma = 1 / (2 l^2)) for RBF and rbf_dgamma, (sigma^2,
    sigma0^2) for Dot.  Tensor hyperparameters pass through, so the plain
    versions can be differentiated by autograd.  Every block function
    reads its scalars here first, so an unknown kind, a Dot dual or
    deriv pass, or dual with deriv raises before any work (the JAX
    assertions, kff_pallas.py:557-559 and 864-866)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if dual and (deriv or kind == "rbf_dgamma"):
        raise ValueError("dual already includes the deriv set")
    if (dual or deriv) and kind == "dot":
        raise NotImplementedError(
            "the Dot kernel has no dual pass (its sigma0 derivative is "
            "count_ee, ops/kernels.py)")
    second = params["sigma0" if kind == "dot" else "l"]
    sigma = params["sigma"]
    sigma = sigma if torch.is_tensor(sigma) else float(sigma)
    second = second if torch.is_tensor(second) else float(second)
    if kind == "dot":
        return sigma * sigma, second * second
    return sigma * sigma, 1.0 / (2.0 * second * second)


def _coeffs(c, sigma2, p2, zeta: int, kind: str = "rbf",
            dual: bool = False):
    """Per-pair scalars (k, A, B, A0) of the kernel family; p2 is the
    second scalar of ``_scalars``.  RBF: k = s2 exp((c^z - 1) g),
    A = k g z c^(z-1), B = k g (z(z-1) c^(z-2) + (z c^(z-1))^2 g).
    Dot: k = s2 (c^z + s0^2), A = s2 z c^(z-1), B = s2 z(z-1) c^(z-2).
    A0 = -A for both.  dual=True (RBF) also returns their d/dg,
    (k (D-1), A (D-1) + k z c^(z-1),
    B (D-1) + k (z(z-1) c^(z-2) + 2 (z c^(z-1))^2 g), -dA), D = c^z
    (kff_pallas.py:189-206, 780-791)."""
    if kind not in ("rbf", "dot"):
        raise ValueError(f"no coefficients for kernel kind {kind!r}")
    if zeta == 1:
        d1 = torch.ones_like(c)
        dm2 = torch.zeros_like(c)
    elif zeta == 2:
        d1 = c
        dm2 = torch.ones_like(c)
    else:
        dm2 = c
        for _ in range(zeta - 3):
            dm2 = dm2 * c
        d1 = dm2 * c
    D = d1 * c
    zd1 = zeta * d1
    b0 = zeta * (zeta - 1) * dm2
    if kind == "dot":
        A = sigma2 * zd1
        return sigma2 * (D + p2), A, sigma2 * b0, -A
    gamma = p2
    k = sigma2 * torch.exp((D - 1.0) * gamma)
    kg = k * gamma
    A = kg * zd1
    B = kg * (b0 + zd1 * zd1 * gamma)
    if not dual:
        return k, A, B, -A
    Dm1 = D - 1.0
    dA = A * Dm1 + k * zd1
    dB = B * Dm1 + k * (b0 + 2.0 * zd1 * zd1 * gamma)
    return (k, A, B, -A), (k * Dm1, dA, dB, -dA)


def _sets(c, sigma2, p2, zeta: int, kind: str, dual: bool, deriv: bool):
    """The coefficient sets of one pass: [K], [K, dK/dgamma] (dual) or
    [dK/dgamma] (deriv)."""
    if dual:
        return list(_coeffs(c, sigma2, p2, zeta, kind, dual=True))
    if deriv:
        return [_coeffs(c, sigma2, p2, zeta, kind, dual=True)[1]]
    return [_coeffs(c, sigma2, p2, zeta, kind)]


def _mirror(K):
    """Exactly symmetric K from its upper triangle."""
    return torch.triu(K) + torch.triu(K, 1).T


def _point_sum(env, b1: int, b2: int):
    """(n1, n2) env-pair plane -> (n1 / b1, n2 / b2) point sums."""
    n1, n2 = env.shape
    return env.reshape(n1 // b1, b1, n2).sum(1).reshape(
        n1 // b1, n2 // b2, b2).sum(2)


def _chunk_points(b1: int, n2: int) -> int:
    return max(1, _PAIR_BUDGET // max(b1 * n2, 1))


def n_tri_tiles(m: int) -> int:
    """Upper-triangle tiles of the symmetric K_FF over ``m`` points."""
    nt = -(-m // TP)
    return nt * (nt + 1) // 2


def _check_tiles(tiles, m: int):
    k0, nk = (int(t) for t in tiles)
    if k0 < 0 or nk < 0 or k0 + nk > n_tri_tiles(m):
        raise ValueError(f"tile range ({k0}, {nk}) outside the "
                         f"{n_tri_tiles(m)} upper-triangle tiles of {m} "
                         "points")
    return k0, nk


def tile_mask(m: int, tiles, device=None):
    """(3 m, 3 m) bool: the elements of the symmetric K_FF that tiles
    [k0, k0 + nk) of the upper triangle and their transposes cover."""
    k0, nk = _check_tiles(tiles, m)
    nt = -(-m // TP)
    J = torch.arange(nt, device=device)
    k = J[None, :] * (J[None, :] + 1) // 2 + J[:, None]       # k[I, J]
    own = (J[:, None] <= J[None, :]) & (k >= k0) & (k < k0 + nk)
    own = own | own.T
    rows = torch.arange(3 * m, device=device) // (3 * TP)
    return own[rows][:, rows]


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU route, and the reference for the kernels)
# ---------------------------------------------------------------------------

def kff_plain(X1, re1, B1: int, X2, re2, B2: int, params, zeta: int,
              symmetric: bool = False, dual: bool = False,
              kind: str = "rbf", deriv: bool = False, tiles=None):
    """K_FF (3 m1, 3 m2) from operands (in any mode: the rounded values,
    ``dense``); dual=True returns (K, dK/dgamma) from one pass,
    deriv=True dK/dgamma alone.  symmetric=True (X1 is X2) computes the
    row stripes' upper part only and mirrors the strict upper triangle,
    so the result is exactly symmetric.  tiles=(k0, nk) (symmetric only)
    is the plain version of the tile-range launch: the same matrix with
    everything outside those upper-triangle tiles and their transposes
    set to zero."""
    kind, deriv = _family(kind, deriv)
    sigma2, p2 = _scalars(params, kind, dual, deriv)
    if tiles is not None and not symmetric:
        raise ValueError("a tile range needs symmetric=True")
    plain_calls["kff_plain"] += 1
    X1, X2 = dense(X1), dense(X2)
    m1, m2 = X1.shape[1] // B1, X2.shape[1] // B2
    outs = [X1.new_zeros((m1, 3, m2, 3)) for _ in range(1 + dual)]
    pc = _chunk_points(B1, X2.shape[1])
    for p0 in range(0, m1, pc):
        p1 = min(m1, p0 + pc)
        q0 = p0 if symmetric else 0
        L = X1[:, p0 * B1:p1 * B1]
        R = X2[:, q0 * B2:]
        G = torch.einsum("ind,jmd->ijnm", L, R)            # (4, 4, n, m)
        rl, rr = re1[:, p0 * B1:p1 * B1], re2[:, q0 * B2:]
        w = (rl[0][:, None] * rr[0][None, :]
             * (rl[1][:, None] == rr[1][None, :]))
        for out, (_, A, B, _) in zip(
                outs, _sets(G[0, 0], sigma2, p2, zeta, kind, dual, deriv)):
            A, B = A * w, B * w
            for u in range(3):
                Bp1 = B * G[1 + u, 0]
                for v in range(3):
                    env = A * G[1 + u, 1 + v] + Bp1 * G[0, 1 + v]
                    out[p0:p1, u, q0:, v] = _point_sum(env, B1, B2)
    outs = [o.reshape(3 * m1, 3 * m2) for o in outs]
    if symmetric:
        outs = [_mirror(o) for o in outs]
    if tiles is not None:
        own = tile_mask(m1, tiles, X1.device)
        outs = [torch.where(own, o, torch.zeros_like(o)) for o in outs]
    return tuple(outs) if dual else outs[0]


def kef_plain(U1, w1, A1: int, X2, re2, B2: int, params, zeta: int,
              dual: bool = False, kind: str = "rbf", deriv: bool = False):
    """K_EF (m1, 3 m2) from operands; dual=True returns (K, dK/dgamma),
    deriv=True dK/dgamma alone."""
    kind, deriv = _family(kind, deriv)
    sigma2, p2 = _scalars(params, kind, dual, deriv)
    plain_calls["kef_plain"] += 1
    U1, X2 = dense(U1), dense(X2)
    m1, m2 = U1.shape[0] // A1, X2.shape[1] // B2
    outs = [U1.new_zeros((m1, m2, 3)) for _ in range(1 + dual)]
    pc = _chunk_points(A1, X2.shape[1])
    for p0 in range(0, m1, pc):
        p1 = min(m1, p0 + pc)
        L = U1[p0 * A1:p1 * A1]
        G = torch.einsum("nd,jmd->jnm", L, X2)             # (4, n, m)
        wl = w1[:, p0 * A1:p1 * A1]
        w = (wl[0][:, None] * re2[0][None, :]
             * (wl[1][:, None] == re2[1][None, :]))
        for out, (_, _, _, A0) in zip(
                outs, _sets(G[0], sigma2, p2, zeta, kind, dual, deriv)):
            A0 = A0 * w
            for v in range(3):
                out[p0:p1, :, v] = _point_sum(A0 * G[1 + v], A1, B2)
    outs = [o.reshape(m1, 3 * m2) for o in outs]
    return tuple(outs) if dual else outs[0]


def kee_from_ops(U1, w1, A1: int, U2, w2, A2: int, params, zeta: int,
                 dual: bool = False, kind: str = "rbf", deriv: bool = False):
    """K_EE (m1, m2) from energy operands (plain PyTorch on any device: the
    block is small next to K_FF, but it reads the same operand values as
    the kernels so the training covariance stays one consistent Gram).
    dual=True returns (K, dK/dgamma), deriv=True dK/dgamma alone.  Dot:
    s2 (c^z + s0^2) over the masked pairs; its constant part is s2 s0^2
    count_ee."""
    kind, deriv = _family(kind, deriv)
    sigma2, p2 = _scalars(params, kind, dual, deriv)
    U1, U2 = dense(U1), dense(U2)
    m1, m2 = U1.shape[0] // A1, U2.shape[0] // A2
    outs = [U1.new_zeros((m1, m2)) for _ in range(1 + dual)]
    pc = _chunk_points(A1, U2.shape[0])
    for p0 in range(0, m1, pc):
        p1 = min(m1, p0 + pc)
        c = torch.matmul(U1[p0 * A1:p1 * A1], U2.T)
        wl = w1[:, p0 * A1:p1 * A1]
        w = (wl[0][:, None] * w2[0][None, :]
             * (wl[1][:, None] == w2[1][None, :]))
        D = c
        for _ in range(zeta - 1):
            D = D * c
        if kind == "dot":
            k = sigma2 * (D + p2)
        else:
            k = sigma2 * torch.exp((D - 1.0) * p2)
        planes = [] if deriv else [k]
        if dual or deriv:
            planes.append(k * (D - 1.0))
        for out, plane in zip(outs, planes):
            out[p0:p1] = _point_sum(plane * w, A1, A2)
    return tuple(outs) if dual else outs[0]


def kee_served(U1, w1, A1: int, U2, w2, A2: int, params, zeta: int,
               kind: str = "rbf", dtype=None):
    """K_EE of a served block: ``kee_from_ops`` in float64, rounded once
    to ``dtype`` (default: the operands').  A float32 product's sums
    follow the number of query rows (the library picks its kernel by
    shape), so a band served at once and its structures served one at a
    time differed by that rounding, which the weights amplify: 1.3e-4 eV
    on a 13-atom energy (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)."""
    f64 = torch.float64
    return kee_from_ops(dense(U1).to(f64), w1.to(f64), A1,
                        dense(U2).to(f64), w2.to(f64), A2, params, zeta,
                        kind=kind).to(dense(U1).dtype if dtype is None
                                      else dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources(source: Path = CSRC) -> list[Path]:
    """The files a library is built from: every ``*.cu`` and ``*.cuh`` of
    the directory ``source`` (by name), or the one file ``source``."""
    source = Path(source)
    if source.is_dir():
        return sorted(p for p in source.iterdir()
                      if p.suffix in (".cu", ".cuh"))
    return [source]


def library_name(source: Path = CSRC) -> str:
    """``libkff-<hash>.so``: the hash over the name and the bytes of every
    file of ``sources(source)``, so a change to any source or header names
    a new library."""
    h = hashlib.sha256()
    for path in sources(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return f"libkff-{h.hexdigest()[:16]}.so"


def build(source: Path = CSRC) -> tuple[Path, str]:
    """Compile the kernels of ``source`` (the ``csrc/`` directory, or one
    ``.cu`` file of another revision) for sm_90a and link them into one
    library in ``build/`` (skipped when the library for these sources
    already exists).  Every ``.cu`` is compiled by an nvcc of its own, all
    started together, then one nvcc links the objects.  Returns (library
    path, compiler output in source order).  The library is written under
    a temporary name and renamed into place, so concurrent processes never
    load a partial file."""
    files = sources(source)
    out = BUILD_DIR / library_name(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xcompiler", "-fPIC"]
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    procs = []
    try:
        for src in (f for f in files if f.suffix == ".cu"):
            obj = os.path.join(work, src.stem + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *arch, "-Xptxas", "-v", "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [proc.communicate(timeout=900)[0] for _, proc in procs]
        failed = [log for (_, proc), log in zip(procs, logs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        res = subprocess.run([nvcc, *arch, "-shared", "-o", tmp,
                              *(obj for obj, _ in procs)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    return out, "".join(logs) + res.stdout + res.stderr


_FN = {}        # entry-point name -> bound ctypes function
_READY = set()  # device indices whose shared-memory limits are set


def load(path) -> dict:
    """Load a library built from ``csrc/`` (or from another revision's
    sources with its entry points): {entry-point name: bound ctypes
    function}, with ``kff_empty``, ``kff_rect_init`` and ``kff_tri_rows``
    where the library has them (a library with ``kff_tri_rows`` takes the
    k-major copy, ``tri_operand``, as X2 of its highest K1 entry
    points)."""
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    LL, D = ctypes.c_longlong, ctypes.c_double
    fns = {}
    # every entry point: (X1, re1, m1, B1, X2, re2, m2, B2, out, outd,
    # sigma2, second scalar, zeta, first tile, tile count, leading
    # dimension of out, transposed store, stream); the scalars are double
    # in the float64 kernels
    for name in _ENTRIES:
        fn = getattr(lib, name)
        S = D if name.endswith("_" + F64) else F
        fn.argtypes = [P, P, I, I, P, P, I, I, P, P, S, S, I, LL, LL, LL, I,
                       P]
        fn.restype = I
        fns[name] = fn
    for name, argtypes in (("kff_empty", [P]), ("kff_rect_init", []),
                           ("kff_tri_rows", [])):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, I
            fns[name] = fn
    return fns


def _lib() -> dict:
    """The package's library, built and loaded at first use; the current
    device's shared-memory limits are set (and checked) here."""
    if not _FN:
        path, _ = build()
        fns = load(path)
        if fns["kff_tri_rows"]() != TROWS:
            raise RuntimeError(f"{path}: K1 reads {fns['kff_tri_rows']()} "
                               f"rows of its k-major copy, not {TROWS}")
        _FN.update(fns)
        _init_device(torch.cuda.current_device())
    return _FN


def _init_device(index: int) -> None:
    """The highest kernels' shared-memory limits on card
    ``index``: once per card, before its first launch."""
    with torch.cuda.device(index):
        rc = _FN["kff_rect_init"]()
    if rc != 0:
        raise RuntimeError(f"kff_rect_init failed on cuda:{index}: CUDA "
                           f"error {rc}")
    _READY.add(index)


def launch_empty(device) -> None:
    """One launch of the library's empty kernel on ``device``'s current
    stream: the floor of a launch (``chip_smoke.py`` times it)."""
    with torch.cuda.device(device):
        rc = _lib()["kff_empty"](
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kff_empty launch failed: CUDA error {rc}")


def _check_dtypes(*tensors):
    """float32 (or bf16 parts with float32 metadata) for the kernels of the
    matmul precisions, or float64 throughout for the ``_f64`` kernels."""
    wide = tensors[0].dtype == torch.float64
    for t in tensors:
        if t.dtype not in (torch.float32, torch.bfloat16, torch.float64):
            raise TypeError(f"the CUDA kernels take float32 or float64, got "
                            f"{t.dtype}")
        if (t.dtype == torch.float64) != wide:
            raise TypeError("float64 and float32 operands do not mix in one "
                            "launch")


def _check_cuda(zeta: int, *tensors):
    """The operands of one launch: of the kernels' dtypes
    (``_check_dtypes``), on one card, contiguous and aligned."""
    if zeta < 1:
        raise ValueError(f"zeta must be a positive integer, got {zeta}")
    _check_dtypes(*tensors)
    for t in tensors:
        if t.device != tensors[0].device or t.device.type != "cuda":
            raise ValueError("kernel operands must all lie on one card")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _check_side(X, re, B: int, comps: int, mode: str):
    parts = X.dim() - 2 - (comps > 1)
    rows = X.shape[-3] if comps > 1 else 1
    if (rows != comps or X.shape[-1] != DP
            or parts != (mode not in ("highest", F64))):
        raise ValueError(f"operand shape {tuple(X.shape)} is not "
                         f"({comps}, N, {DP}) in mode {mode}")
    N = X.shape[-2]
    if re.dtype != _out_dtype(mode):
        raise TypeError(f"operand metadata must be {_out_dtype(mode)}, got "
                        f"{re.dtype}")
    if re.shape != (2, N) or B < 1 or N % B:
        raise ValueError("operand rows do not match the env count")
    if N // B > _MAX_POINTS:
        raise ValueError("too many points for one kernel launch")


def _mode(mm_precision, *ops) -> str:
    """The kernel set: ``mm_precision`` (default: the configured one),
    which float32 and bf16 operands must have been built in; float64
    operands ignore it and take the float64 kernels (``F64``)."""
    mode = config.kff_precision(mm_precision)
    if any(X.dtype == torch.float64 for X in ops):
        return F64
    for X in ops:
        if operand_precision(X) != mode:
            raise ValueError(f"operand built in mode "
                             f"{operand_precision(X)!r}, kernel asked for "
                             f"{mode!r}")
    return mode


def _launch(base, mode, device, *args, k0=0, nk=0, ldo=0, trans=False,
            ranged=False):
    """Launch entry point ``base`` in ``mode`` on the device's current
    stream and count it; (k0, nk) is K1's tile range (unused by K2 and
    K3), counted under the ``_range`` name when ``ranged``; ldo is the
    leading dimension of the output, trans the transposed store of K2."""
    name = kernel_name(base, mode)
    fn = _FN.get(name) or _lib()[name]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index not in _READY:
        _init_device(index)
    if index == current:
        rc = fn(*args, k0, nk, ldo, int(trans),
                torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, k0, nk, ldo, int(trans),
                    torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[kernel_name(base + "_range", mode) if ranged else name] += 1


def _out_dtype(mode: str):
    """The dtype the kernels of ``mode`` write (and read their metadata
    in): float64 for ``F64``, else float32."""
    return torch.float64 if mode == F64 else torch.float32


def _check_out(out, rows: int, cols: int, like, dtype):
    """``out=``: a (rows, cols) view on the operands' device.  On the card
    it must be of the kernels' ``dtype`` with contiguous columns (a slice
    of a larger row-major buffer); on the CPU the plain version's block is
    copied into it (cast to its dtype)."""
    cpu = like.device.type == "cpu"
    if (out.dim() != 2 or tuple(out.shape) != (rows, cols)
            or (out.dtype != dtype and not cpu)
            or out.device != like.device):
        raise ValueError(f"out must be a ({rows}, {cols}) {dtype} tensor on "
                         f"{like.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    if cpu:
        return
    if (out.stride(1) != 1 or out.stride(0) < cols
            or out.data_ptr() % out.element_size()):
        raise ValueError("out must have contiguous columns (a slice of a "
                         "row-major buffer)")


def _variant(kind: str, dual: bool, deriv: bool) -> str:
    return ("_dot" if kind == "dot" else "_dual" if dual
            else "_deriv" if deriv else "")


def _outputs(out, outd, rows: int, cols: int, dual: bool, zero: bool,
             like, dtype):
    """The output views of one launch: ``out`` (and ``outd`` for a dual
    pass), checked, or new (rows, cols) tensors of the kernels' ``dtype``;
    zeroed when ``zero`` (a tile-range launch writes its own tiles
    alone)."""
    if not dual and outd is not None:
        raise ValueError("outd= is the dK/dgamma plane of a dual pass")
    planes = []
    for o in (out, outd)[:1 + dual]:
        if o is None:
            o = (torch.zeros if zero else torch.empty)(
                (rows, cols), dtype=dtype, device=like.device)
        else:
            _check_out(o, rows, cols, like, dtype)
            if zero:
                o.zero_()
        planes.append(o)
    return planes


def kff_from_ops(X1, re1, B1: int, X2, re2, B2: int, params, zeta: int,
                 symmetric: bool = False, dual: bool = False,
                 kind: str = "rbf", deriv: bool = False,
                 mm_precision: str | None = None, tiles=None, out=None,
                 outd=None):
    """K_FF (3 m1, 3 m2) from force operands; symmetric=True (X1 is X2)
    runs the triangular kernel K1, else the rectangular K3 (``_dot`` for
    kind="dot").  dual=True (RBF) returns (K, dK/dgamma) from one pass
    (K1-dual, K3-dual), deriv=True dK/dgamma alone (``_deriv``).  The
    mode's kernel (``_bf16x4``, ``_bf16``) runs on operands built in that
    mode.  tiles=(k0, nk) (symmetric only) is K1's tile-range form: the
    output is zeroed and one launch writes tiles [k0, k0 + nk) of the
    upper triangle and their transposes (counted as ``*_range``); an
    empty range launches nothing.  out (and outd, the dK/dgamma plane of
    a dual pass): the block is written into these (3 m1, 3 m2) views --
    slices of a caller's buffer, zeroed first for a tile range -- and
    returned."""
    kind, deriv = _family(kind, deriv)
    sigma2, p2 = _scalars(params, kind, dual, deriv)
    mode = _mode(mm_precision, X1, X2)
    if tiles is not None and not symmetric:
        raise ValueError("a tile range needs symmetric=True")
    if X1.device.type == "cpu":
        m1, m2 = X1.shape[-2] // B1, X2.shape[-2] // B2
        given = out is not None or outd is not None
        planes = _outputs(out, outd, 3 * m1, 3 * m2, dual, False,
                          X1, dense(X1).dtype) if given else None
        K = kff_plain(X1, re1, B1, X2, re2, B2, params, zeta,
                      symmetric=symmetric, dual=dual, kind=kind,
                      deriv=deriv, tiles=tiles)
        if not given:
            return K
        for o, k in zip(planes, K if dual else (K,)):
            o.copy_(k)
        return tuple(planes) if dual else planes[0]
    _check_cuda(zeta, X1, re1, X2, re2)
    _check_side(X1, re1, B1, 4, mode)
    _check_side(X2, re2, B2, 4, mode)
    m1, m2 = X1.shape[-2] // B1, X2.shape[-2] // B2
    if symmetric and (X1.data_ptr() != X2.data_ptr() or B1 != B2):
        raise ValueError("symmetric K_FF needs one operand set")
    if tiles is not None:
        k0, nk = _check_tiles(tiles, m1)
    else:
        k0, nk = 0, n_tri_tiles(m1) if symmetric else 0
    planes = _outputs(out, outd, 3 * m1, 3 * m2, dual, tiles is not None,
                      X1, _out_dtype(mode))
    out, outd = planes[0], planes[-1]
    if outd.stride(0) != out.stride(0):
        raise ValueError("out and outd must have one leading dimension")
    base = ("kff_tri" if symmetric else "kff_rect") + _variant(kind, dual,
                                                                deriv)
    if nk or not symmetric:
        # the highest K1 kernels read the k-major copy of the operand as X2
        rhs, re_rhs = (_tri_copy(X1, re1, B1), re1) \
            if symmetric and mode == "highest" else (X2, re2)
        # the Dot force blocks need sigma^2 alone (sigma0 enters K_EE only)
        _launch(base, mode, X1.device, X1.data_ptr(), re1.data_ptr(), m1,
                B1, rhs.data_ptr(), re_rhs.data_ptr(), m2, B2,
                out.data_ptr(), outd.data_ptr(), sigma2,
                0.0 if kind == "dot" else p2, zeta, k0=k0, nk=nk,
                ldo=out.stride(0), ranged=tiles is not None)
    return (out, outd) if dual else out


def kef_from_ops(U1, w1, A1: int, X2, re2, B2: int, params, zeta: int,
                 dual: bool = False, kind: str = "rbf", deriv: bool = False,
                 mm_precision: str | None = None, out=None,
                 transpose: bool = False, outd=None):
    """K_EF (m1, 3 m2) from energy and force operands (kernel K2, or
    K2-dot); dual=True (RBF) returns (K, dK/dgamma) from one pass,
    K2-dual; deriv=True dK/dgamma alone, K2-deriv.  transpose=True (not
    dual) gives K_EF^T (3 m2, m1), which the kernel of every mode stores
    so.  out (and outd, the
    dK/dgamma plane of a dual pass): the block is written into these
    views, (m1, 3 m2) or (3 m2, m1), and returned."""
    kind, deriv = _family(kind, deriv)
    sigma2, p2 = _scalars(params, kind, dual, deriv)
    mode = _mode(mm_precision, U1, X2)
    if dual and transpose:
        raise ValueError("transpose= is for the single-plane kernels")
    m1, m2 = U1.shape[-2] // A1, X2.shape[-2] // B2
    shape = (3 * m2, m1) if transpose else (m1, 3 * m2)
    given = out is not None or outd is not None
    if U1.device.type == "cpu":
        planes = _outputs(out, outd, *shape, dual, False, U1,
                          dense(U1).dtype) if given else None
        K = kef_plain(U1, w1, A1, X2, re2, B2, params, zeta, dual=dual,
                      kind=kind, deriv=deriv)
        if transpose:
            K = K.T
        if not given:
            return K.contiguous() if transpose else K
        for o, k in zip(planes, K if dual else (K,)):
            o.copy_(k)
        return tuple(planes) if dual else planes[0]
    _check_cuda(zeta, U1, w1, X2, re2)
    _check_side(U1, w1, A1, 1, mode)
    _check_side(X2, re2, B2, 4, mode)
    if given:
        planes = _outputs(out, outd, *shape, dual, False, U1,
                          _out_dtype(mode))
        out, outd = planes[0], planes[-1]
        if outd.stride(0) != out.stride(0):
            raise ValueError("out and outd must have one leading dimension")
    base = "kef_rect" + _variant(kind, dual, deriv)
    args = (U1.data_ptr(), w1.data_ptr(), m1, A1, X2.data_ptr(),
            re2.data_ptr(), m2, B2)
    scalars = (sigma2, 0.0 if kind == "dot" else p2, zeta)
    if not given:
        out = torch.empty(shape, dtype=_out_dtype(mode), device=U1.device)
        outd = torch.empty_like(out) if dual else out
    _launch(base, mode, U1.device, *args, out.data_ptr(), outd.data_ptr(),
            *scalars, ldo=out.stride(0), trans=transpose)
    return (out, outd) if dual else out
