r"""Covariance assembly for the GP: the training covariance ``k_self``,
its RBF hyperparameter pair ``k_self_dual``, the serving
cross-covariance ``k_block``, the variance diagonals and the Dot
kernel's pair-count matrix ``count_ee`` -- the part of the JAX package's
``ops/kernels.py`` that fitting, training and serving call.

Every block function goes through the operand form of ``ops/kff.py``:
K_FF and K_EF run the CUDA kernels for float32 or float64 tensors on the
card (float64 data: the ``_f64`` kernels, which write float64) and the
plain PyTorch versions on the CPU; K_EE is a plain product over the same
operands.  Rows/cols are ordered [energies..., 3 rows per force
point...] (the reference's build_covariance, kernels/base.py:3-30).
``kind`` is the kernel family, "rbf" or "dot" (``ops/kff.py`` has both
sets of coefficients), or "rbf_dgamma" in ``k_self``/``k_block``: the
RBF covariance's dK/dgamma (the JAX package's ops/kernels.py:97-121).
The covariance builds take the matmul precision of ``config``
(``mm_precision`` overrides it); the variance diagonals stay exact.

``mesh`` (a ``parallel.Mesh``) on ``k_self``, ``k_self_dual`` and
``k_block`` shards the build over the mesh's devices
(``parallel/sharded_kernels.py``) when every shard gets real work -- the
two gates below, the JAX package's ``_sharded_train_ok`` and
``_sharded_serving_ok`` restated in the kernels' TP-point tiles.  Below
the gate the build runs unsharded on the mesh's root, where the data
lies (the JAX package then takes its XLA build).
``config.set_sharded_gate("off")`` takes the sharded route always.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config
from .kff import (TP, _coeffs, _mirror, _point_sum, _scalars, _sorts,
                  dense, energy_operand, force_operand, force_operands,
                  kee_from_ops, kee_served, kef_from_ops, kef_plain,
                  kff_from_ops, kff_plain, n_tri_tiles)
from .packing import EnergyData, ForceData


def _self_buffers(e: EnergyData, f: ForceData, n_planes: int, dtype,
                  like):
    """The (m_e + 3 m_f) square buffers of a training covariance, on the
    device of ``like`` (the dense energy operand), and whether the force
    blocks are written straight into them: the kernels write the
    operands' dtype (float32, or float64 for float64 operands), so on the
    card a buffer of another dtype takes them by a copy; on the CPU the
    plain versions' blocks are copied in (cast) either way."""
    n = e.m + 3 * f.m
    bufs = [torch.empty((n, n), dtype=dtype, device=like.device)
            for _ in range(n_planes)]
    return bufs, like.device.type == "cpu" or dtype == like.dtype


def _fill_self(K, m: int, K_ee, ef, ff, direct: bool):
    """K_EE (mirrored from its upper triangle) into K's corner, K_EF and
    K_FF into their slices unless the kernels wrote them there
    (``direct``), and K_FE = K_EF^T by a copy."""
    K[:m, :m] = _mirror(K_ee)
    if not direct:
        K[:m, m:] = ef
        K[m:, m:] = ff
    K[m:, :m] = K[:m, m:].T


def _sharded_train_ok(m_f: int, n_shards: int) -> bool:
    """Work-proportionality gate of the mesh-sharded training build over
    ``m_f`` force points: ``_sharded_train_ok`` of the JAX package (its
    ops/kernels.py:829-860) in TP-point tiles.  Not when the tile padding
    dominates (fewer points than half a tile), and only when every shard
    gets at least one upper-triangle tile.  The ranges are balanced to
    one tile, so then the largest shard times the shard count stays
    under twice the tiles, the JAX gate's bound on recomputation (the
    port recomputes nothing: it has no filler cells)."""
    if config.sharded_gate() == "off":
        return True
    return 2 * m_f >= TP and n_tri_tiles(m_f) >= n_shards


def _sharded_serving_ok(m_f2: int, n_shards: int) -> bool:
    """Serving-side gate (``_sharded_serving_ok`` of the JAX package, its
    ops/kernels.py:863-871, in tiles): the ``m_f2`` training force points
    must give every shard a column stripe of at least half a TP-point
    tile.  The stripes are cut at whole tiles, so that takes more than
    n_shards - 1 full tiles of points."""
    if config.sharded_gate() == "off":
        return True
    return 2 * m_f2 >= TP * (2 * n_shards - 1)


def _sharded(mesh, plain: bool = False) -> bool:
    """Whether ``mesh`` asks for a sharded build at all (a mesh of one
    shard behaves as no mesh)."""
    if mesh is None or mesh.size < 2:
        return False
    if plain:
        raise ValueError("plain=True builds on one device: pass no mesh")
    return True


def k_self(e: EnergyData, f: ForceData, params, zeta: int = 2,
           kind: str = "rbf", plain: bool = False, dtype=None,
           mm_precision: str | None = None, mesh=None, rest=None):
    """Symmetric training covariance (K_FE = K_EF^T, RBF_mb.py:161-165);
    kind="rbf_dgamma" gives dK/dgamma of the RBF one (the deriv builds).

    The operands are built ONCE, in the matmul precision ``mm_precision``
    (default ``config.kff_precision()``), and every block reads the same
    rounded values, so K_EE, K_EF and K_FF are one consistent Gram (PSD
    contract, kernels.py:708-737 of the JAX package); K_FF runs the
    triangular kernel K1 (K1-dot for kind="dot").  K is built in ONE
    buffer: K1 and K2 write their blocks into its slices (``out=``), K_EE
    goes into its corner and K_FE = K_EF^T is copied, so no block is held
    twice.  plain=True takes the plain versions on any device.  dtype
    (default: the operands') is the result's: K_EE is computed in it from
    the same rounded operand values, the force blocks are cast to it (on
    the card a buffer of another dtype than the data's takes them by a
    copy).  Every block is mirrored or transposed from one triangle, so K
    is exactly symmetric.  mesh:
    K1's tile ranges and the energy-row stripes run one per shard
    (``self_blocks_sharded``); K_FF and K_EF are the unsharded ones bit
    for bit.  rest: the training rows (e0, f0) these rows extend (the new
    self block of an incremental refit): the envs are then sorted as a
    full refit's sides would be (``gram_sorts``), on the unsharded
    route.  Force points with 9 cartesian columns (the self block of a
    stress request's predictive covariance) take ``_k_self_groups``, on
    one device."""
    mode = config.kff_precision(mm_precision)
    if f.ncart != 3:
        return _k_self_groups(e, f, params, zeta, kind, plain, dtype, mode)
    if _sharded(mesh, plain) and _sharded_train_ok(f.m, mesh.size):
        from ..parallel.sharded_kernels import self_blocks_sharded
        (K,) = self_blocks_sharded(e, f, params, kind, zeta, False, mesh,
                                   mm_precision=mode, dtype=dtype)
        return K
    A, B, m = e.x.shape[1], f.x.shape[1], e.m
    sort = gram_sorts(e, f, rest)
    U, w = energy_operand(e, mode, sort[0])
    X, re = force_operand(f, mode, sort[1])
    Ud = dense(U)
    dt = Ud.dtype if dtype is None else dtype
    (K,), direct = _self_buffers(e, f, 1, dt, Ud)
    direct = direct and not plain
    Ud, wd = Ud.to(dt), w.to(dt)
    K_ee = kee_from_ops(Ud, wd, A, Ud, wd, A, params, zeta, kind=kind)
    if direct:
        kw = dict(kind=kind, mm_precision=mode)
        ef = kef_from_ops(U, w, A, X, re, B, params, zeta, out=K[:m, m:],
                          **kw)
        ff = kff_from_ops(X, re, B, X, re, B, params, zeta, symmetric=True,
                          out=K[m:, m:], **kw)
    else:
        kef = kef_plain if plain else kef_from_ops
        kff = kff_plain if plain else kff_from_ops
        kw = dict(kind=kind) if plain else dict(kind=kind, mm_precision=mode)
        ef = kef(U, w, A, X, re, B, params, zeta, **kw)
        ff = kff(X, re, B, X, re, B, params, zeta, symmetric=True, **kw)
    _fill_self(K, m, K_ee, ef, ff, direct)
    return K


def _k_self_groups(e: EnergyData, f: ForceData, params, zeta: int,
                   kind: str, plain: bool, dtype, mode: str):
    """``k_self`` of force points with strain rows, rows (point, 9): per
    group of three columns (``force_operands``) K_EF by K2 and the
    diagonal group block by K1; between two groups K3, the lower block
    its transpose.  Assembled group-major and permuted once into (point,
    group, 3) order."""
    A, B, m = e.x.shape[1], f.x.shape[1], e.m
    U, w = energy_operand(e, mode)
    Xs, re = force_operands(f, mode)
    Ud = dense(U)
    dt = Ud.dtype if dtype is None else dtype
    kef = kef_plain if plain else kef_from_ops
    kff = kff_plain if plain else kff_from_ops
    kw = dict(kind=kind) if plain else dict(kind=kind, mm_precision=mode)
    n_g, n_f = len(Xs), 3 * f.m
    K = torch.empty((m + n_g * n_f,) * 2, dtype=dt, device=Ud.device)
    K[:m, :m] = _mirror(kee_from_ops(Ud.to(dt), w.to(dt), A, Ud.to(dt),
                                     w.to(dt), A, params, zeta, kind=kind))
    for g, Xg in enumerate(Xs):
        rg = slice(m + g * n_f, m + (g + 1) * n_f)
        K[:m, rg] = kef(U, w, A, Xg, re, B, params, zeta, **kw)
        K[rg, rg] = kff(Xg, re, B, Xg, re, B, params, zeta, symmetric=True,
                        **kw)
        for h in range(g + 1, n_g):
            rh = slice(m + h * n_f, m + (h + 1) * n_f)
            K[rg, rh] = kff(Xg, re, B, Xs[h], re, B, params, zeta, **kw)
            K[rh, rg] = K[rg, rh].T
        K[rg, :m] = K[:m, rg].T
    order = torch.arange(n_g * n_f, device=K.device).view(
        n_g, f.m, 3).transpose(0, 1).reshape(-1)
    order = torch.cat([torch.arange(m, device=K.device), m + order])
    return K[order[:, None], order[None, :]]


def k_self_dual(e: EnergyData, f: ForceData, params, zeta: int = 2,
                plain: bool = False, mm_precision: str | None = None,
                mesh=None, dtype=None):
    """(K, dK/dgamma) of the symmetric RBF training covariance, gamma =
    1 / (2 l^2): one fused pass per block (K1-dual, K2-dual on the card),
    which the analytic NLL gradient runs at every L-BFGS-B evaluation.

    As in ``k_self`` the operands are built once, in one matmul
    precision, and all three blocks read the same rounded values (PSD
    contract); each matrix is one buffer that K1-dual and K2-dual write
    their two planes into (``out=``, ``outd=``), and both come out exactly
    symmetric.  dtype (default: the operands'): the result's, as in
    ``k_self``: K_EE and dK_EE/dgamma are computed in it from the rounded
    operand values and the kernels' force blocks are cast to it, so K in
    float64 is ``k_self(dtype=float64)``'s K.  plain=True takes the plain
    versions on any device (the float64 reference on the card).  mesh:
    the dual pass over K1's tile ranges, one per shard."""
    mode = config.kff_precision(mm_precision)
    if _sharded(mesh, plain) and _sharded_train_ok(f.m, mesh.size):
        from ..parallel.sharded_kernels import self_blocks_sharded
        return self_blocks_sharded(e, f, params, "rbf", zeta, True, mesh,
                                   mm_precision=mode, dtype=dtype)
    A, B, m = e.x.shape[1], f.x.shape[1], e.m
    U, w = energy_operand(e, mode)
    X, re = force_operand(f, mode)
    Ud = dense(U)
    dt = Ud.dtype if dtype is None else dtype
    Ks, direct = _self_buffers(e, f, 2, dt, Ud)
    direct = direct and not plain
    ee = kee_from_ops(Ud.to(dt), w.to(dt), A, Ud.to(dt), w.to(dt), A,
                      params, zeta, dual=True)
    if plain:
        ef = kef_plain(U, w, A, X, re, B, params, zeta, dual=True)
        ff = kff_plain(X, re, B, X, re, B, params, zeta, symmetric=True,
                       dual=True)
    else:
        sl = ((slice(None, m), slice(m, None)),
              (slice(m, None), slice(m, None)))
        ef = kef_from_ops(U, w, A, X, re, B, params, zeta, dual=True,
                          mm_precision=mode,
                          **(dict(out=Ks[0][sl[0]], outd=Ks[1][sl[0]])
                             if direct else {}))
        ff = kff_from_ops(X, re, B, X, re, B, params, zeta, symmetric=True,
                          dual=True, mm_precision=mode,
                          **(dict(out=Ks[0][sl[1]], outd=Ks[1][sl[1]])
                             if direct else {}))
    for i, K in enumerate(Ks):
        _fill_self(K, m, ee[i], ef[i], ff[i], direct)
    return tuple(Ks)


# side_operands() calls since the last reset, by the side's role in a
# served block ("train": the data2 side, which a fitted model builds once)
operand_builds = {"query": 0, "train": 0}


def reset_operand_builds() -> None:
    for k in operand_builds:
        operand_builds[k] = 0


class SideOperands(NamedTuple):
    """The operands of one side of a serving block in matmul precision
    ``mode``: energy (U, w, A), force (X, re, B), the unrounded energy
    rows ``Ue`` that K_EE reads (U itself in "highest"), and ``Xs`` the
    operands of the strain column groups of a stress request's force
    points (``force_operands``; empty for three columns)."""
    mode: str
    U: torch.Tensor
    w: torch.Tensor
    A: int
    X: torch.Tensor
    re: torch.Tensor
    B: int
    Ue: torch.Tensor
    Xs: tuple = ()


def gram_sorts(e: EnergyData, f: ForceData, rest=None):
    """Whether the (energy, force) side's envs are sorted by element
    (``energy_operand``, ``force_operand``): None for each, the side's own
    size decides; or, where the rows extend the training rows ``rest`` =
    (e0, f0) (the blocks of an incremental refit), by the size of the
    side a full refit of both would pack, so that a point's sum runs in
    that refit's order."""
    if rest is None:
        return None, None
    e0, f0 = rest
    return (_sorts(None, e.m + e0.m, max(e.x.shape[1], e0.x.shape[1])),
            _sorts(None, f.m + f0.m, max(f.x.shape[1], f0.x.shape[1])))


def side_operands(e: EnergyData, f: ForceData, mode: str,
                  role: str = "query", rest=None) -> SideOperands:
    """Build one side's operands (counted in ``operand_builds[role]``);
    rest: as in ``k_self``."""
    sort = gram_sorts(e, f, rest)
    U, w = energy_operand(e, mode, sort[0])
    (X, *Xs), re = force_operands(f, mode, sort[1])
    Ue = U if mode == "highest" else energy_operand(e, "highest", sort[0])[0]
    operand_builds[role] += 1
    return SideOperands(mode, U, w, e.x.shape[1], X, re, f.x.shape[1], Ue,
                        tuple(Xs))


def block_operands(e1: EnergyData, f1: ForceData, e2: EnergyData,
                   f2: ForceData, mode: str, gram: bool = False):
    """The operands of one serving block in ``mode``: (U, w, A) and (X,
    re, B) of both sides, and the two unrounded energy operands K_EE
    reads; gram: as in ``k_block``."""
    s1 = side_operands(e1, f1, mode, rest=(e2, f2) if gram else None)
    s2 = side_operands(e2, f2, mode, "train")
    return ((s1.U, s1.w, s1.A), (s1.X, s1.re, s1.B),
            (s2.U, s2.w, s2.A), (s2.X, s2.re, s2.B), s1.Ue, s2.Ue)


def block_kee(U1e, U1, w1, A1: int, U2e, U2, w2, A2: int, params,
              zeta: int, kind: str, gram: bool, dtype=None):
    """K_EE of a block in ``dtype`` (default: the operands'): of a
    training Gram (``gram``: from the rounded operands U, computed in
    ``dtype`` as ``k_self`` computes it) or served (from the unrounded
    ones Ue in float64, rounded once: ``kee_served``)."""
    if gram:
        dt = dense(U1).dtype if dtype is None else dtype
        return kee_from_ops(dense(U1).to(dt), w1.to(dt), A1,
                            dense(U2).to(dt), w2.to(dt), A2, params, zeta,
                            kind=kind)
    return kee_served(U1e, w1, A1, U2e, w2, A2, params, zeta, kind=kind,
                      dtype=dtype)


def k_block(e1: EnergyData, f1: ForceData, e2: EnergyData, f2: ForceData,
            params, zeta: int = 2, kind: str = "rbf",
            mm_precision: str | None = None, mesh=None,
            train_ops: SideOperands | None = None, gram: bool = False,
            dtype=None):
    """[[K_EE, K_EF], [K_FE, K_FF]] for (rows: data1, cols: data2) -- the
    serving cross-covariance, built in ONE buffer: the block is allocated
    once, kernel K2 writes K_EF into its slice and, in the other
    orientation with a transposed store, K_FE into its own; the
    rectangular kernel K3 writes K_FF; K_EE is copied into its corner.
    K_EF, K_FE and K_FF take the matmul precision ``mm_precision``; K_EE
    is computed from the unrounded energy operands, as in the JAX
    package's serving build (``kee``, its ops/kernels.py:574), in float64
    and rounded once (``kee_served``).  gram=True: the block joins a
    training covariance (the cross block of an incremental refit), so its
    K_EE comes from the rounded operands (``kee_from_ops``), as in
    ``k_self``, data1's envs are sorted as that Gram's would be
    (``gram_sorts``), and the block is a slice of the Gram a full
    ``k_self`` of both sides would build.  dtype (default: the data's):
    the block's; K_EE is computed in it (served: rounded once to it), the
    kernels' blocks are cast to it.
    train_ops: the data2 side's operands (``side_operands(e2, f2, mode,
    "train")``) when the caller keeps them, as a fitted GP does; they must
    have been built in this mode.  mesh: the training force axis (data2)
    runs in column stripes, one per shard (``k_block_sharded``, which
    builds its own operands).  data1's force points may carry 9 cartesian
    columns (a stress request; data2 carries 3): its rows are then
    (point, 9), each group of three columns (``force_operands``) one
    launch of K2 with the transposed store and one of K3, and the block
    is built unsharded on the mesh's root."""
    mode = config.kff_precision(mm_precision)
    if f2.ncart != 3:
        raise ValueError("the training side of a block carries 3 "
                         "cartesian columns")
    if _sharded(mesh) and _sharded_serving_ok(f2.m, mesh.size) \
            and f1.ncart == 3:
        from ..parallel.sharded_kernels import k_block_sharded
        return k_block_sharded(e1, f1, e2, f2, params, mesh, kind, zeta,
                               mm_precision=mode, gram=gram, dtype=dtype)
    s1 = side_operands(e1, f1, mode, rest=(e2, f2) if gram else None)
    s2 = train_ops if train_ops is not None \
        else side_operands(e2, f2, mode, "train")
    if s2.mode != mode:
        raise ValueError(f"train_ops were built in mode {s2.mode!r}, the "
                         f"block asks for {mode!r}")
    kw = dict(kind=kind, mm_precision=mode)
    K_ee = block_kee(s1.Ue, s1.U, s1.w, s1.A, s2.Ue, s2.U, s2.w, s2.A,
                     params, zeta, kind, gram, dtype)
    m1, m2 = K_ee.shape
    groups = (s1.X,) + s1.Xs
    K = torch.empty((m1 + 3 * len(groups) * f1.m, m2 + 3 * f2.m),
                    dtype=e1.x.dtype, device=K_ee.device)
    kef_from_ops(s1.U, s1.w, s1.A, s2.X, s2.re, s2.B, params, zeta,
                 out=K[:m1, m2:], **kw)
    # a stress request's rows are (point, 9): a column group's rows are
    # then no 2-D view of one row stride, which the kernels' out= needs.
    # So the groups' rows are built group-major, each group a slab that
    # K2 (transposed) and K3 write in place, and permuted into (point,
    # group, 3) order by one strided copy.
    rows = K[m1:] if len(groups) == 1 else torch.empty(
        (len(groups), 3 * f1.m, K.shape[1]), dtype=K.dtype, device=K.device)
    for g, Xg in enumerate(groups):
        slab = rows if len(groups) == 1 else rows[g]
        kef_from_ops(s2.U, s2.w, s2.A, Xg, s1.re, s1.B, params, zeta,
                     out=slab[:, :m2], transpose=True, **kw)
        kff_from_ops(Xg, s1.re, s1.B, s2.X, s2.re, s2.B, params, zeta,
                     out=slab[:, m2:], **kw)
    if len(groups) > 1:
        K[m1:].view(f1.m, len(groups), 3, -1).copy_(
            rows.view(len(groups), f1.m, 3, -1).transpose(0, 1))
        del rows
    K = K.to(K_ee.dtype)
    K[:m1, :m2] = K_ee
    return K


def count_ee(e: EnergyData):
    """Masked pair-count matrix W[p, q] = sum over valid same-element env
    pairs (a in p, b in q) of 1 / (N_p N_q), (m, m) -- dK_EE/d(sigma0^2)
    / sigma^2 of the Dot kernel, whose sigma0 enters only through the
    additive constant s2 s0^2 (kernels.py:492-505 of the JAX package).
    Read from the energy operand, as K_EE is."""
    A = e.x.shape[1]
    _, w = energy_operand(e, "highest")
    pair = w[0][:, None] * w[0][None, :] * (w[1][:, None] == w[1][None, :])
    return _point_sum(pair, A, A)


def diag_energy(e: EnergyData, params, zeta: int = 2, kind: str = "rbf",
                dtype=None):
    """Per-point K_EE(p, p), (m,), computed in ``dtype`` (default: the
    data's) from the data's unrounded operands, as ``kee_served``
    computes the served K_EE."""
    m, A = e.x.shape[:2]
    sigma2, p2 = _scalars(params, kind)
    U, w = energy_operand(e, "highest")
    if dtype is not None:
        U, w = U.to(dtype), w.to(dtype)
    U = U.reshape(m, A, -1)
    wgt, ele = w[0].reshape(m, A), w[1].reshape(m, A)
    k, _, _, _ = _coeffs(torch.bmm(U, U.transpose(1, 2)), sigma2, p2, zeta,
                         kind)
    mask = (wgt[:, :, None] * wgt[:, None, :]
            * (ele[:, :, None] == ele[:, None, :]))
    return (k * mask).sum(dim=(1, 2))


def diag_force(f: ForceData, params, zeta: int = 2, kind: str = "rbf"):
    """Per-point diagonal of the ncart x ncart K_FF(p, p) block, (m,
    ncart): 3 columns, or 9 with the strain rows of a stress request."""
    m, B = f.x.shape[:2]
    sigma2, p2 = _scalars(params, kind)
    Xs, re = force_operands(f, "highest")
    rinv, ele = re[0].reshape(m, B), re[1].reshape(m, B)
    w = (rinv[:, :, None] * rinv[:, None, :]
         * (ele[:, :, None] == ele[:, None, :]))
    cols = []
    for X in Xs:
        X = X.reshape(4, m, B, -1)
        G = torch.einsum("ipad,jpbd->ijpab", X, X)      # (4, 4, m, B, B)
        if not cols:
            _, A, Bc, _ = _coeffs(G[0, 0], sigma2, p2, zeta, kind)
            A, Bc = A * w, Bc * w
        cols += [(A * G[1 + u, 1 + u] + Bc * G[1 + u, 0] * G[0, 1 + u])
                 .sum(dim=(1, 2)) for u in range(3)]
    return torch.stack(cols, dim=1)
