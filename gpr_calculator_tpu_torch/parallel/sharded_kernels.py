"""Mesh-sharded covariance builds over the K1-K3 kernels of ``ops/kff.py``.

Port of the JAX package's ``parallel/sharded_kernels.py`` (the Pallas
kernels under shard_map).  Two decompositions, as there:

* ``self_blocks_sharded`` -- the training build behind ``GP(mesh=...)``
  (``k_self`` / ``k_self_dual``).  The upper-triangle tiles of the
  symmetric K_FF are cut into one contiguous range of the linear tile
  index per shard; each shard launches K1's tile-range form on its own
  device into a zeroed output, and the outputs are summed on the root.
  Every element is written by exactly one shard and is zero elsewhere,
  so the sum is exact: it is the single launch bit for bit.  (The JAX
  build slices the cell schedule, masks the blocks a device does not own
  and takes a psum.)  K_EF and K_EE are striped over the energy rows and
  concatenated on the root.  All blocks read ONE set of operand tensors,
  built once on the root and copied to the shards (the rounded values,
  never rebuilt per shard): one consistent Gram, as in ``k_self``.
* ``k_block_sharded`` -- the serving cross-covariance with the training
  force axis in column stripes (K3 and K2 per stripe); ``kff_sharded`` /
  ``kef_sharded`` -- row stripes whose outputs stay on their shards.

A stripe is the same kernel on a slice of one side's operand.  The slice
along the env axis of the (4, N, DP) layout is not contiguous, so each
shard takes a contiguous copy of its stripe (operand-sized, small next
to the output).  Stripes and tile ranges are cut at whole TP-point
tiles, so every point sits in the tile it has in the single launch.
All movement between shards is ``tensor.to(device)``.
"""
from __future__ import annotations

import torch

from .. import config
from ..ops.kff import (TP, _mirror, dense, energy_operand, force_operand,
                       kee_from_ops, kef_from_ops,
                       kff_from_ops, n_tri_tiles)
from .mesh import Mesh, shard_train_data

# sharded builds since the last reset_builds(), by kind
builds = {"self_blocks": 0, "k_block": 0}


def reset_builds() -> None:
    for k in builds:
        builds[k] = 0


def _split(n: int, n_shards: int):
    """``n`` items in ``n_shards`` contiguous (start, count) ranges whose
    counts differ by at most one (the first ``n % n_shards`` are the
    larger); with more shards than items the last ranges are empty."""
    q, r = divmod(n, n_shards)
    out, start = [], 0
    for s in range(n_shards):
        count = q + (s < r)
        out.append((start, count))
        start += count
    return out


def partition_tri_tiles(n_tiles: int, n_shards: int):
    """One contiguous range (k0, nk) of the linear upper-triangle tile
    index per shard, balanced by tile count: every tile is owned exactly
    once.  The counterpart of ``_partition_tri_cells`` (sharded_kernels.py
    :126-174 of the JAX package); tiles cost the same, so equal counts
    are equal work, and nothing is padded."""
    return _split(n_tiles, n_shards)


def partition_points(m: int, n_shards: int):
    """Point stripes (p0, p1) per shard, cut at whole TP-point tiles and
    balanced by tile count."""
    return [(min(t0 * TP, m), min((t0 + nt) * TP, m))
            for t0, nt in _split(-(-m // TP), n_shards)]


def _rows(t: torch.Tensor, p0: int, p1: int, per: int, dim: int, device):
    """The env rows of points [p0, p1) (``per`` envs a point) along
    ``dim``, as a contiguous tensor on ``device``."""
    return t.narrow(dim, p0 * per, (p1 - p0) * per).to(device).contiguous()


def _on_root(mesh: Mesh, *tensors):
    for t in tensors:
        if t.device != mesh.root:
            raise ValueError(f"the data lies on {t.device}, the mesh's root "
                             f"is {mesh.root}")


def _tup(x):
    return x if isinstance(x, tuple) else (x,)


def _gather(parts, root, dim: int):
    """Per-shard tuples of planes -> one tuple, concatenated on the root."""
    return tuple(torch.cat([p.to(root) for p in plane], dim=dim)
                 for plane in zip(*parts))


def self_blocks_sharded(e, f, params, kind: str, zeta: int, dual: bool,
                        mesh: Mesh, mm_precision: str | None = None,
                        dtype=None):
    """The symmetric training covariance (dual: and dK/dgamma) built over
    ``mesh``, assembled on its root: a 1-tuple (K,) or (K, dK/dgamma).
    kind is "rbf", "rbf_dgamma" or "dot" (Dot with dual raises).  Mirrors
    ``ops.kernels.k_self`` block for block: operands built once in the
    matmul precision, K_EE in ``dtype`` (default: the operands') from the
    same rounded values, the force blocks cast to it."""
    mode = config.kff_precision(mm_precision)
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = energy_operand(e, mode)
    X, re = force_operand(f, mode)
    _on_root(mesh, U, X)
    dt = dense(U).dtype if dtype is None else dtype
    kw = dict(kind=kind, dual=dual)
    ranges = partition_tri_tiles(n_tri_tiles(f.m), mesh.size)
    stripes = partition_points(e.m, mesh.size)
    ff, ef, ee = [], [], []
    for (Us, ws, Xs, res), tiles, (p0, p1) in zip(
            shard_train_data(mesh, U, w, X, re), ranges, stripes):
        if tiles[1]:
            ff.append(_tup(kff_from_ops(
                Xs, res, B, Xs, res, B, params, zeta, symmetric=True,
                tiles=tiles, mm_precision=mode, **kw)))
        if p1 > p0:
            dev = Us.device
            ef.append(_tup(kef_from_ops(
                _rows(Us, p0, p1, A, -2, dev), _rows(ws, p0, p1, A, -1, dev),
                A, Xs, res, B, params, zeta, mm_precision=mode, **kw)))
            Ud, wd = dense(Us).to(dt), ws.to(dt)
            ee.append(_tup(kee_from_ops(
                _rows(Ud, p0, p1, A, -2, dev), _rows(wd, p0, p1, A, -1, dev),
                A, Ud, wd, A, params, zeta, **kw)))
    root = mesh.root
    K_ff = [p.to(root) for p in ff[0]]
    for part in ff[1:]:
        for acc, p in zip(K_ff, part):
            acc.add_(p.to(root))
    K_ef, K_ee = _gather(ef, root, 0), _gather(ee, root, 0)
    builds["self_blocks"] += 1
    out = []
    for kee, kef, kff in zip(K_ee, K_ef, K_ff):
        kef, kff = kef.to(dt), kff.to(dt)
        out.append(torch.cat([torch.cat([_mirror(kee), kef], dim=1),
                              torch.cat([kef.T, kff], dim=1)], dim=0))
    return tuple(out)


def k_block_sharded(e1, f1, e2, f2, params, mesh: Mesh, kind: str = "rbf",
                    zeta: int = 2, mm_precision: str | None = None,
                    gram: bool = False, dtype=None):
    """The serving cross-covariance [[K_EE, K_EF], [K_FE, K_FF]] (rows:
    prediction data 1, cols: training data 2) with the training force
    axis in column stripes over ``mesh``: K3 and K2 run per stripe on its
    shard and are concatenated on the root; K_EE and K_FE touch only the
    small training energy axis and are computed on the root, as in
    ``ops.kernels.k_block`` (``gram``: the block of a training Gram, its
    K_EE and data1's env order as there; ``dtype``: the block's)."""
    from ..ops.kernels import block_kee, block_operands
    mode = config.kff_precision(mm_precision)
    (U1, w1, A1), (X1, re1, B1), (U2, w2, A2), (X2, re2, B2), U1e, U2e = \
        block_operands(e1, f1, e2, f2, mode, gram)
    _on_root(mesh, X1, X2)
    kw = dict(kind=kind, mm_precision=mode)
    ef, ff = [], []
    for (U1s, w1s, X1s, re1s), (q0, q1) in zip(
            shard_train_data(mesh, U1, w1, X1, re1),
            partition_points(f2.m, mesh.size)):
        if q1 == q0:
            continue
        dev = X1s.device
        X2s = _rows(X2, q0, q1, B2, -2, dev)
        re2s = _rows(re2, q0, q1, B2, -1, dev)
        ff.append((kff_from_ops(X1s, re1s, B1, X2s, re2s, B2, params, zeta,
                                **kw),))
        ef.append((kef_from_ops(U1s, w1s, A1, X2s, re2s, B2, params, zeta,
                                **kw),))
    root = mesh.root
    (K_ff,), (K_ef,) = _gather(ff, root, 1), _gather(ef, root, 1)
    K_ee = block_kee(U1e, U1, w1, A1, U2e, U2, w2, A2, params, zeta, kind,
                     gram, dtype)
    K_fe = kef_from_ops(U2, w2, A2, X1, re1, B1, params, zeta, **kw).T
    builds["k_block"] += 1
    dt = K_ee.dtype
    return torch.cat([torch.cat([K_ee, K_ef.to(dt)], dim=1),
                      torch.cat([K_fe.to(dt), K_ff.to(dt)], dim=1)], dim=0)


def kff_sharded(f, params, mesh: Mesh, zeta: int = 2, kind: str = "rbf",
                mm_precision: str | None = None):
    """The (3 m, 3 m) self force-force block in row stripes: shard s
    computes its stripe of lhs points against the whole rhs with the
    rectangular kernel K3.  Returns one (3 m_s, 3 m) tensor per shard,
    each on its shard's device (the JAX output stays row-sharded)."""
    mode = config.kff_precision(mm_precision)
    B = f.x.shape[1]
    X, re = force_operand(f, mode)
    _on_root(mesh, X)
    out = []
    for (Xs, res), (p0, p1) in zip(shard_train_data(mesh, X, re),
                                   partition_points(f.m, mesh.size)):
        dev = Xs.device
        if p1 == p0:
            out.append(dense(Xs).new_zeros((0, 3 * f.m)))
            continue
        out.append(kff_from_ops(
            _rows(Xs, p0, p1, B, -2, dev), _rows(res, p0, p1, B, -1, dev),
            B, Xs, res, B, params, zeta, kind=kind, mm_precision=mode))
    return out


def kef_sharded(e, f, params, mesh: Mesh, zeta: int = 2, kind: str = "rbf",
                mm_precision: str | None = None):
    """The (m_e, 3 m_f) energy-force block with the energy rows in
    stripes (kernel K2 per stripe): one (m_s, 3 m_f) tensor per shard,
    each on its shard's device."""
    mode = config.kff_precision(mm_precision)
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = energy_operand(e, mode)
    X, re = force_operand(f, mode)
    _on_root(mesh, U, X)
    out = []
    for (Us, ws, Xs, res), (p0, p1) in zip(
            shard_train_data(mesh, U, w, X, re),
            partition_points(e.m, mesh.size)):
        dev = Us.device
        if p1 == p0:
            out.append(dense(Us).new_zeros((0, 3 * f.m)))
            continue
        out.append(kef_from_ops(
            _rows(Us, p0, p1, A, -2, dev), _rows(ws, p0, p1, A, -1, dev),
            A, Xs, res, B, params, zeta, kind=kind, mm_precision=mode))
    return out
