"""Mesh-sharded blocked Cholesky factorisation.

Port of the JAX package's ``parallel/cholesky.py``: the same
right-looking blocked algorithm, one panel of ``nb`` columns per step,

    L_jj = chol(K[j, j])                      (nb x nb, on the root)
    P    = K[j+nb:, j] L_jj^-T                (panel solve, on the root)
    K[j+nb:, j+nb:] -= P P^T                  (trailing update, nearly all
                                               of the operations, SHARDED)

Each shard owns a contiguous block of rows on its own device.  Per step
the shards send their slices of the current panel column to the root,
the root factors the diagonal block and solves the panel, the panel is
copied back to the shards, and each shard applies the trailing update to
its own rows -- only to the columns up to its last row, the lower
triangle being all that later steps read.  The factor is assembled on
the root.  Plain ``torch`` throughout (``torch.linalg.cholesky_ex``,
``solve_triangular``, ``matmul``), as the JAX one is plain XLA; torch
shapes are dynamic, so the JAX version's unit-diagonal padding tail and
static column segments are not needed.
"""
from __future__ import annotations

import torch

from .mesh import Mesh

NB = 256           # panel width


def rows_per_shard(n: int, n_shards: int, nb: int = NB) -> int:
    """Rows of each shard's block: whole panels, so that a panel's
    diagonal block lies on one shard."""
    return -(-n // (nb * n_shards)) * nb


def cholesky_sharded(K: torch.Tensor, mesh: Mesh, nb: int = NB):
    """Lower Cholesky factor of the symmetric positive definite ``K``
    (on the mesh's root) with the trailing update partitioned over
    ``mesh``; the result is on the root.  Reads the lower triangle of
    ``K`` and leaves ``K`` untouched.  Raises ``torch.linalg.LinAlgError``
    when a diagonal block is not positive definite."""
    n = K.shape[0]
    root = mesh.root
    if K.device != root:
        raise ValueError(f"K lies on {K.device}, the mesh's root is {root}")
    rows_per = rows_per_shard(n, mesh.size, nb)
    # shard s: rows [r0, r1) of K on its device (a copy: updated in place)
    blocks = []
    for s, dev in enumerate(mesh.devices):
        r0, r1 = min(s * rows_per, n), min((s + 1) * rows_per, n)
        blocks.append((r0, r1, K[r0:r1].to(dev, copy=True)))
    L = torch.zeros_like(K)
    for jb in range(0, n, nb):
        je = min(jb + nb, n)
        # gather the panel column K[jb:, jb:je] on the root
        C = torch.cat([Ks[max(jb, r0) - r0:, jb:je].to(root)
                       for r0, r1, Ks in blocks if r1 > jb])
        Ljj, info = torch.linalg.cholesky_ex(C[:je - jb])
        if int(info) != 0:
            raise torch.linalg.LinAlgError(
                f"cholesky_sharded: the diagonal block at row {jb} is not "
                f"positive definite (info={int(info)})")
        L[jb:je, jb:je] = Ljj
        if je == n:
            break
        P = torch.linalg.solve_triangular(Ljj, C[je - jb:].T,
                                          upper=False).T      # rows je..n
        L[je:, jb:je] = P
        for r0, r1, Ks in blocks:
            if r1 <= je:
                continue
            lo = max(je, r0)
            Ps = P[:r1 - je].to(Ks.device)
            Ks[lo - r0:, je:r1].sub_(Ps[lo - je:] @ Ps.T)
    return L
