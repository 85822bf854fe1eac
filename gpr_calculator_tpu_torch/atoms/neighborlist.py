"""Neighbour-pair construction for descriptor evaluation.

Semantics mirror the reference's use of ase.neighborlist.NeighborList with
cutoffs = rcut/2, self_interaction=False, bothways=True, skin=0
(gpr_calc/SO3.py:348-407): all (i, j, image) pairs with
0 < |r_j + S.cell - r_i| < rcut, including periodic self-images.

A native C++ backend (native/neighbor.cpp) is used when available; the
NumPy fallback is fully vectorised over images.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..native import get_lib


def neighbor_pairs(atoms, rcut: float) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Return (i, j, rij) arrays for every pair within rcut."""
    positions = np.ascontiguousarray(atoms.positions, dtype=float)
    cell = np.ascontiguousarray(np.asarray(atoms.cell), dtype=float)
    pbc = np.asarray(atoms.pbc, dtype=bool)
    if cell.shape != (3, 3):
        cell = np.zeros((3, 3))
        pbc = np.zeros(3, dtype=bool)

    # wrap positions into the cell on periodic axes: both backends
    # derive their image search range from ceil(rcut/height), which
    # assumes in-cell coordinates -- an atom drifted ~a cell outside
    # (long MD/NEB trajectories) would silently lose ALL its periodic
    # pairs.  Wrapping changes nothing physical (pair vectors are
    # min-image relative displacements).
    if np.any(pbc) and abs(np.linalg.det(cell)) > 1e-12:
        frac = positions @ np.linalg.inv(cell)
        for k in range(3):
            if pbc[k]:
                frac[:, k] -= np.floor(frac[:, k])
        positions = np.ascontiguousarray(frac @ cell)

    lib = get_lib()
    if lib is not None:
        return _native_pairs(lib, positions, cell, pbc, rcut)
    return _numpy_pairs(positions, cell, pbc, rcut)


def _native_pairs(lib, positions, cell, pbc, rcut):
    n = len(positions)
    cap = max(64, n * 60)
    pbc_i = np.ascontiguousarray(pbc.astype(np.int32))
    for _ in range(8):
        out_i = np.empty(cap, np.int64)
        out_j = np.empty(cap, np.int64)
        out_r = np.empty((cap, 3), np.float64)
        got = lib.neighbor_build(
            n,
            positions.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cell.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            pbc_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            float(rcut), cap,
            out_i.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            out_r.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if got <= cap:
            order = np.lexsort((out_j[:got], out_i[:got]))
            return out_i[:got][order], out_j[:got][order], out_r[:got][order]
        cap = int(got) + 64
    raise RuntimeError("neighbor_build capacity loop failed")


def _numpy_pairs(positions, cell, pbc, rcut):
    n = len(positions)
    # image ranges from perpendicular heights
    nimg = np.zeros(3, int)
    vol = abs(np.linalg.det(cell))
    for k in range(3):
        if not pbc[k] or vol == 0:
            continue
        cross = np.cross(cell[(k + 1) % 3], cell[(k + 2) % 3])
        h = vol / np.linalg.norm(cross)
        nimg[k] = int(np.ceil(rcut / h))
    shifts = np.array([[a, b, c]
                       for a in range(-nimg[0], nimg[0] + 1)
                       for b in range(-nimg[1], nimg[1] + 1)
                       for c in range(-nimg[2], nimg[2] + 1)], float)
    offsets = shifts @ cell                                  # (S, 3)
    # chunk the (S, chunk, n, 3) displacement tensor over the center
    # axis: the full (S, n, n, 3) form is images*natoms^2 memory
    # (~10 GB at 4000 atoms / 27 images) -- the NumPy fallback must
    # stay usable where the native builder is absent
    S = len(offsets)
    budget = 64 * 1024 * 1024            # f64 elements per chunk block
    chunk = max(1, min(n, int(budget // max(S * n * 3, 1))))
    # seed with empties: n == 0 produces no chunks, and bare
    # np.concatenate([]) raises
    outs_i = [np.zeros(0, np.intp)]
    outs_j = [np.zeros(0, np.intp)]
    outs_r = [np.zeros((0, 3), float)]
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        # rij[s, i-lo, j] = r_j + off_s - r_i
        rij = (positions[None, None, :, :] + offsets[:, None, None, :]
               - positions[None, lo:hi, None, :])
        d2 = np.sum(rij * rij, axis=-1)
        mask = (d2 < rcut * rcut) & (d2 > 1e-20)
        s_idx, i_idx, j_idx = np.nonzero(mask)
        outs_i.append(i_idx + lo)
        outs_j.append(j_idx)
        outs_r.append(rij[s_idx, i_idx, j_idx])
    i_idx = np.concatenate(outs_i)
    j_idx = np.concatenate(outs_j)
    rvecs = np.concatenate(outs_r)
    order = np.lexsort((j_idx, i_idx))
    return i_idx[order], j_idx[order], rvecs[order]
