"""NumPy neighbour list: every (i, j, image) pair with 0 < |r_j + S.cell
- r_i| < rcut, periodic self-images included, sorted by (i, j) (the
semantics of ase.neighborlist with bothways=True and no skin, which the
upstream SO3 descriptor uses)."""
from __future__ import annotations

import numpy as np


def neighbor_pairs(positions, cell, pbc, rcut: float):
    """(i, j, rij) arrays of every pair within rcut."""
    positions = np.asarray(positions, float)
    cell = np.asarray(cell, float)
    pbc = np.asarray(pbc, bool)
    vol = abs(np.linalg.det(cell))
    if np.any(pbc) and vol > 1e-12:
        # periodic axes wrapped into the cell: the image range below
        # assumes in-cell coordinates
        frac = positions @ np.linalg.inv(cell)
        frac[:, pbc] -= np.floor(frac[:, pbc])
        positions = frac @ cell
    nimg = np.zeros(3, int)
    for k in range(3):
        if pbc[k] and vol > 1e-12:
            h = vol / np.linalg.norm(np.cross(cell[(k + 1) % 3],
                                              cell[(k + 2) % 3]))
            nimg[k] = int(np.ceil(rcut / h))
    shifts = np.array([[a, b, c]
                       for a in range(-nimg[0], nimg[0] + 1)
                       for b in range(-nimg[1], nimg[1] + 1)
                       for c in range(-nimg[2], nimg[2] + 1)], float)
    offsets = shifts @ cell
    rij = (positions[None, None, :, :] + offsets[:, None, None, :]
           - positions[None, :, None, :])
    d2 = np.sum(rij * rij, axis=-1)
    s, i, j = np.nonzero((d2 < rcut * rcut) & (d2 > 1e-20))
    order = np.lexsort((j, i))
    return i[order], j[order], rij[s, i, j][order]
