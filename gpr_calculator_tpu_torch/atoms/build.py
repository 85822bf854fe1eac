"""Structure builders for the port's fixtures, made in code (no files).

``au_on_al100_images`` is the reference's headline NEB system: an Au
adatom hopping between neighbouring four-fold hollows of an Al(100)
slab (13 atoms).
"""
from __future__ import annotations

import numpy as np

from .atoms import Atoms
from .constraints import FixAtoms


def fcc100_positions(a: float, size, vacuum: float):
    """Atom positions and cell of an fcc(100) slab, ``size`` = (nx, ny,
    layers), layers stacked bottom-up along z with ``vacuum`` on each
    side.  Returns (positions (n, 3), cell (3, 3), layer index (n,))."""
    nx, ny, nz = size
    s = a / np.sqrt(2.0)          # surface nearest-neighbour distance
    dz = a / 2.0                  # (100) interlayer spacing
    pos, layer = [], []
    for k in range(nz):
        off = 0.5 if k % 2 else 0.0
        for j in range(ny):
            for i in range(nx):
                pos.append([(i + off) * s, (j + off) * s, vacuum + k * dz])
                layer.append(k)
    cell = np.diag([nx * s, ny * s, (nz - 1) * dz + 2.0 * vacuum])
    return np.asarray(pos), cell, np.asarray(layer)


def au_on_al100_images(n_images: int = 5, a: float = 4.05,
                       height: float = 1.7):
    """Au on Al(100): a 2x2x3 Al slab (periodic in x and y, 4 A vacuum
    on each side in z, bottom two layers fixed) with an Au adatom in a
    four-fold hollow ``height`` above the surface; the final state moves
    the Au by half a cell vector to the next hollow.  Returns
    ``n_images`` images by linear interpolation, end points included."""
    pos, cell, layer = fcc100_positions(a, (2, 2, 3), vacuum=4.0)
    s = a / np.sqrt(2.0)
    top = pos[:, 2].max()
    initial = np.vstack([pos, [[0.5 * s, 0.5 * s, top + height]]])
    final = initial.copy()
    final[-1, 0] += 0.5 * cell[0, 0]
    fixed = np.flatnonzero(layer < 2)
    images = []
    for t in np.linspace(0.0, 1.0, n_images):
        images.append(Atoms(symbols=["Al"] * len(pos) + ["Au"],
                            positions=(1.0 - t) * initial + t * final,
                            cell=cell, pbc=[True, True, False],
                            constraints=[FixAtoms(indices=fixed)]))
    return images
