"""Au on Al(100), the upstream emt-serial example's NEB system, made in
code: a 2x2x3 Al fcc(100) slab (a = 4.05 A, periodic in x and y, 4 A of
vacuum on each side in z, the bottom two layers fixed) with an Au adatom
1.7 A above a four-fold hollow; the final state moves the Au by half a
cell vector to the next hollow, and the images interpolate linearly."""
from __future__ import annotations

import numpy as np


def au_on_al100(n_images: int = 5, a: float = 4.05, height: float = 1.7):
    """(list of image positions (13, 3), numbers (13,), cell (3, 3), pbc
    (3,), fixed atom indices)."""
    s = a / np.sqrt(2.0)
    pos, layer = [], []
    for k in range(3):
        off = 0.5 if k % 2 else 0.0
        for j in range(2):
            for i in range(2):
                pos.append([(i + off) * s, (j + off) * s, 4.0 + k * a / 2.0])
                layer.append(k)
    pos, layer = np.asarray(pos), np.asarray(layer)
    cell = np.diag([2 * s, 2 * s, a + 8.0])
    initial = np.vstack([pos, [[0.5 * s, 0.5 * s, pos[:, 2].max() + height]]])
    final = initial.copy()
    final[-1, 0] += 0.5 * cell[0, 0]
    images = [(1.0 - t) * initial + t * final
              for t in np.linspace(0.0, 1.0, n_images)]
    numbers = np.array([13] * len(pos) + [79])
    return (images, numbers, cell, np.array([True, True, False]),
            np.flatnonzero(layer < 2))


BUILDERS = {"au_on_al100": au_on_al100}
