"""Constraints (the reference only ever uses FixAtoms,
gpr_calc/calculator.py:51-55, gaussianprocess.py:823-832)."""
from __future__ import annotations

import numpy as np


class FixAtoms:
    def __init__(self, indices=None, mask=None):
        if mask is not None:
            indices = np.nonzero(np.asarray(mask, bool))[0]
        self.index = np.asarray(indices if indices is not None else [],
                                dtype=int)

    def get_indices(self):
        return self.index

    def adjust_forces(self, atoms, forces):
        forces[self.index] = 0.0

    def adjust_positions(self, atoms, newpositions):
        newpositions[self.index] = atoms.positions[self.index]

    def todict(self):
        return {"name": "FixAtoms", "kwargs": {"indices":
                                               self.index.tolist()}}


def all_fixed_indices(atoms):
    """Union of FixAtoms indices from OUR Atoms or a real ase.Atoms
    (io writers and dispatchers must not depend on the custom
    fixed_indices() method -- ase.Atoms lacks it, and multiple FixAtoms
    entries must all be honored)."""
    idx = []
    for c in getattr(atoms, "constraints", None) or []:
        if type(c).__name__ == "FixAtoms":
            getter = getattr(c, "get_indices", None)
            ind = getter() if getter is not None else getattr(c, "index",
                                                              [])
            idx.extend(int(i) for i in np.asarray(ind).ravel())
    if not idx:
        return np.zeros(0, dtype=int)
    return np.unique(np.asarray(idx, dtype=int))
