"""Pairwise Lennard-Jones base potential.

A copy of the JAX package's ``calculators/lj.py`` (NumPy).
Behavioural parity with the reference's LJ (gpr_calc/calculator.py:183-292):
``calculate(atoms)`` returns the (energy, forces, stress) tuple used by
GP.compute_base_potential, with the truncated-and-shifted form
4 eps ((s/r)^12 - (s/r)^6) - e0 inside rc.
"""
from __future__ import annotations

import numpy as np

from ..atoms.neighborlist import neighbor_pairs
from .base import Calculator


def full_3x3_to_voigt_6_stress(stresses):
    s = stresses
    return np.stack([
        s[..., 0, 0], s[..., 1, 1], s[..., 2, 2],
        0.5 * (s[..., 1, 2] + s[..., 2, 1]),
        0.5 * (s[..., 0, 2] + s[..., 2, 0]),
        0.5 * (s[..., 0, 1] + s[..., 1, 0])], axis=-1)


class LJ:
    def __init__(self, parameters=None):
        p = {"name": "LJ", "rc": 5.0, "sigma": 1.0, "epsilon": 1.0}
        if parameters is not None:
            p.update(parameters)
        self.load_from_dict(p)

    def __str__(self):
        return "LJ(eps: {:.3f}, sigma: {:.3f}, cutoff: {:.3f})".format(
            self.epsilon, self.sigma, self.rc)

    def load_from_dict(self, d):
        self._parameters = d
        self.name = d["name"]
        self.epsilon = d["epsilon"]
        self.sigma = d["sigma"]
        self.rc = d["rc"]

    def save_dict(self):
        return self._parameters

    def calculate(self, atoms):
        sigma, epsilon, rc = self.sigma, self.epsilon, self.rc
        natoms = len(atoms)
        e0 = 4 * epsilon * ((sigma / rc) ** 12 - (sigma / rc) ** 6)

        energies = np.zeros(natoms)
        forces = np.zeros((natoms, 3))
        stresses = np.zeros((natoms, 3, 3))

        pi, pj, rij = neighbor_pairs(atoms, rc)   # both directions
        if len(pi):
            r2 = np.sum(rij * rij, axis=1)
            c6 = (sigma ** 2 / r2) ** 3
            c6[r2 > rc ** 2] = 0.0
            c12 = c6 ** 2
            pe = 4 * epsilon * (c12 - c6) - e0 * (c6 != 0.0)
            pf = (-24 * epsilon * (2 * c12 - c6) / r2)[:, None] * rij
            np.add.at(energies, pi, 0.5 * pe)
            np.add.at(forces, pi, pf)
            st = 0.5 * pf[:, :, None] * rij[:, None, :]
            np.add.at(stresses, pi, st)

        if getattr(atoms, "number_of_lattice_vectors", 0) == 3:
            stress = (full_3x3_to_voigt_6_stress(stresses)
                      / atoms.get_volume())
        else:
            stress = None
        return energies.sum(), forces, stress


class LennardJones(Calculator):
    """ASE-style calculator facade over LJ (usable as a dispatcher base
    calculator for species outside the EMT parameter table)."""
    name = "lj"
    implemented_properties = ["energy", "forces", "stress"]

    def __init__(self, parameters=None, **kwargs):
        super().__init__(**kwargs)
        self._lj = LJ(parameters)

    def calculate(self, atoms=None, properties=("energy", "forces"),
                  system_changes=None):
        energy, forces, stress = self._lj.calculate(atoms)
        self.results = {"energy": energy, "forces": forces,
                        "stress": stress}
