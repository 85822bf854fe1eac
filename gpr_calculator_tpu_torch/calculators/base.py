"""Minimal calculator protocol (ASE-compatible surface).

Calculators cache results per (positions, cell) fingerprint and work with
both our Atoms and ase.Atoms objects.
"""
from __future__ import annotations

import numpy as np


class Calculator:
    name = "calculator"
    implemented_properties = ["energy", "forces"]

    def __init__(self, **kwargs):
        self.results = {}
        self.parameters = _Parameters(kwargs)
        self._fingerprint = None

    # -- ASE-style entry points ---------------------------------------------
    def get_potential_energy(self, atoms=None, force_consistent=False):
        self._update(atoms)
        return self.results["energy"]

    def get_forces(self, atoms=None):
        self._update(atoms)
        return self.results["forces"].copy()

    def get_stress(self, atoms=None):
        self._update(atoms)
        return self.results.get("stress")

    def _update(self, atoms):
        fp = None
        if atoms is not None:
            fp = (atoms.positions.tobytes(),
                  np.asarray(atoms.cell).tobytes(),
                  np.asarray(atoms.pbc).tobytes(),
                  np.asarray(atoms.numbers).tobytes())
        if not self.results or (fp is not None and fp != self._fingerprint):
            self.calculate(atoms)
            self._fingerprint = fp

    def calculate(self, atoms=None, properties=("energy", "forces"),
                  system_changes=None):
        raise NotImplementedError


class _Parameters(dict):
    """Attribute-style access like ase's Parameters object."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key, value):
        self[key] = value
