"""Molecular-dynamics drivers (a copy of the JAX package's ``md.py``).

The reference exposes its hybrid calculator to any ASE dynamics; this
standalone equivalent provides the integrators the on-the-fly MD/EOS
workload needs (velocity Verlet + Langevin thermostat, BAOAB), on the
host in NumPy over any calculator.  Units follow ASE conventions: eV,
Angstrom, amu; the time step is given in fs.  The random generator is an
explicit ``numpy.random.RandomState`` (``rng=``), with the JAX package's
defaults, so one seed draws the same noise in both packages.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# ASE unit system: 1 fs in sqrt(amu A^2 / eV) time units
FS = 0.09822694750253231
KB = 8.617330337217213e-05  # eV / K


def _fixed(atoms) -> np.ndarray:
    """Constrained atom ids, tolerant of foreign atoms objects (ase.Atoms
    has no fixed_indices -- every md entry point must share this guard)."""
    if hasattr(atoms, "fixed_indices"):
        return np.asarray(atoms.fixed_indices(), int)
    return np.zeros(0, int)


class VelocityVerlet:
    def __init__(self, atoms, timestep_fs: float = 1.0,
                 trajectory: Optional[str] = None):
        self.atoms = atoms
        self.dt = timestep_fs * FS
        self.masses = atoms.get_masses()[:, None]
        # preserve velocities set by maxwell_boltzmann_velocities (they
        # live in atoms.arrays); only seed zeros when absent
        if atoms.arrays.get("velocities") is None:
            atoms.arrays["velocities"] = np.zeros_like(atoms.positions)
        self._traj = None
        if trajectory:
            from .io.trajectory import TrajectoryWriter
            self._traj = TrajectoryWriter(trajectory)
        self.nsteps = 0

    @property
    def velocities(self):
        return self.atoms.arrays["velocities"]

    def kinetic_energy(self) -> float:
        v = self.velocities
        return float(0.5 * np.sum(self.masses * v * v))

    def temperature(self) -> float:
        n_fixed = len(_fixed(self.atoms))
        n_free = len(self.atoms) - n_fixed
        # COM momentum is conserved only for free dynamics without
        # constraints; a thermostat (Langevin) or FixAtoms breaks it
        com = 3 if (n_fixed == 0
                    and not isinstance(self, Langevin)) else 0
        dof = max(3 * n_free - com, 1)
        return 2 * self.kinetic_energy() / (dof * KB)

    def run(self, steps: int):
        atoms = self.atoms
        f = atoms.get_forces()
        fixed = _fixed(atoms)
        for _ in range(steps):
            v = self.velocities
            v += 0.5 * self.dt * f / self.masses
            if len(fixed):
                v[fixed] = 0.0
            atoms.set_positions(atoms.positions + self.dt * v)
            f = atoms.get_forces()
            v += 0.5 * self.dt * f / self.masses
            if len(fixed):
                v[fixed] = 0.0
            self.nsteps += 1
            if self._traj is not None:
                self._traj.write(atoms)
        return self


class Langevin(VelocityVerlet):
    """BAOAB-splitting Langevin thermostat."""

    def __init__(self, atoms, timestep_fs: float = 1.0,
                 temperature_K: float = 300.0, friction: float = 0.02,
                 rng: Optional[np.random.RandomState] = None, **kwargs):
        super().__init__(atoms, timestep_fs, **kwargs)
        self.kT = KB * temperature_K
        self.friction = friction
        self.rng = rng or np.random.RandomState(42)

    def run(self, steps: int):
        atoms = self.atoms
        f = atoms.get_forces()
        fixed = _fixed(atoms)
        c1 = np.exp(-self.friction * self.dt)
        c2 = np.sqrt((1 - c1 ** 2) * self.kT / self.masses)
        for _ in range(steps):
            v = self.velocities
            v += 0.5 * self.dt * f / self.masses
            if len(fixed):
                v[fixed] = 0.0          # before the A-drift, not after it
            atoms.set_positions(atoms.positions + 0.5 * self.dt * v)
            noise = self.rng.randn(*v.shape)
            if len(fixed):
                noise[fixed] = 0.0      # O-step must not kick fixed atoms
            v[:] = c1 * v + c2 * noise
            atoms.set_positions(atoms.positions + 0.5 * self.dt * v)
            f = atoms.get_forces()
            v += 0.5 * self.dt * f / self.masses
            if len(fixed):
                v[fixed] = 0.0
            self.nsteps += 1
            if self._traj is not None:
                self._traj.write(atoms)
        return self


def maxwell_boltzmann_velocities(atoms, temperature_K: float,
                                 rng=None) -> np.ndarray:
    rng = rng or np.random.RandomState(0)
    m = atoms.get_masses()[:, None]
    v = rng.randn(len(atoms), 3) * np.sqrt(KB * temperature_K / m)
    # remove the CENTER-OF-MASS momentum (mass-weighted -- a plain mean
    # leaves net momentum for mixed-mass systems and the cell drifts)
    v -= (m * v).sum(axis=0) / m.sum()
    fixed = _fixed(atoms)
    if len(fixed):
        v[fixed] = 0.0
    atoms.arrays["velocities"] = v
    return v


def equation_of_state(atoms, calc, scales=None):
    """E(V) sweep (the EOS workload): returns (volumes, energies)."""
    if scales is None:
        scales = np.linspace(0.95, 1.05, 7)
    cell0 = np.asarray(atoms.cell)
    pos0 = atoms.positions.copy()
    vols, engs = [], []
    for s in scales:
        a = atoms.copy()
        a.set_cell(cell0 * s)
        # affine cell scaling: constraints must not pin FixAtoms rows at
        # their unscaled coordinates
        a.set_positions(pos0 * s, apply_constraint=False)
        a.calc = calc
        vols.append(a.get_volume())
        engs.append(a.get_potential_energy())
    return np.asarray(vols), np.asarray(engs)
