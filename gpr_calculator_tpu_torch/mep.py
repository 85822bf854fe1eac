"""Nudged elastic band implementation (standalone, NumPy).

Port of the JAX package's ``mep.py``, itself the equivalent of ase.mep.NEB
as the reference uses it (gpr_calc/NEB.py:36-60): improved-tangent
NEB (Henkelman & Jonsson 2000) with optional climbing image, linear and
IDPP interpolation.  Operates on the port's Atoms or ase.Atoms.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def find_mic(d, cell, pbc):
    """Minimum-image convention displacement(s) for (possibly) periodic
    cells (simple orthogonalised search over neighbour images)."""
    d = np.asarray(d, float)
    cell = np.asarray(cell, float)
    if cell.shape != (3, 3) or not np.any(pbc) or abs(
            np.linalg.det(cell)) < 1e-12:
        return d, np.linalg.norm(d, axis=-1)
    inv = np.linalg.inv(cell)
    frac = d @ inv
    for i in range(3):
        if pbc[i]:
            frac[..., i] -= np.round(frac[..., i])
    dm = frac @ cell
    # per-axis fractional rounding is the exact minimum image only for
    # orthogonal cells; in a skewed cell the nearest image can need a
    # combined +/-1 shift across axes (ase.geometry.find_mic runs a
    # full image search for this reason).  Refine over the neighbour
    # images of the rounded solution on the periodic axes.
    gram = cell @ cell.T
    off = np.abs(gram - np.diag(np.diag(gram))).max()
    if off > 1e-10 * np.abs(gram).max():
        # +/-1 covers every Lagrange/Minkowski-reduced cell; for strongly
        # skewed non-reduced cells (a row's projection onto another
        # exceeding half its length) the true minimum image can need a
        # wider shift, so widen the window adaptively instead of assuming
        # reduction (ASE runs a full image search for the same reason).
        diag = np.diag(gram)
        skew = np.abs(gram - np.diag(diag)) > 0.5 * np.minimum(
            diag[:, None], diag[None, :])
        width = 2.0 if skew.any() else 1.0
        ranges = [tuple(np.arange(-width, width + 1)) if pbc[i] else (0.0,)
                  for i in range(3)]
        shifts = np.array([[a, b, c] for a in ranges[0]
                           for b in ranges[1] for c in ranges[2]]) @ cell
        cand = dm[..., None, :] + shifts             # (..., S, 3)
        norms = np.linalg.norm(cand, axis=-1)
        best = np.argmin(norms, axis=-1)
        dm = np.take_along_axis(
            cand, best[..., None, None], axis=-2)[..., 0, :]
    return dm, np.linalg.norm(dm, axis=-1)


class NEB:
    def __init__(self, images: List, k: float = 0.1, climb: bool = False,
                 parallel: bool = False, remove_rotation_and_translation:
                 bool = False):
        self.images = images
        self.nimages = len(images)
        self.natoms = len(images[0])
        if np.isscalar(k):
            k = [k] * (self.nimages - 1)
        self.k = list(k)
        self.climb = climb
        self.energies = np.full(self.nimages, np.nan)
        self.nsteps = 0
        self.converged_ = False

    # -- optimizer protocol over interior images -----------------------------
    def get_positions(self) -> np.ndarray:
        return np.vstack([im.positions for im in self.images[1:-1]])

    def set_positions(self, positions):
        n = self.natoms
        for i, im in enumerate(self.images[1:-1]):
            im.set_positions(positions[i * n:(i + 1) * n])

    def get_potential_energy(self) -> float:
        """Max interior energy (what a NEB optimizer logs)."""
        vals = self.energies[1:-1]
        vals = vals[np.isfinite(vals)]
        return float(vals.max()) if len(vals) else float("nan")

    def interpolate(self, method: str = "linear", mic: bool = False,
                    apply_constraint: bool = False):
        first, last = self.images[0], self.images[-1]
        d = last.positions - first.positions
        if mic:
            d, _ = find_mic(d, first.get_cell(), first.pbc)
        for i in range(1, self.nimages - 1):
            t = i / (self.nimages - 1)
            # honor the caller's flag (ASE parity: NEB.interpolate
            # defaults to apply_constraint=False); set_positions would
            # otherwise clamp fixed rows unconditionally
            self.images[i].set_positions(first.positions + t * d,
                                         apply_constraint=apply_constraint)
        if method == "idpp":
            self._idpp_interpolate(mic=mic)

    def _idpp_interpolate(self, mic: bool = False, fmax: float = 0.01,
                          steps: int = 200):
        """Image-dependent pair potential refinement (Smidstrup et al.,
        JCP 140, 214106 (2014)): relax images against interpolated pair
        distances."""
        from .optimize import FIRE

        first, last = self.images[0], self.images[-1]
        d0, _ = (find_mic(first.positions[:, None] - first.positions[None],
                          first.get_cell(), first.pbc)
                 if mic else (first.positions[:, None]
                              - first.positions[None], None))
        dv0 = np.linalg.norm(d0, axis=-1)
        d1 = (last.positions[:, None] - last.positions[None])
        if mic:
            d1, _ = find_mic(d1, last.get_cell(), last.pbc)
        dv1 = np.linalg.norm(d1, axis=-1)

        neb2 = NEB([im.copy() for im in self.images], k=self.k)

        class _IDPPCalc:
            def __init__(self, target):
                self.target = target
                self.results = {}

            def get_potential_energy(self, atoms):
                return self._ef(atoms)[0]

            def get_forces(self, atoms):
                return self._ef(atoms)[1]

            def _ef(self, atoms):
                d = atoms.positions[:, None] - atoms.positions[None]
                if mic:
                    d, _ = find_mic(d, atoms.get_cell(), atoms.pbc)
                r = np.linalg.norm(d, axis=-1)
                np.fill_diagonal(r, 1.0)
                w = 1.0 / r ** 4
                dd = r - self.target
                np.fill_diagonal(dd, 0.0)
                e = 0.5 * (w * dd ** 2).sum()
                # F_i = -dE/dr_i; each unordered pair contributes twice
                # through the full matrix (rows + columns)
                pref = w * dd * (1.0 - 2.0 * dd / r) / r
                f = -2.0 * np.einsum("ij,ijk->ik", pref, d)
                return e, f

        for i, im in enumerate(neb2.images[1:-1], start=1):
            t = i / (self.nimages - 1)
            im.calc = _IDPPCalc(dv0 * (1 - t) + dv1 * t)
        neb2.images[0].calc = _IDPPCalc(dv0)
        neb2.images[-1].calc = _IDPPCalc(dv1)
        opt = FIRE(neb2, verbose=False)
        opt.run(fmax=fmax, steps=steps)
        for im, im2 in zip(self.images[1:-1], neb2.images[1:-1]):
            im.set_positions(im2.positions)

    def _interior_results(self):
        """Energies and true forces of the interior images (hook: the
        batched on-the-fly evaluator overrides this to compute every
        image in one device program)."""
        energies = []
        forces = []
        for image in self.images[1:-1]:
            forces.append(image.get_forces())
            energies.append(image.get_potential_energy())
        return energies, forces

    # -- NEB forces -----------------------------------------------------------
    def get_forces(self) -> np.ndarray:
        images = self.images
        n = self.nimages
        energies = np.empty(n)
        real_forces = [None] * n

        # endpoints: energy only (once)
        for i in (0, n - 1):
            if not np.isfinite(self.energies[i]):
                energies[i] = images[i].get_potential_energy()
            else:
                energies[i] = self.energies[i]
        e_int, f_int = self._interior_results()
        for i in range(1, n - 1):
            real_forces[i] = f_int[i - 1]
            energies[i] = e_int[i - 1]
        self.energies = energies.copy()

        imax = int(np.argmax(energies[1:-1])) + 1
        self.imax = imax
        self.emax = energies[imax]

        cell = images[0].get_cell()
        pbc = images[0].pbc
        forces_out = np.zeros((n - 2, self.natoms, 3))
        for i in range(1, n - 1):
            dp, _ = find_mic(images[i + 1].positions - images[i].positions,
                             cell, pbc)
            dm, _ = find_mic(images[i].positions - images[i - 1].positions,
                             cell, pbc)
            E0, E, E1 = energies[i - 1], energies[i], energies[i + 1]
            # improved tangent (Henkelman & Jonsson 2000 eq. 8-11)
            if E1 > E > E0:
                tangent = dp.copy()
            elif E1 < E < E0:
                tangent = dm.copy()
            else:
                dEmax = max(abs(E1 - E), abs(E0 - E))
                dEmin = min(abs(E1 - E), abs(E0 - E))
                if E1 > E0:
                    tangent = dp * dEmax + dm * dEmin
                else:
                    tangent = dp * dEmin + dm * dEmax
            tt = np.vdot(tangent, tangent)
            if tt < 1e-30:
                tangent = dp
                tt = np.vdot(tangent, tangent)
            that = tangent / np.sqrt(tt)

            f = real_forces[i]
            f_par = np.vdot(f, that)
            if self.climb and i == imax:
                forces_out[i - 1] = f - 2.0 * f_par * that
            else:
                f_spring = (self.k[i] * np.linalg.norm(dp.reshape(-1))
                            - self.k[i - 1] * np.linalg.norm(dm.reshape(-1)))
                forces_out[i - 1] = (f - f_par * that + f_spring * that)

        return forces_out.reshape(-1, 3)
