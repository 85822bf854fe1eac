"""Surrogate-vs-base dispatch policy -- the single source of truth.

Mirrors the reference's hybrid-calculator block (gpr_calc/calculator.py:
60-122): uncertainty tolerances, base fallback with constraint-aware force
zeroing, the "From Base model"/"From Surrogate" log-line protocol, and the
refit cadence with autosave and the training-error gate.  Both the
per-image GPR calculator (calculator.py) and the batched NEB driver
(neb.py) delegate here so the two paths cannot drift.
"""
from __future__ import annotations

import numpy as np


class DispatchPolicy:
    """Policy + bookkeeping shared by every on-the-fly driver."""

    def __init__(self, gp, base, freq: int = 10, opt_freq: int = 1,
                 save: bool = True, tag: str = "GPR", verbose: bool = True,
                 ignore_E_std: bool = True):
        self.gp = gp
        self.base = base
        self.freq = freq
        self.opt_freq = opt_freq
        self.save = save
        self.tag = tag
        self.verbose = verbose
        self.ignore_E_std = ignore_E_std

    # -- tolerance test (calculator.py:64-74) -------------------------------
    def tolerances(self, natoms: int):
        if self.ignore_E_std:
            e_tol = 100.0
        else:
            e_tol = 1.2 * natoms * self.gp.noise_e
        return e_tol, 1.2 * self.gp.noise_f

    def force_reference(self, natoms: int, F) -> float:
        """The bound every force sigma must stay under."""
        f_tol = self.tolerances(natoms)[1]
        return max(f_tol, float(np.abs(F).max()) / 2.5)   # calculator.py:72

    def needs_base(self, natoms: int, F, E_std_total: float, F_std) -> bool:
        e_tol = self.tolerances(natoms)[0]
        E_fail = float(E_std_total) > e_tol
        force_fail = not (np.asarray(F_std)
                          < self.force_reference(natoms, F)).all()
        return E_fail or force_fail

    # -- base fallback (calculator.py:79-99) --------------------------------
    def evaluate_base(self, atoms):
        """Run the base calculator on ``atoms``; returns (energy, forces)
        with constrained rows zeroed.  Grows the training set with the
        RAW (unconstrained) forces: constraint-zeroed rows are dynamics
        bookkeeping, not physics -- training on them would give
        fixed-atom environments the label 0 (and, after add_structure's
        base-potential subtraction, -f_base), corrupting the model."""
        fix_ids = (atoms.fixed_indices()
                   if hasattr(atoms, "fixed_indices") else [])
        prev_calc = getattr(atoms, "calc", None)
        atoms.calc = self.base
        try:
            eng = atoms.get_potential_energy()
            try:
                raw = np.array(atoms.get_forces(apply_constraint=False),
                               float)
            except TypeError:     # calculator facade without the kwarg
                raw = np.array(atoms.get_forces(), float)
        finally:
            # an exception from the base evaluation must not leave the
            # base calculator attached (every later step would silently
            # bypass the GPR dispatcher)
            atoms.calc = prev_calc
        forces = raw.copy()
        if len(fix_ids):
            forces[np.asarray(fix_ids, int)] = 0.0
        self.gp.use_base += 1
        self.gp.add_structure((atoms.copy(), eng, raw))
        return eng, forces

    # -- log-line protocol (parse-compatible with the reference) ------------
    def log_base(self, E_std, E_surrogate, E_base, F_std_max, Fmax_surrogate,
                 Fmax_base):
        if self.verbose:
            print(f"From Base model E: {float(E_std):.3f}/"
                  f"{float(E_surrogate):.3f}/{float(E_base):.3f}, "
                  f"F: {float(F_std_max):.3f}/{float(Fmax_surrogate):.3f}/"
                  f"{float(Fmax_base):.3f}")

    def log_surrogate(self, E_std, e_tol, E, F_std_max, f_tol, Fmax):
        if self.verbose:
            print(f"From Surrogate  E: {float(E_std):.3f}/"
                  f"{float(e_tol):.3f}/{float(E):.3f}, "
                  f"F: {float(F_std_max):.3f}/{float(f_tol):.3f}/"
                  f"{float(Fmax):.3f}")

    # -- refit cadence + autosave + error gate (calculator.py:101-122) ------
    def refit_if_due(self):
        gp = self.gp
        freq = (max(2, self.freq // 2) if gp.N_forces > 100
                else self.freq)
        if not (gp.N_queue > freq or gp.N_energy_queue >= 2):
            return False
        do_opt = self.opt_freq <= 1 or gp.fits % self.opt_freq == 0
        gp.fit(opt=do_opt, show=False, maxiter=10)
        if self.save:
            gp.save(f"{self.tag}-gpr.json", f"{self.tag}-gpr.db",
                    verbose=False)
            print(gp)
        gp.validate_data(show=True)
        if (gp.error["energy_mae"] > 0.1
                or gp.error["forces_mae"] > 0.3):
            raise RuntimeError(
                "GPR training error is too large "
                f"({gp.error}); check the data")
        return True
