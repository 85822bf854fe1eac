"""Hybrid on-the-fly GPR calculator (the dispatcher).

Behavioural parity with gpr_calc/calculator.py:10-181: predict with
uncertainty, compare against tolerances, answer from the surrogate or call
the base calculator, grow the training set, refit on the queue schedule,
and gate on training error.  The MPI position broadcasts (calculator.py:
58-59) are unnecessary here -- there is a single host program; device-level
parallelism lives inside the jitted kernels.
"""
from __future__ import annotations


import numpy as np

from .calculators.base import Calculator


class GPR(Calculator):
    name = "gpr"
    implemented_properties = ["energy", "forces", "stress", "var_e", "var_f"]
    nolabel = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.results = {}
        self.force_base = False
        self.allow_base = True
        self.update_gpr = True
        self.verbose = True
        self.ignore_E_std = True
        self.tag = self.parameters.get("tag", "GPR")
        self.freq = self.parameters.get("freq", 10)
        self.save = self.parameters.get("save", True)
        # opt_freq > 1: re-optimise hyperparameters only every k-th refit;
        # the other refits extend the factor by the appended rows at the
        # current hyperparameters (fit(opt=False), an incremental rank-k
        # update).
        # Default 1 reproduces the reference behaviour (opt=True every
        # refit, calculator.py:104).
        self.opt_freq = self.parameters.get("opt_freq", 1)

    def __copy__(self):
        new = GPR(**dict(self.parameters))
        new.force_base = self.force_base
        new.allow_base = self.allow_base
        new.update_gpr = self.update_gpr
        new.ignore_E_std = self.ignore_E_std
        new.verbose = self.verbose
        return new

    def freeze(self):
        """Disable base-calculator fallback AND refits (NEB endpoint /
        reporting mode, calculator.py:40-46).  freeze/unfreeze nest: the
        outermost unfreeze() restores the calculator's pre-freeze
        allow_base/update_gpr (per-image NEB copies only update the GP on
        image 1, and reporting helpers like neb.plot_progress pair their
        own freeze/unfreeze -- an unconditional restore-to-True would
        silently unfreeze a calculator the caller had frozen)."""
        depth = getattr(self, "_freeze_depth", 0)
        if depth == 0:
            self._frozen_state = (self.allow_base, self.update_gpr)
            self.allow_base = False
            self.update_gpr = False
        self._freeze_depth = depth + 1

    def unfreeze(self):
        depth = getattr(self, "_freeze_depth", 0)
        if depth > 1:
            self._freeze_depth = depth - 1
            return
        self._freeze_depth = 0
        self.allow_base, self.update_gpr = getattr(
            self, "_frozen_state", (True, True))

    def _policy(self):
        from .dispatch import DispatchPolicy
        return DispatchPolicy(
            self.parameters.ff, self.parameters.base, freq=self.freq,
            opt_freq=self.opt_freq, save=self.save, tag=self.tag,
            verbose=self.verbose, ignore_E_std=self.ignore_E_std)

    def calculate(self, atoms=None, properties=("energy", "forces"),
                  system_changes=None):
        gp_model = self.parameters.ff
        self._calculate(atoms, properties)
        policy = self._policy()

        e_tol, f_tol = policy.tolerances(len(atoms))
        E_std = self.results["var_e"] * len(atoms)
        F_std = self.results["var_f"].max()
        E = self.results["energy"]
        Fmax = np.abs(self.results["forces"]).max()
        need_base = policy.needs_base(len(atoms), self.results["forces"],
                                      E_std, self.results["var_f"])

        if self.force_base or (self.allow_base and need_base):
            eng, forces = policy.evaluate_base(atoms)
            policy.log_base(E_std, E, eng, F_std, Fmax,
                            np.abs(forces).max())
            self.results["energy"] = eng
            self.results["free_energy"] = eng
            self.results["forces"] = forces
        else:
            gp_model.use_surrogate += 1
            policy.log_surrogate(E_std, e_tol, E, F_std, f_tol, Fmax)

        if self.update_gpr:
            policy.refit_if_due()

    def _calculate(self, atoms, properties=("energy", "forces")):
        stress = self.parameters.get("stress", False)
        f_tol = self.parameters.get("f_tol", 1e-12)
        # the dispatcher's uncertainty gate REQUIRES std -- a
        # return_std=False parameter (accepted for API parity) must not
        # skip it, or calculate() would KeyError on var_e
        res = self.parameters.ff.predict_structure(
            atoms, stress, return_std=True, f_tol=f_tol)
        self.results["var_e"] = res[3]
        self.results["var_f"] = res[4]
        self.results["energy"] = res[0]
        self.results["free_energy"] = res[0]
        self.results["forces"] = res[1]
        if stress:
            # results["stress"] follows the package calculator contract
            # (ASE Voigt xx,yy,zz,yz,xz,xy, like LennardJones); the GP
            # rows are (xx,yy,zz,xy,xz,yz), so permute the shears
            self.results["stress"] = res[2].sum(axis=0)[[0, 1, 2,
                                                         5, 4, 3]]
        else:
            self.results["stress"] = None
        self.forces = res[1]

    # accessors (calculator.py:157-170)
    def get_var_e(self, total=False):
        if total:
            return self.results["var_e"] * len(self.results["forces"])
        return self.results["var_e"]

    def get_var_f(self):
        return self.results["var_f"]

    def get_e(self, peratom=True):
        e = self.results["energy"]
        return e / len(self.results["forces"]) if peratom else e
