"""Geometry optimizers (BFGS, FIRE), standalone (NumPy).

Port of the JAX package's ``optimize.py``.  The reference drives NEB
through ase.optimize.BFGS / FIRE (gpr_calc/NEB.py:32,50-59).  These
implementations follow the standard algorithms and operate on anything
exposing get_positions / set_positions / get_forces (Atoms or an NEB
object), and write each step's structure (every image of an NEB) to an
ASE-readable ULM trajectory when given one.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np


class Optimizer:
    def __init__(self, obj, trajectory: Optional[str] = None,
                 append_trajectory: bool = False, logfile=None,
                 verbose: bool = True):
        self.obj = obj
        self.verbose = verbose
        self.nsteps = 0
        self.fmax = None
        self._traj_writer = None
        if trajectory is not None:
            from .io.trajectory import TrajectoryWriter
            mode = "a" if append_trajectory else "w"
            self._traj_writer = TrajectoryWriter(trajectory, mode=mode)

    def converged(self, forces=None) -> bool:
        if forces is None:
            forces = self.obj.get_forces()
        return np.sqrt((forces ** 2).sum(axis=1).max()) < self.fmax

    def _log(self, forces):
        if not self.verbose:
            return
        fmax = np.sqrt((forces ** 2).sum(axis=1).max())
        e = self.obj.get_potential_energy()
        name = self.__class__.__name__
        t = time.strftime("%H:%M:%S")
        print(f"{name}: {self.nsteps:4d} {t} {e:15.6f} {fmax:15.6f}")

    def _write_traj(self):
        if self._traj_writer is None:
            return
        images = getattr(self.obj, "images", None)
        if images is not None:
            for im in images:
                self._traj_writer.write(im)
        else:
            self._traj_writer.write(self.obj)

    def run(self, fmax: float = 0.05, steps: int = 100000000) -> bool:
        self.fmax = fmax
        forces = self.obj.get_forces()
        self._log(forces)
        self._write_traj()
        while not self.converged(forces) and self.nsteps < steps:
            self.step(forces)
            self.nsteps += 1
            forces = self.obj.get_forces()
            self._log(forces)
            self._write_traj()
        return self.converged(forces)

    def step(self, forces):
        raise NotImplementedError


class BFGS(Optimizer):
    """Quasi-Newton with an explicit Hessian estimate (ASE-style: H0 =
    alpha*I, eigen-decomposed step, trust-radius clip)."""

    def __init__(self, obj, maxstep: float = 0.2, alpha: float = 70.0,
                 **kwargs):
        super().__init__(obj, **kwargs)
        self.maxstep = maxstep
        self.alpha = alpha
        self.H = None
        self.pos0 = None
        self.forces0 = None

    def step(self, forces):
        pos = self.obj.get_positions()
        f = forces.reshape(-1)
        self._update_hessian(pos.reshape(-1), f)
        omega, V = np.linalg.eigh(self.H)
        dpos = (V @ (f @ V / np.fabs(omega))).reshape(-1, 3)
        steplengths = np.sqrt((dpos ** 2).sum(axis=1))
        maxsteplength = np.max(steplengths)
        if maxsteplength >= self.maxstep:
            dpos *= self.maxstep / maxsteplength
        self.pos0 = pos.reshape(-1).copy()
        self.forces0 = f.copy()
        self.obj.set_positions(pos + dpos)

    def _update_hessian(self, pos, forces):
        if self.H is None:
            self.H = np.eye(len(pos)) * self.alpha
            return
        dpos = pos - self.pos0
        if np.abs(dpos).max() < 1e-7:
            return
        dforces = forces - self.forces0
        a = dpos @ dforces
        dg = self.H @ dpos
        b = dpos @ dg
        # skip the update when either curvature denominator is
        # numerically zero (possible under NEB's projected,
        # non-conservative forces) -- a division there poisons H with
        # inf/NaN and the next eigh crashes
        scale = max(float(np.abs(dpos).max()), 1e-30)
        if abs(a) < 1e-12 * scale or abs(b) < 1e-12 * scale:
            return
        self.H -= (np.outer(dforces, dforces) / a
                   + np.outer(dg, dg) / b)


class FIRE(Optimizer):
    """Fast inertial relaxation engine (Bitzek et al., PRL 97, 170201)."""

    def __init__(self, obj, dt: float = 0.1, maxstep: float = 0.2,
                 dtmax: float = 1.0, Nmin: int = 5, finc: float = 1.1,
                 fdec: float = 0.5, astart: float = 0.1, fa: float = 0.99,
                 **kwargs):
        super().__init__(obj, **kwargs)
        self.dt = dt
        self.maxstep = maxstep
        self.dtmax = dtmax
        self.Nmin = Nmin
        self.finc = finc
        self.fdec = fdec
        self.astart = astart
        self.fa = fa
        self.v = None
        self.a = astart
        self.Nsteps = 0

    def step(self, forces):
        f = forces.reshape(-1)
        if self.v is None:
            self.v = np.zeros_like(f)
        else:
            vf = self.v @ f
            if vf > 0:
                fn = np.linalg.norm(f)
                vn = np.linalg.norm(self.v)
                self.v = (1.0 - self.a) * self.v + self.a * f / max(
                    fn, 1e-30) * vn
                if self.Nsteps > self.Nmin:
                    self.dt = min(self.dt * self.finc, self.dtmax)
                    self.a *= self.fa
                self.Nsteps += 1
            else:
                self.v[:] = 0.0
                self.a = self.astart
                self.dt *= self.fdec
                self.Nsteps = 0
        self.v += self.dt * f
        dpos = self.dt * self.v
        norm = np.sqrt((dpos ** 2).sum())
        if norm > self.maxstep:
            dpos = self.maxstep * dpos / norm
        pos = self.obj.get_positions()
        self.obj.set_positions(pos + dpos.reshape(-1, 3))
