"""What a driver drives: the program (``Port``), or the reference put in
its place (``Reference``: in TF32, the control of the checks' limits).

Both answer ``fit(opt)``, ``theta()``, ``alpha()`` (the weights of the
real training rows, [energies, force components]), ``evals`` (per fit,
the (theta, NLL, gradient) of each evaluation L-BFGS-B asked for) and
``serve(positions)`` -> (E eV, F of the free atoms (n, 3) eV/A, sigma_E
per atom, sigma_F of the free atoms (n, 3)).
"""
from __future__ import annotations

import numpy as np
import torch

from . import harness
from .reference import gp as rgp
from .reference import points


class Port:
    """gpr_calculator_tpu_torch's GP, holding the system's training set."""

    def __init__(self, system):
        import gpr_calculator_tpu_torch as port
        from gpr_calculator_tpu_torch import config
        config.set_kff_precision(system.cfg["precision"])
        self.port, self.system, self.geo = port, system, system.geo
        self.gp = system.port_model(port, harness.log_file())
        self.evals = []
        objective = self.gp._objective

        def recording(*args, **kwargs):
            obj = objective(*args, **kwargs)
            calls = []
            self.evals.append(calls)

            def fun(theta):
                value, grad = obj(theta)
                calls.append((np.array(theta, float), float(value),
                              np.array(grad, float)))
                return value, grad
            return fun
        self.gp._objective = recording

    def fit(self, opt, theta=None, maxiter=10):
        if theta is not None:
            self.gp.kernel.update(list(theta))
        self.gp.fit(opt=opt, show=False, maxiter=maxiter)

    def theta(self):
        return np.array(self.gp.kernel.parameters(), float)

    def alpha(self):
        te, _, nE, nF = self.gp._fit_snapshot
        rows = np.r_[np.arange(nE), te.m + np.arange(3 * nF)]
        return self.gp.alpha_.detach().cpu().numpy()[rows]

    def serve(self, positions):
        geo = self.geo
        atoms = self.port.Atoms(
            numbers=geo.numbers, positions=positions, cell=geo.cell,
            pbc=geo.pbc, constraints=[self.port.FixAtoms(indices=geo.fixed)])
        E, F, _, E_std, F_std = self.gp.predict_structure(atoms,
                                                          return_std=True)
        return (float(E), F[geo.free], float(E_std), F_std[geo.free])

    def release(self):
        self.gp = None


class Reference:
    """The plain reference in the program's place, at ``prec``, with the
    system's kernel family."""

    def __init__(self, system, prec="tf32"):
        self.system, self.geo, self.prec = system, system.geo, prec
        self.data = system.ref_data(prec)
        self._theta = np.array(system.theta0, float)
        self.evals = []
        self.L = self.a = None

    def fit(self, opt, theta=None, maxiter=10):
        s = self.system
        if theta is not None:
            self._theta = np.array(theta, float)
        if opt:
            self._theta, evals = rgp.fit(self.data, self._theta, s.bounds,
                                         s.noise, s.zeta, s.family,
                                         maxiter=maxiter)
            self.evals.append(evals)
        self.L, self.a = rgp.factorize(self.data, self._theta, s.noise,
                                       s.zeta, s.family)

    def theta(self):
        return self._theta.copy()

    def alpha(self):
        return self.a.cpu().numpy()

    def serve(self, positions, alpha=None):
        """The served answer; with ``alpha`` (the weights of the training
        rows) the mean is the reference's block times those weights."""
        geo, s = self.geo, self.system
        q = points.structures_data([positions], geo, s.desc, s.device,
                                   self.prec)
        a = self.a if alpha is None else torch.as_tensor(
            alpha, dtype=torch.float64, device=self.a.device)
        mean, std = rgp.predict(q, self.data, self.L, a, self._theta,
                                s.zeta, s.family)
        mean, std = mean.cpu().numpy(), std.cpu().numpy()
        n = len(geo.numbers)
        return (float(mean[0]) * n, mean[1:].reshape(-1, 3), float(std[0]),
                std[1:].reshape(-1, 3))

    def release(self):
        self.data = self.L = self.a = None
