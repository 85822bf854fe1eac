"""Plain Gaussian-process regression over the blocks of ``kernels.py``,
float64 linear algebra: the NLL and its analytic gradient (exact
traces), the L-BFGS-B search of the upstream model (maxiter 10, ftol
1e-2), the factor and weights, and served means and stds.  Every
function takes the kernel's ``family`` ("RBF" or "Dot") and its zeta.

Training data are ``Data``: an energy side, a force side and the labels
y = [per-atom energies, force components], with the noise (noise_e,
noise_f) on the diagonal.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import minimize

from . import kernels as K


class Data:
    """A training set: sides built in ``prec`` from padded arrays."""

    def __init__(self, energy, force, y, prec="f64"):
        self.E = K.Energy(*energy, prec=prec)
        self.F = K.Force(*force, prec=prec)
        self.y = torch.as_tensor(np.asarray(y, float), dtype=torch.float64,
                                 device=self.E.U.device)
        self.prec = prec

    @property
    def n(self):
        return self.E.m + 3 * self.F.m


def _noise(data: Data, noise):
    return torch.cat([
        torch.full((data.E.m,), noise[0] ** 2, dtype=torch.float64),
        torch.full((3 * data.F.m,), noise[1] ** 2, dtype=torch.float64),
    ]).to(data.y.device)


def covariance(data: Data, theta, zeta, family, dual=False):
    return K.block(data.E, data.F, data.E, data.F, theta, zeta, family,
                   dual=dual, symmetric=True)


def nll(theta, data: Data, noise, zeta, family):
    """(-log marginal likelihood, its gradient in theta: (sigma, l) for
    RBF, (sigma, sigma0) for Dot); (inf, zeros) where K is not positive
    definite.  K is proportional to s2, so g_sigma = (tr(K^-1 K) -
    a^T K a) / sigma in both.  RBF: g_l from the dual plane dK/dg.  Dot:
    dK/dsigma0 = 2 s2 s0 W on the energy block alone (W =
    ``pair_counts``), so g_sigma0 = s2 s0 (tr(K^-1_EE W) - a_E^T W a_E)."""
    sigma, second = (float(t) for t in theta)
    dot = family == "Dot"
    planes = covariance(data, theta, zeta, family, dual=not dot)
    Kk = planes[0]
    Kn = Kk.clone()
    Kn.diagonal().add_(_noise(data, noise))
    L, info = torch.linalg.cholesky_ex(Kn)
    del Kn
    if int(info) != 0:
        return math.inf, np.zeros(2)
    y = data.y
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    value = (0.5 * torch.dot(y, alpha) + torch.log(L.diagonal()).sum()
             + 0.5 * data.n * math.log(2 * math.pi))
    Kinv = torch.cholesky_inverse(L)
    del L
    g_sigma = ((Kinv * Kk).sum() - alpha @ (Kk @ alpha)) / sigma
    if dot:
        m = data.E.m
        W = K.pair_counts(data.E).to(torch.float64)
        a_e = alpha[:m]
        g_second = sigma * sigma * second * (
            (Kinv[:m, :m] * W).sum() - a_e @ (W @ a_e))
    else:
        Kd = planes[1]
        g_gamma = 0.5 * ((Kinv * Kd).sum() - alpha @ (Kd @ alpha))
        g_second = g_gamma * (-1.0 / second ** 3)
    return float(value), np.array([float(g_sigma), float(g_second)])


def fit(data: Data, theta0, bounds, noise, zeta, family, maxiter=10):
    """L-BFGS-B from theta0: (theta*, the evaluations as (theta, NLL,
    gradient))."""
    evals = []

    def fun(theta):
        value, grad = nll(theta, data, noise, zeta, family)
        evals.append((np.array(theta, float), value, grad))
        if not np.isfinite(value):
            return np.inf, np.zeros_like(grad)
        return value, grad
    res = minimize(fun, np.asarray(theta0, float), method="L-BFGS-B",
                   bounds=bounds, jac=True,
                   options={"maxiter": maxiter, "ftol": 1e-2})
    return np.asarray(res.x, float), evals


def factorize(data: Data, theta, noise, zeta, family):
    """(L, alpha) of K + noise at theta, float64."""
    (Kk,) = covariance(data, theta, zeta, family)
    Kk.diagonal().add_(_noise(data, noise))
    L = torch.linalg.cholesky(Kk)
    del Kk
    alpha = torch.cholesky_solve(data.y[:, None], L)[:, 0]
    return L, alpha


def predict(query: Data, train: Data, L, alpha, theta, zeta, family):
    """(mean, std) of every row of ``query`` (its labels unused)."""
    (Kt,) = K.block(query.E, query.F, train.E, train.F, theta, zeta, family)
    mean = Kt @ alpha
    V = torch.linalg.solve_triangular(L, Kt.T, upper=False)
    var = K.prior(query.E, query.F, theta, zeta, family) - (V * V).sum(0)
    return mean, torch.sqrt(torch.clamp(var, min=0.0))
