"""Frozen float64 copy of effective-medium theory (Jacobsen, Stoltze and
Norskov 1996; the parameter table of ASE's EMT), the labels of the
benchmark's Au-on-Al(100) training sets: energies in eV, forces in eV/A
from ``torch.autograd.grad``.  The math of the port's
``calculators/emt.py``, copied so that the benchmark's inputs take
nothing from the program."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .neighbors import neighbor_pairs

SYMBOLS = {13: "Al", 29: "Cu", 47: "Ag", 79: "Au", 28: "Ni", 46: "Pd",
           78: "Pt", 1: "H", 6: "C", 7: "N", 8: "O"}

BOHR = 0.5291772105638411
BETA = 1.809  # (16 pi / 3)^(1/3) / sqrt(2), rounded as in the literature

#                E0      s0     V0     eta2   kappa  lambda  n0
PARAMETERS = {
    "Al": (-3.28, 3.00, 1.493, 1.240, 2.000, 1.169, 0.00700),
    "Cu": (-3.51, 2.67, 2.476, 1.652, 2.740, 1.906, 0.00910),
    "Ag": (-2.96, 3.01, 2.132, 1.652, 2.790, 1.892, 0.00547),
    "Au": (-3.80, 3.00, 2.321, 1.674, 2.873, 2.182, 0.00703),
    "Ni": (-4.44, 2.60, 3.673, 1.669, 2.757, 1.948, 0.01030),
    "Pd": (-3.90, 2.87, 2.773, 1.818, 3.107, 2.155, 0.00688),
    "Pt": (-5.85, 2.90, 4.067, 1.812, 3.145, 2.192, 0.00802),
    "H": (-3.21, 0.71, 2.132, 1.892, 2.148, 1.434, 0.00547),
    "C": (-3.50, 1.81, 0.332, 1.652, 2.790, 1.892, 0.01322),
    "N": (-5.10, 1.88, 0.132, 1.652, 2.790, 1.892, 0.01222),
    "O": (-4.60, 1.95, 0.332, 1.652, 2.790, 1.892, 0.00850),
}


def _cutoff_params():
    maxseq = max(p[1] for p in PARAMETERS.values()) * BOHR
    rc = BETA * maxseq * 0.5 * (np.sqrt(3.0) + np.sqrt(4.0))
    rr = BETA * maxseq * np.sqrt(4.0)   # 4th-shell distance
    acut = np.log(9999.0) / (rr - rc)
    return rc, acut


RC, ACUT = _cutoff_params()
RC_LIST = RC + 0.5


@functools.lru_cache(maxsize=32)
def _element_table(symbols: tuple):
    """Per-element derived parameters in eV/Angstrom units."""
    rows = []
    for sym in symbols:
        if sym not in PARAMETERS:
            raise NotImplementedError(
                f"EMT has no parameters for element {sym!r} (available: "
                f"{sorted(PARAMETERS)})")
        E0, s0b, V0, eta2b, kappab, lamb, n0b = PARAMETERS[sym]
        s0 = s0b * BOHR
        eta2 = eta2b / BOHR
        kappa = kappab / BOHR
        lam = lamb / BOHR
        n0 = n0b / BOHR ** 3
        gamma1 = 0.0
        gamma2 = 0.0
        for i, n in enumerate([12, 6, 24]):
            r = s0 * BETA * np.sqrt(i + 1.0)
            x = n / (12.0 * (1.0 + np.exp(ACUT * (r - RC))))
            gamma1 += x * np.exp(-eta2 * (r - BETA * s0))
            gamma2 += x * np.exp(-kappa / BETA * (r - BETA * s0))
        rows.append([E0, s0, V0, eta2, kappa, lam, n0, gamma1, gamma2])
    return np.asarray(rows)


def emt_energy(positions, pair_i, pair_j, offsets, table, type_idx):
    """Total EMT energy, differentiable w.r.t. ``positions`` (natoms, 3).

    pair_i/pair_j: both-directions neighbour list within RC_LIST;
    offsets: the periodic image shift of each pair (Cartesian)."""
    natoms = positions.shape[0]
    E0, s0, V0, eta2, kappa, lam, n0, gamma1, gamma2 = (
        table[:, k][type_idx] for k in range(9))

    i, j = pair_i, pair_j
    d = positions[j] + offsets - positions[i]
    r = torch.sqrt(torch.sum(d * d, dim=1))
    theta = 1.0 / (1.0 + torch.exp(ACUT * (r - RC)))

    ksi_ij = n0[j] / n0[i]
    # density contribution of j at i
    sig_contrib = (torch.exp(-eta2[j] * (r - BETA * s0[j]))
                   * ksi_ij * theta / gamma1[i])
    # index_put(accumulate=True) adds in a fixed order on a card too
    # (index_add: atomics, no fixed order, energies and forces that vary
    # from run to run in the last bits)
    sigma1 = torch.zeros(natoms, dtype=positions.dtype,
                         device=positions.device).index_put(
                             (i,), sig_contrib, accumulate=True)
    sigma1 = torch.clamp(sigma1, min=1e-12)

    ds = -torch.log(sigma1 / 12.0) / (BETA * eta2)
    x = lam * ds
    E_c = E0 * ((1.0 + x) * torch.exp(-x) - 1.0)
    E_as_atom = 6.0 * V0 * torch.exp(-kappa * ds)

    # pair repulsion (each ordered pair carries the 0.5 V0_i ... term)
    pairE = (0.5 * V0[i] * torch.exp(-kappa[j] * (r / BETA - s0[j]))
             * ksi_ij * theta / gamma2[i])
    return torch.sum(E_c) + torch.sum(E_as_atom) - torch.sum(pairE)


def energy_forces(positions, numbers, cell, pbc, device="cpu"):
    """(energy eV, forces (natoms, 3) eV/A) in float64."""
    numbers = np.asarray(numbers, int)
    symbols = tuple(sorted({SYMBOLS[int(z)] for z in numbers}))
    sym_index = {s: k for k, s in enumerate(symbols)}
    type_idx = np.asarray([sym_index[SYMBOLS[int(z)]] for z in numbers],
                          np.int64)
    positions = np.asarray(positions, float)
    pi, pj, rij = neighbor_pairs(positions, cell, pbc, RC_LIST)
    offsets = rij - (positions[pj] - positions[pi])
    f64 = torch.float64
    pos = torch.tensor(positions, dtype=f64, device=device,
                       requires_grad=True)
    e = emt_energy(
        pos, torch.as_tensor(pi, device=device),
        torch.as_tensor(pj, device=device),
        torch.as_tensor(offsets, dtype=f64, device=device),
        torch.as_tensor(_element_table(symbols), dtype=f64, device=device),
        torch.as_tensor(type_idx, device=device))
    (g,) = torch.autograd.grad(e, pos)
    return float(e.detach()), -g.cpu().numpy()
