"""Descriptor dicts -> the padded arrays of ``gp.Data``: one energy point
a structure (every atom an env, weight 1 / natoms) and one force point an
atom of a selection (the envs whose descriptor moves with that atom: the
seq rows (centre, atom), each carrying dP(centre) / dr(atom))."""
from __future__ import annotations

import numpy as np
import torch

from . import so3
from .gp import Data


def energy_arrays(descs, numbers_list):
    """(x (m, A, d), ele (m, A), counts (m,)) float64 / int64."""
    A = max(len(z) for z in numbers_list)
    d = descs[0]["x"].shape[1]
    dev = descs[0]["x"].device
    x = torch.zeros((len(descs), A, d), dtype=torch.float64, device=dev)
    ele = torch.zeros((len(descs), A), dtype=torch.int64, device=dev)
    for s, (dd, z) in enumerate(zip(descs, numbers_list)):
        x[s, :len(z)] = dd["x"]
        ele[s, :len(z)] = torch.as_tensor(z, device=dev)
    counts = torch.as_tensor([float(len(z)) for z in numbers_list],
                             dtype=torch.float64, device=dev)
    return x, ele, counts


def force_arrays(descs, numbers_list, selections):
    """(x (m, B, d), dxdr (m, B, d, 3), ele (m, B)) of the atoms
    ``selections[s]`` of each structure s, in that order."""
    groups = []
    for dd, z, sel in zip(descs, numbers_list, selections):
        seq = dd["seq"]
        for i in sel:
            ids = (seq[:, 1] == i).nonzero()[0]
            groups.append((dd, z, ids, seq[ids, 0]))
    B = max(len(g[2]) for g in groups)
    d = descs[0]["x"].shape[1]
    dev = descs[0]["x"].device
    m = len(groups)
    x = torch.zeros((m, B, d), dtype=torch.float64, device=dev)
    dxdr = torch.zeros((m, B, d, 3), dtype=torch.float64, device=dev)
    ele = torch.zeros((m, B), dtype=torch.int64, device=dev)
    for k, (dd, z, ids, centres) in enumerate(groups):
        n = len(ids)
        c = torch.as_tensor(centres, device=dev)
        x[k, :n] = dd["x"][c]
        dxdr[k, :n] = dd["dxdr"][torch.as_tensor(ids, device=dev)]
        ele[k, :n] = torch.as_tensor(z, device=dev)[c]
    return x, dxdr, ele


def structures_data(positions_list, geo, desc, device, prec="f64"):
    """A ``gp.Data`` of served structures (labels zero): one energy point
    each and one force point a free atom, the descriptors this package's
    own (``desc`` = (nmax, lmax, rcut, alpha))."""
    nmax, lmax, rcut, alpha = desc
    descs = [so3.descriptor(p, geo.numbers, geo.cell, geo.pbc, nmax, lmax,
                            rcut, alpha, device=device)
             for p in positions_list]
    z = [geo.numbers] * len(descs)
    n = len(descs) * (1 + 3 * len(geo.free))
    return Data(energy_arrays(descs, z),
                force_arrays(descs, z, [geo.free] * len(descs)),
                np.zeros(n), prec)
