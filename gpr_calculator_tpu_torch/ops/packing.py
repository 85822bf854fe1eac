"""Padded tensor layout for GPR training/prediction points.

    energy point block:  x (m, A, d), ele (m, A)
    force point block :  x (m, B, d), dxdr (m, B, d, ncart), ele (m, B)

ncart is 3, or 9 for the points of a stress request: the 3 force columns
and the 6 strain columns (xx, yy, zz, xy, xz, yz) of the descriptor's
rdxdr rows.

A/B are padded per-point environment counts and ``ele == 0`` marks
padding (zero descriptors), as in the JAX package's ``ops/packing.py``.
PyTorch runs eagerly, so nothing here needs shape buckets for reuse;
``bucket_size`` is kept for the callers that pad to a grid anyway.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import config


class EnergyData(NamedTuple):
    """A batch of energy points (one per structure).

    x      : (m, A, d) descriptors of every atom in each structure
    ele    : (m, A) int32 atomic numbers, 0 = padding
    counts : (m,) number of real atoms per point (K_EE normalisation)
    nreal  : number of real points (<= m)
    """

    x: torch.Tensor
    ele: torch.Tensor
    counts: torch.Tensor
    nreal: int

    @property
    def m(self) -> int:
        return self.x.shape[0]

    @property
    def max_atoms(self) -> int:
        return self.x.shape[1]

    @property
    def d(self) -> int:
        return self.x.shape[2]


class ForceData(NamedTuple):
    """A batch of force points (one per selected atom).

    x     : (m, B, d) descriptors of the environments whose power
            spectrum depends on the target atom's position
    dxdr  : (m, B, d, ncart) gradients dX/dr of each environment (and,
            ncart = 9, its strain rows)
    ele   : (m, B) int32 atomic numbers of env centres, 0 = padding
    nreal : number of real points
    """

    x: torch.Tensor
    dxdr: torch.Tensor
    ele: torch.Tensor
    nreal: int

    @property
    def m(self) -> int:
        return self.x.shape[0]

    @property
    def max_envs(self) -> int:
        return self.x.shape[1]

    @property
    def d(self) -> int:
        return self.x.shape[2]

    @property
    def ncart(self) -> int:
        return self.dxdr.shape[3]


def round_up(n: int, multiple: int) -> int:
    if n == 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def bucket_size(n: int, multiple: int = 8, grow: float = 1.25) -> int:
    """Next multiple of ``multiple`` at least ``grow * n``."""
    if n <= 0:
        return multiple
    target = max(n, int(np.ceil(n * grow)))
    return round_up(target, multiple)


def _placement(device, dtype):
    dev = config.device() if device is None else torch.device(device)
    return dev, config.dtype(dev) if dtype is None else dtype


def pack_energy(points: Sequence, m_pad: Optional[int] = None,
                a_pad: Optional[int] = None, d: Optional[int] = None,
                device=None, dtype=None) -> EnergyData:
    """Pack ragged energy points [(x_i (Ni, d), ele_i (Ni,)), ...]."""
    dev, dt = _placement(device, dtype)
    n = len(points)
    if n == 0:
        if d is None:
            raise ValueError("need descriptor width for an empty block")
        m_pad = m_pad or 1
        a_pad = a_pad or 1
        return EnergyData(
            x=torch.zeros((m_pad, a_pad, d), dtype=dt, device=dev),
            ele=torch.zeros((m_pad, a_pad), dtype=torch.int32, device=dev),
            counts=torch.ones((m_pad,), dtype=dt, device=dev),
            nreal=0)
    d_data = points[0][0].shape[1]
    if d is not None and d != d_data:
        raise ValueError(f"declared descriptor width d={d} but the points "
                         f"carry {d_data}")
    d = d_data
    max_a = max(int(p[0].shape[0]) for p in points)
    m_pad = m_pad or n
    a_pad = a_pad or max_a
    if m_pad < n or a_pad < max_a:
        raise ValueError("padding smaller than the data")
    x = np.zeros((m_pad, a_pad, d), np.float64)
    ele = np.zeros((m_pad, a_pad), np.int32)
    counts = np.ones((m_pad,), np.float64)
    for i, (xi, ei) in enumerate(points):
        ni = xi.shape[0]
        x[i, :ni] = xi
        ele[i, :ni] = np.asarray(ei, np.int32)
        counts[i] = ni
    return EnergyData(
        x=torch.as_tensor(x, dtype=dt, device=dev),
        ele=torch.as_tensor(ele, device=dev),
        counts=torch.as_tensor(counts, dtype=dt, device=dev),
        nreal=n)


def pack_force(points: Sequence, m_pad: Optional[int] = None,
               b_pad: Optional[int] = None, d: Optional[int] = None,
               device=None, dtype=None, ncart: int = 3) -> ForceData:
    """Pack ragged force points [(x_i (Ni, d), dxdr_i (Ni, d, c),
    ele_i (Ni,)), ...], c = 3 or 9 (stress rows appended); ``ncart``
    is the width of an empty block and must be 3 or the points' c."""
    dev, dt = _placement(device, dtype)
    n = len(points)
    if n == 0:
        if d is None:
            raise ValueError("need descriptor width for an empty block")
        m_pad = m_pad or 1
        b_pad = b_pad or 1
        return ForceData(
            x=torch.zeros((m_pad, b_pad, d), dtype=dt, device=dev),
            dxdr=torch.zeros((m_pad, b_pad, d, ncart), dtype=dt,
                             device=dev),
            ele=torch.zeros((m_pad, b_pad), dtype=torch.int32, device=dev),
            nreal=0)
    d_data = points[0][0].shape[1]
    if d is not None and d != d_data:
        raise ValueError(f"declared descriptor width d={d} but the points "
                         f"carry {d_data}")
    d = d_data
    nc_data = points[0][1].shape[2]
    if nc_data not in (3, 9) or ncart not in (3, nc_data):
        raise ValueError(f"declared ncart={ncart} but the force points "
                         f"carry {nc_data} cartesian columns (3, or 9 with "
                         "the strain rows)")
    ncart = nc_data
    max_b = max(int(p[0].shape[0]) for p in points)
    m_pad = m_pad or n
    b_pad = b_pad or max_b
    if m_pad < n or b_pad < max_b:
        raise ValueError("padding smaller than the data")
    x = np.zeros((m_pad, b_pad, d), np.float64)
    dxdr = np.zeros((m_pad, b_pad, d, ncart), np.float64)
    ele = np.zeros((m_pad, b_pad), np.int32)
    for i, (xi, di, ei) in enumerate(points):
        ni = xi.shape[0]
        x[i, :ni] = xi
        dxdr[i, :ni] = di
        ele[i, :ni] = np.asarray(ei, np.int32)
    return ForceData(
        x=torch.as_tensor(x, dtype=dt, device=dev),
        dxdr=torch.as_tensor(dxdr, dtype=dt, device=dev),
        ele=torch.as_tensor(ele, device=dev),
        nreal=n)
