r"""Spherical harmonics Y_l^m and their Cartesian gradients as real
(re, im) pairs -- port of the JAX package's ``ops/sph.py``.

Conventions match scipy: Y_l^m(theta, phi) with theta the polar angle,
phi the azimuth, Y_l^{-m} = (-1)^m conj(Y_l^m).  The imaginary structure
of Y_lm is the azimuthal phase e^{i m phi}, so re = P cos(m phi) and
im = P sin(m phi); the SO(3) power spectrum only needs real parts of
conjugated products.

The gradient uses the covariant-component recurrence of the reference
(gpr_calc/SO3.py:682-707); see the JAX module for the formulas.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _legendre_rows(lmax: int, ct, st):
    """Normalised associated Legendre rows (m = 0..lmax per row, with the
    full Y_lm normalisation), one (N, lmax+1) tensor per l."""
    L1 = lmax + 1
    m_idx = torch.arange(L1, device=ct.device)
    zero = _const(0.0, ct)

    diag = [torch.full_like(ct, 1.0 / math.sqrt(4.0 * math.pi))]
    for m in range(1, L1):
        diag.append(-math.sqrt((2 * m + 1) / (2.0 * m)) * st * diag[-1])
    Pmm = torch.stack(diag, dim=1)                      # (N, lmax+1)

    mv = np.arange(L1, dtype=np.float64)
    rows = []
    P_prev2 = torch.where(m_idx == 0, Pmm[:, 0:1], zero)    # l = 0 row
    rows.append(P_prev2)
    P_prev1 = None
    if lmax >= 1:
        p10 = math.sqrt(3.0) * ct * diag[0]
        P_prev1 = torch.where(m_idx == 0, p10[:, None],
                              torch.where(m_idx == 1, Pmm[:, 1:2], zero))
        rows.append(P_prev1)
    for l in range(2, L1):
        valid = mv <= l - 2
        a = np.where(valid, np.sqrt(
            np.where(valid, (4.0 * l * l - 1.0)
                     / np.maximum(l * l - mv * mv, 1e-300), 1.0)), 0.0)
        b = np.sqrt(np.where(valid, ((l - 1.0) ** 2 - mv * mv)
                             / (4.0 * (l - 1.0) ** 2 - 1.0), 0.0))
        row = (_const(a, ct) * (ct[:, None] * P_prev1)
               - _const(a * b, ct) * P_prev2)
        row = torch.where(m_idx == l - 1,
                          math.sqrt(2 * l + 1) * ct[:, None]
                          * Pmm[:, l - 1:l], row)
        row = torch.where(m_idx == l, Pmm[:, l:l + 1], row)
        rows.append(row)
        P_prev2, P_prev1 = P_prev1, row
    return rows


def ylm_all_ri(lmax: int, pos: torch.Tensor, r: torch.Tensor):
    """All Y_l^m for l = 0..lmax as a real pair (Yre, Yim), each
    (N, lmax+1, 2*lmax+1) indexed [n, l, lmax + m] (zero for |m| > l).
    pos: (N, 3) vectors, r: (N,) their norms (r > 0)."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    ct = z / r
    rho = torch.sqrt(x * x + y * y)
    st = rho / r
    # at the pole every m != 0 term carries st^m = 0, and atan2(0, 0) = 0
    phi = torch.atan2(y, x)
    L1 = lmax + 1
    marange = torch.arange(L1, dtype=pos.dtype, device=pos.device)
    mphi = phi[:, None] * marange[None, :]
    cosm, sinm = torch.cos(mphi), torch.sin(mphi)

    rows = _legendre_rows(lmax, ct, st)

    # re[-m] = (-1)^m re[m], im[-m] = -(-1)^m im[m]
    sign = _const((-1.0) ** np.arange(1, L1), pos)
    planes_re, planes_im = [], []
    for row in rows:
        pos_re = row * cosm
        pos_im = row * sinm
        neg_re = sign * pos_re[:, 1:]
        neg_im = -sign * pos_im[:, 1:]
        planes_re.append(torch.cat([neg_re.flip(1), pos_re], dim=1))
        planes_im.append(torch.cat([neg_im.flip(1), pos_im], dim=1))
    return torch.stack(planes_re, dim=1), torch.stack(planes_im, dim=1)


def ylm_gradients_ri(lmax: int, ylms_ext_ri, r: torch.Tensor):
    """Cartesian gradients of Y_l^m for l = 1..lmax as a real pair, from
    the Y planes up to lmax+1 (``ylm_all_ri(lmax + 1, ...)``).  Returns
    two (N, lmax+1, 2*lmax+1, 3) tensors; the l = 0 slice is zero."""
    Yre_ext, Yim_ext = ylms_ext_ri
    W = 2 * lmax + 1
    inv_r = (1.0 / r)[:, None]
    s2 = 1.0 / math.sqrt(2.0)
    mv = np.arange(-lmax, lmax + 1, dtype=np.float64)

    planes_re, planes_im = [], []
    zero = torch.zeros((Yre_ext.shape[0], W, 3), dtype=Yre_ext.dtype,
                       device=Yre_ext.device)
    planes_re.append(zero)                              # l = 0
    planes_im.append(zero)
    for l in range(1, lmax + 1):
        in_l = np.abs(mv) <= l
        c0a = np.where(in_l, -l * np.sqrt(
            np.maximum((l + 1.0) ** 2 - mv * mv, 0.0)
            / ((2 * l + 1) * (2 * l + 3))), 0.0)
        v = np.abs(mv) <= l - 1
        c0b = np.where(v, (l + 1) * np.sqrt(
            np.where(v, (l * l - mv * mv), 0.0)
            / ((2 * l - 1.0) * (2 * l + 1))), 0.0)
        cpa = np.where(in_l, -l * np.sqrt(
            np.maximum((l + mv + 1) * (l + mv + 2), 0.0)
            / (2.0 * (2 * l + 1) * (2 * l + 3))), 0.0)
        vp = np.abs(mv + 1) <= l - 1
        cpb = np.where(vp, -(l + 1) * np.sqrt(
            np.where(vp, (l - mv - 1) * (l - mv), 0.0)
            / (2.0 * (2 * l - 1) * (2 * l + 1))), 0.0)
        cma = np.where(in_l, -l * np.sqrt(
            np.maximum((l - mv + 1) * (l - mv + 2), 0.0)
            / (2.0 * (2 * l + 1) * (2 * l + 3))), 0.0)
        vm = np.abs(mv - 1) <= l - 1
        cmb = np.where(vm, -(l + 1) * np.sqrt(
            np.where(vm, (l + mv - 1) * (l + mv), 0.0)
            / (2.0 * (2 * l - 1) * (2 * l + 1))), 0.0)

        ca, cb = _const(c0a, Yre_ext), _const(c0b, Yre_ext)
        pa, pb = _const(cpa, Yre_ext), _const(cpb, Yre_ext)
        ma, mb = _const(cma, Yre_ext), _const(cmb, Yre_ext)

        out_l_re, out_l_im = [], []
        for Yext in (Yre_ext, Yim_ext):
            Yp = Yext[:, l + 1, :]                      # (N, W + 2)
            Ym = Yext[:, l - 1, :]
            x0 = (ca * Yp[:, 1:-1] + cb * Ym[:, 1:-1]) * inv_r
            xp = (pa * Yp[:, 2:] + pb * Ym[:, 2:]) * inv_r
            xm = (ma * Yp[:, :-2] + mb * Ym[:, :-2]) * inv_r
            out_l_re.append((s2 * (xm - xp), x0))       # gx, gz parts
            out_l_im.append(s2 * (xm + xp))             # gy pre-factor-i
        (gx_re, gz_re), (gx_im, gz_im) = out_l_re
        sum_re, sum_im = out_l_im
        # gy = i * s2 * (xm + xp):  re = -im(sum), im = +re(sum)
        gy_re, gy_im = -sum_im, sum_re
        planes_re.append(torch.stack([gx_re, gy_re, gz_re], dim=-1))
        planes_im.append(torch.stack([gx_im, gy_im, gz_im], dim=-1))
    return torch.stack(planes_re, dim=1), torch.stack(planes_im, dim=1)
