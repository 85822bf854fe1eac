r"""Modified spherical Bessel functions i_l(z), scaled and overflow-free.

Port of the JAX package's ``ops/bessel.py``: the *scaled* functions

    b_l(z)  = e^{-z} i_l(z)          (bounded in [0, 1])
    db_l(z) = e^{-z} i_l'(z)

by upward recurrence from the closed forms where z >= 2 lmax + 2 and by
Miller's downward recurrence below, selected per element.  Derivative:
i_l' = i_{l-1} - (l+1)/z i_l, i_0' = i_1.

float32 inputs keep every intermediate inside float32's exponent range
(narrow Miller seeds and a wider small-z guard), as the JAX package does
for float32; float64 uses the wide constants.
"""
from __future__ import annotations

import torch


def _b01(z):
    em = torch.exp(-2.0 * z)
    # expm1 keeps b0 exact at small z
    b0 = -torch.expm1(-2.0 * z) / (2.0 * z)
    b1_formula = (z * (1.0 + em) - (1.0 - em)) / (2.0 * z * z)
    # the closed form cancels catastrophically for small z: series there
    z2 = z * z
    b1_series = z / 3.0 * (1.0 - z + 0.6 * z2 - (4.0 / 15.0) * z2 * z
                           + (2.0 / 21.0) * z2 * z2)
    b1_cut = 0.3 if z.dtype == torch.float32 else 0.02
    b1 = torch.where(z < b1_cut, b1_series, b1_formula)
    return b0, b1


def _upward(lmax: int, z):
    b0, b1 = _b01(z)
    seq = [b0, b1]
    for l in range(1, lmax):
        seq.append(seq[l - 1] - (2 * l + 1) / z * seq[l])
    return torch.stack(seq[: lmax + 1], dim=-1)


def _miller(lmax: int, z, n_extra: int, lstart: int):
    if z.dtype == torch.float32:
        tiny, big, small = 1e-30, 1e30, 1e-30
    else:
        tiny, big, small = 1e-280, 1e250, 1e-250
    fp = torch.zeros_like(z)
    fc = torch.full_like(z, tiny)
    outs = [None] * (lmax + 1)
    one = torch.ones((), dtype=z.dtype, device=z.device)
    small_t = torch.full((), small, dtype=z.dtype, device=z.device)
    for l in range(lstart, 0, -1):
        fm = fp + (2 * l + 1) / z * fc
        if l - 1 <= lmax:
            outs[l - 1] = fm
        fp, fc = fc, fm
        # keep the unnormalised sequence in range
        scale = torch.where(torch.abs(fm) > big, small_t, one)
        fp = fp * scale
        fc = fc * scale
        outs = [None if o is None else o * scale for o in outs]
    b = torch.stack(outs, dim=-1)
    b0_exact, _ = _b01(z)
    return b * (b0_exact / b[..., 0])[..., None]


def scaled_in(lmax: int, z: torch.Tensor, n_extra: int = 40):
    """Return (b, db): e^{-z} i_l(z) and e^{-z} i_l'(z) for l = 0..lmax,
    shapes z.shape + (lmax + 1,).  Exact limits at z == 0."""
    zshape = z.shape
    zf = z.reshape(-1)
    narrow = z.dtype == torch.float32
    z_cut = 1e-6 if narrow else 1e-12
    small = zf < z_cut
    zsafe = torch.where(small, torch.ones_like(zf), zf)

    # upward recurrence only comfortably above the order
    z_switch = float(2 * lmax + 2)
    use_up = zsafe >= z_switch
    z_up = torch.clamp(zsafe, min=z_switch)
    z_dn = torch.clamp(zsafe, max=z_switch)
    b = torch.where(use_up[..., None], _upward(lmax, z_up),
                    _miller(lmax, z_dn, n_extra,
                            lstart=int(z_switch) + n_extra))

    # derivative: i_l' = i_{l-1} - (l+1)/z i_l  (l >= 1);  i_0' = i_1
    if lmax >= 1:
        ls = torch.arange(1, lmax + 1, dtype=z.dtype, device=z.device)
        db_hi = b[..., :-1] - (ls + 1) / zsafe[..., None] * b[..., 1:]
        db = torch.cat([b[..., 1:2], db_hi], dim=-1)
    else:
        _, b1 = _b01(zsafe)
        db = b1[..., None]

    # z -> 0 limits through the l = 2 leading terms:
    # b = [1-z, z/3 - z^2/3, z^2/15, 0...],
    # db = [z/3 - z^2/3, 1/3 - z/3, 2z/15, 0...]
    l_idx = torch.arange(lmax + 1, device=z.device)
    zc = zf[..., None]
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    b1_lim = zc / 3.0 * (1.0 - zc)
    b_lim = torch.where(l_idx == 0, 1.0 - zc,
                        torch.where(l_idx == 1, b1_lim,
                                    torch.where(l_idx == 2, zc * zc / 15.0,
                                                zero)))
    db_lim = torch.where(l_idx == 0, b1_lim,
                         torch.where(l_idx == 1, (1.0 - zc) / 3.0,
                                     torch.where(l_idx == 2,
                                                 2.0 * zc / 15.0, zero)))

    b = torch.where(small[..., None], b_lim, b)
    db = torch.where(small[..., None], db_lim, db)
    return b.reshape(*zshape, lmax + 1), db.reshape(*zshape, lmax + 1)
