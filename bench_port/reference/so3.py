"""Frozen float64 copy of the SO(3) power spectrum and its gradients.

The math of the port's ``ops/so3.py``, ``ops/bessel.py`` and
``ops/sph.py`` (itself held to the JAX package and the upstream
gpr_calc/SO3.py), copied here so that the benchmark's reference imports
nothing of the program.  ``descriptor`` returns one structure's
descriptor dict: x (natoms, ncoef), dxdr (nseq, ncoef, 3) with dxdr[s]
= dP(centre seq[s, 0]) / dr(seq[s, 1]), seq (nseq, 2), the neighbour
list the NumPy one of ``neighbors.py``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .neighbors import neighbor_pairs

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


def W_matrix(nmax: int) -> np.ndarray:
    """Symmetric orthonormalisation of the (rcut - r)^(a+2) radial basis
    (S^{-1/2} of the overlap matrix, SO3.py:417-430)."""
    S = np.zeros((nmax, nmax))
    for a in range(1, nmax + 1):
        ta = (2 * a + 5) * (2 * a + 6) * (2 * a + 7)
        for b in range(1, a + 1):
            tb = (2 * b + 5) * (2 * b + 6) * (2 * b + 7)
            S[a - 1, b - 1] = math.sqrt(ta * tb) / (
                (5 + a + b) * (6 + a + b) * (7 + a + b))
            S[b - 1, a - 1] = S[a - 1, b - 1]
    sinv = np.linalg.inv(S)
    eigvals, V = np.linalg.eig(sinv)
    return (V @ np.diag(np.sqrt(eigvals)) @ np.linalg.inv(V)).real


def gauss_chebyshev(nmax: int, lmax: int):
    """Chebyshev nodes and the uniform weight pi/N (SO3.py:446-453)."""
    N = (nmax + lmax + 1) * 10
    i = np.arange(1, N + 1)
    return np.cos((2 * i - 1) * np.pi / (2 * N)), np.pi / N


def radial_quadrature(nmax: int, lmax: int, rcut: float, alpha: float):
    """Quadrature nodes q, and G0[n, j] = w_j q^2 g_n(q) sqrt(1-x^2)
    without the e^{-alpha q^2} factor (folded into the pair Gaussian)."""
    gc, w = gauss_chebyshev(nmax, lmax)
    w = w * rcut / 2.0
    q = rcut / 2.0 * (gc + 1.0)
    Wm = W_matrix(nmax)
    phis = np.stack([
        (rcut - q) ** (a + 2)
        / math.sqrt(2 * rcut ** (2 * a + 7)
                    / ((2 * a + 5) * (2 * a + 6) * (2 * a + 7)))
        for a in range(1, nmax + 1)
    ])
    g = Wm @ phis
    G0 = g * (q ** 2) * np.sqrt(1.0 - gc ** 2) * w
    return q, G0


def cosine_cutoff(r, rcut, derivative=False):
    if derivative:
        return -0.5 * math.pi / rcut * torch.sin(math.pi * r / rcut)
    return 0.5 * (torch.cos(math.pi * r / rcut) + 1.0)


CUTOFFS = {"cosine": cosine_cutoff}

def _segment_sum(vals, seg, nseg):
    """out[s] = the sum of vals[k] over seg[k] == s, each segment added in
    the order of k on every device: ``index_put_(accumulate=True)`` sorts
    the indices on a card (stably), where ``index_add_`` adds by atomics
    in no fixed order, so that one structure's descriptors would differ
    from run to run."""
    out = torch.zeros((nseg,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_put_((seg,), vals, accumulate=True)


def _so3_core(rij, weights, pair_center, pair_seq, self_seq, self_ids,
              seq_center, q, G0, pair_Ri=None, pair_Rj=None, *, nmax: int,
              lmax: int, natoms: int, nseq: int, rcut: float, alpha: float,
              derivative: bool, cutoff: str, stress: bool = False):
    """Pair c/dc -> per-centre power spectrum and its gradients.

    rij (P, 3), weights (P,), pair_center (P,), pair_seq (P,) with nseq
    for pairs outside the selection, self_seq/self_ids the (i, i) seq
    rows and their atom ids, seq_center (nseq,), q (NQ,), G0 (nmax, NQ);
    with stress, pair_Ri/pair_Rj (P, 3) the absolute positions of each
    pair's centre and neighbour.  Returns (x (natoms, ncoef), dxdr (nseq,
    ncoef, 3) or None, pstress (nseq, ncoef, 3, 3) or None): pstress
    before the caller's -1/volume (the JAX package's ops/so3.py:254-265)."""
    P = rij.shape[0]
    ncoef = nmax * (nmax + 1) // 2 * (lmax + 1)
    cut_fn = CUTOFFS[cutoff]
    tri = np.tril_indices(nmax)

    r = torch.sqrt(torch.sum(rij * rij, dim=1))
    u = rij / r[:, None]

    # scaled radial integrand: E[p, j] = exp(-alpha (r - q_j)^2)
    E = torch.exp(-alpha * (r[:, None] - q[None, :]) ** 2)
    z = 2.0 * alpha * r[:, None] * q[None, :]
    b, db = scaled_in(lmax, z)                       # (P, NQ, lmax+1)
    I = torch.einsum("nj,pjl->pnl", G0, E[:, :, None] * b)

    larange = torch.arange(lmax + 1, dtype=rij.dtype, device=rij.device)
    norm_l = torch.sqrt(2.0 * math.sqrt(2.0) * math.pi
                        / torch.sqrt(2.0 * larange + 1.0))
    fourpi = 4.0 * math.pi
    fcut = cut_fn(r, rcut)
    ones = torch.ones_like(r)

    if not derivative:
        Yre, Yim = ylm_all_ri(lmax, u, ones)
        pref = ((fourpi * (weights * fcut))[:, None, None, None]
                * I[:, :, :, None] * norm_l[None, None, :, None])
        ctot_re = _segment_sum(pref * Yre[:, None], pair_center,
                               natoms + 1)[:natoms]
        ctot_im = _segment_sum(pref * Yim[:, None], pair_center,
                               natoms + 1)[:natoms]
        Pfull = (torch.einsum("anlm,aklm->ankl", ctot_re, ctot_re)
                 + torch.einsum("anlm,aklm->ankl", ctot_im, ctot_im))
        return Pfull[:, tri[0], tri[1], :].reshape(natoms, ncoef), None, None

    # Y to lmax+1 for the gradient recurrence
    Yext = ylm_all_ri(lmax + 1, u, ones)
    mid = lmax + 1
    Yre = Yext[0][:, :lmax + 1, mid - lmax: mid + lmax + 1]
    Yim = Yext[1][:, :lmax + 1, mid - lmax: mid + lmax + 1]
    dYre, dYim = ylm_gradients_ri(lmax, Yext, r)

    # dI~/dr [p, n, l] = sum_j G0 E (2 alpha q db - 2 alpha r b)
    dEb = E[:, :, None] * (2.0 * alpha * q[None, :, None] * db
                           - 2.0 * alpha * r[:, None, None] * b)
    dIdr = torch.einsum("nj,pjl->pnl", G0, dEb)

    pref = fourpi * weights
    dfcut = cut_fn(r, rcut, derivative=True)
    dfu = (dfcut[:, None] * u)[:, None, None, None, :]

    def c_dc(Ypart, dYpart):
        # c0 = 4pi w Y I~ ;  dc0 = 4pi w (dY I~ + Y u dI~/dr)
        c0 = pref[:, None, None, None] * I[:, :, :, None] * Ypart[:, None]
        dc0 = (pref[:, None, None, None, None]
               * (dYpart[:, None] * I[:, :, :, None, None]
                  + Ypart[:, None, :, :, None] * u[:, None, None, None, :]
                  * dIdr[:, :, :, None, None]))
        dc = dc0 * fcut[:, None, None, None, None] + c0[..., None] * dfu
        c = c0 * fcut[:, None, None, None] * norm_l[None, None, :, None]
        dc = dc * norm_l[None, None, :, None, None]
        return c, dc

    c_re, dc_re = c_dc(Yre, dYre)
    c_im, dc_im = c_dc(Yim, dYim)
    ctot_re = _segment_sum(c_re, pair_center, natoms + 1)[:natoms]
    ctot_im = _segment_sum(c_im, pair_center, natoms + 1)[:natoms]

    Pfull = (torch.einsum("anlm,aklm->ankl", ctot_re, ctot_re)
             + torch.einsum("anlm,aklm->ankl", ctot_im, ctot_im))
    x = Pfull[:, tri[0], tri[1], :].reshape(natoms, ncoef)

    # dP[p, n, k, l, d] = Re[A] + swap_nk(Re[A]),
    # Re[A] = dc_re . ctot_re + dc_im . ctot_im  (at the pair's centre)
    A_re = (torch.einsum("pnlmd,pklm->pnkld", dc_re, ctot_re[pair_center])
            + torch.einsum("pnlmd,pklm->pnkld", dc_im,
                           ctot_im[pair_center]))
    dP = A_re + A_re.transpose(1, 2)
    dP_tri = dP[:, tri[0], tri[1], :, :].reshape(P, ncoef, 3)

    # seq accumulation + translation-invariance self rows (SO3.py:261-273)
    dxdr = _segment_sum(dP_tri, pair_seq, nseq + 1)[:nseq]
    center_tot = _segment_sum(dxdr, seq_center, natoms + 1)[:natoms]
    dxdr = dxdr.index_put((self_seq,), -center_tot[self_ids],
                          accumulate=True)
    if not stress:
        return x, dxdr, None
    # pstress[(i, j)] = -sum_w Rj (x) dP_w; the self rows [(i, i)] add
    # sum over the centre's pairs of Ri (x) dP, stored (ncoef, 3 = R,
    # 3 = gradient) as the reference's 'wn,wijkm->wijknm' (SO3.py:298-303)
    pstress = -_segment_sum(torch.einsum("pn,pcm->pcnm", pair_Rj, dP_tri),
                            pair_seq, nseq + 1)[:nseq]
    rdPi = _segment_sum(torch.einsum("pn,pcm->pcnm", pair_Ri, dP_tri),
                        pair_center, natoms + 1)[:natoms]
    return x, dxdr, pstress.index_put((self_seq,), rdPi[self_ids],
                                      accumulate=True)


def descriptor(positions, numbers, cell, pbc, nmax: int, lmax: int,
               rcut: float, alpha: float = 2.0, device="cpu",
               dtype=torch.float64):
    """SO3 x, dxdr and seq of one structure (unit neighbour weights Z_j,
    the cosine cutoff, every atom a centre), computed in ``dtype``."""
    numbers = np.asarray(numbers, int)
    natoms = len(numbers)
    pi, pj, rij = neighbor_pairs(positions, cell, pbc, rcut)
    stride = natoms + 1
    key_pairs = pi.astype(np.int64) * stride + pj
    ids = np.arange(natoms, dtype=np.int64)
    key_self = ids * stride + ids
    uniq = np.unique(np.concatenate([key_pairs, key_self]))
    seq = np.stack([uniq // stride, uniq % stride], axis=1)
    q, G0 = radial_quadrature(nmax, lmax, rcut, alpha)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    x, dxdr, _ = _so3_core(
        t(rij), t(numbers[pj].astype(float)), t(pi, torch.int64),
        t(np.searchsorted(uniq, key_pairs), torch.int64),
        t(np.searchsorted(uniq, key_self), torch.int64), t(ids, torch.int64),
        t(seq[:, 0], torch.int64), t(q), t(G0), nmax=nmax, lmax=lmax,
        natoms=natoms, nseq=len(seq), rcut=rcut, alpha=alpha,
        derivative=True, cutoff="cosine")
    return {"x": x, "dxdr": dxdr, "seq": seq}
