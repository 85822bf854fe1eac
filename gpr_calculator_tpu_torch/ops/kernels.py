r"""Covariance assembly for the GP: the training covariance ``k_self``,
its RBF hyperparameter pair ``k_self_dual``, the serving
cross-covariance ``k_block``, the variance diagonals and the Dot
kernel's pair-count matrix ``count_ee`` -- the part of the JAX package's
``ops/kernels.py`` that fitting, training and serving call.

Every block function goes through the operand form of ``ops/kff.py``:
K_FF and K_EF run the CUDA kernels for float32 tensors on the card and
the plain PyTorch versions on the CPU; K_EE is a plain product over the
same operands.  Rows/cols are ordered [energies..., 3 rows per force point...]
(the reference's build_covariance, kernels/base.py:3-30).  ``kind`` is
the kernel family, "rbf" or "dot" (``ops/kff.py`` has both sets of
coefficients).
"""
from __future__ import annotations

import torch

from .kff import (_coeffs, _mirror, _point_sum, _scalars, energy_operand,
                  force_operand, kee_from_ops, kef_from_ops, kef_plain,
                  kff_from_ops, kff_plain)
from .packing import EnergyData, ForceData


def _blocks(K_ee, K_ef, K_fe, K_ff):
    return torch.cat([torch.cat([K_ee, K_ef], dim=1),
                      torch.cat([K_fe, K_ff], dim=1)], dim=0)


def k_self(e: EnergyData, f: ForceData, params, zeta: int = 2,
           kind: str = "rbf", plain: bool = False, dtype=None):
    """Symmetric training covariance (K_FE = K_EF^T, RBF_mb.py:161-165).

    The operands are built ONCE and every block reads the same tensors,
    so K_EE, K_EF and K_FF are one consistent Gram (PSD contract,
    kernels.py:708-717 of the JAX package); K_FF runs the triangular
    kernel K1 (K1-dot for kind="dot").  plain=True takes the plain
    versions on any device.  dtype (default: the operands') is the
    result's: K_EE is computed in it from the same operand values, the
    force blocks are cast to it."""
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = energy_operand(e)
    X, re = force_operand(f)
    kef = kef_plain if plain else kef_from_ops
    kff = kff_plain if plain else kff_from_ops
    dt = U.dtype if dtype is None else dtype
    Ud, wd = U.to(dt), w.to(dt)
    K_ee = kee_from_ops(Ud, wd, A, Ud, wd, A, params, zeta, kind=kind)
    K_ef = kef(U, w, A, X, re, B, params, zeta, kind=kind).to(dt)
    K_ff = kff(X, re, B, X, re, B, params, zeta, symmetric=True,
               kind=kind).to(dt)
    return _blocks(K_ee, K_ef, K_ef.T, K_ff)


def k_self_dual(e: EnergyData, f: ForceData, params, zeta: int = 2,
                plain: bool = False):
    """(K, dK/dgamma) of the symmetric RBF training covariance, gamma =
    1 / (2 l^2): one fused pass per block (K1-dual, K2-dual on the card),
    which the analytic NLL gradient runs at every L-BFGS-B evaluation.

    As in ``k_self`` the operands are built once and all three blocks
    read the same tensors (PSD contract); both matrices come out exactly
    symmetric.  plain=True takes the plain versions on any device (the
    float64 reference on the card)."""
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = energy_operand(e)
    X, re = force_operand(f)
    ee = [_mirror(b) for b in kee_from_ops(U, w, A, U, w, A, params, zeta,
                                           dual=True)]
    kef = kef_plain if plain else kef_from_ops
    kff = kff_plain if plain else kff_from_ops
    ef = kef(U, w, A, X, re, B, params, zeta, dual=True)
    ff = kff(X, re, B, X, re, B, params, zeta, symmetric=True, dual=True)
    return tuple(_blocks(ee[i], ef[i], ef[i].T, ff[i]) for i in range(2))


def k_block(e1: EnergyData, f1: ForceData, e2: EnergyData, f2: ForceData,
            params, zeta: int = 2, kind: str = "rbf"):
    """[[K_EE, K_EF], [K_FE, K_FF]] for (rows: data1, cols: data2) -- the
    serving cross-covariance.  K_FE is kernel K2 in the other orientation,
    transposed; K_FF is the rectangular kernel K3."""
    A1, B1 = e1.x.shape[1], f1.x.shape[1]
    A2, B2 = e2.x.shape[1], f2.x.shape[1]
    U1, w1 = energy_operand(e1)
    X1, re1 = force_operand(f1)
    U2, w2 = energy_operand(e2)
    X2, re2 = force_operand(f2)
    K_ee = kee_from_ops(U1, w1, A1, U2, w2, A2, params, zeta, kind=kind)
    K_ef = kef_from_ops(U1, w1, A1, X2, re2, B2, params, zeta, kind=kind)
    K_fe = kef_from_ops(U2, w2, A2, X1, re1, B1, params, zeta, kind=kind).T
    K_ff = kff_from_ops(X1, re1, B1, X2, re2, B2, params, zeta, kind=kind)
    return _blocks(K_ee, K_ef, K_fe, K_ff)


def count_ee(e: EnergyData):
    """Masked pair-count matrix W[p, q] = sum over valid same-element env
    pairs (a in p, b in q) of 1 / (N_p N_q), (m, m) -- dK_EE/d(sigma0^2)
    / sigma^2 of the Dot kernel, whose sigma0 enters only through the
    additive constant s2 s0^2 (kernels.py:492-505 of the JAX package).
    Read from the energy operand, as K_EE is."""
    A = e.x.shape[1]
    _, w = energy_operand(e)
    pair = w[0][:, None] * w[0][None, :] * (w[1][:, None] == w[1][None, :])
    return _point_sum(pair, A, A)


def diag_energy(e: EnergyData, params, zeta: int = 2, kind: str = "rbf"):
    """Per-point K_EE(p, p), (m,)."""
    m, A = e.x.shape[:2]
    sigma2, p2 = _scalars(params, kind)
    U, w = energy_operand(e)
    U = U.reshape(m, A, -1)
    wgt, ele = w[0].reshape(m, A), w[1].reshape(m, A)
    k, _, _, _ = _coeffs(torch.bmm(U, U.transpose(1, 2)), sigma2, p2, zeta,
                         kind)
    mask = (wgt[:, :, None] * wgt[:, None, :]
            * (ele[:, :, None] == ele[:, None, :]))
    return (k * mask).sum(dim=(1, 2))


def diag_force(f: ForceData, params, zeta: int = 2, kind: str = "rbf"):
    """Per-point diagonal of the 3 x 3 K_FF(p, p) block, (m, 3)."""
    m, B = f.x.shape[:2]
    sigma2, p2 = _scalars(params, kind)
    X, re = force_operand(f)
    X = X.reshape(4, m, B, -1)
    G = torch.einsum("ipad,jpbd->ijpab", X, X)          # (4, 4, m, B, B)
    rinv, ele = re[0].reshape(m, B), re[1].reshape(m, B)
    w = (rinv[:, :, None] * rinv[:, None, :]
         * (ele[:, :, None] == ele[:, None, :]))
    _, A, Bc, _ = _coeffs(G[0, 0], sigma2, p2, zeta, kind)
    A, Bc = A * w, Bc * w
    cols = [(A * G[1 + u, 1 + u] + Bc * G[1 + u, 0] * G[0, 1 + u])
            .sum(dim=(1, 2)) for u in range(3)]
    return torch.stack(cols, dim=1)
