r"""Covariance assembly for the GP: the training covariance ``k_self``,
its hyperparameter pair ``k_self_dual``, the serving cross-covariance
``k_block`` and the variance diagonals -- the part of the JAX package's
``ops/kernels.py`` that fitting, training and serving call.

Both builders go through the operand form of ``ops/kff.py``: K_FF and
K_EF run the CUDA kernels for float32 tensors on the card and the plain
PyTorch versions on the CPU; K_EE is a plain product over the same
operands.  Rows/cols are ordered [energies..., 3 rows per force point...]
(the reference's build_covariance, kernels/base.py:3-30).  Only the RBF
kernel is ported.
"""
from __future__ import annotations

import torch

from .kff import (_coeffs, _mirror, _scalars, energy_operand, force_operand,
                  kee_from_ops, kef_from_ops, kef_plain, kff_from_ops,
                  kff_plain)
from .packing import EnergyData, ForceData


def _blocks(K_ee, K_ef, K_fe, K_ff):
    return torch.cat([torch.cat([K_ee, K_ef], dim=1),
                      torch.cat([K_fe, K_ff], dim=1)], dim=0)


def k_self(e: EnergyData, f: ForceData, params, zeta: int = 2):
    """Symmetric training covariance (K_FE = K_EF^T, RBF_mb.py:161-165).

    The operands are built ONCE and every block reads the same tensors,
    so K_EE, K_EF and K_FF are one consistent Gram (PSD contract,
    kernels.py:708-717 of the JAX package); K_FF runs the triangular
    kernel K1."""
    A, B = e.x.shape[1], f.x.shape[1]
    U, w = energy_operand(e)
    X, re = force_operand(f)
    K_ee = kee_from_ops(U, w, A, U, w, A, params, zeta)
    K_ef = kef_from_ops(U, w, A, X, re, B, params, zeta)
    K_ff = kff_from_ops(X, re, B, X, re, B, params, zeta, symmetric=True)
    return _blocks(K_ee, K_ef, K_ef.T, K_ff)


def k_self_dual(e: EnergyData, f: ForceData, params, zeta: int = 2,
                plain: bool = False):
    """(K, dK/dgamma) of the symmetric training covariance, gamma =
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
            params, zeta: int = 2):
    """[[K_EE, K_EF], [K_FE, K_FF]] for (rows: data1, cols: data2) -- the
    serving cross-covariance.  K_FE is kernel K2 in the other orientation,
    transposed; K_FF is the rectangular kernel K3."""
    A1, B1 = e1.x.shape[1], f1.x.shape[1]
    A2, B2 = e2.x.shape[1], f2.x.shape[1]
    U1, w1 = energy_operand(e1)
    X1, re1 = force_operand(f1)
    U2, w2 = energy_operand(e2)
    X2, re2 = force_operand(f2)
    K_ee = kee_from_ops(U1, w1, A1, U2, w2, A2, params, zeta)
    K_ef = kef_from_ops(U1, w1, A1, X2, re2, B2, params, zeta)
    K_fe = kef_from_ops(U2, w2, A2, X1, re1, B1, params, zeta).T
    K_ff = kff_from_ops(X1, re1, B1, X2, re2, B2, params, zeta)
    return _blocks(K_ee, K_ef, K_fe, K_ff)


def diag_energy(e: EnergyData, params, zeta: int = 2):
    """Per-point K_EE(p, p), (m,)."""
    m, A = e.x.shape[:2]
    sigma2, gamma = _scalars(params)
    U, w = energy_operand(e)
    U = U.reshape(m, A, -1)
    wgt, ele = w[0].reshape(m, A), w[1].reshape(m, A)
    k, _, _, _ = _coeffs(torch.bmm(U, U.transpose(1, 2)), sigma2, gamma,
                         zeta)
    mask = (wgt[:, :, None] * wgt[:, None, :]
            * (ele[:, :, None] == ele[:, None, :]))
    return (k * mask).sum(dim=(1, 2))


def diag_force(f: ForceData, params, zeta: int = 2):
    """Per-point diagonal of the 3 x 3 K_FF(p, p) block, (m, 3)."""
    m, B = f.x.shape[:2]
    sigma2, gamma = _scalars(params)
    X, re = force_operand(f)
    X = X.reshape(4, m, B, -1)
    G = torch.einsum("ipad,jpbd->ijpab", X, X)          # (4, 4, m, B, B)
    rinv, ele = re[0].reshape(m, B), re[1].reshape(m, B)
    w = (rinv[:, :, None] * rinv[:, None, :]
         * (ele[:, :, None] == ele[:, None, :]))
    _, A, Bc, _ = _coeffs(G[0, 0], sigma2, gamma, zeta)
    A, Bc = A * w, Bc * w
    cols = [(A * G[1 + u, 1 + u] + Bc * G[1 + u, 0] * G[0, 1 + u])
            .sum(dim=(1, 2)) for u in range(3)]
    return torch.stack(cols, dim=1)
