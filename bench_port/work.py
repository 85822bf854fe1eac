"""Work counts and the published peaks: the least time the card could
take for what the inputs need, whatever implements it.

Peaks of one NVIDIA H100 SXM (data sheet, dense; frozen from
chip_smoke.py): 67 TFLOP/s float32 outside the tensor cores, 67 TFLOP/s
float64 on the tensor cores (DMMA), 34 TFLOP/s float64 on the CUDA
cores, 3.35 TB/s of HBM3.

Operations per valid same-element env pair (chip_smoke.py's ``work``):
a K_FF pair needs 16 dot products of length d (2 d operations each) and
the assembly, 40 operations for K and 46 for dK/dgamma; a K_EF pair 4
dot products and 12 / 10; a K_EE pair one dot product (float64, on the
tensor cores) and ~8 float64 operations a plane.  A symmetric block
counts the upper triangle of point pairs, diagonal point blocks whole.
Bytes: each operand read once, each output written once.
"""
from __future__ import annotations

import numpy as np

PEAK_FP32, PEAK_FP64_TC, PEAK_FP64, PEAK_BYTES = 67e12, 67e12, 34e12, \
    3.35e12


def pairs(ele1, ele2=None):
    """Same-element env pairs between two sides (m, B) of element ids
    (0: no env); ele2 None: the symmetric block's upper triangle."""
    v1 = ele1[ele1 > 0]
    els = np.unique(v1)
    if ele2 is None:
        total = sum(int((v1 == e).sum()) ** 2 for e in els)
        diag = sum(int(((ele1 == e).sum(1) ** 2).sum()) for e in els)
        return (total + diag) // 2
    v2 = ele2[ele2 > 0]
    return sum(int((v1 == e).sum()) * int((v2 == e).sum()) for e in els)


def _t(ops, peak, nbytes):
    return max(ops / peak, nbytes / PEAK_BYTES)


def cov_bound_s(inputs, dual: bool):
    """Least seconds of the training covariance in float32 kernels (K_FF,
    K_EF) and float64 K_EE, its output float64 (two planes with dual)."""
    d, ee, fe = inputs["d"], inputs["e_ele"], inputs["f_ele"]
    ne, nf = ee.size, fe.size
    n = ee.shape[0] + 3 * fe.shape[0]
    planes = 2 if dual else 1
    asm_ff = 40 + 46 if dual else 40
    asm_ef = 12 + 10 if dual else 12
    out = 8 * n * n * planes
    ff = _t(pairs(fe) * (16 * 2 * d + asm_ff), PEAK_FP32,
            nf * (4 * d + 2) * 4)
    ef = _t(pairs(ee, fe) * (4 * 2 * d + asm_ef), PEAK_FP32,
            (ne * (d + 2) + nf * (4 * d + 2)) * 4)
    p = pairs(ee)
    kee = p * 2 * d / PEAK_FP64_TC + p * 8 * planes / PEAK_FP64
    return ff + ef + kee + out / PEAK_BYTES


def nll_bound_s(inputs):
    """One NLL and gradient evaluation: the dual covariance, a float64
    Cholesky (n^3 / 3) and the inverse the exact trace forms (2 n^3 / 3),
    both on the FP64 tensor cores."""
    n = inputs["e_ele"].shape[0] + 3 * inputs["f_ele"].shape[0]
    return cov_bound_s(inputs, dual=True) + n ** 3 / PEAK_FP64_TC


def fit_bound_s(inputs, evals: float):
    """A fit of ``evals`` NLL evaluations and one factorisation (the
    covariance and an n^3 / 3 Cholesky)."""
    n = inputs["e_ele"].shape[0] + 3 * inputs["f_ele"].shape[0]
    return (evals * nll_bound_s(inputs) + cov_bound_s(inputs, dual=False)
            + n ** 3 / 3 / PEAK_FP64_TC)
