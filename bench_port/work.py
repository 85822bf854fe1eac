"""Work counts and the published peaks: the least time the card could
take for what the inputs need, whatever implements it.

Peaks of one NVIDIA H100 SXM (data sheet, dense; frozen from
chip_smoke.py): 67 TFLOP/s float32 outside the tensor cores, 67 TFLOP/s
float64 on the tensor cores (DMMA), 34 TFLOP/s float64 on the CUDA
cores, 3.35 TB/s of HBM3.

Operations per valid same-element env pair: a K_FF pair needs 16 dot
products of length d (2 d operations each) and the assembly, a K_EF pair
4 dot products and its assembly, a K_EE pair one dot product (float64,
on the tensor cores) and its float64 assembly; each plane of a block
pays its assembly again.  The assembly follows the kernel's family
(``inputs["family"]``, the configuration's):

- RBF (chip_smoke.py's ``work``): K_FF 40 for K and 46 for dK/dgamma,
  K_EF 12 and 10, K_EE ~8 a plane.
- Dot, counted from reference/kernels.py's formulas (a multiply, an
  add, a fused multiply-add, a power one operation each; s2 z,
  s2 z (z-1) and s2 s0^2 constants of a call; the same count gives the
  RBF's K planes 37 and 13): K_FF 28 -- c^(z-2), c^(z-1), A = s2 z
  c^(z-1), B = s2 z (z-1) c^(z-2) (4); w = r_a r_b, A w, B w (3);
  B w (Jt_a,u . u_b) for u = 1..3 (3); each of the 9 entries two fused
  multiply-adds (18).  K_EF 7 -- c^(z-1), A (2); w = w_a r_b, -A w (2);
  3 fused multiply-adds.  K_EE 4 -- c^z, k = s2 c^z + s2 s0^2, w_a w_b,
  one fused multiply-add.  One plane: the Dot NLL builds K alone, its
  sigma0 derivative W (the energy block's pair counts) being constant in
  theta and left uncounted.

A symmetric block counts the upper triangle of point pairs, diagonal
point blocks whole.  Bytes: each operand read once, each output written
once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

PEAK_FP32, PEAK_FP64_TC, PEAK_FP64, PEAK_BYTES = 67e12, 67e12, 34e12, \
    3.35e12


class Assembly(NamedTuple):
    """A family's assembly operations a valid same-element env pair, one
    entry a plane (K, then dK/dgamma where the family has it)."""
    ff: tuple
    ef: tuple
    ee: int


ASSEMBLY = {"RBF": Assembly((40, 46), (12, 10), 8),
            "Dot": Assembly((28,), (7,), 4)}


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
    K_EF) and float64 K_EE, its output float64 (two planes with dual,
    which the Dot family has not)."""
    d, ee, fe = inputs["d"], inputs["e_ele"], inputs["f_ele"]
    asm = ASSEMBLY[inputs["family"]]
    ne, nf = ee.size, fe.size
    n = ee.shape[0] + 3 * fe.shape[0]
    planes = 2 if dual else 1
    if planes > len(asm.ff):
        raise ValueError(f"the {inputs['family']} kernel has no dual plane")
    asm_ff = sum(asm.ff[:planes])
    asm_ef = sum(asm.ef[:planes])
    out = 8 * n * n * planes
    ff = _t(pairs(fe) * (16 * 2 * d + asm_ff), PEAK_FP32,
            nf * (4 * d + 2) * 4)
    ef = _t(pairs(ee, fe) * (4 * 2 * d + asm_ef), PEAK_FP32,
            (ne * (d + 2) + nf * (4 * d + 2)) * 4)
    p = pairs(ee)
    kee = p * 2 * d / PEAK_FP64_TC + p * asm.ee * planes / PEAK_FP64
    return ff + ef + kee + out / PEAK_BYTES


def nll_bound_s(inputs):
    """One NLL and gradient evaluation: the covariance with every plane
    of the family (RBF: the dual, Dot: K alone), a float64 Cholesky (n^3
    / 3) and the inverse the exact trace forms (2 n^3 / 3), both on the
    FP64 tensor cores."""
    n = inputs["e_ele"].shape[0] + 3 * inputs["f_ele"].shape[0]
    dual = len(ASSEMBLY[inputs["family"]].ff) > 1
    return cov_bound_s(inputs, dual=dual) + n ** 3 / PEAK_FP64_TC


def fit_bound_s(inputs, evals: float):
    """A fit of ``evals`` NLL evaluations and one factorisation (the
    covariance and an n^3 / 3 Cholesky)."""
    n = inputs["e_ele"].shape[0] + 3 * inputs["f_ele"].shape[0]
    return (evals * nll_bound_s(inputs) + cov_bound_s(inputs, dual=False)
            + n ** 3 / 3 / PEAK_FP64_TC)
