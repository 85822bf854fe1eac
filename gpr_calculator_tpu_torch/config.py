"""Global configuration for the PyTorch port: working device and dtype.

The working dtype follows the device unless set explicitly: float64 on
the CPU (the parity target against the JAX package, ~1e-10) and float32
on CUDA, where the hand-written covariance kernels run in exact fp32 FMA
(the counterpart of the JAX package's ``GPR_CALC_TPU_X64=0`` mode).
"""
from __future__ import annotations

import torch

# float32 products must stay full fp32 (TF32 keeps ~3 decimal digits,
# far outside the GP noise floors the Cholesky has to clear)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Numerical guard used throughout the kernel math (the reference's
# eps=1e-8, gpr_calc/kernels/rbf_kernel.cpp:10).
EPS = 1e-8

_DTYPE: torch.dtype | None = None


def device() -> torch.device:
    """The working device: CUDA when a card is present, else the CPU.
    A GP can be pinned elsewhere with ``GP(device=...)``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def dtype() -> torch.dtype:
    """The working floating dtype: float64 on the CPU, float32 on CUDA."""
    if _DTYPE is not None:
        return _DTYPE
    return torch.float32 if device().type == "cuda" else torch.float64


def set_dtype(dt) -> None:
    global _DTYPE
    _DTYPE = dt
