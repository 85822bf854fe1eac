"""Global configuration for the PyTorch port: working device, dtype, the
matmul precision of the covariance kernels and the two toggles of the
mesh-sharded builds.

The working device is the CUDA card.  With no card the port refuses to
guess: ``device()`` raises until ``set_device("cpu")`` asks for the CPU
(the tests and CPU scripts do), and explicit ``device=`` arguments
(``GP(device="cpu")``) keep working either way.

The working dtype follows the device unless set explicitly: float64 on
the CPU (the parity target against the JAX package, ~1e-10) and float32
on CUDA (the counterpart of the JAX package's ``GPR_CALC_TPU_X64=0``
mode).  ``set_dtype(torch.float64)`` or ``GP(..., dtype=torch.float64)``
on CUDA is the JAX package's default ``GPR_CALC_TPU_X64=1`` mode: the
covariance blocks run on the hand-written float64 kernels (the ``_f64``
entry points of ``ops/kff.py``), which ignore the matmul precision, and
nothing of the model is rounded to float32.  Either way the covariance
blocks on the card go through hand-written kernels, never the plain
versions.

``kff_precision()`` is the matmul precision of the float32 covariance
blocks, the counterpart of the JAX package's ``_resolve_precision``
(ops/kff_pallas.py:102-108), with the same three names:

  highest  exact fp32 dot products (CUDA-core FMA)
  bf16x4   the exact Gram of inputs split into hi + lo bf16 pairs, all
           four cross terms (tensor cores, fp32 accumulation)
  bf16     the exact Gram of inputs rounded once to bf16

The port's default is "highest"; float64 operands ignore the mode.

With ``GP(mesh=...)`` two more settings apply, both "auto" by default
(the JAX package reads them from GPR_CALC_TPU_SHARDED_GATE and
GPR_CALC_TPU_SHARDED_CHOL; the port has no environment variables):

  sharded_gate  "auto": a covariance build is sharded only when every
                shard gets real work (ops/kernels.py); "off": always
  sharded_chol  "auto": the sharded blocked Cholesky from 4 shards and
                4096 rows (models/gp.py); "on" / "off": always / never
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

PRECISIONS = ("highest", "bf16x4", "bf16")

_DTYPE: torch.dtype | None = None
_DEVICE: torch.device | None = None
_PRECISION = "highest"
_SHARDED_GATE = "auto"
_SHARDED_CHOL = "auto"


def device() -> torch.device:
    """The working device: the one ``set_device`` chose, else CUDA.
    Raises when no card is present and nothing was chosen."""
    if _DEVICE is not None:
        return _DEVICE
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: gpr_calculator_tpu_torch runs on the card; "
            "call gpr_calculator_tpu_torch.config.set_device('cpu') (or "
            "pass device='cpu') to run on the CPU")
    return torch.device("cuda")


def set_device(dev) -> None:
    """Pin the working device (None: back to the card)."""
    global _DEVICE
    _DEVICE = None if dev is None else torch.device(dev)


def dtype(dev=None) -> torch.dtype:
    """The working floating dtype on ``dev`` (default: the working
    device): the one ``set_dtype`` chose, else float64 on the CPU and
    float32 on CUDA."""
    if _DTYPE is not None:
        return _DTYPE
    dev = device() if dev is None else torch.device(dev)
    return torch.float32 if dev.type == "cuda" else torch.float64


def set_dtype(dt) -> None:
    """Pin the working dtype on every device (None: back to the device's
    default); float64 on CUDA takes the float64 kernels."""
    global _DTYPE
    _DTYPE = dt


def kff_precision(mode: str | None = None) -> str:
    """``mode`` checked, or the configured precision when it is None."""
    if mode is None:
        return _PRECISION
    if mode not in PRECISIONS:
        raise ValueError(f"unknown kff matmul precision: {mode!r} "
                         f"(one of {', '.join(PRECISIONS)})")
    return mode


def set_kff_precision(mode: str) -> None:
    global _PRECISION
    _PRECISION = kff_precision(mode)


def sharded_gate() -> str:
    return _SHARDED_GATE


def set_sharded_gate(mode: str) -> None:
    global _SHARDED_GATE
    if mode not in ("auto", "off"):
        raise ValueError(f"unknown sharded gate setting: {mode!r} "
                         "(auto or off)")
    _SHARDED_GATE = mode


def sharded_chol() -> str:
    return _SHARDED_CHOL


def set_sharded_chol(mode: str) -> None:
    global _SHARDED_CHOL
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown sharded Cholesky setting: {mode!r} "
                         "(auto, on or off)")
    _SHARDED_CHOL = mode
