r"""K_FF / K_EF covariance blocks: operand builders, hand-written CUDA
kernels (``csrc/kff.cu``) and their plain PyTorch versions.

Port of the JAX package's ``ops/kff_pallas.py``.  Each block side is
first turned into matmul operands (``force_operand``/``energy_operand``):

    u  = x / |x|,   Jt_u = J_u - (J_u . u) u    (per environment)
    X  = [u; Jt_x; Jt_y; Jt_z]                  (4, N, DP), DP = 32
    re = [rinv, element id]                      (2, N)

which reduces the reference's force-force formula (rbf_kernel.cpp:342-473)
to c = u1.u2, p1_u = Jt1_u.u2, p2_v = u1.Jt2_v, m_uv = Jt1_u.Jt2_v and

    K_FF[(p,u),(q,v)] = sum_{a in p, b in q} A(c) m_uv + B(c) p1_u p2_v
    K_EF[p,(q,v)]     = sum_{a in p, b in q} A0(c) w_a rinv_b p2_v

with the coefficients of ``_coeffs`` for the kernel family ``kind``:

    rbf: k = s2 exp((c^z - 1) g),  A = k g z c^(z-1),
         B = k g (z(z-1) c^(z-2) + (z c^(z-1))^2 g),  A0 = -A
    dot: k = s2 (c^z + s0^2),      A = s2 z c^(z-1),
         B = s2 z(z-1) c^(z-2),                      A0 = -A

(gamma = 1 / (2 l^2)).  The Dot force blocks carry no exp, and sigma0
enters K_EE alone, through the additive constant s2 s0^2.  Padding and
|x| < EPS carry rinv = 0 (w = 0 on the energy side).  ``dual=True``
(RBF only, as in the JAX package) adds the same sums with the d/dgamma
coefficients, so one pass gives (K, dK/dgamma) for the analytic NLL
gradient.  Every block of one training covariance must consume the SAME
operand tensors (PSD contract, kff_pallas.py:448-459): build once, pass
everywhere.

Routes.  ``kff_from_ops`` and ``kef_from_ops`` take the plain version for
tensors on the CPU (any float dtype) and launch the CUDA kernels for
float32 tensors on a CUDA device; anything else on CUDA raises.  The
kernels (K1 ``kff_tri``, K2 ``kef_rect``, K3 ``kff_rect``, the dual
passes ``kff_tri_dual``, ``kef_rect_dual`` and the Dot variants
``kff_tri_dot``, ``kef_rect_dot``, ``kff_rect_dot``) are built with nvcc
at first use into the package's git-ignored ``build/`` directory and
bound with ctypes.  ``launches`` counts each kernel launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import config
from ..native import BUILD_DIR

DP = 32                  # padded descriptor width of the operand rows
_PAIR_BUDGET = 2 ** 24   # env pairs per chunk of the plain versions
_SRC = Path(__file__).resolve().parents[1] / "csrc" / "kff.cu"
_MAX_POINTS = 65535 * 8  # grid.y limit at 8 points per tile (csrc/kff.cu)

# kernel name -> launches since the last reset_launches()
launches = {"kff_tri": 0, "kef_rect": 0, "kff_rect": 0,
            "kff_tri_dual": 0, "kef_rect_dual": 0,
            "kff_tri_dot": 0, "kef_rect_dot": 0, "kff_rect_dot": 0}
KINDS = ("rbf", "dot")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def _pad_lanes(a: torch.Tensor) -> torch.Tensor:
    d = a.shape[-1]
    width = -(-d // DP) * DP
    if width == d:
        return a.contiguous()
    return torch.nn.functional.pad(a, (0, width - d)).contiguous()


def force_operand(f):
    """(X (4, N, DP), re (2, N)) for a ForceData side, N = m * B."""
    m, B, d = f.x.shape
    x = f.x.reshape(m * B, d)
    ele = f.ele.reshape(-1)
    n = torch.sqrt(torch.sum(x * x, dim=1))
    valid = (n > config.EPS) & (ele > 0)
    nsafe = torch.where(valid, n, torch.ones_like(n))
    u = x / nsafe[:, None]
    rinv = torch.where(valid, 1.0 / nsafe, torch.zeros_like(n))
    J = f.dxdr.reshape(m * B, d, 3)
    q = torch.einsum("ndu,nd->nu", J, u)
    Jt = J - u[:, :, None] * q[:, None, :]
    X = torch.cat([u[None], Jt.permute(2, 0, 1)], dim=0)     # (4, N, d)
    re = torch.stack([rinv, ele.to(x.dtype)])
    return _pad_lanes(X), re.contiguous()


def energy_operand(e):
    """(U (N, DP), w (2, N)) for an EnergyData side: unit descriptors and
    [valid / count, element id], N = m * A."""
    m, A, d = e.x.shape
    x = e.x.reshape(m * A, d)
    ele = e.ele.reshape(-1)
    n = torch.sqrt(torch.sum(x * x, dim=1))
    valid = (n > config.EPS) & (ele > 0)
    u = x / torch.where(valid, n, torch.ones_like(n))[:, None]
    inv_count = torch.repeat_interleave(1.0 / e.counts, A)
    w = torch.stack([torch.where(valid, inv_count, torch.zeros_like(n)),
                     ele.to(x.dtype)])
    return _pad_lanes(u), w.contiguous()


def _scalars(params, kind: str = "rbf", dual: bool = False):
    """(sigma^2, gamma = 1 / (2 l^2)) for RBF, (sigma^2, sigma0^2) for Dot.
    Tensor hyperparameters pass through, so the plain versions can be
    differentiated by autograd.  Every block function reads its scalars
    here first, so an unknown kind or a Dot dual pass raises before any
    work."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if dual and kind != "rbf":
        raise NotImplementedError(
            "the Dot kernel has no dual pass (its sigma0 derivative is "
            "count_ee, ops/kernels.py)")
    second = params["l" if kind == "rbf" else "sigma0"]
    sigma = params["sigma"]
    sigma = sigma if torch.is_tensor(sigma) else float(sigma)
    second = second if torch.is_tensor(second) else float(second)
    if kind == "rbf":
        return sigma * sigma, 1.0 / (2.0 * second * second)
    return sigma * sigma, second * second


def _coeffs(c, sigma2, p2, zeta: int, kind: str = "rbf",
            dual: bool = False):
    """Per-pair scalars (k, A, B, A0) of the kernel family; p2 is the
    second scalar of ``_scalars``.  RBF: k = s2 exp((c^z - 1) g),
    A = k g z c^(z-1), B = k g (z(z-1) c^(z-2) + (z c^(z-1))^2 g).
    Dot: k = s2 (c^z + s0^2), A = s2 z c^(z-1), B = s2 z(z-1) c^(z-2).
    A0 = -A for both.  dual=True (RBF) also returns their d/dg,
    (k (D-1), A (D-1) + k z c^(z-1),
    B (D-1) + k (z(z-1) c^(z-2) + 2 (z c^(z-1))^2 g), -dA), D = c^z
    (kff_pallas.py:189-206, 780-791)."""
    if zeta == 1:
        d1 = torch.ones_like(c)
        dm2 = torch.zeros_like(c)
    elif zeta == 2:
        d1 = c
        dm2 = torch.ones_like(c)
    else:
        dm2 = c
        for _ in range(zeta - 3):
            dm2 = dm2 * c
        d1 = dm2 * c
    D = d1 * c
    zd1 = zeta * d1
    b0 = zeta * (zeta - 1) * dm2
    if kind == "dot":
        A = sigma2 * zd1
        return sigma2 * (D + p2), A, sigma2 * b0, -A
    gamma = p2
    k = sigma2 * torch.exp((D - 1.0) * gamma)
    kg = k * gamma
    A = kg * zd1
    B = kg * (b0 + zd1 * zd1 * gamma)
    if not dual:
        return k, A, B, -A
    Dm1 = D - 1.0
    dA = A * Dm1 + k * zd1
    dB = B * Dm1 + k * (b0 + 2.0 * zd1 * zd1 * gamma)
    return (k, A, B, -A), (k * Dm1, dA, dB, -dA)


def _sets(c, sigma2, p2, zeta: int, kind: str, dual: bool):
    """The coefficient sets of one pass: [K] or [K, dK/dgamma]."""
    if dual:
        return list(_coeffs(c, sigma2, p2, zeta, kind, dual=True))
    return [_coeffs(c, sigma2, p2, zeta, kind)]


def _mirror(K):
    """Exactly symmetric K from its upper triangle."""
    return torch.triu(K) + torch.triu(K, 1).T


def _point_sum(env, b1: int, b2: int):
    """(n1, n2) env-pair plane -> (n1 / b1, n2 / b2) point sums."""
    n1, n2 = env.shape
    return env.reshape(n1 // b1, b1, n2).sum(1).reshape(
        n1 // b1, n2 // b2, b2).sum(2)


def _chunk_points(b1: int, n2: int) -> int:
    return max(1, _PAIR_BUDGET // max(b1 * n2, 1))


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU route, and the reference for the kernels)
# ---------------------------------------------------------------------------

def kff_plain(X1, re1, B1: int, X2, re2, B2: int, params, zeta: int,
              symmetric: bool = False, dual: bool = False,
              kind: str = "rbf"):
    """K_FF (3 m1, 3 m2) from operands; dual=True returns (K, dK/dgamma)
    from one pass.  symmetric=True (X1 is X2) computes the row stripes'
    upper part only and mirrors the strict upper triangle, so the result
    is exactly symmetric."""
    sigma2, p2 = _scalars(params, kind, dual)
    m1, m2 = X1.shape[1] // B1, X2.shape[1] // B2
    outs = [X1.new_zeros((m1, 3, m2, 3)) for _ in range(1 + dual)]
    pc = _chunk_points(B1, X2.shape[1])
    for p0 in range(0, m1, pc):
        p1 = min(m1, p0 + pc)
        q0 = p0 if symmetric else 0
        L = X1[:, p0 * B1:p1 * B1]
        R = X2[:, q0 * B2:]
        G = torch.einsum("ind,jmd->ijnm", L, R)            # (4, 4, n, m)
        rl, rr = re1[:, p0 * B1:p1 * B1], re2[:, q0 * B2:]
        w = (rl[0][:, None] * rr[0][None, :]
             * (rl[1][:, None] == rr[1][None, :]))
        for out, (_, A, B, _) in zip(
                outs, _sets(G[0, 0], sigma2, p2, zeta, kind, dual)):
            A, B = A * w, B * w
            for u in range(3):
                Bp1 = B * G[1 + u, 0]
                for v in range(3):
                    env = A * G[1 + u, 1 + v] + Bp1 * G[0, 1 + v]
                    out[p0:p1, u, q0:, v] = _point_sum(env, B1, B2)
    outs = [o.reshape(3 * m1, 3 * m2) for o in outs]
    if symmetric:
        outs = [_mirror(o) for o in outs]
    return tuple(outs) if dual else outs[0]


def kef_plain(U1, w1, A1: int, X2, re2, B2: int, params, zeta: int,
              dual: bool = False, kind: str = "rbf"):
    """K_EF (m1, 3 m2) from operands; dual=True returns (K, dK/dgamma)."""
    sigma2, p2 = _scalars(params, kind, dual)
    m1, m2 = U1.shape[0] // A1, X2.shape[1] // B2
    outs = [U1.new_zeros((m1, m2, 3)) for _ in range(1 + dual)]
    pc = _chunk_points(A1, X2.shape[1])
    for p0 in range(0, m1, pc):
        p1 = min(m1, p0 + pc)
        L = U1[p0 * A1:p1 * A1]
        G = torch.einsum("nd,jmd->jnm", L, X2)             # (4, n, m)
        wl = w1[:, p0 * A1:p1 * A1]
        w = (wl[0][:, None] * re2[0][None, :]
             * (wl[1][:, None] == re2[1][None, :]))
        for out, (_, _, _, A0) in zip(
                outs, _sets(G[0], sigma2, p2, zeta, kind, dual)):
            A0 = A0 * w
            for v in range(3):
                out[p0:p1, :, v] = _point_sum(A0 * G[1 + v], A1, B2)
    outs = [o.reshape(m1, 3 * m2) for o in outs]
    return tuple(outs) if dual else outs[0]


def kee_from_ops(U1, w1, A1: int, U2, w2, A2: int, params, zeta: int,
                 dual: bool = False, kind: str = "rbf"):
    """K_EE (m1, m2) from energy operands (plain PyTorch on any device: the
    block is small next to K_FF, but it reads the same operand tensors as
    the kernels so the training covariance stays one consistent Gram).
    dual=True returns (K, dK/dgamma).  Dot: s2 (c^z + s0^2) over the
    masked pairs; its constant part is s2 s0^2 count_ee."""
    sigma2, p2 = _scalars(params, kind, dual)
    m1, m2 = U1.shape[0] // A1, U2.shape[0] // A2
    outs = [U1.new_zeros((m1, m2)) for _ in range(1 + dual)]
    pc = _chunk_points(A1, U2.shape[0])
    for p0 in range(0, m1, pc):
        p1 = min(m1, p0 + pc)
        c = torch.matmul(U1[p0 * A1:p1 * A1], U2.T)
        wl = w1[:, p0 * A1:p1 * A1]
        w = (wl[0][:, None] * w2[0][None, :]
             * (wl[1][:, None] == w2[1][None, :]))
        D = c
        for _ in range(zeta - 1):
            D = D * c
        if kind == "dot":
            k = sigma2 * (D + p2)
        else:
            k = sigma2 * torch.exp((D - 1.0) * p2)
        outs[0][p0:p1] = _point_sum(k * w, A1, A2)
        if dual:
            outs[1][p0:p1] = _point_sum(k * (D - 1.0) * w, A1, A2)
    return tuple(outs) if dual else outs[0]


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> tuple[Path, str]:
    """Compile ``csrc/kff.cu`` for sm_90a into ``build/`` (skipped when the
    library for this source already exists).  Returns (library path,
    compiler output).  The library is written under a temporary name and
    renamed into place, so concurrent processes never load a partial
    file."""
    src = _SRC.read_bytes()
    out = BUILD_DIR / f"libkff-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", tmp, str(_SRC)],
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, res.stdout + res.stderr


def _lib():
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name in ("kff_rect", "kef_rect"):
            fn = getattr(lib, name)
            fn.argtypes = [P, P, I, I, P, P, I, I, P, F, F, I, P]
            fn.restype = I
        lib.kef_rect_dual.argtypes = [P, P, I, I, P, P, I, I, P, P, F, F,
                                      I, P]
        lib.kef_rect_dual.restype = I
        lib.kff_tri.argtypes = [P, P, I, I, P, F, F, I, P]
        lib.kff_tri.restype = I
        lib.kff_tri_dual.argtypes = [P, P, I, I, P, P, F, F, I, P]
        lib.kff_tri_dual.restype = I
        for name in ("kff_rect_dot", "kef_rect_dot"):
            fn = getattr(lib, name)
            fn.argtypes = [P, P, I, I, P, P, I, I, P, F, I, P]
            fn.restype = I
        lib.kff_tri_dot.argtypes = [P, P, I, I, P, F, I, P]
        lib.kff_tri_dot.restype = I
        _LIB = lib
    return _LIB


def _check_cuda(zeta: int, *tensors):
    if zeta < 1:
        raise ValueError(f"zeta must be a positive integer, got {zeta}")
    for t in tensors:
        if t.device != tensors[0].device or t.device.type != "cuda":
            raise ValueError("kernel operands must all lie on one card")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype} "
                            "(float64 on the card is not ported yet)")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _check_side(X, re, B: int, comps: int):
    if X.dim() != 3 or X.shape[0] != comps or X.shape[2] != DP:
        raise ValueError(f"operand shape {tuple(X.shape)} is not "
                         f"({comps}, N, {DP})")
    if re.shape != (2, X.shape[1]) or B < 1 or X.shape[1] % B:
        raise ValueError("operand rows do not match the env count")
    if X.shape[1] // B > _MAX_POINTS:
        raise ValueError("too many points for one kernel launch")


def _launch(name, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_lib(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1


def kff_from_ops(X1, re1, B1: int, X2, re2, B2: int, params, zeta: int,
                 symmetric: bool = False, dual: bool = False,
                 kind: str = "rbf"):
    """K_FF (3 m1, 3 m2) from force operands; symmetric=True (X1 is X2)
    runs the triangular kernel K1, else the rectangular K3 (``_dot`` for
    kind="dot").  dual=True (RBF, symmetric only) returns (K, dK/dgamma)
    from one pass, K1-dual."""
    sigma2, p2 = _scalars(params, kind, dual)
    if dual and not symmetric:
        raise NotImplementedError(
            "the dK/dgamma pass of the rectangular K_FF (K3 deriv) is not "
            "ported yet (ROADMAP.md, section 2)")
    if X1.device.type == "cpu":
        return kff_plain(X1, re1, B1, X2, re2, B2, params, zeta,
                         symmetric=symmetric, dual=dual, kind=kind)
    _check_cuda(zeta, X1, re1, X2, re2)
    _check_side(X1, re1, B1, 4)
    _check_side(X2, re2, B2, 4)
    # the Dot force blocks need sigma^2 alone (sigma0 enters K_EE only)
    scalars = (sigma2, p2) if kind == "rbf" else (sigma2,)
    suffix = "_dot" if kind == "dot" else ""
    m1, m2 = X1.shape[1] // B1, X2.shape[1] // B2
    out = torch.empty((3 * m1, 3 * m2), dtype=torch.float32,
                      device=X1.device)
    if symmetric:
        if X1.data_ptr() != X2.data_ptr() or B1 != B2:
            raise ValueError("symmetric K_FF needs one operand set")
        if dual:
            outd = torch.empty_like(out)
            _launch("kff_tri_dual", X1.device, X1.data_ptr(),
                    re1.data_ptr(), m1, B1, out.data_ptr(), outd.data_ptr(),
                    *scalars, zeta)
            return out, outd
        _launch("kff_tri" + suffix, X1.device, X1.data_ptr(),
                re1.data_ptr(), m1, B1, out.data_ptr(), *scalars, zeta)
    else:
        _launch("kff_rect" + suffix, X1.device, X1.data_ptr(),
                re1.data_ptr(), m1, B1, X2.data_ptr(), re2.data_ptr(), m2,
                B2, out.data_ptr(), *scalars, zeta)
    return out


def kef_from_ops(U1, w1, A1: int, X2, re2, B2: int, params, zeta: int,
                 dual: bool = False, kind: str = "rbf"):
    """K_EF (m1, 3 m2) from energy and force operands (kernel K2, or
    K2-dot); dual=True (RBF) returns (K, dK/dgamma) from one pass,
    K2-dual."""
    sigma2, p2 = _scalars(params, kind, dual)
    if U1.device.type == "cpu":
        return kef_plain(U1, w1, A1, X2, re2, B2, params, zeta, dual=dual,
                         kind=kind)
    _check_cuda(zeta, U1, w1, X2, re2)
    _check_side(U1[None], w1, A1, 1)
    _check_side(X2, re2, B2, 4)
    m1, m2 = U1.shape[0] // A1, X2.shape[1] // B2
    out = torch.empty((m1, 3 * m2), dtype=torch.float32, device=U1.device)
    args = (U1.data_ptr(), w1.data_ptr(), m1, A1, X2.data_ptr(),
            re2.data_ptr(), m2, B2, out.data_ptr())
    if kind == "dot":
        _launch("kef_rect_dot", U1.device, *args, sigma2, zeta)
        return out
    if dual:
        outd = torch.empty_like(out)
        _launch("kef_rect_dual", U1.device, *args, outd.data_ptr(), sigma2,
                p2, zeta)
        return out, outd
    _launch("kef_rect", U1.device, *args, sigma2, p2, zeta)
    return out
