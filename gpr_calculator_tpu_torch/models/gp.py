"""Gaussian-process regressor for on-the-fly force fields, in PyTorch.

Port of the JAX package's ``models/gp.py`` (reference:
gpr_calc/gaussianprocess.py): the same covariance structure, per-atom
energy labels, queue semantics and dispatch thresholds.  ``fit(opt=True)``
first runs scipy's L-BFGS-B over the analytic-gradient NLL of the
kernel's family (``_nll_rbf_analytic``: one fused (K, dK/dgamma) pass
per evaluation; ``_nll_dot_analytic``: one K build and the pair-count
matrix), its traces exact or estimated (``GP(trace=)``), then
refactorises from scratch; ``fit(opt=False)`` extends the factor of the
last fit by the rows appended since (``ops/linalg.py``, the JAX
package's ``_try_incremental_fit``).  Serving gives energies, forces and,
with a stress-enabled descriptor, each atom's stress rows
(``predict_structure(stress=True)``), their stds, or the full predictive
covariance (``predict(return_cov=True)``); ``sparsify`` drops the
training points CUR finds redundant.  The covariance blocks come
from ``ops/kernels.py`` (the hand-written CUDA kernels on the card), the
Cholesky factor, the solves and K^-1 from ``torch.linalg``.

Each GP works on one device and dtype (default ``config.device()`` /
``config.dtype()``), so a card model and a CPU model can live side by
side.  ``GP(mesh=...)`` (a ``parallel.Mesh`` whose root is that device)
shards the covariance builds of fitting, training and serving over the
mesh's devices, and from 4 shards and 4096 rows the Cholesky too
(``_resolve_chol_mode``); a mesh of one shard behaves as no mesh.
"""
from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.optimize import minimize

from .. import config
from ..atoms.atoms import ATOMIC_NUMBERS
from ..ops import kernels as K_ops
from ..ops import linalg
from ..ops.packing import EnergyData, ForceData, pack_energy, pack_force
from ..ops.so3 import SO3
from .kernels import RBF, Dot, kernel_from_dict


def _params_from_theta(kind: str, kp):
    if kind == "rbf":
        return {"sigma": kp[0], "l": kp[1]}
    return {"sigma": kp[0], "sigma0": kp[1]}


def _noise_diag(e: EnergyData, f: ForceData, noise_e, noise_f):
    """Noise diagonal with padded rows pinned to 1.0."""
    de = torch.full((e.m,), 1.0, dtype=e.x.dtype, device=e.x.device)
    de[:e.nreal] = noise_e ** 2
    df = torch.full((f.m,), 1.0, dtype=f.x.dtype, device=f.x.device)
    df[:f.nreal] = noise_f ** 2
    return torch.cat([de, df.repeat_interleave(3)])


def _resolve_chol_mode(mesh, n: int) -> str:
    """"replicated" (one ``torch.linalg.cholesky_ex`` on the root) or
    "sharded" (``parallel.cholesky_sharded``) for an n-row training
    covariance: the JAX package's rule (its models/gp.py:183-216).
    Sharded from 4 shards and 4096 rows, where the per-shard trailing
    update, n^3 / n_shards (1/2 + 1 / (2 n_shards)) over the rows padded
    to whole panels per shard, undercuts the n^3 / 3 of the one factor.
    ``config.set_sharded_chol("on" | "off")`` overrides."""
    mode = config.sharded_chol()
    if mesh is None or mesh.size < 2 or mode == "off":
        return "replicated"
    if mode == "on":
        return "sharded"
    if mesh.size < 4 or n < 4096:
        return "replicated"
    from ..parallel.cholesky import rows_per_shard
    n_pad = rows_per_shard(n, mesh.size) * mesh.size
    if n_pad ** 3 / mesh.size * (0.5 + 0.5 / mesh.size) > n ** 3 / 3:
        return "replicated"
    return "sharded"


def _chol_mesh(K, mesh, chol_mode: str = "replicated"):
    """(L, info) of K: info != 0 when K is not positive definite."""
    if chol_mode == "sharded" and mesh is not None:
        from ..parallel.cholesky import cholesky_sharded
        try:
            return cholesky_sharded(K, mesh), 0
        except torch.linalg.LinAlgError:
            return torch.full_like(K, math.nan), 1
    L, info = torch.linalg.cholesky_ex(K)
    return L, int(info)


# the share of a device's free memory that the float64 buffers of
# ``GP._predict_cov``, ``CUR`` and ``GP.sparsify`` may take
MEMORY_SHARE = 0.5


def _free_bytes(device) -> int:
    """The device's free memory: ``torch.cuda.mem_get_info`` on a card,
    the host's available physical memory on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _check_buffers(device, nbytes: int, what: str) -> None:
    """ValueError when ``nbytes`` of buffers for ``what`` exceed
    MEMORY_SHARE of the device's free memory (the JAX package builds
    these dense n^2 and n x n_query buffers unguarded)."""
    free = _free_bytes(device)
    if nbytes > MEMORY_SHARE * free:
        raise ValueError(
            f"{what} needs {nbytes / 2 ** 30:.3g} GiB of float64 buffers, "
            f"more than {MEMORY_SHARE} of the {free / 2 ** 30:.3g} GiB "
            f"free on {torch.device(device)}")


def _factorize(e: EnergyData, f: ForceData, y, params, noise_e: float,
               noise_f: float, zeta: int, kind: str = "rbf", mesh=None,
               chol_mode: str = "replicated"):
    """K -> (L, alpha): the training covariance plus noise, its lower
    Cholesky factor and the weights (gaussianprocess.py:288-310).  mesh:
    the build is sharded (``k_self``), and with chol_mode="sharded" the
    factorisation too; L and alpha are on the root.

    K is assembled in float64: the force blocks come from the kernels
    in the working dtype (float32 on the card by default, float64 from
    the ``_f64`` kernels for a float64 model) and are cast, K_EE is
    computed in float64 from the same rounded operands and the noise is
    added in float64.  On the MD example's final model (l ~ 0.22,
    noise_e = 2e-3 eV/atom) the whole K and the served block in float32
    put a served energy 1.5e-3-2.7e-3 eV and a force 0.016-0.019 eV/A off
    a float64 model; with K_EE, the served K_EE and the energy prior in
    float64, 1.7e-4-5.0e-4 eV and 1.8e-3-4.1e-3 eV/A (NVIDIA H100 80GB
    HBM3, 700.00 W; PERF.md).  It is factorised and solved in float64,
    as the NLL does.  L and alpha are returned in float64: the served
    mean is a float64 product of the cross covariance (kernel blocks in
    the working dtype, K_EE in float64) with alpha, the variance a float64 solve
    against L (``_predict_packed``).  At the 10 000-row bench
    covariance a float32 solve left alpha 12 % of max|alpha| off the
    float64 solve of the same K and moved a served energy by 0.14-0.16 eV,
    ten times the limit of a tenth of the noise; the float64 solve with
    alpha and the product rounded to float32 still moved it by up to
    0.018 eV, 1.4 times the limit (NVIDIA H100 80GB HBM3, 700.00 W;
    PERF.md).  The factor in float32 left the served energy variance of a
    6100-row model, ~2e-7 of its prior, all rounding (``_predict_packed``)."""
    K = K_ops.k_self(e, f, params, zeta, kind, mesh=mesh,
                     dtype=torch.float64)
    K.diagonal().add_(_noise_diag(e, f, noise_e, noise_f))
    dtype = e.x.dtype
    L, info = _chol_mesh(K, mesh, chol_mode)
    del K
    alpha = torch.cholesky_solve(y.to(torch.float64)[:, None], L)[:, 0]
    if info != 0 or not bool(torch.isfinite(alpha).all()):
        raise FloatingPointError(
            f"Cholesky factorisation failed (info={info}): K is not "
            f"positive definite at noise_e={noise_e:.2e}, "
            f"sigma={float(params['sigma']):.3g} in {dtype}")
    return L, alpha


def _split_theta(theta, noise_fixed, f_coef, noise_opt: bool):
    """theta = (sigma, second[, noise_e]) -> (kernel theta, noise_e,
    noise_f), with noise_f = f_coef noise_e when the noise is optimised."""
    theta = [float(t) for t in theta]
    if noise_opt:
        return theta[:-1], theta[-1], float(f_coef) * theta[-1]
    return theta, float(noise_fixed[0]), float(noise_fixed[1])


# The Hutchinson estimate of the NLL gradient's traces (the JAX
# package's gp.py:140-181): tr(K^-1 A) ~ <W, A Z> / p with W = K^-1 Z for
# a fixed Rademacher probe block Z (n, p), O(n^2 p) from the factor in
# place of the n^2-word K^-1 the exact trace forms.  A trace's error is
# ~sqrt(2 / p) |A|_F, sqrt(2 / (p n)) of it for an evenly spread
# spectrum; what the gradient's is at a size is what the gate measures
# (at the 10k bench shape 2.7 % (RBF) and 0.25 % (Dot) of |g| at 64
# probes, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  Z is drawn once per
# (n, p) and kept, so the estimate is one smooth function of theta
# across L-BFGS-B's evaluations.  Padded rows are exact: K is the
# identity there and z_i^2 = 1.
TRACES = ("exact", "hutch", "auto")
_HUTCH_MIN_N = 6144     # "auto": hutch from this many rows, behind the gate


def _probe_block(n: int, n_probe: int, device):
    """The fixed Rademacher probe block Z (n, n_probe), float64 on
    ``device``, from a torch.Generator seeded 0 there."""
    gen = torch.Generator(device=device).manual_seed(0)
    bits = torch.randint(0, 2, (n, n_probe), generator=gen, device=device)
    return bits.to(torch.float64) * 2.0 - 1.0


def _hutch_solve(L, n_probe: int = 64, probes=None):
    """(Z, W = K^-1 Z) from the lower factor L of K: Z the given probe
    block ``probes`` (n, p), else ``_probe_block(n, n_probe)`` on L's
    device."""
    Z = _probe_block(L.shape[0], n_probe, L.device) if probes is None \
        else probes.to(dtype=L.dtype, device=L.device)
    return Z, torch.cholesky_solve(Z, L)


def _resolve_trace_mode(n: int, trace: str = "auto") -> str:
    """The trace an n-row NLL takes: "exact" or "hutch" as asked;
    "auto" the estimate from ``_HUTCH_MIN_N`` rows on (GP.fit then runs
    the measured gate, ``GP._gated_trace_mode``)."""
    if trace not in TRACES:
        raise ValueError(f"trace must be one of {TRACES}, got {trace!r}")
    if trace != "auto":
        return trace
    return "hutch" if n >= _HUTCH_MIN_N else "exact"


class _Traces:
    """The traces tr(K^-1 A) of an NLL gradient, from the float64 lower
    factor L of K: exact from K^-1 = ``cholesky_inverse(L)``, or with
    ``hutch`` the estimate <W, A Z> / p of ``_hutch_solve``, which forms
    no K^-1."""

    def __init__(self, L, hutch: bool, n_probe: int = 64, probes=None):
        self.Kinv = None
        if hutch:
            self.Z, self.W = _hutch_solve(L, n_probe, probes)
        else:
            self.Kinv = torch.cholesky_inverse(L)
            self.kinv_diag = self.Kinv.diagonal().clone()

    def of(self, A, m=None):
        """tr(K^-1 A) of a symmetric A on the leading m rows and columns
        (m None: all of them), zero elsewhere."""
        if self.Kinv is None:
            Z = self.Z[:m]
            return torch.sum(self.W[:m] * (A @ Z)) / Z.shape[1]
        if m is None:
            return torch.dot(self.Kinv.reshape(-1), A.reshape(-1))
        return (self.Kinv[:m, :m] * A).sum()

    def of_diag(self, v):
        """tr(K^-1 diag(v))."""
        if self.Kinv is None:
            return torch.sum(self.W * (self.Z * v[:, None])) / \
                self.Z.shape[1]
        return torch.dot(self.kinv_diag, v)


def _analytic_nll(Kk, e: EnergyData, f: ForceData, y, sigma: float,
                  noise_e: float, noise_f: float, f_coef, noise_opt: bool,
                  second_grad, mesh=None, chol_mode: str = "replicated",
                  trace: str = "exact", n_probe: int = 64, probes=None):
    """(-LML, grad) from the kernel covariance Kk: the part both kernel
    families share (gp.py:270-436 of the JAX package).

    0.5 tr((K^-1 - aa^T) dK/dtheta) with dK/dsigma = 2 Kk / sigma (free:
    it reuses the solve); ``second_grad(traces, alpha)`` gives the second
    kernel hyperparameter's from a ``_Traces``.  trace="exact" takes the
    traces from K^-1 = ``cholesky_inverse(L)`` (n^2 float64 words: 800 MB
    at n = 10k), trace="hutch" estimates them from ``n_probe`` probes
    (``probes``: a given block (n, p), else ``_probe_block``) without
    forming K^-1; the value is the same computation in both.  A K that is
    not positive definite (``cholesky_ex`` info != 0) gives (+inf,
    zeros).

    Precision: Kk comes in float64 (K_EE computed in float64 from the
    rounded operands, the kernels' force blocks cast from the working
    dtype); the factor, the traces and every reduction are float64.  K
    is ill-conditioned
    where L-BFGS-B starts (RBF: cond ~1e8 at l = 0.1), and there a float32
    Cholesky alone moved the NLL by ~1e-4 of its value, and float32
    reductions the l-gradient by ~1e-3.  With chol_mode="sharded" the
    float64 factor is the mesh-sharded one."""
    if trace not in ("exact", "hutch"):
        raise ValueError(f"trace must be 'exact' or 'hutch', got {trace!r}")
    f64 = torch.float64
    nz = _noise_diag(e, f, noise_e, noise_f).to(f64)
    K = Kk.to(f64)
    del Kk
    K.diagonal().add_(nz)
    L, info = _chol_mesh(K, mesh, chol_mode)
    n = K.shape[0]
    del K
    n_theta = 3 if noise_opt else 2
    if info != 0:
        return (torch.tensor(math.inf, dtype=f64),
                torch.zeros(n_theta, dtype=f64))
    y = y.to(f64)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    n_real = e.nreal + 3 * f.nreal
    ya = torch.dot(y, alpha)
    nll = (0.5 * ya + torch.log(L.diagonal()).sum()
           + 0.5 * n_real * math.log(2 * math.pi))

    traces = _Traces(L, trace == "hutch", n_probe, probes)
    del L
    g_second = second_grad(traces, alpha)
    # tr(Kinv Kk) = n - tr(Kinv Nz); a^T Kk a = a^T y - a^T Nz a
    # (padding rows cancel through the unit noise placed on them)
    tr_kk = n - traces.of_diag(nz)
    aKka = ya - torch.dot(nz * alpha, alpha)
    g_sigma = (tr_kk - aKka) / sigma
    grads = [g_sigma, g_second]
    if noise_opt:
        valid_e = (torch.arange(e.m, device=y.device) < e.nreal).to(f64)
        valid_f = (torch.arange(f.m, device=y.device)
                   < f.nreal).to(f64).repeat_interleave(3)
        dnz = torch.cat([valid_e * (2.0 * noise_e),
                         valid_f * (2.0 * float(f_coef) ** 2 * noise_e)])
        grads.append(0.5 * (traces.of_diag(dnz)
                            - torch.dot(alpha * alpha, dnz)))
    return nll, torch.stack(grads)


def _nll_rbf_analytic(theta, e: EnergyData, f: ForceData, y, noise_fixed,
                      f_coef, zeta: int, noise_opt: bool,
                      plain: bool = False, mesh=None,
                      chol_mode: str = "replicated", trace: str = "exact",
                      n_probe: int = 64, probes=None):
    """(-LML, grad) of the RBF kernel with ANALYTIC hyperparameter
    derivatives (gp.py:270-346 of the JAX package), theta = (sigma,
    l[, noise_e]): dK/dl = dK/dgamma * (-1/l^3), where dK/dgamma comes
    from the same fused pass as K (``k_self_dual``, K_EE and dK_EE/dgamma
    computed in float64 from the rounded operands, as ``_factorize``'s K),
    and the trace tr(K^-1 dK/dgamma) is exact or, with trace="hutch",
    estimated (``_analytic_nll``).  plain=True builds the blocks with the
    plain versions on any device; mesh shards the dual pass
    (``k_self_dual``) and, by chol_mode, the factorisation."""
    kp, noise_e, noise_f = _split_theta(theta, noise_fixed, f_coef,
                                        noise_opt)
    params = _params_from_theta("rbf", kp)
    Kk, Kd = K_ops.k_self_dual(e, f, params, zeta, plain=plain, mesh=mesh,
                               dtype=torch.float64)

    def g_l(traces, alpha):
        g_gamma = 0.5 * (traces.of(Kd) - torch.dot(alpha, Kd @ alpha))
        return g_gamma * (-1.0 / params["l"] ** 3)
    return _analytic_nll(Kk, e, f, y, params["sigma"], noise_e, noise_f,
                         f_coef, noise_opt, g_l, mesh, chol_mode, trace,
                         n_probe, probes)


def _nll_dot_analytic(theta, e: EnergyData, f: ForceData, y, noise_fixed,
                      f_coef, zeta: int, noise_opt: bool,
                      plain: bool = False, mesh=None,
                      chol_mode: str = "replicated", trace: str = "exact",
                      n_probe: int = 64, probes=None):
    """(-LML, grad) of the Dot kernel with ANALYTIC hyperparameter
    derivatives (gp.py:353-436 of the JAX package), theta = (sigma,
    sigma0[, noise_e]).  K comes from ONE gradient-free build per
    evaluation (K1-dot, K2-dot on the card): sigma0 enters k = s2 (c^z +
    s0^2) only through the additive constant, so dK/dsigma0 = 2 s2 s0 W
    on the energy block alone, W = ``count_ee`` (float64), and g_sigma0 =
    0.5 * 2 s2 s0 (tr(K^-1_EE W) - a_E^T W a_E), the trace exact or, with
    trace="hutch", estimated (``_analytic_nll``).  plain=True builds the
    blocks with the plain versions on any device; mesh shards the build
    and, by chol_mode, the factorisation."""
    kp, noise_e, noise_f = _split_theta(theta, noise_fixed, f_coef,
                                        noise_opt)
    params = _params_from_theta("dot", kp)
    sigma, sigma0 = params["sigma"], params["sigma0"]
    Kk = K_ops.k_self(e, f, params, zeta, "dot", plain=plain,
                      dtype=torch.float64, mesh=mesh)
    W = K_ops.count_ee(e).to(torch.float64)
    m = e.m

    def g_sigma0(traces, alpha):
        a_e = alpha[:m]
        return sigma * sigma * sigma0 * (traces.of(W, m)
                                         - torch.dot(a_e, W @ a_e))
    return _analytic_nll(Kk, e, f, y, sigma, noise_e, noise_f, f_coef,
                         noise_opt, g_sigma0, mesh, chol_mode, trace,
                         n_probe, probes)


def _prior(pe: EnergyData, pf: ForceData, params, zeta: int, kind: str,
           dtype):
    """The served prior variance K(x, x) of each row of the points, in
    ``dtype``: the energy prior from the operands the served K_EE reads
    (unit descriptors normalised in the data's dtype), computed in dtype
    -- operands normalised in float64 differ from those by ~1e-7 in |u|,
    which 1/l^2 amplifies where sigma_E is a small difference of the
    prior and |L^-1 k|^2 (PERF.md) --, the force rows' ``diag_force``."""
    return torch.cat([K_ops.diag_energy(pe, params, zeta, kind, dtype=dtype),
                      K_ops.diag_force(pf, params, zeta, kind).reshape(-1)
                      .to(dtype)])


def _predict_packed(pe: EnergyData, pf: ForceData, te: EnergyData,
                    tf: ForceData, params, alpha, L, zeta: int,
                    return_std: bool, kind: str = "rbf", mesh=None,
                    train_ops=None, cols=None):
    """Cross covariance, GEMV with alpha and (optionally) the predictive
    std by a triangular solve against the factor: var = diag - |L^-1 k|^2
    (gaussianprocess.py:873-911), clamped at zero, in the factor's dtype
    (float64 from ``_factorize``), the energy diagonal computed in it too.
    A served energy's posterior variance can be ~2e-7 of its prior (a
    65-atom slab against 6100 training rows), below one float32 step of
    the prior: in float32 that sigma_E was all rounding, 100 % off a
    float64 model and moving by 60-90 % of itself from one call to the
    next (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  mesh: the training
    force axis of the cross covariance runs in stripes over the shards;
    the GEMV and the solve stay on the root.  train_ops: the training
    side's operands when the caller keeps them (``GP._train_operands``).
    cols: the packed training column of each row of L when the factor is
    in another order (after incremental appends, ``GP._factor_cols``);
    alpha stays in packed order."""
    Kt = K_ops.k_block(pe, pf, te, tf, params, zeta, kind, mesh=mesh,
                       train_ops=train_ops, dtype=alpha.dtype)
    # alpha is float64 on every device (``_factorize``): the weights are
    # large and cancel in this product, and K_EE, whose rounding to
    # float32 they amplify most, stays in float64 (k_block's dtype)
    mean = Kt @ alpha
    if not return_std:
        return mean, None
    dt = L.dtype
    diag = _prior(pe, pf, params, zeta, kind, dt)
    KtT = Kt.T if cols is None else Kt.T.index_select(0, cols)
    V = torch.linalg.solve_triangular(L, KtT.to(dt), upper=False)
    var = torch.clamp(diag - (V * V).sum(dim=0), min=0.0)
    return mean, torch.sqrt(var)


# ---------------------------------------------------------------------------
# serving pack: gather the prediction blocks from the device-resident
# descriptor tensors (SO3.calculate_device), host index maps only
# ---------------------------------------------------------------------------

def _packed_rows(nE: int, nF: int, m_e: int) -> np.ndarray:
    """Packed row of each real training row in canonical order [E...,
    3 rows per force point...] (padding sits after each block's real
    points)."""
    return np.r_[np.arange(nE), m_e + np.arange(3 * nF)]


def _factor_perm(groups, nE_total: int) -> np.ndarray:
    """Canonical real row of each factor row for the insertion-order
    groups [(kE, kF), ...] of an incrementally extended factor: each
    group's energy rows, then its force rows (the JAX package's
    ``_factor_perm`` without its ghost rows)."""
    perm, e_off, f_off = [], 0, 0
    for ke, kf in groups:
        perm.append(np.arange(e_off, e_off + ke))
        perm.append(nE_total + np.arange(3 * f_off, 3 * (f_off + kf)))
        e_off += ke
        f_off += kf
    return np.concatenate(perm).astype(np.int64)


# the strain rows a stress request appends to a force point's columns:
# (xx, yy, zz, xy, xz, yz) of the flattened 3 x 3 rdxdr (the reference's
# Voigt pick, gaussianprocess.py:863-871)
_STRESS_COLS = (0, 4, 8, 1, 2, 5)


def _pack_on_device(xs, dxs, e_idx, ele_e, counts, nreal_e, centers, rows,
                    ele_f, nreal_f, rdxs=None):
    """Build (EnergyData, ForceData) from per-structure descriptor tensors
    (x (natoms_s, d), dxdr (nseq_s + 1, d, 3)); the index maps address
    the concatenated tensors, pads pointing at zero rows.  rdxs: the
    structures' rdxdr (nseq_s + 1, d, 3, 3), whose strain columns
    (``_STRESS_COLS``) are appended to each force point's 3 (9 in all)."""
    x_cat = torch.cat(list(xs), dim=0)
    x_ext = torch.cat([x_cat, x_cat.new_zeros((1, x_cat.shape[1]))])
    dx_cat = torch.cat(list(dxs), dim=0)
    if rdxs is not None:
        rd = torch.cat(list(rdxs), dim=0)
        rd = rd.reshape(rd.shape[0], rd.shape[1], 9)[:, :,
                                                     list(_STRESS_COLS)]
        dx_cat = torch.cat([dx_cat, rd], dim=2)
    pe = EnergyData(x=x_ext[e_idx], ele=ele_e, counts=counts,
                    nreal=nreal_e)
    pf = ForceData(x=x_ext[centers], dxdr=dx_cat[rows], ele=ele_f,
                   nreal=nreal_f)
    return pe, pf


def _group_force_points(d, ele, sel, stress: bool = False):
    """Force points for the atoms in ``sel``: group the descriptor's seq
    rows by target atom and gather (x_envs, dxdr_rows, ele_envs), with
    the 6 strain columns appended (9 in all) when ``stress``."""
    seq = d["seq"]
    pts = []
    for i in sel:
        ids = np.flatnonzero(seq[:, 1] == i)
        _i = seq[ids, 0]
        dx = d["dxdr"][ids]
        if stress:
            rd = d["rdxdr"][ids].reshape(len(ids), -1, 9)
            dx = np.concatenate((dx, rd[:, :, list(_STRESS_COLS)]), axis=2)
        pts.append((d["x"][_i], dx, ele[_i]))
    return pts


def _serve_gather_meta(descs, numbers_list, sel_lists):
    """Host-side index maps for _pack_on_device (small int arrays only):
    per structure one energy point, and one force point per atom of
    ``sel_lists[s]`` whose envs are the seq rows targeting that atom."""
    n_struc = len(descs)
    natoms_tot = sum(len(z) for z in numbers_list)
    a_pad = max(len(z) for z in numbers_list)
    groups = []          # (struc_idx, atom_i, seq_row_ids, center_ids)
    for s, d in enumerate(descs):
        seq, nseq = d["seq"], d["nseq"]
        order = np.argsort(seq[:nseq, 1], kind="stable")
        tgt_sorted = seq[order, 1]
        sel = np.asarray(sel_lists[s], np.int64)
        starts = np.searchsorted(tgt_sorted, sel)
        ends = np.searchsorted(tgt_sorted, sel, side="right")
        for i, lo, hi in zip(sel, starts, ends):
            ids = order[lo:hi]
            groups.append((s, i, ids, seq[ids, 0]))
    m_f = len(groups)
    b_pad = max((len(g[2]) for g in groups), default=1)

    x_off = np.concatenate([[0], np.cumsum(
        [len(z) for z in numbers_list])])[:-1]
    dx_off = np.concatenate([[0], np.cumsum(
        [int(d["dxdr"].shape[0]) for d in descs])])[:-1]
    x_zero = natoms_tot                     # appended zero row of x_ext

    e_idx = np.full((n_struc, a_pad), x_zero, np.int64)
    ele_e = np.zeros((n_struc, a_pad), np.int32)
    counts = np.ones((n_struc,), np.float64)
    for s, z in enumerate(numbers_list):
        n = len(z)
        e_idx[s, :n] = x_off[s] + np.arange(n)
        ele_e[s, :n] = z
        counts[s] = n

    m_f_pad = max(m_f, 1)
    centers = np.full((m_f_pad, b_pad), x_zero, np.int64)
    # pad entries gather a structure's zero dxdr row (row nseq)
    rows = np.full((m_f_pad, b_pad), dx_off[0] + descs[0]["nseq"], np.int64)
    ele_f = np.zeros((m_f_pad, b_pad), np.int32)
    for k, (s, i, ids, cen) in enumerate(groups):
        n = len(ids)
        rows[k] = dx_off[s] + descs[s]["nseq"]
        rows[k, :n] = dx_off[s] + ids
        centers[k, :n] = x_off[s] + cen
        ele_f[k, :n] = numbers_list[s][cen]
    return dict(e_idx=e_idx, ele_e=ele_e, counts=counts, centers=centers,
                rows=rows, ele_f=ele_f, m_f=m_f)


def _pack_from_device_descs(descs, numbers_list, sel_lists,
                            stress: bool = False):
    """calculate_device outputs -> (pe, pf) gathered on their device;
    stress: the force points carry the strain rows (9 columns)."""
    meta = _serve_gather_meta(descs, numbers_list, sel_lists)
    x0 = descs[0]["x"]

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=x0.device)

    return _pack_on_device(
        [d["x"] for d in descs], [d["dxdr"] for d in descs],
        t(meta["e_idx"]), t(meta["ele_e"]), t(meta["counts"], x0.dtype),
        len(descs), t(meta["centers"]), t(meta["rows"]), t(meta["ele_f"]),
        meta["m_f"], rdxs=[d["rdxdr"] for d in descs] if stress else None)


def _pack_structures(strucs, descs, stress: bool = False):
    """Structures and their ``calculate_device`` dicts -> (pe, pf, atom
    ids per structure): one energy point a structure and one force point
    a free atom, the served request's pack; with ``stress`` one a atom,
    fixed or not, with the strain rows (the JAX package's gp.py:1841)."""
    eles, sels = [], []
    for struc, dd in zip(strucs, descs):
        eles.append(np.asarray([ATOMIC_NUMBERS[s] for s in dd["elements"]],
                               int))
        fix_ids = set(int(i) for i in struc.fixed_indices()) \
            if hasattr(struc, "fixed_indices") and not stress else set()
        sels.append([i for i in range(len(struc)) if i not in fix_ids])
    pe, pf = _pack_from_device_descs(descs, eles, sels, stress)
    return pe, pf, sels


# ---------------------------------------------------------------------------
# novelty filter and metrics (utilities.py:32-95)
# ---------------------------------------------------------------------------

def new_pt(data, refs, d_tol: float = 1e-1, eps: float = 1e-8) -> bool:
    X, ele = data
    X = X / (np.linalg.norm(X) + eps)
    for X1, ele1 in refs:
        if ele1 == ele:
            X1 = X1 / (np.linalg.norm(X1) + eps)
            d = X @ X1.T
            if 1 - d ** 2 < d_tol:
                return False
    return True


def metric_values(y_true, y_pred):
    """r2 / MAE / RMSE (utilities.py:44-95)."""
    y_true, y_pred = np.asarray(y_true, float), np.asarray(y_pred, float)
    n = max(len(y_true), 1)
    mae = float(np.sum(np.abs(y_true - y_pred)) / n)
    rmse = float(np.sqrt(np.sum((y_true - y_pred) ** 2) / n))
    if len(y_true) == 0:
        return 1.0, mae, rmse
    tbar = y_true.mean()
    r2 = float(1 - np.sum((y_true - y_pred) ** 2)
               / (np.sum((y_true - tbar) ** 2) + 1e-8))
    return r2, mae, rmse


# ---------------------------------------------------------------------------
# GP
# ---------------------------------------------------------------------------

class GP:
    """Drop-in equivalent of gpr_calc.gaussianprocess.GP: training with
    hyperparameter optimisation, serving, and saving the training set."""

    # the gate of trace="auto": hutch is kept when its gradient at theta0
    # is within this share of the exact one's norm (plus 1e-3)
    _HUTCH_GATE_RTOL = 0.05

    def __init__(self, kernel=None, descriptor=None, base_potential=None,
                 noise_e=0.005, noise_f=0.1, f_coef=10,
                 log_file: str = "gpr.log", device=None, dtype=None,
                 mesh=None, trace: str = "exact", n_probe: int = 64):
        """mesh: an optional ``parallel.Mesh`` (``parallel.make_mesh``)
        whose root is the model's device: the covariance builds, and at
        scale the Cholesky, are sharded over it.  trace: the NLL
        gradient's traces in ``fit(opt=True)``, "exact", "hutch" (the
        Hutchinson estimate from ``n_probe`` fixed probes) or "auto"
        (hutch from ``_HUTCH_MIN_N`` rows when it passes the measured
        gate at theta0, ``_gated_trace_mode``); the JAX package's default
        is "auto", the port's "exact" until the estimate is measured
        against it at the benchmark's sizes."""
        _resolve_trace_mode(0, trace)
        self.log_file = log_file
        logger = logging.getLogger(
            f"gpr_calculator_tpu_torch.gp.{log_file or 'default'}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        if not logger.handlers:
            handler = (logging.FileHandler(log_file) if log_file
                       else logging.StreamHandler())
            handler.setFormatter(
                logging.Formatter("%(asctime)s| %(message)s"))
            logger.addHandler(handler)
        self.logging = logger

        self.noise_e = float(noise_e)
        self.noise_f = float(noise_f)
        self.noise_bounds = None
        self.f_coef = f_coef
        self.error = None

        self.descriptor = descriptor
        self.kernel = kernel
        self.base_potential = base_potential
        self.device = config.device() if device is None \
            else torch.device(device)
        self.dtype = config.dtype(self.device) if dtype is None else dtype
        if mesh is not None:
            from ..parallel.mesh import canonical
            if canonical(self.device) != mesh.root:
                raise ValueError(
                    f"the GP works on {self.device}, the mesh's root is "
                    f"{mesh.root}: they must be one device")
        self.mesh = mesh
        self.trace = trace
        self.n_probe = int(n_probe)
        self._probes = None          # the kept Rademacher block Z
        self._trace_gate = None      # (key, mode) of the last gate verdict
        self._nll_trace_used = "exact"
        self._data_version = 0       # bumped by every set_train_pts

        # host-side ragged training store
        self._energy_pts: List[Tuple[np.ndarray, np.ndarray]] = []
        self._energy_y: List[float] = []
        self._force_pts: List[Tuple[np.ndarray, np.ndarray,
                                    np.ndarray]] = []
        self._force_y: List[np.ndarray] = []
        self.train_db: list = []

        self.N_energy = 0
        self.N_forces = 0
        self.N_energy_queue = 0
        self.N_forces_queue = 0
        self.N_queue = 0

        self.alpha_ = None          # float64 weights, packed order
        self.L_ = None              # float64 lower factor, factor order
        self._factor_cols = None    # packed column of each factor row
        self._fit_snapshot = None   # (EnergyData, ForceData, nE, nF)
        self._serve_ops = None      # (snapshot, its serving operands)
        # what the factor holds, for the incremental refit: {"sig",
        # "groups": [(kE, kF), ...]}; None forces the next fit to
        # refactorise
        self._inc = None
        # the factorisation step of fit() by path: counts and wall ms
        self.refit_stats = {"full": 0, "incremental": 0,
                            "full_ms": 0.0, "incremental_ms": 0.0}

        self.fits = 0
        self.use_base = 0
        self.use_surrogate = 0
        self.logging.info(self)

    def __str__(self):
        s = "------Gaussian Process Regression (PyTorch)------\n"
        s += "Kernel: {:s}".format(str(self.kernel))
        s += " {:d} energy ({:.5f})".format(self.N_energy, self.noise_e)
        s += " {:d} forces ({:.5f})\n".format(self.N_forces, self.noise_f)
        if self.use_base > 0:
            s += "Total base/surrogate/gpr_fit calls: {}/{}/{}\n".format(
                self.use_base, self.use_surrogate, self.fits)
        return s

    __repr__ = __str__

    def todict(self):
        """API parity with the reference (an empty dict)."""
        return {}

    @property
    def train_y(self):
        """Training labels: per-atom, base-subtracted energies and the
        force vectors (gp.py:869 of the JAX package)."""
        return {"energy": list(self._energy_y),
                "force": [np.asarray(f) for f in self._force_y]}

    def save_dict(self, db_filename=None):
        """Model metadata: noise, kernel and descriptor settings."""
        d = {"noise": {"energy": self.noise_e, "force": self.noise_f,
                       "f_coef": self.f_coef, "bounds": self.noise_bounds},
             "kernel": self.kernel.save_dict(),
             "descriptor": self.descriptor.save_dict(),
             "db_filename": db_filename}
        if self.error is not None:
            d["error"] = self.error
        if self.base_potential is not None:
            d["base_potential"] = self.base_potential.save_dict()
        return d

    def save(self, filename, db_filename, verbose=True):
        """The model's JSON metadata and its training structures as an
        ASE-compatible database (gp.py:2190-2218 of the JAX package)."""
        with open(filename, "w") as fp:
            json.dump(self.save_dict(db_filename), fp, indent=4)
        self.export_ase_db(db_filename, permission="w")
        if verbose:
            print(f"save model to {filename} and {db_filename}")

    def export_ase_db(self, db_filename, permission="w"):
        from ..io.ase_db import write_db
        rows = []
        for (struc, energy, force, energy_in, force_in) in self.train_db:
            actual_energy = float(energy)
            actual_forces = np.array(force, float)
            if self.base_potential is not None:
                e_off, f_off, _ = self.compute_base_potential(struc)
                actual_energy += e_off
                actual_forces += f_off
            rows.append({
                "atoms": struc,
                "data": {"energy": energy, "force": np.asarray(force),
                         "energy_in": energy_in,
                         "force_in": list(force_in)},
                "key_value_pairs": {
                    "dft_energy": actual_energy / len(force),
                    "dft_fmax": float(np.max(np.abs(
                        actual_forces.reshape(-1)))),
                },
            })
        write_db(db_filename, rows, permission=permission)

    # -- packing -------------------------------------------------------------
    def _pack(self, nE: int, nF: int) -> Tuple[EnergyData, ForceData]:
        d = self.descriptor.ncoef if self.descriptor is not None else 1
        epts = self._energy_pts[:nE]
        fpts = self._force_pts[:nF]
        if epts:
            d = epts[0][0].shape[1]
        if fpts:
            d = fpts[0][0].shape[1]
        kw = dict(d=d, device=self.device, dtype=self.dtype)
        return pack_energy(epts, **kw), pack_force(fpts, **kw)

    def _y_vector(self, e: EnergyData, f: ForceData, nE: int, nF: int):
        y = np.zeros(e.m + 3 * f.m)
        y[:nE] = self._energy_y[:nE]
        yf = np.asarray(self._force_y[:nF], float).reshape(-1)
        y[e.m:e.m + 3 * nF] = yf
        return torch.as_tensor(y, dtype=self.dtype, device=self.device)

    # -- training-data management (gaussianprocess.py:381-629) --------------
    def set_train_pts(self, data: Dict, mode: str = "w"):
        self._data_version += 1
        if mode == "w":
            self._energy_pts, self._energy_y = [], []
            self._force_pts, self._force_y = [], []
            self.train_db = []
            self.N_energy = self.N_forces = 0
            self.N_energy_queue = self.N_forces_queue = self.N_queue = 0
            # a replaced training set must not be appended to the factor
            # of the old one
            self._inc = None

        N_E, N_F = 0, 0
        for d in data.get("db", []):
            (atoms, energy, force, energy_in, force_in) = d
            N_E += 1 if energy_in else 0
            N_F += len(force_in)
            self.train_db.append((atoms, energy, force, energy_in, force_in))

        for (x, e, ele) in data.get("energy", []):
            self._energy_pts.append((np.asarray(x, float),
                                     np.asarray(ele, int)))
            self._energy_y.append(float(e))
        for (x, dxdr, fval, ele) in data.get("force", []):
            self._force_pts.append((np.asarray(x, float),
                                    np.asarray(dxdr, float),
                                    np.asarray(ele, int)))
            self._force_y.append(np.asarray(fval, float))

        self.N_energy = len(self._energy_pts)
        self.N_forces = len(self._force_pts)
        self.N_energy_queue += N_E
        self.N_forces_queue += N_F
        self.N_queue += N_E + N_F

    def get_train_x(self):
        """The training inputs without the queued points
        (gaussianprocess.py:553-577), in the point-list layout:
        {"energy": [(x, ele), ...], "force": [(x, dxdr, ele), ...]}."""
        n_e = self.N_energy - self.N_energy_queue
        n_f = self.N_forces - self.N_forces_queue
        if self.N_queue <= 0 or n_e <= 0:
            n_e = self.N_energy
        if self.N_queue <= 0 or n_f <= 0:
            n_f = self.N_forces
        return {"energy": list(self._energy_pts[:n_e]),
                "force": list(self._force_pts[:n_f])}

    def add_train_pts_energy(self, energy_data):
        """Append energy training points (gaussianprocess.py:579-601), a
        list of (x, energy_per_atom, ele)."""
        self.set_train_pts({"energy": list(energy_data)}, mode="a+")

    def add_train_pts_force(self, force_data):
        """Append force training points (gaussianprocess.py:602-629), a
        list of (x, dxdr, force_vec, ele)."""
        self.set_train_pts({"force": list(force_data)}, mode="a+")

    def remove_train_pts(self, e_ids, f_ids):
        """Delete the energy points ``e_ids`` and force points ``f_ids``
        (indices into the training lists) and refit from scratch
        (gaussianprocess.py:427-464): the training set is replaced
        (``set_train_pts(mode="w")``), its database rows keep the points
        that stay, then a full ``fit()``."""
        e_ids, f_ids = set(int(i) for i in e_ids), set(int(i) for i in f_ids)
        data = {"energy": [], "force": [], "db": []}
        for i, (x, ele) in enumerate(self._energy_pts):
            if i not in e_ids:
                data["energy"].append((x, self._energy_y[i], ele))
        for i, (x, dxdr, ele) in enumerate(self._force_pts):
            if i not in f_ids:
                data["force"].append((x, dxdr, self._force_y[i], ele))
        e_seen, f_seen = 0, 0
        for (atoms, energy, force, energy_in, force_in) in self.train_db:
            new_energy_in = energy_in and (e_seen not in e_ids)
            if energy_in:
                e_seen += 1
            new_force_in = []
            for fi in force_in:
                if f_seen not in f_ids:
                    new_force_in.append(fi)
                f_seen += 1
            if new_energy_in or new_force_in:
                data["db"].append((atoms, energy, force, new_energy_in,
                                   new_force_in))
        self.set_train_pts(data, mode="w")
        self.fit()

    def _mesh_arg(self):
        """The mesh the builds get: None for a mesh of one shard."""
        if self.mesh is not None and self.mesh.size > 1:
            return self.mesh
        return None

    def _chol_mode(self, e: EnergyData, f: ForceData) -> str:
        return _resolve_chol_mode(self._mesh_arg(), e.m + 3 * f.m)

    # -- LML / fit -----------------------------------------------------------
    def _nll_fn(self, trace: str = "exact"):
        """The analytic-gradient NLL of the kernel's family, its traces
        exact or (trace="hutch") estimated from the kept probe block."""
        nll = {"rbf": _nll_rbf_analytic,
               "dot": _nll_dot_analytic}.get(self.kernel.kind)
        if nll is None:
            raise NotImplementedError(
                f"no NLL for the {self.kernel.name} kernel")
        zeta = self.kernel.zeta

        def call(theta, e, f, y, noise_fixed, f_coef, noise_opt):
            probes = self._probe_block(e.m + 3 * f.m) \
                if trace == "hutch" else None
            return nll(theta, e, f, y, noise_fixed, f_coef, zeta, noise_opt,
                       mesh=self._mesh_arg(),
                       chol_mode=self._chol_mode(e, f), trace=trace,
                       n_probe=self.n_probe, probes=probes)
        return call

    def _probe_block(self, n: int):
        """The Rademacher block of the Hutchinson traces at n rows, drawn
        once per (n, n_probe) on the model's device and kept."""
        Z = self._probes
        if Z is None or Z.shape != (n, self.n_probe):
            Z = self._probes = _probe_block(n, self.n_probe, self.device)
        return Z

    def _gated_trace_mode(self, e, f, y, theta0, noise_opt: bool) -> str:
        """The trace one ``fit(opt=True)`` takes: ``trace`` resolved at
        the training size (``_resolve_trace_mode``); where "auto" picks
        the estimate, its gradient at theta0 is held against the exact
        one once, and hutch is kept only within _HUTCH_GATE_RTOL of the
        exact gradient's norm plus 1e-3 (the JAX package's gp.py:
        1062-1100).  The verdict is kept for the training data's version
        (bumped by ``set_train_pts``, which ``add_structure`` calls),
        theta0, the noise and the precision: new data or other
        hyperparameters measure again (the JAX package keyed it by size
        alone, so it never went stale)."""
        n = e.m + 3 * f.m
        mode = _resolve_trace_mode(n, self.trace)
        if mode == "exact" or self.trace == "hutch":
            return mode
        key = (self._data_version, noise_opt, self.n_probe,
               tuple(float(t) for t in theta0), self._params_signature())
        if self._trace_gate is not None and self._trace_gate[0] == key:
            return self._trace_gate[1]
        noise_fixed = (self.noise_e, self.noise_f)
        f_coef = float(self.f_coef)
        _, g_h = self._nll_fn("hutch")(theta0, e, f, y, noise_fixed, f_coef,
                                       noise_opt)
        _, g_e = self._nll_fn("exact")(theta0, e, f, y, noise_fixed, f_coef,
                                       noise_opt)
        g_h = g_h.detach().cpu().numpy().astype(float)
        g_e = g_e.detach().cpu().numpy().astype(float)
        err = float(np.linalg.norm(g_h - g_e))
        ok = bool(np.all(np.isfinite(g_h))) and err <= (
            self._HUTCH_GATE_RTOL * float(np.linalg.norm(g_e)) + 1e-3)
        mode = "hutch" if ok else "exact"
        self.logging.info(
            "NLL trace gate at n=%d: |g_hutch - g_exact| = %.3e "
            "(|g_exact| = %.3e) -> %s", n, err,
            float(np.linalg.norm(g_e)), mode)
        self._trace_gate = (key, mode)
        return mode

    def _theta(self):
        """(theta0, bounds, noise_opt) of the hyperparameter search."""
        noise_opt = self.noise_bounds is not None
        theta0 = list(self.kernel.parameters())
        bounds = [list(b) for b in self.kernel.bounds]
        if noise_opt:
            theta0 = theta0 + [self.noise_e]
            bounds = bounds + [list(self.noise_bounds)]
        return theta0, bounds, noise_opt

    def _objective(self, e, f, y, noise_opt: bool, show: bool = False,
                   trace: str = "exact"):
        """theta -> (NLL, gradient) as float and float64 array for
        L-BFGS-B; a non-finite NLL (K not positive definite) gives
        (inf, zeros), gp.py:1163-1164 of the JAX package."""
        nll_fn = self._nll_fn(trace)
        noise_fixed = (self.noise_e, self.noise_f)

        def obj(theta):
            nll, grad = nll_fn(theta, e, f, y, noise_fixed,
                               float(self.f_coef), noise_opt)
            nll = float(nll)
            grad = grad.detach().cpu().numpy().astype(float)
            if not np.isfinite(nll):
                return np.inf, np.zeros_like(grad)
            if show:
                strs = "Loss: {:12.3f} ".format(nll)
                for para in theta:
                    strs += "{:6.3f} ".format(para)
                print(strs)
                self.logging.info(strs)
            return nll, grad
        return obj

    def log_marginal_likelihood(self, params, eval_gradient=False,
                                clone_kernel=False):
        """LML (and its gradient) at theta = (sigma, l or sigma0[,
        noise_e]) over the whole training set, with the exact trace
        whatever ``trace`` is."""
        theta0, _, noise_opt = self._theta()
        if len(params) != len(theta0):
            raise ValueError(f"expected {len(theta0)} hyperparameters")
        e, f = self._pack(self.N_energy, self.N_forces)
        y = self._y_vector(e, f, self.N_energy, self.N_forces)
        nll, grad = self._nll_fn()(params, e, f, y,
                                   (self.noise_e, self.noise_f),
                                   float(self.f_coef), noise_opt)
        lml = -float(nll)
        if not np.isfinite(lml):
            lml = -np.inf
        if eval_gradient:
            g = -grad.detach().cpu().numpy().astype(float)
            if not np.all(np.isfinite(g)):
                g = np.zeros_like(g)
            return lml, g
        return lml

    def _minimize(self, fun, theta0, bounds, maxiter: int = 10):
        """scipy's L-BFGS-B result over the objective (the optimizer
        settings of gaussianprocess.py:204-220)."""
        return minimize(fun, theta0, method="L-BFGS-B", bounds=bounds,
                        jac=True, options={"maxiter": maxiter, "ftol": 1e-2})

    def optimize(self, fun, theta0, bounds, maxiter: int = 10):
        """L-BFGS-B host loop over the objective: (theta, NLL)."""
        res = self._minimize(fun, theta0, bounds, maxiter)
        return res.x, res.fun

    def fit(self, TrainData=None, show: bool = True, opt: bool = True,
            maxiter: int = 10):
        """opt=True: optimise the kernel's (sigma, l) or (sigma, sigma0)
        [and the noise] by L-BFGS-B over the NLL from the current values,
        its traces as ``trace`` and the gate decide
        (``_gated_trace_mode``), then refactorise the training covariance
        from scratch.  With the estimated traces L-BFGS-B pairs an exact
        value with an estimated gradient, so a run that ends in a failed
        line search (scipy's status 2, e.g. ABNORMAL_TERMINATION_IN_LNSRCH)
        is run once more with the exact trace, and logged.
        opt=False: extend the factor of the last fit by the rows appended
        since (``_try_incremental_fit``), or refactorise where it cannot.
        ``refit_stats`` counts each path with the wall milliseconds of
        its factorisation step (on the card up to the device's finish)."""
        if TrainData is not None:
            self.set_train_pts(TrainData)
        if show:
            print(self)
        e, f = self._pack(self.N_energy, self.N_forces)
        y = self._y_vector(e, f, self.N_energy, self.N_forces)
        if opt:
            print(f"Update GP model => {self.N_queue}/{maxiter}")
            theta0, bounds, noise_opt = self._theta()
            trace = self._gated_trace_mode(e, f, y, theta0, noise_opt)
            res = self._minimize(self._objective(e, f, y, noise_opt, show,
                                                 trace), theta0, bounds,
                                 maxiter)
            if trace == "hutch" and res.status == 2:
                self.logging.info(
                    "L-BFGS-B with the Hutchinson trace ended in %r: "
                    "rerun with the exact trace", str(res.message))
                trace = "exact"
                res = self._minimize(self._objective(e, f, y, noise_opt,
                                                     show), theta0, bounds,
                                     maxiter)
            self._nll_trace_used = trace
            params = res.x
            if noise_opt:
                self.kernel.update(params[:-1])
                self.noise_e = float(params[-1])
                self.noise_f = float(self.f_coef * params[-1])
            else:
                self.kernel.update(params)
        t0 = time.perf_counter()
        if not opt and self._try_incremental_fit(e, f):
            path = "incremental"
            self.logging.info("Cholesky rank-update complete")
        else:
            try:
                L, alpha = _factorize(e, f, y, self.kernel.params(),
                                      self.noise_e, self.noise_f,
                                      self.kernel.zeta, self.kernel.kind,
                                      mesh=self._mesh_arg(),
                                      chol_mode=self._chol_mode(e, f))
            except FloatingPointError as exc:
                self.logging.error(str(exc))
                raise
            self._record_full_factor(e, f, self.N_energy, self.N_forces, L,
                                     alpha)
            path = "full"
            self.logging.info("Cholesky decomposition complete")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.refit_stats[path] += 1
        self.refit_stats[path + "_ms"] += (time.perf_counter() - t0) * 1e3
        self.N_energy_queue = self.N_forces_queue = self.N_queue = 0
        self.fits += 1

    def set_K_inv(self):
        """API parity (gaussianprocess.py:128-131): the reference forms
        K^-1 here; this GP keeps the factor ``L_`` and forms none."""
        return

    # -- incremental refit (gp.py:1223-1425 of the JAX package) --------------
    def _params_signature(self):
        """What the factor depends on besides the data: the kernel, its
        hyperparameters, the noise, the working dtype and the matmul
        precision of the covariance builds."""
        return (self.kernel.kind, self.kernel.zeta,
                tuple(round(float(p), 14) for p in self.kernel.parameters()),
                round(self.noise_e, 14), round(self.noise_f, 14),
                self.dtype, config.kff_precision())

    def _record_full_factor(self, e: EnergyData, f: ForceData, nE: int,
                            nF: int, L, alpha):
        """Keep a from-scratch factor and weights (``_factorize``'s, over
        the packed rows) for serving and later appends: their real rows,
        in canonical order.  The padded rows have unit noise and no
        coupling, so the real rows of the padded factor are the factor of
        the real covariance."""
        rows = _packed_rows(nE, nF, e.m)
        r = torch.as_tensor(rows, device=L.device)
        if len(rows) != L.shape[0]:
            L = L[r[:, None], r[None, :]]
        self._adopt_factor(e, f, nE, nF, L, alpha[r], [(nE, nF)])

    def _adopt_factor(self, e: EnergyData, f: ForceData, nE: int, nF: int,
                      L, alpha_fac, groups):
        """Serve from, and append to, the float64 factor L and weights
        alpha_fac of the real rows in the insertion order of ``groups``
        (``_factor_perm``): the weights scattered into packed order, and
        the packed column of each factor row (``_factor_cols``), which
        ``_predict_packed`` gathers the cross covariance by."""
        self._inc = {"sig": self._params_signature(), "groups": list(groups)}
        cols = torch.as_tensor(_packed_rows(nE, nF, e.m)[
            _factor_perm(groups, nE)], device=self.device)
        alpha = torch.zeros(e.m + 3 * f.m, dtype=torch.float64,
                            device=self.device)
        alpha[cols] = alpha_fac
        self.L_, self.alpha_, self._factor_cols = L, alpha, cols
        self._fit_snapshot = (e, f, nE, nF)
        self._serve_ops = None

    def _y_factor_order(self, perm):
        """The labels in factor order, float64 on the model's device."""
        y = np.concatenate([
            np.asarray(self._energy_y[:self.N_energy], float),
            np.asarray(self._force_y[:self.N_forces], float).reshape(-1)])
        return torch.as_tensor(y[perm], dtype=torch.float64,
                               device=self.device)

    def _append_blocks(self, nE0: int, nF0: int):
        """(B, C) of the rows appended since the last fit, float64, in
        factor order: B = K(old, new) (n_old, k) and C = K(new, new) plus
        the noise (k, k).  B is built as K(new, old) by ``k_block`` with
        the kept operands of the last fit's training set and transposed
        (under a mesh its stripes run over the old training force axis),
        C by ``k_self``: K2, K3 and one K1 over the new rows alone.  Both
        blocks read operands rounded as ``k_self`` rounds them, with K_EE
        from those (``gram=True``), are assembled in float64 with the
        noise added there, as ``_factorize`` does, and sort the new rows'
        envs by element where a full refit's sides would be (a point's
        sum then runs in the same order), so they are the blocks of the K
        a full refit would build up to the kernels' float32 summation
        order."""
        te, tf, _, _ = self._fit_snapshot
        kw = dict(d=te.d, device=self.device, dtype=self.dtype)
        e_new = pack_energy(self._energy_pts[nE0:self.N_energy], **kw)
        f_new = pack_force(self._force_pts[nF0:self.N_forces], **kw)
        params, zeta, kind = (self.kernel.params(), self.kernel.zeta,
                              self.kernel.kind)
        f64 = torch.float64
        K_no = K_ops.k_block(e_new, f_new, te, tf, params, zeta, kind,
                             mesh=self._mesh_arg(),
                             train_ops=self._train_operands(), gram=True,
                             dtype=f64)
        C = K_ops.k_self(e_new, f_new, params, zeta, kind, rest=(te, tf),
                         dtype=f64)
        C.diagonal().add_(_noise_diag(e_new, f_new, self.noise_e,
                                      self.noise_f))
        new = torch.as_tensor(_packed_rows(self.N_energy - nE0,
                                           self.N_forces - nF0, e_new.m),
                              device=self.device)
        B = K_no.index_select(0, new).index_select(1, self._factor_cols)
        return B.T, C[new[:, None], new[None, :]]

    def _try_incremental_fit(self, e: EnergyData, f: ForceData) -> bool:
        """Extend the factor of the last fit by the rows appended since,
        in O(n^2 k) (``linalg.chol_append``), and solve the weights
        against it; False when a refactorisation is needed: no factor
        kept, another signature (hyperparameters, noise, dtype,
        precision), rows removed, or an extension that is not positive
        definite (then the state is dropped and logged)."""
        st = self._inc
        if st is None or st["sig"] != self._params_signature():
            return False
        nE0, nF0 = (sum(g[i] for g in st["groups"]) for i in (0, 1))
        kE, kF = self.N_energy - nE0, self.N_forces - nF0
        if kE < 0 or kF < 0:
            return False
        groups = st["groups"] + ([(kE, kF)] if kE or kF else [])
        L = self.L_
        if kE or kF:
            L, lc_diag = linalg.chol_append(L, *self._append_blocks(nE0,
                                                                    nF0))
            lc_diag = lc_diag.cpu().numpy()
            if not (np.all(np.isfinite(lc_diag)) and np.all(lc_diag > 0)):
                self._inc = None
                self.logging.info(
                    "Cholesky rank-update not positive definite: "
                    "refactorising from scratch")
                return False
        alpha = linalg.chol_solve(L, self._y_factor_order(
            _factor_perm(groups, self.N_energy)))
        self._adopt_factor(e, f, self.N_energy, self.N_forces, L, alpha,
                           groups)
        return True

    # -- prediction ----------------------------------------------------------
    def _train_view(self):
        """Training snapshot the current alpha_ was fitted on."""
        if self._fit_snapshot is None:
            raise RuntimeError("model is not fitted")
        return self._fit_snapshot

    def _train_operands(self):
        """The fit snapshot's operands for serving, built once per fit in
        the matmul precision in force and kept with the snapshot: a refit
        (a new snapshot), another precision or another device drops
        them.  None on a mesh: the sharded block builds its own."""
        if self._mesh_arg() is not None:
            return None
        snap = self._train_view()
        mode = config.kff_precision()
        kept = self._serve_ops      # (snapshot, its operands)
        if (kept is None or kept[0] is not snap or kept[1].mode != mode
                or kept[1].X.device != snap[1].x.device):
            kept = (snap, K_ops.side_operands(snap[0], snap[1], mode,
                                              "train"))
            self._serve_ops = kept
        return kept[1]

    def _serve(self, pe, pf, te, tf, return_std):
        mean, std = _predict_packed(pe, pf, te, tf, self.kernel.params(),
                                    self.alpha_, self.L_, self.kernel.zeta,
                                    return_std, self.kernel.kind,
                                    mesh=self._mesh_arg(),
                                    train_ops=self._train_operands(),
                                    cols=self._factor_cols)
        mean = mean.cpu().numpy()
        return mean, None if std is None else std.cpu().numpy()

    def _predict_points(self, energy_pts, force_pts, return_std=False,
                        total_E=False):
        """Means (and stds) for explicit descriptor points, ordered
        [energies..., forces...] (gaussianprocess.py:319-379); a force
        point gives 3 rows, or 9 when its dxdr carries the strain rows."""
        te, tf, _, _ = self._train_view()
        kw = dict(d=te.d, device=self.device, dtype=self.dtype)
        pe = pack_energy(energy_pts, **kw)
        pf = pack_force(force_pts, **kw)
        mean, std = self._serve(pe, pf, te, tf, return_std)
        nE, nF = len(energy_pts), len(force_pts)
        f_rows = slice(pe.m, pe.m + pf.ncart * nF)
        mean_e = mean[:nE]
        mean_f = mean[f_rows]
        if total_E:
            mean_e = mean_e * np.asarray([len(p[0]) for p in energy_pts])
        if return_std:
            std_e = std[:nE]
            std_f = std[f_rows]
            if total_E:
                std_e = std_e * np.asarray([len(p[0]) for p in energy_pts])
            return mean_e, mean_f, std_e, std_f
        return mean_e, mean_f

    def predict(self, X: Dict, total_E=False, return_std=False,
                return_cov=False, stress=False):
        """Predict for explicit point dicts (gaussianprocess.py:319-379):
        means ordered [energies..., rows of each force point...], a force
        point's rows 3, or 9 when its dxdr carries the strain rows
        appended (as ``predict_structure(stress=True)`` builds them; the
        raw kernel rows' sign).  stress=True checks that the points do.
        return_std adds the stds; return_cov returns (mean, the full
        predictive covariance) instead (``_predict_cov``)."""
        energy_pts = [(np.asarray(p[0], float), np.asarray(p[-1], int))
                      for p in X.get("energy", [])]
        force_pts = [(np.asarray(p[0], float), np.asarray(p[1], float),
                      np.asarray(p[-1], int))
                     for p in X.get("force", [])]
        if stress and force_pts and force_pts[0][1].shape[2] != 9:
            raise ValueError(
                "stress=True requires 9-column force points (dxdr with "
                "appended rdxdr stress terms, cf. predict_structure)")
        if return_cov:
            return self._predict_cov(energy_pts, force_pts, total_E)
        out = self._predict_points(energy_pts, force_pts,
                                   return_std=return_std, total_E=total_E)
        if return_std:
            mean_e, mean_f, std_e, std_f = out
            return (np.concatenate([mean_e, mean_f]),
                    np.concatenate([std_e, std_f]))
        mean_e, mean_f = out
        return np.concatenate([mean_e, mean_f])

    def _predict_cov(self, energy_pts, force_pts, total_E=False):
        """(mean, cov): the full predictive covariance K(X, X) - K_t K^-1
        K_t^T of the points (gaussianprocess.py:363-366), on the model's
        device in float64: K_t from ``k_block`` (K2, K3) and the points'
        own block from ``k_self`` (K1, K2), both float64 as serving and
        ``_factorize`` assemble them, solved against the float64 factor
        ``L_`` in its insertion order (``_factor_cols``).  Its diagonal
        takes the prior that ``predict``'s std is served from
        (``_prior``), so the two give one variance: on the card the
        self block's float32 diagonal and that prior differ by float32
        rounding of a prior far larger than the posterior variance.  Only
        the returned arrays go to the host.  Raises ValueError, before any
        allocation, when its float64 buffers would take more than
        MEMORY_SHARE of the device's free memory."""
        te, tf, _, _ = self._train_view()
        kw = dict(d=te.d, device=self.device, dtype=self.dtype)
        pe = pack_energy(energy_pts, **kw)
        pf = pack_force(force_pts, **kw)
        n_q, n_t = pe.m + pf.ncart * pf.m, te.m + 3 * tf.m
        _check_buffers(self.device, 8 * (3 * n_q * n_t + 3 * n_q * n_q),
                       "the predictive covariance")
        f64 = torch.float64
        params, zeta, kind = (self.kernel.params(), self.kernel.zeta,
                              self.kernel.kind)
        Kt = K_ops.k_block(pe, pf, te, tf, params, zeta, kind,
                           mesh=self._mesh_arg(),
                           train_ops=self._train_operands(), dtype=f64)
        mean = Kt @ self.alpha_
        V = torch.linalg.solve_triangular(
            self.L_, Kt.T.index_select(0, self._factor_cols), upper=False)
        del Kt
        cov = K_ops.k_self(pe, pf, params, zeta, kind, dtype=f64)
        cov.diagonal().copy_(_prior(pe, pf, params, zeta, kind, f64))
        cov -= V.T @ V
        nE, nF = len(energy_pts), len(force_pts)
        rows = torch.as_tensor(
            np.r_[np.arange(nE), pe.m + np.arange(pf.ncart * nF)],
            device=self.device)
        mean = mean[rows].cpu().numpy()
        if total_E:
            mean[:nE] *= np.asarray([len(p[0]) for p in energy_pts])
        return mean, cov[rows[:, None], rows[None, :]].cpu().numpy()

    def predict_structure(self, struc, stress: bool = False,
                          return_std: bool = False, f_tol: float = 1e-8):
        """Main per-structure API (gaussianprocess.py:834-918): energy,
        forces (fixed atoms zero), the per-atom stress rows S (natoms, 6)
        in (xx, yy, zz, xy, xz, yz) with ``stress`` (else None) and, with
        return_std, the stds of E and F: (E, F, S[, E_std, F_std]).
        stress needs a descriptor built with stress=True."""
        E, F, S, *std = self._serve_structures([struc], return_std,
                                               stress)[0]
        return (E, F, S, *std)

    def predict_structures(self, strucs, return_std: bool = False):
        """Batched per-structure prediction (gp.py:1989-2069 of the JAX
        package): the descriptors of every structure from one
        ``_so3_core`` call, one pack and one served block, GEMV and
        variance for the whole batch -- e.g. every interior NEB image of
        an optimizer step.  Returns a list of (E, F) or (E, F, E_std,
        F_std) per structure, with the base potential added and fixed-atom
        rows as ``predict_structure`` gives them."""
        return [(E, F, *std) for E, F, _, *std
                in self._serve_structures(strucs, return_std)]

    def _serve_structures(self, strucs, return_std, stress: bool = False):
        """Serve structures in one descriptor call, one pack and one
        served block: per structure (E, F, S) or (E, F, S, E_std, F_std),
        E and F with the base potential added and the fixed atoms' forces
        zero (their stds too, but with ``stress``, as the JAX package
        gives them).  stress: every atom's force point carries the strain
        rows, and S = -(their 6 rows) (natoms, 6) plus the base
        potential's stress in that column order, else S is None.  The
        descriptors (``SO3.calculate_many_device``, one ``_so3_core``
        call) are computed in float64 and rounded once to the working
        dtype, as the training descriptors are (``convert_train_data``):
        float32 sums in the core would put them ~4e-7 off (NVIDIA H100
        80GB HBM3, 700.00 W; PERF.md)."""
        if stress and not getattr(self.descriptor, "stress", False):
            raise ValueError(
                "stress=True needs a stress-enabled descriptor: construct "
                "SO3(..., stress=True) so the rdxdr strain rows are "
                "computed")
        descs = self.descriptor.calculate_many_device(
            strucs, device=self.device, dtype=torch.float64,
            pair_budget=math.inf)
        for d in descs:
            for key in ("x", "dxdr", "rdxdr"):
                if d[key] is not None:
                    d[key] = d[key].to(self.dtype)
        te, tf, _, _ = self._train_view()
        pe, pf, sels = _pack_structures(strucs, descs, stress)
        mean, std = self._serve(pe, pf, te, tf, return_std)
        ncart = pf.ncart
        out = []
        f_off = pe.m
        for k, (struc, ids) in enumerate(zip(strucs, sels)):
            natoms = len(struc)
            rows = slice(f_off, f_off + ncart * len(ids))
            f_off = rows.stop
            if not stress:
                fixed = np.setdiff1d(np.arange(natoms), ids)
            else:
                fixed = np.asarray(struc.fixed_indices() if hasattr(
                    struc, "fixed_indices") else [], int)
            E = mean[k] * natoms
            mean_rows = mean[rows].reshape(-1, ncart)
            F = np.zeros((natoms, 3))
            F[ids] = mean_rows[:, :3]
            F[fixed] = 0.0
            # the raw rows carry the force functional's sign, -dE/d(eps)
            # / vol for the strain columns: negated to the ASE convention
            # (the JAX package's gp.py:1876-1886)
            S = -mean_rows[:, 3:] if stress else None
            if self.base_potential is not None:
                e_off, f_base, s_off = self.compute_base_potential(struc)
                E += e_off
                F += f_base
                F[fixed] = 0.0
                if stress and s_off is not None:
                    # the base calculators give ASE Voigt (xx, yy, zz, yz,
                    # xz, xy); the strain rows are (xx, yy, zz, xy, xz, yz)
                    S = S + np.asarray(s_off)[..., [0, 1, 2, 5, 4, 3]]
            if not return_std:
                out.append((E, F, S))
                continue
            F_std = np.zeros((natoms, 3))
            F_std[ids] = std[rows].reshape(-1, ncart)[:, :3]
            out.append((E, F, S, std[k], F_std))
        return out

    # -- validation (gaussianprocess.py:490-551) -----------------------------
    def update_y_train(self):
        """API parity (gaussianprocess.py:472-488): the stored labels as
        the (N_E + 3 N_F, 1) column ``y_train`` of the reference."""
        y = np.concatenate([
            np.asarray(self._energy_y[:self.N_energy], float),
            np.asarray(self._force_y[:self.N_forces], float).reshape(-1)])
        self.y_train = y.reshape(-1, 1)
        return self.y_train

    def validate_data(self, test_data=None, total_E=False,
                      return_std=False, show=False):
        if test_data is None:
            energy_pts = list(self._energy_pts[:self.N_energy])
            force_pts = list(self._force_pts[:self.N_forces])
            E = np.asarray(self._energy_y[:self.N_energy])
            F = np.asarray(self._force_y[:self.N_forces]).reshape(-1)
        else:
            energy_pts = [(p[0], p[2]) for p in test_data["energy"]]
            force_pts = [(p[0], p[1], p[3]) for p in test_data["force"]]
            E = np.asarray([p[1] for p in test_data["energy"]], float)
            F = np.asarray([p[2] for p in test_data["force"]],
                           float).reshape(-1)
        if total_E:
            E = E * np.asarray([len(p[0]) for p in energy_pts])

        out = self._predict_points(energy_pts, force_pts,
                                   return_std=return_std, total_E=total_E)
        if return_std:
            E_pred, F_pred, E_std, F_std = out
            if show:
                self.update_error(E, E_pred, F, F_pred)
            return E, E_pred, E_std, F, F_pred, F_std
        E_pred, F_pred = out
        if show:
            self.update_error(E, E_pred, F, F_pred)
        return E, E_pred, F, F_pred

    def update_error(self, E, E_pred, F, F_pred):
        e_r2, e_mae, e_rmse = metric_values(E, E_pred)
        f_r2, f_mae, f_rmse = metric_values(F, F_pred)
        self.error = {"energy_r2": e_r2, "energy_mae": e_mae,
                      "energy_rmse": e_rmse, "forces_r2": f_r2,
                      "forces_mae": f_mae, "forces_rmse": f_rmse}
        for key, val in self.error.items():
            self.logging.info(f"{key:<12s}: {val:.4f}")

    def compute_base_potential(self, atoms):
        return self.base_potential.calculate(atoms)

    # -- active learning (gaussianprocess.py:921-1002) ------------------------
    def convert_train_data(self, data, N_force=100000):
        """(struc, energy, forces) list -> descriptor training dict.  The
        training descriptors are computed in float64 on the model's
        device whatever its working dtype: the host store keeps float64,
        and structures that are equal up to a symmetry must give equal
        training points (their float32 descriptors differ by rounding,
        which the RBF's gamma = 1 / (2 l^2) amplifies at small l into a
        spurious split of duplicate rows of K).  Many structures go
        through one batched descriptor ingest (``SO3.calculate_many``)."""
        strucs = [s for (s, _, _) in data]
        kw = dict(device=self.device, dtype=torch.float64)
        descs = (self.descriptor.calculate_many(strucs, **kw)
                 if len(strucs) > 1
                 else [self.descriptor.calculate(s, **kw) for s in strucs])
        energy_data, force_data, db_data = [], [], []
        for d, (struc, energy, forces) in zip(descs, data):
            ele = np.asarray([ATOMIC_NUMBERS[s] for s in d["elements"]], int)
            f_ids = list(range(len(struc)))[
                :max(0, N_force - len(force_data))]
            for i, (x, dx, el) in zip(
                    f_ids, _group_force_points(d, ele, f_ids)):
                force_data.append((x, dx, forces[i], el))
            energy_data.append((d["x"], energy / len(struc), ele))
            db_data.append((struc, energy, forces, True, f_ids))
        return {"energy": energy_data, "force": force_data, "db": db_data}

    def add_structure(self, data, N_max: int = 20, tol_e_var: float = 1.2,
                      tol_f_var: float = 1.2, add_force: bool = True):
        """Add one (atoms, energy, forces) structure: its energy point
        always, and up to N_max force points of atoms the model is unsure
        about or gets wrong (gaussianprocess.py:921-1002)."""
        tol_e_var *= self.noise_e
        tol_f_var *= self.noise_f
        pts_to_add = {"energy": [], "force": [], "db": []}
        (atoms, energy, force) = data
        energy = float(energy)
        force = np.asarray(force, float)

        if self.base_potential is not None:
            energy_off, force_off, _ = self.compute_base_potential(atoms)
        else:
            energy_off, force_off = 0.0, np.zeros((len(atoms), 3))
        energy = energy - energy_off
        force = force - force_off
        my_data = self.convert_train_data([(atoms, energy, force)])

        if self.alpha_ is not None:
            E, E1, E_std, F, F1, F_std = self.validate_data(
                my_data, return_std=True)
            E_std = float(E_std[0])
            F_std = F_std.reshape(-1, 3)
            f_sel = my_data["db"][0][4]
            F_full = np.zeros((len(atoms), 3))
            F1_full = np.zeros((len(atoms), 3))
            Fstd_full = 2 * tol_f_var * np.ones((len(atoms), 3))
            F_full[f_sel] = F.reshape(-1, 3)
            F1_full[f_sel] = F1.reshape(-1, 3)
            Fstd_full[f_sel] = F_std
            F, F1, F_std = F_full, F1_full, Fstd_full
            E, E1 = [float(E[0])], [float(E1[0])]
        else:
            E = E1 = [energy / len(atoms)]
            F = F1 = force.copy()
            E_std = 2 * tol_e_var
            F_std = 2 * tol_f_var * np.ones((len(atoms), 3))

        F = np.asarray(F).reshape(len(atoms), 3)
        F1 = np.asarray(F1).reshape(len(atoms), 3)

        # the energy row is always added (gaussianprocess.py:964-969)
        pts_to_add["energy"] = my_data["energy"]
        energy_in = True

        force_in = []
        if add_force:
            xs_added = []
            sel_map = {fi: k for k, fi in enumerate(my_data["db"][0][4])}
            for f_id in range(len(atoms)):
                include = False
                if (np.max(F_std[f_id]) > tol_f_var
                        or np.max(abs(F[f_id] - F1[f_id])) > 1.5 * tol_f_var):
                    X = my_data["energy"][0][0][f_id]
                    _ele = my_data["energy"][0][2][f_id]
                    if f_id in sel_map and (
                            len(xs_added) == 0 or new_pt((X, _ele),
                                                         xs_added)):
                        include = True
                if include:
                    force_in.append(f_id)
                    xs_added.append((X, _ele))
                    pts_to_add["force"].append(
                        my_data["force"][sel_map[f_id]])
                if len(force_in) == N_max:
                    break

        N_pts = (1 if energy_in else 0) + len(force_in)
        if N_pts > 0:
            pts_to_add["db"].append((atoms, energy, force, energy_in,
                                     force_in))
            self.set_train_pts(pts_to_add, mode="a+")
        eoff_at = energy_off / max(len(atoms), 1)
        errors = (E[0] + eoff_at, E1[0] + eoff_at, E_std,
                  F.reshape(-1) + force_off.reshape(-1),
                  F1.reshape(-1) + force_off.reshape(-1), F_std)
        return pts_to_add, N_pts, errors

    # -- sparsification (gaussianprocess.py:1004-1023, 1165-1182) -------------
    def sparsify(self, e_tol=1e-10, f_tol=1e-10):
        """Drop the training points CUR finds redundant and refit: the
        kernel covariance of the training set (``k_self`` in float64, K1
        and K2 on the card; no noise), CUR over its energy block and its
        force block on the model's device, and a force point removed only
        when all three of its rows are chosen (the JAX package's rule);
        then ``remove_train_pts``, which refits from scratch."""
        e, f = self._pack(self.N_energy, self.N_forces)
        N_e, N_f = self.N_energy, self.N_forces
        n = e.m + 3 * f.m
        _check_buffers(self.device,
                       8 * (n * n + 3 * max(N_e, 3 * N_f) ** 2),
                       "sparsify")
        K = K_ops.k_self(e, f, self.kernel.params(), self.kernel.zeta,
                         self.kernel.kind, mesh=self._mesh_arg(),
                         dtype=torch.float64)
        pts_e = CUR(K[:N_e, :N_e], e_tol)
        pts = CUR(K[e.m:e.m + 3 * N_f, e.m:e.m + 3 * N_f], f_tol)
        del K
        chosen = np.zeros(3 * N_f, bool)
        chosen[pts] = True
        pts_f = [i for i in range(N_f) if chosen[3 * i:3 * i + 3].all()]
        print("{:d} energy and {:d} forces will be removed".format(
            len(pts_e), len(pts_f)))
        if len(pts_e) + len(pts_f) > 0:
            self.remove_train_pts(pts_e, pts_f)

    # -- bootstrap (gaussianprocess.py:1025-1116) -----------------------------
    @classmethod
    def set_GPR(cls, images, base, kernel="RBF", zeta=2.0, noise_e=0.002,
                noise_f=0.1, lmax=4, nmax=3, rcut=5.0, json_file=None,
                overwrite=False, **kwargs):
        """A GP trained on ``images`` with the ``base`` calculator, its
        hyperparameters optimised from (sigma, l) = (1.0, 0.1) for RBF or
        (sigma, sigma0) = (2.0, 2.0) for kernel="Dot".  kwargs go to the
        constructor (device, dtype, log_file, mesh).  With an existing
        ``json_file``: the saved model (``load``), with ``overwrite`` the
        noise and kernel given here, then fitted."""
        if json_file is not None and os.path.exists(json_file):
            instance = cls.load(json_file, **kwargs)
            if overwrite:
                instance.noise_e = noise_e
                instance.noise_f = noise_f
                if instance.kernel.name != kernel:
                    instance.kernel = (
                        RBF(para=[1.0, 0.1], zeta=int(zeta))
                        if kernel == "RBF"
                        else Dot(para=[2, 2.0], zeta=int(zeta)))
            instance.fit()
            return instance
        instance = cls(kernel=None, descriptor=None, base_potential=None,
                       **kwargs)
        instance.kernel = (Dot(para=[2, 2.0], zeta=int(zeta))
                           if kernel == "Dot"
                           else RBF(para=[1.0, 0.1], zeta=int(zeta)))
        instance.descriptor = SO3(nmax=nmax, lmax=lmax, rcut=rcut)
        instance.noise_e = float(noise_e)
        instance.noise_f = float(noise_f)
        instance.train_images(images, base)
        return instance

    # -- loading (gp.py:2220-2300 of the JAX package) -------------------------
    @classmethod
    def load(cls, filename, N_max=None, device=None, **kwargs):
        """A model from its JSON metadata and its training database (the
        JSON's ``db_filename``, looked up beside the JSON when the path
        as written does not exist).  ``device``: the model's device,
        default ``config.device()``; kwargs go to the constructor.  The
        model is not fitted: call ``fit``."""
        with open(filename, "r") as fp:
            dict0 = json.load(fp)
        instance = cls.load_from_dict(dict0, device=device, **kwargs)
        db_file = dict0["db_filename"]
        if not os.path.isabs(db_file):
            cand = os.path.join(os.path.dirname(os.path.abspath(filename)),
                                os.path.basename(db_file))
            if os.path.exists(cand) and not os.path.exists(db_file):
                db_file = cand
        instance.extract_db(db_file, N_max)
        print(f"load GP model from {filename}")
        print(instance)
        instance.logging.info(f"load GP model from {filename}")
        return instance

    @classmethod
    def load_from_dict(cls, dict0, device=None, **kwargs):
        """A model with the kernel, descriptor, noise and base potential
        of ``save_dict``'s dict, and no training data."""
        instance = cls(kernel=None, descriptor=None, base_potential=None,
                       device=device, **kwargs)
        instance.kernel = kernel_from_dict(dict0["kernel"])
        if dict0["descriptor"]["_type"] != "SO3":
            raise NotImplementedError(
                "unknown descriptor {}".format(dict0["descriptor"]))
        instance.descriptor = SO3.from_dict(dict0["descriptor"])
        if "base_potential" in dict0:
            if dict0["base_potential"]["name"] != "LJ":
                raise NotImplementedError("unknown base potential")
            from ..calculators.lj import LJ
            instance.base_potential = LJ(dict0["base_potential"])
        instance.noise_e = dict0["noise"]["energy"]
        instance.noise_f = dict0["noise"]["force"]
        instance.f_coef = dict0["noise"]["f_coef"]
        instance.noise_bounds = dict0["noise"]["bounds"]
        return instance

    def extract_db(self, db_filename, N_max=None):
        """The training set of an (ASE-compatible) database: its first
        ``N_max`` rows, each row's energy point if ``energy_in`` and the
        force points of ``force_in``, their descriptors from one batched
        float64 ingest on the model's device (``SO3.calculate_many``)."""
        from ..io.ase_db import read_db
        rows = read_db(db_filename)
        if N_max is not None:
            rows = rows[:N_max]
        descs = self.descriptor.calculate_many(
            [row["atoms"] for row in rows], device=self.device,
            dtype=torch.float64)
        pts = {"energy": [], "force": [], "db": []}
        for d, row in zip(descs, rows):
            atoms = row["atoms"]
            energy = row["data"]["energy"]
            force = np.asarray(row["data"]["force"], float)
            energy_in = bool(row["data"]["energy_in"])
            force_in = list(row["data"]["force_in"])
            ele = np.asarray([ATOMIC_NUMBERS[s] for s in d["elements"]], int)
            if energy_in:
                pts["energy"].append((d["x"], energy / len(atoms), ele))
            for fid, (x, dx, el) in zip(
                    force_in, _group_force_points(d, ele, force_in)):
                pts["force"].append((x, dx, force[fid], el))
            pts["db"].append((atoms, energy, force, energy_in, force_in))
        self.set_train_pts(pts, "w")
        print(f"Loaded {len(rows)} structures from {db_filename}")

    def train_images(self, images, base):
        for i, image in enumerate(images):
            image.calc = base
            eng = float(image.get_potential_energy())
            forces = np.asarray(image.get_forces(), float)
            print(f"Calculate E/F for image {i}: {eng:.6f}")
            image.calc = None
            self.add_structure((image.copy(), eng, forces))
        self.fit()
        self.validate_data(show=True)


def CUR(K, l_tol=1e-10):
    """The rows that CUR finds redundant in the symmetric K
    (gaussianprocess.py:1165-1182; Appendix D of Jinnouchi et al., PRB 100,
    014105 (2019)): with the N eigenvalues of K below ``l_tol``, the N
    rows of the largest weight in their eigenvectors, sum over those
    eigenvectors of U_ij^2.  ``torch.linalg.eigh`` in float64 runs on K's
    device (a NumPy K: on the CPU), the ranking on the host (NumPy's
    argsort, as the JAX package's).  Raises ValueError, before it
    allocates, when its float64 buffers would take more than MEMORY_SHARE
    of that device's free memory."""
    K = torch.as_tensor(K)
    n = K.shape[0]
    _check_buffers(K.device, 8 * 3 * n * n, "CUR")
    L, U = torch.linalg.eigh(K.to(torch.float64))
    low = L < l_tol
    omega = (U[:, low] ** 2).sum(dim=1).cpu().numpy()
    return np.argsort(-omega)[:int(low.sum())]
