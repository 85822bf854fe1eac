"""Dry run of the mesh-sharded programs at a small, non-toy shape.

``dryrun_multichip(n_shards, devices=None)`` is the port's counterpart of
the JAX package's ``__graft_entry__.dryrun_multichip``: the same steps at
the same shapes (d = 30, 8 energy points of 12 atoms, 64 force points of
20 envs, made from the same seeds), each held to the same limit:

  1. the sharded analytic NLL and gradient (the program ``GP.fit`` runs
     at every L-BFGS-B evaluation), finite, against the unsharded one;
  3. ``_factorize`` with the sharded build: the replicated Cholesky, and
     the mesh-sharded one (alpha within 5e-4);
  4. sharded serving of one structure, through both gate settings and
     against the unsharded block (mean within 5e-4, std finite);
  5. the sharded ``k_self`` against the unsharded one (5e-4);
  6. ``cholesky_sharded`` (nb = 64) against a float64 factor (5e-5).

Step 2 of the JAX dry run, the autodiff NLL on the sharded operands, has
no counterpart: the port has no autodiff objective.  With ``devices``
None the mesh takes the cards present; name the devices otherwise
(``devices=["cpu"] * n_shards`` or ``["cuda:0"] * n_shards``: virtual
shards on one device).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..models.gp import (_factorize, _nll_rbf_analytic, _predict_packed)
from ..models.posterior import Posterior
from ..ops import kernels as K_ops
from ..ops.packing import pack_energy, pack_force
from .cholesky import cholesky_sharded
from .mesh import make_mesh


def _synthetic_data(m_e, a, m_f, b, d, seed, device, dtype):
    rng = np.random.RandomState(seed)
    epts = [(rng.uniform(0.2, 1.0, (a, d)), rng.choice([13, 79], a))
            for _ in range(m_e)]
    fpts = [(rng.uniform(0.2, 1.0, (b, d)), rng.uniform(-1, 1, (b, d, 3)),
             rng.choice([13, 79], b)) for _ in range(m_f)]
    kw = dict(device=device, dtype=dtype)
    return (pack_energy(epts, m_pad=m_e, a_pad=a, **kw),
            pack_force(fpts, m_pad=m_f, b_pad=b, **kw))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-8))


def _check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def dryrun_multichip(n_shards: int, devices=None) -> dict:
    """Run the sharded programs once on an ``n_shards`` mesh and hold
    each to its limit; returns the readings.  Leaves the gate setting as
    it found it."""
    mesh = make_mesh(n_shards, devices)
    dev, dt = mesh.root, config.dtype(mesh.root)
    d, m_f = 30, max(64, 2 * n_shards)
    e, f = _synthetic_data(8, 12, m_f, 20, d, 3, dev, dt)
    y = torch.as_tensor(np.random.RandomState(4).randn(e.m + 3 * f.m) * 0.1,
                        dtype=dt, device=dev)
    theta, noise = (1.5, 0.8), (0.01, 0.1)
    params = {"sigma": theta[0], "l": theta[1]}
    gate = config.sharded_gate()
    try:
        config.set_sharded_gate("off")
        # 1. the training program: analytic NLL over the sharded dual build
        nll, grad = _nll_rbf_analytic(theta, e, f, y, noise, 10.0, 2, False,
                                      mesh=mesh)
        nll_1, grad_1 = _nll_rbf_analytic(theta, e, f, y, noise, 10.0, 2,
                                          False)
        _check(bool(torch.isfinite(nll)) and bool(torch.isfinite(grad).all()),
               "sharded analytic NLL or gradient is not finite")
        nll_err = abs(float(nll) - float(nll_1)) / max(1.0, abs(float(nll_1)))
        _check(nll_err < 1e-6, f"sharded vs unsharded NLL: {nll_err}")
        _check(_rel(grad, grad_1) < 1e-5, "sharded vs unsharded gradient")

        # 3. the factorisation: sharded build, replicated and sharded solve
        L, alpha = _factorize(e, f, y, params, *noise, 2, "rbf", mesh=mesh)
        _check(bool(torch.isfinite(alpha).all()), "alpha is not finite")
        _, alpha_sc = _factorize(e, f, y, params, *noise, 2, "rbf",
                                 mesh=mesh, chol_mode="sharded")
        a_err = _rel(alpha_sc, alpha)
        _check(a_err < 5e-4, f"sharded-Cholesky alpha mismatch: {a_err}")

        # 4. sharded serving of one structure, gate auto and off, against
        # the unsharded block
        pe, pf = _synthetic_data(1, 12, 6, 20, d, 5, dev, dt)
        post = Posterior.from_packed(e, f, L, alpha)
        serve = {}
        for label, setting, m in (("auto", "auto", mesh), ("off", "off", mesh),
                                  ("unsharded", "auto", None)):
            config.set_sharded_gate(setting)
            serve[label] = _predict_packed(pe, pf, post, params, 2, "rbf",
                                           True, mesh=m)
        config.set_sharded_gate("off")
        mean_ref = serve["unsharded"][0]
        serve_err = max(_rel(serve[k][0], mean_ref) for k in ("auto", "off"))
        _check(serve_err < 5e-4, f"sharded serving diverges: {serve_err}")
        _check(all(bool(torch.isfinite(s).all()) for _, s in serve.values()),
               "a served std is not finite")

        # 5. the sharded triangular build against the single-device one
        K_sh = K_ops.k_self(e, f, params, 2, mesh=mesh)
        K_ref = K_ops.k_self(e, f, params, 2)
        k_err = _rel(K_sh, K_ref)
        _check(k_err < 5e-4, f"sharded k_self mismatch: {k_err}")
    finally:
        config.set_sharded_gate(gate)

    # 6. the sharded blocked Cholesky on that covariance
    K_pd = K_ref + 0.05 * torch.eye(K_ref.shape[0], dtype=dt, device=dev)
    L_sh = cholesky_sharded(K_pd, mesh, nb=64)
    L_64 = torch.linalg.cholesky(K_pd.double())
    chol_err = _rel(L_sh.double(), L_64)
    _check(chol_err < 5e-5, f"sharded Cholesky mismatch: {chol_err}")
    out = dict(n_shards=n_shards, devices=[str(x) for x in mesh.devices],
               nll=float(nll), grad_max=float(grad.abs().max()),
               nll_err=nll_err, alpha_norm=float(alpha.norm()),
               alpha_err=a_err, serve_err=serve_err, k_self_err=k_err,
               chol_err=chol_err)
    print(f"dryrun_multichip({n_shards}) on {out['devices']}: "
          f"NLL={out['nll']:.4f}, |grad|max={out['grad_max']:.4f}, "
          f"alpha norm={out['alpha_norm']:.4f}, sharded-chol alpha parity="
          f"{a_err:.2e}, serving parity={serve_err:.2e}, k_self parity="
          f"{k_err:.2e}, cholesky parity={chol_err:.2e} OK")
    return out
