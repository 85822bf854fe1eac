r"""Plain covariance blocks of the many-body kernels on SO3 descriptors,
the RBF and the Dot family (the upstream's ``RBF_mb`` and ``Dot_mb``).

The upstream models (gpr_calc/kernels/rbf_kernel.cpp, dot_kernel.cpp)
compare local environments a, b of the same element through unit
descriptors u = x/|x|, c = u_a . u_b:

    RBF  k(a, b) = s2 exp((c^z - 1) g),  g = 1 / (2 l^2),  theta (sigma, l)
    Dot  k(a, b) = s2 (c^z + s0^2),                   theta (sigma, sigma0)

with s2 = sigma^2, s0 = sigma0.  An energy point is a structure's
per-atom energy (its envs weighted by 1 / natoms), a force point one
atom's force (its envs weighted by 1 / |x| and carried by J = dx/dr).
With Jt = J - u (J . u):

    K_EE[p, q]        = sum_{a in p, b in q} w_a w_b k
    K_EF[p, (q, v)]   = sum -A w_a r_b (u_a . Jt_b,v)
    K_FF[(p, u), (q, v)] = sum r_a r_b (A Jt_a,u . Jt_b,v
                                        + B (Jt_a,u . u_b)(u_a . Jt_b,v))

A = dk/dc, B = d2k/dc2, only pairs of one element counted:
RBF A = k g z c^(z-1), B = k g (z (z-1) c^(z-2) + (z c^(z-1))^2 g);
Dot A = s2 z c^(z-1), B = s2 z (z-1) c^(z-2).  ``dual`` (RBF only) adds
the same sums with the d/dg coefficients, for the NLL's l-gradient; the
Dot kernel's sigma0 enters only through the constant s2 s0^2, whose
energy-block sums are ``pair_counts``.  Points are padded to a common env
count with zero rows (weight 0).  ``family`` is "RBF" or "Dot".

``prec`` is "f64" (the reference) or "tf32" (the control): the operands
rounded to TF32's 10-bit mantissa, their products summed in float32, the
coefficients and sums in float32, as a float32 program whose dot
products ran on TF32 tensor cores would compute them.
"""
from __future__ import annotations

import torch

EPS = 1e-8
FAMILIES = ("RBF", "Dot")
PAIR_BUDGET = 2 ** 24       # env pairs per chunk


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) at TF32's 10
    mantissa bits."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def _cast(t: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f64":
        return t.to(torch.float64)
    if prec == "tf32":
        return round_tf32(t)
    raise ValueError(f"unknown precision {prec!r}")


def _work_dtype(prec: str):
    return torch.float64 if prec == "f64" else torch.float32


class Energy:
    """An energy side: x (m, A, d), ele (m, A), counts (m,)."""

    def __init__(self, x, ele, counts, prec="f64"):
        x = x.to(torch.float64)
        m, A, d = x.shape
        n = torch.sqrt((x * x).sum(2))
        valid = (n > EPS) & (ele > 0)
        u = x / torch.where(valid, n, torch.ones_like(n))[..., None]
        w = torch.where(valid, 1.0 / counts.to(torch.float64)[:, None],
                        torch.zeros_like(n))
        dt = _work_dtype(prec)
        self.m, self.B, self.prec = m, A, prec
        self.U = _cast(u.reshape(m * A, d), prec)
        self.w = w.reshape(-1).to(dt)
        self.el = ele.reshape(-1)


class Force:
    """A force side: x (m, B, d), dxdr (m, B, d, 3), ele (m, B)."""

    def __init__(self, x, dxdr, ele, prec="f64"):
        x, J = x.to(torch.float64), dxdr.to(torch.float64)
        m, B, d = x.shape
        n = torch.sqrt((x * x).sum(2))
        valid = (n > EPS) & (ele > 0)
        nsafe = torch.where(valid, n, torch.ones_like(n))
        u = x / nsafe[..., None]
        Jt = J - u[..., None] * torch.einsum("pbdc,pbd->pbc", J, u)[:, :, None]
        X = torch.cat([u[None], Jt.permute(3, 0, 1, 2)])     # (4, m, B, d)
        dt = _work_dtype(prec)
        self.m, self.B, self.prec = m, B, prec
        self.X = _cast(X.reshape(4, m * B, d), prec)
        self.r = torch.where(valid, 1.0 / nsafe,
                             torch.zeros_like(n)).reshape(-1).to(dt)
        self.el = ele.reshape(-1)


def _coeffs(c, s2, p2, zeta, family, dual):
    """[(k, A, B)] of the family, p2 the second scalar of ``_scalars``;
    with ``dual`` (RBF) also their d/dg."""
    if dual and family == "Dot":
        raise ValueError("the Dot kernel has no dual plane: its sigma0 "
                         "derivative is pair_counts")
    d1 = c ** (zeta - 1)
    D = d1 * c
    zd1 = zeta * d1
    b0 = zeta * (zeta - 1) * c ** (zeta - 2) if zeta >= 2 \
        else torch.zeros_like(c)
    if family == "Dot":
        return [(s2 * (D + p2), s2 * zd1, s2 * b0)]
    g = p2
    k = s2 * torch.exp((D - 1.0) * g)
    A = k * g * zd1
    B = k * g * (b0 + zd1 * zd1 * g)
    sets = [(k, A, B)]
    if dual:
        Dm1 = D - 1.0
        sets.append((k * Dm1, A * Dm1 + k * zd1,
                     B * Dm1 + k * (b0 + 2.0 * zd1 * zd1 * g)))
    return sets


def _point_sum(env, b1, b2):
    n1, n2 = env.shape
    return env.reshape(n1 // b1, b1, n2).sum(1).reshape(
        n1 // b1, n2 // b2, b2).sum(2)


def _scalars(theta, family):
    """(s2, g) for RBF, (s2, s0^2) for Dot."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}")
    sigma, second = (float(t) for t in theta)
    if family == "Dot":
        return sigma * sigma, second * second
    return sigma * sigma, 1.0 / (2.0 * second * second)


def _chunk(b1, n2):
    return max(1, PAIR_BUDGET // max(b1 * n2, 1))


def _kee_sum(E1: Energy, E2: Energy, planes, ks):
    """[sum_{a in p, b in q} w_a w_b k] for each of the ``planes`` k that
    ``ks(c)`` gives of a chunk's env-pair cosines c."""
    outs = [E1.U.new_zeros((E1.m, E2.m)) for _ in range(planes)]
    pc = _chunk(E1.B, E2.m * E2.B)
    for p0 in range(0, E1.m, pc):
        p1 = min(E1.m, p0 + pc)
        rows = slice(p0 * E1.B, p1 * E1.B)
        c = E1.U[rows] @ E2.U.T
        w = (E1.w[rows, None] * E2.w[None, :]
             * (E1.el[rows, None] == E2.el[None, :]))
        for out, k in zip(outs, ks(c)):
            out[p0:p1] = _point_sum(k * w, E1.B, E2.B)
    return outs


def kee(E1: Energy, E2: Energy, theta, zeta, family, dual=False):
    s2, p2 = _scalars(theta, family)
    return _kee_sum(E1, E2, 1 + dual, lambda c: [
        k for k, _, _ in _coeffs(c, s2, p2, zeta, family, dual)])


def pair_counts(E: Energy):
    """W[p, q] = sum_{a in p, b in q} w_a w_b over same-element env pairs
    (m, m): K_EE's pair sum with k = 1, dK_EE/d(s0^2) / s2 of the Dot
    kernel."""
    (W,) = _kee_sum(E, E, 1, lambda c: [torch.ones_like(c)])
    return W


def kef(E: Energy, F: Force, theta, zeta, family, dual=False):
    """K_EF (m_E, 3 m_F)."""
    s2, p2 = _scalars(theta, family)
    outs = [E.U.new_zeros((E.m, F.m, 3)) for _ in range(1 + dual)]
    pc = _chunk(E.B, F.m * F.B)
    for p0 in range(0, E.m, pc):
        p1 = min(E.m, p0 + pc)
        rows = slice(p0 * E.B, p1 * E.B)
        G = torch.einsum("nd,jmd->jnm", E.U[rows], F.X)
        w = (E.w[rows, None] * F.r[None, :]
             * (E.el[rows, None] == F.el[None, :]))
        for out, (_, A, _) in zip(outs, _coeffs(G[0], s2, p2, zeta, family,
                                                dual)):
            Aw = -A * w
            for v in range(3):
                out[p0:p1, :, v] = _point_sum(Aw * G[1 + v], E.B, F.B)
    return [o.reshape(E.m, 3 * F.m) for o in outs]


def kff(F1: Force, F2: Force, theta, zeta, family, dual=False,
        symmetric=False):
    """K_FF (3 m1, 3 m2); ``symmetric`` (F1 is F2): the upper point
    stripes, mirrored."""
    s2, p2 = _scalars(theta, family)
    outs = [F1.X.new_zeros((F1.m, 3, F2.m, 3)) for _ in range(1 + dual)]
    pc = _chunk(F1.B, F2.m * F2.B)
    for p0 in range(0, F1.m, pc):
        p1 = min(F1.m, p0 + pc)
        q0 = p0 if symmetric else 0
        rows, cols = slice(p0 * F1.B, p1 * F1.B), slice(q0 * F2.B, None)
        G = torch.einsum("ind,jmd->ijnm", F1.X[:, rows], F2.X[:, cols])
        w = (F1.r[rows, None] * F2.r[None, cols]
             * (F1.el[rows, None] == F2.el[None, cols]))
        for out, (_, A, B) in zip(outs, _coeffs(G[0, 0], s2, p2, zeta,
                                                family, dual)):
            Aw, Bw = A * w, B * w
            for u in range(3):
                BG = Bw * G[1 + u, 0]
                for v in range(3):
                    out[p0:p1, u, q0:, v] = _point_sum(
                        Aw * G[1 + u, 1 + v] + BG * G[0, 1 + v], F1.B, F2.B)
    outs = [o.reshape(3 * F1.m, 3 * F2.m) for o in outs]
    if symmetric:
        outs = [torch.triu(o) + torch.triu(o, 1).T for o in outs]
    return outs


def block(E1, F1, E2, F2, theta, zeta, family, dual=False,
          symmetric=False):
    """[[K_EE, K_EF], [K_FE, K_FF]] in float64 (and dK/dg with dual),
    rows [energies, 3 a force point]."""
    f64 = torch.float64
    ee = kee(E1, E2, theta, zeta, family, dual)
    ef = kef(E1, F2, theta, zeta, family, dual)
    fe = ef if symmetric else kef(E2, F1, theta, zeta, family, dual)
    ff = kff(F1, F2, theta, zeta, family, dual, symmetric)
    out = []
    for k in range(1 + dual):
        top = torch.cat([ee[k], ef[k]], 1)
        bottom = torch.cat([fe[k].T, ff[k]], 1)
        out.append(torch.cat([top, bottom]).to(f64))
    return out


def prior(E: Energy, F: Force, theta, zeta, family):
    """k(x, x) of every row: each energy point's K_EE(p, p), each force
    point's three K_FF diagonal entries, float64."""
    s2, p2 = _scalars(theta, family)
    U = E.U.reshape(E.m, E.B, -1)
    (k, _, _), = _coeffs(torch.bmm(U, U.transpose(1, 2)), s2, p2, zeta,
                         family, False)
    w, el = E.w.reshape(E.m, E.B), E.el.reshape(E.m, E.B)
    pe = (k * w[:, :, None] * w[:, None, :]
          * (el[:, :, None] == el[:, None, :])).sum((1, 2))
    X = F.X.reshape(4, F.m, F.B, -1)
    G = torch.einsum("ipad,jpbd->ijpab", X, X)
    r, el = F.r.reshape(F.m, F.B), F.el.reshape(F.m, F.B)
    w = r[:, :, None] * r[:, None, :] * (el[:, :, None] == el[:, None, :])
    (_, A, B), = _coeffs(G[0, 0], s2, p2, zeta, family, False)
    pf = torch.stack([(A * w * G[1 + u, 1 + u]
                       + B * w * G[1 + u, 0] * G[0, 1 + u]).sum((1, 2))
                      for u in range(3)], 1)
    return torch.cat([pe, pf.reshape(-1)]).to(torch.float64)
