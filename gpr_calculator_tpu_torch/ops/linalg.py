r"""Incremental (block rank-k) Cholesky factorisation: the refit of
``GP.fit(opt=False)`` when training rows were appended at unchanged
hyperparameters (the JAX package's ``ops/linalg.py:170-240``).

    K_new = [[K,   B],        L_new = [[L,   0  ],
             [B^T, C]]                 [S^T, L_c]]

    S   = L^-1 B                  (triangular solve, n x k)
    L_c = chol(C - S^T S)         (k x k)

O(n^2 k) against the O(n^3) of a refactorisation.  The weights come from
two triangular solves against L_new (``chol_solve``), which are backward
stable at any conditioning; an explicit-inverse Schur update loses
~cond(K) digits in alpha (the JAX package measured 8 meV at GPR
conditioning sigma^2 / noise^2 ~ 1e9), so none is formed here.

L_new is a new tensor in L's memory order.  The JAX package extends its
factor in place in a donated capacity buffer, with ghost columns and
k-buckets (``chol_append_buf``): those exist for XLA's static shapes.  A
float64 capacity buffer of 256-row steps written in place was slower at
the 10 000-row bench covariance, 4.32-4.70 ms against 3.83-4.17 ms an
append of 25 or 100 rows (NVIDIA H100 80GB HBM3, 700.00 W;
``chip_smoke.py`` (n1), PERF.md): ``solve_triangular`` copies the
buffer's strided view, so both move one n^2 factor an append.

The warning against explicit inverses above is about alpha, whose error
scales with cond(K): alpha stays on the two triangular solves.  The
served variance needs V = L^-1 k, whose error scales with cond(L) =
sqrt(cond(K)), so ``GP`` keeps L^-1 for serving (``tri_inverse``, and
``inv_append`` when rows are appended) and forms V by one GEMM in place
of a triangular solve per request.  In float64 numpy (an RBF kernel,
unit prior, 16 queries) the variance from an explicit L^-1 and from
``solve_triangular`` differed by at most 6.2e-14 at cond(K) 1.1e8 and
8.0e-13 at 1.1e14 (n = 2000; smallest posterior variance 3.8e-11),
8.1e-13 at 3e13 (n = 3000), and by 4.8e-14 after 20 appends of 25 rows
to a 1000-row factor with L^-1 extended by ``inv_append`` (cond 8e11).
On the card the served variances of the two paths differed by 3.4e-14
at 3000 rows and 3.7e-14 after a 200-row append (2e-15 of the largest
prior); at the 10 000-row bench factor V of 16 columns took 5.29 ms by
the solve and 0.29 ms by the GEMM, and ``tri_inverse`` 25.4 ms (NVIDIA
H100 80GB HBM3, 700.00 W; PERF.md).
"""
from __future__ import annotations

import torch


def chol_append(L, B, C):
    """Extend the lower factor L (n, n) of K by k rows: B (n, k) is
    K(old, new), C (k, k) the new rows' self block with their noise, all
    in L's dtype.

    Returns (L_new (n + k, n + k), L_c's diagonal).  A diagonal entry that
    is not finite or not positive signals an extension that is not
    positive definite (from the first failing pivot on, entries are NaN),
    and the factor must then be rebuilt from scratch; nothing here waits
    for the device."""
    n, k = B.shape
    S = torch.linalg.solve_triangular(L, B, upper=False)
    Lc, info = torch.linalg.cholesky_ex(C - S.T @ S)
    # in L's memory order (torch.linalg returns column-major factors), so
    # that L is copied as it lies
    L_new = L.new_empty((n + k, n + k))
    if L.stride(0) < L.stride(1):
        L_new = L_new.T
    L_new[:n, :n] = L
    L_new[:n, n:] = 0.0
    L_new[n:, :n] = S.T
    L_new[n:, n:] = Lc
    pos = torch.arange(1, k + 1, device=info.device)
    failed = (info > 0) & (pos >= info)
    return L_new, torch.where(failed, torch.nan, Lc.diagonal())


def chol_solve(L, y):
    """K^-1 y for K = L L^T: two triangular solves against the lower
    factor L."""
    return torch.cholesky_solve(y[:, None], L)[:, 0]


def tri_inverse(L):
    """L^-1 of the lower factor L, lower triangular (its upper triangle
    exactly zero): one triangular solve against the identity, in place
    in the identity's storage."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False, out=eye)


def inv_append(L_inv, L_new):
    """L_new^-1 from L^-1 (n, n) and ``chol_append``'s extended factor
    L_new = [[L, 0], [S^T, L_c]] (n + k, n + k):

        L_new^-1 = [[L^-1,                  0     ],
                    [-L_c^-1 S^T L^-1,      L_c^-1]]

    O(n^2 k): one (k, n) x (n, n) product and the k x k inverse of L_c,
    against the O(n^3) of ``tri_inverse`` of L_new."""
    n = L_inv.shape[0]
    Lc_inv = tri_inverse(L_new[n:, n:])
    out = L_inv.new_empty(L_new.shape)
    out[:n, :n] = L_inv
    out[:n, n:] = 0.0
    out[n:, :n] = -(Lc_inv @ (L_new[n:, :n] @ L_inv))
    out[n:, n:] = Lc_inv
    return out
