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
