"""What a fit leaves behind, the state a GP serves from and appends to:
``GP`` holds one ``Posterior`` and replaces it whole at every fit, so
nothing built from an old factor outlives it."""
from __future__ import annotations

import numpy as np
import torch

from .. import config, utils_profiling
from ..ops import kernels as K_ops
from ..ops import linalg


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


class Posterior:
    """One fit's state, built from the float64 factor L and weights
    ``alpha`` of the real rows of the packed training set (e, f) in the
    insertion order of ``groups`` [(kE, kF), ...] (``_factor_perm``).
    ``snapshot``: (e, f, nE, nF); ``cols``: the packed column of each
    factor row, by which ``_predict_packed`` gathers the cross
    covariance; ``alpha``: the weights in packed order, zero on padded
    rows; ``sig``: the GP's ``_params_signature()`` at the fit;
    ``appendable``: False once the GP's training set is replaced;
    ``Linv``: L^-1 once ``inverse`` has built it.  log: a logger's
    ``info``, told when L^-1 does not fit."""

    def __init__(self, e, f, L, alpha, groups, sig=None, log=None):
        nE, nF = e.nreal, f.nreal
        self.snapshot = (e, f, nE, nF)
        self.L, self.groups, self.sig = L, list(groups), sig
        self.appendable = True
        self.cols = torch.as_tensor(
            _packed_rows(nE, nF, e.m)[_factor_perm(groups, nE)],
            device=L.device)
        self.alpha = L.new_zeros(e.m + 3 * f.m)
        self.alpha[self.cols] = alpha
        self.Linv = None
        self._declined = False   # L^-1 did not fit beside this factor
        self._ops = {}           # matmul precision -> training operands
        self._log = log

    @classmethod
    def from_packed(cls, e, f, L, alpha, sig=None, log=None):
        """From ``_factorize``'s factor and weights over the packed rows:
        their real rows, in canonical order.  The padded rows have unit
        noise and no coupling, so the real rows of the padded factor are
        the factor of the real covariance."""
        r = torch.as_tensor(_packed_rows(e.nreal, f.nreal, e.m),
                            device=L.device)
        if len(r) != L.shape[0]:
            L = L[r[:, None], r[None, :]]
        return cls(e, f, L, alpha[r], [(e.nreal, f.nreal)], sig, log)

    def append(self, e, f, B, C, y):
        """The posterior of (e, f), whose points extend the snapshot's, in
        O(n^2 k): the factor extended by B = K(old, new) (factor order)
        and C = K(new, new) plus the noise, both float64
        (``linalg.chol_append``), the weights solved from ``y`` (the real
        rows' float64 labels, canonical order), a kept L^-1 extended
        (``linalg.inv_append``, counter ``factor_inv.extend``) where it
        still fits.  None where the extension is not positive definite."""
        L, lc_diag = linalg.chol_append(self.L, B, C)
        lc_diag = lc_diag.cpu().numpy()
        if not (np.all(np.isfinite(lc_diag)) and np.all(lc_diag > 0)):
            return None
        _, _, nE, nF = self.snapshot
        groups = self.groups + [(e.nreal - nE, f.nreal - nF)]
        perm = torch.as_tensor(_factor_perm(groups, e.nreal),
                               device=y.device)
        new = Posterior(e, f, L, linalg.chol_solve(L, y[perm]), groups,
                        self.sig, self._log)
        new._declined = self._declined
        if self.Linv is not None and new._inverse_fits():
            new.Linv = linalg.inv_append(self.Linv, L)
            utils_profiling.count("factor_inv.extend")
        return new

    def operands(self, mesh=None):
        """The training side's operands for serving in the matmul
        precision in force, built once for each precision and kept.  None
        on a mesh: the sharded block builds its own."""
        if mesh is not None:
            return None
        mode = config.kff_precision()
        if mode not in self._ops:
            e, f, _, _ = self.snapshot
            self._ops[mode] = K_ops.side_operands(e, f, mode, "train")
        return self._ops[mode]

    def _inverse_fits(self) -> bool:
        """Whether L^-1 may be kept: its float64 buffers, 2 n^2 (L^-1 and
        the identity it is solved from, or the L^-1 an append extends),
        within MEMORY_SHARE of the device's free memory; once not, never
        again for this factor and those appended to it (logged once)."""
        if self._declined:
            return False
        n = self.L.shape[0]
        need, free = 2 * 8 * n * n, config.free_bytes(self.L.device)
        if need <= config.MEMORY_SHARE * free:
            return True
        self._declined = True
        if self._log is not None:
            self._log("the variance is served by the triangular solve: L^-1 "
                      "of %d rows needs %.3g GiB, more than %s of the %.3g "
                      "GiB free", n, need / 2 ** 30, config.MEMORY_SHARE,
                      free / 2 ** 30)
        return False

    def inverse(self):
        """The kept L^-1 that ``_predict_packed`` serves the variance
        from: built at the first request with stds (span
        ``predict.inverse``, counter ``factor_inv.build``), so a model
        never asked for stds never pays its O(n^3); None while it does
        not fit (``_inverse_fits``)."""
        if self.Linv is None and self._inverse_fits():
            with utils_profiling.span("predict.inverse"):
                self.Linv = linalg.tri_inverse(self.L)
            utils_profiling.count("factor_inv.build")
        return self.Linv
