"""What a fit leaves behind, the state a GP serves from and appends to:
``GP`` holds one ``Posterior`` and replaces it whole at every fit, so
nothing built from an old factor outlives it -- its CUDA graphs of the
served chain (``ServedGraphs``) included."""
from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple

import numpy as np
import torch

from .. import config, utils_profiling
from ..ops import kernels as K_ops
from ..ops import kff
from ..ops import linalg

# the plain counters the served chain bumps as it launches: a graph's
# replay adds what its capture would have added
_COUNTS = (kff.launches, K_ops.operand_builds)


@contextlib.contextmanager
def _on_stream(side):
    """Run the block on the stream ``side``, after the work queued on the
    current stream and before what is queued there next."""
    current = torch.cuda.current_stream(side.device)
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        current.wait_stream(side)


class _Graphs(NamedTuple):
    """One key's static input tensors and, for each stage, its graph, its
    static outputs and the counts its capture added (``_COUNTS``)."""
    inputs: tuple
    stages: list

    def load(self, tensors):
        """Copy a request's tensors into the static inputs."""
        for dst, src in zip(self.inputs, tensors):
            dst.copy_(src)

    def replay(self, i: int):
        """Replay stage i on the current stream: its static outputs."""
        graph, out, counts = self.stages[i]
        graph.replay()
        for counter, added in zip(_COUNTS, counts):
            for k, n in added.items():
                counter[k] += n
        return out


class ServedGraphs:
    """The CUDA graphs a ``Posterior`` serves repeated request shapes
    from: for each key (``gp._graph_key``) one graph a stage of the
    served chain, captured on a side stream into one memory pool, both
    this object's, the CAP most recently used kept.  ``seen_before``
    remembers the keys of eager requests, so a key is captured at its
    second request."""
    CAP = 16

    def __init__(self):
        self._kept = collections.OrderedDict()
        self._seen = collections.OrderedDict()
        self._pool = self._stream = None

    def __len__(self) -> int:
        return len(self._kept)

    def get(self, key):
        """The key's graphs (now the most recently used), or None."""
        graphs = self._kept.get(key)
        if graphs is not None:
            self._kept.move_to_end(key)
        return graphs

    def seen_before(self, key) -> bool:
        """Whether an earlier request had ``key``; this one is noted (the
        4 CAP latest keys are remembered)."""
        seen = key in self._seen
        self._seen[key] = None
        self._seen.move_to_end(key)
        if len(self._seen) > 4 * self.CAP:
            self._seen.popitem(last=False)
        return seen

    def _keep(self, key, graphs) -> None:
        self._kept[key] = graphs
        self._kept.move_to_end(key)
        if len(self._kept) > self.CAP:
            self._kept.popitem(last=False)

    def capture(self, key, inputs, stages) -> None:
        """Capture ``stages`` on a side stream of the inputs' card once
        the key's eager requests have loaded every kernel and library
        handle they launch: stage 0 takes no argument, each later one the
        outputs of the one before, all reading the static tensors
        ``inputs``.  Counted as ``predict.graph_capture``; the counters'
        bumps during the capture are taken back and kept for the replays.
        cuBLAS's workspaces are dropped before and after (as PyTorch's own
        graph trees do), so the one the capture's GEMMs take is allocated
        in the graphs' pool, not kept beside the current stream's for the
        life of the process (32 MiB on an H100).  A graph's workspace and
        the other graphs' outputs may then share the pool's memory: every
        replay rewrites its outputs before they are read, and the caller's
        copies are taken at once."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(inputs[0].device)
        with _on_stream(self._stream):
            torch._C._cuda_clearCublasWorkspaces()
            try:
                self._capture(key, inputs, stages)
            finally:
                torch._C._cuda_clearCublasWorkspaces()
        utils_profiling.count("predict.graph_capture")

    def _capture(self, key, inputs, stages) -> None:
        out, done = (), []
        for stage in stages:
            before = [dict(c) for c in _COUNTS]
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                out = stage(*out)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
            added = []
            for counter, b in zip(_COUNTS, before):
                added.append({k: n - b.get(k, 0) for k, n in counter.items()
                              if n != b.get(k, 0)})
                counter.update(b)
            done.append((graph, out, added))
        self._keep(key, _Graphs(tuple(inputs), done))


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
    ``Linv``: L^-1 once ``inverse`` has built it; ``graphs``: the CUDA
    graphs ``_predict_packed`` replays (``ServedGraphs``).  log: a
    logger's ``info``, told when L^-1 does not fit."""

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
        self.graphs = ServedGraphs()

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
