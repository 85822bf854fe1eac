r"""SO(3) power-spectrum descriptor in PyTorch -- port of the JAX
package's ``ops/so3.py`` (reference: gpr_calc/SO3.py).

  p_{n1 n2 l}(i) = Re sum_m c_{n1 l m}(i) conj(c_{n2 l m}(i)),  n1 >= n2

  c_{nlm}(i) = 4 pi sum_{j in N(i)} w_j f_cut(r_ij) Y_lm(r_ij^)
               * e^{-alpha r^2} Integral_0^rcut q^2 g_n(q) e^{-alpha q^2}
                 i_l(2 alpha r q) dq

The radial integral is Gauss-Chebyshev quadrature of the scaled Bessel
integrand (ops/bessel.py); Y_lm are real (re, im) pairs (ops/sph.py).
Everything after the host-built neighbour list runs on the tensors'
device: on a card in the two launches of the descriptor kernels
(csrc/so3.cu, built into ops/kff.py's library), fed by ``kernel_inputs``
in one int64 and one float upload; on the CPU in ``_so3_core``, the
plain version the card tests hold the kernels to.  Outputs follow the
reference dict contract:
  {'x': (natoms, ncoef), 'dxdr': (nseq, ncoef, 3), 'rdxdr': (nseq,
   ncoef, 3, 3) or None, 'elements': [str], 'seq': (nseq, 2)}
with dxdr[s] = dP(centre i_s)/dr_{j_s} and the (i, i) rows carrying
-sum_{j != i} dP_i/dr_j.  With ``stress=True`` the strain rows rdxdr[s,
c, n, m] = -(sum of R_n dP_c/dr_m over the pairs of row s) / volume, R
the absolute position of the pair's neighbour (the self rows: minus that
of the centre), the reference's convention (SO3.py:298-306).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import config, utils_profiling
from ..atoms.atoms import CHEMICAL_SYMBOLS
from . import kff
from .bessel import scaled_in
from .sph import ylm_all_ri, ylm_gradients_ri


def W_matrix(nmax: int) -> np.ndarray:
    """Symmetric orthonormalisation of the (rcut - r)^(a+2) radial basis
    (S^{-1/2} of the overlap matrix, SO3.py:417-430)."""
    S = np.zeros((nmax, nmax))
    for a in range(1, nmax + 1):
        ta = (2 * a + 5) * (2 * a + 6) * (2 * a + 7)
        for b in range(1, a + 1):
            tb = (2 * b + 5) * (2 * b + 6) * (2 * b + 7)
            S[a - 1, b - 1] = math.sqrt(ta * tb) / (
                (5 + a + b) * (6 + a + b) * (7 + a + b))
            S[b - 1, a - 1] = S[a - 1, b - 1]
    sinv = np.linalg.inv(S)
    eigvals, V = np.linalg.eig(sinv)
    return (V @ np.diag(np.sqrt(eigvals)) @ np.linalg.inv(V)).real


def gauss_chebyshev(nmax: int, lmax: int):
    """Chebyshev nodes and the uniform weight pi/N (SO3.py:446-453)."""
    N = (nmax + lmax + 1) * 10
    i = np.arange(1, N + 1)
    return np.cos((2 * i - 1) * np.pi / (2 * N)), np.pi / N


def radial_quadrature(nmax: int, lmax: int, rcut: float, alpha: float):
    """Quadrature nodes q, and G0[n, j] = w_j q^2 g_n(q) sqrt(1-x^2)
    without the e^{-alpha q^2} factor (folded into the pair Gaussian)."""
    gc, w = gauss_chebyshev(nmax, lmax)
    w = w * rcut / 2.0
    q = rcut / 2.0 * (gc + 1.0)
    Wm = W_matrix(nmax)
    phis = np.stack([
        (rcut - q) ** (a + 2)
        / math.sqrt(2 * rcut ** (2 * a + 7)
                    / ((2 * a + 5) * (2 * a + 6) * (2 * a + 7)))
        for a in range(1, nmax + 1)
    ])
    g = Wm @ phis
    G0 = g * (q ** 2) * np.sqrt(1.0 - gc ** 2) * w
    return q, G0


def cosine_cutoff(r, rcut, derivative=False):
    if derivative:
        return -0.5 * math.pi / rcut * torch.sin(math.pi * r / rcut)
    return 0.5 * (torch.cos(math.pi * r / rcut) + 1.0)


CUTOFFS = {"cosine": cosine_cutoff}

# the batched ingest's pairs per core call: the JAX package's flat budget
# on the CPU; on a card config.MEMORY_SHARE of the free memory over the
# measured float64 bytes per pair (SO3.bytes_per_pair, from a probe of
# PROBE_PAIRS pairs).  nmax 3, lmax 4, on the descriptor kernels: 2 000
# bytes a pair measured, 4 344 with strain rows (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md), as the shapes give them: the pair record's 150
# doubles and a dxdr row of 90 a pair (3 x 90 more with strain rows); half
# of that card's free memory holds ~21 million pairs, the ingest of 100
# 65-atom slabs 0.008 of them.
CPU_PAIR_BUDGET = 262144
PROBE_PAIRS = 4096


# launches of the descriptor kernels (csrc/so3.cu) since the last
# reset_launches(): so3_pair_kernel (one a call with pairs) and
# so3_centre_kernel (one a call)
launches = {"so3_pair": 0, "so3_centre": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _segment_sum(vals, seg, nseg):
    """out[s] = the sum of vals[k] over seg[k] == s, each segment added in
    the order of k on every device: ``index_put_(accumulate=True)`` sorts
    the indices on a card (stably), where ``index_add_`` adds by atomics
    in no fixed order, so that one structure's descriptors would differ
    from run to run."""
    out = torch.zeros((nseg,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_put_((seg,), vals, accumulate=True)


def _so3_core(rij, weights, pair_center, pair_seq, self_seq, self_ids,
              seq_center, q, G0, pair_Ri=None, pair_Rj=None, *, nmax: int,
              lmax: int, natoms: int, nseq: int, rcut: float, alpha: float,
              derivative: bool, cutoff: str, stress: bool = False):
    """Pair c/dc -> per-centre power spectrum and its gradients.

    rij (P, 3), weights (P,), pair_center (P,), pair_seq (P,) with nseq
    for pairs outside the selection, self_seq/self_ids the (i, i) seq
    rows and their atom ids, seq_center (nseq,), q (NQ,), G0 (nmax, NQ);
    with stress, pair_Ri/pair_Rj (P, 3) the absolute positions of each
    pair's centre and neighbour.  Returns (x (natoms, ncoef), dxdr (nseq,
    ncoef, 3) or None, pstress (nseq, ncoef, 3, 3) or None): pstress
    before the caller's -1/volume (the JAX package's ops/so3.py:254-265)."""
    P = rij.shape[0]
    ncoef = nmax * (nmax + 1) // 2 * (lmax + 1)
    cut_fn = CUTOFFS[cutoff]
    tri = np.tril_indices(nmax)

    r = torch.sqrt(torch.sum(rij * rij, dim=1))
    u = rij / r[:, None]

    # scaled radial integrand: E[p, j] = exp(-alpha (r - q_j)^2)
    E = torch.exp(-alpha * (r[:, None] - q[None, :]) ** 2)
    z = 2.0 * alpha * r[:, None] * q[None, :]
    b, db = scaled_in(lmax, z)                       # (P, NQ, lmax+1)
    I = torch.einsum("nj,pjl->pnl", G0, E[:, :, None] * b)

    larange = torch.arange(lmax + 1, dtype=rij.dtype, device=rij.device)
    norm_l = torch.sqrt(2.0 * math.sqrt(2.0) * math.pi
                        / torch.sqrt(2.0 * larange + 1.0))
    fourpi = 4.0 * math.pi
    fcut = cut_fn(r, rcut)
    ones = torch.ones_like(r)

    if not derivative:
        Yre, Yim = ylm_all_ri(lmax, u, ones)
        pref = ((fourpi * (weights * fcut))[:, None, None, None]
                * I[:, :, :, None] * norm_l[None, None, :, None])
        ctot_re = _segment_sum(pref * Yre[:, None], pair_center,
                               natoms + 1)[:natoms]
        ctot_im = _segment_sum(pref * Yim[:, None], pair_center,
                               natoms + 1)[:natoms]
        Pfull = (torch.einsum("anlm,aklm->ankl", ctot_re, ctot_re)
                 + torch.einsum("anlm,aklm->ankl", ctot_im, ctot_im))
        return Pfull[:, tri[0], tri[1], :].reshape(natoms, ncoef), None, None

    # Y to lmax+1 for the gradient recurrence
    Yext = ylm_all_ri(lmax + 1, u, ones)
    mid = lmax + 1
    Yre = Yext[0][:, :lmax + 1, mid - lmax: mid + lmax + 1]
    Yim = Yext[1][:, :lmax + 1, mid - lmax: mid + lmax + 1]
    dYre, dYim = ylm_gradients_ri(lmax, Yext, r)

    # dI~/dr [p, n, l] = sum_j G0 E (2 alpha q db - 2 alpha r b)
    dEb = E[:, :, None] * (2.0 * alpha * q[None, :, None] * db
                           - 2.0 * alpha * r[:, None, None] * b)
    dIdr = torch.einsum("nj,pjl->pnl", G0, dEb)

    pref = fourpi * weights
    dfcut = cut_fn(r, rcut, derivative=True)
    dfu = (dfcut[:, None] * u)[:, None, None, None, :]

    def c_dc(Ypart, dYpart):
        # c0 = 4pi w Y I~ ;  dc0 = 4pi w (dY I~ + Y u dI~/dr)
        c0 = pref[:, None, None, None] * I[:, :, :, None] * Ypart[:, None]
        dc0 = (pref[:, None, None, None, None]
               * (dYpart[:, None] * I[:, :, :, None, None]
                  + Ypart[:, None, :, :, None] * u[:, None, None, None, :]
                  * dIdr[:, :, :, None, None]))
        dc = dc0 * fcut[:, None, None, None, None] + c0[..., None] * dfu
        c = c0 * fcut[:, None, None, None] * norm_l[None, None, :, None]
        dc = dc * norm_l[None, None, :, None, None]
        return c, dc

    c_re, dc_re = c_dc(Yre, dYre)
    c_im, dc_im = c_dc(Yim, dYim)
    ctot_re = _segment_sum(c_re, pair_center, natoms + 1)[:natoms]
    ctot_im = _segment_sum(c_im, pair_center, natoms + 1)[:natoms]

    Pfull = (torch.einsum("anlm,aklm->ankl", ctot_re, ctot_re)
             + torch.einsum("anlm,aklm->ankl", ctot_im, ctot_im))
    x = Pfull[:, tri[0], tri[1], :].reshape(natoms, ncoef)

    # dP[p, n, k, l, d] = Re[A] + swap_nk(Re[A]),
    # Re[A] = dc_re . ctot_re + dc_im . ctot_im  (at the pair's centre)
    A_re = (torch.einsum("pnlmd,pklm->pnkld", dc_re, ctot_re[pair_center])
            + torch.einsum("pnlmd,pklm->pnkld", dc_im,
                           ctot_im[pair_center]))
    dP = A_re + A_re.transpose(1, 2)
    dP_tri = dP[:, tri[0], tri[1], :, :].reshape(P, ncoef, 3)

    # seq accumulation + translation-invariance self rows (SO3.py:261-273)
    dxdr = _segment_sum(dP_tri, pair_seq, nseq + 1)[:nseq]
    center_tot = _segment_sum(dxdr, seq_center, natoms + 1)[:natoms]
    dxdr = dxdr.index_put((self_seq,), -center_tot[self_ids],
                          accumulate=True)
    if not stress:
        return x, dxdr, None
    # pstress[(i, j)] = -sum_w Rj (x) dP_w; the self rows [(i, i)] add
    # sum over the centre's pairs of Ri (x) dP, stored (ncoef, 3 = R,
    # 3 = gradient) as the reference's 'wn,wijkm->wijknm' (SO3.py:298-303)
    pstress = -_segment_sum(torch.einsum("pn,pcm->pcnm", pair_Rj, dP_tri),
                            pair_seq, nseq + 1)[:nseq]
    rdPi = _segment_sum(torch.einsum("pn,pcm->pcnm", pair_Ri, dP_tri),
                        pair_center, natoms + 1)[:natoms]
    return x, dxdr, pstress.index_put((self_seq,), rdPi[self_ids],
                                      accumulate=True)


def kernel_inputs(preps, q, G0, stress: bool):
    """The descriptor kernels' inputs for one ``_core`` call over the
    prepared structures ``preps``: (ints, flts, fields, ao, ro).  ``fields``
    maps each input to its (offset, length) in ``ints`` (int64) or ``flts``
    (float64):
      perm  the pairs sorted stably by centre atom: each centre's pairs in
            ascending pair order, the order in which ``_segment_sum`` adds
            them;
      poff  (natoms + 1) each centre's pairs perm[poff[a]:poff[a + 1]];
      prow  each pair's output row, -1 for a pair whose centre lies outside
            an ``atom_ids`` selection (the plain version's spare row);
      rows  four arrays of natoms: each centre's first and end output row
            (its seq rows are contiguous), its self row and the zero pad row
            its block writes (that of its structure for the structure's
            first atom), -1 for none;
      rij, w, with ``stress`` Ri and Rj (P, 3) and each atom's -1 / volume
            (``scale``), then the quadrature's q and G0.
    ao: atom offsets of the structures; ro: their output row offsets --
    structure k's seq rows from ro[k], its zero pad row at ro[k + 1] - 1,
    ``calculate_device``'s layout."""
    ao = np.cumsum([0] + [p["natoms"] for p in preps])
    so = np.cumsum([0] + [p["nseq"] for p in preps])
    ro = so + np.arange(len(so))
    natoms = int(ao[-1])
    centre = np.concatenate([p["pair_center"] + ao[k]
                             for k, p in enumerate(preps)]).astype(np.int64)
    prow = np.concatenate([np.where(p["pair_seq"] < 0, -1,
                                    p["pair_seq"] + ro[k])
                           for k, p in enumerate(preps)])
    seq_centre = np.concatenate([p["seq"][:, 0] + ao[k]
                                 for k, p in enumerate(preps)])
    if np.any(np.diff(seq_centre) < 0):
        raise ValueError("the seq rows must be sorted by centre atom")
    atoms = np.arange(natoms)
    struc = np.repeat(np.arange(len(preps)), np.diff(ao))
    self_row = np.full(natoms, -1, np.int64)
    self_row[np.concatenate([p["self_ids"] + ao[k]
                             for k, p in enumerate(preps)])] = \
        np.concatenate([p["self_seq"] + ro[k] for k, p in enumerate(preps)])
    pad_row = np.full(natoms, -1, np.int64)
    pad_row[ao[:-1]] = ro[1:] - 1
    ints = {"perm": np.argsort(centre, kind="stable"),
            "poff": np.r_[0, np.cumsum(np.bincount(centre,
                                                   minlength=natoms))],
            "prow": prow,
            "rows": np.concatenate([
                np.searchsorted(seq_centre, atoms) + struc,
                np.searchsorted(seq_centre, atoms, side="right") + struc,
                self_row, pad_row])}
    flts = {"rij": np.concatenate([p["rij"] for p in preps]).ravel(),
            "w": np.concatenate([p["w"] for p in preps])}
    if stress:
        flts.update(
            Ri=np.concatenate([p["Ri"] for p in preps]).ravel(),
            Rj=np.concatenate([p["Rj"] for p in preps]).ravel(),
            scale=np.repeat([-1.0 / p["volume"] for p in preps],
                            np.diff(ao)))
    flts.update(q=np.asarray(q, float), G0=np.asarray(G0, float).ravel())
    fields = {}
    for parts in (ints, flts):
        off = 0
        for name, a in parts.items():
            fields[name] = (off, len(a))
            off += len(a)
    return (np.concatenate(list(ints.values())).astype(np.int64),
            np.concatenate(list(flts.values())).astype(np.float64),
            fields, ao, ro)


def _upload(a, dtype, dev):
    """``a`` as ``dtype`` in one pinned host buffer, copied to ``dev``
    without waiting (the caching host allocator keeps the buffer until the
    copy is done)."""
    buf = torch.empty(len(a), dtype=dtype, pin_memory=True)
    buf.numpy()[:] = a
    return buf.to(dev, non_blocking=True)


def _with_pad_rows(t, so):
    """(nseq, ...) rows of the structures with seq offsets ``so`` -> each
    structure's rows followed by a zero row, ``kernel_inputs``' output
    layout."""
    if t is None:
        return None
    ns = len(so) - 1
    at = np.arange(int(so[-1])) + np.repeat(np.arange(ns), np.diff(so))
    out = t.new_zeros((t.shape[0] + ns,) + t.shape[1:])
    out[torch.as_tensor(at, device=t.device)] = t
    return out


class SO3:
    """Drop-in equivalent of gpr_calc.SO3.SO3 (constructor contract
    SO3.py:23-34, validation SO3.py:67-174).  stress=True adds the strain
    rows ``rdxdr`` to every dict (it needs derivative=True)."""

    def __init__(self, nmax: int = 3, lmax: int = 3, rcut: float = 3.5,
                 alpha: float = 2.0, derivative: bool = True,
                 stress: bool = False, cutoff_function: str = "cosine",
                 weight_on: bool = False):
        if not isinstance(nmax, int) or not (1 <= nmax <= 11):
            raise ValueError("nmax must be an integer in [1, 11]")
        if not isinstance(lmax, int) or not (0 <= lmax <= 32):
            raise ValueError("lmax must be an integer in [0, 32]")
        if rcut <= 0:
            raise ValueError("rcut must be positive")
        if alpha <= 0:
            raise ValueError("alpha must be positive")
        if cutoff_function not in CUTOFFS:
            raise NotImplementedError(
                f"cutoff function {cutoff_function!r} not implemented")
        if stress and not derivative:
            raise ValueError(
                "stress=True requires derivative=True (the rdxdr strain "
                "terms are built from the gradient chain)")
        self.nmax = nmax
        self.lmax = lmax
        self.rcut = float(rcut)
        self.alpha = float(alpha)
        self.derivative = derivative
        self.stress = stress
        self.cutoff_function = cutoff_function
        self.weight_on = weight_on
        self._type = "SO3"
        # quadrature constants stay float64 and are cast per call
        self._q, self._G0 = radial_quadrature(nmax, lmax, self.rcut,
                                              self.alpha)
        self._pair_bytes = {}       # card -> bytes_per_pair

    def save_dict(self):
        return {"nmax": self.nmax, "lmax": self.lmax, "rcut": self.rcut,
                "alpha": self.alpha, "derivative": self.derivative,
                "stress": self.stress, "_type": "SO3"}

    @classmethod
    def from_dict(cls, d):
        return cls(nmax=d["nmax"], lmax=d["lmax"], rcut=d["rcut"],
                   alpha=d["alpha"], derivative=d.get("derivative", True),
                   stress=d.get("stress", False))

    def load_from_dict(self, d):
        """Re-initialise from ``save_dict``'s dict (SO3.py:59-65)."""
        self.__init__(nmax=d["nmax"], lmax=d["lmax"], rcut=d["rcut"],
                      alpha=d["alpha"], derivative=d.get("derivative", True),
                      stress=d.get("stress", False))

    def clear_memory(self):
        """API parity with SO3.clear_memory (SO3.py:176-184): the
        reference frees per-structure arrays it caches on the instance;
        here no per-structure state lives on it (the measured bytes per
        pair and the quadrature constants are per descriptor), so there
        is nothing to free."""
        return

    @property
    def ncoef(self) -> int:
        return self.nmax * (self.nmax + 1) // 2 * (self.lmax + 1)

    def __str__(self):
        return (f"SO3 descriptor with Cutoff: {self.rcut:6.3f} "
                f"lmax: {self.lmax:d}, nmax: {self.nmax:d}, "
                f"alpha: {self.alpha:.3f}\n")

    def calculate(self, atoms, atom_ids=None, device=None, dtype=None):
        """Host (NumPy) descriptor dict, as gpr_calc.SO3.calculate."""
        out = self.calculate_device(atoms, atom_ids, device=device,
                                    dtype=dtype)
        nseq = out["nseq"]
        return {
            "x": out["x"].cpu().numpy(),
            "dxdr": None if out["dxdr"] is None
            else out["dxdr"][:nseq].cpu().numpy(),
            "rdxdr": None if out["rdxdr"] is None
            else out["rdxdr"][:nseq].cpu().numpy(),
            "elements": out["elements"],
            "seq": out["seq"],
        }

    def _prep_structure(self, atoms, atom_ids=None):
        """Host-side neighbour list and seq rows for one structure."""
        from ..atoms.neighborlist import neighbor_pairs

        numbers = np.asarray(atoms.numbers, int)
        natoms = len(numbers)
        if atom_ids is None:
            atom_ids = list(range(natoms))

        pi, pj, rij = neighbor_pairs(atoms, self.rcut)

        # atomic weights: neighbour Z, negated for unlike species when
        # weight_on (SO3.py:381-385)
        w = numbers[pj].astype(float)
        if self.weight_on:
            w = np.where(numbers[pj] != numbers[pi], -w, w)

        # seq rows: the unique (centre i, neighbour-or-self j) pairs in
        # (i, j) lexicographic order (SO3.py:389-404)
        ids_arr = np.asarray(atom_ids, np.int64)
        if len(ids_arr) > 1 and np.any(np.diff(ids_arr) <= 0):
            raise ValueError("atom_ids must be strictly ascending")
        stride = natoms + 1
        key_pairs = pi.astype(np.int64) * stride + pj
        key_self = ids_arr * stride + ids_arr
        if len(ids_arr) == natoms:
            in_sel = None
            keys = np.concatenate([key_pairs, key_self])
        else:
            in_sel = np.isin(pi, ids_arr)
            keys = np.concatenate([key_pairs[in_sel], key_self])
        uniq = np.unique(keys)
        seq = np.stack([uniq // stride, uniq % stride], axis=1)
        pair_seq = np.searchsorted(uniq, key_pairs)
        if in_sel is not None:
            pair_seq = np.where(in_sel, pair_seq, -1)
        self_seq = np.searchsorted(uniq, key_self)
        elements = list(getattr(atoms, "symbols", [])) or [
            CHEMICAL_SYMBOLS[int(zz)] for zz in numbers]
        prep = {"rij": rij, "w": w, "pair_center": pi, "pair_seq": pair_seq,
                "self_seq": self_seq, "self_ids": ids_arr, "seq": seq,
                "nseq": len(seq), "natoms": natoms, "elements": elements}
        if self.stress:
            Ri = np.asarray(atoms.positions, float)[pi]
            prep.update(Ri=Ri, Rj=Ri + rij, volume=atoms.get_volume())
        return prep

    def _core(self, preps, dev, dt):
        """The descriptors of the prepared structures ``preps`` in one
        call over their concatenated pairs, with per-structure atom and
        seq-row offsets: on a card the descriptor kernels
        (``_core_kernels``), elsewhere ``_so3_core``.  Returns (x
        (natoms_tot, ncoef), dxdr (rows, ncoef, 3) or None, rdxdr (rows,
        ncoef, 3, 3) or None -- each structure's strain rows scaled by -1 /
        its volume --, atom offsets ao, row offsets ro): structure k's
        rows are [ro[k], ro[k + 1]), the last of them a zero pad row."""
        if dev.type == "cuda":
            return self._core_kernels(preps, dev, dt)
        return self._core_plain(preps, dev, dt)

    def _core_plain(self, preps, dev, dt):
        """``_core`` by ``_so3_core`` on any device: the CPU path, and the
        yardstick of the kernels on a card."""
        ao = np.cumsum([0] + [p["natoms"] for p in preps])
        so = np.cumsum([0] + [p["nseq"] for p in preps])
        natoms, nseq = int(ao[-1]), int(so[-1])
        # pairs outside an atom_ids selection (-1) go to the spare row nseq
        pair_seq = np.concatenate([
            np.where(p["pair_seq"] < 0, nseq, p["pair_seq"] + so[k])
            for k, p in enumerate(preps)])

        def cat(key, offsets=None):
            parts = [p[key] if offsets is None else p[key] + offsets[k]
                     for k, p in enumerate(preps)]
            return np.concatenate(parts)

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        def flt(a):
            return torch.as_tensor(a, dtype=dt, device=dev)

        stress = self.stress
        x, dxdr, pstress = _so3_core(
            flt(cat("rij")), flt(cat("w")),
            idx(cat("pair_center", ao)), idx(pair_seq),
            idx(cat("self_seq", so)), idx(cat("self_ids", ao)),
            idx(np.concatenate([p["seq"][:, 0] + ao[k]
                                for k, p in enumerate(preps)])),
            flt(self._q), flt(self._G0),
            flt(cat("Ri")) if stress else None,
            flt(cat("Rj")) if stress else None,
            nmax=self.nmax, lmax=self.lmax, natoms=natoms, nseq=nseq,
            rcut=self.rcut, alpha=self.alpha, derivative=self.derivative,
            cutoff=self.cutoff_function, stress=stress)
        if pstress is not None:
            # -1 / volume of each structure on its own seq rows
            scale = np.repeat([-1.0 / p["volume"] for p in preps],
                              [p["nseq"] for p in preps])
            pstress = pstress * flt(scale)[:, None, None, None]
        return (x, _with_pad_rows(dxdr, so), _with_pad_rows(pstress, so),
                ao, so + np.arange(len(so)))

    def _core_kernels(self, preps, dev, dt):
        """``_core`` on a card: the two launches of csrc/so3.cu
        (so3_pair_kernel, so3_centre_kernel) on ``kernel_inputs``, each
        of its two buffers copied up once, the outputs written straight
        into ``_core``'s layout.  float32 and float64; anything else
        raises, as does a failed launch."""
        if dt not in (torch.float32, torch.float64):
            raise TypeError(f"the descriptor kernels take float32 or "
                            f"float64, got {dt}")
        ints, flts, fields, ao, ro = kernel_inputs(
            preps, self._q, self._G0, self.stress)
        ints, flts = _upload(ints, torch.int64, dev), _upload(flts, dt, dev)
        P, natoms, nrows = fields["prow"][1], int(ao[-1]), int(ro[-1])
        deriv, stress, ncoef = self.derivative, self.stress, self.ncoef
        L1 = self.lmax + 1
        NL, LM = self.nmax * L1, L1 * (L1 + 1) // 2
        rlen = 2 * NL + 8 * LM if deriv else NL + 2 * LM

        def new(*shape):
            return torch.empty(shape, dtype=dt, device=dev)

        def ptr(t):
            return None if t is None else t.data_ptr()

        def field(buf, name):
            if name not in fields:
                return None
            return buf.data_ptr() + fields[name][0] * buf.element_size()

        x = new(natoms, ncoef)
        dxdr = new(nrows, ncoef, 3) if deriv else None
        rdxdr = new(nrows, ncoef, 3, 3) if stress else None
        rec = new(P * rlen)
        rdpi = new(natoms * ncoef * 9) if stress else None
        name = "so3_core_f64" if dt == torch.float64 else "so3_core_f32"
        fn = kff.entry_point(name, dev)
        with torch.cuda.device(dev):
            rc = fn(*(field(ints, k) for k in ("perm", "poff", "prow",
                                               "rows")),
                    *(field(flts, k) for k in ("rij", "w", "Ri", "Rj",
                                               "scale", "q", "G0")),
                    ptr(rec), ptr(rdpi), ptr(x), ptr(dxdr), ptr(rdxdr), P,
                    natoms, len(self._q), self.nmax, self.lmax, int(deriv),
                    int(stress), self.rcut, self.alpha,
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        launches["so3_pair"] += int(P > 0)
        launches["so3_centre"] += 1
        utils_profiling.count("descriptor.kernel")
        return x, dxdr, rdxdr, ao, ro

    def calculate_device(self, atoms, atom_ids=None, device=None,
                         dtype=None):
        """Descriptor tensors on ``device`` (default ``config.device()``):

          x      (natoms, ncoef)
          dxdr   (nseq + 1, ncoef, 3) -- row nseq is zero, a safe gather
                 target for padding
          rdxdr  (nseq + 1, ncoef, 3, 3) with the same zero row, or None
                 (stress=False)
          seq    (nseq, 2) host numpy; 'elements' list; 'nseq' int
        """
        dev = config.device() if device is None else torch.device(device)
        dt = config.dtype(dev) if dtype is None else dtype
        with utils_profiling.span("descriptor.prep"):
            prep = self._prep_structure(atoms, atom_ids)
        with utils_profiling.span("descriptor.core"):
            x, dxdr, rdxdr, _, _ = self._core([prep], dev, dt)
        return self._device_dict(prep, x, dxdr, rdxdr)

    def _device_dict(self, prep, x, dxdr, rdxdr):
        """calculate_device's dict of one structure, dxdr and rdxdr with
        their zero pad row (``_core``'s rows of the structure)."""
        return {"x": x, "dxdr": dxdr, "rdxdr": rdxdr,
                "elements": prep["elements"],
                "seq": prep["seq"] if self.derivative else None,
                "nseq": prep["nseq"]}

    def bytes_per_pair(self, device) -> float:
        """Peak device bytes per pair of one float64 ``_core`` call on the
        card (the descriptor kernels) with derivatives (and strain rows
        where the descriptor has them), measured once per descriptor and
        card: the
        call's ``torch.cuda.max_memory_allocated`` above what was
        allocated before it, over its pairs (this resets the card's peak
        memory statistics).  The probe has PROBE_PAIRS pairs around
        PROBE_PAIRS / 32 centres, about an fcc metal's pairs per atom at
        rcut 5 A, each pair a seq row of its own."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._pair_bytes:
            P, natoms = PROBE_PAIRS, PROBE_PAIRS // 32
            rng = np.random.RandomState(0)
            u = rng.normal(size=(P, 3))
            rij = u / np.linalg.norm(u, axis=1)[:, None] \
                * rng.uniform(1.0, self.rcut, (P, 1))
            # a centre's 32 pair rows, then its self row
            centre = np.repeat(np.arange(natoms), 32)
            slot = np.tile(np.arange(33), natoms)
            prep = {"rij": rij, "w": np.ones(P), "pair_center": centre,
                    "pair_seq": np.flatnonzero(slot < 32),
                    "self_seq": np.flatnonzero(slot == 32),
                    "self_ids": np.arange(natoms),
                    "seq": np.stack([np.repeat(np.arange(natoms), 33),
                                     slot], axis=1),
                    "nseq": P + natoms, "natoms": natoms,
                    "Ri": np.zeros((P, 3)), "Rj": rij, "volume": 1.0}
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = self._core([prep], dev, torch.float64)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - before
            del out
            self._pair_bytes[key] = peak / P
        return self._pair_bytes[key]

    def default_pair_budget(self, device) -> int:
        """Pairs per ``_core`` call of the batched ingest.  On the
        CPU the JAX package's flat 262 144.  On a card, the float64
        ``bytes_per_pair`` against ``config.MEMORY_SHARE`` of the free
        memory (``config.free_bytes``); the first call on a card runs the
        probe, which resets the card's peak memory statistics."""
        dev = torch.device(device)
        if dev.type != "cuda" or not self.derivative:
            return CPU_PAIR_BUDGET
        per_pair = self.bytes_per_pair(dev)
        return max(PROBE_PAIRS, int(config.MEMORY_SHARE
                                    * config.free_bytes(dev) / per_pair))

    def _groups(self, atoms_list, pair_budget, device, dtype):
        """Greedy grouping under the pair budget (at least one structure
        a group), one ``_core`` call a group: yields (indices, preps, x,
        dxdr, rdxdr, atom offsets, row offsets)."""
        dev = config.device() if device is None else torch.device(device)
        dt = config.dtype(dev) if dtype is None else dtype
        if pair_budget is None:
            pair_budget = self.default_pair_budget(dev)
        preps = []
        for atoms in atoms_list:
            with utils_profiling.span("descriptor.prep"):
                preps.append(self._prep_structure(atoms))
        groups, cur, cur_pairs = [], [], 0
        for i, p in enumerate(preps):
            npairs = len(p["pair_seq"])
            if cur and cur_pairs + npairs > pair_budget:
                groups.append(cur)
                cur, cur_pairs = [], 0
            cur.append(i)
            cur_pairs += npairs
        if cur:
            groups.append(cur)
        for grp in groups:
            ps = [preps[i] for i in grp]
            with utils_profiling.span("descriptor.core"):
                out = self._core(ps, dev, dt)
            yield (grp, ps) + out

    def calculate_many_device(self, atoms_list, dtype=None, pair_budget=None,
                              device=None):
        """``calculate_device`` of many structures, one ``_core`` call per
        group of structures under ``pair_budget`` pairs (default
        ``default_pair_budget``): a list of dicts in calculate_device's
        form, one per structure, each x and dxdr (with its zero pad row) a
        slice of its group's.  ``pair_budget=math.inf``
        makes one group of them all, without the probe."""
        out = [None] * len(atoms_list)
        for grp, ps, x, dxdr, rdxdr, ao, ro in self._groups(
                atoms_list, pair_budget, device, dtype):
            for k, (i, p) in enumerate(zip(grp, ps)):
                rows = slice(ro[k], ro[k + 1])
                out[i] = self._device_dict(
                    p, x[ao[k]:ao[k + 1]],
                    None if dxdr is None else dxdr[rows],
                    None if rdxdr is None else rdxdr[rows])
        return out

    def calculate_many(self, atoms_list, dtype=None, pair_budget=None,
                       device=None):
        """Batched descriptor ingest (the JAX package's
        ``SO3.calculate_many``): as ``calculate_many_device``, returned as
        host dicts in :meth:`calculate`'s form, copied once a group."""
        out = [None] * len(atoms_list)
        for grp, ps, x, dxdr, rdxdr, ao, ro in self._groups(
                atoms_list, pair_budget, device, dtype):
            x = x.cpu().numpy()
            dxdr, rdxdr = (None if t is None else t.cpu().numpy()
                           for t in (dxdr, rdxdr))
            for k, (i, p) in enumerate(zip(grp, ps)):
                rows = slice(ro[k], ro[k + 1] - 1)
                out[i] = {"x": x[ao[k]:ao[k + 1]],
                          "dxdr": None if dxdr is None else dxdr[rows],
                          "rdxdr": None if rdxdr is None else rdxdr[rows],
                          "elements": p["elements"],
                          "seq": p["seq"] if self.derivative else None}
        return out
