"""Kernel hyperparameter containers and the reference's kernel-layer
block API (parity with gpr_calc/kernels/RBF_mb.py and Dot_mb.py, and with
the JAX package's ``models/kernels.py``); the math lives in
``ops/kernels.py``."""
from __future__ import annotations

import numpy as np

from ..ops import kernels as K_ops
from ..ops.packing import pack_energy, pack_force


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class _BlockAPI:
    """``k_total`` / ``k_total_with_grad`` / ``diag`` (RBF_mb.py:62-204,
    Dot_mb.py:45-148), served by the packed block functions of
    ``ops/kernels.py`` -- the CUDA kernels K1-K3 of the kernel's family on
    the card, their plain versions on the CPU.

    ``data`` is the point-list layout the GP stores: ``{"energy": [(x,
    ele), ...], "force": [(x, dxdr, ele), ...]}`` with x (Ni, d) and dxdr
    (Ni, d, 3), or (Ni, d, 9) with the strain rows appended (as
    ``GP.predict_structure(stress=True)`` builds them).  Rows/cols are
    ordered [energies..., 3 (9) rows per force point...] like the
    reference's build_covariance (kernels/base.py:3-30).  The points are
    packed on the working device and dtype (``config``); the results are
    NumPy arrays."""

    def _pack(self, data):
        energy_pts = [(np.asarray(p[0], float), np.asarray(p[-1], int))
                      for p in data.get("energy", [])]
        force_pts = [(np.asarray(p[0], float), np.asarray(p[1], float),
                      np.asarray(p[-1], int))
                     for p in data.get("force", [])]
        if energy_pts:
            d = energy_pts[0][0].shape[1]
        elif force_pts:
            d = force_pts[0][0].shape[1]
        else:
            raise ValueError("empty data: need energy or force points")
        return (pack_energy(energy_pts, d=d), pack_force(force_pts, d=d),
                len(energy_pts), len(force_pts))

    @staticmethod
    def _real_rows(e, f, n_e, n_f):
        # pack_* emits one dummy padded point for an empty side; keep the
        # real rows (absent blocks drop out, like build_covariance's None
        # branches)
        return np.r_[np.arange(n_e), e.m + np.arange(f.ncart * n_f)]

    def k_total(self, data1, data2=None, f_tol=1e-10, tol=None):
        """Block covariance [[K_EE, K_EF], [K_FE, K_FF]] (RBF_mb.py:135-171,
        Dot_mb.py:87-119); data2=None gives the symmetric self
        covariance."""
        e1, f1, n_e1, n_f1 = self._pack(data1)
        r = self._real_rows(e1, f1, n_e1, n_f1)
        if data2 is None:
            K = K_ops.k_self(e1, f1, self.params(), self.zeta, self.kind)
            return _numpy(K)[np.ix_(r, r)]
        e2, f2, n_e2, n_f2 = self._pack(data2)
        K = K_ops.k_block(e1, f1, e2, f2, self.params(), self.zeta,
                          self.kind)
        return _numpy(K)[np.ix_(r, self._real_rows(e2, f2, n_e2, n_f2))]

    def k_total_with_grad(self, data1, f_tol=1e-10):
        """(C, dC), dC = dstack(dC/dsigma, dC/d(second parameter))
        (RBF_mb.py:173-204, second parameter l; Dot_mb.py:121-148,
        sigma0).  dK/dsigma = 2 K / sigma; RBF's dK/dl rides the fused
        (K, dK/dgamma) pass with dgamma/dl = -1/l^3; Dot's dK/dsigma0 is
        2 s2 s0 ``count_ee`` on the energy block."""
        e1, f1, n_e1, n_f1 = self._pack(data1)
        params = self.params()
        if self.kind == "rbf":
            K, dK_dgamma = K_ops.k_self_dual(e1, f1, params, self.zeta)
            K = _numpy(K)
            C2 = _numpy(dK_dgamma) * (-1.0 / self.l ** 3)
        else:
            K = _numpy(K_ops.k_self(e1, f1, params, self.zeta, self.kind))
            C2 = np.zeros_like(K)
            C2[:e1.m, :e1.m] = (2.0 * self.sigma ** 2 * self.sigma0
                                * _numpy(K_ops.count_ee(e1)))
        C_s = (2.0 / self.sigma) * K
        ix = np.ix_(*[self._real_rows(e1, f1, n_e1, n_f1)] * 2)
        return K[ix], np.dstack((C_s[ix], C2[ix]))

    def k_total_with_stress(self, data1, data2, tol=1e-10):
        """(C, C_stress) for serving with strain rows (RBF_mb.py:206-229):
        data1's force points carry 9 cartesian columns (dxdr with the
        strain rows appended, as ``GP.predict_structure(stress=True)``
        builds them); one served block (``k_block``: K2 and K3 a launch
        per group of three columns) gives all 9 rows a point, and C_stress
        takes rows 3..8 of each.  The raw kernel rows' sign, as the
        reference's; ``GP.predict_structure`` negates them."""
        e1, f1, n_e1, n_f1 = self._pack(data1)
        if n_f1 and f1.ncart != 9:
            raise ValueError(
                "stress build needs 9-column force points (dxdr with "
                "appended rdxdr stress terms, cf. GP.predict_structure)")
        e2, f2, n_e2, n_f2 = self._pack(data2)
        full = _numpy(K_ops.k_block(e1, f1, e2, f2, self.params(),
                                    self.zeta, self.kind))
        full = full[:, self._real_rows(e2, f2, n_e2, n_f2)]
        ncols = full.shape[1]
        f_blocks = full[e1.m:e1.m + 9 * n_f1].reshape(n_f1, 9, ncols)
        C = np.concatenate(
            [full[:n_e1], f_blocks[:, :3].reshape(3 * n_f1, ncols)], axis=0)
        return C, f_blocks[:, 3:].reshape(6 * n_f1, ncols)

    def diag(self, data):
        """Self-variance diagonal: one entry per energy point, then 3 (or
        9) per force point (RBF_mb.py:62-133)."""
        e, f, n_e, n_f = self._pack(data)
        params = self.params()
        out = []
        if n_e:
            out.append(_numpy(K_ops.diag_energy(e, params, self.zeta,
                                                self.kind))[:n_e])
        if n_f:
            out.append(_numpy(K_ops.diag_force(f, params, self.zeta,
                                               self.kind))[:n_f].reshape(-1))
        return np.concatenate(out)


class RBF(_BlockAPI):
    r"""k(x1, x2) = sigma^2 exp(-(1 - (x1^.x2^)^zeta) / (2 l^2))."""

    name = "RBF"
    kind = "rbf"

    def __init__(self, para=(1.0, 1.0), bounds=((1e-2, 5e1), (1e-1, 1e1)),
                 zeta=2):
        self.bounds = [list(b) for b in bounds]
        self.update(list(para))
        self.zeta = int(zeta)

    def __str__(self):
        return "{:.5f}**2 *RBF({:.5f})".format(self.sigma, self.l)

    def update(self, para):
        self.sigma, self.l = float(para[0]), float(para[1])

    def parameters(self):
        return [self.sigma, self.l]

    def params(self):
        return {"sigma": self.sigma, "l": self.l}

    def save_dict(self):
        return {"name": self.name, "sigma": self.sigma, "l": self.l,
                "zeta": self.zeta, "bounds": self.bounds}

    def load_from_dict(self, d):
        self.sigma, self.l = float(d["sigma"]), float(d["l"])
        self.zeta = int(d["zeta"])
        self.bounds = d["bounds"]


class Dot(_BlockAPI):
    r"""k(x1, x2) = sigma^2 (sigma0^2 + (x1^.x2^)^zeta)."""

    name = "Dot"
    kind = "dot"

    def __init__(self, para=(1.0, 1.0), bounds=((1e-2, 5e1), (1e-2, 1e1)),
                 zeta=3):
        self.bounds = [list(b) for b in bounds]
        self.update(list(para))
        self.zeta = int(zeta)

    def __str__(self):
        return "{:.3f}**2 *Dot({:.3f})".format(self.sigma, self.sigma0)

    def update(self, para):
        self.sigma, self.sigma0 = float(para[0]), float(para[1])

    def parameters(self):
        return [self.sigma, self.sigma0]

    def params(self):
        return {"sigma": self.sigma, "sigma0": self.sigma0}

    def save_dict(self):
        return {"name": self.name, "sigma": self.sigma,
                "sigma0": self.sigma0, "zeta": self.zeta,
                "bounds": self.bounds}

    def load_from_dict(self, d):
        self.sigma, self.sigma0 = float(d["sigma"]), float(d["sigma0"])
        self.zeta = int(d["zeta"])
        self.bounds = d["bounds"]


def kernel_from_dict(d):
    name = d.get("name", "RBF")
    if name in ("RBF", "RBF_mb"):
        k = RBF()
    elif name in ("Dot", "Dot_mb"):
        k = Dot()
    else:
        raise NotImplementedError(f"unknown kernel {name}")
    k.load_from_dict(d)
    return k
