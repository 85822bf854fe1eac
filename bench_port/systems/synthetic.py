"""Synthetic training sets at a stated scale: random descriptors, their
Jacobians and elements drawn as the JAX package's bench.py draws them
(the generator of chip_smoke.py's ``bench_data`` / ``bench_points``,
copied): x ~ U(0.2, 1), dx/dr ~ U(-1, 1), elements uniform over the
configuration's list, labels ~ N(0, label_std); float32 rounded, and the
reference given the same rounded values.  The draws are the seed's (NumPy's
RandomState of the seed, the labels of the seed + 100, both modulo 2**32):
seed 0 gives bench.py's own data.

A configuration may fix the draw with ``data.draw_seed`` (an integer): the
points and labels are then drawn as above from ``draw_seed`` in place of
the run's seed (0: bench.py's data), and the run's seed, through a stream
of its own (``rng(seed, 5)``), chooses only the order of the energy
points, the order of the force points (each with its descriptors,
Jacobians, elements and labels) and one sign for all the labels.  The NLL
and its gradient are invariant under a joint permutation of the points and
under y -> -y, so L-BFGS-B takes the same path from theta0 on every seed,
up to rounding: the same evaluations, the same theta*.  Without the key the
draw can change a fit's work (the Dot kernel's count of evaluations follows
it).  Nothing else moves: each point's envs keep their order (a block's
float32 sums stay as they are), elements are not swapped, and the labels
flip together (K_EF couples energies and forces, so only a joint flip
leaves y^T K^-1 y as it is).  Without the key that stream is not drawn
from, and the arrays are the seed's draw, bit for bit."""
from __future__ import annotations

import numpy as np
import torch

from . import Base, rng
from ..reference.gp import Data


class System(Base):
    def __init__(self, cfg, seed, device):
        super().__init__(cfg, device)
        dat = cfg["data"]
        m_e, m_f, envs, d = dat["m_e"], dat["m_f"], dat["envs"], dat["d"]
        els = dat["elements"]
        draw_seed = dat.get("draw_seed")
        base = int(seed if draw_seed is None else draw_seed)
        rs = np.random.RandomState(base % 2 ** 32)
        f32 = np.float32
        self.ex = rs.uniform(*dat["x_range"], (m_e, envs, d)).astype(f32)
        self.ee = rs.choice(els, (m_e, envs))
        self.fx = rs.uniform(*dat["x_range"], (m_f, envs, d)).astype(f32)
        self.fd = rs.uniform(*dat["dxdr_range"], (m_f, envs, d, 3)).astype(f32)
        self.fe = rs.choice(els, (m_f, envs))
        rl = np.random.RandomState((base + 100) % 2 ** 32)
        sd = dat["label_std"]
        self.ye = np.array([rl.normal(0.0, sd) for _ in range(m_e)])
        self.yf = np.stack([rl.normal(0.0, sd, 3) for _ in range(m_f)])
        if draw_seed is not None:
            order = rng(seed, 5)
            pe, pf = order.permutation(m_e), order.permutation(m_f)
            sign = order.choice((-1.0, 1.0))
            self.ex, self.ee = self.ex[pe], self.ee[pe]
            self.ye = sign * self.ye[pe]
            self.fx, self.fd, self.fe = self.fx[pf], self.fd[pf], self.fe[pf]
            self.yf = sign * self.yf[pf]

    def port_model(self, port, log_file):
        """The program's GP holding the training points, not fitted (the
        points as chip_smoke.py's ``bench_points`` hands them over)."""
        gp = self.new_gp(port, log_file)
        f64 = np.float64
        gp.set_train_pts({
            "energy": [(self.ex[i].astype(f64), float(self.ye[i]),
                        self.ee[i]) for i in range(len(self.ex))],
            "force": [(self.fx[i].astype(f64), self.fd[i].astype(f64),
                       self.yf[i], self.fe[i]) for i in range(len(self.fx))]})
        return gp

    def ref_data(self, prec="f64"):
        dev = self.device

        def t(a, dt=torch.float64):
            return torch.as_tensor(a, device=dev).to(dt)
        counts = torch.full((len(self.ex),), float(self.ex.shape[1]),
                            dtype=torch.float64, device=dev)
        return Data((t(self.ex), t(self.ee, torch.int64), counts),
                    (t(self.fx), t(self.fd), t(self.fe, torch.int64)),
                    np.r_[self.ye, self.yf.reshape(-1)], prec)

    def work_inputs(self):
        """What the work counts read: each side's env elements (all envs
        valid), the width and the kernel's family."""
        return {"e_ele": self.ee, "f_ele": self.fe, "d": self.ex.shape[2],
                "family": self.family}
