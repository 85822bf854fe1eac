"""Kernel hyperparameter containers (API parity with gpr_calc/kernels/
RBF_mb.py:7-60 and Dot_mb.py:5-43; the math lives in ops/kernels.py).

Only the RBF covariance is ported; ``Dot`` is kept as a container so that
saved models load, and fitting or serving with it raises."""
from __future__ import annotations


class RBF:
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


class Dot:
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
