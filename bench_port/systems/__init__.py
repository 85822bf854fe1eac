"""Configuration kinds: each module's ``System`` makes a configuration's
inputs from the seed and hands the same inputs to the program
(``port_model``) and to the reference (``ref_data``).  What the kinds
share is here: the served system (the configuration's ``system``: its
images and the fixed part of its structures), the kernel, noise,
precision and descriptor, and the program's GP before its training set.

The kernel's family is the configuration's ``kernel.name``, "RBF" or
"Dot" (the upstream's class names), RBF where it names none; everything
that builds or checks a covariance takes it from here (``family``)."""
import numpy as np
import torch

from ..reference import slab
from ..reference.kernels import FAMILIES

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def rng(seed: int, stream: int):
    """The generator of one input stream of a seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


class Geometry:
    """The served structures' fixed part: numbers, cell, pbc, fixed and
    free atom indices."""

    def __init__(self, numbers, cell, pbc, fixed):
        self.numbers, self.cell, self.pbc = numbers, cell, pbc
        self.fixed = np.asarray(fixed, int)
        self.free = np.setdiff1d(np.arange(len(numbers)), self.fixed)


class Base:
    def __init__(self, cfg, device):
        self.cfg, self.device = cfg, device
        served = cfg["system"]
        images, numbers, cell, pbc, fixed = slab.BUILDERS[served["builder"]](
            served["n_images"])
        self.images, self.geo = images, Geometry(numbers, cell, pbc, fixed)
        k = cfg["kernel"]
        self.family = k.get("name", "RBF")
        if self.family not in FAMILIES:
            raise ValueError(f"unknown kernel family {self.family!r}; "
                             f"one of {FAMILIES}")
        self.theta0, self.bounds, self.zeta = (
            list(k["theta0"]), [list(b) for b in k["bounds"]], k["zeta"])
        self.noise = (cfg["noise"]["noise_e"], cfg["noise"]["noise_f"])
        self.dtype = DTYPES[cfg["dtype"]]
        self.serve_opt = cfg["train"]["opt"]
        d = cfg["descriptor"]
        self.desc = (d["nmax"], d["lmax"], d["rcut"], d["alpha"])

    def descriptor(self, port):
        nmax, lmax, rcut, alpha = self.desc
        return port.SO3(nmax=nmax, lmax=lmax, rcut=rcut, alpha=alpha)

    def new_gp(self, port, log_file):
        """The program's GP of the family at theta0, with no training
        set."""
        kernel = {"RBF": port.RBF, "Dot": port.Dot}[self.family]
        return port.GP(kernel=kernel(para=self.theta0, bounds=self.bounds,
                                     zeta=self.zeta),
                       descriptor=self.descriptor(port),
                       noise_e=self.noise[0], noise_f=self.noise[1],
                       log_file=log_file, device=self.device,
                       dtype=self.dtype)

    def work_inputs(self):
        return None
