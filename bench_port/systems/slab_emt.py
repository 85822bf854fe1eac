"""A slab system labelled by EMT: the images of the configuration's NEB
and seeded perturbations of its interior images, their energies and the
forces on the free atoms of the first ``force_structures`` of them, all
from the reference's float64 EMT."""
from __future__ import annotations

import numpy as np

from . import Base, rng
from ..reference import emt, points, so3
from ..reference.gp import Data


class System(Base):
    def __init__(self, cfg, seed, device):
        super().__init__(cfg, device)
        geo, tr = self.geo, cfg["train"]
        gen = rng(seed, 1)
        self.positions = list(self.images)
        for k in range(tr["perturbed"]):
            p = self.images[tr["perturb_images"][
                k % len(tr["perturb_images"])]].copy()
            p[geo.free] += gen.normal(0.0, tr["displacement"],
                                      (len(geo.free), 3))
            self.positions.append(p)
        self.labels = [emt.energy_forces(p, geo.numbers, geo.cell, geo.pbc)
                       for p in self.positions]
        self.n_force = tr["force_structures"]

    def atoms(self, port, positions):
        geo = self.geo
        return port.Atoms(numbers=geo.numbers, positions=positions,
                          cell=geo.cell, pbc=geo.pbc,
                          constraints=[port.FixAtoms(indices=geo.fixed)])

    def port_model(self, port, log_file):
        """The program's GP holding the training set, not fitted: the
        training descriptors from the program's own ingest
        (``convert_train_data``), the force points those of the free atoms
        of the first ``force_structures`` structures."""
        gp = self.new_gp(port, log_file)
        strucs = [self.atoms(port, p) for p in self.positions]
        td = gp.convert_train_data([(s, e, f) for s, (e, f)
                                    in zip(strucs, self.labels)])
        nat = len(self.geo.numbers)
        free = set(int(i) for i in self.geo.free)
        forces = [pt for k, pt in enumerate(td["force"])
                  if k // nat < self.n_force and k % nat in free]
        gp.set_train_pts({"energy": td["energy"], "force": forces})
        return gp

    def ref_data(self, prec="f64"):
        """The training set for the reference, its descriptors its own."""
        geo = self.geo
        nmax, lmax, rcut, alpha = self.desc
        descs = [so3.descriptor(p, geo.numbers, geo.cell, geo.pbc, nmax,
                                lmax, rcut, alpha, device=self.device)
                 for p in self.positions]
        z = [geo.numbers] * len(descs)
        nat = len(geo.numbers)
        y = np.r_[[e / nat for e, _ in self.labels],
                  np.concatenate([f[geo.free].reshape(-1)
                                  for _, f in self.labels[:self.n_force]])]
        return Data(points.energy_arrays(descs, z),
                    points.force_arrays(descs[:self.n_force],
                                        z[:self.n_force],
                                        [geo.free] * self.n_force),
                    y, prec)
