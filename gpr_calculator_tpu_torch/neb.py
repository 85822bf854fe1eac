"""The on-the-fly NEB workload (parity with gpr_calc/NEB.py), serial path.

Port of the JAX package's ``neb.py``: ``neb_calc`` with per-image
calculator copies, only image 1 updating the GP (NEB.py:40-47), endpoint
energies pinned to the stored training energies (NEB.py:64-74) and the
optional base-calculator re-evaluation of the converged path;
``get_images`` and ``reaction_coordinate``.  Not ported yet: the batched
band (``batched=True``, ROADMAP.md port queue item 5), trajectory files
(item 3) and the plots (item 9).
"""
from __future__ import annotations

from copy import copy
from typing import Optional

import numpy as np

from .mep import NEB, find_mic
from .optimize import BFGS, FIRE


def _endpoint_energy(gp, image, idx):
    """Full physical energy of an endpoint image from the GP's stored
    training label (NEB.py:64-74 pins endpoints to training energies).

    train_y["energy"] is per-atom AND base-subtracted (add_structure,
    models/gp.py) -- the band's interior energies include the base
    offset, so it must be re-added here or the tangent/barrier math
    mixes two energy zeros.  Falls back to a surrogate prediction when
    the label index doesn't exist (a model trained on a different
    chain)."""
    n_at = len(image)
    try:
        e = float(gp.train_y["energy"][idx]) * n_at
    except (KeyError, IndexError, TypeError):
        return float(gp.predict_structure(image)[0])
    if getattr(gp, "base_potential", None) is not None:
        e_off, _, _ = gp.compute_base_potential(image)
        e += float(e_off)
    return e


def neb_calc(images, calculator=None, algo: str = "BFGS",
             fmax: float = 0.05, steps: int = 100, k: float = 0.1,
             climb: bool = False, traj: Optional[str] = None,
             use_ref: bool = False, batched: bool = False):
    """Run an NEB relaxation; returns the NEB object (and reference
    energies when use_ref), with ``converged`` and ``nsteps`` set."""
    if batched:
        raise NotImplementedError(
            "the batched NEB is not ported yet (ROADMAP.md, port queue "
            "item 5); use batched=False")
    neb = NEB(images, k=k, climb=climb)
    if calculator is not None:
        for i, image in enumerate(images):
            image.calc = copy(calculator)
            if getattr(calculator, "name", "") == "gpr":
                image.calc.update_gpr = (i == 1)

    if algo == "BFGS":
        opt = BFGS(neb, trajectory=traj, append_trajectory=True)
    elif algo == "FIRE":
        opt = FIRE(neb, trajectory=traj)
    else:
        raise ValueError("Invalid algorithm for NEB calculation")
    neb.converged = opt.run(fmax=fmax, steps=steps)
    neb.nsteps = opt.nsteps + 1

    for i, image in enumerate(images):
        if getattr(image.calc, "name", "") == "gpr":
            if i in (0, len(images) - 1):
                gp = image.calc.parameters.ff
                neb.energies[i] = _endpoint_energy(gp, image, i)
            else:
                image.calc.freeze()
                neb.energies[i] = image.get_potential_energy()
                image.calc.unfreeze()
        else:
            neb.energies[i] = image.get_potential_energy()

    if use_ref:
        ref_engs = []
        for i, image in enumerate(images):
            if i in (0, len(images) - 1):
                ref_engs.append(neb.energies[i])
            else:
                image.calc.results = {}
                image.calc.force_base = True
                ref_engs.append(image.get_potential_energy())
                image.calc.force_base = False
        return neb, ref_engs
    return neb


def get_images(init, final, num_images: int = 5, vaccum: float = 0.0,
               traj: Optional[str] = None, IDPP: bool = False,
               mic: bool = False, apply_constraint: bool = False):
    """Build the initial image chain (NEB.py:92-138) from two Atoms."""
    if traj is not None or isinstance(init, str) or isinstance(final, str):
        raise NotImplementedError(
            "reading structures from files is not ported yet (ROADMAP.md, "
            "port queue item 3); pass Atoms")
    initial, final = init.copy(), final.copy()

    if initial.pbc[-1] and vaccum > 0:
        for atoms in (initial, final):
            atoms.cell[2, 2] += vaccum
            atoms.center()
            atoms.pbc = np.array([True, True, True])

    images = [initial] + [initial.copy() for _ in range(num_images - 2)] \
        + [final]
    neb = NEB(images)
    neb.interpolate(method="idpp" if IDPP else "linear", mic=mic,
                    apply_constraint=apply_constraint)
    return images


def reaction_coordinate(images) -> np.ndarray:
    """Cumulative arc length along an image chain, using minimum-image
    displacements between consecutive images."""
    cell = images[0].get_cell()
    pbc = images[0].pbc
    s = np.empty(len(images))
    s[0] = 0.0
    for k in range(1, len(images)):
        d, _ = find_mic(images[k].positions - images[k - 1].positions,
                        cell, pbc)
        s[k] = s[k - 1] + float(np.linalg.norm(d))
    return s
