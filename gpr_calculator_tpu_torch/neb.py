"""The on-the-fly NEB workload (parity with gpr_calc/NEB.py).

Port of the JAX package's ``neb.py``: ``neb_calc`` with per-image
calculator copies, only image 1 updating the GP (NEB.py:40-47), endpoint
energies pinned to the stored training energies (NEB.py:64-74) and the
optional base-calculator re-evaluation of the converged path; the batched
band (``batched=True``: ``OnTheFlyBatchedNEB``, every interior image
served by one ``GP.predict_structures`` a step); ``get_images`` (from
Atoms, structure files or a trajectory's tail), ``reaction_coordinate``
and the figures ``plot_path`` and ``plot_progress`` (matplotlib, Agg).
"""
from __future__ import annotations

import os
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


class OnTheFlyBatchedNEB(NEB):
    """NEB whose interior images are evaluated by ONE batched GPR
    prediction per optimizer step (``GP.predict_structures``), with the
    reference's per-image dispatch semantics (calculator.py:63-104):
    uncertain images fall back to the base calculator, feed the training
    set, and trigger the refit cadence (``dispatch.DispatchPolicy``)."""

    def __init__(self, images, gp, base, k=0.1, climb=False, freq=10,
                 verbose=True, opt_freq=1, save=True, tag="GPR",
                 ignore_E_std=True):
        super().__init__(images, k=k, climb=climb)
        from .dispatch import DispatchPolicy
        self.gp = gp
        self.base = base
        self.policy = DispatchPolicy(gp, base, freq=freq,
                                     opt_freq=opt_freq, save=save, tag=tag,
                                     verbose=verbose,
                                     ignore_E_std=ignore_E_std)
        # pin endpoint energies to the stored training labels (the first
        # and last images are the first/last entries of train_images)
        self.energies[0] = _endpoint_energy(gp, images[0], 0)
        self.energies[-1] = _endpoint_energy(gp, images[-1],
                                             len(images) - 1)

    def _interior_results(self):
        interior = self.images[1:-1]
        preds = self.gp.predict_structures(interior, return_std=True)
        policy = self.policy
        energies, forces = [], []
        for image, (E, F, E_std, F_std) in zip(interior, preds):
            natoms = len(image)
            e_tol, f_tol = policy.tolerances(natoms)
            E_std_total = float(E_std) * natoms
            Fmax = float(np.abs(F).max())
            if policy.needs_base(natoms, F, E_std_total, F_std):
                eng, frc = policy.evaluate_base(image)
                policy.log_base(E_std_total, E, eng, float(F_std.max()),
                                Fmax, np.abs(frc).max())
                energies.append(eng)
                forces.append(frc)
            else:
                self.gp.use_surrogate += 1
                policy.log_surrogate(E_std_total, e_tol, E,
                                     float(F_std.max()), f_tol, Fmax)
                energies.append(E)
                forces.append(F)
        policy.refit_if_due()
        return energies, forces


def neb_calc(images, calculator=None, algo: str = "BFGS",
             fmax: float = 0.05, steps: int = 100, k: float = 0.1,
             climb: bool = False, traj: Optional[str] = None,
             use_ref: bool = False, batched: bool = False):
    """Run an NEB relaxation; returns the NEB object (and reference
    energies when use_ref), with ``converged`` and ``nsteps`` set.
    batched=True with a GPR calculator serves every interior image in one
    batched prediction per step (``OnTheFlyBatchedNEB``).  traj: the
    band of every step is appended to this ULM trajectory."""
    batched = batched and getattr(calculator, "name", "") == "gpr"
    if batched:
        neb = OnTheFlyBatchedNEB(
            images, gp=calculator.parameters.ff,
            base=calculator.parameters.base, k=k, climb=climb,
            freq=getattr(calculator, "freq", 10),
            verbose=getattr(calculator, "verbose", True),
            opt_freq=getattr(calculator, "opt_freq", 1),
            save=getattr(calculator, "save", True),
            tag=getattr(calculator, "tag", "GPR"),
            ignore_E_std=getattr(calculator, "ignore_E_std", True))
    else:
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
    # run() returns convergence; calling opt.converged() again would
    # re-evaluate the whole band (and, batched, possibly call the base
    # calculator and refit after the optimization ended)
    neb.converged = opt.run(fmax=fmax, steps=steps)
    neb.nsteps = opt.nsteps + 1

    if batched:
        if not use_ref:
            return neb
        ref_engs = list(neb.energies[:1])
        base = calculator.parameters.base
        for image in images[1:-1]:
            prev = getattr(image, "calc", None)
            image.calc = base
            ref_engs.append(image.get_potential_energy())
            image.calc = prev
        ref_engs.append(neb.energies[-1])
        return neb, ref_engs

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
    """Build the initial image chain (NEB.py:92-138) from two Atoms or
    structure files (``io.read``), or restart from the last
    ``num_images`` frames of an existing trajectory ``traj``."""
    from .io import read

    if traj is not None and os.path.exists(traj):
        return read(traj, index=":")[-num_images:]

    initial = read(init) if isinstance(init, str) else init.copy()
    final = read(final) if isinstance(final, str) else final.copy()

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


def plot_path(data, unit="eV", fontsize=15, figname="neb_path.png",
              title="NEB Path", max_yticks=8, x_scale=False):
    """Render energy vs reaction coordinate for one or more image chains
    (same deliverable as the reference's NEB-path figure: image markers
    plus a smooth endpoint-clamped guide curve per chain).

    data: iterable of (images, energies, label) triples.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.ticker import MaxNLocator
    from scipy.interpolate import CubicSpline

    fig, ax = plt.subplots(figsize=(8, 6))
    for images, energies, label in data:
        s = reaction_coordinate(images)
        if x_scale and s[-1] > 0:
            s = s / s[-1]
        markers = ax.plot(s, energies, marker="o", ls="none")[0]
        # endpoints are minima: clamp the guide curve to zero slope
        # there.  CubicSpline needs strictly increasing x: drop
        # duplicate-coordinate images (e.g. an unmoved frame in a
        # restart chain) from the guide curve only
        keep = np.r_[True, np.diff(s) > 1e-12]
        if keep.sum() >= 2:
            guide = CubicSpline(s[keep], np.asarray(energies)[keep],
                                bc_type="clamped")
            dense = np.linspace(s[0], s[-1], 120)
            ax.plot(dense, guide(dense), ls="--",
                    color=markers.get_color(), label=label)

    ax.margins(x=0.08)
    ax.yaxis.set_major_locator(MaxNLocator(max_yticks))
    ax.set_xlabel("Reaction Coordinates", fontsize=fontsize)
    ax.set_ylabel(f"Energy ({unit})", fontsize=fontsize)
    ax.set_title(title, fontsize=fontsize * 1.1)
    ax.legend(fontsize=fontsize, frameon=False, loc="upper right")
    fig.tight_layout()
    fig.savefig(figname, dpi=300)
    plt.close(fig)


def plot_progress(trajectory, calc, N_images, start=0, interval=50,
                  figname="neb-process.png"):
    """Overlay the NEB path at successive optimizer snapshots from a
    trajectory file (convergence-progress figure; endpoints pinned to the
    stored training energies like neb_calc does)."""
    from .io import read

    frames = read(trajectory, index=":")
    n_snap = len(frames) // N_images
    gp = calc.parameters.ff
    data = []
    for snap in range(start, n_snap, interval):
        print(f"Processing step {snap} of {n_snap}")
        chain = frames[snap * N_images:(snap + 1) * N_images]
        energies = np.empty(len(chain))
        energies[0] = _endpoint_energy(gp, chain[0], 0)
        energies[-1] = _endpoint_energy(gp, chain[-1], N_images - 1)
        for image in chain[1:-1]:
            image.calc = calc
        # frozen: rendering a figure must not dispatch to the base
        # calculator, grow the training set, or refit the live GP
        calc.freeze()
        try:
            energies[1:-1] = [im.get_potential_energy()
                              for im in chain[1:-1]]
        finally:
            calc.unfreeze()
        data.append((chain, energies, f"NEB_iter_{snap}"))
    plot_path(data, figname=figname)
