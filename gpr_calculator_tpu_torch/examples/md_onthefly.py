"""The on-the-fly Langevin MD/EOS workload (a port of the JAX package's
``examples/md_onthefly.py``).

Langevin MD with the hybrid GPR dispatcher, swept over lattice scales
(the EOS axis): each new volume puts the surrogate out of distribution,
so the model keeps growing along the run.  ``opt_freq`` routes only
every k-th refit through hyperparameter re-optimisation (a full
refactorisation); the rest take the incremental rank-k refit
(``GP.fit(opt=False)``, ``ops/linalg.chol_append``).  The run reports
base/surrogate/fit counts, the kernel-row count reached, and the
full-vs-incremental refit split with per-path ms (``GP.refit_stats``).

The model stops growing within a few volumes, so at the default sweep
``--target-structures`` is never reached: a run is one sweep of the
seven volumes.

Usage (on the card; ``--device cpu`` for the CPU, in float64):
    python -m gpr_calculator_tpu_torch.examples.md_onthefly
    python -m gpr_calculator_tpu_torch.examples.md_onthefly --device cpu \\
        --steps 40 --max-volumes 3
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from gpr_calculator_tpu_torch import EMT, GP, GPR, utils_profiling
from gpr_calculator_tpu_torch.atoms import Atoms
from gpr_calculator_tpu_torch.md import Langevin, maxwell_boltzmann_velocities


def fcc_cell(natoms: int, a: float = 3.62, z: int = 29) -> Atoms:
    """Periodic fcc fragment (Cu by default) with natoms sites."""
    n_cells = int(np.ceil((natoms / 4) ** (1 / 3)))
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                      [0, 0.5, 0.5]])
    pos = []
    for i in range(n_cells):
        for j in range(n_cells):
            for k in range(n_cells):
                pos.extend((basis + [i, j, k]) * a)
    pos = np.asarray(pos)[:natoms]
    cell = np.eye(3) * n_cells * a
    return Atoms(numbers=[z] * natoms, positions=pos, cell=cell,
                 pbc=[True] * 3)


def run(steps_per_volume=400, natoms=8, temp_K=800.0, noise_e=2e-3,
        noise_f=0.1, freq=10, opt_freq=10, target_structures=500,
        scales=(1.0, 0.97, 1.03, 0.95, 1.05, 0.99, 1.01),
        max_volumes=None, log_file=None, seed=11, verbose=False,
        device=None, dtype=None):
    """One MD/EOS run; returns (record, the GP).  log_file: the GP's log
    (default ``md_onthefly_gp.log`` in the temporary directory); device,
    dtype: the GP's (default the card, float32; "cpu": float64)."""
    if log_file is None:
        log_file = os.path.join(tempfile.gettempdir(), "md_onthefly_gp.log")
    base = EMT()
    a0 = fcc_cell(natoms)
    rng = np.random.RandomState(seed)
    seeds = []
    for k in range(2):
        s = a0.copy()
        s.positions = s.positions + 0.08 * rng.randn(natoms, 3)
        seeds.append(s)
    # refit_stats sums the refits' ms while the span recorder is on
    was_on = utils_profiling.enabled()
    utils_profiling.enable()
    try:
        gp = GP.set_GPR(seeds, base, noise_e=noise_e, noise_f=noise_f,
                        nmax=2, lmax=2, rcut=4.5, log_file=log_file,
                        device=device, dtype=dtype)
        calc = GPR(base=base, ff=gp, save=False, freq=freq, opt_freq=opt_freq)
        calc.verbose = verbose

        t0 = time.time()
        volumes, md_steps = 0, 0
        cycle = 0
        scales = list(scales)
        while gp.N_energy < target_structures:
            if max_volumes is not None and volumes >= max_volumes:
                break
            scale = scales[volumes % len(scales)] ** (1.0 + 0.25 * cycle)
            atoms = a0.copy()
            atoms.set_cell(np.asarray(a0.cell) * scale)
            atoms.set_positions(a0.positions * scale)
            atoms.positions = atoms.positions + 0.05 * rng.randn(natoms, 3)
            atoms.calc = calc
            maxwell_boltzmann_velocities(atoms, temp_K, rng=rng)
            md = Langevin(atoms, timestep_fs=2.0, temperature_K=temp_K,
                          friction=0.05, rng=rng)
            md.run(steps_per_volume)
            md_steps += md.nsteps
            volumes += 1
            if volumes % len(scales) == 0:
                cycle += 1
            print(f"# volume {volumes} (scale {scale:.4f}): "
                  f"N_energy={gp.N_energy} N_forces={gp.N_forces} "
                  f"rows={gp.N_energy + 3 * gp.N_forces} "
                  f"base={gp.use_base} surrogate={gp.use_surrogate} "
                  f"fits={gp.fits}", file=sys.stderr, flush=True)
        wall = time.time() - t0

        rs = dict(gp.refit_stats)
    finally:
        if not was_on:
            utils_profiling.disable()
    rec = {
        "workload": (f"on-the-fly Langevin MD/EOS, fcc Cu {natoms} atoms,"
                     f" {temp_K:.0f} K, volume sweep"),
        "md_steps": md_steps,
        "volumes": volumes,
        "structures": int(gp.N_energy),
        "force_points": int(gp.N_forces),
        "kernel_rows": int(gp.N_energy + 3 * gp.N_forces),
        "base_calls": int(gp.use_base),
        "surrogate_calls": int(gp.use_surrogate),
        "gpr_fits": int(gp.fits),
        "opt_freq": opt_freq,
        "refit_full": rs["full"],
        "refit_incremental": rs["incremental"],
        "refit_full_ms_avg": round(rs["full_ms"] / max(rs["full"], 1), 1),
        "refit_incremental_ms_avg": round(
            rs["incremental_ms"] / max(rs["incremental"], 1), 1),
        "wall_s": round(wall, 1),
    }
    return rec, gp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400,
                    help="MD steps per volume")
    ap.add_argument("--natoms", type=int, default=8)
    ap.add_argument("--temp", type=float, default=800.0)
    ap.add_argument("--target-structures", type=int, default=500)
    ap.add_argument("--max-volumes", type=int, default=None)
    ap.add_argument("--freq", type=int, default=10)
    ap.add_argument("--opt-freq", type=int, default=10)
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="the GP's device (default: the card)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    if args.device is not None:
        from gpr_calculator_tpu_torch import config
        config.set_device(args.device)
    rec, _ = run(steps_per_volume=args.steps, natoms=args.natoms,
                 temp_K=args.temp, freq=args.freq, opt_freq=args.opt_freq,
                 target_structures=args.target_structures,
                 max_volumes=args.max_volumes, verbose=args.verbose)
    line = json.dumps(rec)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as fp:
            fp.write(line + "\n")


if __name__ == "__main__":
    main()
