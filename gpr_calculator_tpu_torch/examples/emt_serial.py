"""Quick-start: the on-the-fly GPR NEB for Au diffusion on Al(100) (a
port of the JAX package's ``examples/emt_serial.py``).

The plain-EMT NEB, where every force call goes to EMT, beside the
on-the-fly NEB at two noise levels: the surrogate reproduces the EMT
barrier while calling the base calculator far less often.  The images
are built in code (``au_on_al100_images``); the JAX example reads them
from trajectory files.  It writes the paths' figure.

Usage (on the card; ``--device cpu`` for the CPU, in float64):
    python -m gpr_calculator_tpu_torch.examples.emt_serial
    python -m gpr_calculator_tpu_torch.examples.emt_serial --device cpu \\
        --steps 5 --figname /tmp/NEB-test.png
"""
import argparse

from gpr_calculator_tpu_torch import EMT, GP, GPR, au_on_al100_images, \
    neb_calc
from gpr_calculator_tpu_torch.neb import plot_path

NUM_IMAGES = 5
FMAX = 0.05


def run_plain(steps=100):
    """Every force call goes to EMT: the cost and accuracy yardstick."""
    images = au_on_al100_images(NUM_IMAGES)
    neb = neb_calc(images, EMT(), fmax=FMAX, steps=steps)
    n_calls = neb.nsteps * (len(images) - 2) + 2
    return neb, f"EMT ({n_calls})"


def run_surrogate(noise_level: float, steps=100, log_file=None):
    """The on-the-fly NEB at one noise level (eV in all / eV/A)."""
    images = au_on_al100_images(NUM_IMAGES)
    gp = GP.set_GPR(images, EMT(), noise_e=noise_level / len(images[0]),
                    noise_f=noise_level, log_file=log_file)
    neb = neb_calc(images, GPR(base=EMT(), ff=gp, save=False),
                   fmax=FMAX, climb=True, steps=steps)
    print(gp, "\n")
    return neb, f"GPR-{noise_level:.2f} ({gp.use_base}/{gp.use_surrogate})"


def run(steps=100, noise_levels=(0.05, 0.10), figname="NEB-test.png"):
    """The three NEBs, their figure, and per NEB (label, barrier eV,
    converged)."""
    curves = [run_plain(steps)]
    curves += [run_surrogate(level, steps) for level in noise_levels]
    plot_path([(neb.images, neb.energies, label) for neb, label in curves],
              figname=figname, fontsize=16, title="Au diffusion on Al(100)")
    out = []
    for neb, label in curves:
        barrier = max(neb.energies) - neb.energies[0]
        print(f"{label:>18}: barrier {barrier:.3f} eV, "
              f"converged={neb.converged}")
        out.append((label, float(barrier), bool(neb.converged)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100,
                    help="NEB optimizer steps at most")
    ap.add_argument("--figname", type=str, default="NEB-test.png")
    ap.add_argument("--device", type=str, default=None,
                    help="the GPs' device (default: the card)")
    args = ap.parse_args()
    if args.device is not None:
        from gpr_calculator_tpu_torch import config
        config.set_device(args.device)
    run(steps=args.steps, figname=args.figname)


if __name__ == "__main__":
    main()
