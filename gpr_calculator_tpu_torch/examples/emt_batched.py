"""The batched on-the-fly NEB for Au diffusion on Al(100) (a port of the
JAX package's ``examples/emt_batched.py``): every interior image served
by one batched prediction a step (``neb_calc(batched=True)``).  The
images are built in code (``au_on_al100_images``); the JAX example reads
them from trajectory files.

Usage (on the card; ``--device cpu`` for the CPU, in float64):
    python -m gpr_calculator_tpu_torch.examples.emt_batched
    python -m gpr_calculator_tpu_torch.examples.emt_batched --device cpu \\
        --steps 5
"""
import argparse

from gpr_calculator_tpu_torch import EMT, GP, GPR, au_on_al100_images, \
    neb_calc


def run(steps=100, log_file=None):
    """(barrier eV, the NEB, the GP) of the batched on-the-fly NEB."""
    images = au_on_al100_images(5)
    gp = GP.set_GPR(images, EMT(), noise_e=0.05 / len(images[0]),
                    noise_f=0.05, log_file=log_file)
    calc = GPR(base=EMT(), ff=gp, save=False)
    neb = neb_calc(images, calc, fmax=0.05, steps=steps, batched=True)
    barrier = max(neb.energies) - neb.energies[0]
    print(f"barrier: {barrier:.4f} eV,  base/surrogate calls: "
          f"{gp.use_base}/{gp.use_surrogate}")
    return float(barrier), neb, gp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100,
                    help="NEB optimizer steps at most")
    ap.add_argument("--device", type=str, default=None,
                    help="the GP's device (default: the card)")
    args = ap.parse_args()
    if args.device is not None:
        from gpr_calculator_tpu_torch import config
        config.set_device(args.device)
    run(steps=args.steps)


if __name__ == "__main__":
    main()
