"""The batched on-the-fly NEB (``neb_calc(batched=True)``) of the port,
run live in both packages on the CPU in float64, and against the port's
serial NEB.  These tests sit in their own file, apart from the other
batched paths (test_torch_batched.py), so that ``--dist loadfile`` can
give them a worker of their own."""
import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)
from test_torch_neb import NOISE_E, NOISE_F, _images


# the JAX package's batched on-the-fly NEB (CPU float64): set_GPR, then
# neb_calc(..., fmax=0.05, steps=150, batched=True); counts are
# use_base, use_surrogate, fits, N_E, N_F
BATCHED = {"RBF": (18, 0.3569161, (9, 45, 4, 14, 38)),
           "Dot": (24, 0.3539455, (9, 63, 5, 14, 36))}


def run_batched_neb(pkg, kernel, batched=True, use_ref=False):
    images = _images(pkg)
    gp = pkg.GP.set_GPR(images, pkg.EMT(), kernel=kernel, noise_e=NOISE_E,
                        noise_f=NOISE_F, log_file=None)
    calc = pkg.GPR(base=pkg.EMT(), ff=gp, save=False)
    calc.verbose = False
    out = pkg.neb_calc(images, calc, fmax=0.05, steps=150, batched=batched,
                       use_ref=use_ref)
    band, ref = out if use_ref else (out, None)
    counts = (gp.use_base, gp.use_surrogate, gp.fits, gp.N_energy,
              gp.N_forces)
    return dict(converged=bool(band.converged), nsteps=band.nsteps,
                counts=counts, energies=np.asarray(band.energies, float),
                ref=ref, images=images)


@pytest.mark.parametrize("kernel", ["RBF", "Dot"])
def test_batched_neb_matches_jax(kernel):
    """The batched on-the-fly NEB in both packages, run live: converged,
    steps, base/surrogate/fit counts, training-set size and barrier as
    the JAX package's run gives them (1e-6 eV), the band energies of the
    two packages within 1e-5 eV."""
    nsteps, barrier, counts = BATCHED[kernel]
    ours, ref = run_batched_neb(T, kernel), run_batched_neb(J, kernel)
    for run in (ours, ref):
        assert run["converged"] and run["nsteps"] == nsteps
        assert run["counts"] == counts
        e = run["energies"]
        assert abs(e.max() - e[0] - barrier) < 1e-6
    np.testing.assert_allclose(ours["energies"], ref["energies"], rtol=0,
                               atol=1e-5)


def test_batched_and_serial_neb_agree_in_the_port():
    """The port's batched and serial bands end within 0.03 eV of each
    other in barrier (the JAX package's limit, tests/test_batched.py),
    and use_ref gives the base calculator's energies of the batched
    band's interior images, its endpoints the band's."""
    batched = run_batched_neb(T, "RBF", use_ref=True)
    serial = run_batched_neb(T, "RBF", batched=False)
    assert batched["converged"] and serial["converged"]
    bar = [r["energies"].max() - r["energies"][0] for r in (batched,
                                                            serial)]
    assert abs(bar[0] - bar[1]) < 0.03, bar
    ref, e = batched["ref"], batched["energies"]
    assert len(ref) == 5 and ref[0] == e[0] and ref[-1] == e[-1]
    for image, r in zip(batched["images"][1:-1], ref[1:-1]):
        a = image.copy()
        a.calc = T.EMT()
        assert r == pytest.approx(a.get_potential_energy(), abs=1e-10)
