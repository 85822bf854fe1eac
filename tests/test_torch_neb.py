"""The on-the-fly NEB end to end in both packages on the CPU, float64:
GP.set_GPR on the five Au/Al(100) images, then neb_calc with a GPR
calculator at its defaults (opt_freq=1: every refit optimises the
hyperparameters).  The port must reproduce the JAX package's run --
convergence, steps, base/surrogate/fit counts, training-set size, theta
(1e-6 relative) and the band energies (1e-5 eV) -- and the numbers that
run gives, with the operands' envs in their packed order on these small
sides (the default) and with every side sorted by element; the Dot
kernel's run likewise.  Also the NEB pieces alone (find_mic, interpolation,
optimizers, reaction coordinate) against the JAX package."""
import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu import mep as jax_mep
from gpr_calculator_tpu import neb as jax_neb
from gpr_calculator_tpu import optimize as jax_opt
from gpr_calculator_tpu_torch import mep, neb as port_neb, optimize
from gpr_calculator_tpu_torch.ops import kff

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)


NOISE_E, NOISE_F = 0.05 / 13, 0.05
# the JAX package's run (CPU, float64)
THETA = (0.9000824419630231, 1.291296129835527)
NSTEPS, BARRIER = 19, 0.3555160
COUNTS = (8, 51, 4, 13, 40)   # use_base, use_surrogate, fits, N_E, N_F
# the same with kernel="Dot"
DOT_THETA = (0.5980691048753912, 1.6996223564233595)
DOT_NSTEPS, DOT_BARRIER = 24, 0.3560402
DOT_COUNTS = (10, 64, 5, 15, 40)


def _images(pkg):
    return [pkg.Atoms(numbers=a.numbers, positions=a.positions,
                      cell=a.cell.array, pbc=a.pbc,
                      constraints=[pkg.FixAtoms(indices=a.fixed_indices())])
            for a in T.au_on_al100_images()]


def run_neb(pkg, kernel="RBF"):
    images = _images(pkg)
    gp = pkg.GP.set_GPR(images, pkg.EMT(), kernel=kernel, noise_e=NOISE_E,
                        noise_f=NOISE_F, log_file=None)
    theta = list(gp.kernel.parameters())
    band = pkg.neb_calc(images, pkg.GPR(base=pkg.EMT(), ff=gp, save=False),
                        fmax=0.05, steps=150)
    counts = (gp.use_base, gp.use_surrogate, gp.fits, gp.N_energy,
              gp.N_forces)
    return dict(converged=bool(band.converged), nsteps=band.nsteps,
                counts=counts, theta=theta,
                energies=np.asarray(band.energies, float))


_JAX_RUNS = {}


def _jax_run(kernel):
    if kernel not in _JAX_RUNS:
        _JAX_RUNS[kernel] = run_neb(J, kernel)
    return _JAX_RUNS[kernel]


def test_onthefly_neb_matches_jax():
    ours, ref = run_neb(T), _jax_run("RBF")
    for run in (ours, ref):
        assert run["converged"] and run["nsteps"] == NSTEPS
        assert run["counts"] == COUNTS
        np.testing.assert_allclose(run["theta"], THETA, rtol=1e-6)
        e = run["energies"]
        assert abs(e.max() - e[0] - BARRIER) < 1e-6
    np.testing.assert_allclose(ours["energies"], ref["energies"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kernel,theta,nsteps,barrier,counts", [
    ("RBF", THETA, NSTEPS, BARRIER, COUNTS),
    ("Dot", DOT_THETA, DOT_NSTEPS, DOT_BARRIER, DOT_COUNTS)])
def test_onthefly_neb_with_sorted_operands(kernel, theta, nsteps, barrier,
                                           counts, monkeypatch):
    """Every side's envs sorted by element (SORT_MIN_ENVS = 0; these sides
    are below the default): the port's run is still the JAX package's."""
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    ours, ref = run_neb(T, kernel), _jax_run(kernel)
    for run in (ours, ref):
        assert run["converged"] and run["nsteps"] == nsteps
        assert run["counts"] == counts
        np.testing.assert_allclose(run["theta"], theta, rtol=1e-6)
        e = run["energies"]
        assert abs(e.max() - e[0] - barrier) < 1e-6
    np.testing.assert_allclose(ours["energies"], ref["energies"], rtol=0,
                               atol=1e-5)


def test_find_mic_matches_jax():
    rng = np.random.RandomState(1)
    d = rng.uniform(-9.0, 9.0, (20, 3))
    skewed = np.array([[5.0, 0.0, 0.0], [3.1, 4.6, 0.0], [0.4, 0.7, 6.0]])
    for cell, pbc in ((np.diag([5.0, 6.0, 7.0]), [True, True, False]),
                      (skewed, [True, True, True]),
                      (np.zeros((3, 3)), [False] * 3)):
        dm, n = mep.find_mic(d, cell, pbc)
        dj, nj = jax_mep.find_mic(d, cell, pbc)
        np.testing.assert_allclose(dm, dj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(n, nj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("idpp", [False, True])
def test_get_images_matches_jax(idpp):
    ends = T.au_on_al100_images()
    jends = _images(J)
    ours = port_neb.get_images(ends[0], ends[-1], num_images=5, IDPP=idpp,
                               mic=True)
    ref = jax_neb.get_images(jends[0], jends[-1], num_images=5, IDPP=idpp,
                             mic=True)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.positions, b.positions, rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(port_neb.reaction_coordinate(ours),
                               jax_neb.reaction_coordinate(ref), rtol=1e-12)


class _Well:
    """An anisotropic quartic well with the optimizer protocol."""

    def __init__(self):
        self.x = np.array([[1.0, -0.5, 0.3], [0.2, 0.8, -1.1]])
        self.k = np.array([[1.0, 3.0, 0.5], [2.0, 0.7, 1.5]])

    def get_positions(self):
        return self.x.copy()

    def set_positions(self, x):
        self.x = np.asarray(x, float).reshape(self.x.shape)

    def get_forces(self):
        return -(self.k * self.x + self.x ** 3)

    def get_potential_energy(self):
        return float((0.5 * self.k * self.x ** 2 + 0.25 * self.x ** 4).sum())


@pytest.mark.parametrize("name", ["BFGS", "FIRE"])
def test_optimizers_match_jax(name):
    runs = []
    for module in (optimize, jax_opt):
        well = _Well()
        opt = getattr(module, name)(well, verbose=False)
        converged = opt.run(fmax=1e-4, steps=200)
        runs.append((converged, opt.nsteps, well.x))
    assert runs[0][:2] == runs[1][:2] and runs[0][0]
    np.testing.assert_allclose(runs[0][2], runs[1][2], rtol=0, atol=1e-14)
