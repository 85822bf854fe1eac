"""The port's first slice end to end, in both packages on the CPU: train
the on-the-fly GP on three Au/Al(100) NEB images, refit, then serve the
five images and three perturbed copies through the GPR dispatcher, and
two more copies with the base call forced (the dispatcher then grows the
set and refits with opt=False; the JAX package may take its incremental
route there).  Every request must give the same E/F/sigma, 1e-7 relative
in float64 (sigma through the variance, as in test_torch_gp.py), and the
same base/surrogate/fit counts."""
import numpy as np

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)


# (sigma, l) of the JAX package's GP.set_GPR(images, EMT(),
# noise_e=0.05/13, noise_f=0.05) on au_on_al100_images(), CPU float64
SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527
NOISE_E, NOISE_F = 0.05 / 13, 0.05
RTOL = 1e-7


def requests(pkg):
    images = [pkg.Atoms(numbers=a.numbers, positions=a.positions,
                        cell=a.cell.array, pbc=a.pbc,
                        constraints=[pkg.FixAtoms(
                            indices=a.fixed_indices())])
              for a in T.au_on_al100_images()]
    rng = np.random.RandomState(0)

    def perturbed(k):
        a = images[k].copy()
        free = np.setdiff1d(np.arange(len(a)), a.fixed_indices())
        a.positions[free] += rng.normal(0.0, 0.05, (len(free), 3))
        return a

    gated = images + [perturbed(k) for k in (1, 2, 3)]
    forced = [perturbed(k) for k in (1, 3)]
    return images, [(a, False) for a in gated] + [(a, True) for a in forced]


def run_slice(pkg):
    images, reqs = requests(pkg)
    gp = pkg.GP(kernel=pkg.RBF(para=[SIGMA, L_SCALE], zeta=2),
                descriptor=pkg.SO3(nmax=3, lmax=4, rcut=5.0),
                noise_e=NOISE_E, noise_f=NOISE_F, log_file=None)
    for k in (0, 4, 2):
        a = images[k].copy()
        a.calc = pkg.EMT()
        e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
        a.calc = None
        gp.add_structure((a, e, f))
    gp.fit(opt=False, show=False)
    out = []
    for atoms, force_base in reqs:
        a = atoms.copy()
        a.calc = pkg.GPR(base=pkg.EMT(), ff=gp, save=False,
                         opt_freq=10 ** 6)
        a.calc.verbose = False
        a.calc.force_base = force_base
        E, F = a.get_potential_energy(), a.get_forces()
        out.append((E, F, a.calc.results["var_e"], a.calc.results["var_f"]))
    counts = (gp.use_base, gp.use_surrogate, gp.fits, gp.N_energy,
              gp.N_forces)
    return out, counts, gp.error


def test_slice_matches_jax():
    ours, counts, error = run_slice(T)
    ref, counts_ref, error_ref = run_slice(J)
    assert counts == counts_ref
    assert counts[0] == 2 and counts[2] == 2      # the refit happened
    for (E, F, sE, sF), (Ej, Fj, sEj, sFj) in zip(ours, ref):
        assert abs(E - Ej) <= RTOL * abs(Ej)
        np.testing.assert_allclose(F, Fj, rtol=0,
                                   atol=RTOL * np.abs(Fj).max())
        var, var_ref = np.r_[sE, np.ravel(sF)] ** 2, \
            np.r_[sEj, np.ravel(sFj)] ** 2
        np.testing.assert_allclose(var, var_ref, rtol=0,
                                   atol=RTOL * var_ref.max())
    for key, val in error_ref.items():
        assert abs(error[key] - val) <= 1e-6 * max(abs(val), 1e-3), key
