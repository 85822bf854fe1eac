"""The port's MD drivers (``md.py``) and its on-the-fly MD/EOS example
(``examples/md_onthefly.py``) against the JAX package's, on the CPU in
float64.  Each driver case of tests/test_md.py runs in both packages with
the same ``RandomState`` seeds, on EMT and on an LJ base; positions and
velocities agree at 1e-10.  The example runs once in each package (a
module-scoped fixture) at 3 volumes x 40 steps: the same counts, rows and
refit split, final positions within 1e-8 A, and the final models serving
the same E and F at 1e-10 and standard deviations at 1e-8 (sigma =
sqrt(prior - explained variance) loses digits to that cancellation: the
two packages' sigma_E differ by ~1.3e-10 of itself)."""
import importlib.util
import pathlib

import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu.md as JMD
import gpr_calculator_tpu_torch as T
import gpr_calculator_tpu_torch.md as TMD
from gpr_calculator_tpu.calculators import LennardJones as JLJ
from gpr_calculator_tpu_torch.calculators import LennardJones as LJ
from gpr_calculator_tpu_torch.examples import md_onthefly as T_EX
from gpr_calculator_tpu_torch.optimize import BFGS as TBFGS

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {T: TMD, J: JMD}
LJ_PARAMS = {"rc": 5.0, "sigma": 2.2, "epsilon": 0.1}
TOL = 1e-10


def _base(pkg, base):
    if base == "EMT":
        return pkg.EMT()
    return (LJ if pkg is T else JLJ)(dict(LJ_PARAMS))


def _cluster(pkg, natoms=6, seed=41):
    """tests/test_gp.py's make_structs(n=1, natoms, seed)[0]."""
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a],
                     [0, 0.5 * a, 0.5 * a], [a, a, 0], [a, 0, a]])[:natoms]
    return pkg.Atoms(numbers=[29] * natoms,
                     positions=grid + 0.12 * rng.randn(natoms, 3),
                     cell=np.eye(3) * 12, pbc=False)


def _nve(pkg, base):
    md_ = PKGS[pkg]
    atoms = _cluster(pkg, seed=41)
    atoms.calc = _base(pkg, base)
    md_.maxwell_boltzmann_velocities(atoms, 150.0)
    md = md_.VelocityVerlet(atoms, timestep_fs=1.0)
    e0 = atoms.get_potential_energy() + md.kinetic_energy()
    md.run(40)
    e1 = atoms.get_potential_energy() + md.kinetic_energy()
    assert abs(e1 - e0) < 0.05 * max(1.0, abs(e0)), (e0, e1)
    return atoms, md


def _langevin(pkg, base):
    md_ = PKGS[pkg]
    atoms = _cluster(pkg, seed=43)
    atoms.calc = _base(pkg, base)
    (TBFGS if pkg is T else J.BFGS)(atoms).run(fmax=0.1, steps=60)
    md = md_.Langevin(atoms, timestep_fs=2.0, temperature_K=300.0,
                      friction=0.5)
    md.run(200)
    assert 30 < md.temperature() < 1500
    return atoms, md


def _fixed(pkg, base):
    md_ = PKGS[pkg]
    atoms = _cluster(pkg, seed=49)
    atoms.set_constraint(pkg.FixAtoms(indices=[0, 2]))
    atoms.calc = _base(pkg, base)
    md_.maxwell_boltzmann_velocities(atoms, 300.0)
    frozen = atoms.positions[[0, 2]].copy()
    md = md_.Langevin(atoms, timestep_fs=2.0, temperature_K=300.0,
                      friction=0.05)
    md.run(25)
    np.testing.assert_array_equal(atoms.positions[[0, 2]], frozen)
    np.testing.assert_array_equal(md.velocities[[0, 2]], 0.0)
    atoms2 = _cluster(pkg, seed=49)
    atoms2.set_constraint(pkg.FixAtoms(indices=[1]))
    atoms2.calc = _base(pkg, base)
    md_.maxwell_boltzmann_velocities(atoms2, 200.0)
    frozen2 = atoms2.positions[[1]].copy()
    md2 = md_.VelocityVerlet(atoms2, timestep_fs=1.0).run(25)
    np.testing.assert_array_equal(atoms2.positions[[1]], frozen2)
    np.testing.assert_array_equal(md2.velocities[[1]], 0.0)
    return atoms2, md2


def _initial(pkg, base):
    md_ = PKGS[pkg]
    atoms = _cluster(pkg, seed=45)
    atoms.calc = _base(pkg, base)
    v0 = md_.maxwell_boltzmann_velocities(atoms, 300.0)
    assert np.abs(v0).max() > 0
    md = md_.VelocityVerlet(atoms, timestep_fs=1.0)
    np.testing.assert_array_equal(md.velocities, v0)
    assert md.kinetic_energy() > 0
    m = atoms.get_masses()[:, None]
    np.testing.assert_allclose((m * md.velocities).sum(axis=0), 0.0,
                               atol=1e-12)
    return atoms, md.run(10)


def _foreign(pkg, base):
    md_ = PKGS[pkg]

    class ForeignAtoms(pkg.Atoms):
        fixed_indices = property(doc="hidden")

    a = 2.55
    atoms = ForeignAtoms(numbers=[29] * 4,
                         positions=[[0, 0, 0], [a, 0, 0], [0, a, 0],
                                    [0.55 * a, 0.55 * a, 0.55 * a]],
                         cell=np.eye(3) * 12, pbc=False)
    assert not hasattr(atoms, "fixed_indices")
    atoms.calc = _base(pkg, base)
    md_.maxwell_boltzmann_velocities(atoms, 100.0,
                                     rng=np.random.RandomState(3))
    return atoms, md_.VelocityVerlet(atoms, timestep_fs=0.5).run(3)


CASES = {"velocity_verlet_conserves_energy": _nve,
         "langevin_thermalises": _langevin,
         "langevin_and_verlet_respect_fix_atoms": _fixed,
         "md_preserves_initial_velocities": _initial,
         "md_accepts_foreign_atoms_without_fixed_indices": _foreign}


@pytest.mark.parametrize("base", ["EMT", "LJ"])
@pytest.mark.parametrize("case", list(CASES))
def test_md_matches_jax(case, base):
    """Each driver case of tests/test_md.py in both packages (its own
    checks in each), the end positions and velocities equal at 1e-10."""
    (ta, tmd), (ja, jmd) = (CASES[case](pkg, base) for pkg in (T, J))
    assert tmd.nsteps == jmd.nsteps > 0
    np.testing.assert_allclose(ta.positions, ja.positions, rtol=0, atol=TOL)
    np.testing.assert_allclose(tmd.velocities, jmd.velocities, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("base", ["EMT", "LJ"])
def test_eos_sweep_matches_jax(base):
    vols, engs = [], []
    for pkg in (T, J):
        atoms = _cluster(pkg, seed=45)
        atoms.pbc = np.array([True] * 3)
        v, e = PKGS[pkg].equation_of_state(atoms, _base(pkg, base),
                                           scales=np.linspace(0.97, 1.03, 5))
        assert len(v) == 5 and np.all(np.isfinite(e))
        vols.append(v)
        engs.append(e)
    np.testing.assert_allclose(vols[0], vols[1], rtol=1e-14)
    np.testing.assert_allclose(engs[0], engs[1], rtol=0, atol=TOL)


# -- the on-the-fly MD/EOS example -------------------------------------------

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_md_onthefly", ROOT / "examples" / "md_onthefly.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(mod, tmp):
    """mod.run at 3 volumes x 40 steps, the example's defaults otherwise,
    with each volume's atoms kept (its Langevin class wrapped)."""
    kept = []

    class Kept(mod.Langevin):
        def run(self, steps):
            kept.append(self.atoms)
            return super().run(steps)

    orig, mod.Langevin = mod.Langevin, Kept
    try:
        rec, gp = mod.run(steps_per_volume=40, natoms=8, max_volumes=3,
                          log_file=str(tmp / f"{mod.__name__}.log"))
    finally:
        mod.Langevin = orig
    return rec, gp, kept


@pytest.fixture(scope="module")
def examples(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("md")
    return _run_example(T_EX, tmp), _run_example(_jax_example(), tmp)


def test_md_example_matches_jax_counts(examples):
    """Base/surrogate/fits, rows and the full/incremental refit split as
    the JAX package's run gives them."""
    (trec, tgp, _), (jrec, jgp, _) = examples
    keys = ("md_steps", "volumes", "structures", "force_points",
            "kernel_rows", "base_calls", "surrogate_calls", "gpr_fits",
            "refit_full", "refit_incremental")
    assert {k: trec[k] for k in keys} == {k: jrec[k] for k in keys}
    assert (trec["base_calls"], trec["surrogate_calls"],
            trec["gpr_fits"]) == (10, 113, 6)
    assert trec["kernel_rows"] == 48
    assert (trec["refit_full"], trec["refit_incremental"]) == (1, 5)
    assert set(trec) == set(jrec)


def test_md_example_matches_jax_positions(examples):
    """Every volume's final positions and every training structure within
    1e-8 A of the JAX run's."""
    (_, tgp, tkept), (_, jgp, jkept) = examples
    assert len(tkept) == len(jkept) == 3
    for ta, ja in zip(tkept, jkept):
        np.testing.assert_allclose(ta.positions, ja.positions, rtol=0,
                                   atol=1e-8)
    for trow, jrow in zip(tgp.train_db, jgp.train_db):
        np.testing.assert_allclose(trow[0].positions, jrow[0].positions,
                                   rtol=0, atol=1e-8)
        assert trow[4] == jrow[4]


def test_md_example_final_models_serve_alike(examples):
    """The two final models serve the last volume's structure and the
    training structures with E and F equal at 1e-10 of their largest
    magnitude, sigma_E and sigma_F at 1e-8."""
    (_, tgp, tkept), (_, jgp, jkept) = examples
    pairs = [(tkept[-1], jkept[-1])] + [
        (t[0], j[0]) for t, j in zip(tgp.train_db[::3], jgp.train_db[::3])]
    for ta, ja in pairs:
        tout = tgp.predict_structure(ta, return_std=True)
        jout = jgp.predict_structure(ja, return_std=True)
        for k, tol in ((0, TOL), (1, TOL), (3, 1e-8), (4, 1e-8)):
            ref = np.asarray(jout[k], float)
            np.testing.assert_allclose(tout[k], ref, rtol=0,
                                       atol=tol * np.abs(ref).max())
