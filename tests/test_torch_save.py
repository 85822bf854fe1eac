"""GP.save of the port: the dispatcher's autosave after a refit writes the
model JSON and an ASE-compatible database that the JAX package reads
back to the same training set (io.ase_db.read_db, GP.load)."""
import json

import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu.io import ase_db as jax_db
from gpr_calculator_tpu_torch.io import ase_db

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)


SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527
NOISE_E, NOISE_F = 0.05 / 13, 0.05


@pytest.fixture
def saved(tmp_path, monkeypatch):
    """A port GPR with its default save=True, driven to one refit: two
    base calls queue two energy points, and the dispatcher refits and
    saves into the working directory."""
    monkeypatch.chdir(tmp_path)
    images = T.au_on_al100_images()
    gp = T.GP(kernel=T.RBF(para=[SIGMA, L_SCALE], zeta=2),
              descriptor=T.SO3(nmax=3, lmax=4, rcut=5.0),
              noise_e=NOISE_E, noise_f=NOISE_F, log_file=None, device="cpu")
    for k in (0, 4):
        a = images[k].copy()
        a.calc = T.EMT()
        e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
        a.calc = None
        gp.add_structure((a, e, f))
    gp.fit(opt=False, show=False)
    for k in (1, 3):
        a = images[k].copy()
        a.calc = T.GPR(base=T.EMT(), ff=gp, opt_freq=10 ** 6)
        a.calc.verbose = False
        a.calc.force_base = True
        a.get_potential_energy()
    assert gp.fits == 2
    return tmp_path, gp


def test_refit_saves_json_and_db(saved):
    path, gp = saved
    meta = json.loads((path / "GPR-gpr.json").read_text())
    assert meta["db_filename"] == "GPR-gpr.db"
    assert meta["kernel"]["sigma"] == gp.kernel.sigma
    rows = ase_db.read_db(str(path / "GPR-gpr.db"))
    assert len(rows) == len(gp.train_db) == 4
    for row, (atoms, energy, force, energy_in, force_in) in zip(
            rows, gp.train_db):
        np.testing.assert_array_equal(row["atoms"].positions,
                                      atoms.positions)
        np.testing.assert_array_equal(row["atoms"].fixed_indices(),
                                      atoms.fixed_indices())
        assert row["data"]["energy"] == energy
        assert list(row["data"]["force_in"]) == list(force_in)


def test_jax_package_loads_the_saved_model(saved):
    path, gp = saved
    rows = jax_db.read_db(str(path / "GPR-gpr.db"))
    assert len(rows) == len(gp.train_db)
    jgp = J.GP.load(str(path / "GPR-gpr.json"), log_file=None)
    assert (jgp.N_energy, jgp.N_forces) == (gp.N_energy, gp.N_forces)
    assert jgp.kernel.parameters() == gp.kernel.parameters()
    np.testing.assert_allclose(jgp.train_y["energy"], gp.train_y["energy"],
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(jgp.train_y["force"]),
                               np.asarray(gp.train_y["force"]), rtol=1e-12)
