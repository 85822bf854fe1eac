"""The port's file IO and the entry points built on it, against the JAX
package on the CPU in float64: ULM trajectories written by one package
and read by the other, append mode, POSCAR both ways, the ``io.read``
dispatch, ``GP.save`` by one package and ``GP.load`` by the other,
``set_GPR(json_file=...)``, ``get_images`` from files and from a
trajectory's tail, and ``neb_calc(traj=...)`` writing the band.  Every
fixture is built in code."""
import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu import io as jio
from gpr_calculator_tpu import neb as jax_neb
from gpr_calculator_tpu.calculators import LJ as JLJ
from gpr_calculator_tpu.io import ulm as jax_ulm
from gpr_calculator_tpu.io import vasp as jax_vasp
from gpr_calculator_tpu_torch import io as tio
from gpr_calculator_tpu_torch import neb as port_neb
from gpr_calculator_tpu_torch.calculators import LJ
from gpr_calculator_tpu_torch.io import ulm, vasp

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)
from test_torch_neb import NOISE_E, NOISE_F, _images


SIGMA, L_SCALE = 0.9000824419630231, 1.291296129835527
PKGS = {"jax": (J, jax_ulm, jax_vasp, jio), "port": (T, ulm, vasp, tio)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _labelled(pkg):
    """The five Au/Al(100) images of ``pkg`` with a perturbed interior,
    each carrying an EMT energy and forces in ``info``."""
    rng = np.random.RandomState(3)
    images = _images(pkg)
    for a in images[1:-1]:
        a.positions[-1] += rng.normal(0.0, 0.1, 3)
    for a in images:
        b = T.Atoms(numbers=a.numbers, positions=a.positions,
                    cell=np.asarray(a.cell), pbc=a.pbc)
        b.calc = T.EMT()
        a.info["energy"] = b.get_potential_energy()
        a.info["forces"] = b.get_forces()
    return images


def _same_atoms(a, b, info=True):
    np.testing.assert_array_equal(a.numbers, b.numbers)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(np.asarray(a.cell), np.asarray(b.cell))
    np.testing.assert_array_equal(a.pbc, b.pbc)
    np.testing.assert_array_equal(a.fixed_indices(), b.fixed_indices())
    if info:
        assert a.info["energy"] == b.info["energy"]
        np.testing.assert_array_equal(a.info["forces"], b.info["forces"])


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_ulm_across_packages(writer, reader, tmp_path):
    """A ULM trajectory written by one package reads back exactly in the
    other: positions, cell, pbc, FixAtoms, energy and forces."""
    path = str(tmp_path / "band.traj")
    frames = _labelled(PKGS[writer][0])
    w = PKGS[writer][1].UlmWriter(path)
    for a in frames:
        w.write(a)
    back = PKGS[reader][1].read_traj(path)
    assert len(back) == len(frames)
    for a, b in zip(frames, back):
        _same_atoms(a, b)
    items = ulm.read_ulm_items(path)
    ref = jax_ulm.read_ulm_items(path)
    assert len(items) == len(ref) == len(frames)


def test_trajectory_append_mode(tmp_path):
    """Trajectory(mode="a") resumes after the frames already written (by
    either package); the calculator's results land in the frames."""
    path = str(tmp_path / "run.traj")
    frames = _labelled(T)
    w = tio.Trajectory(path, mode="w")
    for a in frames[:2]:
        w.write(a)
    jw = jio.TrajectoryWriter(path, mode="a")
    jw.write(_labelled(J)[2])
    w = tio.Trajectory(path, mode="a")
    a = frames[3].copy()
    a.info.clear()
    a.calc = T.EMT()
    e = a.get_potential_energy()
    f = a.calc.results["forces"]
    w.write(a)
    back = tio.Trajectory(path)
    assert len(back) == 4 and len(jio.read(path, index=":")) == 4
    for k in range(3):
        _same_atoms(back[k], frames[k])
    np.testing.assert_array_equal(back[3].positions, frames[3].positions)
    assert back[3].info["energy"] == e
    np.testing.assert_array_equal(back[3].info["forces"], f)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_poscar_across_packages(writer, reader, tmp_path):
    """POSCAR written by one package and read by the other: the numbers,
    cell, pbc, FixAtoms (selective dynamics) and positions, exactly as the
    JAX package's own round trip gives them."""
    path = str(tmp_path / "POSCAR")
    atoms = _images(PKGS[writer][0])[2]
    PKGS[writer][2].write_vasp(path, atoms)
    back = PKGS[reader][2].read_vasp(path)
    ref_path = str(tmp_path / "CONTCAR")
    jax_vasp.write_vasp(ref_path, _images(J)[2])
    ref = jax_vasp.read_vasp(ref_path)
    _same_atoms(back, ref, info=False)
    np.testing.assert_allclose(back.positions, atoms.positions, rtol=0,
                               atol=1e-14)
    np.testing.assert_array_equal(back.fixed_indices(),
                                  atoms.fixed_indices())


def test_read_dispatch(tmp_path):
    """io.read picks the format from the extension or the POSCAR/CONTCAR
    basename, as the JAX package's read does."""
    frames = _labelled(T)
    traj = str(tmp_path / "band.traj")
    w = ulm.UlmWriter(traj)
    for a in frames:
        w.write(a)
    db = str(tmp_path / "set.db")
    tio.ase_db.write_db(db, [{"atoms": a} for a in frames])
    sub = tmp_path / "POSCAR_scan"
    sub.mkdir()
    poscar = str(sub / "CONTCAR_2")
    vasp.write_vasp(poscar, frames[2])
    dotvasp = str(tmp_path / "image.vasp")
    vasp.write_vasp(dotvasp, frames[1])
    for name, index in ((traj, -1), (traj, 1), (traj, ":"), (db, ":"),
                        (db, 0), (poscar, -1), (dotvasp, -1)):
        ours, ref = tio.read(name, index=index), jio.read(name, index=index)
        ours = ours if isinstance(ours, list) else [ours]
        ref = ref if isinstance(ref, list) else [ref]
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _same_atoms(a, b, info=False)
    # a slice selects frames (the JAX package's read returns them all)
    for a, b in zip(tio.read(traj, index=slice(1, 3)), frames[1:3]):
        _same_atoms(a, b)
    assert len(tio.read(traj, index=slice(1, 3))) == 2
    np.testing.assert_array_equal(tio.read(traj, format="traj").positions,
                                  frames[-1].positions)
    with pytest.raises(ValueError, match="unsupported"):
        tio.read(str(tmp_path / "band.xyz"))


def _saved_model(pkg, base):
    """A model of ``pkg`` trained on images 0, 4, 2 at fixed
    hyperparameters, with an LJ base potential when ``base``."""
    lj = (JLJ if pkg is J else LJ)({"rc": 5.0, "sigma": 2.2,
                                    "epsilon": 0.1}) if base else None
    gp = pkg.GP(kernel=pkg.RBF(para=[SIGMA, L_SCALE], zeta=2),
                descriptor=pkg.SO3(nmax=3, lmax=4, rcut=5.0),
                base_potential=lj, noise_e=NOISE_E, noise_f=NOISE_F,
                log_file=None)
    images = _images(pkg)
    for k in (0, 4, 2):
        a = T.au_on_al100_images()[k]
        a.calc = T.EMT()
        gp.add_structure((images[k], a.get_potential_energy(),
                          a.get_forces(apply_constraint=False)))
    gp.fit(opt=False, show=False)
    return gp


@pytest.mark.parametrize("base", [False, True])
@pytest.mark.parametrize("saver,loader", DIRECTIONS)
def test_save_and_load_across_packages(saver, loader, base, tmp_path,
                                       monkeypatch):
    """GP.save by one package, GP.load by the other (the database found
    beside the JSON from another working directory), fit(opt=False): the
    same training set and the same served band at 1e-10."""
    monkeypatch.chdir(tmp_path)
    gp = _saved_model(PKGS[saver][0], base)
    gp.save("model.json", "model.db", verbose=False)
    (tmp_path / "elsewhere").mkdir()
    monkeypatch.chdir(tmp_path / "elsewhere")
    pkg = PKGS[loader][0]
    kw = {"device": "cpu"} if pkg is T else {}
    loaded = pkg.GP.load(str(tmp_path / "model.json"), log_file=None, **kw)
    assert (loaded.N_energy, loaded.N_forces) == (gp.N_energy, gp.N_forces)
    assert loaded.kernel.parameters() == gp.kernel.parameters()
    assert (loaded.base_potential is None) == (not base)
    np.testing.assert_allclose(loaded.train_y["energy"],
                               gp.train_y["energy"], rtol=1e-12)
    loaded.fit(opt=False, show=False)
    band = _images(pkg)[1:4]
    ours = [loaded.predict_structure(a, return_std=True) for a in band]
    ref = [gp.predict_structure(a, return_std=True)
           for a in _images(PKGS[saver][0])[1:4]]
    for (E, F, _, sE, sF), (Er, Fr, _, sEr, sFr) in zip(ours, ref):
        assert abs(E - Er) <= 1e-10 * abs(Er)
        np.testing.assert_allclose(F, Fr, rtol=0,
                                   atol=1e-10 * np.abs(Fr).max())
        np.testing.assert_allclose(sF ** 2, sFr ** 2, rtol=0,
                                   atol=1e-10 * (sFr ** 2).max())
        assert abs(sE ** 2 - sEr ** 2) <= 1e-10 * sEr ** 2


def test_load_keeps_n_max_and_force_rows(tmp_path):
    """N_max keeps the first rows; each row's energy_in and force_in
    decide its points, as the JAX package's extract_db does.  The device
    is the port's: the JAX package's "tpu" is no device here."""
    gp = _saved_model(T, False)
    gp.save(str(tmp_path / "m.json"), str(tmp_path / "m.db"), verbose=False)
    with pytest.raises(RuntimeError):
        T.GP.load(str(tmp_path / "m.json"), device="tpu", log_file=None)
    for n_max in (None, 2):
        ours = T.GP.load(str(tmp_path / "m.json"), N_max=n_max,
                         device="cpu", log_file=None)
        ref = J.GP.load(str(tmp_path / "m.json"), N_max=n_max,
                        log_file=None)
        assert (ours.N_energy, ours.N_forces) == (ref.N_energy, ref.N_forces)
        assert len(ours.train_db) == (3 if n_max is None else 2)
        for (x, ele), (xr, eler) in zip(ours._energy_pts, ref._energy_pts):
            np.testing.assert_allclose(x, xr, rtol=0,
                                       atol=1e-12 * np.abs(xr).max())
            np.testing.assert_array_equal(ele, eler)
        for p, q in zip(ours._force_pts, ref._force_pts):
            for u, v in zip(p, q):
                np.testing.assert_allclose(u, v, rtol=0,
                                           atol=1e-12 * np.abs(v).max())


@pytest.mark.parametrize("overwrite,kernel", [(False, "RBF"),
                                              (True, "Dot")])
def test_set_gpr_from_an_existing_json(overwrite, kernel, tmp_path):
    """set_GPR(json_file=existing) loads the saved model and fits it (with
    overwrite: the noise and kernel given), as the JAX package does."""
    gp = _saved_model(T, False)
    path = str(tmp_path / "m.json")
    gp.save(path, str(tmp_path / "m.db"), verbose=False)
    runs = []
    for pkg in (T, J):
        g = pkg.GP.set_GPR(None, None, kernel=kernel, noise_e=0.004,
                           noise_f=0.06, json_file=path,
                           overwrite=overwrite, log_file=None)
        runs.append(g)
    ours, ref = runs
    assert ours.kernel.name == ref.kernel.name == kernel
    assert (ours.noise_e, ours.noise_f) == (ref.noise_e, ref.noise_f)
    assert (ours.N_energy, ours.N_forces, ours.fits) == \
        (ref.N_energy, ref.N_forces, ref.fits) == (3, gp.N_forces, 1)
    np.testing.assert_allclose(ours.kernel.parameters(),
                               ref.kernel.parameters(), rtol=1e-6)


def test_get_images_from_files_and_from_a_trajectory(tmp_path):
    """get_images from .traj and POSCAR files, and from the tail of an
    existing trajectory (traj=), as the JAX package builds them."""
    ends = T.au_on_al100_images()
    init, final = str(tmp_path / "initial.traj"), str(tmp_path / "final.vasp")
    w = ulm.UlmWriter(init)
    w.write(ends[0])
    vasp.write_vasp(final, ends[-1])
    for kw in ({}, {"IDPP": True, "mic": True}):
        ours = port_neb.get_images(init, final, num_images=5, **kw)
        ref = jax_neb.get_images(init, final, num_images=5, **kw)
        assert len(ours) == len(ref) == 5
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a.positions, b.positions, rtol=0,
                                       atol=1e-12)
    traj = str(tmp_path / "neb.traj")
    w = ulm.UlmWriter(traj)
    for a in T.au_on_al100_images(9) + ends:
        w.write(a)
    ours = port_neb.get_images(init, final, num_images=5, traj=traj)
    ref = jax_neb.get_images(init, final, num_images=5, traj=traj)
    assert len(ours) == 5
    for a, b, c in zip(ours, ref, ends):
        _same_atoms(a, b, info=False)
        np.testing.assert_array_equal(a.positions, c.positions)


@pytest.mark.parametrize("batched", [False, True])
def test_neb_calc_writes_the_band(batched, tmp_path):
    """neb_calc(traj=...) writes every image at the start and after each
    step, the last band the final one; the JAX package reads the file."""
    gp = _saved_model(T, False)
    images = T.au_on_al100_images()
    path = str(tmp_path / "band.traj")
    calc = T.GPR(base=T.EMT(), ff=gp, save=False)
    calc.verbose = False
    band = T.neb_calc(images, calc, fmax=0.05, steps=2, traj=path,
                      batched=batched)
    frames = tio.read(path, index=":")
    assert band.nsteps == 3
    assert len(frames) == 5 * band.nsteps == len(jio.read(path, index=":"))
    for a, b in zip(frames[-5:], images):
        np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(frames[0].positions, images[0].positions)
