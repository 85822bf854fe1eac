"""Stress serving in the port against the JAX package, on the CPU in
float64: the strain rows of the SO(3) descriptor (``rdxdr``), force points
with 9 cartesian columns (``pack_force``), the served block built by
column groups of three (``k_block``: K2 and K3 a group, the kernels'
route on the card), the 9-column ``diag_force`` and
``k_total_with_stress``, ``GP.predict_structure(stress=True)``,
``GP.predict`` with 9-column points and the ``GPR`` calculator's stress.
The fixtures are periodic LJ Cu cells built in code (tests/test_stress.py's
``make_periodic`` / ``strained``).

Tolerances: the port against the JAX package 1e-10 of the largest
magnitude compared (float64, sums in another order), the served stds
1e-8 (STD_TOL); in the bf16x4 /
bf16 modes the port's plain versions against the JAX kernels in
interpret mode, 2e-5 max|JAX| + 1e-6 (tests/test_torch_precision.py's);
the strain finite differences and the symmetry of the summed virial at
tests/test_stress.py's bounds."""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu.calculators.lj import LJ as JLJ
from gpr_calculator_tpu.calculators.lj import LennardJones as JLennardJones
from gpr_calculator_tpu_torch import convert
from gpr_calculator_tpu_torch.calculators.lj import LJ as TLJ
from gpr_calculator_tpu_torch.calculators.lj import LennardJones
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)
from test_torch_precision import _jax_energy, _jax_force

TOL = 1e-10
# a served std is sqrt(prior - explained), a small difference of large
# numbers at this model's sigma = 50: the packages' stds differ by ~3e-10
# of themselves (tests/test_torch_incremental.py's STD_TOL)
STD_TOL = 1e-8
# reference Voigt pick (gaussianprocess.py:863): [xx, yy, zz, xy, xz, yz]
VOIGT = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
LJ_PARAMS = {"rc": 3.2, "sigma": 2.2, "epsilon": 0.4}
PARAMS = {"rbf": {"sigma": 1.3, "l": 0.9}, "dot": {"sigma": 1.3,
                                                  "sigma0": 0.7}}


def make_periodic(pkg, seed=0, natoms=4, a=3.8):
    """Slightly distorted fcc-like periodic cell (no accidental symmetry),
    a triclinic tilt so the off-diagonal strain terms are live."""
    rng = np.random.RandomState(seed)
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])[:natoms]
    cell = np.eye(3) * a
    cell[0, 1] = 0.13 * a
    pos = frac @ cell + 0.05 * a * rng.randn(natoms, 3)
    return pkg.Atoms(numbers=[29] * natoms, positions=pos, cell=cell,
                     pbc=True)


def strained(pkg, atoms, eps):
    """The deformation r -> (I + eps) r of positions and cell."""
    F = np.eye(3) + eps
    return pkg.Atoms(numbers=atoms.numbers.copy(),
                     positions=atoms.positions @ F.T,
                     cell=np.asarray(atoms.get_cell()) @ F.T,
                     pbc=atoms.pbc.copy())


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(ours, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _so3(pkg):
    return pkg.SO3(nmax=2, lmax=2, rcut=3.2, stress=True)


# -- the descriptor ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_rdxdr_matches_jax(seed):
    """x, dxdr and the strain rows rdxdr of SO3(stress=True).calculate
    equal the JAX package's."""
    ours = _so3(T).calculate(make_periodic(T, seed), dtype=torch.float64)
    ref = _so3(J).calculate(make_periodic(J, seed))
    for key in ("x", "dxdr", "rdxdr"):
        assert ours[key].shape == np.asarray(ref[key]).shape
        _close(ours[key], ref[key])
    np.testing.assert_array_equal(ours["seq"], ref["seq"])


def test_device_and_many_forms_match_calculate():
    """calculate_device (with its zero pad row) and calculate_many /
    calculate_many_device over two cells give calculate's rdxdr, each
    cell scaled by its own volume."""
    so3 = _so3(T)
    cells = [make_periodic(T, 0), make_periodic(T, 5, a=4.1)]
    one = [so3.calculate(a, dtype=torch.float64) for a in cells]
    dd = so3.calculate_device(cells[0], dtype=torch.float64)
    nseq = dd["nseq"]
    assert dd["rdxdr"].shape[0] == nseq + 1
    assert not bool(dd["rdxdr"][nseq].any())
    np.testing.assert_array_equal(dd["rdxdr"][:nseq].numpy(), one[0]["rdxdr"])
    many = so3.calculate_many(cells, dtype=torch.float64)
    many_dev = so3.calculate_many_device(cells, dtype=torch.float64)
    for k in range(2):
        _close(many[k]["rdxdr"], one[k]["rdxdr"], 1e-12)
        _close(many_dev[k]["rdxdr"][:-1].numpy(), one[k]["rdxdr"], 1e-12)
    assert T.SO3(nmax=2, lmax=2, rcut=3.2).calculate(
        cells[0], dtype=torch.float64)["rdxdr"] is None
    with pytest.raises(ValueError, match="derivative"):
        T.SO3(stress=True, derivative=False)


def test_rdxdr_matches_strain_finite_difference():
    """vol * sum_s rdxdr[s, c] contracted with a strain direction A equals
    the finite-difference derivative of sum_i x[i, c] along that strain
    (tests/test_stress.py's bounds)."""
    so3 = _so3(T)
    atoms = make_periodic(T)
    d = so3.calculate(atoms, dtype=torch.float64)
    total = atoms.get_volume() * d["rdxdr"].sum(axis=0)
    A = np.random.RandomState(7).randn(3, 3)
    A = 0.5 * (A + A.T)
    h = 1e-6
    Tp = so3.calculate(strained(T, atoms, h * A),
                       dtype=torch.float64)["x"].sum(axis=0)
    Tm = so3.calculate(strained(T, atoms, -h * A),
                       dtype=torch.float64)["x"].sum(axis=0)
    fd = (Tp - Tm) / (2 * h)
    np.testing.assert_allclose(np.einsum("cnm,nm->c", total, A), fd,
                               rtol=2e-5, atol=2e-7 * np.abs(fd).max())


def test_rdxdr_total_is_symmetric():
    """Rotation invariance makes the summed virial tensor symmetric per
    coefficient (the (R, gradient) index order)."""
    total = _so3(T).calculate(make_periodic(T, 3),
                              dtype=torch.float64)["rdxdr"].sum(axis=0)
    asym = np.abs(total - np.swapaxes(total, 1, 2)).max()
    assert asym < 1e-8 * max(np.abs(total).max(), 1.0)


# -- packing and the blocks --------------------------------------------------

def _points(seed, n, envs, d=9, ncart=9):
    rng = np.random.RandomState(seed)
    pts = []
    for _ in range(n):
        ne = rng.randint(envs - 1, envs + 1)
        pts.append((rng.uniform(0.2, 1.0, (ne, d)),
                    rng.uniform(-1.0, 1.0, (ne, d, ncart)),
                    rng.choice([13, 79], ne)))
    return pts


def _sides(seed, dtype=torch.float64):
    """A 9-column query (2 E, 4 F) and a 3-column training side (3 E,
    6 F), in the port and in the JAX package."""
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    q_e = [(x, el) for x, _, el in _points(seed, 2, 5, ncart=3)]
    q_f = _points(seed + 1, 4, 6)
    t_e = [(x, el) for x, _, el in _points(seed + 2, 3, 5, ncart=3)]
    t_f = _points(seed + 3, 6, 6, ncart=3)
    kw = dict(dtype=dtype)
    ours = (pack_energy(q_e, a_pad=6, **kw), pack_force(q_f, b_pad=8, **kw),
            pack_energy(t_e, a_pad=6, **kw), pack_force(t_f, b_pad=7, **kw))
    ref = (jpe(q_e, a_pad=6), jpf(q_f, b_pad=8, ncart=9), jpe(t_e, a_pad=6),
           jpf(t_f, b_pad=7))
    return ours, ref


def test_pack_force_with_strain_columns_matches_jax():
    """pack_force of 9-column points equals the JAX package's (ncart=9),
    and refuses a declared width the points do not carry."""
    (_, pf, _, _), (_, jpf, _, _) = _sides(11)
    assert pf.ncart == 9 and tuple(pf.dxdr.shape) == jpf.dxdr.shape
    np.testing.assert_array_equal(pf.dxdr.numpy(), np.asarray(jpf.dxdr))
    np.testing.assert_array_equal(pf.x.numpy(), np.asarray(jpf.x))
    with pytest.raises(ValueError, match="ncart"):
        pack_force(_points(1, 2, 4), ncart=6)


@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_column_group_k_block_matches_jax_xla(kind):
    """The served block of a 9-column query, K2 and K3 one launch a
    column group (the plain versions here), rows (point, 9): equal to
    the JAX package's XLA k_block at 1e-10, and the 9-column diag_force
    and k_self (the predictive covariance's self block) to JAX's."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    (pe, pf, te, tf), (jpe, jpf, jte, jtf) = _sides(21)
    params = PARAMS[kind]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    K = TK.k_block(pe, pf, te, tf, params, 2, kind)
    assert tuple(K.shape) == (pe.m + 9 * pf.m, te.m + 3 * tf.m)
    _close(K.numpy(), JK.k_block(jpe, jpf, jte, jtf, jp, kind, 2))
    _close(TK.diag_force(pf, params, 2, kind).numpy(),
           JK.diag_force(jpf, jp, kind, 2))
    _close(TK.k_self(pe, pf, params, 2, kind).numpy(),
           JK.k_self(jpe, jpf, jp, kind, 2))


@pytest.mark.parametrize("kind", ["rbf", "dot"])
@pytest.mark.parametrize("mode", ["bf16x4", "bf16"])
def test_column_group_k_block_in_mode_matches_pallas(mode, kind):
    """In the bf16 modes each column group's K_FE and K_FF rows of the
    served block (float32) equal the JAX kernels in interpret mode on that
    group's three columns at the same mode (the Pallas kernels take 3)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kff_pallas as KP
    (pe, pf, te, tf), _ = _sides(31, torch.float32)
    params = PARAMS[kind]
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    K = TK.k_block(pe, pf, te, tf, params, 2, kind, mm_precision=mode)
    m1, m2 = pe.m, te.m
    rows = K[m1:].reshape(pf.m, 3, 3, -1)
    B1, B2, A2 = pf.x.shape[1], tf.x.shape[1], te.x.shape[1]
    Xs, re1 = kff.force_operands(pf, "highest")
    X2, re2 = kff.force_operand(tf, "highest")
    U2, w2 = kff.energy_operand(te, "highest")
    _, R2, jre2 = _jax_force(X2, re2, B2, mode)
    Le2, _, we2 = _jax_energy(U2, w2, A2, mode)
    jkw = dict(zeta=2, mode=mode, kind=kind, dual=False, deriv=False)
    for g, Xg in enumerate(Xs):
        L1, R1, jre1 = _jax_force(Xg, re1, B1, mode)
        ff = np.asarray(KP.kff_from_ops(jp, L1, jre1, R2, jre2, B1=B1, B2=B2,
                                        interpret=True, symmetric=False,
                                        **jkw), np.float64)
        fe = np.asarray(KP.kef_from_ops(jp, Le2, we2, R1, jre1, A1=A2, B2=B1,
                                        interpret=True, **jkw), np.float64).T
        ours = rows[:, g].reshape(3 * pf.m, -1).numpy().astype(np.float64)
        for o, ref in ((ours[:, m2:], ff[:3 * pf.m, :3 * tf.m]),
                       (ours[:, :m2], fe[:3 * pf.m, :m2])):
            np.testing.assert_allclose(o, ref, rtol=0,
                                       atol=2e-5 * np.abs(ref).max() + 1e-6)


def test_k_total_with_stress_matches_jax():
    """The block API's stress build on a stress descriptor's own points
    (each atom's force point with its strain rows) against the JAX
    package's: C and C_stress at 1e-10."""
    from gpr_calculator_tpu_torch.models.gp import _group_force_points
    d = _so3(T).calculate(make_periodic(T, 4), dtype=torch.float64)
    ele = np.full(len(d["x"]), 29)
    data1 = {"energy": [(d["x"], ele)],
             "force": _group_force_points(d, ele, range(4), stress=True)}
    data2 = {"energy": [(d["x"], ele)],
             "force": _group_force_points(d, ele, range(4))}
    ours = T.RBF(para=[1.3, 0.9]).k_total_with_stress(data1, data2)
    ref = J.RBF(para=[1.3, 0.9]).k_total_with_stress(data1, data2)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        _close(a, b)


# -- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def lj_models():
    """A stress-enabled RBF GP trained by the JAX package on LJ data for
    five periodic Cu cells (tests/test_stress.py's ``lj_gp``); the port's
    GP of its training set, hyperparameters, weights and factor
    (convert.py), which serves what the JAX model serves; and the port's
    own refit of that training set.  The optimised sigma sits at its
    bound (50) against noise_e = 0.002, so K is ill-conditioned: the two
    packages' factorisations of it put served forces ~2e-10 of their
    largest apart, which is why the serving comparison takes the JAX
    model's weights."""
    calc = JLJ(parameters=LJ_PARAMS)
    jgp = J.GP(kernel=J.RBF(para=[1.0, 0.8]), descriptor=_so3(J),
               noise_e=0.002, noise_f=0.05, log_file=None)
    for k in range(5):
        s = make_periodic(J, seed=10 + k)
        e, f, _ = calc.calculate(s)
        jgp.add_structure((s, e, f))
    jgp.fit(show=False, opt=True, maxiter=8)
    state = convert.state_of(jgp)
    kw = dict(device="cpu", dtype=torch.float64, log_file=None)
    carried = convert.gp_from_state(state, **kw)
    for key in ("alpha", "L", "n_fit"):
        state.pop(key)
    refit = convert.gp_from_state(state, **kw)
    refit.fit(show=False, opt=False)
    return jgp, carried, refit


@pytest.mark.parametrize("seed", [30, 31])
def test_predict_structure_stress_matches_jax(lj_models, seed):
    """E, F and the per-atom stress rows S from
    predict_structure(stress=True, return_std=True) equal the JAX model's
    at 1e-10, the stds of E and F at STD_TOL."""
    jgp, tgp, _ = lj_models
    ours = tgp.predict_structure(make_periodic(T, seed), stress=True,
                                 return_std=True)
    ref = jgp.predict_structure(make_periodic(J, seed), stress=True,
                                return_std=True)
    assert ours[2].shape == (4, 6)
    for a, b, tol in zip(ours, ref, (TOL, TOL, TOL, STD_TOL, STD_TOL)):
        _close(a, b, tol)


def test_predicted_stress_matches_energy_fd(lj_models):
    """The summed per-atom stress equals dE_pred/d(strain)/vol of the
    port's own refit (tests/test_stress.py's bounds)."""
    _, _, gp = lj_models
    atoms = make_periodic(T, seed=30)
    _, _, S = gp.predict_structure(atoms, stress=True)
    sig = np.zeros((3, 3))
    for k, (i, j) in enumerate(VOIGT):
        sig[i, j] = sig[j, i] = S.sum(axis=0)[k]
    A = np.random.RandomState(11).randn(3, 3)
    A = 0.5 * (A + A.T)
    h = 1e-5
    Ep, _, _ = gp.predict_structure(strained(T, atoms, h * A))
    Em, _, _ = gp.predict_structure(strained(T, atoms, -h * A))
    fd = (Ep - Em) / (2 * h)
    np.testing.assert_allclose(atoms.get_volume() * np.sum(sig * A), fd,
                               rtol=5e-4, atol=5e-6 * max(abs(fd), 1.0))


def test_predict_nine_column_points_sliced_correctly(lj_models):
    """GP.predict with 9-column force points returns 9 rows a point that
    match predict_structure (forces as they are, the strain rows negated
    there), and refuses stress=True on 3-column points."""
    from gpr_calculator_tpu_torch.models.gp import _group_force_points
    _, _, gp = lj_models
    atoms = make_periodic(T, seed=31)
    E, F, S = gp.predict_structure(atoms, stress=True)
    d = gp.descriptor.calculate(atoms, dtype=torch.float64)
    ele = np.full(len(atoms), 29)
    X = {"energy": [(d["x"], ele)],
         "force": _group_force_points(d, ele, range(len(atoms)),
                                      stress=True)}
    mean, std = gp.predict(X, stress=True, return_std=True)
    rows = mean[1:].reshape(len(atoms), 9)
    np.testing.assert_allclose(rows[:, :3], F, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(-rows[:, 3:], S, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(mean[0] * len(atoms), E, rtol=1e-8)
    assert std.shape == mean.shape and np.all(np.isfinite(std))
    with pytest.raises(ValueError, match="9-column"):
        gp.predict({"energy": [(d["x"], ele)],
                    "force": _group_force_points(d, ele, [0])}, stress=True)


def test_stress_needs_a_stress_descriptor(lj_models):
    """predict_structure(stress=True) on a model whose descriptor has no
    strain rows raises, as the JAX package's does."""
    _, gp, _ = lj_models
    plain = convert.gp_from_state(convert.state_of(gp), device="cpu",
                                  dtype=torch.float64, log_file=None)
    plain.descriptor = T.SO3(nmax=2, lmax=2, rcut=3.2)
    with pytest.raises(ValueError, match="stress-enabled"):
        plain.predict_structure(make_periodic(T, 30), stress=True)


def test_base_potential_stress_order_matches_jax():
    """A base potential's stress (ASE Voigt xx, yy, zz, yz, xz, xy) is
    permuted into the strain rows' order (xx, yy, zz, xy, xz, yz) before
    it is added: the difference with and without the base potential is
    the LJ stress so permuted, and both models equal the JAX package's."""
    rng = np.random.RandomState(73)
    cell = np.array([[8.0, 0.6, 0.0], [0.0, 8.0, 0.4], [0.2, 0.0, 8.0]])
    pos = [rng.uniform(1.0, 7.0, (5, 3)) for _ in range(3)]

    def build(pkg, base):
        strucs = [pkg.Atoms(numbers=[29] * 5, positions=p, cell=cell,
                            pbc=True) for p in pos]
        gp = pkg.GP(kernel=pkg.RBF(para=[1.2, 1.0]),
                    descriptor=pkg.SO3(nmax=2, lmax=2, rcut=4.0,
                                       stress=True),
                    noise_e=0.02, noise_f=0.15, base_potential=base,
                    log_file=None)
        for s in strucs[:2]:
            s.calc = pkg.EMT()
            e, f = s.get_potential_energy(), s.get_forces()
            s.calc = None
            if base is not None:
                e_off, f_off, _ = base.calculate(s)
                e, f = e - e_off, f - f_off
            gp.add_structure((s, e, f))
        gp.fit(show=False, opt=False)
        return gp, strucs[2]

    params = {"rc": 4.0, "sigma": 2.0, "epsilon": 0.05}
    gp1, probe = build(T, TLJ(params))
    S1 = gp1.predict_structure(probe, stress=True)[2]
    jgp1, jprobe = build(J, JLJ(params))
    _close(S1, jgp1.predict_structure(jprobe, stress=True)[2])
    gp1.base_potential = None
    S1_nobase = gp1.predict_structure(probe, stress=True)[2]
    expected = np.asarray(TLJ(params).calculate(probe)[2])[:, [0, 1, 2, 5,
                                                               4, 3]]
    np.testing.assert_allclose(S1 - S1_nobase, expected, rtol=1e-8,
                               atol=1e-12)


def test_gpr_calculator_stress_matches_jax(lj_models):
    """GPR(stress=True): results["stress"] (ASE Voigt, summed over the
    atoms) equals the JAX calculator's on the same frozen models."""
    jgp, tgp, _ = lj_models
    out = []
    for pkg, gp in ((T, tgp), (J, jgp)):
        atoms = make_periodic(pkg, seed=31)
        base = (LennardJones if pkg is T else JLennardJones)(LJ_PARAMS)
        calc = pkg.GPR(base=base, ff=gp, save=False, stress=True)
        calc.verbose = False
        calc.freeze()
        calc.calculate(atoms, properties=["energy", "forces", "stress"])
        out.append(calc.results)
    assert out[0]["stress"].shape == (6,)
    for key in ("energy", "forces", "stress"):
        _close(out[0][key], out[1][key])
