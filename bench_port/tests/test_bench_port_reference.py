"""The plain reference against the formulas it copies, pair by pair, and
against the program's own float64 CPU path (which the repository's tests
hold to the JAX package); the work counts against brute force."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import work
from bench_port.reference import emt, gp as rgp, kernels as K, points, slab
from bench_port.reference import so3
from bench_port.tests.helpers import DOT_KERNEL

THETA = (1.3, 0.8)                 # (sigma, l) or (sigma, sigma0)
ZETA = {"RBF": 2, "Dot": 3}
FAMILIES = list(ZETA)


def _sides(seed=0, m_e=3, m_f=4, A=5, d=7):
    rs = np.random.RandomState(seed)
    ex = torch.as_tensor(rs.uniform(0.2, 1.0, (m_e, A, d)))
    ee = torch.as_tensor(rs.choice([13, 79], (m_e, A)))
    ee[0, -1] = 0                          # a padded env
    fx = torch.as_tensor(rs.uniform(0.2, 1.0, (m_f, A, d)))
    fd = torch.as_tensor(rs.uniform(-1, 1, (m_f, A, d, 3)))
    fe = torch.as_tensor(rs.choice([13, 79], (m_f, A)))
    counts = torch.full((m_e,), float(A), dtype=torch.float64)
    y = rs.normal(0, 0.1, m_e + 3 * m_f)
    return (ex, ee, counts), (fx, fd, fe), y


def _k_pair(xa, xb, family):
    """k, dk/dxa, dk/dxb, d2k/dxa dxb of the family's kernel at THETA on
    raw descriptors, by autograd."""
    xa = xa.clone().requires_grad_(True)
    xb = xb.clone().requires_grad_(True)
    s2, zeta = THETA[0] ** 2, ZETA[family]

    def k(a, b):
        c = (a / a.norm()) @ (b / b.norm())
        if family == "Dot":
            return s2 * (c ** zeta + THETA[1] ** 2)
        return s2 * torch.exp((c ** zeta - 1.0) / (2 * THETA[1] ** 2))
    H = torch.autograd.functional.hessian(k, (xa, xb))
    ga, gb = torch.autograd.grad(k(xa, xb), (xa, xb))
    return float(k(xa, xb).detach()), ga, gb, H[0][1]


def _naive(energy, force, family):
    """The covariance pair by pair from the upstream definitions: E rows
    the mean of the env kernels, F rows their derivatives through dx/dr
    (force = -dE/dr: K_EF carries one minus, K_FF two)."""
    (ex, ee, counts), (fx, fd, fe) = energy, force
    m_e, m_f = ex.shape[0], fx.shape[0]
    n = m_e + 3 * m_f
    Kn = np.zeros((n, n))
    for p in range(m_e):
        for q in range(m_e):
            for a in range(ex.shape[1]):
                for b in range(ex.shape[1]):
                    if ee[p, a] == 0 or ee[p, a] != ee[q, b]:
                        continue
                    k, _, _, _ = _k_pair(ex[p, a], ex[q, b], family)
                    Kn[p, q] += k / (counts[p] * counts[q])
    for p in range(m_e):
        for q in range(m_f):
            for a in range(ex.shape[1]):
                for b in range(fx.shape[1]):
                    if ee[p, a] == 0 or ee[p, a] != fe[q, b]:
                        continue
                    _, _, gb, _ = _k_pair(ex[p, a], fx[q, b], family)
                    v = -(gb @ fd[q, b]) / counts[p]
                    Kn[p, m_e + 3 * q:m_e + 3 * q + 3] += v.numpy()
    for p in range(m_f):
        for q in range(m_f):
            for a in range(fx.shape[1]):
                for b in range(fx.shape[1]):
                    if fe[p, a] != fe[q, b]:
                        continue
                    _, _, _, H = _k_pair(fx[p, a], fx[q, b], family)
                    blk = fd[p, a].T @ H @ fd[q, b]
                    Kn[m_e + 3 * p:m_e + 3 * p + 3,
                       m_e + 3 * q:m_e + 3 * q + 3] += blk.numpy()
    Kn[m_e:, :m_e] = Kn[:m_e, m_e:].T
    return Kn


@pytest.mark.parametrize("family", FAMILIES)
def test_blocks_against_the_pairwise_definition(family):
    energy, force, y = _sides()
    data = rgp.Data(energy, force, y)
    (Kr,) = rgp.covariance(data, THETA, ZETA[family], family)
    Kn = _naive(energy, force, family)
    assert np.abs(Kr.numpy() - Kn).max() <= 1e-12 * np.abs(Kn).max()


def test_dual_plane_against_finite_differences():
    energy, force, y = _sides(1)
    data = rgp.Data(energy, force, y)
    zeta = ZETA["RBF"]
    _, Kd = rgp.covariance(data, THETA, zeta, "RBF", dual=True)
    h = 1e-6
    # dK/dgamma from K at l with gamma +- h
    g0 = 1.0 / (2 * THETA[1] ** 2)
    lp, lm = (1.0 / np.sqrt(2 * (g0 + h)), 1.0 / np.sqrt(2 * (g0 - h)))
    (Kp,) = rgp.covariance(data, (THETA[0], lp), zeta, "RBF")
    (Km,) = rgp.covariance(data, (THETA[0], lm), zeta, "RBF")
    fd = (Kp - Km) / (2 * h)
    assert (Kd - fd).abs().max() <= 1e-6 * fd.abs().max()
    # the Dot kernel has none, as the program's has none
    with pytest.raises(ValueError, match="no dual plane"):
        rgp.covariance(data, THETA, ZETA["Dot"], "Dot", dual=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_nll_gradient_against_finite_differences(family):
    energy, force, y = _sides(2)
    data = rgp.Data(energy, force, y)
    noise = (0.01, 0.1)
    zeta = ZETA[family]
    _, g = rgp.nll(THETA, data, noise, zeta, family)
    h = 1e-6
    for i in range(2):
        tp, tm = list(THETA), list(THETA)
        tp[i] += h
        tm[i] -= h
        fd = (rgp.nll(tp, data, noise, zeta, family)[0]
              - rgp.nll(tm, data, noise, zeta, family)[0]) / (2 * h)
        assert abs(g[i] - fd) <= 1e-5 * max(1.0, abs(fd))


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0,
                      1.0 + 2.0 ** -10 + 2.0 ** -12], dtype=torch.float32)
    r = K.round_tf32(x)
    assert r.tolist() == [1.0, 1.0 + 2.0 ** -9, -3.0, 1.0 + 2.0 ** -10]


@pytest.fixture
def port_cpu(monkeypatch):
    from gpr_calculator_tpu_torch import config
    monkeypatch.setattr(config, "_DEVICE", None)
    config.set_device("cpu")
    import gpr_calculator_tpu_torch as port
    return port


def test_descriptor_and_emt_against_the_program(port_cpu):
    ims, z, cell, pbc, fixed = slab.au_on_al100(5)
    atoms = port_cpu.au_on_al100_images(5)
    for p, a in zip(ims, atoms):
        assert np.array_equal(p, a.positions)
    p = ims[2] + np.random.RandomState(0).normal(0, 0.05, ims[2].shape)
    a = atoms[2].copy()
    a.positions = p
    mine = so3.descriptor(p, z, cell, pbc, 3, 4, 5.0)
    theirs = port_cpu.SO3(nmax=3, lmax=4, rcut=5.0).calculate(
        a, dtype=torch.float64)
    assert np.array_equal(mine["seq"], theirs["seq"])
    assert np.abs(mine["x"].numpy() - theirs["x"]).max() < 1e-12
    assert np.abs(mine["dxdr"].numpy() - theirs["dxdr"]).max() < 1e-12
    e, f = emt.energy_forces(p, z, cell, pbc)
    a.calc = port_cpu.EMT()
    assert abs(e - a.get_potential_energy()) < 1e-10
    assert np.abs(f - a.get_forces(apply_constraint=False)).max() < 1e-10


@pytest.mark.parametrize("family", FAMILIES)
def test_fit_and_served_answers_against_the_program(port_cpu, family):
    """The slab cell's training set: the reference's L-BFGS-B, factor and
    served E, F, sigma against the program's float64 CPU path, with the
    configuration's kernel or the Dot kernel at the program's defaults."""
    from bench_port.systems.slab_emt import System
    cfg = __import__("bench_port.harness", fromlist=["x"]).load_json(
        work.__file__.replace("work.py", "configs/auAl13-rbf-f32.json"))
    cfg = dict(cfg, dtype="float64")
    if family == "Dot":
        cfg["kernel"] = dict(DOT_KERNEL)
    system = System(cfg, 5, torch.device("cpu"))
    assert system.family == family
    gp = system.port_model(port_cpu, None)
    assert gp.kernel.name == family
    gp.fit(opt=True, show=False)
    data = system.ref_data()
    theta, _ = rgp.fit(data, system.theta0, system.bounds, system.noise,
                       system.zeta, family)
    assert np.allclose(theta, gp.kernel.parameters(), rtol=1e-8)
    L, alpha = rgp.factorize(data, theta, system.noise, system.zeta, family)
    geo = system.geo
    p = system.images[1] + 0.02
    q = points.structures_data([p], geo, system.desc, "cpu")
    mean, std = rgp.predict(q, data, L, alpha, theta, system.zeta, family)
    atoms = port_cpu.Atoms(numbers=geo.numbers, positions=p, cell=geo.cell,
                           pbc=geo.pbc,
                           constraints=[port_cpu.FixAtoms(indices=geo.fixed)])
    E, F, _, sE, sF = gp.predict_structure(atoms, return_std=True)
    assert abs(E - float(mean[0]) * 13) < 1e-9
    assert np.abs(F[geo.free].reshape(-1) - mean[1:].numpy()).max() < 1e-9
    # variances: a std near zero is the root of rounding
    var = (std * std).numpy()
    assert abs(sE ** 2 - var[0]) < 1e-12
    assert np.abs(sF[geo.free].reshape(-1) ** 2 - var[1:]).max() < 1e-12


def test_pair_counts_against_brute_force():
    rs = np.random.RandomState(3)
    a = rs.choice([0, 13, 79], (5, 4))
    b = rs.choice([0, 13, 79], (3, 4))
    brute_rect = sum(1 for x in a.ravel() for y in b.ravel()
                     if x and x == y)
    assert work.pairs(a, b) == brute_rect
    tri = 0
    for p in range(5):
        for q in range(p, 5):
            tri += sum(1 for x in a[p] for y in a[q] if x and x == y)
    assert work.pairs(a) == tri


@pytest.mark.parametrize("family", FAMILIES)
def test_work_counts_by_family(family):
    """The covariance, NLL and fit bounds at a tiny size, summed by hand
    from the pair counts and the family's assembly operations."""
    rs = np.random.RandomState(4)
    d = 7
    inputs = {"e_ele": rs.choice([13, 79], (3, 5)),
              "f_ele": rs.choice([13, 79], (4, 5)), "d": d,
              "family": family}
    ff, ef, ee = (work.pairs(inputs["f_ele"]),
                  work.pairs(inputs["e_ele"], inputs["f_ele"]),
                  work.pairs(inputs["e_ele"]))
    n, ne, nf = 3 + 12, 15, 20
    asm = {"RBF": ((40, 46), (12, 10), 8), "Dot": ((28,), (7,), 4)}[family]

    def cov(planes):
        a_ff, a_ef = sum(asm[0][:planes]), sum(asm[1][:planes])
        return (max(ff * (32 * d + a_ff) / work.PEAK_FP32,
                    nf * (4 * d + 2) * 4 / work.PEAK_BYTES)
                + max(ef * (8 * d + a_ef) / work.PEAK_FP32,
                      (ne * (d + 2) + nf * (4 * d + 2)) * 4
                      / work.PEAK_BYTES)
                + ee * 2 * d / work.PEAK_FP64_TC
                + ee * asm[2] * planes / work.PEAK_FP64
                + 8 * n * n * planes / work.PEAK_BYTES)
    planes = len(asm[0])
    assert work.cov_bound_s(inputs, dual=False) == pytest.approx(cov(1))
    nll = cov(planes) + n ** 3 / work.PEAK_FP64_TC
    assert work.nll_bound_s(inputs) == pytest.approx(nll)
    assert work.fit_bound_s(inputs, 5) == pytest.approx(
        5 * nll + cov(1) + n ** 3 / 3 / work.PEAK_FP64_TC)
    if family == "Dot":
        with pytest.raises(ValueError, match="no dual plane"):
            work.cov_bound_s(inputs, dual=True)
    else:
        assert work.cov_bound_s(inputs, dual=True) == pytest.approx(cov(2))
