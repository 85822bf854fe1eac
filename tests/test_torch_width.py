"""Descriptor widths above 32 in the port, on the CPU in float64 against
the JAX package: the operands padded to the next multiple of kff.DP and
the kernels' width check (``_check_side``), the plain K_FF / K_EF / K_EE
blocks (K1, K2, K3; RBF with its dual pass, Dot) against the JAX XLA
builds ``kff_self`` / ``kff`` / ``kef`` / ``kee`` at 1e-10, ``fit`` and
``predict_structure`` of a model with SO3(nmax=4, lmax=4) (d = 50)
against the JAX GP, the on-the-fly NEB at that width against the JAX
package's run, and the k-major copy of the highest K1 kernels, one block
of kff.TROWS rows for each k-slice of kff.DP values."""
import re

import numpy as np
import pytest
import torch

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import convert
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _on_cpu, make_points  # noqa: F401 (fixture)


# descriptor widths: nmax 3 / lmax 4 (the slice's), one past a slice, nmax
# 4 / lmax 4, two whole slices, nmax 6 / lmax 6
WIDTHS = (30, 33, 50, 64, 147)
PARAMS = {"sigma": 1.3, "l": 0.9}
DOT_PARAMS = {"sigma": 0.7, "sigma0": 1.4}
NOISE_E, NOISE_F = 0.05 / 13, 0.05
# the JAX package's on-the-fly NEB at nmax 4, lmax 4, rcut 5.0 (d = 50):
# GP.set_GPR(images, EMT(), noise_e=0.05/13, noise_f=0.05, nmax=4, lmax=4,
# rcut=5.0) on au_on_al100_images(), then neb_calc(images, GPR(base=EMT(),
# ff=gp, save=False), fmax=0.05, steps=150); CPU float64
W50_THETA = (0.8698952095826656, 1.3658675819155097)
W50_NSTEPS, W50_BARRIER = 21, 0.34955560322852364
W50_COUNTS = (7, 58, 3, 12, 43)   # use_base, use_surrogate, fits, N_E, N_F


def _raw(seed, d):
    """Ragged energy and force points of width d, three elements."""
    rng = np.random.RandomState(seed)
    el = (13, 29, 79)
    fp1, fp2 = make_points(rng, 5, 6, d, el), make_points(rng, 3, 5, d, el)
    ep = [(x, e) for x, _, e in make_points(rng, 3, 7, d, el)]
    return ep, fp1, fp2


def _blocks(seed, d):
    """The same points packed by both packages (float64)."""
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    ep, fp1, fp2 = _raw(seed, d)
    kw = dict(device="cpu", dtype=torch.float64)
    ours = (pack_energy(ep, m_pad=4, a_pad=9, **kw),
            pack_force(fp1, b_pad=8, **kw), pack_force(fp2, b_pad=7, **kw))
    theirs = (jpe(ep, m_pad=4, a_pad=9), jpf(fp1, b_pad=8),
              jpf(fp2, b_pad=7))
    return ours, theirs


def _close(ours, ref, rtol=1e-10):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("mode", ["highest", "bf16x4", "bf16", "f64"])
def test_operands_pad_to_whole_slices(d, mode):
    """Force and energy operands of width d are (4, N, 32 ceil(d / 32))
    (the bf16 parts of a mode (P, 4, N, ...)), the values past d zero, and
    the kernels' side check takes them; a width that is no multiple of 32
    (40) is refused."""
    ep, fp1, _ = _raw(3, d)
    wide = mode == kff.F64
    kw = dict(device="cpu", dtype=torch.float64 if wide else torch.float32)
    e, f = pack_energy(ep, **kw), pack_force(fp1, **kw)
    prec = "highest" if wide else mode
    dp = 32 * -(-d // 32)
    X, re = kff.force_operand(f, prec)
    U, w = kff.energy_operand(e, prec)
    parts = () if prec == "highest" else (1 + (mode == "bf16x4"),)
    assert X.shape == (*parts, 4, f.m * f.x.shape[1], dp)
    assert U.shape == (*parts, e.m * e.x.shape[1], dp)
    assert not kff.dense(X)[..., d:].any() and not kff.dense(U)[..., d:].any()
    kff._check_side(X, re, f.x.shape[1], 4, mode)
    kff._check_side(U, w, e.x.shape[1], 1, mode)
    for op, meta, B, comps in ((X, re, f.x.shape[1], 4),
                               (U, w, e.x.shape[1], 1)):
        narrow = op.new_zeros((*op.shape[:-1], 40))
        with pytest.raises(ValueError, match="multiple of 32"):
            kff._check_side(narrow, meta, B, comps, mode)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("block", ["K1", "K2", "K3", "K_EE"])
@pytest.mark.parametrize("kind", ["rbf", "rbf_dual", "dot"])
def test_plain_blocks_match_jax_at_any_width(d, block, kind):
    """kff_plain (symmetric: K1; rectangular: K3), kef_plain (K2) and
    kee_from_ops against the JAX XLA builds kff_self / kff / kef / kee at
    width d, float64, 1e-10 of max|JAX|; the dual pass against the JAX
    "rbf" and "rbf_dgamma" blocks."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    (e, f1, f2), (je, jf1, jf2) = _blocks(40 + d, d)
    params = DOT_PARAMS if kind == "dot" else PARAMS
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    U, w = kff.energy_operand(e)
    X1, re1 = kff.force_operand(f1)
    X2, re2 = kff.force_operand(f2)
    A, B1, B2 = e.x.shape[1], f1.x.shape[1], f2.x.shape[1]
    dual = kind == "rbf_dual"
    fam = "dot" if kind == "dot" else "rbf"
    kw = dict(kind=fam, dual=dual)
    jkinds = ("rbf", "rbf_dgamma") if dual else (fam,)
    if block == "K1":
        ours = kff.kff_plain(X1, re1, B1, X1, re1, B1, params, 2,
                             symmetric=True, **kw)
        refs = [JK.kff_self(jf1, jp, k, 2) for k in jkinds]
    elif block == "K3":
        ours = kff.kff_plain(X1, re1, B1, X2, re2, B2, params, 2, **kw)
        refs = [JK.kff(jf1, jf2, jp, k, 2) for k in jkinds]
    elif block == "K2":
        ours = kff.kef_plain(U, w, A, X2, re2, B2, params, 2, **kw)
        refs = [JK.kef(je, jf2, jp, k, 2) for k in jkinds]
    else:
        ours = kff.kee_from_ops(U, w, A, U, w, A, params, 2, **kw)
        refs = [JK.kee(je, je, jp, k, 2) for k in jkinds]
    for o, r in zip(ours if dual else (ours,), refs):
        _close(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("d", [33, 64])
def test_tri_operand_holds_one_block_a_slice(d):
    """The k-major copy of a force operand of width dp: dp / 32 blocks of
    kff.TROWS rows, block s the rows c 32 + k = X[c, p B + e, 32 s + k]
    and then the weights and the elements; the envs padded to a multiple
    of four with zeros."""
    _, fp1, _ = _raw(9, d)
    f = pack_force(fp1, device="cpu", dtype=torch.float32)
    X, re = kff.force_operand(f)
    m, B, dp = f.m, f.x.shape[1], X.shape[-1]
    Xt = kff.tri_operand(X, re, B)
    assert Xt.shape == (dp // 32 * kff.TROWS, m, -(-B // 4) * 4)
    rows = X.reshape(4, m, B, dp)
    for s in range(dp // 32):
        blk = Xt[s * kff.TROWS:(s + 1) * kff.TROWS]
        ref = rows[..., 32 * s:32 * (s + 1)].permute(0, 3, 1, 2)
        assert torch.equal(blk[:128, :, :B], ref.reshape(128, m, B))
        assert torch.equal(blk[128:, :, :B], re.reshape(2, m, B))
        assert not blk[:, :, B:].any()


def _jax_atoms(a):
    return J.Atoms(numbers=a.numbers, positions=a.positions,
                   cell=a.cell.array, pbc=a.pbc,
                   constraints=[J.FixAtoms(indices=a.fixed_indices())])


@pytest.fixture(scope="module")
def wide_models():
    """A JAX GP with SO3(nmax=4, lmax=4) (d = 50) fitted at fixed
    hyperparameters on three images, and the port's GP from its state
    refitted on the CPU."""
    images = T.au_on_al100_images()
    jgp = J.GP(kernel=J.RBF(para=list(W50_THETA), zeta=2),
               descriptor=J.SO3(nmax=4, lmax=4, rcut=5.0),
               noise_e=NOISE_E, noise_f=NOISE_F, log_file=None)
    for k in (0, 1, 2):
        a = _jax_atoms(images[k])
        a.calc = J.EMT()
        e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
        a.calc = None
        jgp.add_structure((a, e, f))
    jgp.fit(opt=False, show=False)
    state = convert.state_of(jgp)
    fresh = {k: v for k, v in state.items()
             if k not in ("alpha", "L", "n_fit")}
    tgp = convert.gp_from_state(fresh, device="cpu", log_file=None)
    tgp.fit(opt=False, show=False)
    return images, jgp, tgp, state


def test_fit_at_nmax4_lmax4_matches_jax(wide_models):
    """fit(opt=False) of the d = 50 model: the port's weights are the JAX
    GP's (1e-8 of the largest), on descriptors of width 50."""
    _, _, tgp, state = wide_models
    assert tgp._fit_snapshot[1].x.shape[2] == 50
    _close(tgp.alpha_.numpy(), state["alpha"], rtol=1e-8)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_predict_structure_at_nmax4_lmax4_matches_jax(wide_models, k):
    """predict_structure of the d = 50 model against the JAX GP's: the
    energy and forces at 1e-8 relative, the variances at 1e-8 of the
    largest (the tolerances of test_torch_gp.py)."""
    images, jgp, tgp, _ = wide_models
    E, F, _, sE, sF = tgp.predict_structure(images[k], return_std=True)
    Ej, Fj, _, sEj, sFj = jgp.predict_structure(_jax_atoms(images[k]),
                                                return_std=True)
    assert abs(E - Ej) <= 1e-8 * abs(Ej)
    _close(F, Fj, rtol=1e-8)
    _close(np.r_[sE, np.ravel(sF)] ** 2, np.r_[sEj, np.ravel(sFj)] ** 2,
           rtol=1e-8)


@pytest.fixture(scope="module")
def wide_neb():
    """The port's on-the-fly NEB at nmax 4, lmax 4 on the CPU, float64:
    set_GPR on the five Au/Al(100) images, then neb_calc at its
    defaults."""
    images = T.au_on_al100_images()
    gp = T.GP.set_GPR(images, T.EMT(), noise_e=NOISE_E, noise_f=NOISE_F,
                      nmax=4, lmax=4, rcut=5.0, log_file=None)
    theta = [float(x) for x in gp.kernel.parameters()]
    band = T.neb_calc(images, T.GPR(base=T.EMT(), ff=gp, save=False),
                      fmax=0.05, steps=150)
    e = np.asarray(band.energies, float)
    return dict(theta=theta, converged=bool(band.converged),
                nsteps=band.nsteps,
                counts=(gp.use_base, gp.use_surrogate, gp.fits, gp.N_energy,
                        gp.N_forces),
                barrier=float(e.max() - e[0]),
                width=gp._fit_snapshot[1].x.shape[2])


@pytest.mark.parametrize("what", ["steps", "counts", "barrier", "theta"])
def test_neb_at_nmax4_lmax4_reproduces_jax(wide_neb, what):
    """The d = 50 on-the-fly NEB in the port reproduces the JAX package's
    run: converged in the same steps, the same base/surrogate/fit counts
    and training-set size, set_GPR's theta (1e-6 relative) and the barrier
    within 1e-6 eV."""
    run = wide_neb
    assert run["width"] == 50
    if what == "steps":
        assert run["converged"] and run["nsteps"] == W50_NSTEPS
    elif what == "counts":
        assert run["counts"] == W50_COUNTS
    elif what == "barrier":
        assert abs(run["barrier"] - W50_BARRIER) < 1e-6
    else:
        np.testing.assert_allclose(run["theta"], W50_THETA, rtol=1e-6)


def _brute_ranges(re, B, points, envs):
    """chunk_ranges by a loop over the envs."""
    m = re.shape[1] // B
    nt, nc = -(-m // points), -(-B // envs)
    out = np.empty((nt, nc, 2))
    w, el = re[0].numpy(), re[1].numpy()
    for t in range(nt):
        for c in range(nc):
            hit = [el[p * B + e] for p in range(t * points,
                                                min(m, (t + 1) * points))
                   for e in range(c * envs, min(B, (c + 1) * envs))
                   if w[p * B + e] != 0]
            out[t, c] = (min(hit), max(hit)) if hit else (np.inf, -np.inf)
    return out


@pytest.mark.parametrize("block", ["K1", "K2", "K3"])
def test_f64_kernels_skip_what_mma_pairs_counts(block):
    """The float64 kernels stage a chunk pair when its element ranges
    meet and multiply a warp's 16 x 8 env sub-tile (4 lhs points x 4 envs
    against 2 rhs points x 4 envs; K2: lhs tiles of kff.TP_EF_MMA energy
    points) when one of its env pairs carries a weight on both sides and
    shares an element -- the granularity of the mode kernels, which
    kff.mma_pairs counts: its count against a loop over the grid, on
    float64 metadata (K1: the upper-triangle tile pairs)."""
    rng = np.random.RandomState(17)
    kw = dict(device="cpu", dtype=torch.float64)
    el3 = (13, 29, 79)
    f2 = pack_force(make_points(rng, 19, 13, 40, el3), b_pad=14, **kw)
    _, re2 = kff.force_operand(f2, sort=True)
    B2 = 14
    triangle = block == "K1"
    if block == "K2":
        e1 = pack_energy([(x, e) for x, _, e in
                          make_points(rng, 37, 9, 40, el3)], a_pad=10, **kw)
        _, re1 = kff.energy_operand(e1, sort=True)
        B1, tile1 = 10, kff.TP_EF_MMA
    elif triangle:
        re1, B1, tile1 = re2, B2, kff.TP
    else:
        f1 = pack_force(make_points(rng, 11, 9, 40, el3[:2]), b_pad=11,
                        **kw)
        _, re1 = kff.force_operand(f1, sort=True)
        B1, tile1 = 11, kff.TP
    m1, m2 = re1.shape[1] // B1, re2.shape[1] // B2
    r1 = _brute_ranges(re1, B1, tile1, kff.CB)
    r2 = _brute_ranges(re2, B2, kff.TP, kff.CB)
    w1, el1 = re1[0].numpy(), re1[1].numpy()
    w2, el2 = re2[0].numpy(), re2[1].numpy()
    same = ((w1[:, None] != 0) & (w2[None, :] != 0)
            & (el1[:, None] == el2[None, :]))

    def envs(p0, n_points, m, c, B):
        return [p * B + e for p in range(p0, min(m, p0 + n_points))
                for e in range(c * kff.CB, min(B, (c + 1) * kff.CB))]
    staged = n_pairs = multiplied = n_products = 0
    for t1 in range(r1.shape[0]):
        for t2 in range(r2.shape[0]):
            if triangle and t1 > t2:
                continue
            for c1 in range(r1.shape[1]):
                for c2 in range(r2.shape[1]):
                    n_pairs += 1
                    n_products += (tile1 // 4) * (kff.TP // 2)
                    if (r1[t1, c1, 1] < r2[t2, c2, 0]
                            or r2[t2, c2, 1] < r1[t1, c1, 0]):
                        continue
                    staged += 1
                    for g1 in range(tile1 // 4):
                        a = envs(t1 * tile1 + 4 * g1, 4, m1, c1, B1)
                        for g2 in range(kff.TP // 2):
                            b = envs(t2 * kff.TP + 2 * g2, 2, m2, c2, B2)
                            multiplied += bool(a and b
                                               and same[np.ix_(a, b)].any())
    assert kff.mma_pairs(re1, B1, re2, B2, energy_lhs=block == "K2",
                         triangle=triangle) == \
        (staged, n_pairs, multiplied, n_products)
    assert 0 < multiplied < n_products and staged < n_pairs


def _ks_entry_points():
    """The ``<name>_ks`` extern "C" names of csrc/*.cu, read from the
    sources: each line of an extern "C" block that calls an entry macro
    whose definition makes ``NAME##_ks``, directly or through a
    ``*_FAMILY(SUFFIX, ...)`` macro (expanded over its bases)."""
    names = set()
    for src in sorted(kff.CSRC.glob("*.cu")):
        text = src.read_text()
        macros = dict(re.findall(r"#define (\w+)\(NAME[^)]*\)((?:.*\\\n)*.*)",
                                 text))
        makes_ks = {m for m, body in macros.items() if "NAME##_ks" in body}
        families = {
            m.group(1): [b for mac, b in re.findall(
                r"(\w+_ENTRY)\((\w+)##SUFFIX", m.group(2)) if mac in makes_ks]
            for m in re.finditer(
                r"#define (\w+_FAMILY)\(SUFFIX, PREC\)((?:.*\\\n)*.*)",
                text)}
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"',
                                text, re.S):
            for macro, first in re.findall(r"^(\w+)\((\w+)", block, re.M):
                if macro in makes_ks:
                    names.add(first + "_ks")
                elif macro in families:
                    names.update(b + first + "_ks" for b in families[macro])
    return names


def test_every_width_entry_point_is_in_the_sources():
    """Every entry point the wrappers launch for operands wider than 32 --
    ``<name>_ks`` of each base in highest, in both modes and in float64 --
    is an extern "C" symbol of csrc/, and the loader binds those names
    (``kff._KS_ENTRIES``): the one-slice kernels' sources keep their
    entry points, and the k-slice kernels live in csrc/kff_*_ks.cu
    (kff_f64.cu makes both forms)."""
    names = _ks_entry_points()
    assert set(kff._KS_ENTRIES) == names
    assert len(names) == len(kff.BASES) * len(kff.KERNEL_MODES)
    for mode in kff.KERNEL_MODES:
        src = "kff_f64.cu" if mode == kff.F64 else None
        for base in kff.BASES:
            assert kff.kernel_name(base, mode) + "_ks" in names
        if src:
            assert "NAME##_ks" in (kff.CSRC / src).read_text()
