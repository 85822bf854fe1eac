"""The matmul precision modes of the PyTorch port (gpr_calculator_tpu_torch)
against the JAX package, on the CPU, and the port's repairs around them.

bf16x4 is the exact Gram of the float32 operand rows split into hi + lo
bf16 pairs, bf16 the exact Gram of the rows rounded once to bf16
(gpr_calculator_tpu/ops/kff_pallas.py:38-63).  The split must be the JAX
package's bit for bit (``_lhs_rhs``).  The two packages' float32 rows may
differ in the last bit (the norms are summed in another order), so the
blocks are compared on the same rows: the JAX kernels in interpret mode
read ``_lhs_rhs`` of the port's float32 rows, and the port's float32
plain versions read its parts; 2e-5 max|JAX| + 1e-6, the tolerance of
tests/test_torch_kff.py (float32 with the sums in another order).  The
training covariance is also held against the JAX ``_pallas_self_blocks``
on its own operands, float64 data must ignore the mode, the covariance
stays PSD in every mode, and alpha from bf16x4 stays the float32 one
(tests/test_tpu.py:288-326 on the CPU).  Also the deriv (dK/dgamma
alone) builds, the card-by-default device rule and the port's own copy
of the native source.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpr_calculator_tpu_torch import config, native
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops.packing import EnergyData, ForceData

from test_torch_kff import _data, _jax_blocks, _on_cpu  # noqa: F401 (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = ("bf16x4", "bf16")
RBF = {"sigma": 1.3, "l": 0.9}
DOT = {"sigma": 1.3, "sigma0": 0.7}
D = 30   # descriptor width of the test data


def _bits(t):
    """uint16 bit patterns of a bf16 array of either package."""
    if torch.is_tensor(t):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _crafted(rng, shape):
    """float32 values with zeros, negatives, low 16 mantissa bits all set,
    and bf16 rounding ties (low bits 0x8000, even and odd bit 16)."""
    x = rng.uniform(-2.0, 2.0, shape).astype(np.float32)
    u = x.view(np.uint32)
    kind = rng.randint(0, 5, shape)
    u[kind == 1] |= np.uint32(0xFFFF)
    u[kind == 2] = (u[kind == 2] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    u[kind == 3] = ((u[kind == 3] & np.uint32(0xFFFE0000))
                    | np.uint32(0x18000))
    x[rng.uniform(size=shape) < 0.05] = 0.0
    return x


def _jax_split(X, mode):
    """The JAX package's (hi, lo) or (bf16,) of float32 rows X (.., d)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops.kff_pallas import _lhs_rhs
    d = X.shape[-1]
    lhs, rhs = _lhs_rhs(jnp.asarray(X), mode)
    lhs, rhs = np.asarray(lhs), np.asarray(rhs)
    if mode == "bf16":
        assert np.array_equal(_bits(lhs), _bits(rhs))
        return (lhs[..., :d],)
    # lhs = [hi|hi|lo|lo], rhs = [hi|lo|hi|lo]
    for a, b in ((lhs[..., :d], lhs[..., d:2 * d]),
                 (lhs[..., :d], rhs[..., :d]),
                 (lhs[..., 2 * d:3 * d], rhs[..., d:2 * d])):
        assert np.array_equal(_bits(a), _bits(b))
    return lhs[..., :d], lhs[..., 2 * d:3 * d]


# ---------------------------------------------------------------------------
# (i) the split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_split_is_the_jax_split_bit_for_bit(mode):
    rng = np.random.RandomState(1)
    X = _crafted(rng, (4, 200, D))
    ours = kff.split(torch.from_numpy(X), mode)
    ref = _jax_split(X, mode)
    assert ours.dtype == torch.bfloat16 and len(ours) == len(ref)
    for part, r in zip(ours, ref):
        assert np.array_equal(_bits(part), _bits(r))
    if mode == "bf16x4":
        # hi + lo is exact in float32 and within 2^-16 of x
        xt = kff.dense(ours).numpy()
        assert np.array_equal(
            xt, ours[0].float().numpy() + ours[1].float().numpy())
        assert np.all(np.abs(xt - X) <= 2.0 ** -16 * np.abs(X))


@pytest.mark.parametrize("mode", MODES)
def test_operands_split_their_float32_rows_as_jax_does(mode):
    """force_operand / energy_operand in a mode are the JAX split of the
    port's own float32 rows (before lane padding; the lanes past d are
    zero), and the JAX operand builders' splits agree with them wherever
    the two packages' float32 rows do."""
    from gpr_calculator_tpu.ops import kff_pallas as KP
    e, f1, _, raw = _data(3, torch.float32)
    je, jf1, _ = _jax_blocks(*raw)
    X, re = kff.force_operand(f1, "highest")
    Xm, rem = kff.force_operand(f1, mode)
    U, w = kff.energy_operand(e, "highest")
    Um, wm = kff.energy_operand(e, mode)
    assert torch.equal(re, rem) and torch.equal(w, wm)
    assert kff.operand_precision(Xm) == mode == kff.operand_precision(Um)
    for ours, rows in ((Xm, X), (Um, U)):
        assert ours.shape == (len(_jax_split(rows[..., :D].numpy(), mode)),
                              *rows.shape)
        for part, r in zip(ours, _jax_split(rows[..., :D].numpy(), mode)):
            assert np.array_equal(_bits(part[..., :D]), _bits(r))
            assert not part[..., D:].float().any()
    # against the JAX builders on their own rows (points padded there)
    N = X.shape[1]
    jrows = np.asarray(KP.force_operand(jf1, "highest", 8)[0])[:, :N, :D]
    jlhs = np.asarray(KP.force_operand(jf1, mode, 8)[0])[:, :N]
    jparts = (jlhs[..., :D],) if mode == "bf16" else (jlhs[..., :D],
                                                      jlhs[..., 2 * D:3 * D])
    same = X[..., :D].numpy().view(np.uint32) == jrows.view(np.uint32)
    assert same.mean() > 0.5
    for part, r in zip(Xm, jparts):
        assert np.array_equal(_bits(part[..., :D])[same], _bits(r)[same])


# ---------------------------------------------------------------------------
# (ii) the blocks against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------

def _pad_rows(a, n_rows, axis):
    width = [(0, 0)] * a.ndim
    width[axis] = (0, n_rows - a.shape[axis])
    return np.pad(a, width)


def _jax_force(X, re, B, mode):
    """JAX (lhs, rhs, re) from the port's float32 rows, points padded to
    a multiple of 128 (zero rows carry zero weight)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops.kff_pallas import _lhs_rhs
    m = X.shape[1] // B
    n = -(-m // 128) * 128 * B
    lhs, rhs = _lhs_rhs(jnp.asarray(_pad_rows(X[..., :D].numpy(), n, 1)),
                        mode)
    return lhs, rhs, jnp.asarray(_pad_rows(re.numpy(), n, 1))


def _jax_energy(U, w, A, mode):
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops.kff_pallas import _lhs_rhs
    m = U.shape[0] // A
    n = -(-m // 8) * 8 * A
    lhs, rhs = _lhs_rhs(jnp.asarray(_pad_rows(U[:, :D].numpy(), n, 0)),
                        mode)
    return lhs, rhs, jnp.asarray(_pad_rows(w.numpy().T, n, 0))


def _close(ours, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(ours, np.float64), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("variant", ["rbf", "dual", "deriv", "dot"])
@pytest.mark.parametrize("mode", MODES)
def test_blocks_match_pallas_interpret(mode, variant):
    """K1, K3, K2 and K_EE of one variant (K3-dual among the duals) in
    float32 against the JAX kff_from_ops / kef_from_ops / kee_from_ops
    at the same mode, on the same rows."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kff_pallas as KP
    e, f1, f2, _ = _data(40 + len(variant), torch.float32)
    kind = "dot" if variant == "dot" else "rbf"
    params = DOT if kind == "dot" else RBF
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    flags = dict(dual=variant == "dual", deriv=variant == "deriv",
                 kind=kind)
    zeta = 3 if variant == "deriv" else 2
    A, B1, B2 = e.x.shape[1], f1.x.shape[1], f2.x.shape[1]
    m_e, m1, m2 = e.x.shape[0], f1.x.shape[0], f2.x.shape[0]
    U, w = kff.energy_operand(e, mode)
    X1, re1 = kff.force_operand(f1, mode)
    X2, re2 = kff.force_operand(f2, mode)
    Le, Re, we = _jax_energy(kff.energy_operand(e, "highest")[0], w, A,
                             mode)
    L1, R1, jre1 = _jax_force(kff.force_operand(f1, "highest")[0], re1, B1,
                              mode)
    _, R2, jre2 = _jax_force(kff.force_operand(f2, "highest")[0], re2, B2,
                             mode)
    jkw = dict(zeta=zeta, mode=mode, **flags)
    pairs = [
        (kff.kff_plain(X1, re1, B1, X1, re1, B1, params, zeta,
                       symmetric=True, **flags),
         KP.kff_from_ops(jp, L1, jre1, R1, jre1, B1=B1, B2=B1,
                         interpret=True, symmetric=True, **jkw),
         (3 * m1, 3 * m1)),
        (kff.kff_plain(X1, re1, B1, X2, re2, B2, params, zeta, **flags),
         KP.kff_from_ops(jp, L1, jre1, R2, jre2, B1=B1, B2=B2,
                         interpret=True, symmetric=False, **jkw),
         (3 * m1, 3 * m2)),
        (kff.kef_plain(U, w, A, X2, re2, B2, params, zeta, **flags),
         KP.kef_from_ops(jp, Le, we, R2, jre2, A1=A, B2=B2, interpret=True,
                         **jkw),
         (m_e, 3 * m2)),
        (kff.kee_from_ops(U, w, A, U, w, A, params, zeta, **flags),
         KP.kee_from_ops(jp, Le, Re, we, A1=A, **jkw),
         (m_e, m_e)),
    ]
    for ours, ref, (r, c) in pairs:
        if not flags["dual"]:
            ours, ref = (ours,), (ref,)
        assert len(ours) == len(ref)
        for o, j in zip(ours, ref):
            assert o.dtype == torch.float32
            _close(o.numpy(), np.asarray(j)[:r, :c])


# ---------------------------------------------------------------------------
# (iii) the training covariance against the JAX _pallas_self_blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("highest",) + MODES)
def test_k_self_matches_pallas_self_blocks(mode, monkeypatch):
    """k_self_dual (RBF) and k_self (RBF, Dot) in float32 against the JAX
    training build at the same precision, each package on its own
    operands (GPR_CALC_TPU_KFF_INTERPRET=1, as tests/test_tpu.py:269-274
    sets the mode)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    monkeypatch.setenv("GPR_CALC_TPU_KFF_INTERPRET", "1")
    monkeypatch.setenv("GPR_CALC_TPU_KFF_PRECISION", mode)
    e, f1, _, raw = _data(60, torch.float32)
    je, jf1, _ = _jax_blocks(*raw)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in RBF.items()}
    jd = {k: jnp.asarray(v, jnp.float32) for k, v in DOT.items()}
    ours = TK.k_self_dual(e, f1, RBF, 2, mm_precision=mode)
    refs = JK._pallas_self_blocks(je, jf1, jp, "rbf", 2, dual=True)
    cases = list(zip(ours, refs))
    for kind, p, jpp in (("rbf", RBF, jp), ("dot", DOT, jd)):
        cases.append((TK.k_self(e, f1, p, 2, kind, mm_precision=mode),
                      JK._pallas_self_blocks(je, jf1, jpp, kind, 2,
                                             dual=False)[0]))
    for o, j in cases:
        _close(o.numpy(), j)


# ---------------------------------------------------------------------------
# (iv) PSD, (v) f32-equivalence of bf16x4, (vi) float64 ignores the mode
# ---------------------------------------------------------------------------

def _bench_like(m_e, m_f, envs, dtype, seed=0):
    """tests/test_tpu.py's bench-like synthetic data, in the port."""
    rng = np.random.RandomState(seed)
    e = EnergyData(
        x=torch.as_tensor(rng.uniform(0.2, 1.0, (m_e, envs, D)), dtype=dtype),
        ele=torch.as_tensor(rng.choice([13, 79], (m_e, envs)),
                            dtype=torch.int32),
        counts=torch.full((m_e,), float(envs), dtype=dtype), nreal=m_e)
    f = ForceData(
        x=torch.as_tensor(rng.uniform(0.2, 1.0, (m_f, envs, D)), dtype=dtype),
        dxdr=torch.as_tensor(rng.uniform(-1, 1, (m_f, envs, D, 3)),
                             dtype=dtype),
        ele=torch.as_tensor(rng.choice([13, 79], (m_f, envs)),
                            dtype=torch.int32), nreal=m_f)
    return e, f


@pytest.mark.parametrize("mode", ("highest",) + MODES)
def test_training_covariance_is_psd_and_symmetric(mode):
    """The float32 training covariance (K and dK/dgamma's K plane, RBF
    and Dot) is exactly symmetric with min eigenvalue > -1e-5 max: every
    block is the Gram of the same rounded rows
    (tests/test_kff_pallas.py:169-205)."""
    e, f = _bench_like(6, 12, 8, torch.float32, seed=3)
    for K in (TK.k_self(e, f, RBF, 2, mm_precision=mode),
              TK.k_self(e, f, DOT, 2, "dot", mm_precision=mode),
              TK.k_self_dual(e, f, RBF, 2, mm_precision=mode)[0]):
        assert K.dtype == torch.float32 and torch.equal(K, K.T)
        ev = np.linalg.eigvalsh(K.double().numpy())
        assert ev.min() > -1e-5 * max(1.0, ev.max()), (mode, ev.min())


def test_bf16x4_alpha_is_the_float32_alpha():
    """alpha from the bf16x4 build is within 2e-2 of the highest one and
    below 0.3 x the bf16 gap: the split has not degraded to bf16
    (tests/test_tpu.py:288-326, at a size the CPU runs in seconds)."""
    from gpr_calculator_tpu_torch.models.gp import _noise_diag
    e, f = _bench_like(16, 48, 16, torch.float32)
    y = torch.as_tensor(np.random.RandomState(7).randn(16 + 3 * 48) * 0.1,
                        dtype=torch.float32)
    params = {"sigma": 2.0, "l": 1.0}

    def alpha(mode):
        K = TK.k_self(e, f, params, 2, mm_precision=mode)
        K.diagonal().add_(_noise_diag(e, f, 0.01, 0.1))
        return torch.cholesky_solve(y[:, None],
                                    torch.linalg.cholesky(K))[:, 0]

    a_hi, a_x4, a_b1 = alpha("highest"), alpha("bf16x4"), alpha("bf16")
    rel_x4 = float((a_x4 - a_hi).norm() / a_hi.norm())
    rel_b1 = float((a_b1 - a_hi).norm() / a_hi.norm())
    assert rel_x4 < 2e-2, rel_x4
    assert rel_x4 < 0.3 * max(rel_b1, 1e-9), (rel_x4, rel_b1)


@pytest.mark.parametrize("mode", MODES)
def test_float64_ignores_the_mode(mode):
    e, f1, f2, _ = _data(70, torch.float64)
    X, _ = kff.force_operand(f1, mode)
    assert X.dtype == torch.float64 and torch.equal(
        X, kff.force_operand(f1, "highest")[0])
    for kind, p in (("rbf", RBF), ("dot", DOT), ("rbf_dgamma", RBF)):
        assert torch.equal(TK.k_self(e, f1, p, 2, kind, mm_precision=mode),
                           TK.k_self(e, f1, p, 2, kind,
                                     mm_precision="highest"))
        assert torch.equal(
            TK.k_block(e, f1, e, f2, p, 2, kind, mm_precision=mode),
            TK.k_block(e, f1, e, f2, p, 2, kind, mm_precision="highest"))
    for a, b in zip(TK.k_self_dual(e, f1, RBF, 2, mm_precision=mode),
                    TK.k_self_dual(e, f1, RBF, 2, mm_precision="highest")):
        assert torch.equal(a, b)


def test_the_configured_mode_reaches_every_build():
    """set_kff_precision picks the operands and blocks' mode; an operand
    of another mode makes a wrapper raise; serving's K_EE reads the
    unrounded energy rows, the training K_EE the rounded ones."""
    e, f1, f2, _ = _data(80, torch.float32)
    try:
        config.set_kff_precision("bf16x4")
        assert config.kff_precision() == "bf16x4"
        X, re = kff.force_operand(f1)
        assert kff.operand_precision(X) == "bf16x4"
        K = TK.k_self(e, f1, RBF, 2)
        assert torch.equal(K, TK.k_self(e, f1, RBF, 2, mm_precision="bf16x4"))
        B = f1.x.shape[1]
        with pytest.raises(ValueError, match="operand built in mode"):
            kff.kff_from_ops(X, re, B, X, re, B, RBF, 2,
                             mm_precision="bf16")
        Kb = TK.k_block(e, f1, e, f2, RBF, 2)
    finally:
        config.set_kff_precision("highest")
    m = e.m
    A = e.x.shape[1]
    U, w = kff.energy_operand(e, "highest")
    Um, _ = kff.energy_operand(e, "bf16x4")
    assert torch.equal(Kb[:m, :m], kff.kee_served(U, w, A, U, w, A,
                                                  RBF, 2))
    assert torch.equal(K[:m, :m], kff._mirror(kff.kee_from_ops(
        Um, w, A, Um, w, A, RBF, 2)))
    assert not torch.equal(K[:m, :m], TK.k_self(e, f1, RBF, 2)[:m, :m])


# ---------------------------------------------------------------------------
# (vii) names, (viii) the deriv builds in float64
# ---------------------------------------------------------------------------

def test_unknown_precision_is_rejected():
    e, f1, _, _ = _data(90, torch.float32)
    for call in (lambda: config.set_kff_precision("tf32"),
                 lambda: config.kff_precision("bf16x3"),
                 lambda: kff.force_operand(f1, "float32"),
                 lambda: TK.k_self(e, f1, RBF, 2, mm_precision="fp8")):
        with pytest.raises(ValueError, match="unknown kff matmul precision"):
            call()
    assert config.kff_precision() == "highest"


@pytest.mark.parametrize("zeta", [1, 2, 3])
def test_rbf_dgamma_matches_jax_xla(zeta):
    """k_self / k_block(kind="rbf_dgamma") and the deriv blocks (K3-dual's
    second plane among them) against the JAX XLA builds, float64, 1e-10
    (the JAX ops/kernels.py:97-121 kind)."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kernels as JK
    e, f1, f2, raw = _data(100 + zeta, torch.float64)
    je, jf1, jf2 = _jax_blocks(*raw)
    jp = {k: jnp.asarray(v) for k, v in RBF.items()}
    X1, re1 = kff.force_operand(f1)
    X2, re2 = kff.force_operand(f2)
    B1, B2 = f1.x.shape[1], f2.x.shape[1]
    dual = kff.kff_from_ops(X1, re1, B1, X2, re2, B2, RBF, zeta, dual=True)
    cases = [
        (TK.k_self(e, f1, RBF, zeta, "rbf_dgamma"),
         JK.k_self(je, jf1, jp, "rbf_dgamma", zeta)),
        (TK.k_block(e, f1, e, f2, RBF, zeta, "rbf_dgamma"),
         JK.k_block(je, jf1, je, jf2, jp, "rbf_dgamma", zeta)),
        (kff.kff_from_ops(X1, re1, B1, X2, re2, B2, RBF, zeta, deriv=True),
         JK.kff(jf1, jf2, jp, "rbf_dgamma", zeta)),
        (dual[1], JK.kff(jf1, jf2, jp, "rbf_dgamma", zeta)),
        (dual[0], JK.kff(jf1, jf2, jp, "rbf", zeta)),
    ]
    for ours, ref in cases:
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())
    with pytest.raises(NotImplementedError, match="no dual pass"):
        kff.kef_from_ops(*kff.energy_operand(e), e.x.shape[1], X1, re1, B1,
                         DOT, 2, kind="dot", deriv=True)


# ---------------------------------------------------------------------------
# (ix) the card by default, (x) the native source
# ---------------------------------------------------------------------------

def test_device_raises_without_a_card_unless_the_cpu_is_asked():
    code = (
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "import gpr_calculator_tpu_torch as T\n"
        "from gpr_calculator_tpu_torch import config\n"
        "for call in (config.device, config.dtype,\n"
        "             lambda: T.GP(log_file=None),\n"
        "             lambda: T.SO3().calculate_device(\n"
        "                 T.au_on_al100_images()[0])):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as err:\n"
        "        assert 'set_device' in str(err), err\n"
        "    else:\n"
        "        raise AssertionError('no error without a card')\n"
        "assert T.GP(device='cpu', log_file=None).dtype == torch.float64\n"
        "config.set_device('cpu')\n"
        "assert config.device() == torch.device('cpu')\n"
        "assert config.dtype() == torch.float64\n"
        "assert T.GP(log_file=None).device.type == 'cpu'\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_native_source_is_the_ports_own_copy():
    src = pathlib.Path(native._SRC).resolve()
    port = (ROOT / "gpr_calculator_tpu_torch").resolve()
    assert port in src.parents
    assert src.read_bytes() == (ROOT / "gpr_calculator_tpu" / "native"
                                / "neighbor.cpp").read_bytes()
