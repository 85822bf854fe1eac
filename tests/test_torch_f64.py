"""Float64 on the card: the routing of the port's covariance wrappers to the
hand-written ``_f64`` kernels (``ops/kff.py``, ``csrc/kff_f64.cu``), and a
float64 model carried from the JAX package's default x64 mode.

On the CPU the wrappers take the plain versions; the route they take on
the card is followed here on tensors of the ``meta`` device (no data, no
card), with the device check and the launch replaced: which entry point
a block launches, in which dtype its output is allocated and whether the
float32 K1's k-major copy is built.  The entry points are read from the
CUDA sources.  The kernels themselves run in tests/test_torch_kff.py's
``gpu`` tests and in chip_smoke.py (p1).
"""
import re

import numpy as np
import pytest
import torch

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import config, convert
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops import kff

from test_torch_gp import NOISE_E, NOISE_F, SIGMA, L_SCALE, _jax_atoms
from test_torch_kff import _data, _on_cpu  # noqa: F401 (fixture)

PARAMS = {"sigma": 1.3, "l": 0.9}
DOT = {"sigma": 1.3, "sigma0": 0.7}
K1_BASES = [b for b in kff.BASES if b.startswith("kff_tri")]


def _flags(base):
    dot = base.endswith("_dot")
    return dot, dict(dual=base.endswith("_dual"),
                     deriv=base.endswith("_deriv"),
                     kind="dot" if dot else "rbf")


def _operands(dtype, mode="highest", device="meta"):
    """(U, w, A), (X, re, B) of ``_data``'s energy and first force side,
    built in ``mode`` on the CPU and moved to ``device``."""
    e, f1, _, _ = _data(3, dtype)
    U, w = kff.energy_operand(e, mode)
    X, re_ = kff.force_operand(f1, mode)
    return ((U.to(device), w.to(device), e.x.shape[1]),
            (X.to(device), re_.to(device), f1.x.shape[1]))


@pytest.fixture
def routed(monkeypatch):
    """The wrappers' card route on meta tensors: the device check keeps
    its dtype part alone, and each launch is recorded as (counter name,
    entry-point name) instead of run."""
    calls = []
    monkeypatch.setattr(kff, "_check_cuda",
                        lambda zeta, *t: kff._check_dtypes(*t))

    def launch(base, mode, device, *args, k0=0, nk=0, ldo=0, trans=False,
               ranged=False, dp=kff.DP):
        name = kff.kernel_name(base, mode)
        calls.append((kff.kernel_name(base + "_range", mode) if ranged
                      else name, name))
        kff.launches[calls[-1][0]] += 1
    monkeypatch.setattr(kff, "_launch", launch)
    kff.reset_launches()
    return calls


def _planes(x):
    return x if isinstance(x, tuple) else (x,)


def _call(base, E, F, mode, **kw):
    (U, w, A), (X, re_, B) = E, F
    dot, fl = _flags(base)
    p = DOT if dot else PARAMS
    if base.startswith("kef"):
        return kff.kef_from_ops(U, w, A, X, re_, B, p, 2, mm_precision=mode,
                                **fl, **kw)
    return kff.kff_from_ops(X, re_, B, X, re_, B, p, 2, mm_precision=mode,
                            symmetric=base.startswith("kff_tri"), **fl, **kw)


@pytest.mark.parametrize("mode", config.PRECISIONS)
@pytest.mark.parametrize("base", kff.BASES)
def test_float64_operands_launch_the_f64_kernel_in_every_mode(routed, base,
                                                               mode):
    """Float64 operands launch ``<base>_f64`` whatever the configured
    mode, into float64 outputs, and K1 builds no k-major copy for them;
    float32 operands built in the mode launch the mode's kernel, into
    float32 outputs."""
    E64, F64 = _operands(torch.float64)
    out = _call(base, E64, F64, mode)
    assert all(o.dtype == torch.float64 for o in _planes(out))
    assert routed[-1] == (base + "_f64",) * 2
    assert kff.launches[base + "_f64"] == 1
    assert not hasattr(F64[0], "_kff_tri")
    E32, F32 = _operands(torch.float32, mode)
    out = _call(base, E32, F32, mode)
    assert all(o.dtype == torch.float32 for o in _planes(out))
    assert routed[-1] == (kff.kernel_name(base, mode),) * 2
    # the highest K1 alone reads the k-major copy as its rhs
    tri_copy = base.startswith("kff_tri") and mode == "highest"
    assert hasattr(F32[0], "_kff_tri") == tri_copy
    assert sum(kff.launches.values()) == 2


@pytest.mark.parametrize("mode", config.PRECISIONS)
@pytest.mark.parametrize("base", K1_BASES)
def test_float64_tile_ranges_count_under_the_f64_range_name(routed, base,
                                                            mode):
    """A tile-range launch of a float64 K1 counts under
    ``<base>_range_f64``, into a zeroed float64 output."""
    E64, F64 = _operands(torch.float64)
    _call(base, E64, F64, mode, tiles=(0, 1))
    assert routed == [(f"{base}_range_f64", f"{base}_f64")]
    assert kff.launches == {**dict.fromkeys(kff.launches, 0),
                            f"{base}_range_f64": 1}
    assert kff.kernel_name(base + "_range", kff.F64) in kff.launches


@pytest.mark.parametrize("base", kff.BASES)
def test_float64_and_float32_operands_do_not_mix(routed, base):
    """A float64 side against a float32 one, or float64 operands with
    float32 metadata, raise before a launch; float16 raises too."""
    E64, F64 = _operands(torch.float64)
    E32, F32 = _operands(torch.float32)
    (U, w, A), (X, re_, B) = E64, F64
    dot, fl = _flags(base)
    p = DOT if dot else PARAMS
    with pytest.raises(TypeError):
        if base.startswith("kef"):
            kff.kef_from_ops(U, w, A, F32[0], F32[1], B, p, 2, **fl)
        else:
            kff.kff_from_ops(X, re_, B, F32[0], F32[1], B, p, 2, **fl)
    with pytest.raises(TypeError):
        _call(base, (U, w.float(), A), (X, re_.float(), B), "highest")
    with pytest.raises(TypeError):
        _call(base, (U.half(), w, A), (X.half(), re_, B), "highest")
    assert routed == []


def _entry_points():
    """The extern "C" names of csrc/*.cu, read from the sources: each
    ``*_ENTRY(name, ...)`` line, and each ``*_FAMILY(SUFFIX, ...)`` line
    expanded over the bases its macro lists (``base##SUFFIX``)."""
    names = set()
    for src in sorted(kff.CSRC.glob("*.cu")):
        text = src.read_text()
        families = {
            m.group(1): re.findall(r"_ENTRY\((\w+)##SUFFIX", m.group(2))
            for m in re.finditer(
                r"#define (\w+_FAMILY)\(SUFFIX, PREC\)((?:.*\\\n)*.*)",
                text)}
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"',
                                text, re.S):
            for macro, first in re.findall(r"^(\w+)\((\w+)", block, re.M):
                if macro.endswith("_ENTRY"):
                    names.add(first)
                elif macro in families:
                    names.update(b + first for b in families[macro])
            names.update(re.findall(r"^int (\w+)\(", block, re.M))
    return names


def test_every_selectable_entry_point_is_in_the_sources():
    """Every name the wrappers can launch -- each base in highest, in both
    modes and in float64 -- is an extern "C" entry point of csrc/, the
    twelve ``_f64`` ones in kff_f64.cu, and the library's loader binds
    exactly those names (``kff._ENTRIES``)."""
    names = _entry_points()
    for base in kff.BASES:
        for mode in kff.KERNEL_MODES:
            assert kff.kernel_name(base, mode) in names
            assert kff.kernel_name(base, mode) in kff._ENTRIES
    assert set(kff._ENTRIES) <= names
    assert len(kff._ENTRIES) == len(kff.BASES) * 4
    f64 = (kff.CSRC / "kff_f64.cu").read_text()
    for base in kff.BASES:
        assert re.search(rf"^\w+_ENTRY\({base}_f64,", f64, re.M)
    assert {"kff_empty", "kff_rect_init", "kff_tri_rows"} <= names


@pytest.mark.parametrize("dual", [False, True], ids=["K", "dual"])
def test_self_buffers_take_float64_directly(routed, dual):
    """On a device that is not the CPU (meta here, the card in use) the
    training covariance's buffers take the kernels' blocks straight when
    their dtype is the operands': float64 for float64 data, float32 for
    float32; another dtype takes them by a copy."""
    e, f, _, _ = _data(3, torch.float64)
    like64 = torch.empty(1, dtype=torch.float64, device="meta")
    like32 = torch.empty(1, dtype=torch.float32, device="meta")
    n = 1 + dual
    bufs, direct = TK._self_buffers(e, f, n, torch.float64, like64)
    assert direct and len(bufs) == n
    assert all(b.dtype == torch.float64 and b.device.type == "meta"
               and b.shape == (e.m + 3 * f.m,) * 2 for b in bufs)
    assert TK._self_buffers(e, f, n, torch.float32, like32)[1]
    assert not TK._self_buffers(e, f, n, torch.float64, like32)[1]
    assert not TK._self_buffers(e, f, n, torch.float32, like64)[1]
    cpu = torch.empty(1, dtype=torch.float32)
    assert TK._self_buffers(e, f, n, torch.float64, cpu)[1]


def test_outputs_check_and_allocate_by_the_kernels_dtype():
    """``out=`` on the card must be of the kernels' dtype (float64 for the
    ``_f64`` kernels); new outputs are allocated in it."""
    like = torch.empty(1, dtype=torch.float64, device="meta")
    assert kff._out_dtype(kff.F64) == torch.float64
    assert all(kff._out_dtype(m) == torch.float32 for m in config.PRECISIONS)
    good = torch.empty((6, 9), dtype=torch.float64, device="meta")
    kff._check_out(good, 6, 9, like, torch.float64)
    with pytest.raises(ValueError):
        kff._check_out(good.float(), 6, 9, like, torch.float64)
    with pytest.raises(ValueError):
        kff._check_out(good, 6, 9, like, torch.float32)
    planes = kff._outputs(None, None, 6, 9, True, True, like, torch.float64)
    assert [p.dtype for p in planes] == [torch.float64] * 2
    assert kff._outputs(good, None, 6, 9, False, False, like,
                        torch.float64)[0] is good


def test_float64_out_views_are_written_in_place(routed):
    """K1 and K2 into float64 views of one buffer (``out=``, ``outd=``,
    the transposed K2): the views come back, no copy."""
    (U, w, A), (X, re_, B) = _operands(torch.float64)
    m, mf = U.shape[0] // A, X.shape[1] // B
    buf = torch.empty((2, m + 3 * mf, m + 3 * mf), dtype=torch.float64,
                      device="meta")
    ff, ffd, fe = buf[0, m:, m:], buf[1, m:, m:], buf[0, m:, :m]
    K, Kd = kff.kff_from_ops(X, re_, B, X, re_, B, PARAMS, 2, symmetric=True,
                             dual=True, out=ff, outd=ffd)
    assert K is ff and Kd is ffd
    assert kff.kef_from_ops(U, w, A, X, re_, B, PARAMS, 2, transpose=True,
                            out=fe) is fe
    with pytest.raises(ValueError):
        kff.kef_from_ops(U, w, A, X, re_, B, PARAMS, 2, transpose=True,
                         out=fe.float())
    assert [c[0] for c in routed] == ["kff_tri_dual_f64", "kef_rect_f64"]


@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_kee_served_in_float64_equals_kee_from_ops(kind):
    """In a float64 model the served K_EE is ``kee_from_ops`` bit for bit:
    nothing is rounded (to float32 or otherwise)."""
    e, _, _, _ = _data(4, torch.float64)
    e2, _, _, _ = _data(5, torch.float64)
    p = DOT if kind == "dot" else PARAMS
    U1, w1 = kff.energy_operand(e)
    U2, w2 = kff.energy_operand(e2)
    A1, A2 = e.x.shape[1], e2.x.shape[1]
    served = kff.kee_served(U1, w1, A1, U2, w2, A2, p, 2, kind=kind)
    ref = kff.kee_from_ops(U1, w1, A1, U2, w2, A2, p, 2, kind=kind)
    assert served.dtype == torch.float64 and torch.equal(served, ref)
    served = kff.kee_served(U1, w1, A1, U2, w2, A2, p, 2, kind=kind,
                            dtype=torch.float64)
    assert torch.equal(served, ref)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX package's float64 GP (its default x64 mode) on three images
    of au_on_al100_images(), fitted at the JAX package's (sigma, l)."""
    images = T.au_on_al100_images()
    jgp = J.GP(kernel=J.RBF(para=[SIGMA, L_SCALE], zeta=2),
               descriptor=J.SO3(nmax=3, lmax=4, rcut=5.0),
               noise_e=NOISE_E, noise_f=NOISE_F, log_file=None)
    for k in (0, 4, 2):
        a = _jax_atoms(images[k])
        a.calc = J.EMT()
        e, f = a.get_potential_energy(), a.get_forces(apply_constraint=False)
        a.calc = None
        jgp.add_structure((a, e, f))
    jgp.fit(opt=False, show=False)
    return images, jgp, convert.state_of(jgp)


def _within(ours, ref, tol):
    ours, ref = np.asarray(ours, float), np.asarray(ref, float)
    assert np.abs(ours - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("carried", [True, False],
                         ids=["weights_carried", "refit"])
@pytest.mark.parametrize("k", [1, 3])
def test_float64_model_from_a_jax_state_serves_as_jax(jax_model, carried, k):
    """``convert.gp_from_state(state, dtype=float64)`` of a JAX float64
    model's state (NumPy arrays) serves as the JAX model does, within
    1e-10: with the carried weights and factor, and refit by
    ``fit(opt=False)``; every tensor of the model is float64 (here on the
    CPU through the plain versions; on the card through the ``_f64``
    kernels, chip_smoke.py (p2))."""
    images, jgp, state = jax_model
    if not carried:
        state = {key: v for key, v in state.items()
                 if key not in ("alpha", "L", "n_fit")}
    gp = convert.gp_from_state(state, device="cpu", dtype=torch.float64,
                               log_file=None)
    if not carried:
        gp.fit(opt=False, show=False)
    assert gp.dtype == torch.float64
    assert gp.alpha_.dtype == gp.L_.dtype == torch.float64
    te, tf, _, _ = gp._fit_snapshot
    assert te.x.dtype == tf.x.dtype == tf.dxdr.dtype == torch.float64
    E, F, _, sE, sF = gp.predict_structure(images[k], return_std=True)
    Ej, Fj, _, sEj, sFj = jgp.predict_structure(_jax_atoms(images[k]),
                                                return_std=True)
    assert abs(E - Ej) <= 1e-10 * abs(Ej)
    _within(F, Fj, 1e-10)
    # variances against the request's largest (components of zero prior
    # variance sit at the rounding floor, whose root is not reproducible)
    _within(np.r_[sE, np.ravel(sF)] ** 2, np.r_[sEj, np.ravel(sFj)] ** 2,
            1e-10)
