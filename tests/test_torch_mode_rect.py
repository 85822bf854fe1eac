"""K3 (kff_rect*) and K2 (kef_rect*) in the bf16x4 and bf16 modes, on the
CPU: what the mode kernels of csrc/kff_rect_mma.cu compute, read and skip.

Every side's envs are sorted by element here (``monkeypatch`` of
``kff.SORT_MIN_ENVS`` to 0), the layout the kernels' element skip works on.
Inputs come from a numpy seed and go through the JAX package and the port.
Tolerances: the port's plain versions against the JAX kernels in interpret
mode at the same mode, on the same rounded rows, 2e-5 max|JAX| + 1e-6 (the
tolerance of tests/test_torch_precision.py: float32 with the sums in
another order); sorted against packed operands 1e-5 max|K| (a permutation
of a point's envs moves only the order of a float32 sum); the served
block in one buffer against the concatenated blocks, bit for bit.  The
kernels themselves are held against these plain versions on the card
(``-m gpu`` in tests/test_torch_kff.py, and chip_smoke.py).
"""
import os
import shutil
import stat

import numpy as np
import pytest
import torch

from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force

from test_torch_kff import _data, _on_cpu  # noqa: F401 (fixture)
from test_torch_precision import _jax_energy, _jax_force
from test_torch_serving_block import _brute_ranges, _points

MODES = ("bf16x4", "bf16")
VARIANTS = ("rbf", "dual", "deriv", "dot")
RBF = {"sigma": 1.3, "l": 0.9}
DOT = {"sigma": 1.3, "sigma0": 0.7}


def _flags(variant):
    return dict(dual=variant == "dual", deriv=variant == "deriv",
                kind="dot" if variant == "dot" else "rbf")


def _planes(x):
    return x if isinstance(x, tuple) else (x,)


def _rect_blocks(e, f1, f2, mode, variant, zeta):
    """K3 (f1 x f2) and K2 (e x f2) of one variant from the plain versions,
    on operands built in ``mode`` with the current sort default."""
    params = DOT if variant == "dot" else RBF
    U, w = kff.energy_operand(e, mode)
    X1, re1 = kff.force_operand(f1, mode)
    X2, re2 = kff.force_operand(f2, mode)
    A, B1, B2 = e.x.shape[1], f1.x.shape[1], f2.x.shape[1]
    fl = _flags(variant)
    return (_planes(kff.kff_plain(X1, re1, B1, X2, re2, B2, params, zeta,
                                  **fl)),
            _planes(kff.kef_plain(U, w, A, X2, re2, B2, params, zeta, **fl)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_sorted_mode_blocks_match_pallas_interpret(mode, variant,
                                                   monkeypatch):
    """K3 and K2 of each variant on sorted operands in float32: the port's
    plain versions on its bf16 parts against the JAX kff_from_ops /
    kef_from_ops in interpret mode at the same mode, on ``_lhs_rhs`` of the
    same sorted rows."""
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops import kff_pallas as KP
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    e, f1, f2, _ = _data(80 + VARIANTS.index(variant), torch.float32)
    params = DOT if variant == "dot" else RBF
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    zeta = 3 if variant == "deriv" else 2
    fl = _flags(variant)
    A, B1, B2 = e.x.shape[1], f1.x.shape[1], f2.x.shape[1]
    _, w = kff.energy_operand(e, mode)
    _, re1 = kff.force_operand(f1, mode)
    _, re2 = kff.force_operand(f2, mode)
    # the sort is the one the mode operands carry: element ids in order
    B = f2.x.shape[1]
    el, wt = re2[1].reshape(-1, B), re2[0].reshape(-1, B)
    key = torch.where(wt != 0, el, torch.full_like(el, 1e9))
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    Le, _, we = _jax_energy(kff.energy_operand(e, "highest")[0], w, A, mode)
    L1, _, jre1 = _jax_force(kff.force_operand(f1, "highest")[0], re1, B1,
                             mode)
    _, R2, jre2 = _jax_force(kff.force_operand(f2, "highest")[0], re2, B2,
                             mode)
    jkw = dict(zeta=zeta, mode=mode, **fl)
    ff, ef = _rect_blocks(e, f1, f2, mode, variant, zeta)
    refs = ((ff, _planes(KP.kff_from_ops(jp, L1, jre1, R2, jre2, B1=B1,
                                         B2=B2, interpret=True,
                                         symmetric=False, **jkw))),
            (ef, _planes(KP.kef_from_ops(jp, Le, we, R2, jre2, A1=A, B2=B2,
                                         interpret=True, **jkw))))
    for ours, theirs in refs:
        assert len(ours) == len(theirs)
        for o, j in zip(ours, theirs):
            ref = np.asarray(j, np.float64)[:o.shape[0], :o.shape[1]]
            assert o.dtype == torch.float32
            np.testing.assert_allclose(o.numpy().astype(np.float64), ref,
                                       rtol=0,
                                       atol=2e-5 * np.abs(ref).max() + 1e-6)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mode", MODES)
def test_sorted_and_packed_mode_blocks_agree(mode, variant, monkeypatch):
    """Sorting each point's envs moves only the order of its float32 sum:
    K3 and K2 from sorted and from packed operands agree to 1e-5 max|K|."""
    e, f1, f2, _ = _data(90 + VARIANTS.index(variant), torch.float32)
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    ours = _rect_blocks(e, f1, f2, mode, variant, 2)
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 10 ** 9)
    packed = _rect_blocks(e, f1, f2, mode, variant, 2)
    for a, b in zip(ours, packed):
        for x, y in zip(a, b):
            scale = float(y.abs().max())
            assert scale > 0
            assert float((x - y).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "packed"])
@pytest.mark.parametrize("energy_lhs", [False, True], ids=["K3", "K2"])
def test_mma_pairs_match_brute_force(energy_lhs, sort):
    """What a mode kernel stages and multiplies, counted by a loop: chunks
    of CB envs of TP lhs points (K2: TP_EF_MMA energy points) against CB
    envs of TP rhs points, staged when their element ranges meet; inside,
    a warp product (4 lhs points x CB envs against 2 rhs points x CB envs)
    multiplied when one of its env pairs carries a weight on both sides
    and shares an element."""
    rng = np.random.RandomState(6)
    kw = dict(device="cpu", dtype=torch.float64)
    el3 = (13, 29, 79)
    f2 = pack_force(_points(rng, 19, 13, el3), m_pad=20, b_pad=14, **kw)
    _, re2 = kff.force_operand(f2, sort=sort)
    B2 = 14
    if energy_lhs:
        e1 = pack_energy([(x, e) for x, _, e in _points(rng, 37, 9, el3)],
                         a_pad=10, **kw)
        _, re1 = kff.energy_operand(e1, sort=sort)
        B1, tile1 = 10, kff.TP_EF_MMA
    else:
        f1 = pack_force(_points(rng, 11, 9, el3[:2]), b_pad=11, **kw)
        _, re1 = kff.force_operand(f1, sort=sort)
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
        for c1 in range(r1.shape[1]):
            for t2 in range(r2.shape[0]):
                for c2 in range(r2.shape[1]):
                    meet = not (r1[t1, c1, 1] < r2[t2, c2, 0]
                                or r2[t2, c2, 1] < r1[t1, c1, 0])
                    n_pairs += 1
                    staged += meet
                    for g1 in range(tile1 // 4):
                        rows = envs(t1 * tile1 + 4 * g1, 4, m1, c1, B1)
                        for g2 in range(kff.TP // 2):
                            cols = envs(t2 * kff.TP + 2 * g2, 2, m2, c2, B2)
                            n_products += 1
                            hit = bool(same[np.ix_(rows, cols)].any()) \
                                if rows and cols else False
                            assert meet or not hit
                            multiplied += meet and hit
    assert kff.mma_pairs(re1, B1, re2, B2, energy_lhs=energy_lhs) == \
        (staged, n_pairs, multiplied, n_products)
    assert 0 < multiplied < n_products
    if sort:
        assert staged < n_pairs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["rbf", "dot"])
def test_k_block_in_one_buffer_in_each_mode(kind, mode, monkeypatch):
    """The served block of a mode on sorted operands, built in one buffer
    (K2 writes K_EF and, transposed, K_FE into their slices; K3 K_FF),
    equals the concatenation of the separately built blocks bit for bit."""
    from test_torch_serving_block import _data as sb_data
    monkeypatch.setattr(kff, "SORT_MIN_ENVS", 0)
    (e1, f1, e2, f2), _ = sb_data(72, torch.float32, 3)
    params = RBF if kind == "rbf" else DOT
    K = TK.k_block(e2, f2, e1, f1, params, 2, kind, mm_precision=mode)
    q = TK.side_operands(e2, f2, mode)
    t = TK.side_operands(e1, f1, mode, "train")
    assert kff.operand_precision(q.X) == mode
    kw = dict(kind=kind, mm_precision=mode)
    ee = kff.kee_served(q.Ue, q.w, q.A, t.Ue, t.w, t.A, params, 2,
                        kind=kind)
    ef = kff.kef_from_ops(q.U, q.w, q.A, t.X, t.re, t.B, params, 2, **kw)
    fe = kff.kef_from_ops(t.U, t.w, t.A, q.X, q.re, q.B, params, 2, **kw).T
    ff = kff.kff_from_ops(q.X, q.re, q.B, t.X, t.re, t.B, params, 2, **kw)
    cat = torch.cat([torch.cat([ee, ef], 1), torch.cat([fe, ff], 1)], 0)
    assert K.is_contiguous() and torch.equal(K, cat)


@pytest.mark.parametrize("mode", MODES)
def test_kef_transpose_into_out_in_each_mode_on_the_cpu(mode):
    """kef_from_ops(transpose=True, out=) in a mode on CPU tensors: the
    plain version's K_EF transposed, written into a slice of a larger
    buffer and nothing else; without out= a new contiguous K_FE."""
    e, _, f2, _ = _data(95, torch.float32)
    U, w = kff.energy_operand(e, mode)
    X, re = kff.force_operand(f2, mode)
    args = (U, w, e.x.shape[1], X, re, f2.x.shape[1], RBF, 2)
    ef = kff.kef_plain(*args)
    buf = torch.full((ef.shape[1] + 3, ef.shape[0] + 2), float("nan"))
    view = buf[1:1 + ef.shape[1], 2:]
    assert kff.kef_from_ops(*args, out=view, transpose=True,
                            mm_precision=mode) is view
    assert torch.equal(view, ef.T)
    assert bool(torch.isnan(buf[0]).all() and torch.isnan(buf[:, :2]).all())
    fe = kff.kef_from_ops(*args, transpose=True, mm_precision=mode)
    assert fe.is_contiguous() and torch.equal(fe, ef.T)
    with pytest.raises(ValueError):
        kff.kef_from_ops(*args, out=torch.empty(ef.shape), transpose=True,
                         mm_precision=mode)


_NVCC_STUB = """#!{python}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open(out, "w") as fh:
    fh.write(" ".join(args))
print("nvcc stub:", " ".join(a for a in args if a.endswith((".cu", ".o"))))
"""


def test_build_names_the_library_by_every_source(tmp_path, monkeypatch):
    """build() compiles every .cu of the source directory on its own and
    links the objects into one library, named by a hash over every source
    and header: a change to any file names a new library; an existing one
    is not built again.  nvcc is replaced by a stub that writes its
    arguments into the output file."""
    import sys
    src = tmp_path / "csrc"
    shutil.copytree(kff.CSRC, src)
    assert [p.name for p in kff.sources()] == sorted(
        p.name for p in kff.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    stub = tmp_path / "nvcc"
    stub.write_text(_NVCC_STUB.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kff, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(kff, "BUILD_DIR", tmp_path / "build")
    cus = sorted(p.name for p in src.glob("*.cu"))
    assert len(cus) >= 4 and (src / "kff_common.cuh").exists()
    lib, log = kff.build(src)
    assert lib.name == kff.library_name(src) and lib.exists()
    for name in cus:
        assert name in log
    linked = lib.read_text().split()
    assert "-shared" in linked
    assert sorted(os.path.basename(a) for a in linked if a.endswith(".o")) \
        == sorted(n[:-3] + ".o" for n in cus)
    assert kff.build(src) == (lib, "")
    names = {lib.name}
    for changed in ("kff_common.cuh", cus[-1]):
        with open(src / changed, "a") as fh:
            fh.write("// edited\n")
        names.add(kff.library_name(src))
    assert len(names) == 3
    assert sorted(os.listdir(tmp_path / "build")) == [lib.name]
