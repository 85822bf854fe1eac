"""The port's mesh-sharded builds (gpr_calculator_tpu_torch.parallel) on
meshes of 4 and of 3 CPU shards, against the port's unsharded builds and
against the JAX package.

Inputs come from numpy seeds and go through both packages.  Limits: the
float64 sharded blocks against the port's unsharded ones at 1e-12 max|K|
(the same plain arithmetic; only K_EE's product runs over other shapes)
and against the JAX XLA builds at 1e-10 max|K| (the parity target of every
float64 port test); float32 against the JAX package's own sharded Pallas
build in interpret mode on its virtual mesh at rtol 2e-5 / atol 1e-6 (the
limits of tests/test_torch_kff.py: float32 sums in another order); the
sharded Cholesky against torch.linalg.cholesky at 1e-10.
"""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import config
from gpr_calculator_tpu_torch.ops import kernels as TK
from gpr_calculator_tpu_torch.ops import kff
from gpr_calculator_tpu_torch.ops.packing import pack_energy, pack_force
from gpr_calculator_tpu_torch.parallel import (
    Mesh, cholesky_sharded, k_block_sharded, kef_sharded, kff_sharded,
    make_mesh, partition_tri_tiles, self_blocks_sharded, shard_train_data)
from gpr_calculator_tpu_torch.parallel import sharded_kernels as sk
from gpr_calculator_tpu_torch.parallel.dryrun import dryrun_multichip

from test_torch_kff import _on_cpu, make_points  # noqa: F401 (fixture)

RBF_P = {"sigma": 1.3, "l": 0.9}
DOT_P = {"sigma": 1.3, "sigma0": 0.7}
# (kind, dual, params): the three training builds GP(mesh=...) runs
BUILDS = [("rbf", False, RBF_P), ("rbf", True, RBF_P), ("dot", False, DOT_P)]
BUILD_IDS = ["rbf", "rbf_dual", "dot"]


def cpu_mesh(n):
    return make_mesh(n, ["cpu"] * n)


@pytest.fixture
def gate_off():
    config.set_sharded_gate("off")
    yield
    config.set_sharded_gate("auto")


def _raw(seed, n_f=21, n_e=11):
    """Ragged points: 21 force points (3 tiles a side, 6 upper-triangle
    tiles), 11 energy points (2 tiles), two elements."""
    rng = np.random.RandomState(seed)
    fp = make_points(rng, n_f, 6, 30)
    ep = [(x, el) for x, _, el in make_points(rng, n_e, 7, 30)]
    return ep, fp


def _pack(raw, dtype):
    ep, fp = raw
    kw = dict(device="cpu", dtype=dtype)
    return (pack_energy(ep, m_pad=len(ep) + 1, a_pad=9, **kw),
            pack_force(fp, b_pad=8, **kw))


def _jax_pack(raw, f32=False):
    import jax
    import jax.numpy as jnp
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    ep, fp = raw
    out = jpe(ep, m_pad=len(ep) + 1, a_pad=9), jpf(fp, b_pad=8)
    if f32:
        out = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, out)
    return out


def _jparams(p, dtype=None):
    import jax.numpy as jnp
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the mesh and the partition
# ---------------------------------------------------------------------------

def test_mesh_shards_devices_and_replication():
    mesh = cpu_mesh(4)
    assert isinstance(mesh, Mesh) and mesh.size == 4
    assert mesh.root == torch.device("cpu")
    t = torch.arange(6.0)
    assert all(r is t for r in mesh.replicate(t))
    placed = shard_train_data(mesh, t, t + 1)
    assert len(placed) == 4 and placed[3][1] is not t
    assert torch.equal(placed[2][1], t + 1)
    assert make_mesh(2, ["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="one device per shard"):
        make_mesh(4, ["cpu"])
    with pytest.raises(ValueError):
        Mesh([])


def test_make_mesh_never_falls_to_the_cpu():
    """With no card and no devices named, make_mesh raises; a CUDA device
    that is not present raises too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="not present"):
        make_mesh(2, ["cpu", "cuda:0"])


@pytest.mark.parametrize("n_tiles,n_shards", [
    (6, 4), (6, 3), (36, 4), (70876, 4), (1, 1), (3, 4), (2, 8), (0, 3)])
def test_partition_tri_tiles_ownership(n_tiles, n_shards):
    """Every tile is owned exactly once (the contract of the JAX
    package's test_partition_tri_cells_ownership): the ranges are
    contiguous, disjoint and complete, their sizes differ by at most one,
    also with more shards than tiles."""
    ranges = partition_tri_tiles(n_tiles, n_shards)
    assert len(ranges) == n_shards
    start = 0
    for k0, nk in ranges:
        assert k0 == start and nk >= 0
        start += nk
    assert start == n_tiles
    sizes = [nk for _, nk in ranges]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("n_shards", [4, 3])
@pytest.mark.parametrize("kind,dual,params", BUILDS, ids=BUILD_IDS)
def test_plain_tile_ranges_sum_to_the_whole(n_shards, kind, dual, params):
    """kff_plain(tiles=) over ranges that partition the tiles sums to
    kff_plain exactly (float64, torch.equal): every element lies in one
    upper-triangle tile or its transpose, and is zero in the others."""
    _, f = _pack(_raw(3), torch.float64)
    X, re = kff.force_operand(f)
    B = f.x.shape[1]
    args = (X, re, B, X, re, B, params, 2)
    kw = dict(symmetric=True, kind=kind, dual=dual)
    whole = kff.kff_plain(*args, **kw)
    ranges = partition_tri_tiles(kff.n_tri_tiles(f.m), n_shards)
    assert kff.n_tri_tiles(f.m) == 6
    parts = [kff.kff_plain(*args, tiles=t, **kw) for t in ranges]
    masks = [kff.tile_mask(f.m, t) for t in ranges]
    assert torch.equal(sum(m.int() for m in masks),
                       torch.ones_like(masks[0], dtype=torch.int32))
    for p, plane in enumerate(whole if dual else (whole,)):
        planes = [part[p] if dual else part for part in parts]
        assert torch.equal(sum(planes), plane)
        for pl, m in zip(planes, masks):
            assert not pl[~m].any()
    # the CPU wrapper takes the plain range version
    assert torch.equal(
        kff.kff_from_ops(*args, tiles=ranges[1], symmetric=True, kind=kind),
        kff.kff_plain(*args, tiles=ranges[1], symmetric=True, kind=kind))
    with pytest.raises(ValueError, match="tile range"):
        kff.kff_plain(*args, tiles=(5, 2), **kw)
    with pytest.raises(ValueError, match="symmetric"):
        kff.kff_plain(*args, tiles=(0, 1), kind=kind)


# ---------------------------------------------------------------------------
# the sharded builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zeta", [1, 2, 3])
@pytest.mark.parametrize("kind,dual,params", BUILDS, ids=BUILD_IDS)
def test_self_blocks_sharded_f64(kind, dual, params, zeta):
    """The sharded training build on 4 and on 3 shards against the port's
    unsharded k_self / k_self_dual (1e-12 max|K|) and against the JAX
    package's XLA k_self, float64 (1e-10 max|K|)."""
    from gpr_calculator_tpu.ops import kernels as JK
    raw = _raw(30 + zeta)
    e, f = _pack(raw, torch.float64)
    je, jf = _jax_pack(raw)
    jp = _jparams(params)
    if dual:
        ours = TK.k_self_dual(e, f, params, zeta)
        kinds = ("rbf", "rbf_dgamma")
    else:
        ours = (TK.k_self(e, f, params, zeta, kind),)
        kinds = (kind,)
    refs = [np.asarray(JK.k_self(je, jf, jp, k, zeta, allow_pallas=False))
            for k in kinds]
    for n_shards in (4, 3):
        sk.reset_builds()
        Ks = self_blocks_sharded(e, f, params, kind, zeta, dual,
                                 cpu_mesh(n_shards))
        assert sk.builds["self_blocks"] == 1 and len(Ks) == len(kinds)
        for K, own, ref in zip(Ks, ours, refs):
            assert torch.equal(K, K.T)
            _close(K, own, 1e-12)
            _close(K, ref, 1e-10)


@pytest.mark.parametrize("kind,dual,params,zeta", [
    b + (z,) for b, zs in zip(BUILDS, ((1, 2, 3), (2,), (2,))) for z in zs],
    ids=["rbf-1", "rbf-2", "rbf-3", "rbf_dual-2", "dot-2"])
def test_self_blocks_sharded_f32_matches_sharded_pallas(kind, dual, params,
                                                        zeta):
    """float32 on 4 CPU shards against the JAX package's
    pallas_self_blocks_sharded in interpret mode on its virtual mesh,
    mm_precision="highest": rtol 2e-5 / atol 1e-6."""
    import jax
    from gpr_calculator_tpu.parallel import make_mesh as jax_mesh
    from gpr_calculator_tpu.parallel.sharded_kernels import \
        pallas_self_blocks_sharded
    import jax.numpy as jnp
    raw = _raw(40 + zeta)
    e, f = _pack(raw, torch.float32)
    je, jf = _jax_pack(raw, f32=True)
    refs = pallas_self_blocks_sharded(
        je, jf, _jparams(params, jnp.float32), kind, zeta, dual=dual,
        mesh=jax_mesh(min(8, len(jax.devices()))), interpret=True,
        mm_precision="highest")
    Ks = self_blocks_sharded(e, f, params, kind, zeta, dual, cpu_mesh(4),
                             mm_precision="highest")
    assert len(Ks) == len(refs) == 1 + dual
    for K, ref in zip(Ks, refs):
        np.testing.assert_allclose(K.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=1e-6)


def test_self_blocks_sharded_contracts():
    """Dot with dual raises, as everywhere; data off the mesh's root
    raises; the Dot NLL's float64 K_EE comes through ``dtype``; in a bf16
    mode every shard reads the root's rounded rows (the sharded build is
    the unsharded one, exactly)."""
    e, f = _pack(_raw(5), torch.float32)
    mesh = cpu_mesh(4)
    with pytest.raises(NotImplementedError):
        self_blocks_sharded(e, f, DOT_P, "dot", 2, True, mesh)
    with pytest.raises(ValueError, match="mesh's root"):
        self_blocks_sharded(e, f, RBF_P, "rbf", 2, False,
                            Mesh(["meta", "cpu"]))
    (K,) = self_blocks_sharded(e, f, DOT_P, "dot", 2, False, mesh,
                               dtype=torch.float64)
    assert K.dtype == torch.float64
    _close(K, TK.k_self(e, f, DOT_P, 2, "dot", dtype=torch.float64), 1e-12)
    for mode in ("bf16x4", "bf16"):
        (K,) = self_blocks_sharded(e, f, RBF_P, "rbf", 2, False, mesh,
                                   mm_precision=mode)
        assert torch.equal(K, TK.k_self(e, f, RBF_P, 2, mm_precision=mode))


@pytest.mark.parametrize("kind,params", [("rbf", RBF_P), ("dot", DOT_P)])
def test_k_block_sharded_matches_jax(kind, params):
    """The serving block with the training force axis in column stripes
    (4 and 3 shards; prediction and training env widths differ) against
    the JAX k_block, float64, 1e-10, and the port's unsharded one."""
    from gpr_calculator_tpu.ops import kernels as JK
    from gpr_calculator_tpu.ops.packing import pack_energy as jpe
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    raw = _raw(51)
    rng = np.random.RandomState(52)
    pfp = make_points(rng, 5, 4, 30)
    pep = [(x, el) for x, _, el in make_points(rng, 2, 6, 30)]
    e2, f2 = _pack(raw, torch.float64)
    kw = dict(device="cpu", dtype=torch.float64)
    e1, f1 = pack_energy(pep, **kw), pack_force(pfp, **kw)
    je2, jf2 = _jax_pack(raw)
    ref = np.asarray(JK.k_block(jpe(pep), jpf(pfp), je2, jf2,
                                _jparams(params), kind, 2))
    own = TK.k_block(e1, f1, e2, f2, params, 2, kind)
    for n_shards in (4, 3):
        K = k_block_sharded(e1, f1, e2, f2, params, cpu_mesh(n_shards),
                            kind, 2)
        _close(K, ref, 1e-10)
        _close(K, own, 1e-12)


@pytest.mark.parametrize("n_shards", [4, 3])
def test_row_stripes_stay_on_their_shards(n_shards):
    """kff_sharded / kef_sharded: one row stripe per shard, cut at whole
    8-point tiles; concatenated they are the JAX kff / kef (1e-10) and
    the port's rectangular builds."""
    from gpr_calculator_tpu.ops import kernels as JK
    raw = _raw(61)
    e, f = _pack(raw, torch.float64)
    je, jf = _jax_pack(raw)
    jp = _jparams(RBF_P)
    mesh = cpu_mesh(n_shards)
    ff = kff_sharded(f, RBF_P, mesh, 2)
    ef = kef_sharded(e, f, RBF_P, mesh, 2)
    assert len(ff) == len(ef) == n_shards
    # 21 force points: 3 tiles; 12 energy points (one padded): 2 tiles
    assert [t.shape[0] for t in ff] == [24, 24, 15, 0][:n_shards]
    assert [t.shape[0] for t in ef] == [8, 4, 0, 0][:n_shards]
    _close(torch.cat(ff), JK.kff(jf, jf, jp, "rbf", 2), 1e-10)
    _close(torch.cat(ef), JK.kef(je, jf, jp, "rbf", 2), 1e-10)
    X, re = kff.force_operand(f)
    B = f.x.shape[1]
    _close(torch.cat(ff), kff.kff_plain(X, re, B, X, re, B, RBF_P, 2), 1e-12)


# ---------------------------------------------------------------------------
# the gates and the dispatch
# ---------------------------------------------------------------------------

def test_gates_against_the_jax_gates():
    """The two work-proportionality gates in the port's 8-point tiles
    against the JAX gates' verdicts in its 128-point column blocks: a
    port size m stands for 16 m points there.

    Serving: JAX asks for half a block per device (2 m_jax >= 128 n), the
    port for a stripe of at least half a tile for every shard with the
    stripes cut at whole tiles (2 m >= 8 (2 n - 1)); they agree outside
    n / 2 <= m / 8 < n - 1 / 2.  Training: both refuse a set smaller than
    half a tile / block; above it the JAX gate bounds the recomputation
    of its padded schedule, the port asks for one tile per shard, and
    both pass at production sizes."""
    from gpr_calculator_tpu.ops import kernels as JK
    from gpr_calculator_tpu.ops.packing import pack_force as jpf
    rng = np.random.RandomState(31)
    pts = [(rng.uniform(0.2, 1.0, (4, 6)), rng.uniform(-1, 1, (4, 6, 3)),
            rng.choice([13, 79], 4)) for _ in range(20)]

    def jax_f(m):
        return jpf((pts * (m // 20 + 1))[:m], m_pad=m, b_pad=4)

    assert config.sharded_gate() == "auto"
    scale = 128 // kff.TP
    for n in (2, 4, 8):
        for tiles2 in range(0, 4 * n + 2):           # m in half tiles
            m = tiles2 * kff.TP // 2
            ours = TK._sharded_serving_ok(m, n)
            assert ours == (2 * m >= kff.TP * (2 * n - 1))
            if not n <= tiles2 < 2 * n - 1:
                assert ours == JK._sharded_serving_ok(jax_f(max(m, 1)
                                                            * scale), n), \
                    (m, n)
    # training: padding-dominated sets are refused by both, production
    # sizes pass both (the shapes of the JAX package's gate test)
    assert not TK._sharded_train_ok(3, 4)
    assert not JK._sharded_train_ok(jax_f(3 * scale), 4)
    assert not TK._sharded_train_ok(20, 8)          # 6 tiles, 8 shards
    assert not JK._sharded_train_ok(jax_f(20), 8)
    assert TK._sharded_train_ok(24, 4)              # 6 tiles, 4 shards
    assert TK._sharded_train_ok(260, 8)
    assert JK._sharded_train_ok(jax_f(260), 8)
    assert TK._sharded_train_ok(3000, 4)
    # off: always sharded
    config.set_sharded_gate("off")
    try:
        assert TK._sharded_train_ok(1, 8) and TK._sharded_serving_ok(1, 8)
    finally:
        config.set_sharded_gate("auto")
    with pytest.raises(ValueError):
        config.set_sharded_gate("on")


def test_k_self_mesh_dispatch(gate_off):
    """k_self / k_self_dual / k_block(mesh=) take the sharded routes;
    under the gate a small model builds unsharded on the root; a mesh of
    one shard is no mesh; plain=True with a mesh raises."""
    raw = _raw(71, n_f=5, n_e=3)
    e, f = _pack(raw, torch.float64)
    mesh = cpu_mesh(4)
    sk.reset_builds()
    K = TK.k_self(e, f, RBF_P, 2, mesh=mesh)
    Kk, Kd = TK.k_self_dual(e, f, RBF_P, 2, mesh=mesh)
    Kb = TK.k_block(e, f, e, f, RBF_P, 2, mesh=mesh)
    assert sk.builds == {"self_blocks": 2, "k_block": 1}
    _close(K, TK.k_self(e, f, RBF_P, 2), 1e-12)
    _close(Kk, K, 1e-12)
    _close(Kd, TK.k_self(e, f, RBF_P, 2, "rbf_dgamma"), 1e-12)
    _close(Kb, TK.k_block(e, f, e, f, RBF_P, 2), 1e-12)
    config.set_sharded_gate("auto")          # 5 points: under both gates
    TK.k_self(e, f, RBF_P, 2, mesh=mesh)
    TK.k_self_dual(e, f, RBF_P, 2, mesh=mesh)
    TK.k_block(e, f, e, f, RBF_P, 2, mesh=mesh)
    config.set_sharded_gate("off")
    TK.k_self(e, f, RBF_P, 2, mesh=cpu_mesh(1))
    assert sk.builds == {"self_blocks": 2, "k_block": 1}
    with pytest.raises(ValueError, match="plain=True"):
        TK.k_self(e, f, RBF_P, 2, plain=True, mesh=mesh)


# ---------------------------------------------------------------------------
# the sharded Cholesky
# ---------------------------------------------------------------------------

def _spd(n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n + 16)
    return torch.as_tensor(A @ A.T + n * np.eye(n))


@pytest.mark.parametrize("n,nb", [
    (64, 16),       # several panels per shard
    (100, 16),      # n not a multiple of nb * n_shards
    (256, 32),      # the cases of the JAX package's test
    (48, 64),       # n smaller than one panel
])
def test_cholesky_sharded_matches_dense(n, nb):
    K = _spd(n, seed=n)
    K0 = K.clone()
    ref = torch.linalg.cholesky(K)
    for n_shards in (4, 3, 8):
        L = cholesky_sharded(K, cpu_mesh(n_shards), nb=nb)
        np.testing.assert_allclose(L.numpy(), ref.numpy(), rtol=1e-10,
                                   atol=1e-10)
        assert not torch.triu(L, 1).any()
    assert torch.equal(K, K0)               # the input is left untouched


def test_cholesky_sharded_one_shard_and_failure():
    K = _spd(80, seed=9)
    L = cholesky_sharded(K, cpu_mesh(1), nb=16)
    np.testing.assert_allclose(L.numpy(), torch.linalg.cholesky(K).numpy(),
                               rtol=1e-10, atol=1e-10)
    K[40, 40] = -1.0
    with pytest.raises(torch.linalg.LinAlgError):
        cholesky_sharded(K, cpu_mesh(4), nb=16)
    with pytest.raises(ValueError, match="mesh's root"):
        cholesky_sharded(K, Mesh(["meta", "cpu"]))


def test_chol_mode_thresholds_are_the_jax_ones():
    """_resolve_chol_mode: sharded from 4 shards and 4096 rows unless the
    rows padded to whole panels cost more than the one factor, as the JAX
    package's (its verdicts on a stand-in mesh of the same size), with a
    config setter in place of the environment variable."""
    import types
    from gpr_calculator_tpu.models import gp as jgp
    from gpr_calculator_tpu_torch.models.gp import _resolve_chol_mode
    assert config.sharded_chol() == "auto"
    for n_shards in (1, 2, 3, 4, 8):
        mesh = cpu_mesh(n_shards)
        jmesh = types.SimpleNamespace(
            devices=types.SimpleNamespace(size=n_shards))
        for n in (200, 4095, 4096, 4100, 6000, 10000, 20000):
            assert _resolve_chol_mode(mesh, n) \
                == jgp._resolve_chol_mode(jmesh, n), (n_shards, n)
    assert _resolve_chol_mode(cpu_mesh(4), 10000) == "sharded"
    assert _resolve_chol_mode(cpu_mesh(3), 10000) == "replicated"
    assert _resolve_chol_mode(None, 10000) == "replicated"
    try:
        config.set_sharded_chol("on")
        assert _resolve_chol_mode(cpu_mesh(2), 50) == "sharded"
        assert _resolve_chol_mode(cpu_mesh(1), 50) == "replicated"
        config.set_sharded_chol("off")
        assert _resolve_chol_mode(cpu_mesh(8), 10000) == "replicated"
    finally:
        config.set_sharded_chol("auto")
    with pytest.raises(ValueError):
        config.set_sharded_chol("maybe")


# ---------------------------------------------------------------------------
# GP(mesh=...)
# ---------------------------------------------------------------------------

def _cu_structs(n, natoms, seed):
    """The jittered near-fcc Cu clusters of the JAX package's mesh tests
    (tests/test_gp.py make_structs), as plain arrays."""
    rng = np.random.RandomState(seed)
    a = 2.55
    grid = np.array([[0, 0, 0], [a, 0, 0], [0.5 * a, 0.5 * a, 0],
                     [0, a, 0], [0.5 * a, 0, 0.5 * a],
                     [0, 0.5 * a, 0.5 * a], [a, a, 0], [a, 0, a]])
    return [grid[:natoms] + 0.12 * rng.randn(natoms, 3) for _ in range(n)]


def _fit_port(structs, labels, mesh, kernel="rbf", opt=False):
    k = T.RBF(para=[1.2, 1.0]) if kernel == "rbf" else T.Dot(para=[1.2, 1.0])
    gp = T.GP(kernel=k, descriptor=T.SO3(nmax=2, lmax=2, rcut=4.0),
              noise_e=0.01, noise_f=0.1, log_file=None, device="cpu",
              mesh=mesh)
    for s, (e, f) in zip(structs, labels):
        gp.add_structure((s, e, f))
    gp.fit(show=False, opt=opt)
    return gp


@pytest.fixture(scope="module")
def cu_models():
    """3 Cu5 structures labelled by the JAX EMT, fitted by the JAX
    package with and without its 8-device mesh."""
    import jax
    import gpr_calculator_tpu as J
    from gpr_calculator_tpu.parallel import make_mesh as jax_mesh
    pos = _cu_structs(3, 5, 31)
    kw = dict(numbers=[29] * 5, cell=np.eye(3) * 12, pbc=False)
    jstructs = [J.Atoms(positions=p, **kw) for p in pos]
    tstructs = [T.Atoms(positions=p, **kw) for p in pos]
    calc = J.EMT()
    labels = [(calc.get_potential_energy(s), calc.get_forces(s))
              for s in jstructs]
    jgp = J.GP(kernel=J.RBF(para=[1.2, 1.0]),
               descriptor=J.SO3(nmax=2, lmax=2, rcut=4.0), noise_e=0.01,
               noise_f=0.1, log_file=None,
               mesh=jax_mesh(min(8, len(jax.devices()))))
    for s, (e, f) in zip(jstructs, labels):
        jgp.add_structure((s, e, f))
    jgp.fit(show=False, opt=False)
    return jstructs, tstructs, labels, jgp


@pytest.mark.parametrize("n_shards", [4, 3])
def test_gp_with_mesh_matches_unsharded_and_jax(cu_models, gate_off,
                                                n_shards):
    """GP(mesh=) against GP() in the port (E 1e-9, F 1e-7, the limits of
    the JAX package's own mesh test) and against the JAX GP(mesh=
    make_mesh(8)) on the same structures and labels (1e-8 of the largest
    value, the port's float64 GP parity limit), with the sharded route
    forced: serving and its std, then the sharded Cholesky forced too."""
    jstructs, tstructs, labels, jgp = cu_models
    ref = _fit_port(tstructs, labels, None)
    sk.reset_builds()
    gp = _fit_port(tstructs, labels, cpu_mesh(n_shards))
    assert sk.builds["self_blocks"] >= 1
    config.set_sharded_chol("on")
    try:
        gp_chol = _fit_port(tstructs, labels, cpu_mesh(n_shards))
    finally:
        config.set_sharded_chol("auto")
    for k in range(3):
        E0, F0, _, Es0, Fs0 = ref.predict_structure(tstructs[k],
                                                    return_std=True)
        Ej, Fj, _ = jgp.predict_structure(jstructs[k])
        for model in (gp, gp_chol):
            E1, F1, _, Es1, Fs1 = model.predict_structure(tstructs[k],
                                                          return_std=True)
            np.testing.assert_allclose(E1, E0, rtol=1e-9)
            np.testing.assert_allclose(F1, F0, rtol=1e-7, atol=1e-11)
            np.testing.assert_allclose(Es1, Es0, rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(Fs1, Fs0, rtol=1e-6, atol=1e-9)
            _close(E1, Ej, 1e-8)
            _close(F1, Fj, 1e-8)
    assert sk.builds["k_block"] >= 6


@pytest.mark.parametrize("kernel", ["rbf", "dot"])
def test_gp_fit_with_optimisation_on_a_mesh(cu_models, gate_off, kernel):
    """fit(opt=True) through the sharded analytic NLL of each kernel
    family, with the sharded Cholesky forced: the hyperparameters, the
    NLL and its gradient are the unsharded model's."""
    _, tstructs, labels, _ = cu_models
    config.set_sharded_chol("on")
    try:
        gp = _fit_port(tstructs, labels, cpu_mesh(4), kernel, opt=True)
    finally:
        config.set_sharded_chol("auto")
    ref = _fit_port(tstructs, labels, None, kernel, opt=True)
    np.testing.assert_allclose(gp.kernel.parameters(),
                               ref.kernel.parameters(), rtol=1e-8)
    theta = list(ref.kernel.parameters())
    lml, g = gp.log_marginal_likelihood(theta, eval_gradient=True)
    lml0, g0 = ref.log_marginal_likelihood(theta, eval_gradient=True)
    np.testing.assert_allclose(lml, lml0, rtol=1e-10)
    np.testing.assert_allclose(g, g0, rtol=1e-7, atol=1e-9)
    E1, F1, _ = gp.predict_structure(tstructs[0])
    E0, F0, _ = ref.predict_structure(tstructs[0])
    np.testing.assert_allclose(E1, E0, rtol=1e-8)
    np.testing.assert_allclose(F1, F0, rtol=1e-6, atol=1e-10)


def test_gp_device_must_be_the_mesh_root():
    with pytest.raises(ValueError, match="mesh's root"):
        T.GP(kernel=T.RBF(para=[1.2, 1.0]), log_file=None, device="meta",
             mesh=cpu_mesh(4))
    gp = T.GP(kernel=T.RBF(para=[1.2, 1.0]), log_file=None, device="cpu",
              mesh=cpu_mesh(1))
    assert gp._mesh_arg() is None           # one shard: as no mesh
    assert T.GP(kernel=T.RBF(para=[1.2, 1.0]), log_file=None, device="cpu",
                mesh=cpu_mesh(3))._mesh_arg().size == 3


@pytest.mark.parametrize("n_shards", [4, 3])
def test_dryrun_multichip_on_cpu_shards(n_shards):
    """The port's dry run (the steps and shapes of the JAX package's
    __graft_entry__.dryrun_multichip, its autodiff leg left out)."""
    out = dryrun_multichip(n_shards, devices=["cpu"] * n_shards)
    assert out["devices"] == ["cpu"] * n_shards
    assert np.isfinite(out["nll"]) and out["k_self_err"] < 1e-12
    assert out["chol_err"] < 1e-10 and out["serve_err"] < 1e-12
    assert config.sharded_gate() == "auto"
