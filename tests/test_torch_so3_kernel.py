"""The SO(3) descriptor kernels (csrc/so3.cu, ``SO3._core`` on a card).

On the CPU: ``kernel_inputs``, the host layout the kernels walk -- each
centre's pairs in the order ``_segment_sum`` adds them, every pair's
output row (pairs outside an ``atom_ids`` selection at -1, the plain
version's spare row), the rows of each centre, its self row, the zero pad
row after each structure, and the two upload buffers.  ``gpu`` tests hold
the kernels to the plain ``_so3_core`` on the same card (``_core_plain``)
-- x, dxdr and the strain rows, every case one ``_core`` call of at most
4 launches -- and two calls bit for bit (skipped without a card;
``pytest --noconftest -m gpu`` runs them on a machine without JAX).

Tolerances, relative to max|plain|: float64 1e-12 -- the same arithmetic
in another order (the quadrature's node sums, c_tot contracted before
the pair's dc, m < 0 counted as twice m > 0), rounding at ~1e-15 of the
largest entry; float32 2e-5 -- float32 rounding in another order over
~80-node and ~30-pair sums, ~4e-7 of the largest entry."""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import utils_profiling
from gpr_calculator_tpu_torch.ops import so3 as so3_mod


def images():
    return T.au_on_al100_images()


def cluster():
    rng = np.random.RandomState(2)
    pos = rng.uniform(0.0, 5.0, (7, 3))
    return T.Atoms(numbers=[13, 79, 13, 13, 79, 13, 79], positions=pos)


def preps_of(so3, strucs, atom_ids=None):
    return [so3._prep_structure(a, atom_ids) for a in strucs]


# ---------------------------------------------------------------------------
# the host layout (CPU)
# ---------------------------------------------------------------------------

LAYOUTS = {
    "slab": lambda: (T.SO3(nmax=3, lmax=4, rcut=5.0), images()[1:2], None),
    "selection": lambda: (T.SO3(nmax=3, lmax=4, rcut=5.0), images()[1:3],
                          [1, 4, 9, 12]),
    "band_stress": lambda: (T.SO3(nmax=2, lmax=3, rcut=4.0, stress=True),
                            images()[:3], None),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_kernel_inputs_walk_pairs_in_segment_sum_order(case):
    so3, strucs, atom_ids = LAYOUTS[case]()
    preps = preps_of(so3, strucs, atom_ids)
    ints, flts, fields, ao, ro = so3_mod.kernel_inputs(
        preps, so3._q, so3._G0, so3.stress)
    assert ints.dtype == np.int64 and flts.dtype == np.float64

    def get(buf, name):
        off, n = fields[name]
        return buf[off:off + n]

    natoms = int(ao[-1])
    so = np.cumsum([0] + [p["nseq"] for p in preps])
    assert list(ro) == list(so + np.arange(len(so)))
    # the plain version's global indices: centre, seq row (spare: -1)
    centre = np.concatenate([p["pair_center"] + ao[k]
                             for k, p in enumerate(preps)])
    seq = np.concatenate([np.where(p["pair_seq"] < 0, -1,
                                   p["pair_seq"] + so[k])
                          for k, p in enumerate(preps)])
    assert (seq < 0).any() == (atom_ids is not None)
    perm, poff, prow = (get(ints, k) for k in ("perm", "poff", "prow"))
    rbeg, rend, self_row, pad_row = get(ints, "rows").reshape(4, natoms)
    assert len(perm) == len(prow) == len(centre)
    assert len(ints) == sum(n for k, (_, n) in fields.items()
                            if k in ("perm", "poff", "prow", "rows"))
    # the CSR walk: each centre's pairs, in the order _segment_sum adds
    # them (index order)
    walked = []
    for a in range(natoms):
        mine = perm[poff[a]:poff[a + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(centre == a))
        walked.extend(mine)
    assert poff[0] == 0 and poff[-1] == len(perm)
    # output rows: structure k's seq row s at s - so[k] + ro[k]
    out_row = np.concatenate([np.arange(so[k], so[k + 1]) + k
                              for k in range(len(preps))])
    np.testing.assert_array_equal(prow[seq < 0], -1)
    np.testing.assert_array_equal(prow[seq >= 0], out_row[seq[seq >= 0]])
    for s in range(int(so[-1])):
        order = [p for p in walked if prow[p] == out_row[s]]
        np.testing.assert_array_equal(order, np.flatnonzero(seq == s))
    # each centre's rows, its self row, the pad rows: every output row once
    covered = np.zeros(int(ro[-1]), int)
    seq_centre = np.concatenate([p["seq"][:, 0] + ao[k]
                                 for k, p in enumerate(preps)])
    for a in range(natoms):
        covered[rbeg[a]:rend[a]] += 1
        rows_a = out_row[seq_centre == a]
        np.testing.assert_array_equal(np.arange(rbeg[a], rend[a]), rows_a)
        if rbeg[a] == rend[a]:
            assert self_row[a] == -1
            assert not np.isin(np.flatnonzero(centre == a),
                               np.flatnonzero(seq >= 0)).any()
        else:
            assert rbeg[a] <= self_row[a] < rend[a]
    np.testing.assert_array_equal(np.flatnonzero(pad_row >= 0), ao[:-1])
    covered[pad_row[pad_row >= 0]] += 1
    np.testing.assert_array_equal(covered, 1)
    # the float buffer
    np.testing.assert_array_equal(
        get(flts, "rij"), np.concatenate([p["rij"] for p in preps]).ravel())
    np.testing.assert_array_equal(get(flts, "w"),
                                  np.concatenate([p["w"] for p in preps]))
    np.testing.assert_array_equal(get(flts, "q"), so3._q)
    np.testing.assert_array_equal(get(flts, "G0"), so3._G0.ravel())
    assert ("scale" in fields) == so3.stress
    if so3.stress:
        np.testing.assert_array_equal(
            get(flts, "Rj"), np.concatenate([p["Rj"] for p in preps]).ravel())
        np.testing.assert_array_equal(
            get(flts, "scale"), np.repeat([-1.0 / p["volume"] for p in preps],
                                          np.diff(ao)))


def test_kernel_inputs_refuse_unsorted_seq_rows():
    so3 = T.SO3(nmax=2, lmax=2, rcut=4.0)
    prep = so3._prep_structure(cluster())
    prep["seq"] = prep["seq"][::-1]
    with pytest.raises(ValueError, match="sorted by centre"):
        so3_mod.kernel_inputs([prep], so3._q, so3._G0, False)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


F64 = torch.float64
SLAB = dict(nmax=3, lmax=4, rcut=5.0)
CASES = {
    "slab": lambda: (T.SO3(**SLAB), images()[1:2], None, F64),
    "band5": lambda: (T.SO3(**SLAB), images()[:5], None, F64),
    "cluster": lambda: (T.SO3(**SLAB), [cluster()], None, F64),
    "atom_ids": lambda: (T.SO3(**SLAB), images()[1:2], [1, 4, 9, 12], F64),
    "weight_on": lambda: (T.SO3(weight_on=True, **SLAB), images()[1:2],
                          None, F64),
    "stress": lambda: (T.SO3(stress=True, **SLAB), images()[1:3], None,
                       F64),
    "no_derivative": lambda: (T.SO3(derivative=False, **SLAB),
                              images()[1:2], None, F64),
    "nmax4_lmax4": lambda: (T.SO3(nmax=4, lmax=4, rcut=5.0), images()[1:2],
                            None, F64),
    "lmax12": lambda: (T.SO3(nmax=2, lmax=12, rcut=4.0, alpha=1.5),
                       [cluster()], None, F64),
    "float32": lambda: (T.SO3(**SLAB), images()[1:2], None, torch.float32),
    # the largest shape SO3 admits: c_tot takes 110 KB of shared memory
    "nmax11_lmax32": lambda: (T.SO3(nmax=11, lmax=32, rcut=3.0),
                              [cluster()], None, F64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_on_card(cuda, case):
    so3, strucs, atom_ids, dt = CASES[case]()
    preps = preps_of(so3, strucs, atom_ids)
    so3_mod.reset_launches()
    got = so3._core(preps, cuda, dt)
    torch.cuda.synchronize()
    assert so3_mod.launches == {"so3_pair": 1, "so3_centre": 1}
    ref = so3._core_plain(preps, cuda, dt)
    tol = 1e-12 if dt == F64 else 2e-5
    for name, g, r in zip(("x", "dxdr", "rdxdr"), got[:3], ref[:3]):
        assert (g is None) == (r is None), name
        if r is None:
            continue
        assert g.dtype == dt and g.shape == r.shape, name
        err = (g - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), (name, err)
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[4], ref[4])


@pytest.mark.gpu
def test_kernels_repeat_bit_for_bit_on_card(cuda):
    so3 = T.SO3(stress=True, **SLAB)
    preps = preps_of(so3, images()[:3])
    one, two = (so3._core(preps, cuda, F64) for _ in range(2))
    for a, b in zip(one[:3], two[:3]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_served_descriptors_take_the_kernels_on_card(cuda):
    """A served band's descriptors: one ``_core`` call of two launches,
    counted by ``descriptor.kernel``; each structure's dxdr a view of the
    call's buffer with its zero pad row."""
    so3 = T.SO3(**SLAB)
    band = images()[:5]
    so3_mod.reset_launches()
    utils_profiling.enable()
    try:
        before = utils_profiling.counters.get("descriptor.kernel", 0)
        descs = so3.calculate_many_device(band, device=cuda, dtype=F64,
                                          pair_budget=float("inf"))
        assert utils_profiling.counters["descriptor.kernel"] == before + 1
    finally:
        utils_profiling.disable()
    assert so3_mod.launches == {"so3_pair": 1, "so3_centre": 1}
    base = descs[0]["dxdr"].untyped_storage().data_ptr()
    for d in descs:
        assert d["dxdr"].untyped_storage().data_ptr() == base
        assert d["dxdr"].shape[0] == d["nseq"] + 1
        assert not d["dxdr"][d["nseq"]].any()


@pytest.mark.gpu
def test_bytes_per_pair_measures_the_kernels_on_card(cuda):
    """The ingest's pair budget follows the kernels' memory: a few KB a
    pair (the plain version's 32 986 at nmax 3, lmax 4)."""
    so3 = T.SO3(**SLAB)
    so3_mod.reset_launches()
    per_pair = so3.bytes_per_pair(cuda)
    assert so3_mod.launches == {"so3_pair": 1, "so3_centre": 1}
    assert 0 < per_pair < 8000
