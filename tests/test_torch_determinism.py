"""The port's sums over segments add in a fixed order: the SO(3)
descriptor's segment sums and the EMT density, which the on-the-fly runs
read at every step.  On the CPU against a plain loop; ``gpu`` tests hold
the same on the card and two calls bit for bit (skipped without one;
``pytest --noconftest -m gpu`` runs them on a machine without JAX)."""
import numpy as np
import pytest
import torch

import gpr_calculator_tpu_torch as T
from gpr_calculator_tpu_torch import config
from gpr_calculator_tpu_torch.ops.so3 import _segment_sum


def segment_case(seed, sorted_ids):
    rng = np.random.RandomState(seed)
    seg = rng.randint(0, 40, 2000)
    if sorted_ids:
        seg = np.sort(seg)
    return rng.normal(size=(2000, 5, 3)), seg


def loop_sum(vals, seg, nseg):
    out = np.zeros((nseg,) + vals.shape[1:])
    for k, s in enumerate(seg):
        out[s] += vals[k]
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_adds_in_index_order(seed, sorted_ids):
    vals, seg = segment_case(seed, sorted_ids)
    got = _segment_sum(torch.as_tensor(vals), torch.as_tensor(seg), 41)
    np.testing.assert_array_equal(got.numpy(), loop_sum(vals, seg, 41))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sum_on_card_adds_in_index_order(cuda, sorted_ids):
    vals, seg = segment_case(2, sorted_ids)
    got = _segment_sum(torch.as_tensor(vals, device=cuda),
                       torch.as_tensor(seg, device=cuda), 41)
    np.testing.assert_array_equal(got.cpu().numpy(), loop_sum(vals, seg, 41))


@pytest.mark.gpu
def test_descriptor_and_emt_repeat_on_card(cuda):
    slab = T.au_on_al100_images()[1]
    so3 = T.SO3(nmax=3, lmax=4, rcut=5.0)
    one, two = (so3.calculate_device(slab, device=cuda, dtype=torch.float64)
                for _ in range(2))
    for key in ("x", "dxdr"):
        assert torch.equal(one[key], two[key]), key
    config.set_device("cuda")
    try:
        runs = []
        for _ in range(2):
            slab.calc = T.EMT()
            runs.append((slab.get_potential_energy(),
                         slab.get_forces(apply_constraint=False)))
    finally:
        config.set_device(None)
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
