"""The port's SO(3) descriptor against the JAX package's SO3.calculate:
x, dxdr and the seq / centre maps, periodic and not, two elements,
float64, 1e-10 relative."""
import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)


def slab():
    return T.au_on_al100_images()[1]


def cluster():
    rng = np.random.RandomState(2)
    pos = rng.uniform(0.0, 5.0, (7, 3))
    return T.Atoms(numbers=[13, 79, 13, 13, 79, 13, 79], positions=pos)


@pytest.mark.parametrize("make", [slab, cluster])
@pytest.mark.parametrize("settings", [dict(nmax=3, lmax=4, rcut=5.0),
                                      dict(nmax=2, lmax=3, rcut=4.0,
                                           alpha=1.5)])
def test_so3_matches_jax(make, settings):
    a = make()
    ja = J.Atoms(numbers=a.numbers, positions=a.positions,
                 cell=a.cell.array, pbc=a.pbc)
    ours = T.SO3(**settings).calculate(a)
    ref = J.SO3(**settings).calculate(ja)
    assert ours["elements"] == ref["elements"]
    np.testing.assert_array_equal(ours["seq"], ref["seq"])
    for key in ("x", "dxdr"):
        np.testing.assert_allclose(
            ours[key], ref[key], rtol=0,
            atol=1e-10 * np.abs(ref[key]).max())
