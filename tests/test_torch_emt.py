"""The port's EMT (torch, autograd forces) against the JAX package's EMT,
float64, 1e-10 relative."""
import numpy as np
import pytest

import gpr_calculator_tpu as J
import gpr_calculator_tpu_torch as T

from test_torch_kff import _on_cpu  # noqa: F401 (fixture)


def slab():
    return T.au_on_al100_images()[2]


def cluster():
    """A random non-periodic Cu/Au cluster with no pair closer than 2.2 A."""
    rng = np.random.RandomState(4)
    pos = []
    while len(pos) < 9:
        p = rng.uniform(0.0, 6.0, 3)
        if all(np.linalg.norm(p - q) > 2.2 for q in pos):
            pos.append(p)
    return T.Atoms(numbers=rng.choice([29, 79], len(pos)), positions=pos)


def to_jax(a):
    return J.Atoms(numbers=a.numbers, positions=a.positions,
                   cell=a.cell.array, pbc=a.pbc)


@pytest.mark.parametrize("make", [slab, cluster])
def test_emt_matches_jax(make):
    a = make()
    ja = to_jax(a)
    a.calc, ja.calc = T.EMT(), J.EMT()
    E, F = a.get_potential_energy(), a.get_forces(apply_constraint=False)
    Ej, Fj = ja.get_potential_energy(), ja.get_forces(apply_constraint=False)
    assert abs(E - Ej) <= 1e-10 * abs(Ej)
    np.testing.assert_allclose(F, Fj, rtol=0, atol=1e-10 * np.abs(Fj).max())
