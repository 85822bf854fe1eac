"""A minimal, standalone Atoms container.

The reference framework is an ASE add-on; this framework runs without ASE
(none of ase/pyxtal is required) but stays duck-type compatible with the
subset of the ase.Atoms API it uses, so real ASE objects can be passed in
anywhere ours are accepted.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

CHEMICAL_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
    "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr",
    "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
    "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
    "In", "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf",
    "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po",
    "At", "Rn", "Fr", "Ra", "Ac", "Th", "Pa", "U", "Np", "Pu",
]
ATOMIC_NUMBERS = {s: z for z, s in enumerate(CHEMICAL_SYMBOLS)}

# Standard atomic weights (amu, IUPAC; conventional values for interval
# elements, most-stable-isotope mass for the radioactives).  Used by the
# dynamics drivers (thermostat noise, kinetic energy), not the GPR math
# -- a silent fallback to mass=Z skewed temperatures by sqrt(Z/m).
ATOMIC_MASSES = {
    "H": 1.008, "He": 4.0026, "Li": 6.94, "Be": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.9815, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.098, "Ca": 40.078,
    "Sc": 44.956, "Ti": 47.867, "V": 50.942, "Cr": 51.996, "Mn": 54.938,
    "Fe": 55.845, "Co": 58.933, "Ni": 58.693, "Cu": 63.546, "Zn": 65.38,
    "Ga": 69.723, "Ge": 72.630, "As": 74.922, "Se": 78.971, "Br": 79.904,
    "Kr": 83.798, "Rb": 85.468, "Sr": 87.62, "Y": 88.906, "Zr": 91.224,
    "Nb": 92.906, "Mo": 95.95, "Tc": 97.0, "Ru": 101.07, "Rh": 102.906,
    "Pd": 106.42, "Ag": 107.868, "Cd": 112.414, "In": 114.818,
    "Sn": 118.710, "Sb": 121.760, "Te": 127.60, "I": 126.904,
    "Xe": 131.293, "Cs": 132.905, "Ba": 137.327, "La": 138.905,
    "Ce": 140.116, "Pr": 140.908, "Nd": 144.242, "Pm": 145.0,
    "Sm": 150.36, "Eu": 151.964, "Gd": 157.25, "Tb": 158.925,
    "Dy": 162.500, "Ho": 164.930, "Er": 167.259, "Tm": 168.934,
    "Yb": 173.045, "Lu": 174.967, "Hf": 178.486, "Ta": 180.948,
    "W": 183.84, "Re": 186.207, "Os": 190.23, "Ir": 192.217,
    "Pt": 195.084, "Au": 196.967, "Hg": 200.592, "Tl": 204.38,
    "Pb": 207.2, "Bi": 208.980, "Po": 209.0, "At": 210.0, "Rn": 222.0,
    "Fr": 223.0, "Ra": 226.0, "Ac": 227.0, "Th": 232.038, "Pa": 231.036,
    "U": 238.029, "Np": 237.0, "Pu": 244.0, "Am": 243.0, "Cm": 247.0,
    "Bk": 247.0, "Cf": 251.0, "Es": 252.0, "Fm": 257.0, "Md": 258.0,
    "No": 259.0, "Lr": 262.0,
}


def symbols_to_numbers(symbols) -> np.ndarray:
    out = []
    for s in symbols:
        if isinstance(s, (int, np.integer)):
            out.append(int(s))
        else:
            out.append(ATOMIC_NUMBERS[s])
    return np.asarray(out, dtype=np.int64)


class Cell:
    """3x3 cell with the handful of ASE Cell behaviours we rely on."""

    def __init__(self, array):
        self.array = np.asarray(array, dtype=float).reshape(3, 3)

    def __array__(self, dtype=None, copy=None):
        a = self.array
        if dtype is not None:
            a = a.astype(dtype)
        return np.array(a) if copy else a

    def __getitem__(self, idx):
        return self.array[idx]

    def __setitem__(self, idx, value):
        self.array[idx] = value

    def volume(self) -> float:
        return abs(np.linalg.det(self.array))

    def reciprocal_heights(self) -> np.ndarray:
        """Perpendicular heights of the cell (for image-count estimates)."""
        a = self.array
        vol = abs(np.linalg.det(a))
        if vol == 0:
            return np.zeros(3)
        heights = np.zeros(3)
        for i in range(3):
            cross = np.cross(a[(i + 1) % 3], a[(i + 2) % 3])
            heights[i] = vol / np.linalg.norm(cross)
        return heights


class Atoms:
    """Standalone structure container (positions in Angstrom)."""

    def __init__(self, symbols=None, positions=None, numbers=None,
                 cell=None, pbc=False, constraints=None, tags=None,
                 calc=None):
        if numbers is not None:
            self.numbers = np.asarray(numbers, dtype=np.int64)
        elif symbols is not None:
            if isinstance(symbols, str):
                symbols = _parse_formula(symbols)
            self.numbers = symbols_to_numbers(symbols)
        else:
            self.numbers = np.zeros(0, dtype=np.int64)
        n = len(self.numbers)
        if positions is None:
            positions = np.zeros((n, 3))
        self.positions = np.asarray(positions, dtype=float).reshape(n, 3)
        if cell is None:
            cell = np.zeros((3, 3))
        cell = np.asarray(cell, dtype=float)
        if cell.shape == (3,):
            cell = np.diag(cell)
        self.cell = Cell(cell)
        if isinstance(pbc, (bool, np.bool_)):
            pbc = [pbc] * 3
        self.pbc = np.asarray(pbc, dtype=bool)
        self.constraints = list(constraints or [])
        self.tags = (np.asarray(tags, dtype=np.int64)
                     if tags is not None else np.zeros(n, dtype=np.int64))
        self.calc = calc
        self.info = {}
        self.arrays = {}

    # -- basics ------------------------------------------------------------
    def __len__(self):
        return len(self.numbers)

    @property
    def symbols(self) -> List[str]:
        return [CHEMICAL_SYMBOLS[z] for z in self.numbers]

    def get_chemical_symbols(self):
        return self.symbols

    def get_atomic_numbers(self):
        return self.numbers.copy()

    def get_positions(self):
        return self.positions.copy()

    def set_positions(self, positions, apply_constraint: bool = True):
        # always copy (ASE parity: np.array, not asarray) -- asarray can
        # return a view of the caller's buffer, and adjust_positions below
        # would then write the old fixed coordinates INTO the caller's
        # array (e.g. a.set_positions(b.positions) corrupting b), besides
        # aliasing self.positions to it
        positions = np.array(positions, float).reshape(len(self), 3)
        if apply_constraint:
            # ASE parity: constraints clamp position updates (ase
            # Atoms.set_positions -> constraint.adjust_positions); the
            # plain-calculator NEB/IDPP paths rely on this to keep
            # FixAtoms rows frozen
            for c in self.constraints:
                adj = getattr(c, "adjust_positions", None)
                if adj is not None:
                    adj(self, positions)
        self.positions = positions
        if self.calc is not None and hasattr(self.calc, "results"):
            self.calc.results = {}

    def get_cell(self):
        return self.cell.array.copy()

    def set_cell(self, cell):
        self.cell = Cell(cell)

    def get_volume(self) -> float:
        v = self.cell.volume()
        if v == 0:
            raise ValueError("zero-volume cell")
        return v

    def get_scaled_positions(self, wrap=True) -> np.ndarray:
        inv = np.linalg.inv(self.cell.array)
        sp = self.positions @ inv
        if wrap:
            for i in range(3):
                if self.pbc[i]:
                    sp[:, i] %= 1.0
        return sp

    def get_masses(self):
        out = []
        for z in self.numbers:
            sym = CHEMICAL_SYMBOLS[z]
            if sym not in ATOMIC_MASSES:
                raise NotImplementedError(
                    f"no atomic mass tabulated for element {sym!r}")
            out.append(ATOMIC_MASSES[sym])
        return np.asarray(out)

    def set_constraint(self, constraint=None):
        self.constraints = [] if constraint is None else [constraint]

    def center(self, vacuum=None, axis=(0, 1, 2)):
        if isinstance(axis, int):
            axis = (axis,)
        cell = self.cell.array
        for ax in axis:
            direction = cell[ax]
            norm = np.linalg.norm(direction)
            if norm == 0:
                continue
            unit = direction / norm
            proj = self.positions @ unit
            lo, hi = proj.min(), proj.max()
            if vacuum is not None:
                new_len = hi - lo + 2 * vacuum
                cell[ax] = unit * new_len
                norm = new_len
            shift = (norm - (hi - lo)) / 2.0 - lo
            self.positions += unit * shift
        self.cell = Cell(cell)

    def copy(self) -> "Atoms":
        new = Atoms(numbers=self.numbers.copy(),
                    positions=self.positions.copy(),
                    cell=self.cell.array.copy(),
                    pbc=self.pbc.copy(),
                    constraints=list(self.constraints),
                    tags=self.tags.copy())
        new.info = dict(self.info)
        return new

    def __add__(self, other: "Atoms") -> "Atoms":
        # ASE parity: keep both operands' FixAtoms (right side shifted
        # by len(self)) -- the slab+adsorbate idiom must not silently
        # unfreeze the substrate
        from .constraints import FixAtoms, all_fixed_indices
        fixed = list(all_fixed_indices(self))
        fixed += [int(i) + len(self) for i in all_fixed_indices(other)]
        out = Atoms(
            numbers=np.concatenate([self.numbers, other.numbers]),
            positions=np.vstack([self.positions, other.positions]),
            cell=self.cell.array.copy(), pbc=self.pbc.copy(),
            constraints=[FixAtoms(indices=fixed)] if fixed else None,
            tags=np.concatenate([self.tags, other.tags]))
        out.info.update(self.info)
        return out

    # -- calculator protocol -------------------------------------------------
    def get_potential_energy(self) -> float:
        if self.calc is None:
            raise RuntimeError("no calculator attached")
        return self.calc.get_potential_energy(self)

    def get_forces(self, apply_constraint: bool = True) -> np.ndarray:
        if self.calc is None:
            raise RuntimeError("no calculator attached")
        forces = np.array(self.calc.get_forces(self), dtype=float,
                          copy=True)
        if apply_constraint:
            # ASE parity: ase Atoms.get_forces applies adjust_forces, so
            # FixAtoms rows read zero for ANY calculator (the GPR path
            # zeroes them itself; plain calculators rely on this)
            for c in self.constraints:
                adj = getattr(c, "adjust_forces", None)
                if adj is not None:
                    adj(self, forces)
        return forces

    def fixed_indices(self) -> np.ndarray:
        """UNION of all FixAtoms constraints (a list can carry several)."""
        from .constraints import all_fixed_indices
        return all_fixed_indices(self)

    def set_calculator(self, calc):
        self.calc = calc

    @property
    def number_of_lattice_vectors(self) -> int:
        return int(np.sum(np.any(self.cell.array != 0, axis=1)))


def _parse_formula(formula: str):
    import re
    out = []
    for sym, count in re.findall(r"([A-Z][a-z]?)(\d*)", formula):
        if sym:
            out.extend([sym] * (int(count) if count else 1))
    return out
