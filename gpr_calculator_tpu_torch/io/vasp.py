"""POSCAR/CONTCAR reader & writer (VASP 5 format); a copy of the JAX
package's ``io/vasp.py`` over the port's Atoms."""
from __future__ import annotations

import numpy as np

from ..atoms.atoms import Atoms, ATOMIC_NUMBERS


def read_vasp(filename: str):
    with open(filename) as fh:
        lines = [ln.rstrip("\n") for ln in fh]
    scale = float(lines[1].split()[0])
    cell = np.array([[float(x) for x in lines[2 + i].split()[:3]]
                     for i in range(3)])
    if scale < 0:  # negative => target volume
        vol = abs(np.linalg.det(cell))
        scale = (-scale / vol) ** (1.0 / 3.0)
    cell = cell * scale
    symbols = lines[5].split()
    counts = [int(x) for x in lines[6].split()]
    idx = 7
    selective = False
    if lines[idx].strip() and lines[idx].strip()[0] in "Ss":
        selective = True
        idx += 1
    direct = lines[idx].strip()[0] not in "CcKk"
    idx += 1
    natoms = sum(counts)
    pos = np.zeros((natoms, 3))
    fixed = []
    for i in range(natoms):
        parts = lines[idx + i].split()
        pos[i] = [float(x) for x in parts[:3]]
        if selective and len(parts) >= 6:
            if all(p.upper().startswith("F") for p in parts[3:6]):
                fixed.append(i)
    if direct:
        pos = pos @ cell
    else:
        pos = pos * scale
    numbers = []
    for s, c in zip(symbols, counts):
        numbers.extend([ATOMIC_NUMBERS[s]] * c)
    atoms = Atoms(numbers=numbers, positions=pos, cell=cell,
                  pbc=[True, True, True])
    if fixed:
        from ..atoms.constraints import FixAtoms
        atoms.set_constraint(FixAtoms(indices=fixed))
    return atoms


def write_vasp(filename: str, atoms):
    symbols = atoms.symbols
    uniq = []
    for s in symbols:
        if not uniq or uniq[-1][0] != s:
            uniq.append([s, 0])
        uniq[-1][1] += 1
    with open(filename, "w") as fh:
        fh.write("generated by gpr_calculator_tpu_torch\n1.0\n")
        for row in np.asarray(atoms.cell):
            fh.write("  {:.16f} {:.16f} {:.16f}\n".format(*row))
        fh.write(" ".join(u[0] for u in uniq) + "\n")
        fh.write(" ".join(str(u[1]) for u in uniq) + "\n")
        from ..atoms.constraints import all_fixed_indices
        fixed = set(int(i) for i in all_fixed_indices(atoms))
        if fixed:
            # keep the read_vasp <-> write_vasp round trip symmetric:
            # FixAtoms rows become "F F F" selective-dynamics flags
            fh.write("Selective dynamics\n")
        fh.write("Cartesian\n")
        for i, p in enumerate(atoms.positions):
            line = "  {:.16f} {:.16f} {:.16f}".format(*p)
            if fixed:
                line += "  F F F" if i in fixed else "  T T T"
            fh.write(line + "\n")
