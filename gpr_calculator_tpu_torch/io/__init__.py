"""File IO, copies of the JAX package's modules (NumPy and sqlite3 only):
ASE-compatible trajectories (ULM), sqlite databases, POSCAR."""
from __future__ import annotations

import os

from . import ase_db  # noqa
from .trajectory import Trajectory, TrajectoryWriter  # noqa


def read(filename, index=-1, format=None):
    """ASE-style read dispatch for the formats the framework uses.

    Explicit ``format`` wins; otherwise the extension decides, and the
    POSCAR/CONTCAR convention is checked against the BASENAME only (a
    directory named POSCAR_scan must not hijack a .traj read)."""
    name = str(filename)
    base = os.path.basename(name)
    if format is None:
        if name.endswith(".traj"):
            format = "traj"
        elif name.endswith(".db"):
            format = "db"
        elif name.endswith(".vasp") or base.startswith(("POSCAR",
                                                        "CONTCAR")):
            format = "vasp"
    if format == "traj":
        from .ulm import read_traj
        frames = read_traj(name)
        # a slice selects frames (the JAX package's read returns them all)
        return frames if index == ":" else frames[index]
    if format == "db":
        from .ase_db import read_db
        atoms_list = [r["atoms"] for r in read_db(name)]
        if index == ":":
            return atoms_list
        return atoms_list[index]
    if format == "vasp":
        from .vasp import read_vasp
        return read_vasp(name)
    raise ValueError(f"unsupported file format: {filename}")
