"""Trajectory interface over the ULM backend (a copy of the JAX package's
``io/trajectory.py``)."""
from __future__ import annotations

from .ulm import UlmWriter, read_traj


class TrajectoryWriter:
    def __init__(self, filename: str, mode: str = "w"):
        # UlmWriter handles mode='a' natively (resumes after the frames
        # already in the file, without re-reading them)
        self._writer = UlmWriter(filename, mode=mode)

    def write(self, atoms):
        # capture last energy/forces if a calculator holds them
        calc = getattr(atoms, "calc", None)
        if calc is not None and getattr(calc, "results", None):
            if "energy" in calc.results:
                atoms.info["energy"] = calc.results["energy"]
            if "forces" in calc.results:
                atoms.info["forces"] = calc.results["forces"]
        self._writer.write(atoms)

    def close(self):
        self._writer.close()


def Trajectory(filename: str, mode: str = "r"):
    if mode == "r":
        return read_traj(filename)
    return TrajectoryWriter(filename, mode=mode)
