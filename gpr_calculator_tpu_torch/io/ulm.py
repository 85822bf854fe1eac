"""Minimal ASE-ULM ("- of Ulm") trajectory reader/writer, ASE-free: a copy
of the JAX package's ``io/ulm.py`` (NumPy only) over the port's Atoms.

Layout (reverse-engineered against ase.io.ulm v3 files):
  header : 8B magic '- of Ulm' + 16B tag + int64 {version, nitems, pos0}
  pos0   : int64 offsets[nitems]
  item   : int64 json_len + JSON; arrays appear as
           {"ndarray": [shape, dtype, absolute_offset]} and the owning key
           carries a '.' suffix.  Frames after the first are delta-encoded
           (only changed keys), inheriting the rest from frame 0.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

MAGIC = b"- of Ulm"
TAG = b"ASE-Trajectory  "


def _resolve(obj, buf: bytes):
    if isinstance(obj, dict):
        if "ndarray" in obj and isinstance(obj["ndarray"], list):
            shape, dtype, off = obj["ndarray"]
            count = int(np.prod(shape)) if shape else 1
            arr = np.frombuffer(buf, dtype=np.dtype(dtype), count=count,
                                offset=off)
            return arr.reshape(shape).copy()
        return {k.rstrip("."): _resolve(v, buf) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v, buf) for v in obj]
    return obj


def read_ulm_items(filename: str) -> List[dict]:
    with open(filename, "rb") as fh:
        buf = fh.read()
    if buf[:8] != MAGIC:
        raise ValueError(f"{filename} is not a ULM file")
    version, nitems, pos0 = np.frombuffer(buf[24:48], np.int64)
    offsets = np.frombuffer(buf, np.int64, count=int(nitems),
                            offset=int(pos0))
    items = []
    for off in offsets:
        n = int(np.frombuffer(buf, np.int64, count=1, offset=int(off))[0])
        raw = json.loads(buf[off + 8:off + 8 + n].decode())
        items.append(_resolve(raw, buf))
    return items


def read_traj(filename: str) -> List:
    """Return a list of Atoms frames (delta-encoding merged)."""
    from ..atoms.atoms import Atoms
    from ..atoms.constraints import FixAtoms

    items = read_ulm_items(filename)
    frames = []
    base = items[0] if items else {}
    for item in items:
        # ASE semantics: frame i inherits STATIC data from frame 0 only
        # (numbers, cell, pbc, constraints); a cumulative merge would
        # carry frame i-1's calculator results into an unevaluated
        # frame i
        state = {**base, **item}
        numbers = np.asarray(state["numbers"])
        positions = np.asarray(state["positions"], float)
        cell = np.asarray(state.get("cell", np.zeros((3, 3))), float)
        pbc = np.asarray(state.get("pbc", [False] * 3), bool)
        cons = []
        raw_c = state.get("constraints")
        if raw_c:
            lst = json.loads(raw_c) if isinstance(raw_c, str) else raw_c
            for c in lst:
                if c.get("name") == "FixAtoms":
                    cons.append(FixAtoms(indices=c["kwargs"].get("indices")))
        atoms = Atoms(numbers=numbers, positions=positions, cell=cell,
                      pbc=pbc, constraints=cons,
                      tags=state.get("tags"))
        calc = item.get("calculator")
        if isinstance(calc, dict) and "energy" in calc:
            atoms.info["energy"] = calc.get("energy")
            if "forces" in calc:
                atoms.info["forces"] = np.asarray(calc["forces"])
        frames.append(atoms)
    return frames


class UlmWriter:
    """Incremental ULM trajectory writer (full data per frame -- readable
    by ase.io.read and read_traj).

    Each write() appends the new frame's blobs at the end of the data
    region, then rewrites the (small) offsets table and the header
    counters: O(frame) per write, so long MD/NEB trajectories stay linear.
    mode='a' resumes after the frames already in the file.
    """

    def __init__(self, filename: str, mode: str = "w"):
        self.filename = filename
        self._offsets: List[int] = []
        self._pos = 48  # end of the data region (header size initially)
        if mode == "a" and os.path.exists(filename):
            size = os.path.getsize(filename)
            with open(filename, "rb") as fh:
                head = fh.read(48)
                if head[:8] != MAGIC:
                    raise ValueError(f"{filename} is not a ULM file")
                _, nitems, pos0 = np.frombuffer(head[24:48], np.int64)
                fh.seek(int(pos0))
                self._offsets = [int(o) for o in np.frombuffer(
                    fh.read(8 * int(nitems)), np.int64)]
            table_end = int(pos0) + 8 * int(nitems)
            if table_end >= size:
                # our layout: the offsets table is the last data -- new
                # frames may overwrite it (it is rewritten at the end)
                self._pos = int(pos0)
            else:
                # ASE-written files keep frame data AFTER the table
                # (doubling growth); never overwrite -- append at EOF,
                # leaving the old table bytes as dead space
                self._pos = size + ((-size) % 8)
        else:
            with open(filename, "wb") as fh:
                fh.write(MAGIC + TAG
                         + np.asarray([3, 0, 48], np.int64).tobytes())

    def write(self, atoms):
        pos = self._pos
        blobs = []

        def put_array(arr):
            nonlocal pos
            arr = np.ascontiguousarray(arr)
            pad = (-pos) % 8
            if pad:
                blobs.append(b"\0" * pad)
                pos += pad
            off = pos
            b = arr.tobytes()
            blobs.append(b)
            pos += len(b)
            return {"ndarray": [list(arr.shape), arr.dtype.name, off]}

        item = {}
        item["pbc"] = [bool(b) for b in atoms.pbc]
        item["numbers."] = put_array(np.asarray(atoms.numbers, np.int64))
        item["positions."] = put_array(np.asarray(atoms.positions,
                                                  np.float64))
        item["cell"] = np.asarray(atoms.cell).tolist()
        from ..atoms.constraints import all_fixed_indices
        fixed = all_fixed_indices(atoms)     # works for ase.Atoms too
        if len(fixed):
            item["constraints"] = json.dumps([{
                "name": "FixAtoms",
                "kwargs": {"indices": [int(i) for i in fixed]}}])
        if atoms.info.get("energy") is not None:
            calc = {"name": "unknown", "parameters": {},
                    "energy": float(atoms.info["energy"])}
            if atoms.info.get("forces") is not None:
                calc["forces."] = put_array(
                    np.asarray(atoms.info["forces"], np.float64))
            item["calculator."] = calc

        j = json.dumps(item).encode()
        pad = (-pos) % 8
        if pad:
            blobs.append(b"\0" * pad)
            pos += pad
        offset = pos
        blobs.append(np.int64(len(j)).tobytes())
        blobs.append(j)
        pos += 8 + len(j)
        pad2 = (-pos) % 8
        if pad2:
            blobs.append(b"\0" * pad2)
            pos += pad2

        offsets = self._offsets + [offset]
        with open(self.filename, "r+b") as fh:
            fh.seek(self._pos)
            for b in blobs:
                fh.write(b)
            fh.write(np.asarray(offsets, np.int64).tobytes())
            fh.truncate()
            fh.seek(24)
            fh.write(np.asarray([3, len(offsets), pos],
                                np.int64).tobytes())
        self._offsets = offsets
        self._pos = pos

    def close(self):
        pass
