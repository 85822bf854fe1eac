"""Read/write ASE-SQLite-compatible structure databases without ASE.

The reference persists training structures through ase.db
(gaussianprocess.py:689-724 export, :726-821 ingest).  This module speaks the
same on-disk format (schema version 9):

  * ``systems`` table with raw little-endian buffers: numbers (int32),
    positions/cell (float64), pbc bitfield, constraints JSON;
  * the ``data`` column encoded by ASE's object_to_bytes framing:
    [int64 offset][raw ndarray buffers][JSON], where ndarrays appear in the
    JSON as {"__ndarray__": [shape, dtype, buffer_offset]}.

so model artifacts interoperate in both directions with the reference
(e.g. examples/database/pd4-RBF.db loads directly).
"""
from __future__ import annotations

import json
import os
import sqlite3
import time
from typing import List

import numpy as np

from ..atoms.atoms import Atoms
from ..atoms.constraints import FixAtoms


# ---------------------------------------------------------------------------
# ASE object_to_bytes / bytes_to_object framing
# ---------------------------------------------------------------------------

def bytes_to_object(b: bytes):
    offset = int(np.frombuffer(b[:8], np.int64)[0])
    obj = json.loads(b[offset:].decode())
    return _b2o(obj, b)


def _b2o(obj, b: bytes):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            shape, dtype, off = obj["__ndarray__"]
            arr = np.frombuffer(
                b, dtype=np.dtype(dtype),
                count=int(np.prod(shape)) if shape else 1, offset=off)
            return arr.reshape(shape).copy()
        return {k: _b2o(v, b) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_b2o(v, b) for v in obj]
    return obj


def object_to_bytes(obj) -> bytes:
    parts: List[bytes] = [b"        "]  # placeholder for the offset

    def o2b(o):
        if isinstance(o, np.ndarray):
            offset = sum(len(p) for p in parts)
            assert offset % 8 == 0
            parts.append(np.ascontiguousarray(o).tobytes())
            pad = (-len(parts[-1])) % 8
            if pad:
                parts.append(b"\0" * pad)
            return {"__ndarray__": [list(o.shape), o.dtype.name, offset]}
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, (np.bool_,)):
            return bool(o)
        if isinstance(o, dict):
            return {k: o2b(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [o2b(v) for v in o]
        return o

    tail = o2b(obj)
    offset = sum(len(p) for p in parts)
    parts[0] = np.int64(offset).tobytes()
    parts.append(json.dumps(tail, separators=(",", ":")).encode())
    return b"".join(parts)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

_INIT = [
    """CREATE TABLE systems (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    unique_id TEXT UNIQUE,
    ctime REAL, mtime REAL, username TEXT,
    numbers BLOB, positions BLOB, cell BLOB, pbc INTEGER,
    initial_magmoms BLOB, initial_charges BLOB, masses BLOB, tags BLOB,
    momenta BLOB, constraints TEXT,
    calculator TEXT, calculator_parameters TEXT,
    energy REAL, free_energy REAL, forces BLOB, stress BLOB,
    dipole BLOB, magmoms BLOB, magmom REAL, charges BLOB,
    key_value_pairs TEXT, data BLOB,
    natoms INTEGER, fmax REAL, smax REAL,
    volume REAL, mass REAL, charge REAL)""",
    "CREATE TABLE species (Z INTEGER, n INTEGER, id INTEGER)",
    "CREATE TABLE keys (key TEXT, id INTEGER)",
    "CREATE TABLE text_key_values (key TEXT, value TEXT, id INTEGER)",
    "CREATE TABLE number_key_values (key TEXT, value REAL, id INTEGER)",
    "CREATE TABLE information (name TEXT, value TEXT)",
    "INSERT INTO information VALUES ('version', '9')",
]


def _blob(arr):
    if arr is None:
        return None
    arr = np.ascontiguousarray(arr)
    return sqlite3.Binary(arr.tobytes())


def write_db(filename: str, rows: List[dict], permission: str = "w"):
    """rows: dicts with 'atoms', optional 'data', 'key_value_pairs'."""
    if permission == "w" and os.path.exists(filename):
        os.remove(filename)
    new = not os.path.exists(filename)
    con = sqlite3.connect(filename)
    try:
        if new:
            for stmt in _INIT:
                con.execute(stmt)
        for k, row in enumerate(rows):
            atoms = row["atoms"]
            numbers = np.asarray(atoms.numbers, np.int32)
            positions = np.asarray(atoms.positions, np.float64)
            cell = np.asarray(np.asarray(atoms.cell), np.float64)
            pbc = int(sum(int(b) << i for i, b in enumerate(atoms.pbc)))
            from ..atoms.constraints import all_fixed_indices
            constraints = None
            fixed = all_fixed_indices(atoms)   # works for ase.Atoms too
            if len(fixed):
                constraints = json.dumps([{
                    "name": "FixAtoms",
                    "kwargs": {"indices": [int(i) for i in fixed]}}])
            data_blob = (sqlite3.Binary(object_to_bytes(row["data"]))
                         if row.get("data") else None)
            kvp = json.dumps(row.get("key_value_pairs", {}))
            vol = None
            try:
                vol = float(abs(np.linalg.det(cell)))
            except Exception:
                pass
            # ASE stores ctime/mtime in YEARS SINCE 2000 (ase.db.core:
            # now() = (time()-T2000)/YEAR), not Unix seconds -- rows
            # written in seconds show absurd ages in real ASE tooling
            ase_now = (time.time() - 946681200.0) / 31557600.0
            con.execute(
                "INSERT INTO systems (unique_id, ctime, mtime, username, "
                "numbers, positions, cell, pbc, constraints, "
                "key_value_pairs, data, natoms, volume) "
                "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
                (f"gct-{time.time():.6f}-{k}", ase_now, ase_now,
                 os.environ.get("USER", "gct"),
                 _blob(numbers), _blob(positions), _blob(cell), pbc,
                 constraints, kvp, data_blob, len(numbers), vol))
        con.commit()
    finally:
        con.close()


def read_db(filename: str) -> List[dict]:
    """Return [{'atoms': Atoms, 'data': dict, 'key_value_pairs': dict}]."""
    if not os.path.exists(filename):
        raise FileNotFoundError(filename)
    con = sqlite3.connect(filename)
    out = []
    try:
        cur = con.execute(
            "SELECT numbers, positions, cell, pbc, constraints, "
            "key_value_pairs, data FROM systems ORDER BY id")
        for (numbers, positions, cell, pbc, constraints, kvp,
             data) in cur.fetchall():
            numbers = np.frombuffer(numbers, np.int32).astype(np.int64)
            n = len(numbers)
            positions = np.frombuffer(positions, np.float64).reshape(n, 3).copy()   # frombuffer is read-only
            cell = (np.frombuffer(cell, np.float64).reshape(3, 3).copy()
                    if cell else np.zeros((3, 3)))
            pbc_arr = [(int(pbc) >> i) & 1 == 1 for i in range(3)]
            cons = []
            if constraints:
                for c in json.loads(constraints):
                    if c.get("name") == "FixAtoms":
                        kw = c.get("kwargs", {})
                        cons.append(FixAtoms(indices=kw.get("indices")))
            atoms = Atoms(numbers=numbers, positions=positions, cell=cell,
                          pbc=pbc_arr, constraints=cons)
            out.append({
                "atoms": atoms,
                "data": bytes_to_object(data) if data else {},
                "key_value_pairs": json.loads(kvp) if kvp else {},
            })
    finally:
        con.close()
    return out
