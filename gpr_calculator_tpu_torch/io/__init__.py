"""File IO: ASE-compatible sqlite databases (``ase_db``, a copy of the JAX
package's module; NumPy and sqlite3 only).  Trajectories (ULM) and POSCAR
are not ported yet (ROADMAP.md, port queue item 3)."""
from __future__ import annotations

from . import ase_db  # noqa
