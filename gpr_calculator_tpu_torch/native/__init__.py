"""Native (C++) neighbour-list builder, compiled on demand with g++.

The source is ``neighbor.cpp`` beside this file, the port's own
byte-identical copy of the JAX package's native neighbour list.  The
library is built into the port's git-ignored ``build/`` directory under
a name keyed by the source hash and the host's ISA flags
(``-march=native`` code must not be loaded on a lesser CPU), written
under a temporary name and renamed into place so concurrent processes
never load a half-written file.  Without a compiler the callers use the
NumPy fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "neighbor.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_LIB = None
_TRIED = False


def _host_tag() -> str:
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    blob = f"{platform.machine()}|{flags}".encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _build() -> Path | None:
    if not _SRC.exists():
        return None
    src_hash = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"libgprnative-{src_hash}-{_host_tag()}.so"
    if out.exists():
        return out
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    except OSError:
        return None
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", str(_SRC), "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def get_lib():
    """Return the loaded native library, or None when unavailable."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.neighbor_build.restype = ctypes.c_longlong
    lib.neighbor_build.argtypes = [
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_double,
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_double),
    ]
    _LIB = lib
    return _LIB
