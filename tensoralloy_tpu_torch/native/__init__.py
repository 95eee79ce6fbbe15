"""Native (C++) host lists: cell-list neighbor search and triple
enumeration, loaded with ctypes.

`neighbor.cpp` is compiled with ``g++ -O3`` at first use into `_build/`
next to this package; the library's name carries a hash of the source,
the flags and the host's CPU features, so a library built from another
source or for another CPU is never loaded. Without a compiler `get_lib`
returns None and the callers (`neighbor.neighbor_list`,
`transform.featurizer`) take their numpy paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "neighbor.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread",
         "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _cpu_features() -> bytes:
    """What `-march=native` compiles for: the machine and its feature
    flags, so that a library is rebuilt on a host with another CPU."""
    tag = platform.machine().encode()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return tag + line
    except OSError:
        pass
    return tag


def library_path() -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode() + _cpu_features())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libtat_neigh_{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    # compile to a private temp file and os.replace (atomic) into place:
    # concurrent worker processes (Dataset.build(serial=False)) may race
    # this build, and a CDLL of a half-written .so segfaults
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS, str(_SRC), "-o", tmp]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
        except (subprocess.SubprocessError, OSError):
            # -march=native is not supported by every compiler and host
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True,
                           timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False


def _load(lib_path: Path) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, built if need be; None where it cannot be
    built or loaded (no compiler)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib_path = library_path()
        lib = _load(lib_path) if lib_path.exists() else None
        if lib is None:
            # absent, or a file that does not load: (re)build once
            lib = _load(lib_path) if _build(lib_path) else None
        if lib is None:
            _build_failed = True
            return None
        lib.ta_neighbor_list.restype = ctypes.c_longlong
        lib.ta_neighbor_list.argtypes = [
            ctypes.c_longlong,
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            ctypes.c_double, ctypes.c_longlong,
            np.ctypeslib.ndpointer(np.int32, flags="C,W"),
            np.ctypeslib.ndpointer(np.int32, flags="C,W"),
            np.ctypeslib.ndpointer(np.int32, flags="C,W"),
            np.ctypeslib.ndpointer(np.float64, flags="C,W"),
            np.ctypeslib.ndpointer(np.float64, flags="C,W"),
        ]
        lib.ta_triple_list.restype = ctypes.c_longlong
        lib.ta_triple_list.argtypes = [
            ctypes.c_longlong,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            ctypes.c_longlong, ctypes.c_longlong,
            np.ctypeslib.ndpointer(np.int32, flags="C,W"),
            np.ctypeslib.ndpointer(np.int32, flags="C,W"),
        ]
        _lib = lib
        return _lib


def native_neighbor_list(positions: np.ndarray, cell: np.ndarray,
                         pbc: np.ndarray, cutoff: float
                         ) -> Optional[Tuple[np.ndarray, ...]]:
    """C++ cell-list neighbor search; None if the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float64)
    cell = np.ascontiguousarray(cell, np.float64)
    pbc_u8 = np.ascontiguousarray(np.asarray(pbc, bool), np.uint8)
    n = len(positions)
    cap = max(1024, n * 120)
    while True:
        out_i = np.empty(cap, np.int32)
        out_j = np.empty(cap, np.int32)
        out_s = np.empty((cap, 3), np.int32)
        out_d = np.empty(cap, np.float64)
        out_v = np.empty((cap, 3), np.float64)
        got = lib.ta_neighbor_list(n, positions, cell, pbc_u8,
                                   float(cutoff), cap, out_i, out_j,
                                   out_s.reshape(-1), out_d,
                                   out_v.reshape(-1))
        if got < 0:
            cap = -got
            continue
        return (out_i[:got], out_j[:got],
                out_s[:got].astype(np.float64), out_d[:got],
                out_v[:got])


def native_triple_list(ilist_sorted: np.ndarray, natoms: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(p, q) indices into the (i-sorted) pair arrays for j<k triples."""
    lib = get_lib()
    if lib is None:
        return None
    ilist_sorted = np.ascontiguousarray(ilist_sorted, np.int32)
    npairs = len(ilist_sorted)
    cap = max(1024, npairs * 32)
    while True:
        out_p = np.empty(cap, np.int32)
        out_q = np.empty(cap, np.int32)
        got = lib.ta_triple_list(npairs, ilist_sorted, natoms, cap,
                                 out_p, out_q)
        if got < 0:
            cap = -got
            continue
        return out_p[:got], out_q[:got]
