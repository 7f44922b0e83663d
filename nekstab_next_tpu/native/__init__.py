"""Native (C++) runtime components, bound via ctypes.

The reference's compute core leans on native libraries around the Fortran
solver (gslib gather-scatter in C, LAPACK — SURVEY.md section 2.2); here the
device compute path is XLA, and the native layer owns the host-side
*setup* work that is irregular/pointer-chasing and ill-suited to numpy:

* ``global_numbering`` — gslib-setup equivalent: dedup quantized node
  coordinates into a global numbering + multiplicity (native/gs_setup.cpp).

The library is built from ``gs_setup.cpp`` on first use (g++ -O3 -shared,
for the generic target of the host's architecture, so one build runs on any
CPU of that architecture) into ``_gs_setup.so`` next to the source, which git
ignores; every entry point has a pure-numpy fallback so the package works
without a toolchain (set ``NEKSTAB_NO_NATIVE=1`` to force the fallback).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gs_setup.cpp")
_LIB = os.path.join(_HERE, "_gs_setup.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NEKSTAB_NO_NATIVE"):
            return None
        try:
            if (not os.path.exists(_LIB)) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            ):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC",
                     "-std=c++17", _SRC, "-o", _LIB + ".tmp"],
                    check=True, capture_output=True,
                )
                os.replace(_LIB + ".tmp", _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.gs_number.restype = ctypes.c_int64
            lib.gs_number.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
        except Exception as e:  # pragma: no cover - toolchain-dependent
            print(f"nekstab_next_tpu.native: falling back to numpy ({e})",
                  file=sys.stderr)
            _lib = None
        return _lib


def global_numbering(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Global node numbering from quantized coordinate keys.

    ``keys``: (nkeys, nd<=3) int64.  Returns ``(gid, counts)`` with
    ``gid`` (nkeys,) int32 and ``counts`` (nglobal,) int32 = multiplicity of
    each global node.  The numbering is deterministic (first-occurrence
    order with the native path; sorted-unique order with the numpy
    fallback) — any consistent numbering is equivalent for dssum/dsavg."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if keys.ndim == 1:
        keys = keys[:, None]
    nkeys, nd = keys.shape

    lib = _load()
    if lib is not None and nd <= 3:
        gid = np.empty(nkeys, dtype=np.int32)
        counts = np.empty(nkeys, dtype=np.int32)
        ng = lib.gs_number(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(nkeys), ctypes.c_int32(nd),
            gid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if ng >= 0:
            return gid, counts[:ng].copy()

    _, gid, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    return gid.astype(np.int32).reshape(-1), counts.astype(np.int32)


def available() -> bool:
    """True if the compiled native library is usable."""
    return _load() is not None
