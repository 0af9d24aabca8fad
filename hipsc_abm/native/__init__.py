"""Native (C++) host-side output tier, lazily built and ctypes-bound.

The device compute path is JAX/XLA; the host runtime around it follows the
reference's split (its native tier was numba-JIT'd kernels,
``/root/reference/ABM/cell_backend.py``) — here the host-side hot spot is
output serialization, so that is what goes native. ``get_lib()`` compiles
``fastio.cpp`` once per source change with g++ (cached .so next to the
source), binds it with ctypes, and returns None on any failure so every
caller can fall back to the pure-Python writers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastio.cpp")
_SO = os.path.join(_DIR, "_fastio.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """(Re)compile the shared library if the source is newer than the .so."""
    try:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return True
        tmp = _SO + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO)  # atomic vs concurrent builders
        return True
    except Exception:
        return False


def get_lib():
    """The bound library, or None when unavailable (no g++, build failure,
    or HIPSC_NO_NATIVE_IO=1 for testing the fallback path)."""
    global _lib, _tried
    if os.environ.get("HIPSC_NO_NATIVE_IO"):
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.hipsc_fmt_repr.restype = ctypes.c_int
            lib.hipsc_fmt_repr.argtypes = [ctypes.c_double, ctypes.c_char_p]
            lib.hipsc_write_values_csv.restype = ctypes.c_int
            lib.hipsc_write_values_csv.argtypes = [
                ctypes.c_char_p,
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_void_p),
            ]
            lib.hipsc_write_matrix_e18.restype = ctypes.c_int
            lib.hipsc_write_matrix_e18.argtypes = [
                ctypes.c_char_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib
