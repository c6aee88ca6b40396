# Copied from boojum_tpu/utils/native.py; the library builds into
# boojum_tpu_torch/_build/.
"""ctypes bindings for the native witness engine (native/witness_engine.cpp).

Builds the shared library on first use (g++ -O3, no external deps) into
the package's ignored ``_build/`` (never into ``native/``), through a
temporary file and an atomic rename, so that processes building at once
do not load a half-written library. The callers (`utils/npgl.py`) keep
their numpy path when the toolchain or the library is unavailable: host
code whose results are identical either way, so the package works without
native code. `available()` says which path runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                    "witness_engine.cpp")
_OUT = os.path.join(os.path.dirname(__file__), "..", "_build",
                    "libwitness_engine.so")


def get_lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        src = os.path.abspath(_SRC)
        out = os.path.abspath(_OUT)
        if not os.path.exists(out) or \
                os.path.getmtime(out) < os.path.getmtime(src):
            os.makedirs(os.path.dirname(out), exist_ok=True)
            tmp = "%s.%d.tmp" % (out, os.getpid())
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            src, "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lp = ctypes.POINTER(ctypes.c_long)
        lib.gl_add_arrays.argtypes = [u64p, u64p, u64p, ctypes.c_long]
        lib.gl_sub_arrays.argtypes = [u64p, u64p, u64p, ctypes.c_long]
        lib.gl_mul_arrays.argtypes = [u64p, u64p, u64p, ctypes.c_long]
        lib.gl_mul_scalar.argtypes = [u64p, ctypes.c_uint64, u64p, ctypes.c_long]
        lib.gl_inv_arrays.argtypes = [u64p, u64p, ctypes.c_long]
        lib.gl_powers.argtypes = [ctypes.c_uint64, u64p, ctypes.c_long]
        lib.fma_node.argtypes = [u64p, lp, lp, lp, lp, ctypes.c_uint64,
                                 ctypes.c_uint64, ctypes.c_long]
        lib.reduce_node.argtypes = [u64p, lp, u64p, ctypes.c_long, lp,
                                    ctypes.c_long]
        lib.self_test.restype = ctypes.c_uint64
        if lib.self_test() != 0:
            _LIB = None
            return None
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def available() -> bool:
    return get_lib() is not None


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = get_lib()
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    out = np.empty_like(a)
    lib.gl_mul_arrays(_p64(a), _p64(b), _p64(out), a.size)
    return out


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = get_lib()
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    out = np.empty_like(a)
    lib.gl_add_arrays(_p64(a), _p64(b), _p64(out), a.size)
    return out


def batch_inv(a: np.ndarray) -> np.ndarray:
    lib = get_lib()
    a = np.ascontiguousarray(a, np.uint64)
    out = np.empty_like(a)
    lib.gl_inv_arrays(_p64(a), _p64(out), a.size)
    return out


def powers(base: int, n: int) -> np.ndarray:
    lib = get_lib()
    out = np.empty(n, np.uint64)
    lib.gl_powers(ctypes.c_uint64(base), _p64(out), n)
    return out
