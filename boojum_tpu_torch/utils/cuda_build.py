"""Build and load the hand-written CUDA kernels of `boojum_tpu_torch/csrc/`.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``_build/lib<name>.so``, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The first call of
`load` builds every library that is missing or older than its sources, all
``nvcc`` processes started together. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
KERNELS = ("ntt_stage", "poseidon2", "ntt_small")

_LIBS: dict = {}  # kernel handles: name -> ctypes.CDLL

_P, _I, _LL, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_ulonglong)
# C entry points of each library -> argument types; every one returns an
# int CUDA error code. Pointers and streams are c_void_p, so ctypes does not
# cut them to 32 bits.
_SIGNATURES = {
    "ntt_stage": {
        # x, y, butterfly table, cross twiddle, log_r, m, inverse, twmode,
        # twiddle width, 1/R scale, stream
        "ntt_stage": [_P, _P, _P, _P, _I, _LL, _I, _I, _LL, _ULL, _P],
    },
    "poseidon2": {
        "poseidon2_set_constants": [_P, _P],  # round constants, diagonal
        "poseidon2_permute": [_P, _P, _LL, _P],  # in, out, batch, stream
    },
    "ntt_small": {
        # x, y, stage table, log_n, batch, inverse, 1/n scale, stream
        "ntt_small": [_P, _P, _P, _I, _LL, _I, _ULL, _P],
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, "lib%s.so" % name)


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    srcs = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f == name + ".cu" or f.endswith(".cuh")]
    return any(os.path.getmtime(s) > os.path.getmtime(out) for s in srcs)


def build_all(verbose: bool = False) -> float:
    """Compile every stale kernel library in parallel; returns seconds."""
    todo = [k for k in KERNELS if _stale(k)]
    if not todo:
        return 0.0
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for name in todo:
        tmp = _lib_path(name) + ".tmp"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", CSRC, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append("%s:\n%s" % (name, out))
            continue
        os.replace(tmp, _lib_path(name))
        if verbose:
            print("[nvcc %s]\n%s" % (name, out.strip()), flush=True)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(_lib_path(name))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream_handle(t) -> int:
    """The raw CUDA stream PyTorch runs on for ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError("%s failed with CUDA error %d" % (what, rc))
