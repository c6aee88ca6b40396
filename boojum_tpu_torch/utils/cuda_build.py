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
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
KERNELS = ("ntt_stage", "poseidon2", "ntt_small", "sha256_witness",
           "poseidon", "blake2s", "keccak")

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
        "poseidon2_set_constants": [_P, _P],  # round constants, shifts
        "poseidon2_permute": [_P, _P, _LL, _P],  # in, out, batch, stream
        # cols, out, k, m, row stride of cols, stream
        "poseidon2_leaf_hashes": [_P, _P, _I, _LL, _LL, _P],
        "poseidon2_node_layer": [_P, _P, _LL, _P],  # cur, out, m, stream
    },
    "ntt_small": {
        # x, y, stage table, cross twiddle (None: no epilogue), log_n,
        # batch, inverse, cross-twiddle column shift, stream
        "ntt_small": [_P, _P, _P, _P, _I, _LL, _I, _I, _P],
    },
    "sha256_witness": {
        "sha256_witness": [_P, _P, _P, _LL, _P],  # blocks, init, out, nb, stream
    },
    "poseidon": {
        # state, elements, k, out state, round constants, stream
        "poseidon_absorb": [_P, _P, _LL, _P, _P, _P],
        "poseidon_permute": [_P, _P, _P, _P],  # state, out, constants, stream
        # cols, out, k, m, row stride of cols, constants, stream
        "poseidon_leaf_hashes": [_P, _P, _I, _LL, _LL, _P, _P],
        "poseidon_node_layer": [_P, _P, _LL, _P, _P],  # cur, out, m, constants, stream
    },
    # cols, out, k, m, row stride of cols, stream; cur, out, m, levels,
    # tickets, stream
    "blake2s": {
        "blake2s_leaf_hashes": [_P, _P, _I, _LL, _LL, _P],
        "blake2s_node_layers": [_P, _P, _LL, _I, _P, _P],
    },
    "keccak": {
        "keccak_leaf_hashes": [_P, _P, _I, _LL, _LL, _P],
        "keccak_node_layers": [_P, _P, _LL, _I, _P, _P],
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


def build(names, csrc: str = CSRC, out_dir: str = BUILD, verbose: bool = False
          ) -> float:
    """Compile ``csrc/<name>.cu`` into ``out_dir/lib<name>.so`` for each of
    ``names``, all ``nvcc`` processes started together; returns seconds."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for name in names:
        out = os.path.join(out_dir, "lib%s.so" % name)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", csrc, "-o", out + ".tmp", os.path.join(csrc, name + ".cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append("%s:\n%s" % (name, log))
            continue
        os.replace(out + ".tmp", out)
        if verbose:
            print("[nvcc %s, done at %.1f s]\n%s"
                  % (name, time.time() - t0, log.strip()), flush=True)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return time.time() - t0


def build_all(verbose: bool = False) -> float:
    """Compile every stale kernel library of the package; returns seconds."""
    todo = [k for k in KERNELS if _stale(k)]
    return build(todo, verbose=verbose) if todo else 0.0


def open_lib(path: str, name: str) -> ctypes.CDLL:
    """Load the library ``path`` built from ``csrc/<name>.cu`` and give each
    of its C entry points its argument types. An entry the library lacks (a
    library built from older sources) is left out."""
    lib = ctypes.CDLL(path)
    for fn, argtypes in _SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name] = open_lib(_lib_path(name), name)
    return lib


def sass(lib_path: str) -> dict:
    """The SASS of every kernel in a built library, from ``cuobjdump -sass``:
    kernel (mangled) name -> list of (address, opcode, instruction text)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    kernels, cur = {}, None
    for line in out.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            cur = kernels.setdefault(head.group(1), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins and cur is not None:
            text = ins.group(2)
            opcode = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            cur.append((int(ins.group(1), 16), opcode, text))
    return kernels


# Integer-pipe opcodes (before the first '.'): what a Goldilocks kernel's
# arithmetic compiles to.
INT_OPCODES = {"IMAD", "IADD3", "IADD", "ISETP", "LOP3", "SHF", "SEL", "LEA",
               "IMNMX", "PRMT", "IABS", "POPC", "FLO", "BMSK", "SGXT", "ISCADD",
               "IMUL", "LOP", "SHL", "SHR", "UIMAD", "UIADD3", "ULOP3", "USHF",
               "USEL", "ULEA", "UISETP"}


# Trip counts of the Poseidon2 kernels' round loops, in address order: 4 full,
# 22 partial and 4 full rounds.
P2_ROUND_TRIPS = (4, 22, 4)


def sass_summary(instrs, trips=()) -> dict:
    """Counts of one kernel's SASS: all instructions, integer-pipe ones,
    IMADs, and its loops (backward branches), each with the integer-pipe
    instructions of its body. Given ``trips``, the trip counts of the
    innermost loops in address order, ``integer_per_pass`` is the number of
    integer-pipe instructions one pass through the code executes: each
    innermost loop body ``trips`` times, every other instruction once."""
    is_int = [op.split(".")[0] in INT_OPCODES for _, op, _ in instrs]
    loops = []
    for addr, op, text in instrs:
        target = re.search(r"0x([0-9a-f]+)", text) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            start = int(target.group(1), 16)
            loops.append(dict(start=start, end=addr, integer=sum(
                i for (a, _, _), i in zip(instrs, is_int) if start <= a <= addr)))
    out = dict(total=len(instrs), integer=sum(is_int),
               imad=sum(op.split(".")[0] in ("IMAD", "UIMAD")
                        for _, op, _ in instrs),
               loops=loops)
    if trips:
        inner = sorted((lp for lp in loops if not any(
            o is not lp and lp["start"] <= o["start"] and o["end"] <= lp["end"]
            for o in loops)), key=lambda lp: lp["start"])
        if len(inner) != len(trips):
            raise ValueError("%d innermost loops, expected %d"
                             % (len(inner), len(trips)))
        out["integer_per_pass"] = out["integer"] + sum(
            (t - 1) * lp["integer"] for t, lp in zip(trips, inner))
    return out


def chain_per_round(lib, instrs, summary):
    """Integer-pipe SASS instructions of one round of a sequential kernel's
    chain. K6 (`poseidon`): a permutation's integer instructions over its 30
    rounds, each round loop's body counted its trips: the innermost loops of
    20 or more integer instructions are the round loops, three of them 4
    full, 22 partial and 4 full rounds, one of them the 22 partial rounds (or
    all 30, when it holds most of the kernel), none when all are unrolled.
    K5 (`sha256_witness`): the innermost loop holding the most funnel shifts
    is the chain's, and a round has six (the rotations of s0 and s1); None
    when the kernel has no such loop."""
    inner = [lp for lp in summary["loops"] if not any(
        o is not lp and lp["start"] <= o["start"] and o["end"] <= lp["end"]
        for o in summary["loops"])]
    if lib == "poseidon":
        rounds = [lp for lp in inner if lp["integer"] >= 20]
        if not rounds:
            return round(summary["integer"] / 30, 1)
        if len(rounds) == 1:
            trips = (30,) if rounds[0]["integer"] > summary["integer"] / 2 \
                else (22,)
        elif len(rounds) == 3:
            trips = (4, 22, 4)
        else:
            return None
        extra = sum(lp["integer"] for lp in summary["loops"]
                    if lp in inner and lp not in rounds)
        per_pass = summary["integer"] - extra + sum(
            (t - 1) * lp["integer"] for t, lp in zip(trips, rounds))
        return round(per_pass / 30, 1)
    best = None
    for lp in inner:
        shf = sum(op.startswith("SHF") for a, op, _ in instrs
                  if lp["start"] <= a <= lp["end"])
        if shf >= 6 and (best is None or shf > best[0]):
            best = (shf, lp["integer"])
    return None if best is None else round(best[1] / (best[0] / 6), 1)


def stream_handle(t) -> int:
    """The raw CUDA stream PyTorch runs on for ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError("%s failed with CUDA error %d" % (what, rc))
