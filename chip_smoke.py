"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from `boojum_tpu_torch/csrc/`, prints each
kernel's SASS instruction counts (`cuobjdump -sass`), and holds every kernel
entry bit-exactly against its plain PyTorch version on the card: `ntt_stage`
at every template instance (R 128 / 256 x forward / inverse x twiddle mode
0 / 1 / 2) and at a ragged width, `poseidon2_permute`,
`poseidon2_leaf_hashes` and `poseidon2_node_layer` at the trees' shapes,
`ntt_small` at every template instance (log n 0 .. 12 x forward / forward
with the cross twiddle / inverse) at two ragged batches and at the NTT
path's two shapes with its real twiddle tables; every shape it times is held
against the plain version first. Then it drives
three paths, each with the launch counts set to 0 just before it and read
just after:

- the flagship: proves the 8 kB SHA-256 circuit (2^16 rows, LDE 8, cap 16,
  Poseidon transcript, Poseidon2 trees) through the port's entry points and
  requires the sha256 of `proof_to_json(proof)` to equal the reference
  digest in `boojum_tpu_torch/data/flagship_proof_digest.json` (made by
  `scripts/torch_reference_digest.py` from the JAX package). It records the
  kernel launches of one prove by shape, holds each shape bit-exactly
  against its plain version, times it and prints, per kernel, the sum over
  a prove of launches x time and of launches x (time - bound);
- the standalone NTT: runs `pallas_ntt.ntt_any` at (2^24, 8), whose output
  must equal the digest in `boojum_tpu_torch/data/ntt_2e24_digest.json`
  (made by `scripts/torch_reference_ntt_digest.py`) and the radix-256 route
  `ntt.ntt_fourstep_cols`; it must launch `ntt_small` 4 times, with no
  plain version and no torch cross-twiddle multiply on the card (both
  cross twiddles ride in the kernel's store);
- the batch permutation: `pallas_poseidon2.permutation_stacked_fast` on 2^20
  random states, against its plain version. No path of the port calls it
  since the trees hash through the leaf and node entries; this phase keeps
  the `poseidon2_permute` entry launched and checked.

    python3 chip_smoke.py                 # everything, as above
    python3 chip_smoke.py --kernels-only  # build, SASS, kernel checks; stop

Prints the card's `name, power.limit`, a `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, with no result line, when
CUDA or nvidia-smi is unavailable or any phase fails.
"""

import collections
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# The kernels' work is 32-bit integer multiply-adds (IMAD). The data sheet's
# non-tensor fp32 peak is 67 TFLOP/s with an FMA counted as 2 ops, i.e.
# 33.5e12 FMA/s from 128 fp32 lanes per SM per clock; Hopper issues IMAD on
# 64 lanes per SM per clock, half that rate. A Goldilocks multiply needs at
# least the 4 32x32->64-bit partial products of its 64x64-bit product.
H100_IMAD_PER_S = 67e12 / 2 / 2
IMAD_PER_FIELD_MUL = 4
# s-box multiplies of one Poseidon2 permutation: 8 full rounds x 12 x 4,
# 22 partial rounds x 4
P2_MULS = 8 * 12 * 4 + 22 * 4
P2_REPLACES = "boojum_tpu/hash/pallas_poseidon2.py:43"


def log(msg):
    print(msg, flush=True)


def card_line():
    """The card's ``name, power.limit``; raises when nvidia-smi cannot say,
    since every number of the run is reported beside it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError("nvidia-smi failed (rc %d): %s"
                           % (out.returncode, out.stderr.strip()))
    return lines[0]


def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, field_muls):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = field_muls * IMAD_PER_FIELD_MUL / H100_IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b):
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    ha, hb = gl.to_u64(a), gl.to_u64(b)
    if ha.shape != hb.shape:
        raise AssertionError("shapes differ: %s vs %s" % (ha.shape, hb.shape))
    if np.array_equal(ha, hb):
        return 0.0
    return float(np.max(np.abs(ha.astype(np.float64) - hb.astype(np.float64))))


def rand_field(rng, shape):
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    return gl.from_u64(rng.integers(0, gl.ORDER, shape, dtype=np.uint64),
                       "cuda")


def require_equal(got, want, what):
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError("%s differs from its plain version (max abs err "
                             "%g)" % (what, err))
    return err


# ---------------------------------------------------------------------------
# SASS
# ---------------------------------------------------------------------------


def k4_elements(log_n):
    """Elements one thread of a `ntt_small` instance holds: 2^A rows of C
    columns, A = min(log n, 3), C = 2 (csrc/ntt_small.cu, Shape<L>)."""
    return 2 << min(log_n, 3)


def sass_report():
    """Instruction counts of the built kernels. The Poseidon2 entries roll
    their round loops (each round body unrolled), so their integer
    instructions per permutation count each round loop's body times its
    trips; the leaf entry's count is for one absorbed rate block. The
    ntt_stage and ntt_small instances are straight-line code over the
    elements a thread holds (32 for ntt_stage; 2^A rows of C columns for
    ntt_small), so theirs is per element."""
    import re
    from boojum_tpu_torch.utils import cuda_build

    report = {}
    for lib in ("poseidon2", "ntt_stage", "ntt_small"):
        trips = cuda_build.P2_ROUND_TRIPS if lib == "poseidon2" else ()
        for kname, instrs in sorted(
                cuda_build.sass(cuda_build._lib_path(lib)).items()):
            s = cuda_build.sass_summary(instrs, trips)
            short, per_elem = kname, 32
            for tag in ("permute_kernel", "leaf_kernel", "node_kernel",
                        "ntt_stage_kernel"):
                if tag in kname:
                    short = tag + kname.split(tag, 1)[1][:14]
            k4 = re.search(r"ntt_small_kernelILi(\d+)ELb([01])ELb([01])E",
                           kname)
            if k4:
                log_n, inv, epi = (int(g) for g in k4.groups())
                short = "ntt_small_kernel<%d,%s%s>" % (
                    log_n, "inv" if inv else "fwd", ",tw" if epi else "")
                per_elem = k4_elements(log_n)
            s["integer_per_element"] = s["integer"] / per_elem
            report[short] = s
            per = " (%d integer per permutation)" % s["integer_per_pass"] \
                if trips else " (%.1f integer per element)" % (
                    s["integer_per_element"])
            log("sass %s: %d instructions, %d integer-pipe, %d IMAD, "
                "%d loops%s" % (short, s["total"], s["integer"], s["imad"],
                                len(s["loops"]), per))
    return report


# ---------------------------------------------------------------------------
# kernel checks against the plain versions
# ---------------------------------------------------------------------------


def k1_args(rng, r, m, inverse, twmode, width=256):
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.ntt import ntt
    x = rand_field(rng, (r, m))
    tw = None
    if twmode:
        log_w = min(width, m).bit_length() - 1
        tw = gl.from_u64(ntt.fourstep_twiddles_host(r.bit_length() - 1, log_w,
                                                    inverse), "cuda")
    return x, dict(inverse=inverse, tw=tw, tw_pre=twmode == 2)


def k1_bound(r, m, inverse, twmode, width):
    log_r = r.bit_length() - 1
    nbytes = 2 * r * m * 8 + (r * width * 8 if twmode else 0)
    muls = (r // 2) * log_r * m + r * m * (int(inverse) + int(twmode > 0))
    return bound(nbytes, muls)


def check_ntt_stage(rng):
    """K1 at every template instance, and at ragged widths (odd M takes the
    8-byte path), bit-equal to its plain version."""
    from boojum_tpu_torch.ntt import mxu_ntt

    errs = []
    cases = [(r, 1 << 14, inv, tw) for r in (128, 256) for inv in (False, True)
             for tw in (0, 1, 2)]
    cases += [(r, m, inv, 0) for r in (128, 256) for m in (1000, 1001)
              for inv in (False, True)]
    for (r, m, inverse, twmode) in cases:
        x, kw = k1_args(rng, r, m, inverse, twmode)
        errs.append(require_equal(
            mxu_ntt.ntt_cols_matmul(x, **kw), mxu_ntt.ntt_stage_plain(x, **kw),
            "ntt_stage R=%d M=%d inverse=%d twmode=%d" % (r, m, inverse,
                                                          twmode)))
    log("ntt_stage: bit-equal at %d cases (R 128/256 x inverse x twmode "
        "0/1/2 at M = 2^14; ragged M 1000, 1001)" % len(cases))
    return max(errs)


def time_ntt_stage(rng, r, m, inverse, twmode, width, plain=False):
    """K1 at one shape: bit-equal to its plain version, then timed."""
    from boojum_tpu_torch.ntt import mxu_ntt
    x, kw = k1_args(rng, r, m, inverse, twmode, width)
    err = require_equal(
        mxu_ntt.ntt_cols_matmul(x, **kw), mxu_ntt.ntt_stage_plain(x, **kw),
        "ntt_stage R=%d M=%d inverse=%d twmode=%d W=%d"
        % (r, m, inverse, twmode, width))
    res = dict(err=err,
               ms=cuda_ms(lambda: mxu_ntt.ntt_cols_matmul(x, **kw), 20))
    if plain:
        res["plain_ms"] = cuda_ms(lambda: mxu_ntt.ntt_stage_plain(x, **kw), 2)
    res["bound_ms"], res["bound_by"] = k1_bound(r, m, inverse, twmode, width)
    return res


def check_poseidon2(rng):
    """The three K2 entries, bit-equal to their plain versions, and timed at
    the reported shapes. Returns {entry: (max err, timing at its shape)}."""
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp

    out = {}
    errs, timing = [], None
    for b in (1, 127, 1 << 16, 1 << 20):
        st = rand_field(rng, (12, b))
        errs.append(require_equal(pp.permutation_stacked_fast(st),
                                  pp.permutation_plain(st),
                                  "poseidon2_permute B=%d" % b))
        if b == 1 << 16:
            timing = time_p2(("permute", b), st, plain=True)
    out["poseidon2_permute"] = (max(errs), timing)
    log("poseidon2_permute: bit-equal at B = 1, 127, 2^16, 2^20")

    errs = []
    for (k, m) in ((64, 1 << 19), (8, 1 << 19), (13, 1 << 16)):
        cols = rand_field(rng, (k, m))
        errs.append(require_equal(pp.leaf_hashes(cols),
                                  pp.leaf_hashes_plain(cols),
                                  "poseidon2_leaf_hashes (%d, %d)" % (k, m)))
        if (k, m) == (64, 1 << 19):
            timing = time_p2(("leaf", k, m), cols, plain=True)
    strided = rand_field(rng, (8, 1 << 12))[:, :1 << 11]  # a row stride > m
    errs.append(require_equal(pp.leaf_hashes(strided),
                              pp.leaf_hashes_plain(strided),
                              "poseidon2_leaf_hashes on a strided view"))
    out["poseidon2_leaf_hashes"] = (max(errs), timing)
    log("poseidon2_leaf_hashes: bit-equal at (64, 2^19), (8, 2^19), "
        "(13, 2^16) padded, and a strided (8, 2^11) view")

    errs = []
    for m in (1 << 19, 32):
        cur = rand_field(rng, (4, m))
        errs.append(require_equal(pp.node_layer(cur), pp.node_layer_plain(cur),
                                  "poseidon2_node_layer m=%d" % m))
        if m == 1 << 19:
            timing = time_p2(("node", m), cur, plain=True)
    out["poseidon2_node_layer"] = (max(errs), timing)
    log("poseidon2_node_layer: bit-equal at m = 2^19, 32")
    return out


def p2_bound(shape):
    kind = shape[0]
    if kind == "permute":
        b = shape[1]
        return bound(2 * 12 * 8 * b, P2_MULS * b)
    if kind == "leaf":
        k, m = shape[1:]
        return bound((k + 4) * m * 8, -(-k // 8) * P2_MULS * m)
    m = shape[1]
    return bound((4 * m + 2 * m) * 8, P2_MULS * (m // 2))


def time_p2(shape, x, plain=False):
    """A K2 entry at one shape: bit-equal to its plain version, then
    timed."""
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    fn, plain_fn = {"permute": (pp.permutation_stacked_fast,
                                pp.permutation_plain),
                    "leaf": (pp.leaf_hashes, pp.leaf_hashes_plain),
                    "node": (pp.node_layer, pp.node_layer_plain)}[shape[0]]
    err = require_equal(fn(x), plain_fn(x), "poseidon2 %s" % (shape,))
    res = dict(err=err, ms=cuda_ms(lambda: fn(x), 20))
    if plain:
        res["plain_ms"] = cuda_ms(lambda: plain_fn(x), 2)
    res["bound_ms"], res["bound_by"] = p2_bound(shape)
    n = x.shape[1] // (2 if shape[0] == "node" else 1)
    log("%s %s: bit-equal, %.4f ms kernel (%.1f M perm/s%s), bound %.4f ms "
        "(%s), %.1f%% of bound" % (
            {"permute": "poseidon2_permute", "leaf": "poseidon2_leaf_hashes",
             "node": "poseidon2_node_layer"}[shape[0]], shape[1:], res["ms"],
            n * (-(-x.shape[0] // 8) if shape[0] == "leaf" else 1)
            / res["ms"] / 1e3,
            ", plain %.3f ms" % res["plain_ms"] if plain else "",
            res["bound_ms"], res["bound_by"],
            100 * res["bound_ms"] / res["ms"]))
    return res


def k4_tables():
    """The two cross-twiddle tables of `ntt_any` at (2^24, 8), as the path
    hands them to K4: the inner (512, 8) table at shift 15 and the outer
    (4096, 4096) table re-laid to (8, 2^21) at shift 3."""
    import torch
    from boojum_tpu_torch.ntt import ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    dev = torch.device("cuda")
    inner = ntt.fourstep_twiddles_device(9, 3, False, dev)
    outer = pn.relaid_twiddles(ntt.fourstep_twiddles_device(12, 12, False,
                                                            dev), 9)
    return {9: (inner, 15), 3: (outer, 3)}


def check_ntt_small(rng):
    """K4 against its plain version at every template instance (log n 0 ..
    12; forward, forward with the cross twiddle, inverse), each at an odd
    batch (8-byte path) and an even one (16-byte path); then timed at the
    two shapes of the NTT path, (512, 2^18) and (8, 2^24), forward and
    inverse, and forward with the path's real twiddle tables. Returns the
    largest error and the timings by (log_n, B, mode)."""
    from boojum_tpu_torch.ntt import pallas_ntt as pn

    errs = []
    for log_n in range(pn.MAX_KERNEL_LOG + 1):
        n = 1 << log_n
        for b in (1001, 2050):
            x = rand_field(rng, (n, b))
            shift = 1 if b % 2 == 0 else 0
            tw = rand_field(rng, (n, b >> shift))
            for mode in ("forward", "twiddle", "inverse"):
                kw = dict(tw=tw, tw_shift=shift) if mode == "twiddle" else {}
                inv = mode == "inverse"
                errs.append(require_equal(
                    pn.ntt_small(x, log_n, inv, **kw),
                    pn.ntt_small_plain(x, log_n, inv, **kw),
                    "ntt_small n=%d B=%d %s" % (n, b, mode)))
    log("ntt_small: bit-equal at every instance (log n 0..12 x forward / "
        "twiddle / inverse) at B = 1001 and 2050")

    tables, timings = k4_tables(), {}
    for (log_n, b) in ((9, 1 << 18), (3, 1 << 24)):
        n = 1 << log_n
        x = rand_field(rng, (n, b))
        tw, shift = tables[log_n]
        for mode in ("forward", "twiddle", "inverse"):
            kw = dict(tw=tw, tw_shift=shift) if mode == "twiddle" else {}
            inv = mode == "inverse"
            err = require_equal(pn.ntt_small(x, log_n, inv, **kw),
                                pn.ntt_small_plain(x, log_n, inv, **kw),
                                "ntt_small n=%d B=%d %s" % (n, b, mode))
            errs.append(err)
            ms = cuda_ms(lambda: pn.ntt_small(x, log_n, inv, **kw), 20)
            plain_ms = cuda_ms(lambda: pn.ntt_small_plain(x, log_n, inv,
                                                          **kw), 2)
            tw_bytes = tw.numel() * 8 if mode == "twiddle" else 0
            muls = (n // 2) * log_n * b + n * b * int(mode != "forward")
            b_ms, b_by = bound(2 * n * b * 8 + n * 8 + tw_bytes, muls)
            log("ntt_small n=%d B=%d %s: bit-equal, %.4f ms kernel, %.3f ms "
                "plain, bound %.4f ms (%s), %.1f%% of bound"
                % (n, b, mode, ms, plain_ms, b_ms, b_by, 100 * b_ms / ms))
            timings[(log_n, b, mode)] = dict(ms=ms, plain_ms=plain_ms,
                                             bound_ms=b_ms, bound_by=b_by,
                                             err=err)
        del x
    return max(errs), timings


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------


def reset_counts():
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.ntt import mxu_ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    for mod in (mxu_ntt, pp, pn):
        mod.LAUNCHES = 0
        mod.PLAIN_CUDA_CALLS = 0
        if hasattr(mod, "SHAPES"):
            mod.SHAPES.clear()
    pp.LEAF_LAUNCHES = pp.NODE_LAUNCHES = 0
    pn.TORCH_TWIDDLE_MULS = 0


def read_counts():
    """Launches of every kernel entry, plain calls on CUDA tensors, and torch
    cross-twiddle multiplies on CUDA tensors."""
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.ntt import mxu_ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    return dict(ntt_stage=mxu_ntt.LAUNCHES, poseidon2_permute=pp.LAUNCHES,
                poseidon2_leaf_hashes=pp.LEAF_LAUNCHES,
                poseidon2_node_layer=pp.NODE_LAUNCHES,
                ntt_small=pn.LAUNCHES,
                plain_on_cuda=mxu_ntt.PLAIN_CUDA_CALLS + pp.PLAIN_CUDA_CALLS
                + pn.PLAIN_CUDA_CALLS,
                torch_twiddle_muls=pn.TORCH_TWIDDLE_MULS)


def ntt_path(k4):
    """The standalone NTT entry point at 2^24 x 8: `pallas_ntt.ntt_any` (the
    K4 route) against the committed JAX digest and against the K1 route
    (`ntt.ntt_fourstep_cols`), with both routes timed. ``k4`` maps a K4
    shape (log_n, B, mode) to its timing from `check_ntt_small`."""
    import numpy as np
    import torch
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.ntt import ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn

    with open(os.path.join(ROOT, "boojum_tpu_torch", "data",
                           "ntt_2e24_digest.json")) as f:
        ref = json.load(f)
    n, b = ref["shape"]
    log_n = n.bit_length() - 1
    x = gl.from_u64(np.random.default_rng(ref["seed"]).integers(
        0, gl.ORDER, (n, b), dtype=np.uint64), "cuda")

    reset_counts()  # counts of the NTT path only
    out = pn.ntt_any(x, log_n)
    torch.cuda.synchronize()
    counts = read_counts()
    log("ntt path (%d, %d): launches %s" % (n, b, json.dumps(counts)))
    if counts["ntt_small"] != 4 or log_n != 24:
        raise AssertionError("ntt_any at 2^24 should launch ntt_small 4 "
                             "times, got %d at 2^%d"
                             % (counts["ntt_small"], log_n))
    if counts["plain_on_cuda"] or counts["torch_twiddle_muls"]:
        raise AssertionError("a plain version or a torch twiddle multiply "
                             "ran on a CUDA tensor")

    host = gl.to_u64(out)
    digest = hashlib.sha256(host.astype("<u8").tobytes()).hexdigest()
    log("ntt path output sha256 %s (reference %s, %s)"
        % (digest, ref["output_u64_sha256"], ref["function"]))
    if digest != ref["output_u64_sha256"]:
        rows = [[str(int(v)) for v in host[r]] for r in (0, 1)]
        raise AssertionError("ntt_any output differs from the reference "
                             "(rows 0-1 %s equal the reference's)"
                             % ("" if rows == ref["rows_0_1"] else "do not"))
    del host
    k1_out = ntt.ntt_fourstep_cols(x)
    if not torch.equal(out, k1_out):
        raise AssertionError("ntt_any differs from ntt.ntt_fourstep_cols")
    log("ntt path: ntt_any equals the K1 route ntt.ntt_fourstep_cols")
    del out, k1_out

    ms_k4 = cuda_ms(lambda: pn.ntt_any(x, log_n), 3)
    ms_k1 = cuda_ms(lambda: ntt.ntt_fourstep_cols(x), 3)
    # One K4-route call at 2^24 splits 2^12 x 2^12, and each 2^12 pass
    # 2^9 x 2^3: 4 kernel launches -- (512, 2^18) with the inner twiddle
    # twice, (8, 2^24) with the outer twiddle once and without once -- and
    # 6 transpose copies (4 inner, 2 outer), each pass over all 2^27
    # elements. Kernels from check_ntt_small; transposes timed alone here.
    inner, outer = x.view(512, 8, -1), x.view(4096, 4096, b)
    parts = dict(
        kernels=2 * k4[(9, n * b // 512, "twiddle")]["ms"]
        + k4[(3, n * b // 8, "twiddle")]["ms"]
        + k4[(3, n * b // 8, "forward")]["ms"],
        transpose_inner=4 * cuda_ms(
            lambda: inner.transpose(0, 1).reshape(8, -1), 10),
        transpose_outer=2 * cuda_ms(
            lambda: outer.transpose(0, 1).reshape(4096, -1), 10))
    b_ms, _ = bound((10 * 2 * n * b + 2 * 512 * 8 + 2 ** 24) * 8, 0)
    log("ntt path ntt_any (K4 route): %.3f ms per call, %.3f ms per 2^%d "
        "transform, %.2f NTT/s; byte bound of its 4 kernel passes (with "
        "their twiddle tables) + 6 transposes %.3f ms"
        % (ms_k4, ms_k4 / b, log_n, b * 1e3 / ms_k4, b_ms))
    log("ntt path split per call (parts timed alone, ms): " + json.dumps(
        {k: round(v, 4) for k, v in parts.items()}))
    log("ntt path ntt_fourstep_cols (K1 route, cross twiddles kept on the "
        "card): %.3f ms per call, %.3f ms per transform, %.2f NTT/s"
        % (ms_k1, ms_k1 / b, b * 1e3 / ms_k1))
    return counts


def per_prove_costs(rng, k1_shapes, p2_shapes):
    """Holds every kernel shape one prove launched against its plain version,
    times it and sums, per kernel, launches x time and launches x (time -
    bound) over the prove. Returns the sums and each kernel's largest
    error."""
    totals = collections.defaultdict(lambda: [0, 0.0, 0.0])
    errs = collections.defaultdict(float)
    for (r, m, inverse, twmode, width), n in sorted(k1_shapes.items()):
        t = time_ntt_stage(rng, r, m, inverse, twmode, width or 256)
        errs["ntt_stage"] = max(errs["ntt_stage"], t["err"])
        log("per prove: ntt_stage (R=%d, M=%d, inverse=%d, twmode=%d, W=%d) "
            "x %d: bit-equal, %.4f ms, bound %.4f ms (%s), %.1f%% of bound"
            % (r, m, inverse, twmode, width, n, t["ms"], t["bound_ms"],
               t["bound_by"], 100 * t["bound_ms"] / t["ms"]))
        tot = totals["ntt_stage"]
        tot[0] += n
        tot[1] += n * t["ms"]
        tot[2] += n * (t["ms"] - t["bound_ms"])
    names = {"permute": "poseidon2_permute", "leaf": "poseidon2_leaf_hashes",
             "node": "poseidon2_node_layer"}
    for shape, n in sorted(p2_shapes.items()):
        if shape[0] == "permute":
            x = rand_field(rng, (12, shape[1]))
        elif shape[0] == "leaf":
            x = rand_field(rng, shape[1:])
        else:
            x = rand_field(rng, (4, shape[1]))
        log("per prove: %s x %d" % (shape, n))
        t = time_p2(shape, x)
        errs[names[shape[0]]] = max(errs[names[shape[0]]], t["err"])
        tot = totals[names[shape[0]]]
        tot[0] += n
        tot[1] += n * t["ms"]
        tot[2] += n * (t["ms"] - t["bound_ms"])
        del x
    out = {k: dict(launches=v[0], sum_ms=round(v[1], 4),
                   lost_ms=round(v[2], 4)) for k, v in totals.items()}
    log("per prove, by kernel (launches, sum of launches x time, sum of "
        "launches x (time - bound)): " + json.dumps(out))
    return out, errs


def flagship():
    """Synthesis, setup, one cold and three warm proves on the card. Returns
    the launch counts of the path and one prove's launches by shape."""
    import numpy as np
    import torch
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.gadgets.sha256 import build_sha256_circuit
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.ntt import mxu_ntt
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)
    from boojum_tpu_torch.prover.proof import proof_to_json

    with open(os.path.join(ROOT, "boojum_tpu_torch", "data",
                           "flagship_proof_digest.json")) as f:
        ref = json.load(f)
    data = bytes(np.random.default_rng(ref["seed"]).integers(
        0, 256, ref["input_len"], dtype=np.uint8))
    t0 = time.time()
    cs, _ = build_sha256_circuit(data, max_trace_len=ref["max_trace_len"])
    cs.pad_and_shrink()
    t_synth = time.time() - t0
    log("flagship synthesis %.2f s, domain %d" % (t_synth, cs.final_trace_len))

    reset_counts()  # counts of the main path only
    t0 = time.time()
    sb = create_base_setup(cs)
    t_base = time.time() - t0
    cfg = ProofConfig(**ref["config"])
    t0 = time.time()
    art = create_device_setup(cs, sb, cfg, ref["hasher"], device="cuda")
    prover = DeviceProver(cs, art, cfg, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    log("flagship create_base_setup %.2f s, create_device_setup %.2f s"
        % (t_base, t_setup))

    def prove():
        t = time.time()
        proof = prover.prove(ref["transcript"], ref["hasher"])
        torch.cuda.synchronize()
        return proof, time.time() - t

    torch.cuda.reset_peak_memory_stats()
    proof, t_cold = prove()
    warm = []
    for _ in range(3):
        before = read_counts()
        k1_before, p2_before = mxu_ntt.SHAPES.copy(), pp.SHAPES.copy()
        proof, t = prove()
        warm.append(t)
    counts = read_counts()
    per_prove = {k: counts[k] - before[k] for k in counts}
    k1_shapes = mxu_ntt.SHAPES - k1_before
    p2_shapes = pp.SHAPES - p2_before
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("flagship prove cold %.3f s, warm %s s, peak device memory %.2f GB"
        % (t_cold, ", ".join("%.3f" % w for w in warm), peak_gb))
    log("flagship launches (setup + 4 proves): %s; per prove: %s"
        % (json.dumps(counts), json.dumps(per_prove)))
    for name in ("ntt_stage", "poseidon2_leaf_hashes", "poseidon2_node_layer"):
        if counts[name] <= 0:
            raise AssertionError("%s never launched on the main path" % name)
    if counts["plain_on_cuda"]:
        raise AssertionError("a plain version ran on a CUDA tensor")

    text = proof_to_json(proof)
    digest = hashlib.sha256(text.encode()).hexdigest()
    log("flagship proof_to_json: %d chars, sha256 %s (reference %s)"
        % (len(text), digest, ref["proof_json_sha256"]))
    if digest != ref["proof_json_sha256"]:
        raise AssertionError("flagship proof differs from the reference")

    prover.prove(ref["transcript"], ref["hasher"], verbose=True)
    log("flagship stage split (synced, one extra prove): " + json.dumps(
        {k: round(v, 4) for k, v in prover.last_stage_times.items()}))
    return counts, k1_shapes, p2_shapes


def permute_path(rng):
    """The batch permutation entry point on 2^20 random states, against its
    plain version. No path of the port calls `permutation_stacked_fast` (the
    trees use the leaf and node entries); this phase is made up so that the
    `poseidon2_permute` entry still launches once."""
    import torch
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    st = rand_field(rng, (12, 1 << 20))
    reset_counts()  # counts of this path only
    out = pp.permutation_stacked_fast(st)
    torch.cuda.synchronize()
    counts = read_counts()
    log("permute path (12, 2^20): launches %s" % json.dumps(counts))
    if counts["poseidon2_permute"] != 1 or counts["plain_on_cuda"]:
        raise AssertionError("the permute path should launch "
                             "poseidon2_permute once and no plain version")
    require_equal(out, pp.permutation_plain(st), "permute path output")
    return counts


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 1
    from boojum_tpu_torch.utils import cuda_build

    kernels_only = "--kernels-only" in sys.argv[1:]
    card = card_line()  # name, power.limit as nvidia-smi prints them
    log(card)
    t0 = time.time()
    cuda_build.build_all(verbose=True)
    log("build: %.1f s (%s)" % (time.time() - t0, ", ".join(cuda_build.KERNELS)))
    sass = sass_report()

    rng = np.random.default_rng(7)
    k1_err = check_ntt_stage(rng)
    k1 = time_ntt_stage(rng, 256, 1 << 17, False, 1, 256, plain=True)
    log("ntt_stage (256, 2^17) twmode 1: %.4f ms kernel, %.3f ms plain, "
        "bound %.4f ms (%s), %.1f%% of bound"
        % (k1["ms"], k1["plain_ms"], k1["bound_ms"], k1["bound_by"],
           100 * k1["bound_ms"] / k1["ms"]))
    p2 = check_poseidon2(rng)
    k4_err, k4 = check_ntt_small(rng)
    if kernels_only:
        log("chip_smoke: --kernels-only, stopping after the kernel checks")
        return 0

    counts, k1_shapes, p2_shapes = flagship()
    costs, prove_errs = per_prove_costs(rng, k1_shapes, p2_shapes)
    ntt_counts = ntt_path(k4)
    perm_counts = permute_path(rng)

    def row(name, source, replaces, launches, err, t):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=None)

    p2_src = "boojum_tpu_torch/csrc/poseidon2.cu"
    kernels = [
        row("ntt_stage", "boojum_tpu_torch/csrc/ntt_stage.cu",
            "boojum_tpu/ntt/mxu_ntt.py:339", counts["ntt_stage"],
            max(k1_err, k1["err"], prove_errs["ntt_stage"]), k1),
        row("poseidon2_permute", p2_src, P2_REPLACES,
            perm_counts["poseidon2_permute"], *p2["poseidon2_permute"]),
        row("ntt_small", "boojum_tpu_torch/csrc/ntt_small.cu",
            "boojum_tpu/ntt/pallas_ntt.py:52", ntt_counts["ntt_small"],
            k4_err, k4[(9, 1 << 18, "twiddle")]),
        row("poseidon2_leaf_hashes", p2_src, P2_REPLACES,
            counts["poseidon2_leaf_hashes"],
            max(p2["poseidon2_leaf_hashes"][0],
                prove_errs["poseidon2_leaf_hashes"]),
            p2["poseidon2_leaf_hashes"][1]),
        row("poseidon2_node_layer", p2_src, P2_REPLACES,
            counts["poseidon2_node_layer"],
            max(p2["poseidon2_node_layer"][0],
                prove_errs["poseidon2_node_layer"]),
            p2["poseidon2_node_layer"][1]),
    ]
    log("summary: " + json.dumps(dict(per_prove=costs, sass={
        k: {f: v[f] for f in ("total", "integer", "imad", "integer_per_pass",
                              "integer_per_element") if f in v}
        for k, v in sass.items()})))
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
