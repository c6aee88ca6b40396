"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from `boojum_tpu_torch/csrc/`, holds each one
bit-exactly against its plain PyTorch version on the card at the shapes of
the flagship proof, then proves the flagship 8 kB SHA-256 circuit (2^16 rows,
LDE 8, cap 16, Poseidon transcript, Poseidon2 trees) through the port's entry
points and requires the sha256 of `proof_to_json(proof)` to equal the
reference digest committed in `boojum_tpu_torch/data/flagship_proof_digest.json`
(made by `scripts/torch_reference_digest.py` from the JAX package). Then it
holds the all-stage small NTT kernel against its plain version and runs the
standalone NTT entry point `pallas_ntt.ntt_any` at (2^24, 8), whose output
must equal the digest in `boojum_tpu_torch/data/ntt_2e24_digest.json` (made
by `scripts/torch_reference_ntt_digest.py`) and the radix-256 route
`ntt.ntt_fourstep_cols`.

    python3 chip_smoke.py

Prints the card's `name, power.limit`, a `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, with no result line, when
CUDA or nvidia-smi is unavailable or any phase fails.
"""

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
    if np.array_equal(ha, hb):
        return 0.0
    return float(np.max(np.abs(ha.astype(np.float64) - hb.astype(np.float64))))


def check_ntt_stage(rng, results):
    """K1 against its plain version at the flagship's shapes."""
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.ntt import mxu_ntt, ntt

    P = gl.ORDER
    cases = [  # (R, M, inverse, twmode, where the prove runs it)
        (256, 1 << 17, False, 1, "LDE first pass, (2^16, 8 cosets x 64 cols)"),
        (256, 1 << 17, False, 0, "LDE second pass"),
        (256, 1 << 14, True, 0, "monomials first pass, (2^16, 64 cols)"),
        (256, 1 << 14, True, 2, "monomials second pass"),
        (128, 1 << 17, False, 0, "radix-128 stage (2^14-row domains)"),
        (128, 1 << 17, True, 2, "radix-128 inverse with twiddle"),
    ]
    for (r, m, inverse, twmode, where) in cases:
        x = gl.from_u64(rng.integers(0, P, (r, m), dtype=np.uint64), "cuda")
        tw = None
        if twmode:
            log_r = r.bit_length() - 1
            w = ntt.fourstep_twiddles_host(log_r, 8, inverse)
            tw = gl.from_u64(w, "cuda")
        kw = dict(inverse=inverse, tw=tw, tw_pre=twmode == 2)
        got = mxu_ntt.ntt_cols_matmul(x, **kw)
        want = mxu_ntt.ntt_stage_plain(x, **kw)
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError("ntt_stage R=%d M=%d inverse=%s twmode=%d "
                                 "differs from its plain version (max abs "
                                 "err %g)" % (r, m, inverse, twmode, err))
        ms = cuda_ms(lambda: mxu_ntt.ntt_cols_matmul(x, **kw), 20)
        plain_ms = cuda_ms(lambda: mxu_ntt.ntt_stage_plain(x, **kw), 2)
        log_r = r.bit_length() - 1
        nbytes = 2 * r * m * 8 + (tw.numel() * 8 if tw is not None else 0)
        muls = (r // 2) * log_r * m + r * m * (int(inverse) + int(twmode > 0))
        b_ms, b_by = bound(nbytes, muls)
        log("ntt_stage R=%d M=%d inverse=%d twmode=%d (%s): bit-equal, "
            "%.4f ms kernel, %.3f ms plain, bound %.4f ms (%s), %.1f%% of bound"
            % (r, m, inverse, twmode, where, ms, plain_ms, b_ms, b_by,
               100 * b_ms / ms))
        results.append(dict(r=r, m=m, inverse=inverse, twmode=twmode, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            err=err))


def check_poseidon2(rng, results):
    """K2 against its plain version at one Merkle layer's batch sizes."""
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp

    for b in (1 << 16, 1 << 20):
        st = gl.from_u64(rng.integers(0, gl.ORDER, (12, b), dtype=np.uint64),
                         "cuda")
        got = pp.permutation_stacked_fast(st)
        want = pp.permutation_plain(st)
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError("poseidon2 B=%d differs from its plain "
                                 "version (max abs err %g)" % (b, err))
        ms = cuda_ms(lambda: pp.permutation_stacked_fast(st), 20)
        plain_ms = cuda_ms(lambda: pp.permutation_plain(st), 2)
        # s-box multiplies: 8 full rounds x 12 x 4, 22 partial rounds x 4
        b_ms, b_by = bound(2 * 12 * 8 * b, (8 * 12 * 4 + 22 * 4) * b)
        log("poseidon2 B=%d: bit-equal, %.4f ms kernel (%.1f M perm/s), "
            "%.3f ms plain, bound %.4f ms (%s), %.1f%% of bound"
            % (b, ms, b / ms / 1e3, plain_ms, b_ms, b_by, 100 * b_ms / ms))
        results.append(dict(b=b, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, err=err))


def check_ntt_small(rng, results):
    """K4 against its plain version, forward and inverse: small and large n,
    batches that are not a multiple of the kernel's tile, and the two shapes
    of the NTT path, (512, 2^18) and (8, 2^24)."""
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.ntt import pallas_ntt as pn

    cases = [(0, 7), (1, 1 << 20), (3, 3001), (9, 1000), (12, 1030),
             (9, 1 << 18), (3, 1 << 24)]
    for (log_n, b) in cases:
        n = 1 << log_n
        x = gl.from_u64(rng.integers(0, gl.ORDER, (n, b), dtype=np.uint64),
                        "cuda")
        for inverse in (False, True):
            got = pn.ntt_small(x, log_n, inverse)
            want = pn.ntt_small_plain(x, log_n, inverse)
            err = max_abs_err(got, want)
            if err != 0.0:
                raise AssertionError("ntt_small n=%d B=%d inverse=%s differs "
                                     "from its plain version (max abs err %g)"
                                     % (n, b, inverse, err))
            ms = cuda_ms(lambda: pn.ntt_small(x, log_n, inverse), 20)
            plain_ms = cuda_ms(lambda: pn.ntt_small_plain(x, log_n, inverse),
                               2)
            muls = (n // 2) * log_n * b + n * b * int(inverse)
            b_ms, b_by = bound(2 * n * b * 8 + n * 8, muls)
            log("ntt_small n=%d B=%d inverse=%d: bit-equal, %.4f ms kernel, "
                "%.3f ms plain, bound %.4f ms (%s), %.1f%% of bound"
                % (n, b, inverse, ms, plain_ms, b_ms, b_by, 100 * b_ms / ms))
            results.append(dict(log_n=log_n, b=b, inverse=inverse, ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, err=err))
        del x, got, want


def ntt_path(k4_ms):
    """The standalone NTT entry point at 2^24 x 8: `pallas_ntt.ntt_any` (the
    K4 route) against the committed JAX digest and against the K1 route
    (`ntt.ntt_fourstep_cols`), with both routes timed. ``k4_ms`` maps a K4
    shape (log_n, B) to its forward kernel time."""
    import numpy as np
    import torch
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.ntt import mxu_ntt, ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn

    with open(os.path.join(ROOT, "boojum_tpu_torch", "data",
                           "ntt_2e24_digest.json")) as f:
        ref = json.load(f)
    n, b = ref["shape"]
    log_n = n.bit_length() - 1
    x = gl.from_u64(np.random.default_rng(ref["seed"]).integers(
        0, gl.ORDER, (n, b), dtype=np.uint64), "cuda")

    for mod in (mxu_ntt, pp, pn):  # counts of the NTT path only
        mod.LAUNCHES = 0
        mod.PLAIN_CUDA_CALLS = 0
    out = pn.ntt_any(x, log_n)
    torch.cuda.synchronize()
    launches = pn.LAUNCHES
    plain_cuda = (mxu_ntt.PLAIN_CUDA_CALLS, pp.PLAIN_CUDA_CALLS,
                  pn.PLAIN_CUDA_CALLS)
    log("ntt path (%d, %d): ntt_small launches %d, ntt_stage %d, poseidon2 "
        "%d; plain versions on CUDA: %s"
        % (n, b, launches, mxu_ntt.LAUNCHES, pp.LAUNCHES, plain_cuda))
    if launches != 4 or log_n != 24:
        raise AssertionError("ntt_any at 2^24 should launch ntt_small 4 "
                             "times, got %d at 2^%d" % (launches, log_n))
    if any(plain_cuda):
        raise AssertionError("a plain version ran on a CUDA tensor")

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
    # 2^9 x 2^3: 4 kernel launches, 3 cross-twiddle multiplies (2 inner on
    # (512, 8, 2^15), 1 outer on (4096, 4096, 8)) and 6 transpose copies
    # (4 inner, 2 outer), each pass over all 2^27 elements. Time each part
    # alone on the same data.
    inner, outer = x.view(512, 8, -1), x.view(4096, 4096, b)
    tw_in = gl.from_u64(ntt.fourstep_twiddles_host(9, 3), "cuda")[:, :, None]
    tw_out = pn._fourstep_twiddles_device(12, 12, x.device)[:, :, None]
    parts = dict(
        kernels=2 * k4_ms[(9, n * b // 512)] + 2 * k4_ms[(3, n * b // 8)],
        mul_inner=2 * cuda_ms(lambda: gl.mul(inner, tw_in), 3),
        mul_outer=cuda_ms(lambda: gl.mul(outer, tw_out), 3),
        transpose_inner=4 * cuda_ms(
            lambda: inner.transpose(0, 1).reshape(8, -1), 10),
        transpose_outer=2 * cuda_ms(
            lambda: outer.transpose(0, 1).reshape(4096, -1), 10))
    b_ms, _ = bound(13 * 2 * n * b * 8, 0)
    log("ntt path ntt_any (K4 route): %.3f ms per call, %.3f ms per 2^%d "
        "transform, %.2f NTT/s; byte bound of its 4 kernel passes + 3 twiddle "
        "multiplies + 6 transposes %.3f ms"
        % (ms_k4, ms_k4 / b, log_n, b * 1e3 / ms_k4, b_ms))
    log("ntt path split per call (parts timed alone, ms): " + json.dumps(
        {k: round(v, 4) for k, v in parts.items()}))
    # the K1 route uploads its (256, 2^16) cross-twiddle table on every call
    ms_up = cuda_ms(lambda: gl.from_u64(ntt.fourstep_twiddles_host(8, 16),
                                        "cuda"), 3)
    log("ntt path ntt_fourstep_cols (K1 route): %.3f ms per call, %.3f ms "
        "per transform, %.2f NTT/s; of which its twiddle upload %.3f ms"
        % (ms_k1, ms_k1 / b, b * 1e3 / ms_k1, ms_up))
    return launches


def flagship():
    """Synthesis, setup, one cold and three warm proves on the card."""
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

    for mod in (mxu_ntt, pp):  # counts of the main path only
        mod.LAUNCHES = 0
        mod.PLAIN_CUDA_CALLS = 0
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
        before = (mxu_ntt.LAUNCHES, pp.LAUNCHES)
        proof, t = prove()
        warm.append(t)
    per_prove = (mxu_ntt.LAUNCHES - before[0], pp.LAUNCHES - before[1])
    launches = (mxu_ntt.LAUNCHES, pp.LAUNCHES)
    plain_cuda = (mxu_ntt.PLAIN_CUDA_CALLS, pp.PLAIN_CUDA_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("flagship prove cold %.3f s, warm %s s, peak device memory %.2f GB"
        % (t_cold, ", ".join("%.3f" % w for w in warm), peak_gb))
    log("flagship launches (setup + 4 proves): ntt_stage %d, poseidon2 %d; "
        "per prove: ntt_stage %d, poseidon2 %d; plain versions on CUDA: %s"
        % (launches + per_prove + (plain_cuda,)))
    if min(launches) <= 0:
        raise AssertionError("a kernel of the main path never launched")
    if any(plain_cuda):
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
    return launches


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 1
    from boojum_tpu_torch.utils import cuda_build

    card = card_line()  # name, power.limit as nvidia-smi prints them
    t0 = time.time()
    cuda_build.build_all(verbose=True)
    log("build: %.1f s (%s)" % (time.time() - t0, ", ".join(cuda_build.KERNELS)))

    rng = np.random.default_rng(7)
    ntt_res, p2_res, k4_res = [], [], []
    check_ntt_stage(rng, ntt_res)
    check_poseidon2(rng, p2_res)
    launches = flagship()
    check_ntt_small(rng, k4_res)
    k4_launches = ntt_path({(r["log_n"], r["b"]): r["ms"] for r in k4_res
                            if not r["inverse"]})
    k1, k2 = ntt_res[0], p2_res[0]
    k4 = next(r for r in k4_res if (r["log_n"], r["b"]) == (9, 1 << 18))
    kernels = [
        dict(name="ntt_stage", route="cuda",
             source="boojum_tpu_torch/csrc/ntt_stage.cu",
             replaces="boojum_tpu/ntt/mxu_ntt.py:339",
             launches=launches[0], max_abs_err=max(r["err"] for r in ntt_res),
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="poseidon2_permute", route="cuda",
             source="boojum_tpu_torch/csrc/poseidon2.cu",
             replaces="boojum_tpu/hash/pallas_poseidon2.py:43",
             launches=launches[1], max_abs_err=max(r["err"] for r in p2_res),
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="ntt_small", route="cuda",
             source="boojum_tpu_torch/csrc/ntt_small.cu",
             replaces="boojum_tpu/ntt/pallas_ntt.py:52",
             launches=k4_launches, max_abs_err=max(r["err"] for r in k4_res),
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None),
    ]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
