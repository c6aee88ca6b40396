"""Compare versions of the Poseidon2, ntt_stage, ntt_small, poseidon (K6)
and sha256_witness (K5) kernels on one card: SASS instruction counts and
times, in one process.

Each variant is ``LABEL=CSRC_DIR``; its `poseidon2.cu`, `ntt_stage.cu`,
`ntt_small.cu`, `poseidon.cu` and `sha256_witness.cu` are compiled by
`boojum_tpu_torch/utils/cuda_build.build` into
`boojum_tpu_torch/_build/compare/<label>/`. Per kernel it prints one
JSON line of SASS counts (`cuda_build.sass_summary`): all instructions,
integer-pipe ones, IMADs and the loops, for the Poseidon2 permutation
kernel the integer instructions per permutation (each round loop's body
times its trip count), and for K5 and K6 the integer instructions of one
round of their chains (`cuda_build.chain_per_round`). Then it times
`poseidon2_permute` at B = 2^16 and 2^20, `ntt_stage` at (256, 2^17)
forward with the cross twiddle (twmode 1), `ntt_small` at (512, 2^18) and
(8, 2^24), forward and inverse, `poseidon_absorb` at 62 rate blocks (the
flagship prove's largest), `poseidon_permute` and `sha256_witness` at 129
blocks (the flagship's), the variants in turns (A B ... B A), and checks
that every variant's outputs equal the first's. Every K6 variant gets the
round constants followed by the MDS exponents (the table of the first K6,
whose successor reads only the constants). An `ntt_small.cu` without the cross-twiddle epilogue
(before `tt_shift`) has the older entry (x, y, stage table, log_n, batch,
inverse, n^-1, stream); the script calls each variant by its own. Needs the
card and the CUDA toolkit:

    python3 scripts/torch_kernel_compare.py old=OLD_CSRC new=boojum_tpu_torch/csrc
"""

import concurrent.futures
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LIBS = ("poseidon2", "ntt_stage", "ntt_small", "poseidon", "sha256_witness")


def sass_lines(label, out_dir):
    from boojum_tpu_torch.utils import cuda_build
    for name in LIBS:
        lib = os.path.join(out_dir, "lib%s.so" % name)
        for kname, instrs in sorted(cuda_build.sass(lib).items()):
            # the permutation kernel: "poseidon2_kernel" before the fused
            # entries came, "permute_kernel" since
            per_perm = name == "poseidon2" and (
                "permute_kernel" in kname or "poseidon2_kernel" in kname)
            trips = ()
            if per_perm:  # sources before the s-box block loops: 3 loops
                loops = len(cuda_build.sass_summary(instrs)["loops"])
                trips = cuda_build.P2_ROUND_TRIPS if loops == len(
                    cuda_build.P2_ROUND_TRIPS) else (4, 22, 4)
            s = cuda_build.sass_summary(instrs, trips)
            if name in ("poseidon", "sha256_witness"):
                s["integer_per_round"] = cuda_build.chain_per_round(
                    name, instrs, s)
            print(json.dumps(dict(variant=label, library=name, kernel=kname,
                                  **s)), flush=True)


def load(out_dir, csrc):
    import ctypes

    import numpy as np
    from boojum_tpu_torch.hash import poseidon2 as p2mod
    from boojum_tpu_torch.utils import cuda_build
    p2, k1, k4, k6, k5 = (cuda_build.open_lib(
        os.path.join(out_dir, "lib%s.so" % name), name) for name in LIBS)
    with open(os.path.join(csrc, "ntt_small.cu")) as f:
        k4.epilogue = "tt_shift" in f.read()
    if not k4.epilogue:
        k4.ntt_small.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.c_void_p]
    # the kernel before the fused entries took the diagonal factors
    # 2^shift, later ones take the shifts
    rc = np.asarray(p2mod._RC, np.uint64)
    diag = np.asarray(p2mod._DIAG_SHIFTS, np.int64) \
        if hasattr(p2, "poseidon2_leaf_hashes") else \
        np.asarray([1 << s for s in p2mod._DIAG_SHIFTS], np.uint64)
    cuda_build.check(p2.poseidon2_set_constants(rc.ctypes.data,
                                                diag.ctypes.data), "constants")
    return p2, k1, k4, k6, k5


def main(argv):
    import numpy as np
    import torch
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.ntt import mxu_ntt, ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    from boojum_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("torch_kernel_compare: CUDA is not available", file=sys.stderr)
        return 1
    variants = dict(arg.split("=", 1) for arg in argv)
    dirs = {label: os.path.join(cuda_build.BUILD, "compare", label)
            for label in variants}
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        # every variant's nvcc processes at once
        list(pool.map(lambda lb: cuda_build.build(LIBS, variants[lb],
                                                  dirs[lb]), variants))
    for label in variants:
        sass_lines(label, dirs[label])
    # one card: load every variant's libraries into this process
    loaded = {label: load(dirs[label], csrc) for label, csrc in
              variants.items()}

    rng = np.random.default_rng(11)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}

    def permute_call(st):
        def call(lib):
            out = torch.empty_like(st)
            cuda_build.check(lib[0].poseidon2_permute(
                st.data_ptr(), out.data_ptr(), st.shape[1], stream), "permute")
            return out
        return call

    for b in (1 << 16, 1 << 20):
        st = gl.from_u64(rng.integers(0, gl.ORDER, (12, b), dtype=np.uint64),
                         "cuda")
        cases["poseidon2_permute B=%d" % b] = permute_call(st)
    x = gl.from_u64(rng.integers(0, gl.ORDER, (256, 1 << 17), dtype=np.uint64),
                    "cuda")
    tw = gl.from_u64(ntt.fourstep_twiddles_host(8, 8), "cuda")
    table = mxu_ntt._stage_twiddles_device(8, False, x.device)

    def k1_call(lib):
        y = torch.empty_like(x)
        cuda_build.check(lib[1].ntt_stage(
            x.data_ptr(), y.data_ptr(), table.data_ptr(), tw.data_ptr(), 8,
            x.shape[1], 0, 1, tw.shape[1], 1, stream), "ntt_stage")
        return y
    cases["ntt_stage (256, 2^17) twmode 1"] = k1_call

    def k4_case(log_n, b, inverse, tw=None, shift=0):
        x4 = gl.from_u64(rng.integers(0, gl.ORDER, (1 << log_n, b),
                                      dtype=np.uint64), "cuda")
        st = pn._stage_tables_device(log_n, inverse, x4.device)

        def call(lib):
            if tw is not None and not lib[2].epilogue:
                return None  # a kernel without the cross-twiddle epilogue
            y = torch.empty_like(x4)
            if lib[2].epilogue:
                rc = lib[2].ntt_small(
                    x4.data_ptr(), y.data_ptr(), st.data_ptr(),
                    None if tw is None else tw.data_ptr(), log_n, b,
                    int(inverse), shift, stream)
            else:
                rc = lib[2].ntt_small(x4.data_ptr(), y.data_ptr(),
                                      st.data_ptr(), log_n, b, int(inverse),
                                      gl.s_inv(1 << log_n), stream)
            cuda_build.check(rc, "ntt_small")
            return y
        return call

    for (log_n, b) in ((9, 1 << 18), (3, 1 << 24)):
        for inverse in (False, True):
            cases["ntt_small (%d, 2^%d) %s" % (
                1 << log_n, b.bit_length() - 1,
                "inverse" if inverse else "forward")] = k4_case(log_n, b,
                                                                inverse)
    # the NTT path's tables: inner (512, 8) at shift 15, outer re-laid
    # (8, 2^21) at shift 3 (timed for the variants that take them)
    inner = ntt.fourstep_twiddles_device(9, 3, False, x.device)
    outer = pn.relaid_twiddles(ntt.fourstep_twiddles_device(
        12, 12, False, x.device), 9)
    cases["ntt_small (512, 2^18) twiddle"] = k4_case(9, 1 << 18, False,
                                                     inner, 15)
    cases["ntt_small (8, 2^24) twiddle"] = k4_case(3, 1 << 24, False,
                                                   outer, 3)

    # K6 and K5 at the flagship prove's shapes
    from boojum_tpu_torch.gadgets.sha256 import INITIAL_STATE
    from boojum_tpu_torch.hash import poseidon
    k6_table = gl.from_u64(np.concatenate([
        np.asarray(poseidon._RC, np.uint64),
        np.asarray(poseidon._EXPS, np.uint64)]), "cuda")
    k6_state = gl.from_u64(rng.integers(0, gl.ORDER, 12, dtype=np.uint64),
                           "cuda")
    k6_elems = gl.from_u64(rng.integers(0, gl.ORDER, 62 * 8 - 1,
                                        dtype=np.uint64), "cuda")

    def k6_absorb(lib):
        out = torch.empty_like(k6_state)
        cuda_build.check(lib[3].poseidon_absorb(
            k6_state.data_ptr(), k6_elems.data_ptr(), k6_elems.shape[0],
            out.data_ptr(), k6_table.data_ptr(), stream), "poseidon_absorb")
        return out

    def k6_permute(lib):
        out = torch.empty_like(k6_state)
        cuda_build.check(lib[3].poseidon_permute(
            k6_state.data_ptr(), out.data_ptr(), k6_table.data_ptr(), stream),
            "poseidon_permute")
        return out

    blocks = torch.as_tensor(rng.integers(0, 256, (129, 64)),
                             dtype=torch.int64).cuda()
    init = torch.tensor(INITIAL_STATE, dtype=torch.int64).cuda()

    def k5_call(lib):
        out = blocks.new_empty((20, 129, 64))
        cuda_build.check(lib[4].sha256_witness(
            blocks.data_ptr(), init.data_ptr(), out.data_ptr(), 129, stream),
            "sha256_witness")
        return out
    cases["poseidon_absorb 62 blocks"] = k6_absorb
    cases["poseidon_permute"] = k6_permute
    cases["sha256_witness nb=129"] = k5_call

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for case, fn in cases.items():
        labels = [label for label in variants
                  if fn(loaded[label]) is not None]
        order = labels + labels[::-1]
        ref = fn(loaded[labels[0]])
        times = {label: [] for label in labels}
        for label in order:
            lib = loaded[label]
            if not torch.equal(fn(lib), ref):
                raise AssertionError("%s: %s differs from %s"
                                     % (case, label, labels[0]))
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn(lib)
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / 20)
        print(json.dumps(dict(case=case, card=card, ms=times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
