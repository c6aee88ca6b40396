"""Compare versions of the stage-2+3 kernels (`csrc/stage23.cu`:
`stage23_rows` and `stage23_scan`) on one card, in one process, at the
row-kernel keys that the proves launch.

Each variant is ``LABEL=CSRC_DIR``; its `stage23.cu` is compiled by
`boojum_tpu_torch/utils/cuda_build.build` into
`boojum_tpu_torch/_build/compare_stage23/<label>/`. A `stage23_scan` that
takes an epoch is the single-pass scan (one launch, its status words
`stage23.Launch.prods`, a new epoch a call); an older one, the three-launch
scan with its block-product scratch. Both take the same `stage23_rows`
arguments.

For each variant it prints the registers, stack and spills of its kernels
(``cuobjdump -res-usage``) and their SASS counts (`cuda_build.sass_summary`:
all, integer-pipe, IMAD). Then, per key, one JSON line a variant: the
rows kernel's and the scan's times (CUDA events around 20 calls, the host
work of each call included, as a prove pays it), the variants in turns
(A B ... B A), and whether its output equals `stage23_plain`'s; then each
variant's times by configuration (one launch of each kernel a prove).
``--flagship-only`` times the flagship's key alone. Every variant
must equal the plain version, except those whose label begins with
``probe``: edited copies timed to find what rules a kernel, whose outputs
may be wrong by design. Needs the card and the CUDA toolkit:

    python3 scripts/torch_stage23_compare.py [--flagship-only] old=OLD_CSRC new=boojum_tpu_torch/csrc [probe_x=DIR ...]

where OLD_CSRC holds older sources with the headers they include, for
example from ``git archive <commit> boojum_tpu_torch/csrc``.
"""

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ITERS = 20
# rows a block of the three-launch scan (the kernels before the single-pass
# scan)
OLD_SCAN_BLOCK = 256
# (configuration, row-kernel key `stage23.Launch.key`): every key the proves
# of `chip_smoke.py` launch, one launch of each kernel a prove (`chip_smoke.py`
# prints them as "stage23 prove keys"); the flagship's circuit is also the
# Poseidon-tree, Blake2s and Keccak-256 flagships' and the Keccak-256
# circuit's
KEYS = (
    ("flagship", ("rows", 1 << 16, 92, 4, 93, 105, 64, 1, 8, 4, 60, 4, 1, 100,
                  5, 92, False)),
    ("lookup_heavy_specialized", ("rows", 1 << 17, 56, 4, 57, 67, 46, 1, 8, 3,
                                  32, 3, 1, 63, 4, 56, False)),
    ("lookup_heavy_general", ("rows", 1 << 17, 32, 4, 33, 42, 38, 1, 10, 3, 0,
                              3, 1, 38, 4, 32, True)),
    ("recursion_outer", ("rows", 4096, 132, 16, 132, 142, 18) + (0,) * 9
     + (False,)),
    ("recursion_inner", ("rows", 32, 16, 8, 16, 22, 4) + (0,) * 9 + (False,)),
)


class Variant:
    """One variant's library and how it runs each kernel of a launch."""

    def __init__(self, label, csrc, lib_path):
        from boojum_tpu_torch.utils import cuda_build
        self.label = label
        self.lib_path = lib_path
        self.lib = cuda_build.open_lib(lib_path, "stage23")
        with open(os.path.join(csrc, "stage23.cu")) as f:
            self.single_pass = "long long epoch" in f.read()
        if not self.single_pass:  # out, block products, n, chunks, ldo, stream
            P, LL = ctypes.c_void_p, ctypes.c_longlong
            self.lib.stage23_scan.argtypes = [P, P, LL, ctypes.c_int, LL, P]

    def prepare(self, launch):
        """Scratch of this variant's scan for ``launch``."""
        if self.single_pass:
            return None
        blocks = -(-launch.n // OLD_SCAN_BLOCK)
        return launch.out.new_empty((blocks, 2)) if blocks > 1 else None

    def rows(self, launch):
        from boojum_tpu_torch.utils import cuda_build
        cuda_build.check(self.lib.stage23_rows(
            *(None if t is None else t.data_ptr() for t in launch.inputs),
            launch.out.data_ptr(), launch.params.ctypes.data, launch.stream),
            "stage23_rows")

    def scan(self, launch, scratch):
        from boojum_tpu_torch.prover import stage23
        from boojum_tpu_torch.utils import cuda_build
        if self.single_pass:
            rc = self.lib.stage23_scan(
                launch.out.data_ptr(), launch.prods.data_ptr(), launch.n,
                launch.chunks, launch.out.shape[1], stage23.new_epoch(),
                launch.stream)
        else:
            rc = self.lib.stage23_scan(
                launch.out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), launch.n,
                launch.chunks, launch.out.shape[1], launch.stream)
        cuda_build.check(rc, "stage23_scan")


def res_usage(lib_path):
    """{kernel: {REG, STACK, SHARED, LOCAL, ...}} from ``cuobjdump
    -res-usage``."""
    from boojum_tpu_torch.utils import cuda_build
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-res-usage", lib_path],
                         capture_output=True, text=True, check=True).stdout
    usage, cur = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            cur = line[len("Function "):].rstrip(":")
        elif cur and line.startswith("REG:"):
            usage[cur] = {k: int(v) for k, v in (
                f.split(":", 1) for f in line.split() if ":" in f)
                if v.isdigit()}
    return usage


def sass_counts(lib_path):
    from boojum_tpu_torch.utils import cuda_build
    return {k: {f: s[f] for f in ("total", "integer", "imad")}
            for k, s in ((k, cuda_build.sass_summary(i))
                         for k, i in cuda_build.sass(lib_path).items())}


def _turns(variants, fn):
    """{label: [ms, ms]}: ``fn(v)`` timed for each variant in turns."""
    import chip_smoke
    times = {v.label: [] for v in variants}
    for v in variants + variants[::-1]:
        times[v.label].append(chip_smoke.cuda_ms(lambda: fn(v), ITERS))
    return times


def main(argv):
    import numpy as np
    import torch
    import chip_smoke
    from boojum_tpu_torch.prover import stage23
    from boojum_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("torch_stage23_compare: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    keys = KEYS[:1] if "--flagship-only" in argv else KEYS
    specs = dict(arg.split("=", 1) for arg in argv if not arg.startswith("--"))
    dirs = {label: os.path.join(cuda_build.BUILD, "compare_stage23", label)
            for label in specs}
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        list(pool.map(lambda lb: cuda_build.build(
            ["stage23"], specs[lb], dirs[lb], verbose=True), specs))
    variants = [Variant(label, specs[label],
                        os.path.join(dirs[label], "libstage23.so"))
                for label in specs]
    # `stage23.Launch` packs the arguments; its own library is not built
    cuda_build._LIBS.setdefault("stage23", variants[0].lib)
    for v in variants:
        print(json.dumps(dict(variant=v.label, single_pass=v.single_pass,
                              res_usage=res_usage(v.lib_path),
                              sass=sass_counts(v.lib_path))), flush=True)
    rng = np.random.default_rng(16)
    per_prove = {v.label: {} for v in variants}
    for config, key in keys:
        args, _ = chip_smoke.stage23_inputs(rng, key, True)
        want = stage23.stage23_plain(*args)
        launch = stage23.Launch(*args)
        scratch = {}
        for v in variants:
            scratch[v.label] = v.prepare(launch)
            launch.out.fill_(0)
            v.rows(launch)
            v.scan(launch, scratch[v.label])
            equal = bool(torch.equal(launch.out, want))
            if not equal and not v.label.startswith("probe"):
                raise AssertionError("%s differs from stage23_plain at %s"
                                     % (v.label, key[1:]))
            v.equal = equal
        t_rows = _turns(variants, lambda v: v.rows(launch))
        t_scan = _turns(variants, lambda v: v.scan(launch, scratch[v.label]))
        (rb, _), (sb, _) = chip_smoke.stage23_bounds(key)
        for v in variants:
            rows_ms = sum(t_rows[v.label]) / len(t_rows[v.label])
            scan_ms = sum(t_scan[v.label]) / len(t_scan[v.label])
            per_prove[v.label][config] = dict(rows_ms=rows_ms,
                                              scan_ms=scan_ms)
            print(json.dumps(dict(
                variant=v.label, config=config, key=list(key[1:]),
                equal_plain=v.equal, rows_ms=rows_ms, scan_ms=scan_ms,
                rows_bound_ms=rb, scan_bound_ms=sb,
                rows_each_turn=t_rows[v.label],
                scan_each_turn=t_scan[v.label])), flush=True)
        del launch, want, args
        torch.cuda.empty_cache()
    for label, tot in per_prove.items():
        print(json.dumps(dict(variant=label, per_prove=tot)), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
