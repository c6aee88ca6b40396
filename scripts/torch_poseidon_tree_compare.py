"""Compare versions of the Merkle-tree kernels of the algebraic tree
hashers on one card, in one process: the classic Poseidon's (`poseidon.cu`'s
`poseidon_leaf_hashes` and node entries) or, with ``--poseidon2``, K2's
(`poseidon2.cu`'s `poseidon2_leaf_hashes` and node entries). It times the
leaf hashes at a prove's shapes and the node layers of every tree that
prove builds.

Each variant is ``LABEL=CSRC_DIR``; its `poseidon.cu` (`poseidon2.cu`) is
compiled by `boojum_tpu_torch/utils/cuda_build.build` into
`boojum_tpu_torch/_build/compare_poseidon/<label>/`
(`compare_poseidon2/<label>/`).
- Classic Poseidon: a variant whose library has
  `poseidon_tree_set_constants` (the sparse partial rounds) gets
  `poseidon_sparse`'s table in its constant memory once and is called as
  `poseidon.leaf_hashes` / `node_layers` call it; an older one takes the
  round-constant table as an argument (`poseidon._table`).
- Poseidon2: every variant gets the round constants and the internal
  matrix's shifts, as `pallas_poseidon2` gives them.
A variant with a node-layers entry builds a tree's node layers in the
launches `device_bytes_hash.node_launches` plans (one a tree, two above
2^17 leaves) into one buffer; one without it, one node-layer launch a
layer.

For each variant it prints the SASS split of its tree kernels
(`chip_smoke.ptree_sass_counts` or `p2_sass_counts`: instructions a
permutation by pipe) and its leaf kernel's opcodes by round loop. Then, per
leaf shape and per tree, one JSON line a variant: the time (CUDA events
around 20 calls, the host work of each call included, as a prove pays it),
the variants in turns (A B ... B A); then the sums over a prove. Every
variant's output must equal the first's, and the first's the plain
version's. Needs the card and the CUDA toolkit:

    python3 scripts/torch_poseidon_tree_compare.py [--poseidon2] old=OLD_CSRC new=boojum_tpu_torch/csrc

where OLD_CSRC holds older sources with the headers they include, for
example from ``git archive <commit> boojum_tpu_torch/csrc``.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (k, m, launches a prove) of a flagship prove's leaf hashes (either tree
# hasher)
LEAVES = ((93, 1 << 19, 1), (64, 1 << 19, 1), (8, 1 << 19, 1),
          (16, 1 << 16, 1), (16, 1 << 13, 1), (16, 1 << 10, 1),
          (16, 1 << 7, 1), (16, 1 << 4, 1))
# (leaves, trees a prove) of its node layers, cap 16
TREES = ((1 << 19, 3), (1 << 16, 1), (1 << 13, 1), (1 << 10, 1), (1 << 7, 1))
CAP = 16
ITERS = 20


class Variant:
    """One variant's library and how it hashes leaves and builds a tree's
    node layers."""

    def __init__(self, label, lib_path):
        import numpy as np
        import torch
        from boojum_tpu_torch.hash import poseidon, poseidon_sparse
        from boojum_tpu_torch.utils import cuda_build
        self.label = label
        self.lib_path = lib_path
        self.lib = lib = cuda_build.open_lib(lib_path, "poseidon")
        self.sparse = hasattr(lib, "poseidon_tree_set_constants")
        self.tree = hasattr(lib, "poseidon_node_layers")
        if self.sparse:
            table = np.asarray(poseidon_sparse.kernel_table(), np.uint64)
            exps = np.asarray(poseidon._EXPS, np.int64)
            cuda_build.check(lib.poseidon_tree_set_constants(
                table.ctypes.data, table.size, exps.ctypes.data),
                "poseidon_tree_set_constants")
            self.extra = ()
        else:  # the entries take the round constants before the stream
            P, LL = ctypes.c_void_p, ctypes.c_longlong
            lib.poseidon_leaf_hashes.argtypes = [P, P, ctypes.c_int, LL, LL,
                                                 P, P]
            lib.poseidon_node_layer.argtypes = [P, P, LL, P, P]
            self.extra = (poseidon._table(torch.device("cuda")).data_ptr(),)

    def stream(self):
        import torch
        return torch.cuda.current_stream().cuda_stream

    def leaves(self, cols):
        from boojum_tpu_torch.utils import cuda_build
        k, m = cols.shape
        out = cols.new_empty((4, m))
        cuda_build.check(self.lib.poseidon_leaf_hashes(
            cols.data_ptr(), out.data_ptr(), k, m, m, *self.extra,
            self.stream()), "poseidon_leaf_hashes")
        return out

    def launches(self, m):
        from boojum_tpu_torch.hash import device_bytes_hash as dbh
        n = len(dbh.node_widths(m, CAP))
        return len(dbh.node_launches(m, n)) if self.tree else n

    def nodes(self, cur):
        from boojum_tpu_torch.hash import device_bytes_hash as dbh
        from boojum_tpu_torch.utils import cuda_build
        widths = dbh.node_widths(cur.shape[1], CAP)
        if self.tree:
            return dbh.launch_node_layers(
                cur, widths, self.lib.poseidon_node_layers,
                "poseidon_node_layers", lambda m, levels: None)
        layers = []
        for w in widths:
            out = cur.new_empty((4, w))
            cuda_build.check(self.lib.poseidon_node_layer(
                cur.data_ptr(), out.data_ptr(), cur.shape[1], *self.extra,
                self.stream()), "poseidon_node_layer")
            layers.append(out)
            cur = out
        return layers


class P2Variant:
    """One variant's `poseidon2` library and how it hashes leaves and builds
    a tree's node layers."""

    def __init__(self, label, lib_path):
        import numpy as np
        from boojum_tpu_torch.hash import poseidon2 as p2
        from boojum_tpu_torch.utils import cuda_build
        self.label = label
        self.lib_path = lib_path
        self.lib = lib = cuda_build.open_lib(lib_path, "poseidon2")
        self.tree = hasattr(lib, "poseidon2_node_layers")
        rc = np.asarray(p2._RC, np.uint64)
        shifts = np.asarray(p2._DIAG_SHIFTS, np.int64)
        cuda_build.check(lib.poseidon2_set_constants(
            rc.ctypes.data, shifts.ctypes.data), "poseidon2_set_constants")

    stream = Variant.stream
    launches = Variant.launches

    def leaves(self, cols):
        from boojum_tpu_torch.utils import cuda_build
        k, m = cols.shape
        out = cols.new_empty((4, m))
        cuda_build.check(self.lib.poseidon2_leaf_hashes(
            cols.data_ptr(), out.data_ptr(), k, m, m, self.stream()),
            "poseidon2_leaf_hashes")
        return out

    def nodes(self, cur):
        from boojum_tpu_torch.hash import device_bytes_hash as dbh
        from boojum_tpu_torch.utils import cuda_build
        widths = dbh.node_widths(cur.shape[1], CAP)
        if self.tree:
            return dbh.launch_node_layers(
                cur, widths, self.lib.poseidon2_node_layers,
                "poseidon2_node_layers", lambda m, levels: None)
        layers = []
        for w in widths:
            out = cur.new_empty((4, w))
            cuda_build.check(self.lib.poseidon2_node_layer(
                cur.data_ptr(), out.data_ptr(), cur.shape[1], self.stream()),
                "poseidon2_node_layer")
            layers.append(out)
            cur = out
        return layers


def opcode_mix(lib_path):
    """The leaf kernel's SASS by opcode (before the first '.'): for each of
    its loops inside the rate-block loop (in address order; the round loops
    and any loop nested in them), the instructions it holds outside the
    loops nested in it, and for the rest of the rate-block loop's body,
    {opcode: count} of one pass, the most frequent first."""
    import collections
    from boojum_tpu_torch.utils import cuda_build
    for kname, instrs in cuda_build.sass(lib_path).items():
        if "leaf_kernel" not in kname:
            continue
        loops = cuda_build.sass_summary(instrs)["loops"]
        outer = max(loops, key=lambda lp: lp["end"] - lp["start"])
        loops = sorted((lp for lp in loops if lp is not outer),
                       key=lambda lp: lp["start"])

        def home(a):  # the innermost loop holding address a, or None
            held = [lp for lp in loops if lp["start"] <= a <= lp["end"]]
            return min(held, key=lambda lp: lp["end"] - lp["start"]) \
                if held else None

        parts = collections.defaultdict(collections.Counter)
        for a, op, _ in instrs:
            if outer["start"] <= a <= outer["end"]:
                lp = home(a)
                name = "loop%d" % loops.index(lp) if lp else "rest"
                parts[name][op.split(".")[0]] += 1
        return {k: dict(c.most_common()) for k, c in sorted(parts.items())}
    return {}


def _cuda_ms(fn, iters):
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


def _turns(variants, fn):
    """{label: [ms, ms]}: ``fn(v)`` timed for each variant in turns."""
    times = {v.label: [] for v in variants}
    for v in variants + variants[::-1]:
        times[v.label].append(_cuda_ms(lambda: fn(v), ITERS))
    return times


def main(argv):
    import numpy as np
    import torch
    import chip_smoke
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.hash import poseidon
    from boojum_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("torch_poseidon_tree_compare: CUDA is not available",
              file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    p2 = "--poseidon2" in argv
    name = "poseidon2" if p2 else "poseidon"
    if p2:
        from boojum_tpu_torch.hash import pallas_poseidon2 as hasher
    else:
        hasher = poseidon
    specs = dict(arg.split("=", 1) for arg in argv if arg != "--poseidon2")
    dirs = {label: os.path.join(cuda_build.BUILD, "compare_" + name, label)
            for label in specs}
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        list(pool.map(lambda lb: cuda_build.build([name], specs[lb], dirs[lb],
                                                  verbose=True), specs))
    variants = [(P2Variant if p2 else Variant)(
        label, os.path.join(dirs[label], "lib%s.so" % name))
        for label in specs]
    for v in variants:
        counts = (chip_smoke.p2_sass_counts if p2
                  else chip_smoke.ptree_sass_counts)(v.lib_path)
        print(json.dumps(dict(variant=v.label, sass={
            e: {k: c[k] for k in ("per_perm", "per_lane", "fixed") if k in c}
            for e, c in counts.items()}, leaf_opcodes=opcode_mix(
                v.lib_path))), flush=True)
    rng = np.random.default_rng(11)
    per_prove = {v.label: dict(leaf_launches=0, leaf_ms=0.0,
                               node_launches=0, node_ms=0.0)
                 for v in variants}
    for k, m, n in LEAVES:
        cols = gl.from_u64(rng.integers(0, gl.ORDER, (k, m), dtype=np.uint64),
                           "cuda")
        want = hasher.leaf_hashes_plain(cols)
        for v in variants:
            if not torch.equal(v.leaves(cols), want):
                raise AssertionError("%s leaves (%d, %d) differ from the "
                                     "plain version" % (v.label, k, m))
        times = _turns(variants, lambda v: v.leaves(cols))
        for v in variants:
            ms = sum(times[v.label]) / len(times[v.label])
            per_prove[v.label]["leaf_launches"] += n
            per_prove[v.label]["leaf_ms"] += n * ms
            print(json.dumps(dict(variant=v.label, entry="leaf", k=k, m=m,
                                  ms=ms, ms_each_turn=times[v.label])),
                  flush=True)
    for m, trees in TREES:
        cur = gl.from_u64(rng.integers(0, gl.ORDER, (4, m), dtype=np.uint64),
                          "cuda")
        want = hasher.node_layers_plain(cur, CAP)
        for v in variants:
            got = v.nodes(cur)
            if len(got) != len(want) or not all(
                    torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("%s node layers m=%d differ from the "
                                     "plain chain" % (v.label, m))
        times = _turns(variants, lambda v: v.nodes(cur))
        for v in variants:
            ms = sum(times[v.label]) / len(times[v.label])
            per_prove[v.label]["node_launches"] += trees * v.launches(m)
            per_prove[v.label]["node_ms"] += trees * ms
            print(json.dumps(dict(
                variant=v.label, entry="nodes", leaves=m, cap=CAP,
                trees_a_prove=trees, launches=v.launches(m), ms=ms,
                ms_each_turn=times[v.label])), flush=True)
    for label, tot in per_prove.items():
        print(json.dumps(dict(variant=label, per_prove=tot)), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
