"""Compare versions of the byte trees' node kernels, K8 (`blake2s.cu`) and K9
(`keccak.cu`), on one card: the node layers of every tree one Blake2s or
Keccak-256 flagship prove builds, in one process.

Each variant is ``LABEL=CSRC_DIR``; its `blake2s.cu` and `keccak.cu` are
compiled by `boojum_tpu_torch/utils/cuda_build.build` into
`boojum_tpu_torch/_build/compare_bytes/<label>/`. A variant with the
one-layer entry `<lib>_node_layer` (the kernels before `byte_tree.cuh`) is
driven as its wrapper drove it: a new (8, m/2) tensor and one launch a
layer. A variant with `<lib>_node_layers` is driven as `node_layers` drives
it: one buffer (`device_bytes_hash.node_buffer`), zeroed hand-on counters
and the launches `node_launches` plans (one a tree, two above 2^17
leaves). The trees are a prove's: 3 of 2^19 leaves, one each of 2^16, 2^13, 2^10 and 2^7, cap
16, on random digests. Per hash, tree and variant it prints one JSON line:
the launches and the time of the tree's node layers (CUDA events around 20
builds, host work of each build included, as a prove pays it), the variants
in turns (A B ... B A); then the sum over a prove. Every variant's layers
must equal the first's, and the first's the plain per-layer chain. Needs
the card and the CUDA toolkit:

    python3 scripts/torch_byte_tree_compare.py old=OLD_CSRC new=boojum_tpu_torch/csrc

With ``--sweep`` it then times one launch of each `<lib>_node_layers`
variant alone at every input width 2^19 .. 2^5, for 1 to 15 levels: the
cost of each stage of 3 levels as the tree grows.
"""

import concurrent.futures
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LIBS = {"blake2s": "blake2s", "keccak256": "keccak"}
TREES = ((1 << 19, 3), (1 << 16, 1), (1 << 13, 1), (1 << 10, 1), (1 << 7, 1))
CAP = 16
ITERS = 20


class Variant:
    """One variant's two libraries and how it builds a tree's node layers."""

    def __init__(self, label, csrc, out_dir):
        from boojum_tpu_torch.utils import cuda_build
        self.label = label
        self.libs = {algo: cuda_build.open_lib(
            os.path.join(out_dir, "lib%s.so" % lib), lib)
            for algo, lib in LIBS.items()}
        self.tree = os.path.exists(os.path.join(csrc, "byte_tree.cuh"))
        if not self.tree:
            for lib in self.libs.values():
                for name in ("blake2s_node_layer", "keccak_node_layer"):
                    if hasattr(lib, name):
                        getattr(lib, name).argtypes = [ctypes.c_void_p] * 2 + [
                            ctypes.c_longlong, ctypes.c_void_p]

    def launches(self, m):
        from boojum_tpu_torch.hash import device_bytes_hash as dbh
        n = len(dbh.node_widths(m, CAP))
        return len(dbh.node_launches(m, n)) if self.tree else n

    def launch_tree(self, algo, cur, out, levels):
        import torch
        from boojum_tpu_torch.utils import cuda_build
        m = cur.shape[1]
        # zeroed hand-on counters for any block size and stage: fewer than
        # one a block of 2 threads (4 digests)
        tickets = torch.zeros(m // 4 + 64, dtype=torch.int32,
                              device=cur.device)
        cuda_build.check(getattr(self.libs[algo], LIBS[algo] + "_node_layers")(
            cur.data_ptr(), out.data_ptr(), m, levels, tickets.data_ptr(),
            torch.cuda.current_stream().cuda_stream), LIBS[algo])

    def nodes(self, algo, cur):
        import torch
        from boojum_tpu_torch.hash import device_bytes_hash as dbh
        from boojum_tpu_torch.utils import cuda_build
        stream = torch.cuda.current_stream().cuda_stream
        lib = self.libs[algo]
        name = LIBS[algo]
        if not self.tree:
            layers = []
            while cur.shape[1] > CAP:
                out = cur.new_empty((8, cur.shape[1] // 2))
                cuda_build.check(getattr(lib, name + "_node_layer")(
                    cur.data_ptr(), out.data_ptr(), cur.shape[1], stream),
                    name)
                layers.append(out)
                cur = out
            return layers
        layers = dbh.node_buffer(cur, dbh.node_widths(cur.shape[1], CAP))
        src, done = cur, 0
        for m, levels in dbh.node_launches(cur.shape[1], len(layers)):
            self.launch_tree(algo, src, layers[done], levels)
            done += levels
            src = layers[done - 1]
        return layers

    def sweep(self, rng):
        """One launch of ``<lib>_node_layers`` alone at every input width
        2^19 .. 2^5 and every level count up to 15, on random digests: one
        JSON line a hash and width (CUDA events around 30 launches into a
        buffer allocated once, its counters zeroed each time)."""
        import numpy as np
        import torch
        from boojum_tpu_torch.field import goldilocks as gl
        for algo in LIBS:
            for lg in range(19, 4, -1):
                cur = gl.from_u64(rng.integers(0, 1 << 32, (8, 1 << lg),
                                               dtype=np.uint64), "cuda")
                out = torch.empty(8 << lg, dtype=torch.int64, device="cuda")
                ms = {}
                for levels in range(1, min(15, lg) + 1):
                    ms[levels] = _cuda_ms(
                        lambda: self.launch_tree(algo, cur, out, levels), 30)
                print(json.dumps(dict(variant=self.label, hash=algo,
                                      width=1 << lg, ms_by_levels=ms)),
                      flush=True)


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


def main(argv):
    import numpy as np
    import torch
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    from boojum_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("torch_byte_tree_compare: CUDA is not available",
              file=sys.stderr)
        return 1
    sweep = "--sweep" in argv
    specs = dict(arg.split("=", 1) for arg in argv if arg != "--sweep")
    dirs = {label: os.path.join(cuda_build.BUILD, "compare_bytes", label)
            for label in specs}
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        list(pool.map(lambda lb: cuda_build.build(list(LIBS.values()),
                                                  specs[lb], dirs[lb]), specs))
    variants = [Variant(label, specs[label], dirs[label]) for label in specs]
    order = variants + variants[::-1]
    rng = np.random.default_rng(13)
    per_prove = {(algo, v.label): [0, 0.0] for algo in LIBS for v in variants}
    for algo in LIBS:
        for m, trees in TREES:
            cur = gl.from_u64(rng.integers(0, 1 << 32, (8, m),
                                           dtype=np.uint64), "cuda")
            first = variants[0].nodes(algo, cur)
            want = dbh.node_layers_plain(cur, algo, CAP)
            for v in variants:
                got = v.nodes(algo, cur)
                ref = want if v is variants[0] else first
                if len(got) != len(ref) or not all(
                        torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError("%s %s m=%d: layers differ" % (
                        v.label, algo, m))
            times = {v.label: [] for v in variants}
            for v in order:
                times[v.label].append(_cuda_ms(lambda: v.nodes(algo, cur),
                                               ITERS))
            for v in variants:
                ms = sum(times[v.label]) / len(times[v.label])
                tot = per_prove[(algo, v.label)]
                tot[0] += trees * v.launches(m)
                tot[1] += trees * ms
                print(json.dumps(dict(
                    variant=v.label, hash=algo, leaves=m, cap=CAP,
                    trees_a_prove=trees, launches=v.launches(m), ms=ms,
                    ms_each_turn=times[v.label])), flush=True)
    for (algo, label), (launches, ms) in per_prove.items():
        print(json.dumps(dict(variant=label, hash=algo, per_prove=dict(
            launches=launches, ms=ms))), flush=True)
    if sweep:
        for v in variants:
            if v.tree:
                v.sweep(rng)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
