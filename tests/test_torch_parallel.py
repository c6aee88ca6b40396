"""The port's sharded proving (`boojum_tpu_torch/parallel/`) against the JAX
package's `boojum_tpu.parallel.sharding` on the conftest's virtual CPU mesh.

One spawn of four gloo ranks for the whole file (`tests/torch_parallel_ranks.py`,
torch and the port only) runs every distributed function on its blocks of
seeded inputs at S = 4 (all ranks) and S = 2 (ranks 0 and 1): the forward
and inverse four-step NTT on the plain domain and on a coset, the grand
product, the field sum, the column-sharded commit step, and the sharded
Merkle tree with a cap above and below S. While they run, the parent
computes the JAX references, and every result must be equal as canonical
u64: the JAX sharded NTTs, grand product and sum on `make_mesh(S)` for each
S; one JAX sharded tree (S = 4, cap 2, its per-rank roots gathered and its
top replicated), whose cap-8 layer and path prefixes are the cap-8 tree's
(a tree does not depend on S); and for the commit step, which the prover
does not use, the port's single-device LDE, leaf hashes and cap-S tree
(the reference's own test holds its commit step to the same pieces;
tracing a JAX sharded tree or commit step costs 20-35 s a configuration
on the CPU). Ranks 0 and 1 also prove the small circuit sharded, whose
`proof_to_json` must be rank 2's single-device proof's and which the
port's `verify` must accept (the reference's own sharded prove stops at
`ShardedOracle.flat_t`, so the sharded proof is held to the single-device
one)."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.parallel import sharding as ref_sh
from tests import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SIZES = (4, 2)


def _u64(lo, hi):
    return np.asarray(lo).astype(np.uint64) | \
        (np.asarray(hi).astype(np.uint64) << np.uint64(32))


def _limbs(a):
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


class _Ranks:
    """The spawned ranks; ``result(r)`` waits for them once."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        env = dict(os.environ, WORLD_SIZE=str(WORLD), OMP_NUM_THREADS="1",
                   GLOO_SOCKET_IFNAME="lo")
        env.pop("XLA_FLAGS", None)
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_ranks",
             str(out_dir)], cwd=ROOT, env=dict(env, RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self._results = None

    def result(self, rank):
        if self._results is None:
            logs = [p.communicate(timeout=300)[0] for p in self.procs]
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, "rank %d failed:\n%s" % (r, log)
            self._results = []
            for r in range(WORLD):
                with open(os.path.join(self.out_dir, "rank%d.pkl" % r),
                          "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results[rank]

    def blocks(self, size, key, axis=0):
        """The S ranks' blocks of ``key`` in group ``size``, in rank order."""
        return np.concatenate([self.result(r)[size][key]
                               for r in range(size)], axis=axis)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    procs = _Ranks(tmp_path_factory.mktemp("ranks"))
    yield procs
    procs.kill()


@pytest.fixture(scope="module")
def data():
    return ranks.inputs()


@pytest.fixture(scope="module")
def meshes():
    return {s: ref_sh.make_mesh(s) for s in SIZES}


@pytest.fixture(scope="module")
def jax_tree(data, meshes):
    """The JAX sharded tree at S = 4 with cap 2, and, per cap, its cap and
    the paths of `ranks.TREE_LEAVES` (the cap-8 tree is its layers down to
    width 8)."""
    tree = ref_sh.build_sharded_tree(meshes[4], ref_gl.from_u64(data["tree"]),
                                     2)
    paths = [tree.get_proof(i) for i in ranks.TREE_LEAVES]
    out = {}
    for cap in ranks.TREE_CAPS:
        level = next(i for i, (lo, _) in enumerate(tree.layers)
                     if lo.shape[1] == cap)
        out[cap] = (tree._cap_from_host(*tree.layers[level]),
                    [(leaf, path[:level]) for leaf, path in paths])
    return out


@pytest.mark.parametrize("cap", ranks.TREE_CAPS)
@pytest.mark.parametrize("size", SIZES)
def test_sharded_tree_matches_jax(spawned, jax_tree, size, cap):
    """Caps 8 and 2: above S (local layers down to the cap) and, at S = 4,
    below it (the per-rank roots gathered, the top replicated)."""
    for r in range(size):
        assert spawned.result(r)[size]["tree", cap] == jax_tree[cap]


@pytest.mark.parametrize("size", SIZES)
def test_distributed_ntt_and_intt_match_jax(spawned, data, meshes, size):
    mesh = meshes[size]
    x = ref_gl.from_u64(data["ntt"])
    fwd = ref_sh.distributed_ntt(mesh, ranks.LOG_N, ranks.B)
    inv = ref_sh.distributed_intt(mesh, ranks.LOG_N, ranks.B)
    for coset in (1, ranks.COSET):
        facs = ref_sh.coset_power_factors(ranks.LOG_N, size, coset)
        y = fwd(x.lo, x.hi, *facs)
        assert np.array_equal(spawned.blocks(size, ("ntt", coset)), _u64(*y))
        unscale = ref_sh.coset_power_factors(ranks.LOG_N, size,
                                             pow(coset, ranks.P - 2, ranks.P))
        back = inv(y[0], y[1], *unscale)
        assert np.array_equal(spawned.blocks(size, ("intt", coset)),
                              _u64(*back))
        assert np.array_equal(_u64(*back), data["ntt"])


@pytest.mark.parametrize("size", SIZES)
def test_distributed_grand_product_matches_jax(spawned, data, meshes, size):
    (c0l, c0h), (c1l, c1h) = _limbs(data["gp"][0]), _limbs(data["gp"][1])
    out = ref_sh.distributed_grand_product(meshes[size], ranks.GP_N)(
        c0l, c0h, c1l, c1h)
    want = np.stack([_u64(out[0], out[1]), _u64(out[2], out[3])])
    assert np.array_equal(spawned.blocks(size, "gp", axis=1), want)


@pytest.mark.parametrize("size", SIZES)
def test_distributed_sum_reduce_matches_jax(spawned, data, meshes, size):
    want = _u64(*ref_sh.distributed_sum_reduce(meshes[size])(
        *_limbs(data["sum"])))
    for r in range(size):
        assert spawned.result(r)[size]["sum"] == want


@pytest.fixture(scope="module")
def jax_commit(data):
    """The reference's own pieces for its commit step (as its
    `tests/test_parallel.py` holds it): the JAX single-device LDE and
    Merkle tree, whose leaf hashes (4, m) and, per S, width-S layer (the
    cap-S tree's cap, 4 x S) are the expected results."""
    from boojum_tpu.hash import merkle
    from boojum_tpu.prover import device as ref_device

    lde = ref_device.monomials_to_lde(ref_gl.from_u64(data["commit"]),
                                      ranks.COMMIT["lde"])
    tree = merkle.AlgebraicMerkleTree.from_leaf_columns(
        ref_device.leaf_columns(lde), cap_size=min(SIZES))
    caps = {lay.shape[1]: lay for lay in tree.layers}
    return tree.leaf_hashes, {s: caps[s] for s in SIZES}


@pytest.mark.parametrize("size", SIZES)
def test_distributed_commit_step_matches_jax(spawned, jax_commit, size):
    leaves, caps = jax_commit
    got = np.concatenate([spawned.result(r)[size]["commit"][0]
                          for r in range(size)], axis=1)
    assert np.array_equal(got, leaves)
    for r in range(size):
        assert np.array_equal(spawned.result(r)[size]["commit"][1],
                              caps[size])


def test_sharded_prove_gives_the_single_device_proof(spawned):
    """The small circuit proved at S = 2 (every query's rows and paths from
    their owner rank: the sharded oracles' `query_many` works) gives the
    single-device proof's bytes on both ranks, and `verify` accepts it."""
    single, ok = spawned.result(2)["proof"]
    assert ok
    for r in range(2):
        js, ok = spawned.result(r)["proof"]
        assert ok
        assert js == single


def test_make_mesh_needs_a_process_group():
    from boojum_tpu_torch.parallel import make_mesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")
