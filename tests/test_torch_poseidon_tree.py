"""The classic-Poseidon Merkle tree of the port (tree hasher "poseidon"):
the plain versions of its two kernel entries (`poseidon.leaf_hashes_plain`
/ `node_layer_plain`, the wrappers' CPU path) against the JAX package's
batched sponge (`boojum_tpu.hash.sponge.hash_leaves` / `hash_nodes`), the
port's device tree against the JAX host `AlgebraicMerkleTree` (caps and
paths), and a Python-int emulation of the Hopper kernels'
(`csrc/poseidon.cu` `leaf_kernel`, `node_kernel`) lazy arithmetic in their
operation order, range-checked at every step, against the JAX package's
permutation and the plain versions: the only check of those kernels this
CPU can run. Exact equality throughout.

The JAX sponge's batched permutation runs jitted here
(`tests/torch_small_circuit.use_jax_poseidon_perm`, the package's rolled
`poseidon._permutation_rolled_gl`); eagerly each call takes tens of
seconds."""

import numpy as np
import pytest
import torch

from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.hash import poseidon as ref_poseidon
from boojum_tpu.hash import sponge as ref_sponge
from boojum_tpu.hash.merkle import AlgebraicMerkleTree
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.hash import poseidon
from boojum_tpu_torch.hash.merkle import \
    AlgebraicMerkleTree as PortMerkleTree
from boojum_tpu_torch.prover.device_merkle import build_any_device_tree
from tests.test_torch_poseidon2_fused import (EPS, M64, _sbox7,
                                              add_canon_lazy, canonicalize,
                                              reduce96)
from tests.torch_small_circuit import use_jax_poseidon_perm

P = gl.ORDER


@pytest.fixture(scope="module")
def jax_poseidon():
    with pytest.MonkeyPatch.context() as mp:
        use_jax_poseidon_perm(mp.setattr)
        yield


def _cols(seed, k, m):
    return np.random.default_rng(seed).integers(0, P, (k, m), dtype=np.uint64)


def _counts():
    return (poseidon.LAUNCHES, poseidon.LEAF_LAUNCHES, poseidon.NODE_LAUNCHES,
            poseidon.PLAIN_CUDA_CALLS)


@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 93])
def test_plain_leaves_match_jax(jax_poseidon, k):
    """Leaves of k elements (a partial block, whole blocks, one more
    element, the flagship's witness width) at m = 64."""
    cols = _cols(k, k, 64)
    before = _counts()
    got = poseidon.leaf_hashes_plain(gl.from_u64(cols))
    assert torch.equal(poseidon.leaf_hashes(gl.from_u64(cols)), got)
    want = ref_sponge.hash_leaves(ref_gl.from_u64(cols), "poseidon")
    assert np.array_equal(gl.to_u64(got), ref_gl.to_u64(want))
    # on CPU tensors the wrappers run the plain versions and count nothing
    assert _counts() == before


def test_plain_nodes_match_jax(jax_poseidon):
    cur = _cols(5, 4, 1 << 10)
    got = poseidon.node_layer_plain(gl.from_u64(cur))
    assert got.shape == (4, 1 << 9)
    assert torch.equal(poseidon.node_layer(gl.from_u64(cur)), got)
    want = ref_sponge.hash_nodes(ref_gl.from_u64(cur[:, 0::2]),
                                 ref_gl.from_u64(cur[:, 1::2]), "poseidon")
    assert np.array_equal(gl.to_u64(got), ref_gl.to_u64(want))


@pytest.mark.parametrize("log_m,cap", [(10, 1), (11, 4), (12, 16)])
def test_tree_matches_jax(jax_poseidon, log_m, cap):
    """The port's tree of one-element leaves against the reference's host
    tree: the cap, and the leaf hash and path of a handful of leaves, each
    of which the port's verifier opens over the cap."""
    cols = _cols(log_m, 1, 1 << log_m)
    ref = AlgebraicMerkleTree.from_leaf_columns(ref_gl.from_u64(cols), cap,
                                                "poseidon")
    tree = build_any_device_tree(gl.from_u64(cols), cap, "poseidon")
    assert tree.get_cap() == ref.get_cap()
    assert len(tree.layers) - 1 == log_m - cap.bit_length() + 1
    for idx in (0, 1, 5, (1 << log_m) - 1, 1 << (log_m - 1)):
        leaf, path = tree.get_proof(idx)
        assert (leaf, path) == ref.get_proof(idx)
        assert PortMerkleTree.verify_proof_over_cap(path, tree.get_cap(), leaf,
                                                    idx, "poseidon")


# ---------------------------------------------------------------------------
# csrc/poseidon.cu leaf_kernel / node_kernel in their operation order: one
# thread a state in registers; constants added to every element, the s-box
# on all twelve (full rounds) or on element 0 (partial rounds), then the
# circulant with every term split into 32-bit halves summed in two u64
# accumulators and one reduce96 an output
# ---------------------------------------------------------------------------


def emulate_tree_permute(s):
    """`permute_regs`: lazy in, lazy out."""
    rc, exps = poseidon._RC, poseidon._EXPS
    for r in range(30):
        boxes = 12 if r < 4 or r >= 26 else 1
        t = [add_canon_lazy(s[i], rc[r * 12 + i]) for i in range(12)]
        s = [_sbox7(x) if i < boxes else x for i, x in enumerate(t)]
        out = []
        for row in range(12):
            lo = hi = 0
            for c in range(12):
                e = exps[(12 - row + c) % 12]
                lo += (s[c] & EPS) << e
                hi += (s[c] >> 32) << e
            assert lo <= M64 and hi <= M64  # the u64 accumulators
            out.append(reduce96((hi << 32) + lo))
        s = out
    return s


def emulate_leaf(col):
    """`leaf_kernel` for one column of k values: the zero state, the rate
    overwritten a block at a time with rows past k read as zero."""
    s = [0] * 12
    for r0 in range(0, len(col), 8):
        s = [col[r0 + i] if r0 + i < len(col) else 0 for i in range(8)] + \
            s[8:]
        s = emulate_tree_permute(s)
    return [canonicalize(v) for v in s[:4]]


def emulate_node(left, right):
    return [canonicalize(v)
            for v in emulate_tree_permute(list(left) + list(right) + [0] * 4)
            [:4]]


@pytest.mark.parametrize("kind", ["random", "p_minus_1", "u64_max", "zeros",
                                  "lazy_random"])
def test_tree_kernel_order_matches_jax_permutation(kind):
    """The kernels' operation order on lazy values, canonicalized once,
    equals the JAX package's Poseidon permutation (its exact scalar twin)
    mod p."""
    rng = np.random.default_rng(41)
    states = {
        "random": [[int(v) for v in col] for col in _cols(42, 12, 3).T],
        "p_minus_1": [[P - 1] * 12],
        "u64_max": [[M64] * 12],
        "zeros": [[0] * 12],
        "lazy_random": [[int(v) for v in rng.integers(0, M64, 12,
                                                       dtype=np.uint64,
                                                       endpoint=True)]
                        for _ in range(3)],
    }[kind]
    for st in states:
        got = [canonicalize(v) for v in emulate_tree_permute(st)]
        assert got == ref_poseidon.s_permutation([v % P for v in st])


def test_tree_kernel_leaf_and_node_order_match_plain():
    """Leaves of k = 1, 9 and 16 (the state lazy between blocks, rows past
    k zero) and sibling pairs equal the plain versions."""
    for k in (1, 9, 16):
        cols = _cols(50 + k, k, 3)
        cols[:, 1] = P - 1
        want = gl.to_u64(poseidon.leaf_hashes_plain(gl.from_u64(cols)))
        for j in range(cols.shape[1]):
            assert emulate_leaf([int(v) for v in cols[:, j]]) == \
                [int(v) for v in want[:, j]]
    cur = _cols(60, 4, 4)
    want = gl.to_u64(poseidon.node_layer_plain(gl.from_u64(cur)))
    for j in range(2):
        assert emulate_node([int(v) for v in cur[:, 2 * j]],
                            [int(v) for v in cur[:, 2 * j + 1]]) == \
            [int(v) for v in want[:, j]]


def test_tree_entries_check_inputs():
    with pytest.raises(TypeError):
        poseidon.node_layer(gl.from_u64(_cols(5, 5, 4)))
    with pytest.raises(ValueError):
        poseidon.node_layer(gl.from_u64(_cols(5, 4, 3)))
    with pytest.raises(TypeError):
        poseidon.leaf_hashes(torch.zeros((8, 4), dtype=torch.int32))
