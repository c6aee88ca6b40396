"""The port's byte hashes, device trees, path checks, transcripts and proof
of work against the JAX package on the same inputs (made with numpy from a
seed): the plain versions of kernels K8 (Blake2s) and K9 (Keccak-256)
against the reference's host `BytesMerkleTree` digests (hashlib and
`hash/keccak.py`) and its compiled `*_leaves_traced` / `*_nodes_traced`;
the port's device trees (on the CPU) against the reference host trees'
caps and paths, checked by the port's `verify_proof_over_cap`; the byte
transcripts' challenges; the grinds' nonces, also through the worker
pool. The wrappers launch a kernel or raise on a tensor that is not on
the CPU (checked on the ``meta`` device)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.hash import device_bytes_hash as ref_dbh
from boojum_tpu.hash import poseidon as ref_poseidon
from boojum_tpu.hash import sponge as ref_sponge
from boojum_tpu.hash.merkle import AlgebraicMerkleTree as RefAlgebraicTree
from boojum_tpu.hash.merkle import BytesMerkleTree as RefBytesTree
from boojum_tpu.prover import pow as ref_pow
from boojum_tpu.transcript import make_transcript as ref_make_transcript
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.hash import device_bytes_hash as dbh
from boojum_tpu_torch.hash.merkle import AlgebraicMerkleTree, BytesMerkleTree
from boojum_tpu_torch.prover import device_merkle
from boojum_tpu_torch.prover import pow as port_pow
from boojum_tpu_torch.transcript import make_transcript

P = gl.ORDER
ALGOS = ("blake2s", "keccak256")


def _cols(seed, k, m):
    a = np.random.default_rng(seed).integers(0, P, (k, m), dtype=np.uint64)
    a[:, 0] = P - 1  # the top of the field: every byte of the element set
    return a


def _leaf_bytes(a):
    return [a[:, i].astype("<u8").tobytes() for i in range(a.shape[1])]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("k", [1, 8, 16, 17, 93])
def test_plain_leaves_equal_host_digests(algo, k):
    """k = 8, 16 fill whole Blake2s blocks (the last-block flag on a full
    block), k = 17 fills the Keccak rate (the pad takes a block of its own),
    k = 93 is the flagship's witness leaf (12 Blake2s blocks, 6 absorbs)."""
    a = _cols(k, k, 33)
    got = dbh.digests_to_bytes(gl.to_u64(dbh.leaf_hashes(gl.from_u64(a),
                                                         algo)))
    assert got == [RefBytesTree._digest(algo, b) for b in _leaf_bytes(a)]


@pytest.mark.parametrize("algo", ALGOS)
def test_plain_nodes_equal_host_digests(algo):
    cur = np.random.default_rng(3).integers(0, 1 << 32, (8, 64),
                                            dtype=np.uint64)
    cur[:, 0] = 0xFFFFFFFF
    digests = dbh.digests_to_bytes(cur)
    got = dbh.digests_to_bytes(gl.to_u64(dbh.node_layer(gl.from_u64(cur),
                                                        algo)))
    assert got == [RefBytesTree._digest(algo, digests[2 * i] + digests[2 * i + 1])
                   for i in range(32)]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("k", [8, 17])
def test_plain_versions_equal_jax_traced(algo, k):
    """The plain leaves and nodes against the reference's compiled
    `*_leaves_traced` / `*_nodes_traced` (word planes equal as u32)."""
    a = _cols(100 + k, k, 4)
    leaf_fn = {"blake2s": ref_dbh.blake2s_leaves_traced,
               "keccak256": ref_dbh.keccak_leaves_traced}[algo]
    node_fn = {"blake2s": ref_dbh.blake2s_nodes_traced,
               "keccak256": ref_dbh.keccak_nodes_traced}[algo]
    ref_leaves = np.asarray(leaf_fn(ref_gl.from_u64(a)))
    leaves = dbh.leaf_hashes(gl.from_u64(a), algo)
    assert np.array_equal(gl.to_u64(leaves), ref_leaves.astype(np.uint64))
    ref_nodes = np.asarray(node_fn(jnp.asarray(ref_leaves[:, 0::2]),
                                   jnp.asarray(ref_leaves[:, 1::2])))
    assert np.array_equal(gl.to_u64(dbh.node_layer(leaves, algo)),
                          ref_nodes.astype(np.uint64))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("cap", [1, 4, 16])
def test_byte_trees_equal_reference(algo, cap):
    """The device byte tree (on the CPU: the plain versions) gives the
    reference host tree's cap and every path, fetched in one flush; the
    port's path check accepts each path and refuses it at another index."""
    a = _cols(cap, 5, 64)
    ref = RefBytesTree.from_leaf_columns_u64(a, cap, algo)
    dev = device_merkle.build_any_device_tree(gl.from_u64(a), cap, algo)
    assert isinstance(dev, device_merkle.DeviceBytesTree)
    assert dev.get_cap() == ref.get_cap()
    fetches = device_merkle.FETCHES
    coll = device_merkle.FetchCollector()
    dev.prefetch_proofs(range(64), coll)
    coll.flush()
    assert device_merkle.FETCHES - fetches == 1
    for i in range(64):
        assert dev.get_proof(i) == ref.get_proof(i)
        leaf, path = ref.get_proof(i)
        assert BytesMerkleTree.verify_proof_over_cap(path, ref.get_cap(),
                                                     leaf, i, algo)
        assert not BytesMerkleTree.verify_proof_over_cap(
            path, ref.get_cap(), leaf, i ^ 1, algo)


def test_algebraic_tree_equals_reference():
    """The Poseidon2 tree that `build_any_device_tree` builds (on the CPU)
    against the reference host tree; the port's path check accepts each
    path and refuses a changed sibling."""
    a = _cols(21, 11, 16)
    ref = RefAlgebraicTree.from_leaf_columns(ref_gl.from_u64(a), 4,
                                             "poseidon2")
    port = device_merkle.build_any_device_tree(gl.from_u64(a), 4, "poseidon2")
    assert port.get_cap() == ref.get_cap()
    for i in (0, 5, 15):
        assert port.get_proof(i) == ref.get_proof(i)
        leaf, path = port.get_proof(i)
        assert AlgebraicMerkleTree.verify_proof_over_cap(
            path, port.get_cap(), leaf, i, "poseidon2")
        bad = [path[0][:3] + ((path[0][3] + 1) % P,)] + path[1:]
        assert not AlgebraicMerkleTree.verify_proof_over_cap(
            bad, port.get_cap(), leaf, i, "poseidon2")


def test_poseidon_tree_equals_reference_scalar_sponge():
    """The port's path check of a classic-Poseidon tree (the hasher of
    reference proofs the verifier accepts; the port builds no such tree)
    on a tree of the reference's scalar sponge, leaf by leaf and node by
    node: every path passes, and none at its sibling's index."""
    a = _cols(22, 9, 8)
    perm = ref_poseidon.s_permutation
    leaves = [tuple(ref_sponge.scalar_hash_into_leaf(
        [int(x) for x in a[:, i]], perm)) for i in range(8)]
    layers = [leaves]
    while len(layers[-1]) > 2:
        level = layers[-1]
        layers.append([tuple(ref_sponge.scalar_hash_into_node(
            level[2 * i], level[2 * i + 1], perm))
            for i in range(len(level) // 2)])
    cap = layers[-1]
    for i in range(8):
        path = [layers[d][(i >> d) ^ 1] for d in range(len(layers) - 1)]
        assert AlgebraicMerkleTree.verify_proof_over_cap(
            path, cap, leaves[i], i, "poseidon")
        assert not AlgebraicMerkleTree.verify_proof_over_cap(
            path, cap, leaves[i], i ^ 1, "poseidon")


@pytest.mark.parametrize("kind", ["blake2s", "keccak256", "poseidon2"])
def test_transcript_challenges_equal_reference(kind):
    """One random sequence of absorbs (elements, caps) and draws (single
    challenges, several, raw bytes for the byte transcripts)."""
    rng = np.random.default_rng(17)
    port, ref = make_transcript(kind), ref_make_transcript(kind)
    got, want = [], []
    for step in range(12):
        els = [int(x) for x in rng.integers(0, P, int(rng.integers(0, 20)),
                                            dtype=np.uint64)]
        if kind == "poseidon2":
            cap = [tuple(int(x) for x in rng.integers(0, P, 4, dtype=np.uint64))
                   for _ in range(2)]
        else:
            cap = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                   for _ in range(2)]
        for t in (port, ref):
            t.witness_field_elements(els)
            if step % 3 == 0:
                t.witness_merkle_tree_cap(cap)
        n = int(rng.integers(1, 7))
        got += port.get_multiple_challenges(n)
        want += ref.get_multiple_challenges(n)
        if kind != "poseidon2" and step % 4 == 1:
            got.append(port.get_challenge_bytes(8))
            want.append(ref.get_challenge_bytes(8))
    assert got == want


def _serial_reference_grind(monkeypatch):
    """The reference's grinds through its own serial path (`_grind_range`
    over all nonces, as with one worker): its pool forks a process that has
    threads, which can hang under a loaded test run. Same smallest nonce."""
    monkeypatch.setattr(ref_pow, "_parallel_grind",
                        lambda kind, seed, threshold, block=0:
                        ref_pow._grind_range((kind, seed, threshold, 0,
                                              1 << 40)))


@pytest.mark.parametrize("kind", ["blake2s", "keccak256", "poseidon2"])
def test_pow_nonce_equals_reference(kind, monkeypatch):
    """At 8 bits every grind returns the reference's (smallest) nonce, and
    both packages' checks accept it and refuse the next nonce that fails."""
    _serial_reference_grind(monkeypatch)
    ch = [123456789, 987654321, P - 2, 42]
    grind = {"blake2s": "blake2s_pow", "keccak256": "keccak256_pow",
             "poseidon2": "poseidon2_pow"}[kind]
    check = "verify_" + grind
    nonce = getattr(port_pow, grind)(ch, 8)
    if kind == "poseidon2":
        # the reference's batched grind is an eager JAX permutation (about
        # 30 s here): scan its scalar digest for the smallest passing nonce
        want = next(n for n in range(1 << 16) if
                    ref_pow._poseidon2_digest(ch, n) < 1 << 56)
    else:
        want = getattr(ref_pow, grind)(ch, 8)
    assert nonce == want
    assert getattr(port_pow, check)(ch, 8, nonce)
    assert getattr(ref_pow, check)(ch, 8, nonce)
    assert not any(getattr(port_pow, check)(ch, 8, n) for n in range(nonce))


@pytest.mark.parametrize("kind", ["blake2s", "keccak256"])
def test_pow_worker_pool_returns_smallest_nonce(kind, monkeypatch):
    """The grind past its serial first block: two spawned workers scan a
    generation of two blocks, and the smallest hit of the first generation
    with one wins. The seed is chosen so that the first hit lies past the
    first block and its generation holds a hit in each worker's block."""
    import os
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    block, threshold = 4, 1 << 60  # a hit every 16 nonces on average

    for s in range(64):
        seed = bytes([s]) * 32
        if port_pow._grind_range((kind, seed, threshold, 0, block)) is not None:
            continue
        first = port_pow._grind_range((kind, seed, threshold, block,
                                       64 * block))
        if first is None:
            continue
        gen = (first - block) // (2 * block)
        lo = block + gen * 2 * block
        workers = {(n - lo) // block for n in range(lo, lo + 2 * block)
                   if port_pow._grind_range((kind, seed, threshold, n, 1))
                   is not None}
        if workers == {0, 1}:
            break
    else:
        raise AssertionError("no seed with a hit in both workers' blocks")
    assert port_pow._parallel_grind(kind, seed, threshold, block) == first
    assert first == ref_pow._grind_range((kind, seed, threshold, 0, 1 << 20))


def test_digests_to_bytes_equals_reference():
    words = np.random.default_rng(5).integers(0, 1 << 32, (8, 7),
                                              dtype=np.uint64)
    assert dbh.digests_to_bytes(words) == \
        ref_dbh.digests_to_bytes(words.astype(np.uint32))


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("entry", ["leaf", "node"])
def test_wrappers_raise_without_a_kernel(algo, entry):
    """No fallback: a tensor on a device with no kernel raises; it never
    reaches the plain version."""
    calls = dbh.PLAIN_CUDA_CALLS
    x = torch.empty((8, 16), dtype=torch.int64, device="meta")
    fn = dbh.leaf_hashes if entry == "leaf" else dbh.node_layer
    with pytest.raises(RuntimeError, match="no kernel"):
        fn(x, algo)
    with pytest.raises(TypeError):
        fn(torch.zeros((8, 16), dtype=torch.int32), algo)
    assert dbh.PLAIN_CUDA_CALLS == calls
