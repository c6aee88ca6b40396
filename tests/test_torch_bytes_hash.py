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

import pathlib
import re

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
from boojum_tpu.prover.device_merkle import \
    build_device_bytes_tree as ref_build_device_bytes_tree
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
    layers = dbh.node_layers(gl.from_u64(cur), algo, 32)
    assert len(layers) == 1
    got = dbh.digests_to_bytes(gl.to_u64(layers[0]))
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
    assert np.array_equal(gl.to_u64(dbh.node_layers(leaves, algo, 2)[0]),
                          ref_nodes.astype(np.uint64))


def _plain_chain(cur, algo, cap):
    """The per-layer plain chain: one plain node layer at a time while the
    width is above the cap and even."""
    layers = []
    while cur.shape[1] > cap and cur.shape[1] % 2 == 0:
        cur = dbh._PLAIN[algo][1](cur)
        layers.append(cur)
    return layers


_JAX_TREES = {}


def _jax_tree_layers(algo):
    """The JAX `build_device_bytes_tree` of 32 leaves of 2 elements, cap 1:
    its leaf layer and its 5 node layers as u64 word planes (compiled once
    an algo; a smaller cap's tree is the prefix of these layers)."""
    if algo not in _JAX_TREES:
        a = _cols(300, 2, 32)
        tree = ref_build_device_bytes_tree(ref_gl.from_u64(a), 1, algo)
        _JAX_TREES[algo] = (a, [np.asarray(x).astype(np.uint64)
                                for x in tree.layers])
    return _JAX_TREES[algo]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("cap", [1, 4, 16])
def test_node_layers_equal_plain_chain_and_jax_tree(algo, cap):
    """`node_layers` on the CPU gives the per-layer plain chain and the JAX
    `build_device_bytes_tree`'s node layers down to the cap, as exact u32
    words."""
    a, ref_layers = _jax_tree_layers(algo)
    leaves = dbh.leaf_hashes(gl.from_u64(a), algo)
    assert np.array_equal(gl.to_u64(leaves), ref_layers[0])
    got = dbh.node_layers(leaves, algo, cap)
    want = _plain_chain(leaves, algo, cap)
    assert [g.shape[1] for g in got] == [32 >> j for j in
                                         range(1, 6 - cap.bit_length() + 1)]
    assert len(got) == len(want)
    for g, w, r in zip(got, want, ref_layers[1:]):
        assert torch.equal(g, w)
        assert np.array_equal(gl.to_u64(g), r)


def _cuda_int(path, name):
    text = path.read_text()
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


def _emulate_launch(src, src_off, out, at, m, levels, tickets, threads, stage,
                    node, writes, rng, words=8, lanes=1):
    """One launch of a tree's `*_node_layers` entry as csrc/byte_tree.cuh
    schedules it, on flat u64 arrays: `src` holds the (words, m) input
    layer from `src_off`, `out` receives the `levels` layers from `at`,
    `tickets` are the launch's hand-on counters;
    `node` hashes (words, 2p) sibling pairs into (words, p) parents; `writes`
    counts the stores to each element of `out`. The blocks of a stage take
    their tickets in an order drawn from `rng`; a block that goes on reads
    only digests its own group wrote. With ``lanes`` > 1 (a node hash that
    opts in to narrow levels, lanes = words), a block's level of at most
    threads / lanes parents is narrow: thread lanes * t + w handles word w
    of parent t, reading word w of its pair and storing that word."""
    group = 1 << stage  # 2 THREADS >> STAGE digests a block, 2 THREADS a group
    assert threads >> (stage - 1) >= 32  # a full stage's levels fill warps
    assert 1 <= levels < 63 and m >= 2 and m % (1 << levels) == 0  # valid
    planes = np.arange(words)
    owner = np.full(len(out), -1)  # the block of the stage that wrote it
    width, done, ticket_off = m, 0, 0
    blocks = -(-m // (2 * threads))  # byte_tree::grid: stage 0's blocks
    while True:
        assert blocks == -(-width // (2 * threads))
        slot = np.zeros((blocks, words, threads), np.uint64)  # a block's
        n = [min(2 * threads, width - 2 * threads * b) for b in range(blocks)]
        w = width
        for j in range(min(stage, levels - done)):
            half = w >> 1
            pairs, who = [], []
            for b in range(blocks):
                first = 2 * threads * b
                narrow = lanes > 1 and (n[b] >> 1) * lanes <= threads
                for t in range(n[b] >> 1):  # the threads with a parent
                    # narrow: thread lanes * t + k handles word k of parent t
                    assert (lanes * t + words - 1 if narrow else t) < threads
                    if j == 0:  # 16-byte loads from the stage's input layer
                        a = src_off + planes * w + first + 2 * t
                        if done:  # written by this block's group
                            assert (owner[a] // group == b).all()
                            assert (owner[a + 1] // group == b).all()
                        pairs.append((src[a], src[a + 1]))
                    else:  # slots 2t, 2t + 1
                        assert 2 * t + 1 < threads
                        pairs.append((slot[b, :, 2 * t],
                                      slot[b, :, 2 * t + 1]))
                    who.append((b, first, t))
            # __syncthreads(): every child is read before a slot is written
            children = np.empty((words, 2 * len(pairs)), np.uint64)
            children[:, 0::2] = np.stack([lr[0] for lr in pairs], 1)
            children[:, 1::2] = np.stack([lr[1] for lr in pairs], 1)
            parents = gl.to_u64(node(gl.from_u64(children)))
            for i, (b, first, t) in enumerate(who):
                slot[b, :, t] = parents[:, i]
                a = at + planes * half + (first >> (j + 1)) + t
                out[a] = parents[:, i]
                owner[a] = b
                writes[a] += 1
            # __syncthreads(); src = out; out += WORDS * half
            src, src_off = out, at
            at += words * half
            w = half
            n = [nb >> 1 for nb in n]
        done += min(stage, levels - done)
        if done == levels:
            return ticket_off
        # every block takes a ticket of its group's counter, in any order;
        # the one that draws the group's last goes on as block b / GROUP
        groups = -(-blocks // group)
        goes_on = {}
        for b in rng.permutation(blocks):
            g = b // group
            members = min(group, blocks - g * group)
            if tickets[ticket_off + g] == members - 1:
                goes_on[g] = b
            tickets[ticket_off + g] += 1
        assert sorted(goes_on) == list(range(groups))
        ticket_off += groups
        blocks, width = groups, w


def _tickets(m, levels, threads, stage):
    """Hand-on counters of a launch: a group of 2^stage blocks of every
    stage but the last."""
    n = done = 0
    while done + stage < levels:
        blocks = -(-m // (2 * threads))
        n += -(-blocks // (1 << stage))
        m >>= stage
        done += stage
    return n


def _emulate_node_layers(cur, node, cap, threads, stage, rng, plan=None,
                         lanes=1):
    """`node_layers`' CUDA branch with its launches emulated: the layers are
    views of `node_buffer`'s one buffer, each launch of ``plan`` (by
    default `node_launches`') reads the last layer the one before it wrote
    and takes the next slice of the hand-on counters (`node_tickets` of
    them at the kernel's own block size; counted here for ``threads``).
    ``node`` is the plain node hash of a (words, 2p) layer; ``lanes`` the
    node hash's lanes a state at narrow levels (`_emulate_launch`), or a
    function of a launch's (width, levels) giving them. Returns the
    layers, the store count of every element, and the counters after the
    launches."""
    words, m = cur.shape
    widths = dbh.node_widths(m, cap)
    layers = dbh.node_buffer(cur, widths, words)
    if not widths:
        return [], np.zeros(0, int), np.zeros(0, int)
    if plan is None:
        plan = dbh.node_launches(m, len(widths))
    assert sum(lv for _, lv in plan) == len(widths)
    assert layers[0].storage_offset() == 0
    total = sum(words * w for w in widths)
    buf = np.zeros(total, np.uint64)
    writes = np.zeros(total, int)
    counts = [_tickets(w, lv, threads, stage) for w, lv in plan]
    lanes_of = lanes if callable(lanes) else (lambda w, lv: lanes)
    if threads == dbh.NODE_THREADS:
        assert counts == [dbh.node_tickets(w, lv) for w, lv in plan]
    tickets = np.zeros(sum(counts), int)
    src, src_off, done, first = gl.to_u64(cur).reshape(-1), 0, 0, 0
    for (w, levels), n in zip(plan, counts):
        assert w == (m if done == 0 else widths[done - 1])
        used = _emulate_launch(src, src_off, buf,
                               layers[done].storage_offset(), w, levels,
                               tickets[first:first + n], threads, stage,
                               node, writes, rng, words, lanes_of(w, levels))
        assert used == n
        done += levels
        first += n
        src, src_off = buf, layers[done - 1].storage_offset()
    return [gl.from_u64(buf[v.storage_offset():][:words * v.shape[1]]
                        .reshape(words, v.shape[1])) for v in layers], \
        writes, tickets


def test_node_launches_plan_a_prove():
    """The launches of a prove's byte trees: two for each 2^19-leaf tree
    (its first stage of 3 layers, then 12), one for each smaller tree, none
    for the 2^4-leaf tree at cap 16: 10 node launches a prove."""
    plans = {m: dbh.node_launches(m, len(dbh.node_widths(m, 16)))
             for m in (1 << 19, 1 << 16, 1 << 13, 1 << 10, 1 << 7, 1 << 4)}
    assert plans == {1 << 19: [(1 << 19, 3), (1 << 16, 12)],
                     1 << 16: [(1 << 16, 12)], 1 << 13: [(1 << 13, 9)],
                     1 << 10: [(1 << 10, 6)], 1 << 7: [(1 << 7, 3)],
                     1 << 4: []}
    per_prove = 3 * len(plans[1 << 19]) + sum(
        len(plans[m]) for m in (1 << 16, 1 << 13, 1 << 10, 1 << 7, 1 << 4))
    assert per_prove == 10
    assert dbh.node_launches(1 << 18, 3) == [(1 << 18, 3)]
    assert dbh.node_launches(1 << 18, 4) == [(1 << 18, 3), (1 << 15, 1)]


SCHEDULE_CASES = [(1 << e, 1) for e in range(1, 13)] + [
    (1000, 1),  # stops where the width turns odd: 500, 250, 125
    (3 << 10, 1),  # 10 levels down to width 3, a ragged last group
    (1 << 12, 4), (1 << 12, 16), (96, 16), (16, 16)]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("m,cap,threads,split", [
    case + (None, False) for case in SCHEDULE_CASES] + [
    (1 << 12, 1, 128, False), (3 << 10, 1, 128, False),
    (1000, 1, 128, False), (1 << 12, 1, None, True), (1 << 12, 16, None, True),
    (3 << 10, 1, None, True)])
def test_kernel_schedule_matches_plain_chain(algo, m, cap, threads, split):
    """Emulates csrc/byte_tree.cuh at its own THREADS (256; also at 128 a
    block, its first design) and STAGE (3): each block's subtree of a
    stage, the thread that hashes each pair at each level, the shared slots
    read and written in place between the barriers, the hand-on tickets
    (every group's counter counts its blocks once and one block of each
    goes on, whatever order they arrive in), the cap and odd-width stops,
    and the write offset of each layer in the one buffer, also split into
    two launches as `node_launches` splits a tree above 2^17 digests (its
    first stage alone, then the rest). Every element of the buffer is
    stored once, and the layers equal the per-layer plain chain's."""
    cuh = pathlib.Path(dbh.__file__).parents[1] / "csrc" / "byte_tree.cuh"
    stage = _cuda_int(cuh, "STAGE")
    assert (_cuda_int(cuh, "THREADS"), stage) == \
        (dbh.NODE_THREADS, dbh.NODE_STAGE) == (256, 3)
    assert dbh.NODE_GROUP == 8
    cur = gl.from_u64(np.random.default_rng(m + cap).integers(
        0, 1 << 32, (8, m), dtype=np.uint64))
    n = len(dbh.node_widths(m, cap))
    plan = [(m, stage), (m >> stage, n - stage)] if split else None
    got, writes, tickets = _emulate_node_layers(
        cur, dbh._PLAIN[algo][1], cap, threads or dbh.NODE_THREADS, stage,
        np.random.default_rng(m), plan)
    assert (writes == 1).all()
    assert (tickets >= 1).all() and (tickets <= dbh.NODE_GROUP).all()
    want = _plain_chain(cur, algo, cap)
    assert len(want) == n
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    fn = dbh.leaf_hashes if entry == "leaf" else \
        (lambda cur, algo: dbh.node_layers(cur, algo, 1))
    with pytest.raises(RuntimeError, match="no kernel"):
        fn(x, algo)
    with pytest.raises(TypeError):
        fn(torch.zeros((8, 16), dtype=torch.int32), algo)
    assert dbh.PLAIN_CUDA_CALLS == calls
