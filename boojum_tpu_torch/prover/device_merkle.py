# Port of boojum_tpu/prover/device_merkle.py to torch (Poseidon2, Poseidon, Blake2s and Keccak-256 trees).
"""Merkle-cap trees and FRI on the device.

Reference behavior: oracle construction (src/cs/oracle/merkle_tree.rs:78-176)
and FRI folding (src/cs/implementations/fri/mod.rs:49,362). The leaf hashes
of a Poseidon2 tree are one `pallas_poseidon2.leaf_hashes` call and each
node layer one `pallas_poseidon2.node_layer` call (on the GPU one launch
each of the Hopper `poseidon2_leaf_hashes` and `poseidon2_node_layer`
kernels); a classic-Poseidon tree's are `poseidon.leaf_hashes` and
`poseidon.node_layer` (kernels `poseidon_leaf_hashes` and
`poseidon_node_layer`; the reference builds it on the host,
boojum_tpu/prover/device_merkle.py:332); a Blake2s or Keccak-256 tree
(src/cs/oracle/mod.rs:179, :247) takes one `device_bytes_hash.leaf_hashes` call and one `node_layers` call
(kernels K8 and K9: one launch for its node layers, two for a tree above
2^17 leaves). The layers stay on the device, and only caps and queried
paths cross to the host: the query phase's gathers all ride one
`FetchCollector` flush, one copy to the host and one wait.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import extension as ext2
from ..field import goldilocks as gl
from ..field.goldilocks import MULTIPLICATIVE_GENERATOR, ORDER
from ..hash import device_bytes_hash as dbh
from ..hash import pallas_poseidon2, poseidon
from ..utils import npgl
from .device import upload
from .fri import FriResult, interpolate_final_host
from .proof import OracleQuery


# flushes of a FetchCollector that had work: each is one device-to-host copy
# and one wait for the device
FETCHES = 0


class FetchCollector:
    """Batches device gathers and their transfers to the host into ONE copy
    (the reference's FetchCollector, boojum_tpu/prover/device_merkle.py:654).
    Entries registered with ``add`` (tensors already computed) or
    ``add_gather`` (``fn(*args)`` run at the flush) are flattened into one
    int64 tensor on the device, copied once into pinned host memory, and
    the host waits once; each callback then gets the host u64 copy of its
    entry (one array, or a list of arrays for a sequence of tensors)."""

    def __init__(self):
        self._items = []

    def add(self, tensors, callback):
        """Fetch already-computed device tensors (one, or a sequence)."""
        one = isinstance(tensors, torch.Tensor)
        self._items.append((None, (tensors,) if one else tuple(tensors),
                            callback, one))

    def add_gather(self, fn, args, callback):
        """Deferred gather: ``fn(*args)`` -> one tensor, run at the flush."""
        self._items.append((fn, tuple(args), callback, True))

    def flush(self):
        global FETCHES
        if not self._items:
            return
        items, self._items = self._items, []
        outs = [[fn(*args)] if fn is not None else list(args)
                for (fn, args, _, _) in items]
        flat = torch.cat([t.reshape(-1) for ts in outs for t in ts])
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            torch.cuda.current_stream(flat.device).synchronize()
        else:
            host = flat
        arr = host.numpy().view(np.uint64)
        FETCHES += 1
        pos = 0
        for (_, _, callback, one), ts in zip(items, outs):
            got = []
            for t in ts:
                got.append(arr[pos:pos + t.numel()].reshape(tuple(t.shape)))
                pos += t.numel()
            callback(got[0] if one else got)


def _flush_alone(collector):
    """The collector to register with, and whether to flush it at once
    (no caller's collector: a call fetches by itself, as before)."""
    return (collector, False) if collector is not None \
        else (FetchCollector(), True)


# the leaf and node hashes of the algebraic trees, by tree hasher
_ALGEBRAIC = {
    "poseidon2": (pallas_poseidon2.leaf_hashes, pallas_poseidon2.node_layer),
    "poseidon": (poseidon.leaf_hashes, poseidon.node_layer)}


def build_device_tree(cols: torch.Tensor, cap_size: int,
                      hasher: str = "poseidon2") -> "DeviceTree":
    """Poseidon2 or Poseidon Merkle-cap tree of leaf columns (k, m); leaf i
    is column i."""
    leaf_hashes, node_layer = _ALGEBRAIC[hasher]
    cur = leaf_hashes(cols)
    layers = [cur]
    while cur.shape[1] > cap_size:
        cur = node_layer(cur)
        layers.append(cur)
    return DeviceTree(layers)


class DeviceTree:
    """Merkle-cap tree whose layers stay on the device: leaves (4, m), then
    each node layer, the last being the cap (the get_cap/get_proof
    interface of the reference's host trees)."""

    def __init__(self, layers):
        self.layers = layers
        self._cap_host = None
        self._path_cache = {}

    @staticmethod
    def _nodes(arr: np.ndarray) -> list:
        """Host copy (words, n) of n nodes -> the n nodes as the host tree
        holds them: tuples of 4 field elements."""
        return [tuple(int(x) for x in arr[:, j]) for j in range(arr.shape[1])]

    def get_cap(self):
        if self._cap_host is None:
            self.set_cap_host(gl.to_u64(self.layers[-1]))
        return self._cap_host

    def set_cap_host(self, arr: np.ndarray):
        """Keep the cap from its host u64 copy fetched elsewhere."""
        self._cap_host = self._nodes(arr)

    def prefetch_proofs(self, leaf_indices, collector=None):
        """Gather every queried leaf and sibling path: one gather, fetched
        with the ``collector``'s flush, or at once without one."""
        idxs = sorted(set(int(i) for i in leaf_indices) - set(self._path_cache))
        if not idxs:
            return
        depth = len(self.layers) - 1  # the path excludes the cap layer
        idx = upload(np.asarray(idxs, np.int64), self.layers[0].device)

        def gather(idx):
            parts = [self.layers[level][:, (idx >> level) ^ 1]
                     for level in range(depth)]
            parts.append(self.layers[0][:, idx])
            return torch.stack(parts)  # (depth + 1, words, q)

        def ingest(arr):
            for qi, leaf_idx in enumerate(idxs):
                nodes = self._nodes(arr[:, :, qi].T)
                self._path_cache[leaf_idx] = (nodes[depth], nodes[:depth])

        coll, alone = _flush_alone(collector)
        coll.add_gather(gather, (idx,), ingest)
        if alone:
            coll.flush()

    def get_proof(self, idx: int):
        if int(idx) not in self._path_cache:
            self.prefetch_proofs([idx])
        return self._path_cache[int(idx)]


def build_device_bytes_tree(cols: torch.Tensor, cap_size: int,
                            algo: str) -> "DeviceBytesTree":
    """Blake2s or Keccak-256 Merkle-cap tree of leaf columns (k, m): the leaf
    digests, then each node layer down to the cap; digests equal the
    reference's host `BytesMerkleTree`'s."""
    layers = [dbh.leaf_hashes(cols, algo)]
    layers += dbh.node_layers(layers[0], algo, cap_size)
    if layers[-1].shape[1] > cap_size:
        raise ValueError("a byte tree of %d leaves stops at an odd width %d "
                         "above its cap %d" % (cols.shape[1],
                                               layers[-1].shape[1], cap_size))
    return DeviceBytesTree(layers, algo)


class DeviceBytesTree(DeviceTree):
    """Byte-digest Merkle-cap tree whose (8, m) word-plane layers stay on the
    device; caps and paths cross to the host as 32-byte digests."""

    def __init__(self, layers, algo: str):
        super().__init__(layers)
        self.algo = algo

    @staticmethod
    def _nodes(arr: np.ndarray) -> list:
        return dbh.digests_to_bytes(arr)


# tree hashers, each with a device tree
TREE_HASHERS = ("poseidon2", "poseidon", "blake2s", "keccak256")


def build_any_device_tree(cols: torch.Tensor, cap_size: int, hasher: str):
    """The Merkle-cap tree of leaf columns (k, m) by tree hasher: Poseidon2
    or Poseidon (`DeviceTree`), or Blake2s / Keccak-256
    (`DeviceBytesTree`)."""
    if hasher in _ALGEBRAIC:
        return build_device_tree(cols, cap_size, hasher)
    if hasher in ("blake2s", "keccak256"):
        return build_device_bytes_tree(cols, cap_size, hasher)
    raise ValueError("unknown tree hasher %r" % (hasher,))


class DeviceFlatOracle:
    """FRI-layer oracle: flat (c0, c1) sources and tree on the device; leaf i
    holds the 2^k consecutive elements of chunk i, c0 block then c1 block."""

    def __init__(self, c0, c1, elems_per_leaf: int, tree: DeviceTree):
        self.c0 = c0
        self.c1 = c1
        self.elems_per_leaf = elems_per_leaf
        self.tree = tree
        self._chunk_cache = {}

    def get_cap(self):
        return self.tree.get_cap()

    def prefetch(self, flat_indices, collector=None):
        """Gather the queried leaves' chunks and paths: fetched with the
        ``collector``'s flush, or at once without one."""
        e = self.elems_per_leaf
        leaf_idxs = sorted(set(int(i) // e for i in flat_indices))
        coll, alone = _flush_alone(collector)
        self.tree.prefetch_proofs(leaf_idxs, coll)
        starts = upload(np.asarray(leaf_idxs, np.int64), self.c0.device)

        def gather(starts):
            gidx = (starts[:, None] * e
                    + torch.arange(e, device=starts.device)).reshape(-1)
            return torch.stack([self.c0[gidx], self.c1[gidx]])

        def ingest(both):
            v0 = both[0].reshape(-1, e)
            v1 = both[1].reshape(-1, e)
            for row, li in enumerate(leaf_idxs):
                self._chunk_cache[li] = ([int(x) for x in v0[row]],
                                         [int(x) for x in v1[row]])

        coll.add_gather(gather, (starts,), ingest)
        if alone:
            coll.flush()

    def query(self, flat_idx: int) -> OracleQuery:
        leaf_idx = int(flat_idx) // self.elems_per_leaf
        if leaf_idx not in self._chunk_cache:
            self.prefetch([flat_idx])
        _, path = self.tree.get_proof(leaf_idx)
        s0, s1 = self._chunk_cache[leaf_idx]
        return OracleQuery(leaf_elements=s0 + s1, proof=path)


# ---------------------------------------------------------------------------
# Device FRI
# ---------------------------------------------------------------------------


def _fold(c0, c1, roots, chs, cosets):
    """len(chs) fold-by-2 steps over flat bitreversed ext arrays: g(x²) =
    f(x) + f(-x) + α·(f(x) - f(-x))/x, the challenge α and 1/coset squared
    per step (chs, cosets: the pre-squared host chains)."""
    for ch, ci in zip(chs, cosets):
        m = c0.shape[0] // 2
        fx0, fmx0 = c0[0::2], c0[1::2]
        fx1, fmx1 = c1[0::2], c1[1::2]
        tw = gl.mul(roots[:m], ci)
        d = (gl.mul(gl.sub(fx0, fmx0), tw), gl.mul(gl.sub(fx1, fmx1), tw))
        m0, m1 = ext2.scale(d, ch)
        c0 = gl.add(gl.add(fx0, fmx0), m0)
        c1 = gl.add(gl.add(fx1, fmx1), m1)
    return c0, c1


def _commit_layer(c0, c1, k: int, cap_size: int,
                  hasher: str) -> DeviceFlatOracle:
    """Leaf columns (2·2^k, size/2^k) of a flat layer: leaf i = [c0 chunk i,
    c1 chunk i]; then its tree."""
    e = 1 << k
    tree_size = c0.shape[0] // e
    cols = torch.cat([c0.reshape(tree_size, e).T, c1.reshape(tree_size, e).T])
    return DeviceFlatOracle(c0, c1, e,
                            build_any_device_tree(cols, cap_size, hasher))


def do_fri_device(h, transcript, schedule: list[int], lde_factor: int,
                  cap_size: int, roots: torch.Tensor, hasher: str):
    """FRI over the DEEP polynomial h = (c0, c1) flat tensors: commit each
    layer, absorb its cap, fold by 2^k with the transcript's challenge, and
    interpolate the final layer on the host. ``roots`` is the bitreversed
    inverse-root table of the full domain (`fri._inverse_roots_bitreversed`);
    each layer's tree is hashed with ``hasher``.
    Byte-identical to the reference's fri.do_fri on the same input.

    Under a device transcript the caps and challenges stay on the device
    (the challenge's squaring chain is `sq_chain_dev`), and the final layer
    is left in ``result.final_layer`` = (c0, c1, coset, final degree) for
    the prover to fetch in its handoff and pass to `finish_fri`."""
    from .device_transcript import sq_chain_dev

    is_dev = getattr(transcript, "IS_DEVICE", False)
    result = FriResult()
    cur0, cur1 = h
    coset_inv = pow(MULTIPLICATIVE_GENERATOR, ORDER - 2, ORDER)
    for stage, k in enumerate(schedule):
        oracle = _commit_layer(cur0, cur1, k, cap_size, hasher)
        if is_dev:
            transcript.witness_merkle_tree_cap_dev(oracle.tree.layers[-1])
        else:
            transcript.witness_merkle_tree_cap(oracle.get_cap())
        if stage == 0:
            result.base_oracle = oracle
        else:
            result.intermediate_oracles.append(oracle)
        if is_dev:
            chs = ext2.prepare(sq_chain_dev(transcript.get_ext_challenge(), k))
        else:
            c = (transcript.get_challenge(), transcript.get_challenge())
            chs = []
            for _ in range(k):
                chs.append(c)
                c = ext2.s2_mul(c, c)
        cosets = []
        for _ in range(k):
            cosets.append(coset_inv)
            coset_inv = coset_inv * coset_inv % ORDER
        cur0, cur1 = _fold(cur0, cur1, roots, chs, cosets)

    final_degree = int(cur0.shape[0]) // lde_factor
    coset = int(npgl.inv(np.uint64(coset_inv)))
    result.final_layer = (cur0, cur1, coset, final_degree)
    if not is_dev:
        f0, f1 = gl.to_u64(torch.stack([cur0, cur1]))  # one fetch
        finish_fri(result, f0, f1, transcript)
    return result


def finish_fri(result: FriResult, f0: np.ndarray, f1: np.ndarray,
               transcript):
    """Interpolate the final FRI layer from its host u64 values f0, f1 (the
    tensors of ``result.final_layer``), check its degree, absorb its
    monomials into the host transcript and keep them in the result."""
    _, _, coset, final_degree = result.final_layer
    mono0 = np.asarray(interpolate_final_host(f0, coset), np.uint64)
    mono1 = np.asarray(interpolate_final_host(f1, coset), np.uint64)
    assert not mono0[final_degree:].any(), "FRI final poly degree too high"
    assert not mono1[final_degree:].any(), "FRI final poly degree too high"
    transcript.witness_field_elements([int(x) for x in mono0[:final_degree]])
    transcript.witness_field_elements([int(x) for x in mono1[:final_degree]])
    result.monomial_forms = ([int(x) for x in mono0[:final_degree]],
                             [int(x) for x in mono1[:final_degree]])
    result.final_layer = None
