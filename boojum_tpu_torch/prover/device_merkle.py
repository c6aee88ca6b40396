# Port of boojum_tpu/prover/device_merkle.py (the Poseidon2 half) to torch.
"""Poseidon2 Merkle-cap trees and FRI on the device.

Reference behavior: oracle construction (src/cs/oracle/merkle_tree.rs:78-176)
and FRI folding (src/cs/implementations/fri/mod.rs:49,362). Every leaf hash
and node layer is one batched permutation, `permutation_stacked_fast` (the
Hopper `poseidon2_permute` kernel on the GPU); the layers stay on the
device, and only caps and queried paths cross to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import extension as ext2
from ..field import goldilocks as gl
from ..field.goldilocks import MULTIPLICATIVE_GENERATOR, ORDER
from ..hash.pallas_poseidon2 import permutation_stacked_fast
from ..utils import npgl
from .fri import FriResult, interpolate_final_host
from .proof import OracleQuery

RATE = 8
CAP = 4


def _pad_cols_to_rate(cols: torch.Tensor) -> torch.Tensor:
    k, m = cols.shape
    pad = (-k) % RATE
    if pad:
        return torch.cat([cols, cols.new_zeros((pad, m))])
    return cols


def _leaf_hashes(cols: torch.Tensor) -> torch.Tensor:
    """cols (k, m), k a multiple of 8 -> leaf hashes (4, m): overwrite-mode
    absorption of each rate-8 block, one permutation per block."""
    k, m = cols.shape
    assert k % RATE == 0
    st = cols.new_zeros((12, m))
    for b in range(k // RATE):
        st = permutation_stacked_fast(
            torch.cat([cols[b * RATE:(b + 1) * RATE], st[RATE:]]))
    return st[:CAP]


def _node_layer(cur: torch.Tensor) -> torch.Tensor:
    """(4, m) -> (4, m/2): hash (left, right) sibling pairs."""
    m = cur.shape[1]
    st = torch.cat([cur[:, 0::2], cur[:, 1::2], cur.new_zeros((4, m // 2))])
    return permutation_stacked_fast(st)[:CAP]


def build_device_tree(cols: torch.Tensor, cap_size: int) -> "DeviceTree":
    """Poseidon2 Merkle-cap tree of leaf columns (k, m); leaf i is column i."""
    cur = _leaf_hashes(_pad_cols_to_rate(cols))
    layers = [cur]
    while cur.shape[1] > cap_size:
        cur = _node_layer(cur)
        layers.append(cur)
    return DeviceTree(layers)


class DeviceTree:
    """Merkle-cap tree whose layers stay on the device: leaves (4, m), then
    each node layer, the last being the cap (AlgebraicMerkleTree's
    get_cap/get_proof interface)."""

    def __init__(self, layers):
        self.layers = layers
        self._cap_host = None
        self._path_cache = {}

    def get_cap(self):
        if self._cap_host is None:
            arr = gl.to_u64(self.layers[-1])
            self._cap_host = [tuple(int(arr[i, j]) for i in range(4))
                              for j in range(arr.shape[1])]
        return self._cap_host

    def prefetch_proofs(self, leaf_indices):
        """Gather every queried leaf and sibling path in one host transfer
        (the reference's FetchCollector, collapsed to one gather per tree)."""
        idxs = sorted(set(int(i) for i in leaf_indices) - set(self._path_cache))
        if not idxs:
            return
        depth = len(self.layers) - 1  # the path excludes the cap layer
        dev = self.layers[0].device
        idx = torch.tensor(idxs, dtype=torch.int64, device=dev)
        parts = [self.layers[level][:, (idx >> level) ^ 1]
                 for level in range(depth)]
        parts.append(self.layers[0][:, idx])
        arr = gl.to_u64(torch.stack(parts))  # (depth + 1, 4, q)
        for qi, leaf_idx in enumerate(idxs):
            leaf = tuple(int(arr[depth, i, qi]) for i in range(4))
            path = [tuple(int(arr[level, i, qi]) for i in range(4))
                    for level in range(depth)]
            self._path_cache[leaf_idx] = (leaf, path)

    def get_proof(self, idx: int):
        if int(idx) not in self._path_cache:
            self.prefetch_proofs([idx])
        return self._path_cache[int(idx)]


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

    def prefetch(self, flat_indices):
        e = self.elems_per_leaf
        leaf_idxs = sorted(set(int(i) // e for i in flat_indices))
        self.tree.prefetch_proofs(leaf_idxs)
        starts = torch.tensor(leaf_idxs, dtype=torch.int64,
                              device=self.c0.device)[:, None] * e
        gidx = (starts + torch.arange(e, device=self.c0.device)).reshape(-1)
        both = gl.to_u64(torch.stack([self.c0[gidx], self.c1[gidx]]))
        v0 = both[0].reshape(-1, e)
        v1 = both[1].reshape(-1, e)
        for row, li in enumerate(leaf_idxs):
            self._chunk_cache[li] = ([int(x) for x in v0[row]],
                                     [int(x) for x in v1[row]])

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


def _commit_layer(c0, c1, k: int, cap_size: int) -> DeviceFlatOracle:
    """Leaf columns (2·2^k, size/2^k) of a flat layer: leaf i = [c0 chunk i,
    c1 chunk i]; then its tree."""
    e = 1 << k
    tree_size = c0.shape[0] // e
    cols = torch.cat([c0.reshape(tree_size, e).T, c1.reshape(tree_size, e).T])
    return DeviceFlatOracle(c0, c1, e, build_device_tree(cols, cap_size))


def do_fri_device(h, transcript, schedule: list[int], lde_factor: int,
                  cap_size: int, roots: torch.Tensor):
    """FRI over the DEEP polynomial h = (c0, c1) flat tensors: commit each
    layer, absorb its cap, fold by 2^k with the transcript's challenge, and
    interpolate the final layer on the host. ``roots`` is the bitreversed
    inverse-root table of the full domain (`fri._inverse_roots_bitreversed`).
    Byte-identical to the reference's fri.do_fri on the same input."""
    result = FriResult()
    cur0, cur1 = h
    coset_inv = pow(MULTIPLICATIVE_GENERATOR, ORDER - 2, ORDER)
    for stage, k in enumerate(schedule):
        oracle = _commit_layer(cur0, cur1, k, cap_size)
        transcript.witness_merkle_tree_cap(oracle.get_cap())
        if stage == 0:
            result.base_oracle = oracle
        else:
            result.intermediate_oracles.append(oracle)
        c = (transcript.get_challenge(), transcript.get_challenge())
        chs, cosets = [], []
        for _ in range(k):
            chs.append(c)
            cosets.append(coset_inv)
            c = ext2.s2_mul(c, c)
            coset_inv = coset_inv * coset_inv % ORDER
        cur0, cur1 = _fold(cur0, cur1, roots, chs, cosets)

    m = int(cur0.shape[0])
    final_degree = m // lde_factor
    coset = int(npgl.inv(np.uint64(coset_inv)))
    mono0 = np.asarray(interpolate_final_host(gl.to_u64(cur0), coset), np.uint64)
    mono1 = np.asarray(interpolate_final_host(gl.to_u64(cur1), coset), np.uint64)
    assert not mono0[final_degree:].any(), "FRI final poly degree too high"
    assert not mono1[final_degree:].any(), "FRI final poly degree too high"
    transcript.witness_field_elements([int(x) for x in mono0[:final_degree]])
    transcript.witness_field_elements([int(x) for x in mono1[:final_degree]])
    result.monomial_forms = ([int(x) for x in mono0[:final_degree]],
                             [int(x) for x in mono1[:final_degree]])
    return result
