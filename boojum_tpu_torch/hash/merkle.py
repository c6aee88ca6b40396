# Copied from boojum_tpu/hash/merkle.py (the path checks only).
"""Merkle-cap path checks of the verifier.

Reference behavior: src/cs/oracle/merkle_tree.rs ``verify_proof_over_cap``
(:482). The "cap" is the top 2^k layer committed in VK/transcript instead
of a single root.

The prover builds its trees on the device (`prover/device_merkle.py`:
`build_any_device_tree`, which runs on CPU tensors through the kernels'
plain versions); the verifier opens their paths here, on Python ints and
32-byte digests.
"""

from __future__ import annotations

import hashlib

from . import poseidon, poseidon2, sponge
from .keccak import keccak256


class AlgebraicMerkleTree:
    """Merkle-cap tree whose node type is [F; 4] (Poseidon/Poseidon2 sponge)."""

    @staticmethod
    def verify_proof_over_cap(proof, cap, leaf_hash, idx: int,
                              permutation: str = "poseidon2") -> bool:
        perm = poseidon2.s_permutation if permutation == "poseidon2" \
            else poseidon.s_permutation
        current = tuple(leaf_hash)
        cur = idx
        for el in proof:
            if cur & 1 == 0:
                current = tuple(sponge.scalar_hash_into_node(current, el, perm))
            else:
                current = tuple(sponge.scalar_hash_into_node(el, current, perm))
            cur >>= 1
        return tuple(cap[cur]) == current


class BytesMerkleTree:
    """Merkle-cap tree over 32-byte digests (Blake2s / Keccak256 hashers) of
    the non-recursive transcript/tree configs (reference oracle impls at
    src/cs/oracle/mod.rs:179-313)."""

    @staticmethod
    def _digest(algo: str, data: bytes) -> bytes:
        if algo == "blake2s":
            return hashlib.blake2s(data, digest_size=32).digest()
        elif algo == "keccak256":
            return keccak256(data)
        raise ValueError(algo)

    @staticmethod
    def verify_proof_over_cap(proof, cap, leaf_hash: bytes, idx: int,
                              algo: str = "blake2s") -> bool:
        current = leaf_hash
        cur = idx
        for el in proof:
            pair = (current, el) if cur & 1 == 0 else (el, current)
            current = BytesMerkleTree._digest(algo, pair[0] + pair[1])
            cur >>= 1
        return cap[cur] == current
