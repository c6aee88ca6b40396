"""Hashes: Poseidon2 batched permutation (kernel K2), the classic-Poseidon
tree hashes (`poseidon.leaf_hashes` / `node_layer`), the Blake2s and
Keccak-256 tree hashes (kernels K8 and K9, `device_bytes_hash`), the exact
scalar Poseidon/Poseidon2 permutations and sponge of the transcript, the
host Keccak-256 and the host Merkle trees."""

from . import poseidon, poseidon2, sponge  # noqa: F401
