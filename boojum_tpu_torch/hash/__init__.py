"""Hashes: Poseidon2 batched permutation (kernel K2) and the exact scalar
Poseidon/Poseidon2 permutations and sponge of the transcript."""

from . import poseidon, poseidon2, sponge  # noqa: F401
