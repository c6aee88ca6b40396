# Copied from boojum_tpu/prover/pow.py (the Poseidon2 grind as a scalar scan).
"""Proof-of-work grinding (reference src/cs/implementations/pow.rs).

Blake2s PoW: seed = blake2s(LE bytes of challenge field elements); find u64
nonce such that blake2s(seed || nonce_le) has >= bits leading zero BITS
(interpreted as LE u64 of the first 8 digest bytes). Vectorized host search.

Every grind returns the smallest passing nonce, so proofs are deterministic
and equal to the reference's.
"""

from __future__ import annotations

import hashlib

from ..hash.keccak import keccak256


def _grind_range(args):
    """Worker: smallest passing nonce in [start, start+count) or None."""
    kind, seed, threshold, start, count = args
    if kind == "blake2s":
        def digest(n):
            return hashlib.blake2s(seed + n.to_bytes(8, "little"),
                                   digest_size=32).digest()
    else:
        def digest(n):
            return keccak256(seed + n.to_bytes(8, "little"))
    for n in range(start, start + count):
        if int.from_bytes(digest(n)[:8], "little") < threshold:
            return n
    return None


def _parallel_grind(kind: str, seed: bytes, threshold: int,
                    block: int = 1 << 15) -> int:
    """Deterministic multi-process nonce search (reference pow.rs:51 grinds
    on a worker pool; serial python at ~1 us/hash makes 2^20-bit grinds
    multi-second). Scans generations of workers*block nonces; the result is
    the SMALLEST passing nonce of the first generation with a hit, so proofs
    stay byte-deterministic regardless of worker timing."""
    import multiprocessing as mp
    import os

    workers = min(8, os.cpu_count() or 1)
    if workers <= 1:
        n = _grind_range((kind, seed, threshold, 0, 1 << 40))
        return int(n)
    # the first block alone: a grind of a few bits ends there without a pool
    n = _grind_range((kind, seed, threshold, 0, block))
    if n is not None:
        return n
    base = block
    # spawn, not fork: the prover's process has threads (torch's)
    with mp.get_context("spawn").Pool(workers) as pool:
        while True:
            tasks = [(kind, seed, threshold, base + i * block, block)
                     for i in range(workers)]
            hits = [h for h in pool.map(_grind_range, tasks) if h is not None]
            if hits:
                return min(hits)
            base += workers * block


def blake2s_pow(challenges: list[int], bits: int) -> int:
    seed_h = hashlib.blake2s(digest_size=32)
    for c in challenges:
        seed_h.update(int(c).to_bytes(8, "little"))
    seed = seed_h.digest()
    return _parallel_grind("blake2s", seed, 1 << (64 - bits))


def verify_blake2s_pow(challenges: list[int], bits: int, nonce: int) -> bool:
    seed_h = hashlib.blake2s(digest_size=32)
    for c in challenges:
        seed_h.update(int(c).to_bytes(8, "little"))
    digest = hashlib.blake2s(seed_h.digest() + int(nonce).to_bytes(8, "little"),
                             digest_size=32).digest()
    return int.from_bytes(digest[:8], "little") < (1 << (64 - bits))


def keccak256_pow(challenges: list[int], bits: int) -> int:
    seed = b"".join(int(c).to_bytes(8, "little") for c in challenges)
    seed = keccak256(seed)
    return _parallel_grind("keccak256", seed, 1 << (64 - bits))


def verify_keccak256_pow(challenges: list[int], bits: int, nonce: int) -> bool:
    seed = b"".join(int(c).to_bytes(8, "little") for c in challenges)
    seed = keccak256(seed)
    digest = keccak256(seed + int(nonce).to_bytes(8, "little"))
    return int.from_bytes(digest[:8], "little") < (1 << (64 - bits))


# ----------------------------------------------------------------------------
# Algebraic (Poseidon2) PoW — recursion-friendly grinding.
#
# The reference has NO algebraic PoW runner (pow.rs implements only NoPow /
# Blake2s256 / Keccak256) and its in-circuit PoW verification is todo!()
# (src/gadgets/recursion/recursive_verifier.rs:1503), so proofs ground with
# the byte hashes cannot be recursively verified there either. This variant
# closes that gap: grinding is ONE Poseidon2 permutation per candidate nonce
# (README.md:101 notes the reference expects algebraic PoW ~2x slower on
# CPU), and the circuit twin in
# gadgets/recursion/verifier.py verifies it with one in-circuit permutation.
#
# Definition: state = [c0, c1, c2, c3, nonce_lo, nonce_hi, 0...0] (width 12),
# digest = permutation(state)[0] as canonical u64; accept iff
# digest < 2^(64 - bits). c0..c3 are the four transcript challenges the
# prover draws for grinding (prover.py stage 11), nonce split as two u32.
# ----------------------------------------------------------------------------


def _poseidon2_digest(challenges: list[int], nonce: int) -> int:
    from ..hash.poseidon2 import s_permutation
    state = [int(c) for c in challenges[:4]] + \
        [int(nonce) & 0xFFFFFFFF, int(nonce) >> 32] + [0] * 6
    return s_permutation(state)[0]


def poseidon2_pow(challenges: list[int], bits: int) -> int:
    """The smallest nonce whose digest passes (the reference's result),
    scanned in order with the scalar permutation, which costs the host less
    a nonce than the batched torch permutation on CPU tensors."""
    threshold = 1 << (64 - bits)
    nonce = 0
    while _poseidon2_digest(challenges, nonce) >= threshold:
        nonce += 1
    return nonce


def verify_poseidon2_pow(challenges: list[int], bits: int,
                         nonce: int) -> bool:
    if not (0 <= int(nonce) < (1 << 64)):
        return False
    return _poseidon2_digest(challenges, nonce) < (1 << (64 - bits))
