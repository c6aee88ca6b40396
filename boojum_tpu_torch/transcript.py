# Copied from boojum_tpu/transcript.py (the algebraic transcripts only).
"""Fiat-Shamir transcripts (host-side, exact).

Reference behavior: src/cs/implementations/transcript.rs —
``AlgebraicSpongeBasedTranscript`` (:48; rescue-prime padding: append ONE then
zero-pad to a rate multiple), ``Blake2sTranscript`` (:155) and
``Keccak256Transcript`` (:264) byte transcripts with reseed-by-finalize, and
the aliases GoldilocksPoisedonTranscript / GoldilocksPoisedon2Transcript
(:131-153, classic-Poseidon resp. Poseidon2 round function, overwrite mode).

Transcripts are tiny host computations between device stages; exactness (bit
identity with the reference) matters, speed does not.
"""

from __future__ import annotations

from .field.goldilocks import ORDER
from .hash import poseidon, poseidon2
from .hash.sponge import RATE, STATE_WIDTH


class AlgebraicTranscript:
    """Sponge transcript over Goldilocks (overwrite absorption, rate 8)."""

    IS_ALGEBRAIC = True

    def __init__(self, permutation="poseidon"):
        self.perm = (poseidon.s_permutation if permutation == "poseidon"
                     else poseidon2.s_permutation)
        self.state = [0] * STATE_WIDTH
        self.buffer: list[int] = []
        self.available: list[int] = []

    def witness_field_elements(self, els):
        self.buffer.extend(int(e) % ORDER for e in els)

    def witness_merkle_tree_cap(self, cap):
        for el in cap:
            self.witness_field_elements(el)

    def get_challenge(self) -> int:
        if not self.buffer:
            if self.available:
                return self.available.pop(0)
            self.state = self.perm(self.state)
            self.available = list(self.state[:RATE])
            return self.get_challenge()
        to_absorb = self.buffer + [1]  # rescue-prime padding
        self.buffer = []
        while len(to_absorb) % RATE != 0:
            to_absorb.append(0)
        for i in range(0, len(to_absorb), RATE):
            chunk = to_absorb[i:i + RATE]
            self.state[:RATE] = chunk  # overwrite mode
            self.state = self.perm(self.state)
        self.available = list(self.state[:RATE])
        return self.get_challenge()

    def get_multiple_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]


def make_transcript(kind: str):
    """kind in {poseidon, poseidon2}; the byte transcripts are not ported."""
    if kind in ("poseidon", "poseidon2"):
        return AlgebraicTranscript(kind)
    if kind in ("blake2s", "keccak256"):
        raise NotImplementedError("the %s transcript is not ported" % kind)
    raise ValueError(kind)
