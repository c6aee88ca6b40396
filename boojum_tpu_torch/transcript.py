# Copied from boojum_tpu/transcript.py.
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

import hashlib

from .field.goldilocks import ORDER
from .hash import poseidon, poseidon2
from .hash.keccak import keccak256
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


class _BytesTranscript:
    """Shared logic of Blake2s/Keccak256 transcripts (reseed-by-finalize)."""

    IS_ALGEBRAIC = False

    def __init__(self):
        self.fed = b""  # bytes since last reset
        self.buffer = bytearray()
        self.available = bytearray()

    def _digest(self, data: bytes) -> bytes:
        raise NotImplementedError

    def witness_field_elements(self, els):
        for e in els:
            self.buffer += (int(e) % ORDER).to_bytes(8, "little")

    def witness_merkle_tree_cap(self, cap):
        for el in cap:
            assert isinstance(el, (bytes, bytearray)) and len(el) == 32
            self.buffer += el

    def _reseed(self):
        output = self._digest(self.fed)
        self.fed = output  # finalize_reset + update(output)
        self.available = bytearray(output)

    def get_challenge(self) -> int:
        if self.buffer:
            self.fed += bytes(self.buffer)
            self.buffer.clear()
            self._reseed()
        if self.available:
            assert len(self.available) % 8 == 0
            chunk = bytes(self.available[:8])
            del self.available[:8]
            return int.from_bytes(chunk, "little") % ORDER
        self._reseed()
        return self.get_challenge()

    def get_challenge_bytes(self, num_bytes: int) -> bytes:
        if self.buffer:
            self.fed += bytes(self.buffer)
            self.buffer.clear()
            self._reseed()
        if len(self.available) >= num_bytes:
            out = bytes(self.available[:num_bytes])
            del self.available[:num_bytes]
            return out
        self._reseed()
        return self.get_challenge_bytes(num_bytes)

    def get_multiple_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]


class Blake2sTranscript(_BytesTranscript):
    def _digest(self, data: bytes) -> bytes:
        return hashlib.blake2s(data, digest_size=32).digest()


class Keccak256Transcript(_BytesTranscript):
    def _digest(self, data: bytes) -> bytes:
        return keccak256(data)


def make_transcript(kind: str):
    """kind in {poseidon, poseidon2, blake2s, keccak256}."""
    if kind in ("poseidon", "poseidon2"):
        return AlgebraicTranscript(kind)
    if kind == "blake2s":
        return Blake2sTranscript()
    if kind == "keccak256":
        return Keccak256Transcript()
    raise ValueError(kind)
