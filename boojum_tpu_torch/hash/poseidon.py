# Copied from boojum_tpu/hash/poseidon.py (the exact scalar permutation only).
"""Classic Poseidon permutation over Goldilocks, width 12 (Plonky2-compatible).

Reference behavior: src/implementations/poseidon_goldilocks_naive.rs (full and
partial rounds at :123-147, MDS circulant of powers of two, constants shared
with Poseidon2). Used by the ``GoldilocksPoisedonTranscript`` (reference
transcript.rs:131-139). Only the exact Python-int permutation is carried: the
port's Merkle trees hash with Poseidon2.
"""

from __future__ import annotations

from ..field.goldilocks import ORDER
from . import _poseidon_constants as C
from .poseidon2 import _s_sbox7  # same x^7 S-box

STATE_WIDTH = C.STATE_WIDTH
RATE = C.RATE
CAPACITY = C.CAPACITY

_RC = C.ALL_ROUND_CONSTANTS
_R_F_HALF = C.HALF_NUM_FULL_ROUNDS
_R_P = C.NUM_PARTIAL_ROUNDS
_EXPS = C.MDS_MATRIX_EXPS

# MDS[row][col] = 2^EXPS[(12 - row + col) % 12]
_MDS_POW = [[1 << _EXPS[(12 - r + c) % 12] for c in range(12)] for r in range(12)]


# ----------------------------------------------------------------------------
# Exact scalar twin
# ----------------------------------------------------------------------------


def _s_mds(state):
    return [sum(state[c] * _MDS_POW[r][c] for c in range(12)) % ORDER for r in range(12)]


def s_permutation(state: list[int]) -> list[int]:
    assert len(state) == STATE_WIDTH
    r = 0
    for _ in range(_R_F_HALF):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(s) for s in state]
        state = _s_mds(state)
        r += 1
    for _ in range(_R_P):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(state[0])] + state[1:]
        state = _s_mds(state)
        r += 1
    for _ in range(_R_F_HALF):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(s) for s in state]
        state = _s_mds(state)
        r += 1
    return state
