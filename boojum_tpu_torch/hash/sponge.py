# Copied from boojum_tpu/hash/sponge.py (the scalar sponge only).
"""Algebraic sponges over Goldilocks: scalar twin + batched TPU leaf hashing.

Reference behavior: src/algebraic_props/sponge.rs (GenericAlgebraicSponge,
absorb/finalize at :224-345) and src/algebraic_props/round_function.rs
(AbsorptionMode absorb/pad). Width 12, rate 8, capacity 4; commitment =
state[..N] (reference poseidon_goldilocks.rs:474-483).

Only the scalar sponge is carried; batched leaf and node hashing lives in
`prover/device_merkle.py`.
"""

from __future__ import annotations

from ..field import goldilocks as gl
from . import poseidon2

RATE = 8
CAPACITY = 4
STATE_WIDTH = 12

OVERWRITE = "overwrite"
ADDITION = "addition"


# ----------------------------------------------------------------------------
# Scalar sponge (Python ints) — transcript and small-input hashing
# ----------------------------------------------------------------------------


class ScalarSponge:
    """Exact twin of GenericAlgebraicSponge for one state of Python ints."""

    def __init__(self, permutation=poseidon2.s_permutation, mode=OVERWRITE):
        self.perm = permutation
        self.mode = mode
        self.state = [0] * STATE_WIDTH
        self.buffer = [0] * RATE
        self.filled = 0

    def _absorb_buffer(self, count):
        for i in range(count):
            if self.mode == OVERWRITE:
                self.state[i] = self.buffer[i]
            else:
                self.state[i] = (self.state[i] + self.buffer[i]) % gl.ORDER
        if count < RATE:
            # pad: overwrite zeroes the tail, addition leaves it
            if self.mode == OVERWRITE:
                for i in range(count, RATE):
                    self.state[i] = 0
        self.state = self.perm(self.state)

    def absorb_single(self, value: int):
        self.buffer[self.filled] = value % gl.ORDER
        self.filled += 1
        if self.filled == RATE:
            self._absorb_buffer(RATE)
            self.filled = 0

    def absorb(self, values):
        for v in values:
            self.absorb_single(v)

    def run_round_function(self):
        assert self.filled == 0
        self.state = self.perm(self.state)

    def finalize(self, n: int = CAPACITY):
        """Non-destructive finalize (the reference consumes a copy)."""
        state = list(self.state)
        if self.filled > 0:
            for i in range(self.filled):
                if self.mode == OVERWRITE:
                    state[i] = self.buffer[i]
                else:
                    state[i] = (state[i] + self.buffer[i]) % gl.ORDER
            if self.mode == OVERWRITE:
                for i in range(self.filled, RATE):
                    state[i] = 0
            state = self.perm(state)
        return state[:n]

    def finalize_reset(self, n: int = CAPACITY):
        out = self.finalize(n)
        self.state = [0] * STATE_WIDTH
        self.filled = 0
        return out


def scalar_hash_into_leaf(values, permutation=poseidon2.s_permutation, mode=OVERWRITE):
    sp = ScalarSponge(permutation, mode)
    for v in values:
        sp.absorb_single(v)
    return sp.finalize(CAPACITY)


def scalar_hash_into_node(left, right, permutation=poseidon2.s_permutation, mode=OVERWRITE):
    sp = ScalarSponge(permutation, mode)
    sp.absorb(list(left) + list(right))
    return sp.finalize(CAPACITY)
