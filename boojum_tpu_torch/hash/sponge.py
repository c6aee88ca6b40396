# Copied from boojum_tpu/hash/sponge.py (the scalar sponge; the batched
# hash_leaves / hash_nodes on stacked torch states).
"""Algebraic sponges over Goldilocks: scalar twin + batched leaf hashing.

Reference behavior: src/algebraic_props/sponge.rs (GenericAlgebraicSponge,
absorb/finalize at :224-345) and src/algebraic_props/round_function.rs
(AbsorptionMode absorb/pad). Width 12, rate 8, capacity 4; commitment =
state[..N] (reference poseidon_goldilocks.rs:474-483).

The batched `hash_leaves` / `hash_nodes` (overwrite mode) are the plain
torch versions of the Merkle trees' leaf and node kernels
(`pallas_poseidon2.leaf_hashes` / `node_layer` for Poseidon2,
`poseidon.leaf_hashes` / `node_layer` for the classic Poseidon).
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from . import poseidon, poseidon2

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


# ----------------------------------------------------------------------------
# Batched leaf / node hashing (torch) on stacked (12, N) states
# ----------------------------------------------------------------------------


def _stacked_perm(name):
    return poseidon2._permutation_stacked if name == "poseidon2" \
        else poseidon.permutation_stacked


def hash_leaves(columns: torch.Tensor, permutation: str = "poseidon2"
                ) -> torch.Tensor:
    """Hash N leaves of k canonical elements each: ``columns`` (k, N), leaf
    i is columns[:, i] -> (CAPACITY, N). From the zero state, each rate
    block overwrites state[0..8) and is permuted; a partial last block
    zero-fills the rest of the rate (no 1-then-zeros pad)."""
    perm = _stacked_perm(permutation)
    k, n = columns.shape
    st = columns.new_zeros((STATE_WIDTH, n))
    for r0 in range(0, k, RATE):
        block = columns[r0:r0 + RATE]
        if block.shape[0] < RATE:
            block = torch.cat([block, block.new_zeros((RATE - block.shape[0],
                                                       n))])
        st = perm(torch.cat([block, st[RATE:]]))
    return st[:CAPACITY]


def hash_nodes(left: torch.Tensor, right: torch.Tensor,
               permutation: str = "poseidon2") -> torch.Tensor:
    """Hash N (left, right) node pairs, each (CAPACITY, N): the state
    left ‖ right ‖ 0, one permutation -> (CAPACITY, N)."""
    perm = _stacked_perm(permutation)
    st = torch.cat([left, right, left.new_zeros((CAPACITY, left.shape[1]))])
    return perm(st)[:CAPACITY]
