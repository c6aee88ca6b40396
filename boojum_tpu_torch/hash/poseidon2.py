# Port of boojum_tpu/hash/poseidon2.py (the exact scalar twin is copied).
"""Poseidon2 permutation over Goldilocks, width 12.

Reference behavior: src/implementations/poseidon2/state_generic_impl.rs
(permutation :221-233, partial round :203, internal matrix :171-200) and
src/implementations/suggested_mds.rs (external MDS addition chain).

Round structure (counter shared across phases, constants indexed by it):
  external MDS -> 4 full rounds -> 22 partial rounds -> 4 full rounds
  full round r:    state += RC[r], sbox^7 each, external MDS
  partial round r: state[0] += RC[r][0], sbox^7 on state[0], internal matrix

`_permutation_stacked` runs a batch stacked as a (12, B) int64 tensor in
plain torch; it is the plain version of the Hopper kernel behind
`pallas_poseidon2.permutation_stacked_fast`. `s_permutation` is the exact
Python-int twin used by the transcript.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from . import _poseidon_constants as C

STATE_WIDTH = C.STATE_WIDTH
RATE = C.RATE
CAPACITY = C.CAPACITY

_RC = C.ALL_ROUND_CONSTANTS  # 30 rounds x 12
_R_F_HALF = C.HALF_NUM_FULL_ROUNDS
_R_P = C.NUM_PARTIAL_ROUNDS
_DIAG_SHIFTS = C.INNER_DIAGONAL_SHIFTS


# ----------------------------------------------------------------------------
# Batched torch permutation on a stacked (12, B) state
# ----------------------------------------------------------------------------


def _sbox7(x):
    x2 = gl.square(x)
    x3 = gl.mul(x, x2)
    x4 = gl.square(x2)
    return gl.mul(x3, x4)


def _external_mds_stacked(st):
    """Block circulant [[2,1,1],[1,2,1],[1,1,2]] of M4 blocks on (12, B):
    the M4 addition chain on (3, B) slices, then out_i = b_i + Σ_k b_k."""
    b = st.reshape(3, 4, -1)
    x0, x1, x2, x3 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    t0 = gl.add(x0, x1)
    t1 = gl.add(x2, x3)
    t2 = gl.add(gl.double(x1), t1)
    t3 = gl.add(gl.double(x3), t0)
    t4 = gl.add(gl.double(gl.double(t1)), t3)
    t5 = gl.add(gl.double(gl.double(t0)), t2)
    blocks = torch.stack([gl.add(t3, t5), t5, gl.add(t2, t4), t4], dim=1)
    total = gl.add(gl.add(blocks[0], blocks[1]), blocks[2])  # (4, B)
    return gl.add(blocks, total[None]).reshape(12, -1)


def _internal_matrix_stacked(st):
    """st[i] = st[i]·2^shift[i] + Σ st."""
    total = gl.sum_mod(st, 0)
    diag = torch.tensor([1 << s for s in _DIAG_SHIFTS], dtype=torch.int64,
                        device=st.device)
    return gl.add(gl.mul(st, diag[:, None]), total[None])


def _rc_column(r: int, device):
    return torch.tensor([gl.i64(c) for c in _RC[r * 12:(r + 1) * 12]],
                        dtype=torch.int64, device=device)[:, None]


def _permutation_stacked(st: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on a canonical (12, B) int64 state -> canonical (12, B)."""
    st = _external_mds_stacked(st)
    r = 0
    for _ in range(_R_F_HALF):
        st = _external_mds_stacked(_sbox7(gl.add(st, _rc_column(r, st.device))))
        r += 1
    for _ in range(_R_P):
        row0 = _sbox7(gl.add(st[0], _RC[r * 12]))
        st = _internal_matrix_stacked(torch.cat([row0[None], st[1:]]))
        r += 1
    for _ in range(_R_F_HALF):
        st = _external_mds_stacked(_sbox7(gl.add(st, _rc_column(r, st.device))))
        r += 1
    return st


# ----------------------------------------------------------------------------
# Exact scalar twin (Python ints) — used by the host transcript and tests
# ----------------------------------------------------------------------------


def _s_sbox7(x: int) -> int:
    x2 = x * x % ORDER
    x3 = x2 * x % ORDER
    x4 = x2 * x2 % ORDER
    return x3 * x4 % ORDER


def _s_block_mul4(x0, x1, x2, x3):
    t0 = (x0 + x1) % ORDER
    t1 = (x2 + x3) % ORDER
    t2 = (2 * x1 + t1) % ORDER
    t3 = (2 * x3 + t0) % ORDER
    t4 = (4 * t1 + t3) % ORDER
    t5 = (4 * t0 + t2) % ORDER
    t6 = (t3 + t5) % ORDER
    t7 = (t2 + t4) % ORDER
    return t6, t5, t7, t4


def s_external_mds(state):
    b = [_s_block_mul4(*state[0:4]), _s_block_mul4(*state[4:8]), _s_block_mul4(*state[8:12])]
    out = [0] * 12
    for blk in range(3):
        for i in range(4):
            out[blk * 4 + i] = (b[blk][i] + b[0][i] + b[1][i] + b[2][i]) % ORDER
    return out


def s_internal_matrix(state):
    total = sum(state) % ORDER
    return [(s * (1 << _DIAG_SHIFTS[i]) + total) % ORDER for i, s in enumerate(state)]


def s_permutation(state: list[int]) -> list[int]:
    """Exact Poseidon2 permutation on one 12-element state of Python ints."""
    assert len(state) == STATE_WIDTH
    state = s_external_mds(state)
    r = 0
    for _ in range(_R_F_HALF):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(s) for s in state]
        state = s_external_mds(state)
        r += 1
    for _ in range(_R_P):
        state = list(state)
        state[0] = _s_sbox7((state[0] + _RC[r * 12]) % ORDER)
        state = s_internal_matrix(state)
        r += 1
    for _ in range(_R_F_HALF):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(s) for s in state]
        state = s_external_mds(state)
        r += 1
    return state
