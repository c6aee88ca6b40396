# Port of boojum_tpu/hash/poseidon2.py (its exact scalar twin with one
# reduction an output and the S-box by pow).
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

import functools

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
_MAX_I63 = (1 << 63) - 1


# ----------------------------------------------------------------------------
# Batched torch permutation on a stacked (12, B) state
# ----------------------------------------------------------------------------


_M32 = 0xFFFF_FFFF


def _mul_lazy(a, b):
    """a·b mod p for any u64 patterns a, b, not canonicalized."""
    return gl._reduce128_lazy(*gl._mul_wide(a, b))


def _sbox7(x):
    """x^7 for canonical x, canonical out: x^2, x^3, x^4 and x^7 as lazy
    products (about three quarters of `goldilocks.mul`'s ops each), one
    canonicalization at the end."""
    x2 = _mul_lazy(x, x)
    x3 = _mul_lazy(x, x2)
    x4 = _mul_lazy(x2, x2)
    return gl.canonicalize(_mul_lazy(x3, x4))


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


@functools.lru_cache(maxsize=None)
def _diag_shift_tables(device):
    """The internal diagonal's shifts s[i] as (12, 1) tensors on ``device``:
    s, and 63 - s for the high part of x·2^s."""
    s = torch.tensor(_DIAG_SHIFTS, dtype=torch.int64, device=device)[:, None]
    return s, 63 - s


def _sum_lanes(st):
    """Σ st over the 12 lanes, canonical: the sums of the lanes' 32-bit
    halves (< 2^36 each), with hi·2^32 = h1·2^64 + h0·2^32 and 2^64 ≡
    2^32 - 1: lo + h1·(2^32 - 1) < 2^37 and h0·2^32 < p are canonical, and
    one field add joins them."""
    lo = (st & _M32).sum(0)
    hi = gl._lsr32(st).sum(0)
    return gl.add(lo + (hi >> 32) * gl.EPSILON, (hi & _M32) << 32)


def _internal_matrix_stacked(st):
    """st[i] = st[i]·2^shift[i] + Σ st. x·2^s = hi·2^64 + lo with lo = x << s
    (mod 2^64) and hi = x >> (64 - s) (logical, < 2^14), reduced as a
    product's halves are (lazily: the field add of the canonical sum then
    canonicalizes it): the value of gl.mul(x, 2^s) in about a third of its
    ops."""
    s, rest = _diag_shift_tables(st.device)
    hi = ((st >> 1) & _MAX_I63) >> rest
    return gl.add(gl._reduce128_lazy(hi, st << s), _sum_lanes(st)[None])


@functools.lru_cache(maxsize=None)
def _rc_column(r: int, device):
    return torch.tensor([gl.i64(c) for c in _RC[r * 12:(r + 1) * 12]],
                        dtype=torch.int64, device=device)[:, None]


# states a thread of a CPU permutation takes at once: each of the
# permutation's thousands of elementwise ops then works on tensors that stay
# in the core's cache instead of streaming through memory
# (scripts/torch_plain_permutation_chunks.py times it against one batch)
_CPU_STATES_PER_THREAD = 8192


def _permutation_stacked(st: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on a canonical (12, B) int64 state -> canonical (12, B).
    CPU states run in chunks of `_CPU_STATES_PER_THREAD` states a thread of
    torch's pool."""
    if st.device.type != "cpu":
        return _permutation_one(st)
    chunk = _CPU_STATES_PER_THREAD * torch.get_num_threads()
    return torch.cat([_permutation_one(st[:, i:i + chunk])
                      for i in range(0, st.shape[1], chunk)], dim=1)


def _permutation_one(st: torch.Tensor) -> torch.Tensor:
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


# round constants a round, as tuples
_RC_ROUNDS = tuple(tuple(_RC[r * 12:(r + 1) * 12])
                   for r in range(2 * _R_F_HALF + _R_P))


def s_external_mds(state):
    """The block circulant [[2,1,1],[1,2,1],[1,1,2]] of M4 blocks; sums
    stay unreduced (a few bits past 64) until the one reduction an output."""
    blocks = []
    for i in (0, 4, 8):
        x0, x1, x2, x3 = state[i:i + 4]
        t0, t1 = x0 + x1, x2 + x3
        t2, t3 = 2 * x1 + t1, 2 * x3 + t0
        t4, t5 = 4 * t1 + t3, 4 * t0 + t2
        blocks.append((t3 + t5, t5, t2 + t4, t4))
    total = [a + b + c for a, b, c in zip(*blocks)]
    return [(v + t) % ORDER for blk in blocks for v, t in zip(blk, total)]


def s_internal_matrix(state):
    total = sum(state)
    return [((s << sh) + total) % ORDER for s, sh in zip(state, _DIAG_SHIFTS)]


def s_permutation(state: list[int]) -> list[int]:
    """Exact Poseidon2 permutation on one 12-element state of Python ints
    (canonical out; the S-box x^7 by ``pow``)."""
    assert len(state) == STATE_WIDTH
    state = s_external_mds(state)
    rounds = iter(_RC_ROUNDS)
    for _ in range(_R_F_HALF):
        state = s_external_mds([pow(s + c, 7, ORDER)
                                for s, c in zip(state, next(rounds))])
    for _ in range(_R_P):
        state[0] = pow(state[0] + next(rounds)[0], 7, ORDER)
        state = s_internal_matrix(state)
    for _ in range(_R_F_HALF):
        state = s_external_mds([pow(s + c, 7, ORDER)
                                for s, c in zip(state, next(rounds))])
    return state
