# Copied from boojum_tpu/utils/npgl.py.
"""Vectorized host-side Goldilocks arithmetic on numpy uint64 arrays.

Used by witness generation (the TPU build's replacement for the reference's
multithreaded DAG resolver, src/dag/ — see SURVEY §2.6: dependency-ordered
vectorized host batches) and by host-side setup computations. Device-side
arithmetic lives in boojum_tpu_torch.field.goldilocks (int64 tensors).

All functions take/return canonical uint64 arrays (< p) elementwise.
"""

from __future__ import annotations

import numpy as np

# uint64 wraparound is intentional throughout (carry/borrow tracking)
np.seterr(over="ignore")

P = np.uint64(0xFFFF_FFFF_0000_0001)
EPSILON = np.uint64(0xFFFF_FFFF)  # 2^64 mod p
_MASK32 = np.uint64(0xFFFF_FFFF)
_U32 = np.uint64(32)

ORDER = 0xFFFF_FFFF_0000_0001


def _tiny(a, b):
    """Fast exact-int path for size-1 operands (gadget scalar calls dominate
    synthesis; numpy dispatch on 1-element arrays costs ~30µs vs ~1µs)."""
    return a.size == 1 and b.size == 1


def add(a, b):
    """(a + b) mod p for canonical a, b."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    if _tiny(a, b):
        v = (int(a.reshape(-1)[0]) + int(b.reshape(-1)[0])) % ORDER
        return np.full(a.shape if a.ndim >= b.ndim else b.shape, v, np.uint64)
    s = a + b
    wrapped = s < a  # overflow past 2^64: add EPSILON
    s = np.where(wrapped, s + EPSILON, s)
    # canonicalize (one conditional subtract suffices: s < 2p always)
    ge = s >= P
    return np.where(ge, s - P, s)


def sub(a, b):
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    if _tiny(a, b):
        v = (int(a.reshape(-1)[0]) - int(b.reshape(-1)[0])) % ORDER
        return np.full(a.shape if a.ndim >= b.ndim else b.shape, v, np.uint64)
    d = a - b
    borrow = a < b
    # wrapped: d = a - b + 2^64 ≡ a - b + EPSILON (mod p)
    return np.where(borrow, d - EPSILON, d)


def neg(a):
    a = np.asarray(a, np.uint64)
    return np.where(a == 0, a, P - a)


def _mul_wide(a, b):
    """64x64 -> (hi, lo) uint64 pair."""
    a0 = a & _MASK32
    a1 = a >> _U32
    b0 = b & _MASK32
    b1 = b >> _U32
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    # mid = lh + hl + (ll >> 32), tracking carry out of 64 bits
    mid = lh + (ll >> _U32)
    mid2 = mid + hl
    carry = np.where(mid2 < hl, np.uint64(1), np.uint64(0))
    lo = (ll & _MASK32) | (mid2 << _U32)
    hi = hh + (mid2 >> _U32) + (carry << _U32)
    return hi, lo


def _reduce128(hi, lo):
    """Reduce hi:lo mod p via 2^64 ≡ 2^32 - 1, 2^96 ≡ -1."""
    x2 = hi & _MASK32  # bits 64..96
    x3 = hi >> _U32  # bits 96..128
    # lo + x2 * (2^32 - 1)
    e = (x2 << _U32) - x2
    s = lo + e
    wrapped = s < lo
    s = np.where(wrapped, s + EPSILON, s)
    # subtract x3
    d = s - x3
    borrow = s < x3
    d = np.where(borrow, d - EPSILON, d)
    ge = d >= P
    return np.where(ge, d - P, d)


def mul(a, b):
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    if _tiny(a, b):
        v = (int(a.reshape(-1)[0]) * int(b.reshape(-1)[0])) % ORDER
        return np.full(a.shape if a.ndim >= b.ndim else b.shape, v, np.uint64)
    if a.shape == b.shape and a.size >= 1024:
        from . import native
        if native.available():
            return native.mul(a, b).reshape(a.shape)
    hi, lo = _mul_wide(a, b)
    return _reduce128(hi, lo)


def mul_scalar(a, k: int):
    return mul(a, np.uint64(k % ORDER))


def pow_scalar(a, e: int):
    """a ** e elementwise for python-int e."""
    a = np.asarray(a, np.uint64)
    result = np.full(a.shape, 1, np.uint64)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inv(a):
    """Fermat inverse elementwise (0 -> 0)."""
    return pow_scalar(a, ORDER - 2)


def batch_inv(a):
    """Bulk inversion; 0 maps to 0. Native Montgomery chain when available
    (~600x numpy Fermat), else vectorized Fermat."""
    a = np.asarray(a, np.uint64)
    if a.size >= 64:
        from . import native
        if native.available():
            return native.batch_inv(a.reshape(-1)).reshape(a.shape)
    return inv(a)


# -- extension-field (c0, c1) pair helpers, vectorized ----------------------


def ext_mul(a, b):
    v0 = mul(a[0], b[0])
    v1 = mul(a[1], b[1])
    c0 = add(v0, mul(v1, np.uint64(7)))
    t = mul(add(a[0], a[1]), add(b[0], b[1]))
    return (c0, sub(sub(t, v0), v1))


def ext_powers(base, count: int):
    """[base^0 .. base^(count-1)] for an ext scalar, vectorized doubling."""
    c0 = np.empty(count, np.uint64)
    c1 = np.empty(count, np.uint64)
    if count == 0:
        return (c0, c1)
    c0[0], c1[0] = 1, 0
    have = 1
    cur = (int(base[0]) % ORDER, int(base[1]) % ORDER)
    step = cur
    while have < count:
        take = min(have, count - have)
        s0 = np.uint64(step[0])
        s1 = np.uint64(step[1])
        r = ext_mul((c0[:take], c1[:take]), (s0, s1))
        c0[have:have + take] = r[0]
        c1[have:have + take] = r[1]
        have += take
        # step = base^have
        v0 = (step[0] * step[0] + 7 * step[1] * step[1]) % ORDER
        v1 = (2 * step[0] * step[1]) % ORDER
        step = (v0, v1)
    # note: step doubling above squares; recompute precisely for correctness
    return (c0, c1)


def ext_exclusive_prefix_mul(a):
    """Exclusive prefix products of ext pairs via Hillis-Steele (log n
    vectorized passes) — the host twin of the device associative scan."""
    n = a[0].shape[0]
    inc0 = a[0].copy()
    inc1 = a[1].copy()
    shift = 1
    while shift < n:
        m0 = ext_mul((inc0[shift:], inc1[shift:]), (inc0[:-shift], inc1[:-shift]))
        inc0[shift:] = m0[0]
        inc1[shift:] = m0[1]
        shift <<= 1
    out0 = np.empty(n, np.uint64)
    out1 = np.empty(n, np.uint64)
    out0[0], out1[0] = 1, 0
    out0[1:] = inc0[:-1]
    out1[1:] = inc1[:-1]
    return (out0, out1)


def powers(base: int, count: int):
    """[base^0 .. base^(count-1)] as uint64 (exact doubling ladder)."""
    out = np.empty(count, np.uint64)
    if count == 0:
        return out
    out[0] = 1
    have = 1
    while have < count:
        step = np.uint64(pow(base, have, ORDER))
        take = min(have, count - have)
        out[have:have + take] = mul(out[:take], step)
        have += take
    return out
