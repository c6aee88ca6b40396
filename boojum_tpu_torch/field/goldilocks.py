# Port of boojum_tpu/field/goldilocks.py to torch tensors.
"""Goldilocks field arithmetic on torch tensors.

The field is F_p with p = 2^64 - 2^32 + 1. A tensor of field elements is an
``int64`` tensor whose bits are the element's u64 representation: torch has
no working ``uint64`` arithmetic on the CPU, and an ``int64`` tensor runs
unchanged on the CPU and on the GPU. Conventions that follow from that:

- additions, subtractions and left shifts wrap modulo 2^64, which is what
  the u64 algorithms below need;
- ``>>`` on int64 is arithmetic, so logical shifts mask after shifting;
- unsigned comparisons flip the sign bit of both sides first;
- products are formed from 32x16-bit pieces, so that no multiply overflows
  int64 (`_mul32`).

Every public op returns canonical values (< p) for canonical inputs. Python
ints >= 2^63 (p - 1 and most constants) go through `i64` before they meet a
tensor. The scalar `s_*` helpers and `domain_generator` are exact Python-int
twins, copied from the reference.
"""

from __future__ import annotations

import numpy as np
import torch

# Field constants (reference src/field/goldilocks/mod.rs:110-116).
ORDER = 0xFFFF_FFFF_0000_0001
EPSILON = 0xFFFF_FFFF  # 2^64 mod p
MULTIPLICATIVE_GENERATOR = 7
TWO_ADICITY = 32
RADIX_2_SUBGROUP_GENERATOR = 0x185629DCDA58878C
CHAR_BITS = 64

_M32 = 0xFFFF_FFFF
_SIGN = -(1 << 63)


def i64(v: int) -> int:
    """u64 value (any Python int, reduced mod 2^64) -> its int64 bit pattern."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


_P = i64(ORDER)


# ---------------------------------------------------------------------------
# host <-> tensor
# ---------------------------------------------------------------------------


def from_u64(arr, device="cpu") -> torch.Tensor:
    """numpy u64 array (any shape) -> int64 tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy u64 array on the host."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def full(shape, value: int, device="cpu") -> torch.Tensor:
    return torch.full(tuple(shape), i64(value % ORDER), dtype=torch.int64,
                      device=device)


def _pattern(b):
    """Second operand of add/sub: a tensor, or a Python int as its pattern."""
    return b if isinstance(b, torch.Tensor) else i64(int(b) % ORDER)


# ---------------------------------------------------------------------------
# u64 helpers on int64 bit patterns
# ---------------------------------------------------------------------------


def _lsr32(x):
    """Logical x >> 32."""
    return (x >> 32) & _M32


def _ult(a, b):
    """Unsigned a < b."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _mul32(a, b):
    """u64 bit pattern of a * b for 0 <= a, b < 2^32. Each multiply is
    32x16 bits (< 2^48); only the shift and the add wrap."""
    return a * (b & 0xFFFF) + ((a * (b >> 16)) << 16)


def _mul_wide(a, b):
    """64x64 -> (hi, lo) u64 patterns (utils/npgl._mul_wide). ``a`` is a
    tensor; ``b`` a tensor or a non-negative Python int."""
    a0 = a & _M32
    a1 = _lsr32(a)
    b0 = b & _M32
    b1 = _lsr32(b)
    ll = _mul32(a0, b0)
    lh = _mul32(a0, b1)
    hl = _mul32(a1, b0)
    hh = _mul32(a1, b1)
    mid = lh + _lsr32(ll)
    mid2 = mid + hl
    carry = _ult(mid2, hl).to(torch.int64)
    lo = (ll & _M32) | (mid2 << 32)
    hi = hh + _lsr32(mid2) + (carry << 32)
    return hi, lo


def canonicalize(x):
    """Any u64 pattern -> its canonical representative (< p)."""
    return torch.where(_ult(x, _P), x, x - _P)


def _reduce128(hi, lo):
    """hi:lo mod p via 2^64 = 2^32 - 1 and 2^96 = -1 (mod p)."""
    x2 = hi & _M32
    x3 = _lsr32(hi)
    e = (x2 << 32) - x2
    s = lo + e
    s = torch.where(_ult(s, lo), s + EPSILON, s)
    d = s - x3
    d = torch.where(_ult(s, x3), d - EPSILON, d)
    return canonicalize(d)


# ---------------------------------------------------------------------------
# field ops (canonical in, canonical out)
# ---------------------------------------------------------------------------


def add(a, b):
    b = _pattern(b)
    s = a + b
    s = torch.where(_ult(s, a), s + EPSILON, s)
    return canonicalize(s)


def sub(a, b):
    b = _pattern(b)
    d = a - b
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a):
    return torch.where(a == 0, a, _P - a)


def double(a):
    return add(a, a)


def mul(a, b):
    """a * b; ``b`` may also be a Python int (split on the host, no upload)."""
    if not isinstance(b, torch.Tensor):
        b = int(b) % ORDER
    hi, lo = _mul_wide(a, b)
    return _reduce128(hi, lo)


def square(a):
    return mul(a, a)


def pow_const(a, e: int):
    """a ** e elementwise for a Python-int exponent."""
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inverse(a):
    """Fermat inverse elementwise; 0 maps to 0."""
    return pow_const(a, ORDER - 2)


def batch_inverse(a):
    """Elementwise inverse of a whole tensor (0 maps to 0)."""
    return inverse(a)


def sum_mod(a, dim: int = 0):
    """Modular sum along ``dim`` by a log-depth tree of `add`."""
    a = a.movedim(dim, 0)
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        s = add(a[:half], a[half:2 * half])
        if a.shape[0] % 2:
            s = torch.cat([s, a[2 * half:]])
        a = s
    return a[0]


# ---------------------------------------------------------------------------
# Host-side exact scalar helpers (Python ints)
# ---------------------------------------------------------------------------


def s_add(a: int, b: int) -> int:
    return (a + b) % ORDER


def s_sub(a: int, b: int) -> int:
    return (a - b) % ORDER


def s_mul(a: int, b: int) -> int:
    return (a * b) % ORDER


def s_inv(a: int) -> int:
    return pow(a, ORDER - 2, ORDER)


def s_pow(a: int, e: int) -> int:
    return pow(a, e, ORDER)


def domain_generator(log2_size: int) -> int:
    """Generator of the order-2^log2_size subgroup (reference
    src/cs/implementations/utils.rs:13)."""
    assert log2_size <= TWO_ADICITY
    g = RADIX_2_SUBGROUP_GENERATOR
    for _ in range(TWO_ADICITY - log2_size):
        g = s_mul(g, g)
    return g
