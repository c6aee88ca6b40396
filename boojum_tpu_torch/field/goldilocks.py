# Port of boojum_tpu/field/goldilocks.py to torch tensors.
"""Goldilocks field arithmetic on torch tensors.

The field is F_p with p = 2^64 - 2^32 + 1. A tensor of field elements is an
``int64`` tensor whose bits are the element's u64 representation: torch has
no working ``uint64`` arithmetic on the CPU, and an ``int64`` tensor runs
unchanged on the CPU and on the GPU. Conventions that follow from that:

- additions, subtractions, left shifts and products wrap modulo 2^64,
  which is what the u64 algorithms below need: a product of two 32-bit
  halves is its exact u64 bit pattern (`_mul_wide`);
- ``>>`` on int64 is arithmetic, so logical shifts mask after shifting;
- unsigned comparisons flip the sign bit of both sides first.

Every public op returns canonical values (< p) for canonical inputs. Python
ints >= 2^63 (p - 1 and most constants) go through `i64` before they meet a
tensor. The scalar `s_*` helpers and `domain_generator` are exact Python-int
twins, copied from the reference.

A scalar operand of `mul`, `add`, `sub` and `full` may be a Python int (split
on the host), a tensor, or a `Prepared` scalar: a 0-dim device value that
`prepare` split once into the 32-bit halves `mul` needs, so a multiply by a
device challenge costs the same ops as a multiply by a host int.
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


class Prepared:
    """A canonical field scalar on the device, split once: ``value`` (0-dim)
    and ``limbs``, its low and high 32-bit halves (0-dim). `mul` takes the
    halves as they are."""

    __slots__ = ("value", "limbs")

    def __init__(self, value: torch.Tensor, limbs):
        self.value = value
        self.limbs = tuple(limbs)


def prepare(values: torch.Tensor) -> list:
    """Canonical values (any shape, taken flat) -> one `Prepared` each, in
    a fixed handful of ops for the whole tensor."""
    v = values.reshape(-1)
    limbs = torch.stack([v, v >> 32], dim=1) & _M32
    vals, flat = v.unbind(0), limbs.reshape(-1).unbind(0)
    return [Prepared(vals[i], flat[2 * i:2 * i + 2]) for i in range(len(vals))]


def full(shape, value, device="cpu") -> torch.Tensor:
    """``value`` (a Python int, a canonical 0-dim tensor on ``device`` or a
    `Prepared` scalar) broadcast to ``shape``."""
    if isinstance(value, Prepared):
        value = value.value
    if isinstance(value, torch.Tensor):
        return value.expand(tuple(shape)).clone()
    return torch.full(tuple(shape), i64(value % ORDER), dtype=torch.int64,
                      device=device)


def _pattern(b):
    """Second operand of add/sub: a tensor, a `Prepared` scalar's value, or
    a Python int as its pattern."""
    if isinstance(b, Prepared):
        return b.value
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


def _limbs(b):
    """The low and high 32-bit halves of ``b``: Python ints for an int, as
    prepared for a `Prepared` scalar, else split on the device."""
    if isinstance(b, Prepared):
        return b.limbs
    if not isinstance(b, torch.Tensor):
        return b & _M32, b >> 32
    return b & _M32, _lsr32(b)


def _mul_wide(a, b):
    """64x64 -> (hi, lo) u64 patterns. ``a`` is a tensor; ``b`` a tensor, a
    `Prepared` scalar or a non-negative Python int. The low word is the
    wrapped int64 product; the high word is the classic mulhi of the 32-bit
    halves: t = a0·b1 + (a0·b0 >> 32) and u = a1·b0 + (t mod 2^32) stay
    below 2^64, and hi = a1·b1 + (t >> 32) + (u >> 32)."""
    a0 = a & _M32
    a1 = _lsr32(a)
    b0, b1 = _limbs(b)
    t = a0 * b1 + _lsr32(a0 * b0)
    u = a1 * b0 + (t & _M32)
    hi = a1 * b1 + _lsr32(t) + _lsr32(u)
    return hi, a * _pattern(b)


def canonicalize(x):
    """Any u64 pattern -> its canonical representative (< p)."""
    return torch.where(_ult(x, _P), x, x - _P)


def _reduce128_lazy(hi, lo):
    """hi:lo mod p via 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), not
    canonicalized: a u64 pattern congruent to the value, maybe >= p. Exact
    for any hi, lo: the overflowing add cannot wrap twice, and the
    borrowing subtract leaves s - x3 + p >= 0."""
    x2 = hi & _M32
    x3 = _lsr32(hi)
    e = (x2 << 32) - x2
    s = lo + e
    s = torch.where(_ult(s, lo), s + EPSILON, s)
    d = s - x3
    return torch.where(_ult(s, x3), d - EPSILON, d)


def _reduce128(hi, lo):
    """hi:lo mod p, canonical."""
    return canonicalize(_reduce128_lazy(hi, lo))


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
    """a * b; ``b`` may also be a Python int (split on the host, no upload)
    or a `Prepared` scalar (split once, when it was prepared)."""
    if not isinstance(b, (torch.Tensor, Prepared)):
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
