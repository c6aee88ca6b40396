# Port of boojum_tpu/field/extension.py to torch tensors.
"""Quadratic extension GL2 = F_p[u] / (u^2 - 7) on torch tensors.

An element array is a pair ``(c0, c1)`` of int64 field tensors of one shape
(`goldilocks`), meaning c0 + c1·u. Scalars are ``(int, int)`` tuples and go
through the exact Python-int ``s2_*`` helpers, copied from the reference; the
array ops that take a scalar (`full`, `scale`, `base_scale`, `powers`) also
take a device scalar, and then never read it on the host: a `PreparedExt`
(the device transcript's challenges and power tables, split once by
`prepare`: each component and c0 + c1 as `goldilocks.Prepared`, so a scale
by it costs the ops of a scale by host ints), or a (2,) int64 tensor
[c0, c1].
"""

from __future__ import annotations

import torch

from . import goldilocks as gl
from .goldilocks import ORDER

NON_RESIDUE = 7


def zeros(shape, device="cpu"):
    z = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    return (z, z.clone())


def ones(shape, device="cpu"):
    return (torch.ones(tuple(shape), dtype=torch.int64, device=device),
            torch.zeros(tuple(shape), dtype=torch.int64, device=device))


class PreparedExt:
    """A device ext scalar split once: ``c0``, ``c1`` and ``csum`` = c0 + c1
    as `goldilocks.Prepared` scalars. ``c[0]``, ``c[1]`` are the components,
    as for a host pair."""

    __slots__ = ("c0", "c1", "csum")

    def __init__(self, c0, c1, csum):
        self.c0, self.c1, self.csum = c0, c1, csum

    def __getitem__(self, i):
        return (self.c0, self.c1)[i]

    @property
    def device(self):
        return self.c0.value.device

    def pair(self) -> torch.Tensor:
        """The (2,) tensor [c0, c1]."""
        return torch.stack([self.c0.value, self.c1.value])


def prepare(pairs: torch.Tensor) -> list:
    """(..., 2) canonical ext values on the device -> one `PreparedExt` per
    row, in a fixed handful of ops for the whole tensor."""
    v = pairs.reshape(-1, 2)
    csum = gl.add(v[:, 0], v[:, 1])
    flat = gl.prepare(torch.cat([v, csum[:, None]], dim=1))
    return [PreparedExt(*flat[3 * i:3 * i + 3]) for i in range(v.shape[0])]


def full(shape, c, device="cpu"):
    """Ext scalar ``c = (c0, c1)`` broadcast to ``shape``."""
    return (gl.full(shape, c[0], device), gl.full(shape, c[1], device))


def from_base(a):
    return (a, torch.zeros_like(a))


def add(a, b):
    return (gl.add(a[0], b[0]), gl.add(a[1], b[1]))


def sub(a, b):
    return (gl.sub(a[0], b[0]), gl.sub(a[1], b[1]))


def neg(a):
    return (gl.neg(a[0]), gl.neg(a[1]))


def mul(a, b):
    v0 = gl.mul(a[0], b[0])
    v1 = gl.mul(a[1], b[1])
    c0 = gl.add(v0, gl.mul(v1, NON_RESIDUE))
    t = gl.mul(gl.add(a[0], a[1]), gl.add(b[0], b[1]))
    return (c0, gl.sub(gl.sub(t, v0), v1))


def mul_by_base(a, b):
    return (gl.mul(a[0], b), gl.mul(a[1], b))


def scale(a, c):
    """Ext array times the ext scalar ``c`` (host pair, `PreparedExt` or
    device (2,))."""
    v0 = gl.mul(a[0], c[0])
    v1 = gl.mul(a[1], c[1])
    c0 = gl.add(v0, gl.mul(v1, NON_RESIDUE))
    if isinstance(c, PreparedExt):
        csum = c.csum
    elif isinstance(c, torch.Tensor):
        csum = gl.add(c[0], c[1])
    else:
        csum = (c[0] + c[1]) % ORDER
    t = gl.mul(gl.add(a[0], a[1]), csum)
    return (c0, gl.sub(gl.sub(t, v0), v1))


def base_scale(b, c):
    """Base array times the ext scalar ``c``."""
    return (gl.mul(b, c[0]), gl.mul(b, c[1]))


def square(a):
    return mul(a, a)


def inverse(a):
    """Elementwise inverse via the norm: (c0 - c1·u) / (c0² - 7·c1²)."""
    norm = gl.sub(gl.square(a[0]), gl.mul(gl.square(a[1]), NON_RESIDUE))
    inv_norm = gl.inverse(norm)
    return (gl.mul(a[0], inv_norm), gl.neg(gl.mul(a[1], inv_norm)))


batch_inverse = inverse


def exclusive_prefix_mul(a):
    """z[0] = 1, z[i] = prod_{k<i} a[k] along axis 0 (Hillis-Steele scan:
    log n vectorized passes)."""
    n = a[0].shape[0]
    inc = (a[0].clone(), a[1].clone())
    shift = 1
    while shift < n:
        m = mul((inc[0][shift:], inc[1][shift:]),
                (inc[0][:-shift], inc[1][:-shift]))
        inc = (torch.cat([inc[0][:shift], m[0]]),
               torch.cat([inc[1][:shift], m[1]]))
        shift <<= 1
    one = ones((1,) + tuple(a[0].shape[1:]), a[0].device)
    return (torch.cat([one[0], inc[0][:-1]]), torch.cat([one[1], inc[1][:-1]]))


def powers(c, n: int, device="cpu"):
    """[c^0, ..., c^(n-1)] of the ext scalar ``c`` as an (n,) ext array, by
    doubling: the first powers times c^have give the next ones. For a host
    pair, c^have comes from the host. For a device scalar the table carries
    it: with t[0 .. have] filled, t[1 .. have] · t[have] fill
    t[have + 1 .. 2·have], whose last entry is the next step; one ext
    multiply a doubling, broadcast against the step's one-element slices."""
    out = ones((n,), device)
    if isinstance(c, (PreparedExt, torch.Tensor)):
        if n > 1:  # in place: filling the table
            out[0][1:2].copy_(gl.full((1,), c[0]))
            out[1][1:2].copy_(gl.full((1,), c[1]))
        have = 1  # t[0 .. have] hold c^0 .. c^have
        while have < n - 1:
            take = min(have, n - 1 - have)
            nxt = mul((out[0][1:take + 1], out[1][1:take + 1]),
                      (out[0][have:have + 1], out[1][have:have + 1]))
            out[0][have + 1:have + take + 1] = nxt[0]
            out[1][have + 1:have + take + 1] = nxt[1]
            have += take
        return out
    have = 1
    while have < n:
        take = min(have, n - have)
        nxt = scale((out[0][:take], out[1][:take]), s2_pow(c, have))
        out[0][have:have + take] = nxt[0]  # in place: filling the table
        out[1][have:have + take] = nxt[1]
        have += take
    return out


def sum_mod(a, dim: int = 0):
    return (gl.sum_mod(a[0], dim), gl.sum_mod(a[1], dim))


# ---------------------------------------------------------------------------
# Exact host-side scalar extension ops over (int, int) tuples
# ---------------------------------------------------------------------------


def s2_add(a, b):
    return ((a[0] + b[0]) % ORDER, (a[1] + b[1]) % ORDER)


def s2_sub(a, b):
    return ((a[0] - b[0]) % ORDER, (a[1] - b[1]) % ORDER)


def s2_mul(a, b):
    c0 = (a[0] * b[0] + NON_RESIDUE * a[1] * b[1]) % ORDER
    c1 = (a[0] * b[1] + a[1] * b[0]) % ORDER
    return (c0, c1)


def s2_neg(a):
    return ((-a[0]) % ORDER, (-a[1]) % ORDER)


def s2_inv(a):
    norm = (a[0] * a[0] - NON_RESIDUE * a[1] * a[1]) % ORDER
    inv_norm = pow(norm, ORDER - 2, ORDER)
    return ((a[0] * inv_norm) % ORDER, (-a[1] * inv_norm) % ORDER)


def s2_pow(a, e: int):
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = s2_mul(result, base)
        e >>= 1
        base = s2_mul(base, base)
    return result
