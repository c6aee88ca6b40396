# Port of boojum_tpu/prover/jit_ops.py: the GL2 column helpers and EV.
"""Extension-field column helpers of the prover stages on torch tensors.

`EV` wraps an ext array ``(c0, c1)`` of int64 field tensors with operator
sugar, so the stage code reads like the math. Scalars are ``(int, int)``
ext tuples; the reference's jitted u32-limb primitives become plain calls
into `field.extension`.
"""

from __future__ import annotations

import torch

from ..field import extension as ext2
from ..field import goldilocks as gl


def affine(w, s, beta, gamma):
    """(w + β·s + γ) as an ext array over base arrays w, s (the copy
    permutation's numerator and denominator factors)."""
    return (gl.add(gl.add(w, gl.mul(s, beta[0])), gamma[0]),
            gl.add(gl.mul(s, beta[1]), gamma[1]))


class EV:
    """An ext-field vector (c0, c1) with operator sugar."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = c0
        self.c1 = c1

    @property
    def a(self):
        return (self.c0, self.c1)

    @staticmethod
    def from_base(b):
        return EV(b, torch.zeros_like(b))

    @staticmethod
    def const(c, shape, device):
        return EV(*ext2.full(shape, c, device))

    def __add__(self, o):
        return EV(*ext2.add(self.a, o.a))

    def __sub__(self, o):
        return EV(*ext2.sub(self.a, o.a))

    def __mul__(self, o):
        return EV(*ext2.mul(self.a, o.a))

    def inv(self):
        return EV(*ext2.inverse(self.a))

    def scale(self, c):
        """Times the ext scalar c = (int, int)."""
        return EV(*ext2.scale(self.a, c))

    def mul_base(self, b):
        return EV(*ext2.mul_by_base(self.a, b))

    def to_host(self):
        return gl.to_u64(self.c0), gl.to_u64(self.c1)
