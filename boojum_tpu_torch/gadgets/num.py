# Copied from boojum_tpu/gadgets/num.py.
"""Circuit-value arithmetic: Num / Boolean wrappers and the circuit ops
domains used to re-run protocol math inside a circuit.

Reference behavior: src/gadgets/num/mod.rs, boolean/mod.rs, and the crucial
num/prime_field_like.rs trick — `NumAsFieldWrapper`/`NumExtAsFieldWrapper`
implement the field interface over circuit variables so the SAME gate
evaluators and verifier equations run in-circuit. Here the analogue is
`CircuitOps` / `CircuitExt2Ops`: they satisfy the gates/base ops protocol
(add/sub/mul/from_int) with values being variable handles (resp. handle
pairs), so `GateEvaluator.evaluate` and the verifier's quotient-identity
recomputation trace into gate placements unchanged.
"""

from __future__ import annotations

import numpy as np

from ..cs.cs import ConstraintSystem
from ..cs.gates import ConstantsAllocatorGate, FmaGate
from ..cs.gates.arith import FmaGateInExtension
from ..utils import npgl

P = npgl.ORDER


class CircuitOps:
    """Base-field ops over circuit variable handles (ints)."""

    name = "circuit"

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self._one = ConstantsAllocatorGate.allocate_constant(cs, 1)

    def from_int(self, c: int) -> int:
        return ConstantsAllocatorGate.allocate_constant(self.cs, c % P)

    def zero(self) -> int:
        return self.from_int(0)

    def one(self) -> int:
        return self._one

    def add(self, a: int, b: int) -> int:
        # 1·a·1 + 1·b
        return FmaGate.compute_fma(self.cs, 1, (self._one, a), 1, b)

    def sub(self, a: int, b: int) -> int:
        # a + (p-1)·b
        return FmaGate.compute_fma(self.cs, 1, (self._one, a), P - 1, b)

    def mul(self, a: int, b: int) -> int:
        return FmaGate.compute_fma(self.cs, 1, (a, b), 0, self._one)

    def mul_add(self, a: int, b: int, c: int) -> int:
        return FmaGate.compute_fma(self.cs, 1, (a, b), 1, c)

    def scale(self, c: int, a: int) -> int:
        return FmaGate.compute_fma(self.cs, c % P, (self._one, a), 0, self._one)

    def inverse(self, a: int) -> int:
        """Allocate 1/a as witness and constrain a·inv == 1."""
        cs = self.cs
        inv = cs.alloc_variables(1)

        def fn(vals):
            v = int(vals[0, 0])
            return np.asarray([pow(v, P - 2, P)], np.uint64)

        cs.set_values_with_dependencies(np.asarray([[a]], np.uint64), inv, fn)
        FmaGate.enforce_fma_batch(cs, 1, ([a], [int(inv[0])]), 0,
                                  [self._one], [self._one])
        return int(inv[0])

    def enforce_equal(self, a: int, b: int):
        FmaGate.enforce_fma_batch(self.cs, 1, ([self._one], [a]), 0,
                                  [self._one], [b])

    def enforce_zero(self, a: int):
        zero = self.from_int(0)
        FmaGate.enforce_fma_batch(self.cs, 1, ([self._one], [a]), 0,
                                  [self._one], [zero])

    def alloc_witness(self, value: int) -> int:
        return self.cs.alloc_variable_with_value(value % P)


class CircuitExt2Ops:
    """GoldilocksExt2 ops over (c0_var, c1_var) handle pairs — the in-circuit
    twin of Ext2Ops, backed by the extension FMA gate."""

    name = "circuit_ext2"

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.base = CircuitOps(cs)
        self._one = (self.base.one(), self.base.from_int(0))

    def from_int(self, c) -> tuple:
        if isinstance(c, tuple):
            return (self.base.from_int(c[0]), self.base.from_int(c[1]))
        return (self.base.from_int(c), self.base.from_int(0))

    def from_base(self, v: int) -> tuple:
        return (v, self.base.from_int(0))

    def zero(self):
        return self.from_int(0)

    def one(self):
        return self._one

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def mul(self, a, b):
        d0, d1 = FmaGateInExtension.compute_fma_ext_batch(
            self.cs, (1, 0), (([a[0]], [a[1]]), ([b[0]], [b[1]])), (0, 0),
            ([self._one[0]], [self._one[1]]))
        return (int(d0[0]), int(d1[0]))

    def mul_by_base(self, a, v: int):
        return (self.base.mul(a[0], v), self.base.mul(a[1], v))

    def inverse(self, a):
        """Allocate the extension inverse and constrain a·inv == 1."""
        cs = self.cs
        from ..field import extension as ext2
        inv0 = cs.alloc_variables(1)
        inv1 = cs.alloc_variables(1)

        def fn(vals):
            v = (int(vals[0, 0]), int(vals[1, 0]))
            iv = ext2.s2_inv(v)
            return np.stack([np.asarray([iv[0]], np.uint64),
                             np.asarray([iv[1]], np.uint64)])

        cs.set_values_with_dependencies(
            np.asarray([[a[0]], [a[1]]], np.uint64),
            np.stack([inv0, inv1]), fn)
        inv = (int(inv0[0]), int(inv1[0]))
        prod = self.mul(a, inv)
        self.base.enforce_equal(prod[0], self._one[0])
        self.base.enforce_equal(prod[1], self._one[1])
        return inv

    def enforce_equal(self, a, b):
        self.base.enforce_equal(a[0], b[0])
        self.base.enforce_equal(a[1], b[1])

    def select(self, flag: int, a, b):
        """flag ? a : b via SelectionGate."""
        from ..cs.gates import SelectionGate
        out = SelectionGate.select_batch(
            self.cs, np.asarray([a[0], a[1]], np.uint64),
            np.asarray([b[0], b[1]], np.uint64), flag)
        return (int(out[0]), int(out[1]))
