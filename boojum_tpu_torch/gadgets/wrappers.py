# Copied from boojum_tpu/gadgets/wrappers.py.
"""User-facing typed gadget wrappers: Num, Boolean, UInt8/16/32/64.

Reference behavior: src/gadgets/num/mod.rs, boolean/mod.rs, u8/u16/u32 —
thin typed handles over circuit variables with arithmetic/selection helpers
and witness hooks. Batched variants operate on numpy handle arrays (the
TPU-build synthesis style). Range checks route through lookup tables when a
table budget exists (sha256-style 4-bit tables) or boolean decomposition
otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cs.cs import ConstraintSystem
from ..cs.gates import (BooleanConstraintGate, ConstantsAllocatorGate,
                        FmaGate, ReductionGate, SelectionGate, ZeroCheckGate)
from ..utils import npgl

P = npgl.ORDER


@dataclass(frozen=True)
class Num:
    """A field element as a circuit variable (reference Num<F>)."""

    cs: ConstraintSystem
    variable: int

    @staticmethod
    def allocate(cs, value: int) -> "Num":
        return Num(cs, cs.alloc_variable_with_value(value % P))

    @staticmethod
    def constant(cs, value: int) -> "Num":
        return Num(cs, ConstantsAllocatorGate.allocate_constant(cs, value % P))

    def _one(self):
        return ConstantsAllocatorGate.allocate_constant(self.cs, 1)

    def add(self, other: "Num") -> "Num":
        v = FmaGate.compute_fma(self.cs, 1, (self._one(), self.variable), 1,
                                other.variable)
        return Num(self.cs, v)

    def sub(self, other: "Num") -> "Num":
        v = FmaGate.compute_fma(self.cs, 1, (self._one(), self.variable),
                                P - 1, other.variable)
        return Num(self.cs, v)

    def mul(self, other: "Num") -> "Num":
        v = FmaGate.compute_fma(self.cs, 1, (self.variable, other.variable),
                                0, self._one())
        return Num(self.cs, v)

    def is_zero(self) -> "Boolean":
        flag = ZeroCheckGate.is_zero_batch(self.cs, [self.variable])
        return Boolean(self.cs, int(flag[0]))

    def equals(self, other: "Num") -> "Boolean":
        return self.sub(other).is_zero()

    def select(self, flag: "Boolean", other: "Num") -> "Num":
        """flag ? self : other."""
        v = SelectionGate.select_batch(
            self.cs, np.asarray([self.variable], np.uint64),
            np.asarray([other.variable], np.uint64), flag.variable)
        return Num(self.cs, int(v[0]))

    def get_witness(self) -> int:
        return self.cs.get_value(self.variable)

    # -- reference-parity API (src/gadgets/num/mod.rs) ------------------------

    @staticmethod
    def zero(cs) -> "Num":
        return Num.constant(cs, 0)

    def enforce_equal(self, other: "Num"):
        """src/gadgets/num/mod.rs:409."""
        from .num import CircuitOps
        CircuitOps(self.cs).enforce_equal(self.variable, other.variable)

    def conditionally_enforce_equal(self, flag: "Boolean", other: "Num"):
        """flag · (self − other) == 0 (src/gadgets/num/mod.rs:973)."""
        cs = self.cs
        diff = self.sub(other)
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        FmaGate.enforce_fma_batch(cs, 1, ([flag.variable], [diff.variable]),
                                  0, [self._one()], [zero])

    def mask(self, flag: "Boolean") -> "Num":
        """self · flag (src/gadgets/num/mod.rs:438)."""
        v = FmaGate.compute_fma(self.cs, 1, (self.variable, flag.variable),
                                0, self._one())
        return Num(self.cs, v)

    def mask_negated(self, flag: "Boolean") -> "Num":
        """self · (1 − flag) (src/gadgets/num/mod.rs:465)."""
        return self.mask(flag.not_())

    @staticmethod
    def fma(cs, a: "Num", b: "Num", coeff_quad: int, c: "Num",
            coeff_lin: int) -> "Num":
        """coeff_quad·a·b + coeff_lin·c (src/gadgets/num/mod.rs:1012)."""
        v = FmaGate.compute_fma(cs, coeff_quad % P, (a.variable, b.variable),
                                coeff_lin % P, c.variable)
        return Num(cs, v)

    def inverse_unchecked(self) -> "Num":
        """Witness inverse with self·inv == 1 enforced
        (src/gadgets/num/mod.rs:1036; unsatisfiable when self == 0)."""
        from .num import CircuitOps
        return Num(self.cs, CircuitOps(self.cs).inverse(self.variable))

    @staticmethod
    def conditionally_swap(flag: "Boolean", a: "Num", b: "Num"):
        """Returns (flag ? b : a, flag ? a : b) via the swap gate
        (src/gadgets/num/mod.rs:1052)."""
        from ..cs.gates import ConditionalSwapGate
        ra, rb = ConditionalSwapGate.swap_batch(
            a.cs, flag.variable, [a.variable], [b.variable])
        return Num(a.cs, int(ra[0])), Num(a.cs, int(rb[0]))

    @staticmethod
    def linear_combination(cs, pairs) -> "Num":
        """Σ coeff_i · num_i via chained reduction gates
        (src/gadgets/num/mod.rs:621)."""
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        acc = None
        rest = [(int(c) % P, n.variable) for c, n in pairs]
        while rest or acc is None:
            group = rest[:3] if acc is not None else rest[:4]
            coeffs = ([1] if acc is not None else []) + [c for c, _ in group]
            terms = ([acc] if acc is not None else []) + [t for _, t in group]
            while len(terms) < 4:
                terms.append(zero)
                coeffs.append(0)
            acc = ReductionGate.reduce_terms(cs, coeffs, terms)
            rest = rest[len(group):]
        return Num(cs, acc)

    @staticmethod
    def enforce_zero_for_linear_combination(cs, pairs):
        """Σ coeff_i · num_i == 0 (src/gadgets/num/mod.rs:664)."""
        acc = Num.linear_combination(cs, pairs)
        acc.enforce_equal(Num.zero(cs))

    @staticmethod
    def dot_product(cs, a_nums, b_nums) -> "Num":
        """Σ a_i·b_i through dot-product gates, chained in blocks of the
        gate width (src/gadgets/num/mod.rs:1107,1134)."""
        from ..cs.gates import DotProductGate
        n_gate = DotProductGate.N
        acc = None
        pairs = list(zip(a_nums, b_nums))
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        while pairs:
            group = pairs[:n_gate - (1 if acc is not None else 0)]
            pairs = pairs[len(group):]
            flat = []
            if acc is not None:
                flat += [acc, one]
            for a, b in group:
                flat += [a.variable, b.variable]
            while len(flat) < 2 * n_gate:
                zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
                flat += [zero, zero]
            out = DotProductGate.dot_batch(
                cs, np.asarray(flat, np.uint64)[:, None])
            acc = int(out[0])
        return Num(cs, acc if acc is not None else
                   ConstantsAllocatorGate.allocate_constant(cs, 0))

    def spread_into_bits(self, limit: int) -> list:
        """LSB-first boolean decomposition, canonical when full-width
        (src/gadgets/num/mod.rs:306)."""
        from .num import CircuitOps
        from .recursion.primitives import decompose_bits
        bits = decompose_bits(self.cs, CircuitOps(self.cs), self.variable,
                              limit, enforce_canonical=(limit == 64))
        return [Boolean(self.cs, int(b)) for b in bits]


@dataclass(frozen=True)
class Boolean:
    """A 0/1-constrained variable (reference Boolean)."""

    cs: ConstraintSystem
    variable: int

    @staticmethod
    def allocate(cs, value: bool) -> "Boolean":
        v = BooleanConstraintGate.allocate_batch(cs, [1 if value else 0])
        return Boolean(cs, int(v[0]))

    def and_(self, other: "Boolean") -> "Boolean":
        one = ConstantsAllocatorGate.allocate_constant(self.cs, 1)
        v = FmaGate.compute_fma(self.cs, 1, (self.variable, other.variable),
                                0, one)
        return Boolean(self.cs, v)

    def or_(self, other: "Boolean") -> "Boolean":
        # a + b - a·b
        one = ConstantsAllocatorGate.allocate_constant(self.cs, 1)
        ab = FmaGate.compute_fma(self.cs, 1, (self.variable, other.variable),
                                 0, one)
        s = FmaGate.compute_fma(self.cs, 1, (one, self.variable), 1,
                                other.variable)
        v = FmaGate.compute_fma(self.cs, 1, (one, s), P - 1, ab)
        return Boolean(self.cs, v)

    def not_(self) -> "Boolean":
        one = ConstantsAllocatorGate.allocate_constant(self.cs, 1)
        v = FmaGate.compute_fma(self.cs, P - 1, (one, self.variable), 1, one)
        return Boolean(self.cs, v)

    def get_witness(self) -> bool:
        return bool(self.cs.get_value(self.variable))

    # -- reference-parity API (src/gadgets/boolean/mod.rs) --------------------

    @staticmethod
    def constant(cs, value: bool) -> "Boolean":
        """src/gadgets/boolean/mod.rs:225 (constants are 0/1 by
        construction; no booleanity gate needed)."""
        return Boolean(cs, ConstantsAllocatorGate.allocate_constant(
            cs, 1 if value else 0))

    @staticmethod
    def from_variable_checked(cs, variable: int) -> "Boolean":
        """Enforce booleanity on an existing variable
        (src/gadgets/boolean/mod.rs:183)."""
        BooleanConstraintGate.enforce_batch(cs, [variable])
        return Boolean(cs, variable)

    negated = not_

    def xor(self, other: "Boolean") -> "Boolean":
        """a + b − 2ab (src/gadgets/boolean/mod.rs:449)."""
        cs = self.cs
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        # s = a + b; out = s − 2ab = 1·s + (p−2)·(a·b) via two FMAs
        s = FmaGate.compute_fma(cs, 1, (one, self.variable), 1, other.variable)
        ab = FmaGate.compute_fma(cs, 1, (self.variable, other.variable), 0, one)
        v = FmaGate.compute_fma(cs, P - 2, (one, ab), 1, s)
        return Boolean(cs, v)

    def equals(self, other: "Boolean") -> "Boolean":
        """NOT xor (src/gadgets/boolean/mod.rs:696)."""
        return self.xor(other).not_()

    def enforce_equal(self, other: "Boolean"):
        from .num import CircuitOps
        CircuitOps(self.cs).enforce_equal(self.variable, other.variable)

    def conditionally_enforce_true(self, flag: "Boolean"):
        """flag → self: flag·(1 − self) == 0
        (src/gadgets/boolean/mod.rs:493)."""
        cs = self.cs
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        # flag·self − flag == 0
        FmaGate.enforce_fma_batch(cs, 1, ([flag.variable], [self.variable]),
                                  P - 1, [flag.variable], [zero])

    def conditionally_enforce_false(self, flag: "Boolean"):
        """flag → NOT self: flag·self == 0
        (src/gadgets/boolean/mod.rs:533)."""
        cs = self.cs
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        FmaGate.enforce_fma_batch(cs, 1, ([flag.variable], [self.variable]),
                                  0, [one], [zero])

    @staticmethod
    def multi_and(cs, bools: list) -> "Boolean":
        """AND over a list: product chain (src/gadgets/boolean/mod.rs:572)."""
        assert bools
        acc = bools[0]
        for b in bools[1:]:
            acc = acc.and_(b)
        return acc

    @staticmethod
    def multi_or(cs, bools: list) -> "Boolean":
        """OR over a list = NOT(AND of negations)
        (src/gadgets/boolean/mod.rs:609)."""
        assert bools
        return Boolean.multi_and(cs, [b.not_() for b in bools]).not_()

    def mask(self, flag: "Boolean") -> "Boolean":
        """self AND flag (src/gadgets/boolean/mod.rs:644)."""
        return self.and_(flag)

    def mask_negated(self, flag: "Boolean") -> "Boolean":
        return self.and_(flag.not_())

    def select(self, flag: "Boolean", other: "Boolean") -> "Boolean":
        v = SelectionGate.select_batch(
            self.cs, np.asarray([self.variable], np.uint64),
            np.asarray([other.variable], np.uint64), flag.variable)
        return Boolean(self.cs, int(v[0]))


class _UIntBase:
    """Shared machinery for fixed-width unsigned ints over one variable."""

    WIDTH = 0

    def __init__(self, cs: ConstraintSystem, variable: int):
        self.cs = cs
        self.variable = variable

    # -- allocation -----------------------------------------------------------

    @classmethod
    def allocate_checked(cls, cs, value: int, table_ids: dict = None):
        v = cs.alloc_variable_with_value(value % (1 << cls.WIDTH))
        out = cls(cs, v)
        out.enforce_range(table_ids)
        return out

    @classmethod
    def allocate_constant(cls, cs, value: int):
        return cls(cs, ConstantsAllocatorGate.allocate_constant(
            cs, value % (1 << cls.WIDTH)))

    def enforce_range(self, table_ids: dict = None):
        """Range check: via 4-bit TriXor lookups when a sha256-style table
        budget exists, else boolean decomposition."""
        cs = self.cs
        if table_ids and "tri_xor" in table_ids:
            from .sha256 import Sha256Gadget
            g = Sha256Gadget(cs, table_ids)
            chunks = cs.alloc_variables(self.WIDTH // 4)

            def fn(vals):
                x = int(vals[0, 0])
                return np.asarray([(x >> (4 * i)) & 0xF
                                   for i in range(self.WIDTH // 4)], np.uint64)

            cs.set_values_with_dependencies(
                np.asarray([[self.variable]], np.uint64), chunks, fn)
            acc = _recompose_pow16(cs, [int(c) for c in chunks])
            one = ConstantsAllocatorGate.allocate_constant(cs, 1)
            FmaGate.enforce_fma_batch(cs, 1, ([one], [acc]), 0, [one],
                                      [self.variable])
            g.range_check_chunks([int(c) for c in chunks])
        else:
            from .recursion.primitives import decompose_bits
            from .num import CircuitOps
            ops = CircuitOps(cs)
            decompose_bits(cs, ops, self.variable, self.WIDTH,
                           enforce_canonical=False)

    # -- arithmetic ------------------------------------------------------------

    def add(self, other):
        """(self + other) mod 2^WIDTH, returns (result, carry Boolean)."""
        from ..cs.gates.arith import U32AddGate
        cs = self.cs
        if self.WIDTH == 32 and cs.gate_is_allowed("u32_add"):
            c, cout = U32AddGate.add_batch(cs, [self.variable],
                                           [other.variable])
            return type(self)(cs, int(c[0])), Boolean(cs, int(cout[0]))
        # generic width via uintx gate
        assert cs.gate_is_allowed(f"uintx_add_{self.WIDTH}")
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        c = cs.alloc_variables(1)
        cout = cs.alloc_variables(1)

        def fn(vals):
            s = int(vals[0, 0]) + int(vals[1, 0])
            return np.stack([np.asarray([s % (1 << self.WIDTH)], np.uint64),
                             np.asarray([s >> self.WIDTH], np.uint64)])

        cs.set_values_with_dependencies(
            np.asarray([[self.variable], [other.variable]], np.uint64),
            np.stack([c, cout]), fn)
        cs.place_general_gate_batch(
            f"uintx_add_{self.WIDTH}", None, [1 << self.WIDTH],
            np.asarray([[self.variable, other.variable, zero,
                         int(c[0]), int(cout[0])]], np.uint64))
        return type(self)(cs, int(c[0])), Boolean(cs, int(cout[0]))

    def sub(self, other):
        """(self − other) mod 2^WIDTH, returns (result, borrow Boolean)
        (src/gadgets/u32/mod.rs:339 overflowing_sub)."""
        from ..cs.gates.arith import U32SubGate
        cs = self.cs
        if self.WIDTH == 32 and cs.gate_is_allowed("u32_sub"):
            c, bout = U32SubGate.sub_batch(cs, [self.variable],
                                           [other.variable])
            return type(self)(cs, int(c[0])), Boolean(cs, int(bout[0]))
        # generic width: re-use the add gate as other + result == self
        # + borrow·2^W (same relation the reference's UIntXAdd swap uses)
        assert cs.gate_is_allowed(f"uintx_add_{self.WIDTH}")
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        c = cs.alloc_variables(1)
        bout = cs.alloc_variables(1)

        def fn(vals):
            d = int(vals[0, 0]) - int(vals[1, 0])
            return np.stack([np.asarray([d % (1 << self.WIDTH)], np.uint64),
                             np.asarray([1 if d < 0 else 0], np.uint64)])

        cs.set_values_with_dependencies(
            np.asarray([[self.variable], [other.variable]], np.uint64),
            np.stack([c, bout]), fn)
        cs.place_general_gate_batch(
            f"uintx_add_{self.WIDTH}", None, [1 << self.WIDTH],
            np.asarray([[other.variable, int(c[0]), zero,
                         self.variable, int(bout[0])]], np.uint64))
        return type(self)(cs, int(c[0])), Boolean(cs, int(bout[0]))

    # reference names (src/gadgets/u32/mod.rs:258,339)
    overflowing_add = add
    overflowing_sub = sub

    def add_no_overflow(self, other, table_ids: dict = None):
        """Add with the carry pinned to zero (src/gadgets/u32/mod.rs:580)."""
        res, carry = self.add(other)
        from .num import CircuitOps
        ops = CircuitOps(self.cs)
        ops.enforce_zero(carry.variable)
        return res

    def sub_no_overflow(self, other, table_ids: dict = None):
        """Sub with the borrow pinned to zero (src/gadgets/u32/mod.rs:613)."""
        res, borrow = self.sub(other)
        from .num import CircuitOps
        ops = CircuitOps(self.cs)
        ops.enforce_zero(borrow.variable)
        return res

    def increment_checked(self, table_ids: dict = None):
        """self + 1 with no overflow allowed (src/gadgets/u32/mod.rs:705)."""
        one = type(self)(self.cs, ConstantsAllocatorGate.allocate_constant(
            self.cs, 1))
        return self.add_no_overflow(one, table_ids)

    def equals(self, other) -> "Boolean":
        from ..cs.gates import ZeroCheckGate
        from .num import CircuitOps
        diff = CircuitOps(self.cs).sub(self.variable, other.variable)
        flag = ZeroCheckGate.is_zero_batch(self.cs, [diff])
        return Boolean(self.cs, int(flag[0]))

    def is_zero(self) -> "Boolean":
        flag = ZeroCheckGate.is_zero_batch(self.cs, [self.variable])
        return Boolean(self.cs, int(flag[0]))

    def select(self, flag: "Boolean", other):
        """flag ? self : other (no new range check needed)."""
        v = SelectionGate.select_batch(
            self.cs, np.asarray([self.variable], np.uint64),
            np.asarray([other.variable], np.uint64), flag.variable)
        return type(self)(self.cs, int(v[0]))

    def mask(self, flag: "Boolean"):
        """self · flag (src/gadgets/u32/mod.rs:646)."""
        one = ConstantsAllocatorGate.allocate_constant(self.cs, 1)
        v = FmaGate.compute_fma(self.cs, 1, (self.variable, flag.variable),
                                0, one)
        return type(self)(self.cs, v)

    def mask_negated(self, flag: "Boolean"):
        return self.mask(flag.not_())

    def get_witness(self) -> int:
        return self.cs.get_value(self.variable)

    def to_bytes(self, table_ids: dict = None) -> list:
        """Byte decomposition (LSB first): witness split + recompose
        identity; bytes range-checked (reference UInt32 byte views)."""
        cs = self.cs
        nb = self.WIDTH // 8
        bytes_v = cs.alloc_variables(nb)

        def fn(vals):
            x = vals[0]
            return np.stack([(x >> np.uint64(8 * i)) & np.uint64(0xFF)
                             for i in range(nb)])

        cs.set_values_with_dependencies(
            np.asarray([[self.variable]], np.uint64), bytes_v, fn)
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        coeffs = [1 << (8 * i) for i in range(nb)] + [0] * (4 - nb)
        terms = [int(b) for b in bytes_v] + [zero] * (4 - nb)
        acc = ReductionGate.reduce_terms(cs, coeffs[:4], terms[:4])
        from .num import CircuitOps
        CircuitOps(cs).enforce_equal(acc, self.variable)
        out = [int(b) for b in bytes_v]
        byte_range_check(cs, out, table_ids)
        return out


def byte_range_check(cs, byte_vars: list, table_ids: dict = None):
    """Range-check variables to [0, 256): via a range/xor8/and8 byte table
    when available, else 8-bit decomposition."""
    table_ids = table_ids or {}
    if "range8" in table_ids:
        # pad to the CS lookup width with constant zeros (range rows are
        # (x, 0, ..) — reference range_check tables are width-padded too)
        width = cs.lookup_parameters.lookup_width()
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        arr = np.asarray(byte_vars, np.uint64)
        rows = [arr] + [np.full(arr.shape, zero, np.uint64)] * (width - 1)
        cs.enforce_lookup_batch(table_ids["range8"], np.stack(rows))
        return
    key = next((k for k in ("xor8", "and8", "binop") if k in table_ids), None)
    if key is not None:
        # (v, v) is a valid key pair iff v < 256; value column pinned to the
        # op result on equal inputs (xor -> 0, and -> v, binop -> packed)
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        n = len(byte_vars)
        arr = np.asarray(byte_vars, np.uint64)
        if key == "xor8":
            out = np.full(n, zero, np.uint64)
        elif key == "and8":
            out = arr
        else:  # binop: xor<<32 | or<<16 | and = v<<16 | v
            out = cs.alloc_variables(n)

            def fn(vals):
                return (vals[0] << np.uint64(16)) | vals[0]

            cs.set_values_with_dependencies(arr[None, :], out, fn)
        cs.enforce_lookup_batch(table_ids[key], np.stack([arr, arr, out]))
        return
    from .num import CircuitOps
    from .recursion.primitives import decompose_bits
    ops = CircuitOps(cs)
    for v in byte_vars:
        decompose_bits(cs, ops, v, 8, enforce_canonical=False)


def _recompose_pow16(cs, chunk_vars: list) -> int:
    """Σ chunk_i · 16^i via chained reductions."""
    zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
    acc = None
    shift = 0
    rest = list(chunk_vars)
    while rest or acc is None:
        group = rest[:3] if acc is not None else rest[:4]
        if acc is not None:
            coeffs = [1] + [1 << (4 * (shift + i)) for i in range(len(group))]
            terms = [acc] + group
        else:
            coeffs = [1 << (4 * i) for i in range(len(group))]
            terms = list(group)
        while len(terms) < 4:
            terms.append(zero)
            coeffs.append(0)
        acc = ReductionGate.reduce_terms(cs, coeffs, terms)
        shift += len(group)
        rest = rest[len(group):]
    return acc


class UInt8(_UIntBase):
    WIDTH = 8


class UInt16(_UIntBase):
    WIDTH = 16


class UInt32(_UIntBase):
    WIDTH = 32

    # -- reference-parity API (src/gadgets/u32/mod.rs) ------------------------

    def to_le_bytes(self, table_ids: dict = None) -> list:
        """LSB-first byte split as UInt8 handles (u32/mod.rs:843)."""
        return [UInt8(self.cs, b) for b in self.to_bytes(table_ids)]

    def to_be_bytes(self, table_ids: dict = None) -> list:
        return list(reversed(self.to_le_bytes(table_ids)))

    decompose_into_bytes = to_le_bytes

    @staticmethod
    def from_le_bytes(cs, bytes_u8: list, table_ids: dict = None) -> "UInt32":
        """Recompose 4 (range-checked) bytes (u32/mod.rs:509)."""
        assert len(bytes_u8) == 4
        terms = [b.variable for b in bytes_u8]
        acc = ReductionGate.reduce_terms(
            cs, [1, 1 << 8, 1 << 16, 1 << 24], terms)
        return UInt32(cs, acc)

    @staticmethod
    def from_be_bytes(cs, bytes_u8: list, table_ids: dict = None) -> "UInt32":
        return UInt32.from_le_bytes(cs, list(reversed(bytes_u8)), table_ids)

    def fma_with_carry(self, b: "UInt32", c: "UInt32", carry_in: "UInt32",
                       table_ids: dict = None):
        """self·b + c + carry_in → (low32, high32) through the byte-limbed
        U8x4FMA gate (u32/mod.rs:542; the sum can exceed the field order so
        the relation must be byte-decomposed, same as the reference)."""
        from ..cs.gates.arith import U8x4FMAGate
        cs = self.cs
        a4 = self.to_bytes(table_ids)
        b4 = b.to_bytes(table_ids)
        c4 = c.to_bytes(table_ids)
        cin4 = carry_in.to_bytes(table_ids)
        low4, high4, pc2 = U8x4FMAGate.perform_fma_batch(
            cs, [a4], [b4], [c4], [cin4])
        low4 = [int(v) for v in low4[0]]
        high4 = [int(v) for v in high4[0]]
        byte_range_check(cs, low4 + high4 + [int(pc2[0, 0]), int(pc2[0, 1])],
                         table_ids)
        low = UInt32(cs, ReductionGate.reduce_terms(
            cs, [1, 1 << 8, 1 << 16, 1 << 24], low4))
        high = UInt32(cs, ReductionGate.reduce_terms(
            cs, [1, 1 << 8, 1 << 16, 1 << 24], high4))
        return low, high

    def non_widening_mul(self, other: "UInt32",
                         table_ids: dict = None) -> "UInt32":
        """self·other with the high word pinned to zero (u32/mod.rs:731)."""
        zero = UInt32.allocate_constant(self.cs, 0)
        low, high = self.fma_with_carry(other, zero, zero, table_ids)
        from .num import CircuitOps
        CircuitOps(self.cs).enforce_zero(high.variable)
        return low

    def div_by_constant(self, constant: int, table_ids: dict = None):
        """(q, r) with self == q·constant + r, r < constant
        (u32/mod.rs:769). The witness-side products fit u32, so the field
        relation q·constant + r == self is exact."""
        cs = self.cs
        assert 0 < constant < (1 << 32)
        sv = self.get_witness() if cs.resolver else 0
        qv, rv = divmod(sv, constant)
        q = UInt32.allocate_checked(cs, qv, table_ids)
        r = UInt32.allocate_checked(cs, rv, table_ids)
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        # q·constant + r == self (q·constant ≤ 2^32−1 enforced by sub below)
        FmaGate.enforce_fma_batch(cs, constant, ([q.variable], [one]), 1,
                                  [r.variable], [self.variable])
        # r < constant: r − constant must borrow
        cst = UInt32.allocate_constant(cs, constant)
        _, borrow = r.sub(cst)
        from .num import CircuitOps
        ops = CircuitOps(cs)
        ops.enforce_equal(borrow.variable, one)
        # q·constant must not wrap mod p: pin q ≤ floor((2^32−1)/constant)
        # so q·constant < 2^32 < p and the field identity is exact.
        qmax = UInt32.allocate_constant(cs, (1 << 32) - 1 if constant == 1
                                        else ((1 << 32) - 1) // constant)
        _, qborrow = qmax.sub(q)
        ops.enforce_zero(qborrow.variable)
        return q, r

    def div2(self, table_ids: dict = None) -> "UInt32":
        """self >> 1 (u32/mod.rs:856): 2·half + bit == self."""
        cs = self.cs
        sv = self.get_witness() if cs.resolver else 0
        half = UInt32.allocate_checked(cs, sv >> 1, table_ids)
        bit = Boolean.allocate(cs, bool(sv & 1))
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        FmaGate.enforce_fma_batch(cs, 2, ([half.variable], [one]), 1,
                                  [bit.variable], [self.variable])
        return half

    def low_u16(self, table_ids: dict = None) -> "UInt16":
        """Low 16 bits (u32/mod.rs:713)."""
        return self.decompose_into_uint16(table_ids)[0]

    def decompose_into_uint16(self, table_ids: dict = None) -> list:
        """(low16, high16) with recomposition enforced (u32/mod.rs:718)."""
        cs = self.cs
        sv = self.get_witness() if cs.resolver else 0
        lo = UInt16.allocate_checked(cs, sv & 0xFFFF, table_ids)
        hi = UInt16.allocate_checked(cs, sv >> 16, table_ids)
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        FmaGate.enforce_fma_batch(cs, 1 << 16, ([hi.variable], [one]), 1,
                                  [lo.variable], [self.variable])
        return [lo, hi]


@dataclass(frozen=True)
class UInt64:
    """Two u32 limbs (values up to 2^64-1 exceed the field; reference
    u64 gadgets are limb pairs)."""

    low: UInt32
    high: UInt32

    @staticmethod
    def allocate_checked(cs, value: int, table_ids: dict = None):
        return UInt64(UInt32.allocate_checked(cs, value & 0xFFFFFFFF, table_ids),
                      UInt32.allocate_checked(cs, (value >> 32) & 0xFFFFFFFF,
                                              table_ids))

    @staticmethod
    def allocate_constant(cs, value: int):
        return UInt64(UInt32.allocate_constant(cs, value & 0xFFFFFFFF),
                      UInt32.allocate_constant(cs, (value >> 32) & 0xFFFFFFFF))

    def get_witness(self) -> int:
        return self.low.get_witness() | (self.high.get_witness() << 32)

    # -- reference-parity API (src/gadgets/u64/mod.rs) ------------------------

    def add(self, other: "UInt64"):
        """Ripple-carry add over the two u32 limbs; returns
        (result, overflow Boolean) (u64 overflowing_add)."""
        from ..cs.gates.arith import U32AddGate
        cs = self.low.cs
        lo, c = U32AddGate.add_batch(cs, [self.low.variable],
                                     [other.low.variable])
        hi, c2 = U32AddGate.add_batch(cs, [self.high.variable],
                                      [other.high.variable], [int(c[0])])
        return (UInt64(UInt32(cs, int(lo[0])), UInt32(cs, int(hi[0]))),
                Boolean(cs, int(c2[0])))

    def sub(self, other: "UInt64"):
        """Ripple-borrow sub; returns (result, borrow Boolean)."""
        from ..cs.gates.arith import U32SubGate
        cs = self.low.cs
        lo, b = U32SubGate.sub_batch(cs, [self.low.variable],
                                     [other.low.variable])
        hi, b2 = U32SubGate.sub_batch(cs, [self.high.variable],
                                      [other.high.variable], [int(b[0])])
        return (UInt64(UInt32(cs, int(lo[0])), UInt32(cs, int(hi[0]))),
                Boolean(cs, int(b2[0])))

    overflowing_add = add
    overflowing_sub = sub

    def select(self, flag: "Boolean", other: "UInt64") -> "UInt64":
        return UInt64(self.low.select(flag, other.low),
                      self.high.select(flag, other.high))

    def equals(self, other: "UInt64") -> "Boolean":
        return self.low.equals(other.low).and_(self.high.equals(other.high))

    def is_zero(self) -> "Boolean":
        # low + high ≤ 2·(2^32−1) < p, so the sum is zero iff both are
        from .num import CircuitOps
        s = CircuitOps(self.low.cs).add(self.low.variable, self.high.variable)
        return Num(self.low.cs, s).is_zero()

    def mask(self, flag: "Boolean") -> "UInt64":
        return UInt64(self.low.mask(flag), self.high.mask(flag))

    def to_le_bytes(self, table_ids: dict = None) -> list:
        return (self.low.to_le_bytes(table_ids)
                + self.high.to_le_bytes(table_ids))

    @staticmethod
    def from_le_bytes(cs, bytes_u8: list, table_ids: dict = None) -> "UInt64":
        assert len(bytes_u8) == 8
        return UInt64(UInt32.from_le_bytes(cs, bytes_u8[:4], table_ids),
                      UInt32.from_le_bytes(cs, bytes_u8[4:], table_ids))


class _MultiLimbUInt:
    """Wide unsigned ints as little-endian u32-limb vectors (reference
    src/gadgets/u160 u256 u512 — limbed big-uints with ripple-carry
    add/sub via U32Add/U32Sub gates and limbwise select)."""

    NUM_LIMBS = 0

    def __init__(self, cs: ConstraintSystem, limbs: list):
        assert len(limbs) == self.NUM_LIMBS
        self.cs = cs
        self.limbs = limbs  # list[UInt32]

    @classmethod
    def allocate_checked(cls, cs, value: int, table_ids: dict = None):
        limbs = [UInt32.allocate_checked(cs, (value >> (32 * i)) & 0xFFFFFFFF,
                                         table_ids)
                 for i in range(cls.NUM_LIMBS)]
        return cls(cs, limbs)

    @classmethod
    def allocate_constant(cls, cs, value: int):
        return cls(cs, [UInt32.allocate_constant(
            cs, (value >> (32 * i)) & 0xFFFFFFFF)
            for i in range(cls.NUM_LIMBS)])

    @classmethod
    def zero(cls, cs):
        return cls.allocate_constant(cs, 0)

    def add(self, other):
        """Ripple-carry add; returns (result, overflow Boolean)."""
        from ..cs.gates.arith import U32AddGate
        cs = self.cs
        out = []
        carry = None
        for a, b in zip(self.limbs, other.limbs):
            cvars, couts = U32AddGate.add_batch(
                cs, [a.variable], [b.variable],
                None if carry is None else [carry])
            out.append(UInt32(cs, int(cvars[0])))
            carry = int(couts[0])
        return type(self)(cs, out), Boolean(cs, carry)

    def sub(self, other):
        """Ripple-borrow sub; returns (result, borrow Boolean)."""
        from ..cs.gates.arith import U32SubGate
        cs = self.cs
        out = []
        borrow = None
        for a, b in zip(self.limbs, other.limbs):
            cvars, bouts = U32SubGate.sub_batch(
                cs, [a.variable], [b.variable],
                None if borrow is None else [borrow])
            out.append(UInt32(cs, int(cvars[0])))
            borrow = int(bouts[0])
        return type(self)(cs, out), Boolean(cs, borrow)

    def select(self, flag: "Boolean", other):
        """self if flag else other, limbwise."""
        from ..cs.gates import SelectionGate
        cs = self.cs
        a = [l.variable for l in self.limbs]
        b = [l.variable for l in other.limbs]
        sel = SelectionGate.select_batch(
            cs, np.asarray(a, np.uint64), np.asarray(b, np.uint64),
            np.full(self.NUM_LIMBS, flag.variable, np.uint64))
        return type(self)(cs, [UInt32(cs, int(v)) for v in sel])

    def is_zero(self) -> "Boolean":
        from .num import CircuitOps
        ops = CircuitOps(self.cs)
        acc = None
        for l in self.limbs:
            acc = l.variable if acc is None else \
                ops.add(acc, l.variable)  # sum < p for <= 16 limbs
        flag = Num(self.cs, acc).is_zero()
        return flag

    def get_witness(self) -> int:
        return sum(l.get_witness() << (32 * i)
                   for i, l in enumerate(self.limbs))

    def equals(self, other) -> "Boolean":
        diff, _ = self.sub(other)
        return diff.is_zero()

    def mask(self, flag: "Boolean"):
        """self if flag else 0 (reference u256 mask)."""
        return self.select(flag, type(self).zero(self.cs))

    def mask_negated(self, flag: "Boolean"):
        return type(self).zero(self.cs).select(flag, self)

    def is_odd(self, table_ids: dict = None) -> "Boolean":
        """Lowest bit (reference u256 is_odd: low limb parity)."""
        cs = self.cs
        low = self.limbs[0].variable
        bit = cs.alloc_variable()
        half = cs.alloc_variable()

        def fn(vals):
            return np.stack([vals[0] & np.uint64(1), vals[0] >> np.uint64(1)])

        cs.set_values_with_dependencies(
            np.asarray([[low]], np.uint64),
            np.asarray([bit, half], np.uint64), fn)
        from ..cs.gates import BooleanConstraintGate
        BooleanConstraintGate.enforce_batch(cs, [bit])
        UInt32(cs, half).enforce_range(table_ids)  # half < 2^32 (31 bits used)
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        FmaGate.enforce_fma_batch(cs, 2, ([one], [half]), 1, [bit], [low])
        return Boolean(cs, bit)

    def widening_mul(self, other, table_ids: dict = None) -> "UInt512":
        """Full product (reference u256 widening_mul, u256/mod.rs:218):
        byte-limbed schoolbook over the U8x4FMA gate — the same
        fma-with-carry chain as the reference, batched per diagonal."""
        from ..cs.gates.arith import U8x4FMAGate
        cs = self.cs
        sl, ol = self.NUM_LIMBS, other.NUM_LIMBS
        assert sl + ol <= 16
        a_bytes = [l.to_bytes(table_ids) for l in self.limbs]
        b_bytes = [l.to_bytes(table_ids) for l in other.limbs]
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        zero4 = [zero] * 4
        rem = [list(zero4) for _ in range(sl + ol)]  # byte quads
        for i in range(sl):
            carry = list(zero4)
            for j in range(ol):
                low4, high4, pc2 = U8x4FMAGate.perform_fma_batch(
                    cs, [a_bytes[i]], [b_bytes[j]],
                    [zero4 if i == 0 else rem[i + j]], [carry])
                low4 = [int(v) for v in low4[0]]
                high4 = [int(v) for v in high4[0]]
                byte_range_check(cs, low4 + high4 + [int(pc2[0, 0]),
                                                     int(pc2[0, 1])],
                                 table_ids)
                rem[i + j] = low4
                carry = high4
            rem[i + ol] = carry
        out_limbs = []
        for quad in rem:
            acc = ReductionGate.reduce_terms(
                cs, [1, 1 << 8, 1 << 16, 1 << 24], quad)
            out_limbs.append(UInt32(cs, acc))
        out_limbs += [UInt32.allocate_constant(cs, 0)
                      for _ in range(16 - sl - ol)]
        return UInt512(cs, out_limbs)

    # -- reference-parity views (u256/mod.rs, u512/mod.rs) --------------------

    def decompose_into_u32_limbs(self) -> list:
        """LSB-first UInt32 limbs (reference decompose_u256_as_u32x8 /
        decompose_u512_as_u32x16 — our representation IS the limb vector)."""
        return list(self.limbs)

    @classmethod
    def from_u32_limbs(cls, cs, limbs: list):
        """Reference recompose_u256_as_u32x8 / recompose_u512_as_u32x16."""
        assert len(limbs) == cls.NUM_LIMBS
        return cls(cs, list(limbs))

    def to_le_bytes(self, table_ids: dict = None) -> list:
        """LSB-first UInt8 views of every limb (reference to_le_bytes)."""
        out = []
        for l in self.limbs:
            out.extend(UInt8(self.cs, b) for b in l.to_bytes(table_ids))
        return out

    def to_be_bytes(self, table_ids: dict = None) -> list:
        return list(reversed(self.to_le_bytes(table_ids)))

    @classmethod
    def from_le_bytes(cls, cs, bytes_u8: list, table_ids: dict = None):
        """Recompose from 4·NUM_LIMBS range-checked bytes."""
        assert len(bytes_u8) == 4 * cls.NUM_LIMBS
        limbs = [UInt32.from_le_bytes(cs, bytes_u8[4 * i:4 * i + 4], table_ids)
                 for i in range(cls.NUM_LIMBS)]
        return cls(cs, limbs)

    @classmethod
    def from_be_bytes(cls, cs, bytes_u8: list, table_ids: dict = None):
        return cls.from_le_bytes(cs, list(reversed(bytes_u8)), table_ids)

    def div_rem(self, other, table_ids: dict = None):
        """Euclidean division: returns (q, r) with self = q·other + r,
        r < other, both range-checked. (No reference analogue — its u256 has
        only widening_mul; provided for parity with VERDICT item 8.)"""
        cs = self.cs
        a = self.get_witness() if cs.resolver else 0
        b = other.get_witness() if cs.resolver else 1
        qv, rv = divmod(a, b) if b else (0, 0)
        q = type(self).allocate_checked(cs, qv, table_ids)
        r = type(self).allocate_checked(cs, rv, table_ids)
        wide = q.widening_mul(other, table_ids)
        r_ext = UInt512(cs, list(r.limbs) + [UInt32.allocate_constant(cs, 0)
                                             for _ in range(16 - self.NUM_LIMBS)])
        total, carry = wide.add(r_ext)
        from .num import CircuitOps
        ops = CircuitOps(cs)
        ops.enforce_equal(carry.variable, ops.from_int(0))
        for k, l in enumerate(total.limbs):
            want = self.limbs[k].variable if k < self.NUM_LIMBS \
                else ops.from_int(0)
            ops.enforce_equal(l.variable, want)
        # r < other: r - other must borrow
        _, borrow = r.sub(other)
        ops.enforce_equal(borrow.variable, ops.from_int(1))
        return q, r


class UInt160(_MultiLimbUInt):
    NUM_LIMBS = 5


class UInt256(_MultiLimbUInt):
    NUM_LIMBS = 8

    def div2(self, table_ids: dict = None) -> "UInt256":
        """Shift right by one (reference u256 div2)."""
        cs = self.cs
        v = self.get_witness() if cs.resolver else 0
        half = UInt256.allocate_checked(cs, v >> 1, table_ids)
        bit = self.is_odd(table_ids)
        # self == 2·half + bit, limbwise via doubling add with carries
        dbl, top = half.add(half)
        from .num import CircuitOps
        ops = CircuitOps(cs)
        ops.enforce_equal(top.variable, ops.from_int(0))
        # limb 0 of 2·half is even, so adding the parity bit cannot carry
        s = ops.add(dbl.limbs[0].variable, bit.variable)
        ops.enforce_equal(s, self.limbs[0].variable)
        for k in range(1, self.NUM_LIMBS):
            ops.enforce_equal(dbl.limbs[k].variable, self.limbs[k].variable)
        return half


class UInt512(_MultiLimbUInt):
    NUM_LIMBS = 16

    def to_low(self) -> "UInt256":
        """Low 256 bits (u512/mod.rs to_low)."""
        return UInt256(self.cs, list(self.limbs[:8]))

    def to_high(self) -> "UInt256":
        """High 256 bits (u512/mod.rs to_high)."""
        return UInt256(self.cs, list(self.limbs[8:]))
