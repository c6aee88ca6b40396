# Copied from boojum_tpu/gadgets/non_native.py.
"""Non-native field emulation over 16-bit limbs.

Reference behavior: src/gadgets/non_native_field/implementations/
implementation_u16.rs — foreign-modulus (e.g. BN254 base field) arithmetic
with u16 limbs. Multiplication is checked via the witness identity
a·b = q·M + r evaluated limb-column-wise with carry propagation:

  for every limb column k:  Σ_{i+j=k} (aᵢ·bⱼ − qᵢ·Mⱼ) − rₖ + carry_{k-1}
                            = carry_k · 2^16,

with every aᵢ/bᵢ/qᵢ/rᵢ 16-bit range-checked (RangeCheck16 table when
available, else bit decomposition) and carries bounded. All limb sums stay
far below the Goldilocks modulus (≤ 2L·(2^16)² + carry ≈ 2^38), so the
column equations are exact field equations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cs.cs import ConstraintSystem
from ..cs.gates import ConstantsAllocatorGate, FmaGate, ReductionGate
from ..utils import npgl

P = npgl.ORDER
LIMB = 16
BASE = 1 << LIMB


@dataclass
class NonNativeParams:
    modulus: int
    num_limbs: int

    @staticmethod
    def for_modulus(m: int) -> "NonNativeParams":
        L = (m.bit_length() + LIMB - 1) // LIMB
        return NonNativeParams(m, L)

    def limbs_of(self, x: int) -> list:
        return [(x >> (LIMB * i)) & (BASE - 1) for i in range(self.num_limbs)]


class NonNativeField:
    """A foreign-field element as num_limbs 16-bit limb variables."""

    def __init__(self, cs: ConstraintSystem, params: NonNativeParams,
                 limbs: list, table_ids: dict = None):
        self.cs = cs
        self.params = params
        self.limbs = limbs  # variable handles, LSB first
        self.table_ids = table_ids

    # -- allocation -----------------------------------------------------------

    @classmethod
    def allocate_checked(cls, cs, params: NonNativeParams, value: int,
                         table_ids: dict = None) -> "NonNativeField":
        value %= params.modulus
        limbs = [cs.alloc_variable_with_value(l)
                 for l in params.limbs_of(value)]
        out = cls(cs, params, limbs, table_ids)
        out._range_check(limbs)
        return out

    @classmethod
    def constant(cls, cs, params: NonNativeParams, value: int,
                 table_ids: dict = None) -> "NonNativeField":
        value %= params.modulus
        limbs = [ConstantsAllocatorGate.allocate_constant(cs, l)
                 for l in params.limbs_of(value)]
        return cls(cs, params, limbs, table_ids)

    def _range_check(self, limb_vars: list, bits: int = LIMB):
        cs = self.cs
        if self.table_ids and "range16" in self.table_ids:
            for v in limb_vars:
                cs.enforce_lookup(self.table_ids["range16"], [v])
        else:
            from .num import CircuitOps
            from .recursion.primitives import decompose_bits
            ops = CircuitOps(cs)
            for v in limb_vars:
                decompose_bits(cs, ops, v, bits, enforce_canonical=False)

    def get_witness(self) -> int:
        return sum(self.cs.get_value(l) << (LIMB * i)
                   for i, l in enumerate(self.limbs))

    # -- arithmetic -----------------------------------------------------------

    def _mod_reduce_witness(self, wide_value_fn, num_q_limbs: int):
        """Allocate q, r for value = q·M + r given host big-int value."""
        cs = self.cs
        params = self.params
        value = wide_value_fn()
        q, r = divmod(value, params.modulus)
        q_limbs = [cs.alloc_variable_with_value((q >> (LIMB * i)) & (BASE - 1))
                   for i in range(num_q_limbs)]
        r_limbs = [cs.alloc_variable_with_value(l)
                   for l in params.limbs_of(r)]
        self._range_check(q_limbs)
        self._range_check(r_limbs)
        return q_limbs, r_limbs

    def _column_chain(self, columns_terms, columns_host, carry_bits: int,
                      offset_pow: int):
        """Enforce the signed-carry column chain:
          terms_k + (c_off_{k-1} - 2^cb) + OFF == c_off_k · 2^16,
        with OFF = 2^offset_pow - 2^carry_bits making every column
        non-negative; c_off_k range-checked to (offset_pow - 16 + 1) bits.
        columns_terms: per column, list of (coeff, var) pairs;
        columns_host: per column, exact signed host value of the terms."""
        cs = self.cs
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
        cb = carry_bits
        OFF = (1 << offset_pow) - (1 << cb)
        c_off_prev = None
        carry_host = 0
        c_off_bits = offset_pow - LIMB + 1
        for k, (terms, host_val) in enumerate(zip(columns_terms, columns_host)):
            pairs = list(terms)
            if c_off_prev is not None:
                pairs.append((1, c_off_prev))
            pairs.append((OFF if c_off_prev is not None
                          else OFF + (1 << cb), one))
            # fold pairs via reduction chains
            acc = zero
            while pairs:
                group = pairs[:3]
                pairs = pairs[3:]
                coeffs = [1] + [c % P for (c, _) in group]
                vars_ = [acc] + [v for (_, v) in group]
                while len(vars_) < 4:
                    vars_.append(zero)
                    coeffs.append(0)
                acc = ReductionGate.reduce_terms(cs, coeffs, vars_)
            if cs.resolver:
                col = host_val + carry_host
                assert col % BASE == 0, "non-native column identity broken"
                carry_host = col >> LIMB  # exact (col divisible), signed
                assert abs(carry_host) < (1 << cb)
            c_off = cs.alloc_variable_with_value((carry_host + (1 << cb)) % P)
            FmaGate.enforce_fma_batch(cs, BASE, ([one], [c_off]), 0, [zero],
                                      [acc])
            self._range_check([c_off], bits=c_off_bits)
            c_off_prev = c_off
        # final signed carry must be zero: c_off == 2^cb
        from .num import CircuitOps
        ops = CircuitOps(cs)
        ops.enforce_equal(c_off_prev, ops.from_int(1 << cb))

    def mul(self, other: "NonNativeField") -> "NonNativeField":
        cs = self.cs
        params = self.params
        L = params.num_limbs
        M_limbs = params.limbs_of(params.modulus)
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)

        q_limbs, r_limbs = self._mod_reduce_witness(
            lambda: self.get_witness() * other.get_witness(), L)

        a_val = [cs.get_value(l) for l in self.limbs] if cs.resolver else [0] * L
        b_val = [cs.get_value(l) for l in other.limbs] if cs.resolver else [0] * L
        q_val = [cs.get_value(l) for l in q_limbs] if cs.resolver else [0] * L
        r_val = [cs.get_value(l) for l in r_limbs] if cs.resolver else [0] * L

        columns = []
        hosts = []
        for k in range(2 * L - 1):
            terms = []
            host = 0
            for i in range(max(0, k - L + 1), min(k + 1, L)):
                j = k - i
                prod = FmaGate.compute_fma(cs, 1,
                                           (self.limbs[i], other.limbs[j]),
                                           0, one)
                terms.append((1, prod))
                host += a_val[i] * b_val[j]
                if M_limbs[j]:
                    terms.append((P - M_limbs[j], q_limbs[i]))
                    host -= q_val[i] * M_limbs[j]
            if k < L:
                terms.append((P - 1, r_limbs[k]))
                host -= r_val[k]
            columns.append(terms)
            hosts.append(host)
        # max column magnitude ~ L·2^32 < 2^37 -> offset 2^38, carry bits 22
        self._column_chain(columns, hosts, carry_bits=22, offset_pow=38)
        return NonNativeField(cs, params, r_limbs, self.table_ids)

    def add(self, other: "NonNativeField") -> "NonNativeField":
        cs = self.cs
        params = self.params
        L = params.num_limbs
        M_limbs = params.limbs_of(params.modulus)
        q_limbs, r_limbs = self._mod_reduce_witness(
            lambda: self.get_witness() + other.get_witness(), 1)
        a_val = [cs.get_value(l) for l in self.limbs] if cs.resolver else [0] * L
        b_val = [cs.get_value(l) for l in other.limbs] if cs.resolver else [0] * L
        q0 = cs.get_value(q_limbs[0]) if cs.resolver else 0
        r_val = [cs.get_value(l) for l in r_limbs] if cs.resolver else [0] * L

        columns = []
        hosts = []
        for k in range(L):
            terms = [(1, self.limbs[k]), (1, other.limbs[k]),
                     (P - 1, r_limbs[k])]
            host = a_val[k] + b_val[k] - r_val[k]
            if M_limbs[k]:
                terms.append((P - M_limbs[k], q_limbs[0]))
                host -= q0 * M_limbs[k]
            columns.append(terms)
            hosts.append(host)
        self._column_chain(columns, hosts, carry_bits=4, offset_pow=20)
        return NonNativeField(cs, params, r_limbs, self.table_ids)

    def sub(self, other: "NonNativeField") -> "NonNativeField":
        """a − b mod M via a + (2M − b) with a two-limb quotient
        (reference implementation_u16.rs sub: add the shifted modulus)."""
        cs = self.cs
        params = self.params
        L = params.num_limbs
        M2 = 2 * params.modulus
        M2_limbs = [(M2 >> (LIMB * i)) & (BASE - 1) for i in range(L + 1)]
        M_limbs = params.limbs_of(params.modulus)
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        q_limbs, r_limbs = self._mod_reduce_witness(
            lambda: self.get_witness() + M2 - other.get_witness(), 1)
        a_val = [cs.get_value(l) for l in self.limbs] if cs.resolver else [0] * L
        b_val = [cs.get_value(l) for l in other.limbs] if cs.resolver else [0] * L
        q0 = cs.get_value(q_limbs[0]) if cs.resolver else 0
        r_val = [cs.get_value(l) for l in r_limbs] if cs.resolver else [0] * L

        columns = []
        hosts = []
        for k in range(L + 1):
            terms = []
            host = 0
            if k < L:
                terms += [(1, self.limbs[k]), (P - 1, other.limbs[k]),
                          (P - 1, r_limbs[k])]
                host += a_val[k] - b_val[k] - r_val[k]
            if M2_limbs[k]:
                terms.append((M2_limbs[k], one))
                host += M2_limbs[k]
            Mk = M_limbs[k] if k < L else (params.modulus >> (LIMB * L))
            if Mk:
                terms.append((P - Mk, q_limbs[0]))
                host -= q0 * Mk
            columns.append(terms)
            hosts.append(host)
        self._column_chain(columns, hosts, carry_bits=5, offset_pow=21)
        return NonNativeField(cs, params, r_limbs, self.table_ids)

    def neg(self) -> "NonNativeField":
        zero = NonNativeField.constant(self.cs, self.params, 0, self.table_ids)
        return zero.sub(self)

    def _enforce_mul(self, other: "NonNativeField",
                     result: "NonNativeField"):
        """Enforce self · other ≡ result (mod M) with ``result`` being
        EXISTING limb variables (shared column-chain core of mul/div)."""
        cs = self.cs
        params = self.params
        L = params.num_limbs
        M_limbs = params.limbs_of(params.modulus)
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        wide = (self.get_witness() * other.get_witness()
                - result.get_witness()) if cs.resolver else 0
        assert wide % params.modulus == 0 or not cs.resolver
        q = wide // params.modulus if cs.resolver else 0
        q_limbs = [cs.alloc_variable_with_value((q >> (LIMB * i)) & (BASE - 1))
                   for i in range(L)]
        self._range_check(q_limbs)
        r_limbs = result.limbs

        a_val = [cs.get_value(l) for l in self.limbs] if cs.resolver else [0] * L
        b_val = [cs.get_value(l) for l in other.limbs] if cs.resolver else [0] * L
        q_val = [cs.get_value(l) for l in q_limbs] if cs.resolver else [0] * L
        r_val = [cs.get_value(l) for l in r_limbs] if cs.resolver else [0] * L

        columns = []
        hosts = []
        for k in range(2 * L - 1):
            terms = []
            host = 0
            for i in range(max(0, k - L + 1), min(k + 1, L)):
                j = k - i
                prod = FmaGate.compute_fma(cs, 1,
                                           (self.limbs[i], other.limbs[j]),
                                           0, one)
                terms.append((1, prod))
                host += a_val[i] * b_val[j]
                if M_limbs[j]:
                    terms.append((P - M_limbs[j], q_limbs[i]))
                    host -= q_val[i] * M_limbs[j]
            if k < L:
                terms.append((P - 1, r_limbs[k]))
                host -= r_val[k]
            columns.append(terms)
            hosts.append(host)
        self._column_chain(columns, hosts, carry_bits=22, offset_pow=38)

    def div(self, other: "NonNativeField") -> "NonNativeField":
        """self / other mod M: witness c = self·other⁻¹, then enforce
        other · c == self. ``other`` must be invertible mod M."""
        cs = self.cs
        params = self.params
        if cs.resolver:
            b = other.get_witness() % params.modulus
            inv = pow(b, -1, params.modulus)
            c_val = self.get_witness() * inv % params.modulus
        else:
            c_val = 0
        c = NonNativeField.allocate_checked(cs, params, c_val, self.table_ids)
        other._enforce_mul(c, self)
        return c

    def inverse(self) -> "NonNativeField":
        one = NonNativeField.constant(self.cs, self.params, 1, self.table_ids)
        return one.div(self)

    def enforce_canonical(self):
        """Enforce value < M (the reference's normalization end state): a
        borrow-free witness d with d + value == M − 1 limb-wise."""
        cs = self.cs
        params = self.params
        L = params.num_limbs
        one = ConstantsAllocatorGate.allocate_constant(cs, 1)
        Mm1_limbs = [((params.modulus - 1) >> (LIMB * i)) & (BASE - 1)
                     for i in range(L)]
        d_val = params.modulus - 1 - self.get_witness() if cs.resolver else 0
        assert d_val >= 0 or not cs.resolver, "value not canonical"
        d_limbs = [cs.alloc_variable_with_value((d_val >> (LIMB * i))
                                                & (BASE - 1))
                   for i in range(L)]
        self._range_check(d_limbs)
        r_val = [cs.get_value(l) for l in self.limbs] if cs.resolver else [0] * L
        dv = [cs.get_value(l) for l in d_limbs] if cs.resolver else [0] * L
        columns = []
        hosts = []
        for k in range(L):
            terms = [(1, self.limbs[k]), (1, d_limbs[k])]
            host = r_val[k] + dv[k] - Mm1_limbs[k]
            terms.append((P - Mm1_limbs[k], one) if Mm1_limbs[k]
                         else (0, one))
            columns.append(terms)
            hosts.append(host)
        self._column_chain(columns, hosts, carry_bits=2, offset_pow=18)

    def equals_canonical(self, other: "NonNativeField"):
        """Enforce equality as field elements: canonicalize both, then
        limbwise equality."""
        from .num import CircuitOps
        self.enforce_canonical()
        other.enforce_canonical()
        ops = CircuitOps(self.cs)
        for a, b in zip(self.limbs, other.limbs):
            ops.enforce_equal(a, b)

    # -- reference-parity helpers (implementation_u16.rs) ---------------------

    def double(self) -> "NonNativeField":
        """implementation_u16.rs double/lazy_double."""
        return self.add(self)

    def square(self) -> "NonNativeField":
        return self.mul(self)

    def negated(self) -> "NonNativeField":
        return self.neg()

    def normalize(self) -> "NonNativeField":
        """Return the canonical representative (< M) of self, with
        self ≡ r (mod M) enforced (implementation_u16.rs normalize)."""
        cs = self.cs
        r_val = self.get_witness() % self.params.modulus if cs.resolver else 0
        r = NonNativeField.allocate_checked(cs, self.params, r_val,
                                            self.table_ids)
        one = NonNativeField.constant(cs, self.params, 1, self.table_ids)
        self._enforce_mul(one, r)
        r.enforce_canonical()
        return r

    def is_zero(self) -> int:
        """Boolean variable: value ≡ 0 (mod M). Normalizes first; the
        canonical limbs sum to zero iff all are zero (sum ≪ p)."""
        from ..cs.gates import ZeroCheckGate
        from .num import CircuitOps
        r = self.normalize()
        ops = CircuitOps(self.cs)
        acc = r.limbs[0]
        for l in r.limbs[1:]:
            acc = ops.add(acc, l)
        flag = ZeroCheckGate.is_zero_batch(self.cs, [acc])
        return int(flag[0])

    def mask(self, flag_var) -> "NonNativeField":
        """flag ? self : 0 (implementation_u16.rs mask)."""
        zero = NonNativeField.constant(self.cs, self.params, 0, self.table_ids)
        return NonNativeField.select(flag_var, self, zero)

    def mask_negated(self, flag_var) -> "NonNativeField":
        zero = NonNativeField.constant(self.cs, self.params, 0, self.table_ids)
        return NonNativeField.select(flag_var, zero, self)

    def allocate_inverse_or_zero(self) -> "NonNativeField":
        """inv(self) when invertible else 0, with self·inv == (is_zero ? 0:1)
        enforced (implementation_u16.rs allocate_inverse_or_zero)."""
        cs = self.cs
        M = self.params.modulus
        if cs.resolver:
            v = self.get_witness() % M
            inv_val = pow(v, -1, M) if v else 0
        else:
            inv_val = 0
        inv = NonNativeField.allocate_checked(cs, self.params, inv_val,
                                              self.table_ids)
        z = self.is_zero()
        one = NonNativeField.constant(cs, self.params, 1, self.table_ids)
        zero = NonNativeField.constant(cs, self.params, 0, self.table_ids)
        rhs = NonNativeField.select(z, zero, one)
        self._enforce_mul(inv, rhs)
        return inv

    @staticmethod
    def select(flag_var, a: "NonNativeField", b: "NonNativeField"):
        """flag ? a : b, limbwise (SelectionGate)."""
        from ..cs.gates import SelectionGate
        cs = a.cs
        sel = SelectionGate.select_batch(
            cs, np.asarray(a.limbs, np.uint64), np.asarray(b.limbs, np.uint64),
            np.full(len(a.limbs), flag_var, np.uint64))
        return NonNativeField(cs, a.params, [int(v) for v in sel], a.table_ids)


class NonNativeFieldLazy:
    """Unreduced non-native element: per-limb SYMBOLIC term lists.

    Reference behavior: implementation_u16.rs ``lazy_add`` /
    ``add_many_lazy`` / ``lazy_double`` — additions cost ZERO constraints
    (they only extend the term lists and the tracked limb bound); one
    ``normalize()`` pays a single q·M + r column chain for the whole
    accumulated sum. ECC-style chains (many adds per mul) synthesize far
    fewer rows this way, matching the reference's trace layout philosophy.
    """

    def __init__(self, cs, params: NonNativeParams, limb_terms, limb_hosts,
                 max_limb: int, table_ids=None):
        self.cs = cs
        self.params = params
        #: per limb: list of (small-int coeff, variable) pairs
        self.limb_terms = limb_terms
        #: per limb: exact host value of the terms (ints; 0 without resolver)
        self.limb_hosts = limb_hosts
        #: bound: every limb's host value is <= max_limb
        self.max_limb = max_limb
        self.table_ids = table_ids

    @classmethod
    def from_reduced(cls, nn: NonNativeField) -> "NonNativeFieldLazy":
        cs = nn.cs
        hosts = [cs.get_value(l) if cs.resolver else 0 for l in nn.limbs]
        return cls(cs, nn.params, [[(1, l)] for l in nn.limbs], hosts,
                   BASE - 1, nn.table_ids)

    @staticmethod
    def _coerce(x) -> "NonNativeFieldLazy":
        if isinstance(x, NonNativeFieldLazy):
            return x
        return NonNativeFieldLazy.from_reduced(x)

    def lazy_add(self, other) -> "NonNativeFieldLazy":
        o = self._coerce(other)
        terms = [a + b for a, b in zip(self.limb_terms, o.limb_terms)]
        hosts = [a + b for a, b in zip(self.limb_hosts, o.limb_hosts)]
        return NonNativeFieldLazy(self.cs, self.params, terms, hosts,
                                  self.max_limb + o.max_limb, self.table_ids)

    def lazy_double(self) -> "NonNativeFieldLazy":
        terms = [[(2 * c, v) for (c, v) in lt] for lt in self.limb_terms]
        return NonNativeFieldLazy(self.cs, self.params, terms,
                                  [2 * h for h in self.limb_hosts],
                                  2 * self.max_limb, self.table_ids)

    @classmethod
    def add_many_lazy(cls, elems) -> "NonNativeFieldLazy":
        acc = cls._coerce(elems[0])
        for e in elems[1:]:
            acc = acc.lazy_add(e)
        return acc

    def get_witness(self) -> int:
        """Exact UNREDUCED host integer value."""
        return sum(h << (LIMB * i) for i, h in enumerate(self.limb_hosts))

    def normalize(self) -> NonNativeField:
        """Materialize as a reduced NonNativeField: ONE q·M + r column
        chain over the accumulated terms (the whole point of laziness)."""
        cs = self.cs
        params = self.params
        L = params.num_limbs
        M = params.modulus
        M_limbs = params.limbs_of(M)

        value_max = sum(self.max_limb << (LIMB * i) for i in range(L))
        q_bits = max(value_max.bit_length() - M.bit_length() + 1, 1)
        n_q = -(-q_bits // LIMB)
        value = self.get_witness() if cs.resolver else 0
        q, r = divmod(value, M)
        q_limbs = [cs.alloc_variable_with_value((q >> (LIMB * i)) & (BASE - 1))
                   for i in range(n_q)]
        r_limbs = [cs.alloc_variable_with_value(l) for l in params.limbs_of(r)]
        helper = NonNativeField(cs, params, r_limbs, self.table_ids)
        helper._range_check(q_limbs)
        helper._range_check(r_limbs)
        q_val = [cs.get_value(l) for l in q_limbs] if cs.resolver else [0] * n_q
        r_val = [cs.get_value(l) for l in r_limbs] if cs.resolver else [0] * L

        n_cols = max(L, n_q + L - 1)
        columns, hosts = [], []
        max_col = 0
        for k in range(n_cols):
            terms = []
            host = 0
            col_bound = 0
            if k < L:
                terms.extend((c % P, v) for (c, v) in self.limb_terms[k])
                host += self.limb_hosts[k]
                col_bound += self.max_limb
                terms.append((P - 1, r_limbs[k]))
                host -= r_val[k]
            for i in range(max(0, k - L + 1), min(k + 1, n_q)):
                Mj = M_limbs[k - i]
                if Mj:
                    terms.append((P - Mj, q_limbs[i]))
                    host -= q_val[i] * Mj
                    col_bound += Mj * (BASE - 1)
            columns.append(terms)
            hosts.append(host)
            max_col = max(max_col, col_bound)
        offset_pow = max_col.bit_length() + 2
        helper._column_chain(columns, hosts, carry_bits=offset_pow - LIMB,
                             offset_pow=offset_pow)
        return helper
