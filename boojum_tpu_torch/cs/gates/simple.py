# Copied from boojum_tpu/cs/gates/simple.py; FmaGate's device twin runs on torch.
"""The basic gate set.

Reference behavior (src/cs/gates/): fma_gate_without_constant.rs (c0·A·B +
c1·C → D, :138), reduction_gate.rs (Σ cᵢ·tᵢ → r), constant_allocator.rs
(var = const, dedup tool), nop_gate.rs, public_input.rs,
boolean_allocator.rs (a²=a), selection_gate.rs, parallel_selection_gate.rs,
conditional_swap_gate.rs, dot_product_gate.rs, quadratic_combination.rs,
reduction_by_powers_gate.rs, zero_check.rs.

Each gate provides:
- ``make_evaluator()`` — the relation metadata + ``evaluate`` body (runs in
  every ops domain, see gates/base.py),
- batched gadget entry points registering vectorized witness resolutions and
  placing instances through the CS's batched placement.
"""

from __future__ import annotations

import numpy as np

from ...utils import npgl
from .base import GateEvaluator


# ---------------------------------------------------------------------------
# NOP / PublicInput markers
# ---------------------------------------------------------------------------


class NopEvaluator(GateEvaluator):
    name = "nop"
    needs_selector = True
    num_quotient_terms = 0

    def num_repetitions(self, geometry):
        return 1

    def evaluate(self, src, ops):
        return []


class LookupMarkerEvaluator(GateEvaluator):
    """LookupFormalGate marker for GENERAL-PURPOSE lookups (reference
    src/cs/gates/lookup_marker.rs:39 LookupGateMarkerFormalEvaluator).

    Occupies general rows whose copy columns hold lookup chunks; contributes
    no gate quotient terms itself — the lookup argument's A-poly relations
    reference this gate's selector-tree path product. The selector tree gives
    it degree max(depth, 2) (GateDescription.is_lookup in cs/setup.py).
    """

    name = "lookup_formal"
    needs_selector = True
    num_quotient_terms = 0
    max_constraint_degree = 1

    def __init__(self, cps: int, id_in_constant: bool):
        self.num_variables = cps  # principal width: width (+1 id-as-variable)
        self.num_constants = 1 if id_in_constant else 0

    def num_repetitions(self, geometry):
        return geometry.num_columns_under_copy_permutation // self.num_variables

    def num_required_constants(self, geometry):
        return self.num_constants

    def evaluate(self, src, ops):
        return []

    def spec_params(self):
        return (self.num_variables, self.num_constants)


class NopGate:
    @staticmethod
    def make_evaluator():
        return NopEvaluator()


class PublicInputEvaluator(NopEvaluator):
    name = "public_input"
    num_variables = 1

    def num_repetitions(self, geometry):
        return geometry.num_columns_under_copy_permutation


class PublicInputGate:
    """Marks a variable as a public input: places it in a general-purpose row
    and records (column, row) (reference public_input.rs)."""

    @staticmethod
    def make_evaluator():
        return PublicInputEvaluator()

    @staticmethod
    def place(cs, variable: int):
        if not cs.config.keep_setup:
            return
        rows, offsets = cs.place_general_gate_batch(
            "public_input", "pi", [],
            np.asarray([[variable]], np.uint64))
        cs.set_public(int(offsets[0]), int(rows[0]))


# ---------------------------------------------------------------------------
# ConstantsAllocator
# ---------------------------------------------------------------------------


class ConstantsAllocatorEvaluator(GateEvaluator):
    name = "constants_allocator"
    num_variables = 1
    num_constants = 1
    max_constraint_degree = 1
    num_quotient_terms = 1

    @property
    def per_chunk_offset(self):
        return (1, 0, 1)

    def num_repetitions(self, geometry):
        return min(geometry.num_constant_columns,
                   geometry.num_columns_under_copy_permutation)

    def num_required_constants(self, geometry):
        return geometry.num_constant_columns

    def evaluate(self, src, ops):
        return [ops.sub(src.var(0), src.const(0))]


class BoundedConstantsAllocatorEvaluator(ConstantsAllocatorEvaluator):
    """Constant allocator with bounded instances per row (reference
    bounded_constant_allocator.rs)."""

    def __init__(self, bound: int):
        self.max_repetitions_bound = bound
        self.name = f"constants_allocator_bounded_{bound}"

    def spec_params(self):
        return self.max_repetitions_bound

    def num_repetitions(self, geometry):
        return min(super().num_repetitions(geometry),
                   self.max_repetitions_bound)


class ConstantsAllocatorGate:
    @staticmethod
    def make_evaluator():
        return ConstantsAllocatorEvaluator()

    @staticmethod
    def init_tools(cs):
        cs.static_tools["constant_to_variable"] = {}

    @staticmethod
    def allocate_constant(cs, value: int) -> int:
        """Dedup: same constant returns the same variable
        (reference constant_allocator.rs:252)."""
        value = int(value) % npgl.ORDER
        tool = cs.static_tools["constant_to_variable"]
        if value in tool:
            return tool[value]
        var = cs.alloc_variable_with_value(value)
        tool[value] = var
        cs.place_general_gate_batch(
            "constants_allocator", None, [[value]],
            np.asarray([[var]], np.uint64), constants_per_instance=True)
        return var

    @staticmethod
    def allocate_constants_batch(cs, values) -> np.ndarray:
        return np.asarray(
            [ConstantsAllocatorGate.allocate_constant(cs, int(v)) for v in values],
            np.uint64)


class ConstantsAsConstraintEvaluator(GateEvaluator):
    """ConstantsAllocationAsConstraintGate (reference
    constants_allocator_as_explicit_constraint.rs:14): the set
    [0, 1, -1, *extras] lives in copy columns of ONE row, each pinned by its
    own degree-1 term var_i − c_i with the constants BAKED INTO the evaluator
    — the gate consumes NO constant columns, which is its entire point. The
    reference leaves evaluate_* as todo!(); the documented intent (unique
    identifier per constants set, max_constraint_degree 1, one instance per
    row / can_apply_many_on_row = false) is implemented here."""

    max_constraint_degree = 1

    def __init__(self, extras=()):
        self.extras = tuple(int(c) % npgl.ORDER for c in extras)
        self.constants_set = (0, 1, npgl.ORDER - 1) + self.extras
        # unique per set (reference unique_identifier, :24-40)
        self.name = "constants_as_constraint_" + \
            "_".join(str(c) for c in self.extras)
        self.num_variables = len(self.constants_set)
        self.num_quotient_terms = len(self.constants_set)

    def num_repetitions(self, geometry):
        return 1

    def num_required_constants(self, geometry):
        return 0

    def evaluate(self, src, ops):
        return [ops.sub(src.var(i), ops.from_int(c))
                for i, c in enumerate(self.constants_set)]

    def spec_params(self):
        return self.extras


class ConstantsAllocationAsConstraintGate:
    """Allocate a SET of constants on one row without consuming constant
    columns (reference constants_allocator_as_explicit_constraint.rs:14:
    "ALWAYS adds 0, 1 and -1 as constants, and can add an arbitrary set").
    Feeds the same constant→variable dedup tool as ConstantsAllocatorGate, so
    later allocate_constant calls reuse these variables."""

    @staticmethod
    def make_evaluator(extras=()):
        return ConstantsAsConstraintEvaluator(tuple(extras))

    @staticmethod
    def add(cs, extras=()) -> np.ndarray:
        ev = ConstantsAsConstraintEvaluator(tuple(extras))
        assert cs.geometry.num_columns_under_copy_permutation >= \
            ev.num_variables, "constants set wider than the copy section"
        cs.allow_evaluator(ev)
        # one gate per distinct set (reference UniquenessTool, :90)
        seen = cs.static_tools.setdefault("constants_as_constraint_sets", set())
        assert ev.name not in seen, \
            f"constants set {ev.extras} already allocated"
        seen.add(ev.name)
        vals = np.asarray(ev.constants_set, np.uint64)
        vs = cs.alloc_variables_with_values(vals)
        cs.place_general_gate_batch(ev.name, None, [],
                                    np.asarray(vs, np.uint64).reshape(1, -1))
        c2v = cs.static_tools.setdefault("constant_to_variable", {})
        for c, v in zip(ev.constants_set, vs):
            c2v.setdefault(int(c), int(v))
        return vs


# ---------------------------------------------------------------------------
# FMA: c0 * A * B + c1 * C -> D
# ---------------------------------------------------------------------------


class FmaEvaluator(GateEvaluator):
    name = "fma"
    num_variables = 4
    num_constants = 2
    max_constraint_degree = 3
    num_quotient_terms = 1

    def evaluate(self, src, ops):
        a, b, c, d = src.var(0), src.var(1), src.var(2), src.var(3)
        c0, c1 = src.const(0), src.const(1)
        term = ops.add(ops.mul(c0, ops.mul(a, b)), ops.mul(c1, c))
        return [ops.sub(term, d)]


class FmaGate:
    @staticmethod
    def make_evaluator():
        return FmaEvaluator()

    @staticmethod
    def compute_fma_batch(cs, coeff_quad: int, ab, coeff_lin: int, c) -> np.ndarray:
        """d = c0*a*b + c1*c elementwise over variable arrays; returns the
        new output variable array."""
        a, b = (np.asarray(x, np.uint64).reshape(-1) for x in ab)
        c = np.asarray(c, np.uint64).reshape(-1)
        n = a.shape[0]
        d = cs.alloc_variables(n)
        c0 = coeff_quad % npgl.ORDER
        c1 = coeff_lin % npgl.ORDER

        def fn(vals):
            av, bv, cv = vals
            return npgl.add(npgl.mul(npgl.mul_scalar(av, c0), bv),
                            npgl.mul_scalar(cv, c1))

        def fn_dev(vals):
            # int64 tensors of u64 bit patterns (the JAX twin takes limbs)
            from ...field import goldilocks as gl
            av, bv, cv = vals
            return gl.add(gl.mul(gl.mul(av, c0), bv), gl.mul(cv, c1))

        fn.device_twin = fn_dev
        cs.set_values_with_dependencies(np.stack([a, b, c]), d, fn)
        cs.place_general_gate_batch("fma", (c0, c1), [c0, c1],
                                    np.stack([a, b, c, d], axis=1))
        return d

    @staticmethod
    def enforce_fma_batch(cs, coeff_quad: int, ab, coeff_lin: int, c, d):
        """Place the relation c0·a·b + c1·c == d over EXISTING variables
        (no witness generation — reference gate.add_to_cs with rhs_part)."""
        a, b = (np.asarray(x, np.uint64).reshape(-1) for x in ab)
        c = np.asarray(c, np.uint64).reshape(-1)
        d = np.asarray(d, np.uint64).reshape(-1)
        c0 = coeff_quad % npgl.ORDER
        c1 = coeff_lin % npgl.ORDER
        cs.place_general_gate_batch("fma", (c0, c1), [c0, c1],
                                    np.stack([a, b, c, d], axis=1))

    @staticmethod
    def compute_fma(cs, coeff_quad: int, ab, coeff_lin: int, c) -> int:
        out = FmaGate.compute_fma_batch(
            cs, coeff_quad,
            (np.asarray([ab[0]], np.uint64), np.asarray([ab[1]], np.uint64)),
            coeff_lin, np.asarray([c], np.uint64))
        return int(out[0])


# ---------------------------------------------------------------------------
# ReductionGate<N>: sum_i coeff_i * term_i -> result
# ---------------------------------------------------------------------------


class ReductionEvaluator(GateEvaluator):
    max_constraint_degree = 2
    num_quotient_terms = 1

    def __init__(self, n: int):
        self.n = n
        self.name = f"reduction_{n}"
        self.num_variables = n + 1
        self.num_constants = n

    def evaluate(self, src, ops):
        acc = ops.zero()
        for i in range(self.n):
            acc = ops.add(acc, ops.mul(src.var(i), src.const(i)))
        return [ops.sub(acc, src.var(self.n))]


class ReductionGate:
    N = 4

    @classmethod
    def make_evaluator(cls, n: int = None):
        return ReductionEvaluator(n or cls.N)

    @staticmethod
    def reduce_terms_batch(cs, coeffs: list[int], terms_2d) -> np.ndarray:
        """terms_2d: (N, n) variable handles -> result variable array (n,)."""
        terms = np.asarray(terms_2d, np.uint64)
        nterms, n = terms.shape
        coeffs = [int(c) % npgl.ORDER for c in coeffs]
        assert len(coeffs) == nterms
        result = cs.alloc_variables(n)

        def fn(vals):
            acc = np.zeros(n, np.uint64)
            for i, cf in enumerate(coeffs):
                acc = npgl.add(acc, npgl.mul_scalar(vals[i], cf))
            return acc

        cs.set_values_with_dependencies(terms, result, fn)
        cs.place_general_gate_batch(
            f"reduction_{nterms}", tuple(coeffs), coeffs,
            np.concatenate([terms, result[None, :]]).T)
        return result

    @staticmethod
    def reduce_terms(cs, coeffs, terms) -> int:
        out = ReductionGate.reduce_terms_batch(
            cs, coeffs, np.asarray(terms, np.uint64).reshape(-1, 1))
        return int(out[0])

    @staticmethod
    def enforce_reduce_batch(cs, coeffs: list[int], terms_2d, outs):
        """Place Σ coeff_i·term_i == out over EXISTING variables (no witness
        generation — the enforce twin of reduce_terms_batch).
        terms_2d: (N, n) handles; outs: (n,) handles."""
        terms = np.asarray(terms_2d, np.uint64)
        outs = np.asarray(outs, np.uint64).reshape(-1)
        coeffs = [int(c) % npgl.ORDER for c in coeffs]
        cs.place_general_gate_batch(
            f"reduction_{len(coeffs)}", tuple(coeffs), coeffs,
            np.concatenate([terms, outs[None, :]]).T)


# ---------------------------------------------------------------------------
# Boolean constraint: a*a == a
# ---------------------------------------------------------------------------


class BooleanEvaluator(GateEvaluator):
    name = "boolean"
    num_variables = 1
    max_constraint_degree = 2
    num_quotient_terms = 1

    def evaluate(self, src, ops):
        # reference boolean_allocator.rs evaluate_once: a * (1 - a)
        a = src.var(0)
        return [ops.sub(a, ops.mul(a, a))]


class BoundedBooleanEvaluator(BooleanEvaluator):
    """Boolean allocator with bounded instances per row (reference
    bounded_boolean_allocator.rs) — frees row capacity for geometry tuning."""

    def __init__(self, bound: int):
        self.max_repetitions_bound = bound
        self.name = f"boolean_bounded_{bound}"

    def spec_params(self):
        return self.max_repetitions_bound


class BooleanConstraintGate:
    @staticmethod
    def make_evaluator():
        return BooleanEvaluator()

    @staticmethod
    def enforce_batch(cs, variables):
        vs = np.asarray(variables, np.uint64).reshape(-1, 1)
        cs.place_general_gate_batch("boolean", None, [], vs)

    @staticmethod
    def allocate_batch(cs, bits) -> np.ndarray:
        """Allocate boolean-constrained variables with given bit values."""
        vs = cs.alloc_variables_with_values(np.asarray(bits, np.uint64))
        BooleanConstraintGate.enforce_batch(cs, vs)
        return vs


# ---------------------------------------------------------------------------
# Selection: result = sel·a + (1-sel)·b
# ---------------------------------------------------------------------------


class SelectionEvaluator(GateEvaluator):
    name = "selection"
    num_variables = 4
    max_constraint_degree = 2
    num_quotient_terms = 1

    def evaluate(self, src, ops):
        a, b, sel, res = src.var(0), src.var(1), src.var(2), src.var(3)
        term = ops.add(ops.mul(a, sel), ops.mul(ops.sub(ops.one(), sel), b))
        return [ops.sub(term, res)]


class SelectionGate:
    @staticmethod
    def make_evaluator():
        return SelectionEvaluator()

    @staticmethod
    def select_batch(cs, a, b, sel) -> np.ndarray:
        a = np.asarray(a, np.uint64).reshape(-1)
        b = np.asarray(b, np.uint64).reshape(-1)
        sel = np.broadcast_to(np.asarray(sel, np.uint64), a.shape).copy()
        res = cs.alloc_variables(a.shape[0])

        def fn(vals):
            av, bv, sv = vals
            return np.where(sv != 0, av, bv)

        cs.set_values_with_dependencies(np.stack([a, b, sel]), res, fn)
        cs.place_general_gate_batch(
            "selection", None, [], np.stack([a, b, sel, res], axis=1))
        return res


# ---------------------------------------------------------------------------
# Parallel selection: result_i = sel·a_i + (1-sel)·b_i  (N triples, 1 sel)
# ---------------------------------------------------------------------------


class ParallelSelectionEvaluator(GateEvaluator):
    max_constraint_degree = 2

    def __init__(self, n: int = 4):
        self.n = n
        self.name = f"parallel_selection_{n}"
        self.num_variables = 3 * n + 1
        self.num_quotient_terms = n

    def evaluate(self, src, ops):
        sel = src.var(0)
        one_minus = ops.sub(ops.one(), sel)
        out = []
        for i in range(self.n):
            a = src.var(3 * i + 1)
            b = src.var(3 * i + 2)
            res = src.var(3 * i + 3)
            term = ops.add(ops.mul(a, sel), ops.mul(one_minus, b))
            out.append(ops.sub(term, res))
        return out


class ParallelSelectionGate:
    N = 4

    @classmethod
    def make_evaluator(cls, n: int = None):
        return ParallelSelectionEvaluator(n or cls.N)


# ---------------------------------------------------------------------------
# Conditional swap: (ra, rb) = sel ? (b, a) : (a, b)
# ---------------------------------------------------------------------------


class ConditionalSwapEvaluator(GateEvaluator):
    max_constraint_degree = 2

    def __init__(self, n: int = 1):
        self.n = n
        self.name = f"conditional_swap_{n}"
        self.num_variables = 4 * n + 1
        self.num_quotient_terms = 2 * n

    def evaluate(self, src, ops):
        sel = src.var(0)
        one_minus = ops.sub(ops.one(), sel)
        out = []
        for i in range(self.n):
            a = src.var(4 * i + 1)
            b = src.var(4 * i + 2)
            ra = src.var(4 * i + 3)
            rb = src.var(4 * i + 4)
            t1 = ops.add(ops.mul(b, sel), ops.mul(one_minus, a))
            out.append(ops.sub(t1, ra))
            t2 = ops.add(ops.mul(a, sel), ops.mul(one_minus, b))
            out.append(ops.sub(t2, rb))
        return out


class ConditionalSwapGate:
    N = 1

    @classmethod
    def make_evaluator(cls, n: int = None):
        return ConditionalSwapEvaluator(n or cls.N)

    @staticmethod
    def swap_batch(cs, sel, a, b):
        a = np.asarray(a, np.uint64).reshape(-1)
        b = np.asarray(b, np.uint64).reshape(-1)
        sel_arr = np.broadcast_to(np.asarray(sel, np.uint64), a.shape).copy()
        ra = cs.alloc_variables(a.shape[0])
        rb = cs.alloc_variables(a.shape[0])

        def fn(vals):
            sv, av, bv = vals
            return np.stack([np.where(sv != 0, bv, av),
                             np.where(sv != 0, av, bv)])

        cs.set_values_with_dependencies(
            np.stack([sel_arr, a, b]), np.stack([ra, rb]), fn)
        cs.place_general_gate_batch(
            "conditional_swap_1", None, [],
            np.stack([sel_arr, a, b, ra, rb], axis=1))
        return ra, rb


# ---------------------------------------------------------------------------
# Dot product: sum_i a_i · b_i -> result  (N pairs)
# ---------------------------------------------------------------------------


class DotProductEvaluator(GateEvaluator):
    max_constraint_degree = 2
    num_quotient_terms = 1

    def __init__(self, n: int = 4):
        self.n = n
        self.name = f"dot_product_{n}"
        self.num_variables = 2 * n + 1

    def evaluate(self, src, ops):
        acc = ops.zero()
        for i in range(self.n):
            acc = ops.add(acc, ops.mul(src.var(2 * i), src.var(2 * i + 1)))
        return [ops.sub(acc, src.var(2 * self.n))]


class DotProductGate:
    N = 4

    @classmethod
    def make_evaluator(cls, n: int = None):
        return DotProductEvaluator(n or cls.N)

    @staticmethod
    def dot_batch(cs, pairs_2d) -> np.ndarray:
        """pairs_2d: (2N, n) handles [a0,b0,a1,b1,...] -> result (n,)."""
        pairs = np.asarray(pairs_2d, np.uint64)
        two_n, n = pairs.shape
        result = cs.alloc_variables(n)

        def fn(vals):
            acc = np.zeros(n, np.uint64)
            for i in range(two_n // 2):
                acc = npgl.add(acc, npgl.mul(vals[2 * i], vals[2 * i + 1]))
            return acc

        cs.set_values_with_dependencies(pairs, result, fn)
        cs.place_general_gate_batch(
            f"dot_product_{two_n // 2}", None, [],
            np.concatenate([pairs, result[None, :]]).T)
        return result


# ---------------------------------------------------------------------------
# Quadratic combination: sum_i a_i · b_i == 0  (N pairs)
# ---------------------------------------------------------------------------


class QuadraticCombinationEvaluator(GateEvaluator):
    max_constraint_degree = 2
    num_quotient_terms = 1

    def __init__(self, n: int = 4):
        self.n = n
        self.name = f"quadratic_combination_{n}"
        self.num_variables = 2 * n

    def evaluate(self, src, ops):
        acc = ops.zero()
        for i in range(self.n):
            acc = ops.add(acc, ops.mul(src.var(2 * i), src.var(2 * i + 1)))
        return [acc]


class QuadraticCombinationGate:
    N = 4

    @classmethod
    def make_evaluator(cls, n: int = None):
        return QuadraticCombinationEvaluator(n or cls.N)


# ---------------------------------------------------------------------------
# Reduction by powers: sum_i term_i · c^i -> result
# ---------------------------------------------------------------------------


class ReductionByPowersEvaluator(GateEvaluator):
    num_quotient_terms = 1
    num_constants = 1

    def __init__(self, n: int = 4):
        self.n = n
        self.name = f"reduction_by_powers_{n}"
        self.num_variables = n + 1
        self.max_constraint_degree = n

    def evaluate(self, src, ops):
        c = src.const(0)
        acc = ops.zero()
        power = ops.one()
        for i in range(self.n):
            acc = ops.add(acc, ops.mul(src.var(i), power))
            if i + 1 < self.n:
                power = ops.mul(power, c)
        return [ops.sub(acc, src.var(self.n))]


class ReductionByPowersGate:
    N = 4

    @classmethod
    def make_evaluator(cls, n: int = None):
        return ReductionByPowersEvaluator(n or cls.N)


# ---------------------------------------------------------------------------
# Zero check: flag = (input == 0), via inversion witness
# terms: flag + input·inv - 1 == 0 ; input·flag == 0
# ---------------------------------------------------------------------------


class ZeroCheckEvaluator(GateEvaluator):
    name = "zero_check"
    max_constraint_degree = 2
    num_quotient_terms = 2

    def __init__(self, use_witness_column: bool = False):
        self.use_witness_column = use_witness_column
        self.num_variables = 2 if use_witness_column else 3
        self.num_witnesses = 1 if use_witness_column else 0

    def spec_params(self):
        return self.use_witness_column

    @property
    def per_chunk_offset(self):
        return (self.num_variables, self.num_witnesses, 0)

    def evaluate(self, src, ops):
        inp = src.var(0)
        flag = src.var(1)
        inv = src.wit(0) if self.use_witness_column else src.var(2)
        t1 = ops.sub(ops.add(flag, ops.mul(inp, inv)), ops.one())
        t2 = ops.mul(inp, flag)
        return [t1, t2]


class ZeroCheckGate:
    @staticmethod
    def make_evaluator(use_witness_column: bool = False):
        return ZeroCheckEvaluator(use_witness_column)

    @staticmethod
    def init_tools(cs):
        # vacant repetitions violate term 1 -> register row cleanup
        # (reference zero_check.rs:405 finalization hint)
        ZeroCheckGate.add_row_cleanup(cs)

    @staticmethod
    def is_zero_batch_with_witness(cs, inputs) -> np.ndarray:
        """is_zero with the inversion hint in a WITNESS column (non-copiable;
        needs geometry.num_witness_columns >= 1 and the gate allowed with
        use_witness_column=True — reference zero_check.rs witness variant)."""
        inp = np.asarray(inputs, np.uint64).reshape(-1)
        n = inp.shape[0]
        flag = cs.alloc_variables(n)
        inv = np.asarray([cs.alloc_witness() for _ in range(n)], np.uint64)

        def fn(vals):
            v = vals[0]
            flags = (v == 0).astype(np.uint64)
            nonzero = np.where(v == 0, np.uint64(1), v)
            invs = npgl.batch_inv(nonzero)
            invs = np.where(v == 0, np.uint64(0), invs)
            return np.stack([flags, invs])

        cs.set_values_with_dependencies(inp[None, :], np.stack([flag, inv]),
                                        fn)
        cs.place_general_gate_batch(
            "zero_check", None, [], np.stack([inp, flag], axis=1),
            wits_2d=inv[:, None])
        return flag

    @staticmethod
    def is_zero_batch(cs, inputs) -> np.ndarray:
        """Returns flag variables (1 if input == 0). Uses variable column for
        the inversion witness (no witness columns needed)."""
        inp = np.asarray(inputs, np.uint64).reshape(-1)
        n = inp.shape[0]
        flag = cs.alloc_variables(n)
        inv = cs.alloc_variables(n)

        def fn(vals):
            v = vals[0]
            flags = (v == 0).astype(np.uint64)
            nonzero = np.where(v == 0, np.uint64(1), v)
            invs = npgl.batch_inv(nonzero)
            invs = np.where(v == 0, np.uint64(0), invs)
            return np.stack([flags, invs])

        cs.set_values_with_dependencies(inp[None, :], np.stack([flag, inv]), fn)
        cs.place_general_gate_batch(
            "zero_check", None, [], np.stack([inp, flag, inv], axis=1))
        return flag

    @staticmethod
    def add_row_cleanup(cs):
        """Partial zero-check rows must be completed with valid dummy
        instances (all-zero chunks violate term 1); register at allow time."""
        def cleanup(cs):
            tool = cs.tooling.get("zero_check", {})
            if None in tool:
                row, count = tool.pop(None)
                ev = cs.evaluators_general[cs.general_idx_by_name["zero_check"]]
                cap = ev.num_repetitions(cs.geometry)
                need = cap - count
                if need > 0:
                    zero_v = cs.alloc_variables_with_values(np.zeros(need, np.uint64))
                    one_v = cs.alloc_variables_with_values(np.ones(need, np.uint64))
                    pw = ev.num_variables
                    cols = (count + np.arange(need)) * pw
                    cs.copy_permutation_data[cols, row] = zero_v
                    cs.copy_permutation_data[cols + 1, row] = one_v
                    if ev.use_witness_column:
                        wcols = (count + np.arange(need)) * ev.num_witnesses
                        for wc in wcols:
                            cs.witness_placement_data[wc, row] = \
                                cs.alloc_witness_with_value(0)
                    else:
                        inv_v = cs.alloc_variables_with_values(
                            np.zeros(need, np.uint64))
                        cs.copy_permutation_data[cols + 2, row] = inv_v
        cs.row_cleanups.append(cleanup)
