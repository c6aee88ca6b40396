# Copied from boojum_tpu/cs/gates/arith.py.
"""Arithmetic gates: u32 add/sub with carries, parametrized-width add,
matrix multiplication, extension-field FMA.

Reference behavior: src/cs/gates/u32_add.rs (a + b + carry_in = c +
2^32·carry_out, carry boolean), u32_sub.rs (a - b - borrow_in = c -
2^32·borrow_out), uintx_add.rs (shift constant instead of 2^32),
matrix_multiplication_gate.rs (out = M·in for a constant NxN matrix — the
in-circuit Poseidon MDS), fma_gate_in_extension_without_constant.rs.
"""

from __future__ import annotations

import numpy as np

from ...utils import npgl
from .base import GateEvaluator


class U32AddEvaluator(GateEvaluator):
    name = "u32_add"
    num_variables = 5
    max_constraint_degree = 2
    num_quotient_terms = 2

    def evaluate(self, src, ops):
        a, b, cin, c, cout = (src.var(i) for i in range(5))
        shift = ops.from_int(1 << 32)
        t = ops.sub(ops.sub(ops.add(ops.add(a, b), cin), c), ops.mul(shift, cout))
        boolean = ops.sub(ops.mul(cout, cout), cout)
        return [t, boolean]


class U32AddGate:
    @staticmethod
    def make_evaluator():
        return U32AddEvaluator()

    @staticmethod
    def add_batch(cs, a, b, carry_in=None):
        """c = (a + b + carry_in) mod 2^32 with carry_out; returns (c, carry_out).
        Inputs must be range-checked u32 variables."""
        a = np.asarray(a, np.uint64).reshape(-1)
        b = np.asarray(b, np.uint64).reshape(-1)
        n = a.shape[0]
        if carry_in is None:
            from .simple import ConstantsAllocatorGate
            zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
            carry_in = np.full(n, zero, np.uint64)
        else:
            carry_in = np.asarray(carry_in, np.uint64).reshape(-1)
        c = cs.alloc_variables(n)
        cout = cs.alloc_variables(n)

        def fn(vals):
            s = vals[0].astype(np.uint64) + vals[1] + vals[2]
            return np.stack([s & np.uint64(0xFFFFFFFF), s >> np.uint64(32)])

        cs.set_values_with_dependencies(np.stack([a, b, carry_in]),
                                        np.stack([c, cout]), fn)
        cs.place_general_gate_batch(
            "u32_add", None, [], np.stack([a, b, carry_in, c, cout], axis=1))
        return c, cout


class U32SubEvaluator(GateEvaluator):
    name = "u32_sub"
    num_variables = 5
    max_constraint_degree = 2
    num_quotient_terms = 2

    def evaluate(self, src, ops):
        a, b, bin_, c, bout = (src.var(i) for i in range(5))
        shift = ops.from_int(1 << 32)
        t = ops.add(ops.sub(ops.sub(ops.sub(a, b), bin_), c), ops.mul(shift, bout))
        boolean = ops.sub(ops.mul(bout, bout), bout)
        return [t, boolean]


class U32SubGate:
    @staticmethod
    def make_evaluator():
        return U32SubEvaluator()

    @staticmethod
    def sub_batch(cs, a, b, borrow_in=None):
        a = np.asarray(a, np.uint64).reshape(-1)
        b = np.asarray(b, np.uint64).reshape(-1)
        n = a.shape[0]
        if borrow_in is None:
            from .simple import ConstantsAllocatorGate
            zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
            borrow_in = np.full(n, zero, np.uint64)
        else:
            borrow_in = np.asarray(borrow_in, np.uint64).reshape(-1)
        c = cs.alloc_variables(n)
        bout = cs.alloc_variables(n)

        def fn(vals):
            d = vals[0].astype(np.int64) - vals[1].astype(np.int64) \
                - vals[2].astype(np.int64)
            borrow = (d < 0).astype(np.uint64)
            return np.stack([(d + (borrow.astype(np.int64) << 32)).astype(np.uint64),
                             borrow])

        cs.set_values_with_dependencies(np.stack([a, b, borrow_in]),
                                        np.stack([c, bout]), fn)
        cs.place_general_gate_batch(
            "u32_sub", None, [], np.stack([a, b, borrow_in, c, bout], axis=1))
        return c, bout


class UIntXAddEvaluator(GateEvaluator):
    num_variables = 5
    num_constants = 1
    max_constraint_degree = 2
    num_quotient_terms = 2

    def __init__(self, width: int = 32):
        self.width = width
        self.name = f"uintx_add_{width}"

    def spec_params(self):
        return self.width

    def evaluate(self, src, ops):
        a, b, cin, c, cout = (src.var(i) for i in range(5))
        shift = src.const(0)
        t = ops.sub(ops.sub(ops.add(ops.add(a, b), cin), c), ops.mul(shift, cout))
        boolean = ops.sub(ops.mul(cout, cout), cout)
        return [t, boolean]


class UIntXAddGate:
    WIDTH = 32

    @classmethod
    def make_evaluator(cls, width: int = None):
        return UIntXAddEvaluator(width or cls.WIDTH)


class MatrixMulEvaluator(GateEvaluator):
    max_constraint_degree = 1
    """out = M·in for a constant N x N matrix (reference
    matrix_multiplication_gate.rs — in-circuit Poseidon MDS)."""

    def __init__(self, params):
        n, matrix = params
        self.n = n
        self.matrix = [[int(x) % npgl.ORDER for x in row] for row in matrix]
        self.name = f"matrix_mul_{n}"
        self.num_variables = 2 * n
        self.num_quotient_terms = n

    def spec_params(self):
        return (self.n, self.matrix)

    def evaluate(self, src, ops):
        out = []
        for i in range(self.n):
            acc = ops.zero()
            for j in range(self.n):
                acc = ops.add(acc, ops.mul(ops.from_int(self.matrix[i][j]),
                                           src.var(j)))
            out.append(ops.sub(acc, src.var(self.n + i)))
        return out


class MatrixMultiplicationGate:
    @staticmethod
    def make_evaluator(params):
        return MatrixMulEvaluator(params)

    @staticmethod
    def multiply_batch(cs, name, matrix, inputs_2d):
        """inputs_2d: (N, n) handles -> outputs (N, n)."""
        inputs = np.asarray(inputs_2d, np.uint64)
        nn, n = inputs.shape
        outputs = cs.alloc_variables(nn * n).reshape(nn, n)
        m = np.asarray([[int(x) % npgl.ORDER for x in row] for row in matrix],
                       np.uint64)

        def fn(vals):
            out = np.zeros((nn, n), np.uint64)
            for i in range(nn):
                for j in range(nn):
                    out[i] = npgl.add(out[i], npgl.mul_scalar(vals[j], int(m[i, j])))
            return out

        cs.set_values_with_dependencies(inputs, outputs, fn)
        cs.place_general_gate_batch(
            name, None, [], np.concatenate([inputs, outputs]).T)
        return outputs


class FmaExtEvaluator(GateEvaluator):
    """c0·A·B + c1·C -> D over GoldilocksExt2 (reference
    fma_gate_in_extension_without_constant.rs): variables are (c0, c1) pairs,
    coefficients are extension constants; two quotient terms (components)."""

    name = "fma_ext"
    num_variables = 8
    num_constants = 4
    max_constraint_degree = 3
    num_quotient_terms = 2

    def evaluate(self, src, ops):
        a = (src.var(0), src.var(1))
        b = (src.var(2), src.var(3))
        c = (src.var(4), src.var(5))
        d = (src.var(6), src.var(7))
        q = (src.const(0), src.const(1))
        l = (src.const(2), src.const(3))
        nr = ops.from_int(7)

        def emul(x, y):
            v0 = ops.mul(x[0], y[0])
            v1 = ops.mul(x[1], y[1])
            c0 = ops.add(v0, ops.mul(nr, v1))
            c1 = ops.sub(ops.sub(ops.mul(ops.add(x[0], x[1]),
                                         ops.add(y[0], y[1])), v0), v1)
            return (c0, c1)

        t = emul(emul(q, a), b)
        u = emul(l, c)
        r0 = ops.sub(ops.add(t[0], u[0]), d[0])
        r1 = ops.sub(ops.add(t[1], u[1]), d[1])
        return [r0, r1]


class FmaGateInExtension:
    @staticmethod
    def make_evaluator():
        return FmaExtEvaluator()

    @staticmethod
    def compute_fma_ext_batch(cs, coeff_quad, ab, coeff_lin, c):
        """coeffs are (c0, c1) int tuples; ab/c are pairs of (c0_vars, c1_vars)
        arrays; returns (d0_vars, d1_vars)."""
        from ...field import extension as ext2
        (a0, a1), (b0, b1) = ab
        c0v, c1v = c
        arrs = [np.asarray(x, np.uint64).reshape(-1)
                for x in (a0, a1, b0, b1, c0v, c1v)]
        n = arrs[0].shape[0]
        d0 = cs.alloc_variables(n)
        d1 = cs.alloc_variables(n)
        q = (int(coeff_quad[0]) % npgl.ORDER, int(coeff_quad[1]) % npgl.ORDER)
        l = (int(coeff_lin[0]) % npgl.ORDER, int(coeff_lin[1]) % npgl.ORDER)

        def fn(vals):
            av = (vals[0], vals[1])
            bv = (vals[2], vals[3])
            cv = (vals[4], vals[5])

            def em(x, y):
                v0 = npgl.mul(x[0], y[0])
                v1 = npgl.mul(x[1], y[1])
                r0 = npgl.add(v0, npgl.mul_scalar(v1, 7))
                r1 = npgl.sub(npgl.sub(npgl.mul(npgl.add(x[0], x[1]),
                                                npgl.add(y[0], y[1])), v0), v1)
                return (r0, r1)

            def es(x, s):
                return (npgl.add(npgl.mul_scalar(x[0], s[0]),
                                 npgl.mul_scalar(npgl.mul_scalar(x[1], s[1]), 7)),
                        npgl.add(npgl.mul_scalar(x[0], s[1]),
                                 npgl.mul_scalar(x[1], s[0])))

            t = em(es(av, q), bv)
            u = es(cv, l)
            return np.stack([npgl.add(t[0], u[0]), npgl.add(t[1], u[1])])

        cs.set_values_with_dependencies(np.stack(arrs), np.stack([d0, d1]), fn)
        cs.place_general_gate_batch(
            "fma_ext", (q, l), [q[0], q[1], l[0], l[1]],
            np.stack(arrs + [d0, d1], axis=1))
        return d0, d1


class SimpleNonlinearityEvaluator(GateEvaluator):
    """(x + c)^N - y = 0 (reference
    src/cs/gates/simple_non_linearity_with_constant.rs:100-126); width 2,
    one row-shared additive constant."""

    num_variables = 2
    num_constants = 1
    num_quotient_terms = 1

    def __init__(self, n: int = 7):
        self.n = n
        self.name = f"simple_nonlinearity_{n}"
        self.max_constraint_degree = n

    def spec_params(self):
        return self.n

    def evaluate(self, src, ops):
        x, y = src.var(0), src.var(1)
        base = ops.add(x, src.const(0))
        acc = None
        e = self.n
        sq = base
        while e:
            if e & 1:
                acc = sq if acc is None else ops.mul(acc, sq)
            e >>= 1
            if e:
                sq = ops.mul(sq, sq)
        return [ops.sub(acc, y)]


class SimpleNonlinearityGate:
    N = 7

    @classmethod
    def make_evaluator(cls, n: int = None):
        return SimpleNonlinearityEvaluator(n or cls.N)

    @staticmethod
    def init_tools(cs):
        # vacant repetitions violate (0+c)^N != 0 -> fill partial rows with
        # valid dummy instances (reference NonlinearityGateFinalizationHint,
        # simple_non_linearity_with_constant.rs:140)
        def cleanup(cs):
            for name, idx in list(cs.general_idx_by_name.items()):
                if not name.startswith("simple_nonlinearity_"):
                    continue
                ev = cs.evaluators_general[idx]
                cap = ev.num_repetitions(cs.geometry)
                tool = cs.tooling.get(name, {})
                for key in list(tool):
                    row, count = tool.pop(key)
                    need = cap - count
                    if need <= 0:
                        continue
                    c = key[0]
                    y_val = pow(c, ev.n, npgl.ORDER)
                    x_v = cs.alloc_variables_with_values(
                        np.zeros(need, np.uint64))
                    y_v = cs.alloc_variables_with_values(
                        np.full(need, y_val, np.uint64))
                    cols = (count + np.arange(need)) * ev.num_variables
                    cs.copy_permutation_data[cols, row] = x_v
                    cs.copy_permutation_data[cols + 1, row] = y_v

        cs.row_cleanups.append(cleanup)

    @classmethod
    def apply_nonlinearity_batch(cls, cs, x, constant: int, n: int = None):
        """y = (x + constant)^n elementwise over handle array x."""
        n = n or cls.N
        x = np.asarray(x, np.uint64).reshape(-1)
        cnt = x.shape[0]
        y = cs.alloc_variables(cnt)
        c = int(constant) % npgl.ORDER

        def fn(vals):
            base = npgl.add(vals[0], np.full(cnt, c, np.uint64))
            acc = None
            e, sq = n, base
            while e:
                if e & 1:
                    acc = sq if acc is None else npgl.mul(acc, sq)
                e >>= 1
                if e:
                    sq = npgl.mul(sq, sq)
            return acc[None]

        cs.set_values_with_dependencies(x[None], y[None], fn)
        cs.place_general_gate_batch(
            f"simple_nonlinearity_{n}", (c,), [c], np.stack([x, y], axis=1))
        return y


class U32TriAddCarryEvaluator(GateEvaluator):
    """Byte-chunked a + b + c = out + carry·2^32 (reference
    src/cs/gates/u32_tri_add_carry_as_chunk.rs:105-178): all operands are
    4 byte-limbs; carry in [0, 2] (range-checked by the caller)."""

    name = "u32_tri_add_carry"
    num_variables = 17
    max_constraint_degree = 1
    num_quotient_terms = 1

    def evaluate(self, src, ops):
        acc = ops.zero()
        for operand in range(3):
            for i in range(4):
                acc = ops.add(acc, ops.mul(ops.from_int(1 << (8 * i)),
                                           src.var(4 * operand + i)))
        for i in range(4):
            acc = ops.sub(acc, ops.mul(ops.from_int(1 << (8 * i)),
                                       src.var(12 + i)))
        acc = ops.sub(acc, ops.mul(ops.from_int(1 << 32), src.var(16)))
        return [acc]


class U32TriAddCarryAsChunkGate:
    @staticmethod
    def make_evaluator():
        return U32TriAddCarryEvaluator()

    @staticmethod
    def add_batch(cs, a4, b4, c4):
        """a4/b4/c4: (n, 4) byte-limb handles -> (out4 (n, 4), carry (n,)).
        Byte-range checks on out are the caller's (carry needs a 2-bit
        check; it is NOT boolean here — max value 2)."""
        a4 = np.asarray(a4, np.uint64).reshape(-1, 4)
        b4 = np.asarray(b4, np.uint64).reshape(-1, 4)
        c4 = np.asarray(c4, np.uint64).reshape(-1, 4)
        n = a4.shape[0]
        out4 = cs.alloc_variables(4 * n).reshape(n, 4)
        carry = cs.alloc_variables(n)

        def fn(vals):
            tot = np.zeros(n, np.uint64)
            for operand in range(3):
                for i in range(4):
                    tot += vals[4 * operand + i] << np.uint64(8 * i)
            outs = [(tot >> np.uint64(8 * i)) & np.uint64(0xFF)
                    for i in range(4)]
            outs.append(tot >> np.uint64(32))
            return np.stack(outs)

        ins = np.concatenate([a4.T, b4.T, c4.T])
        cs.set_values_with_dependencies(
            ins, np.concatenate([out4.T, carry[None]]), fn)
        cs.place_general_gate_batch(
            "u32_tri_add_carry", None, [],
            np.concatenate([a4, b4, c4, out4, carry[:, None]], axis=1))
        return out4, carry


class U8x4FMAEvaluator(GateEvaluator):
    """u32 FMA over byte limbs: a·b + c + carry_in = low + 2^32·high
    enforced as two 0..32 / 32..64 bit-window identities with two 8-bit
    product carries (reference src/cs/gates/u32_fma.rs:137-299)."""

    name = "u8x4_fma"
    num_variables = 26
    max_constraint_degree = 2
    num_quotient_terms = 2

    def evaluate(self, src, ops):
        a = [src.var(i) for i in range(4)]
        b = [src.var(4 + i) for i in range(4)]
        c = [src.var(8 + i) for i in range(4)]
        cin = [src.var(12 + i) for i in range(4)]
        low = [src.var(16 + i) for i in range(4)]
        high = [src.var(20 + i) for i in range(4)]
        pc0, pc1 = src.var(24), src.var(25)

        def sh(k):
            return ops.from_int(1 << k)

        t1 = ops.zero()
        for i in range(4):
            t1 = ops.add(t1, ops.mul(sh(8 * i), ops.add(c[i], cin[i])))
            t1 = ops.sub(t1, ops.mul(sh(8 * i), low[i]))
        for k in range(4):  # mul columns 0..3 (bits 0..32)
            col = ops.zero()
            for i in range(k + 1):
                col = ops.add(col, ops.mul(a[i], b[k - i]))
            t1 = ops.add(t1, ops.mul(sh(8 * k), col))
        t1 = ops.sub(t1, ops.mul(sh(32), pc0))
        t1 = ops.sub(t1, ops.mul(sh(40), pc1))

        t2 = ops.add(pc0, ops.mul(sh(8), pc1))
        for i in range(4):
            t2 = ops.sub(t2, ops.mul(sh(8 * i), high[i]))
        for k in range(4, 7):  # mul columns 4..6 (bits 32..56)
            col = ops.zero()
            for i in range(k - 3, 4):
                col = ops.add(col, ops.mul(a[i], b[k - i]))
            t2 = ops.add(t2, ops.mul(sh(8 * (k - 4)), col))
        return [t1, t2]


class U8x4FMAGate:
    @staticmethod
    def make_evaluator():
        return U8x4FMAEvaluator()

    @staticmethod
    def perform_fma_batch(cs, a4, b4, c4, cin4):
        """(n,4) byte-limb handle arrays -> (low4, high4, pc2); byte range
        checks on low/high and 8-bit checks on pc are the caller's
        (reference perform_fma u32_fma.rs:450)."""
        a4 = np.asarray(a4, np.uint64).reshape(-1, 4)
        b4 = np.asarray(b4, np.uint64).reshape(-1, 4)
        c4 = np.asarray(c4, np.uint64).reshape(-1, 4)
        cin4 = np.asarray(cin4, np.uint64).reshape(-1, 4)
        n = a4.shape[0]
        low4 = cs.alloc_variables(4 * n).reshape(n, 4)
        high4 = cs.alloc_variables(4 * n).reshape(n, 4)
        pc2 = cs.alloc_variables(2 * n).reshape(n, 2)

        def fn(vals):
            def word(off):
                w = np.zeros(n, np.uint64)
                for i in range(4):
                    w += vals[off + i] << np.uint64(8 * i)
                return w

            a, b, c, cin = word(0), word(4), word(8), word(12)
            av = [vals[i] for i in range(4)]
            bv = [vals[4 + i] for i in range(4)]
            tmp = c + cin
            for k in range(4):
                col = np.zeros(n, np.uint64)
                for i in range(k + 1):
                    col += av[i] * bv[k - i]
                tmp += col << np.uint64(8 * k)
            pc = tmp >> np.uint64(32)
            res_lo = a * b + c + cin  # u64 wrap-free: < 2^64
            outs = [(res_lo >> np.uint64(8 * i)) & np.uint64(0xFF)
                    for i in range(8)]
            outs.append(pc & np.uint64(0xFF))
            outs.append(pc >> np.uint64(8))
            return np.stack(outs)

        ins = np.concatenate([a4.T, b4.T, c4.T, cin4.T])
        cs.set_values_with_dependencies(
            ins, np.concatenate([low4.T, high4.T, pc2.T]), fn)
        cs.place_general_gate_batch(
            "u8x4_fma", None, [],
            np.concatenate([a4, b4, c4, cin4, low4, high4, pc2], axis=1))
        return low4, high4, pc2
