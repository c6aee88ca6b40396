# Copied from boojum_tpu/cs/gates/poseidon2_gate.py.
"""Poseidon2FlattenedGate: one full permutation per gate instance.

Reference behavior: src/cs/gates/poseidon2.rs:8-441
(Poseidon2RoundFunctionFlattenedEvaluator / Poseidon2FlattenedGate) — the
whole 12-wide permutation is a single gate: 130 variables per instance
(12 in, 12 out, 106 degree-reset s-box intermediates), 118 quotient terms,
max degree 7. Degree resets: every full round after the first binds the
pre-round state to fresh variables; every partial round binds the pre-s-box
first element.

Unlike the reference (which multiplies by dense 12x12 matrices loaded as
global constants), the relation here uses the structured Poseidon2 forms —
the M4 block addition chain for the external MDS and sum+diagonal-shift for
the internal matrix — which is the same linear map with ~10x fewer symbolic
ops (matters when the evaluator runs over full LDE domains on device).
"""

from __future__ import annotations

import numpy as np

from ...hash.poseidon2 import _RC, _DIAG_SHIFTS, _R_F_HALF, _R_P
from ...utils import npgl
from .base import GateEvaluator

SW = 12
NUM_VARIABLES = 2 * SW + SW * (_R_F_HALF - 1) + _R_P + SW * _R_F_HALF  # 130
NUM_TERMS = (2 * (_R_F_HALF - 1) + 1 + 1) * SW + _R_P  # 118


def _ops_block_mul4(ops, x0, x1, x2, x3):
    two = ops.from_int(2)
    four = ops.from_int(4)
    t0 = ops.add(x0, x1)
    t1 = ops.add(x2, x3)
    t2 = ops.add(ops.mul(two, x1), t1)
    t3 = ops.add(ops.mul(two, x3), t0)
    t4 = ops.add(ops.mul(four, t1), t3)
    t5 = ops.add(ops.mul(four, t0), t2)
    t6 = ops.add(t3, t5)
    t7 = ops.add(t2, t4)
    return t6, t5, t7, t4


def _ops_external_mds(ops, state):
    b = [_ops_block_mul4(ops, *state[0:4]),
         _ops_block_mul4(ops, *state[4:8]),
         _ops_block_mul4(ops, *state[8:12])]
    col = [ops.add(ops.add(b[0][i], b[1][i]), b[2][i]) for i in range(4)]
    return [ops.add(b[blk][i], col[i]) for blk in range(3) for i in range(4)]


def _ops_internal_matrix(ops, state):
    total = state[0]
    for s in state[1:]:
        total = ops.add(total, s)
    return [ops.add(ops.mul(ops.from_int(1 << _DIAG_SHIFTS[i]), s), total)
            for i, s in enumerate(state)]


def _ops_sbox7(ops, x):
    x2 = ops.mul(x, x)
    x3 = ops.mul(x2, x)
    x4 = ops.mul(x2, x2)
    return ops.mul(x3, x4)


class Poseidon2FlattenedEvaluator(GateEvaluator):
    name = "poseidon2_flattened"
    num_variables = NUM_VARIABLES
    max_constraint_degree = 7
    num_quotient_terms = NUM_TERMS

    def evaluate(self, src, ops):
        state = [src.var(i) for i in range(SW)]
        output = [src.var(SW + i) for i in range(SW)]
        off = 2 * SW
        terms = []

        def rc(r, i):
            return ops.from_int(_RC[r * SW + i])

        r = 0
        state = _ops_external_mds(ops, state)
        for fr in range(_R_F_HALF):
            if fr != 0:
                for i in range(SW):
                    sb = src.var(off)
                    off += 1
                    terms.append(ops.sub(state[i], sb))
                    state[i] = sb
            state = [_ops_sbox7(ops, ops.add(state[i], rc(r, i)))
                     for i in range(SW)]
            state = _ops_external_mds(ops, state)
            r += 1
        for _ in range(_R_P):
            s0 = ops.add(state[0], rc(r, 0))
            sb = src.var(off)
            off += 1
            terms.append(ops.sub(s0, sb))
            state[0] = _ops_sbox7(ops, sb)
            state = _ops_internal_matrix(ops, state)
            r += 1
        for _ in range(_R_F_HALF):
            for i in range(SW):
                sb = src.var(off)
                off += 1
                terms.append(ops.sub(state[i], sb))
                state[i] = sb
            state = [_ops_sbox7(ops, ops.add(state[i], rc(r, i)))
                     for i in range(SW)]
            state = _ops_external_mds(ops, state)
            r += 1
        assert off == NUM_VARIABLES
        for i in range(SW):
            terms.append(ops.sub(output[i], state[i]))
        assert len(terms) == NUM_TERMS
        return terms


def _np_external_mds(state):
    def bm4(x0, x1, x2, x3):
        t0 = npgl.add(x0, x1)
        t1 = npgl.add(x2, x3)
        t2 = npgl.add(npgl.add(x1, x1), t1)
        t3 = npgl.add(npgl.add(x3, x3), t0)
        t4 = npgl.add(npgl.mul_scalar(t1, 4), t3)
        t5 = npgl.add(npgl.mul_scalar(t0, 4), t2)
        return npgl.add(t3, t5), t5, npgl.add(t2, t4), t4

    b = [bm4(*state[0:4]), bm4(*state[4:8]), bm4(*state[8:12])]
    col = [npgl.add(npgl.add(b[0][i], b[1][i]), b[2][i]) for i in range(4)]
    return [npgl.add(b[blk][i], col[i]) for blk in range(3) for i in range(4)]


def _np_internal_matrix(state):
    total = state[0]
    for s in state[1:]:
        total = npgl.add(total, s)
    return [npgl.add(npgl.mul_scalar(s, (1 << _DIAG_SHIFTS[i]) % npgl.ORDER),
                     total)
            for i, s in enumerate(state)]


def _np_sbox7(x):
    x2 = npgl.mul(x, x)
    x3 = npgl.mul(x2, x)
    return npgl.mul(x3, npgl.mul(x2, x2))


def _int_flat_witness(state_cols):
    """Pure-Python-int twin of _np_flat_witness for SMALL batches: numpy
    scalar ops cost ~30 us each, and one permutation is ~4k of them —
    recursion-circuit synthesis spent ~6 s/permutation-heavy circuit in
    these closures (round-4 profile). Identical values."""
    P = int(npgl.ORDER)
    n = len(state_cols[0])
    inter_all, out_all = None, None
    inters, outs = [], []
    for j in range(n):
        st = [int(state_cols[i][j]) for i in range(SW)]

        def emds(s):
            def bm4(x0, x1, x2, x3):
                t0 = (x0 + x1) % P
                t1 = (x2 + x3) % P
                t2 = (2 * x1 + t1) % P
                t3 = (2 * x3 + t0) % P
                t4 = (4 * t1 + t3) % P
                t5 = (4 * t0 + t2) % P
                return (t3 + t5) % P, t5, (t2 + t4) % P, t4

            b = [bm4(*s[0:4]), bm4(*s[4:8]), bm4(*s[8:12])]
            col = [(b[0][i] + b[1][i] + b[2][i]) % P for i in range(4)]
            return [(b[blk][i] + col[i]) % P for blk in range(3)
                    for i in range(4)]

        def sbox7(x):
            x2 = x * x % P
            x3 = x2 * x % P
            return x3 * (x2 * x2 % P) % P

        inter = []
        r = 0
        st = emds(st)
        for fr in range(_R_F_HALF):
            if fr != 0:
                inter.extend(st)
            st = [sbox7((st[i] + _RC[r * SW + i]) % P) for i in range(SW)]
            st = emds(st)
            r += 1
        for _ in range(_R_P):
            s0 = (st[0] + _RC[r * SW]) % P
            inter.append(s0)
            st = list(st)
            st[0] = sbox7(s0)
            total = sum(st) % P
            st = [((st[i] << _DIAG_SHIFTS[i]) + total) % P
                  for i in range(SW)]
            r += 1
        for _ in range(_R_F_HALF):
            inter.extend(st)
            st = [sbox7((st[i] + _RC[r * SW + i]) % P) for i in range(SW)]
            st = emds(st)
            r += 1
        inters.append(inter)
        outs.append(st)
    inter_arr = np.asarray(inters, np.uint64).T  # (n_inter, n)
    out_arr = np.asarray(outs, np.uint64).T      # (SW, n)
    return [inter_arr[i] for i in range(inter_arr.shape[0])], \
        [out_arr[i] for i in range(SW)]


def _np_flat_witness(state_cols):
    """state_cols: list of 12 (n,) arrays -> (intermediates list, outputs).
    Mirrors the evaluator's variable consumption order exactly."""
    if len(state_cols[0]) <= 8:
        return _int_flat_witness(state_cols)
    state = list(state_cols)
    inter = []
    r = 0
    state = _np_external_mds(state)
    for fr in range(_R_F_HALF):
        if fr != 0:
            inter.extend(state)
        state = [_np_sbox7(npgl.add(state[i],
                                    np.uint64(_RC[r * SW + i])))
                 for i in range(SW)]
        state = _np_external_mds(state)
        r += 1
    for _ in range(_R_P):
        s0 = npgl.add(state[0], np.uint64(_RC[r * SW]))
        inter.append(s0)
        state = list(state)
        state[0] = _np_sbox7(s0)
        state = _np_internal_matrix(state)
        r += 1
    for _ in range(_R_F_HALF):
        inter.extend(state)
        state = [_np_sbox7(npgl.add(state[i],
                                    np.uint64(_RC[r * SW + i])))
                 for i in range(SW)]
        state = _np_external_mds(state)
        r += 1
    return inter, state


class Poseidon2FlattenedGate:
    @staticmethod
    def make_evaluator():
        return Poseidon2FlattenedEvaluator()

    @staticmethod
    def compute_round_function_batch(cs, states):
        """states: (n, 12) variable handles -> (n, 12) output handles; one
        gate instance per permutation (reference compute_round_function,
        poseidon2.rs:743)."""
        states = np.asarray(states, np.uint64).reshape(-1, SW)
        n = states.shape[0]
        n_inter = NUM_VARIABLES - 2 * SW
        outputs = cs.alloc_variables(SW * n).reshape(n, SW)
        inters = cs.alloc_variables(n_inter * n).reshape(n_inter, n)

        def fn(vals):
            inter, out = _np_flat_witness([vals[i] for i in range(SW)])
            return np.stack(inter + out)

        cs.set_values_with_dependencies(
            states.T, np.concatenate([inters, outputs.T]), fn)
        cs.place_general_gate_batch(
            "poseidon2_flattened", None, [],
            np.concatenate([states, outputs, inters.T], axis=1))
        return outputs
