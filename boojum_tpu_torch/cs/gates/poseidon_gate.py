# Copied from boojum_tpu/cs/gates/poseidon_gate.py (without the JAX scan evaluation).
"""PoseidonFlattenedGate: one classic-Poseidon permutation per gate instance.

Reference behavior: src/cs/gates/poseidon.rs:503 (PoseidonFlattenedGate) —
the flattening mirrors poseidon2_gate.py: 130 variables (12 in, 12 out, 106
degree-reset s-box intermediates), 118 quotient terms, max degree 7. Classic
Poseidon differs from Poseidon2 in the linear layer (circulant
powers-of-two MDS every round, no separate internal matrix) and in adding
round constants to the WHOLE state in partial rounds.
"""

from __future__ import annotations

import numpy as np

from ...hash.poseidon import _MDS_POW, _RC, _R_F_HALF, _R_P
from ...utils import npgl
from .base import GateEvaluator
from .poseidon2_gate import SW, NUM_VARIABLES, NUM_TERMS, _ops_sbox7, _np_sbox7


def _ops_mds(ops, state):
    out = []
    for r in range(SW):
        acc = None
        for c in range(SW):
            term = ops.mul(ops.from_int(_MDS_POW[r][c] % npgl.ORDER), state[c])
            acc = term if acc is None else ops.add(acc, term)
        out.append(acc)
    return out


def _np_mds(state):
    out = []
    for r in range(SW):
        acc = None
        for c in range(SW):
            term = npgl.mul_scalar(state[c], _MDS_POW[r][c] % npgl.ORDER)
            acc = term if acc is None else npgl.add(acc, term)
        out.append(acc)
    return out


class PoseidonFlattenedEvaluator(GateEvaluator):
    name = "poseidon_flattened"
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
        for fr in range(_R_F_HALF):
            if fr != 0:
                for i in range(SW):
                    sb = src.var(off)
                    off += 1
                    terms.append(ops.sub(state[i], sb))
                    state[i] = sb
            state = [_ops_sbox7(ops, ops.add(state[i], rc(r, i)))
                     for i in range(SW)]
            state = _ops_mds(ops, state)
            r += 1
        for _ in range(_R_P):
            state = [ops.add(state[i], rc(r, i)) for i in range(SW)]
            sb = src.var(off)
            off += 1
            terms.append(ops.sub(state[0], sb))
            state[0] = _ops_sbox7(ops, sb)
            state = _ops_mds(ops, state)
            r += 1
        for _ in range(_R_F_HALF):
            for i in range(SW):
                sb = src.var(off)
                off += 1
                terms.append(ops.sub(state[i], sb))
                state[i] = sb
            state = [_ops_sbox7(ops, ops.add(state[i], rc(r, i)))
                     for i in range(SW)]
            state = _ops_mds(ops, state)
            r += 1
        assert off == NUM_VARIABLES
        for i in range(SW):
            terms.append(ops.sub(output[i], state[i]))
        assert len(terms) == NUM_TERMS
        return terms


def _int_flat_witness(state_cols):
    """Pure-int twin of _np_flat_witness for small batches (the classic
    dense-MDS permutation is ~4k numpy scalar ops = ~125 ms per instance;
    int math is ~40x faster at batch 1). Identical values."""
    P = int(npgl.ORDER)
    n = len(state_cols[0])
    exps = [[int(_MDS_POW[a][b] % npgl.ORDER).bit_length() - 1
             for b in range(SW)] for a in range(SW)]
    inters, outs = [], []
    for j in range(n):
        st = [int(state_cols[i][j]) for i in range(SW)]

        def mds(s):
            return [sum(s[c] << exps[r_][c] for c in range(SW)) % P
                    for r_ in range(SW)]

        def sbox7(x):
            x2 = x * x % P
            x3 = x2 * x % P
            return x3 * (x2 * x2 % P) % P

        inter = []
        r = 0
        for fr in range(_R_F_HALF):
            if fr != 0:
                inter.extend(st)
            st = [sbox7((st[i] + _RC[r * SW + i]) % P) for i in range(SW)]
            st = mds(st)
            r += 1
        for _ in range(_R_P):
            st = [(st[i] + _RC[r * SW + i]) % P for i in range(SW)]
            inter.append(st[0])
            st = list(st)
            st[0] = sbox7(st[0])
            st = mds(st)
            r += 1
        for _ in range(_R_F_HALF):
            inter.extend(st)
            st = [sbox7((st[i] + _RC[r * SW + i]) % P) for i in range(SW)]
            st = mds(st)
            r += 1
        inters.append(inter)
        outs.append(st)
    inter_arr = np.asarray(inters, np.uint64).T
    out_arr = np.asarray(outs, np.uint64).T
    return [inter_arr[i] for i in range(inter_arr.shape[0])], \
        [out_arr[i] for i in range(SW)]


def _np_flat_witness(state_cols):
    if len(state_cols[0]) <= 8:
        return _int_flat_witness(state_cols)
    state = list(state_cols)
    inter = []
    r = 0
    for fr in range(_R_F_HALF):
        if fr != 0:
            inter.extend(state)
        state = [_np_sbox7(npgl.add(state[i], np.uint64(_RC[r * SW + i])))
                 for i in range(SW)]
        state = _np_mds(state)
        r += 1
    for _ in range(_R_P):
        state = [npgl.add(state[i], np.uint64(_RC[r * SW + i]))
                 for i in range(SW)]
        inter.append(state[0])
        state = list(state)
        state[0] = _np_sbox7(state[0])
        state = _np_mds(state)
        r += 1
    for _ in range(_R_F_HALF):
        inter.extend(state)
        state = [_np_sbox7(npgl.add(state[i], np.uint64(_RC[r * SW + i])))
                 for i in range(SW)]
        state = _np_mds(state)
        r += 1
    return inter, state


class PoseidonFlattenedGate:
    @staticmethod
    def make_evaluator():
        return PoseidonFlattenedEvaluator()

    @staticmethod
    def compute_round_function_batch(cs, states):
        """states: (n, 12) variable handles -> (n, 12) output handles."""
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
            "poseidon_flattened", None, [],
            np.concatenate([states, outputs, inters.T], axis=1))
        return outputs
