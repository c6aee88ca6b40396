# Copied from boojum_tpu/gadgets/recursion/primitives.py.
"""Recursion primitives: in-circuit classic Poseidon, circuit transcript,
bit decomposition, in-circuit Merkle verification.

Reference behavior: src/gadgets/recursion/ — recursive_transcript.rs
(CircuitTranscript mirrors AlgebraicSpongeBasedTranscript over Num),
recursive_tree_hasher.rs (CircuitTreeHasher), and the index-bit handling in
recursive_verifier.rs. The inner proofs here use the classic-Poseidon
transcript + Poseidon2 tree (the reference's recursive bench combination,
sha256/mod.rs:286-294).
"""

from __future__ import annotations

import numpy as np

from ...cs.cs import ConstraintSystem
from ...cs.gates import BooleanConstraintGate, FmaGate, ReductionGate, SelectionGate
from ...cs.gates.arith import MatrixMultiplicationGate
from ...hash import _poseidon_constants as C
from ...utils import npgl
from ..num import CircuitOps
from ..poseidon2_circuit import Poseidon2Circuit, allow_poseidon2_gates

P = npgl.ORDER

_RC = C.ALL_ROUND_CONSTANTS
_EXPS = C.MDS_MATRIX_EXPS
_POSEIDON_MDS = [[1 << _EXPS[(12 - r + c) % 12] for c in range(12)]
                 for r in range(12)]


def allow_poseidon_gates(cs: ConstraintSystem, flattened: bool = False):
    """flattened=True uses PoseidonFlattenedGate (one 130-variable instance
    per permutation; needs >= 130 copy columns and degree >= 7)."""
    if flattened:
        from ...cs.gates import PoseidonFlattenedGate
        assert cs.geometry.num_columns_under_copy_permutation >= 130
        assert cs.geometry.max_allowed_constraint_degree >= 7
        cs.allow_gate(PoseidonFlattenedGate)
        return
    ev = MatrixMultiplicationGate.make_evaluator((12, _POSEIDON_MDS))
    ev.name = "matrix_mul_poseidon_12"
    cs.allow_evaluator(ev)


class PoseidonCircuit:
    """In-circuit CLASSIC Poseidon permutation (transcript round function;
    reference poseidon_goldilocks_naive.rs semantics)."""

    def __init__(self, cs: ConstraintSystem, ops: CircuitOps = None):
        self.cs = cs
        self.ops = ops or CircuitOps(cs)

    def _sbox(self, x: int) -> int:
        ops = self.ops
        x2 = ops.mul(x, x)
        x3 = ops.mul(x2, x)
        x4 = ops.mul(x2, x2)
        return ops.mul(x3, x4)

    def _mds(self, state: list) -> list:
        out = MatrixMultiplicationGate.multiply_batch(
            self.cs, "matrix_mul_poseidon_12", _POSEIDON_MDS,
            np.asarray([[v] for v in state], np.uint64))
        return [int(out[i, 0]) for i in range(12)]

    def permutation(self, state: list) -> list:
        ops = self.ops
        if "poseidon_flattened" in self.cs.placement_strategy:
            from ...cs.gates import PoseidonFlattenedGate
            out = PoseidonFlattenedGate.compute_round_function_batch(
                self.cs, np.asarray([state], np.uint64))
            return [int(v) for v in out[0]]
        r = 0
        st = list(state)
        for _ in range(4):
            st = [ops.add(st[i], ops.from_int(_RC[r * 12 + i])) for i in range(12)]
            st = [self._sbox(v) for v in st]
            st = self._mds(st)
            r += 1
        for _ in range(22):
            st = [ops.add(st[i], ops.from_int(_RC[r * 12 + i])) for i in range(12)]
            st = [self._sbox(st[0])] + st[1:]
            st = self._mds(st)
            r += 1
        for _ in range(4):
            st = [ops.add(st[i], ops.from_int(_RC[r * 12 + i])) for i in range(12)]
            st = [self._sbox(v) for v in st]
            st = self._mds(st)
            r += 1
        return st


class CircuitTranscript:
    """In-circuit twin of AlgebraicTranscript (overwrite sponge, rate 8,
    rescue-prime padding)."""

    def __init__(self, cs: ConstraintSystem, ops: CircuitOps,
                 permutation: str = "poseidon"):
        self.cs = cs
        self.ops = ops
        self.perm = (PoseidonCircuit(cs, ops) if permutation == "poseidon"
                     else Poseidon2Circuit(cs, ops)).permutation
        zero = ops.from_int(0)
        self.state = [zero] * 12
        self.buffer: list[int] = []
        self.available: list[int] = []

    def witness_field_elements(self, els: list):
        self.buffer.extend(els)

    def witness_merkle_tree_cap(self, cap):
        for el in cap:
            self.witness_field_elements(list(el))

    def get_challenge(self) -> int:
        if not self.buffer:
            if self.available:
                return self.available.pop(0)
            self.state = self.perm(self.state)
            self.available = list(self.state[:8])
            return self.get_challenge()
        to_absorb = self.buffer + [self.ops.one()]
        self.buffer = []
        zero = self.ops.from_int(0)
        while len(to_absorb) % 8 != 0:
            to_absorb.append(zero)
        for i in range(0, len(to_absorb), 8):
            self.state = to_absorb[i:i + 8] + self.state[8:]
            self.state = self.perm(self.state)
        self.available = list(self.state[:8])
        return self.get_challenge()

    def get_multiple_challenges(self, k: int) -> list:
        return [self.get_challenge() for _ in range(k)]


def decompose_bits(cs: ConstraintSystem, ops: CircuitOps, v: int,
                   num_bits: int = 64, enforce_canonical: bool = True):
    """Allocate the LSB-first bit decomposition of a variable, constrained
    by booleanity + recomposition (+ canonical-representative check:
    value < p iff NOT(hi32 == 2^32-1 AND lo32 != 0))."""
    bits = cs.alloc_variables(num_bits)

    def fn(vals):
        x = int(vals[0, 0])
        return np.asarray([(x >> i) & 1 for i in range(num_bits)], np.uint64)

    cs.set_values_with_dependencies(np.asarray([[v]], np.uint64), bits, fn)
    BooleanConstraintGate.enforce_batch(cs, bits)
    acc = _recompose(cs, ops, [int(b) for b in bits])
    ops.enforce_equal(acc, v)

    if enforce_canonical and num_bits == 64:
        lo32 = _recompose(cs, ops, [int(b) for b in bits[:32]])
        hi32 = _recompose(cs, ops, [int(b) for b in bits[32:]])
        # is_max = (hi32 == 2^32 - 1); require is_max * lo32 == 0
        from ...cs.gates import ZeroCheckGate
        diff = ops.sub(hi32, ops.from_int(0xFFFFFFFF))
        is_max = ZeroCheckGate.is_zero_batch(cs, [diff])
        prod = ops.mul(int(is_max[0]), lo32)
        ops.enforce_zero(prod)
    return [int(b) for b in bits]


def _recompose(cs, ops, bit_vars: list) -> int:
    acc = None
    shift = 0
    rest = list(bit_vars)
    zero = ops.from_int(0)
    while rest or acc is None:
        group = rest[:3] if acc is not None else rest[:4]
        if acc is not None:
            coeffs = [1] + [1 << (shift + i) for i in range(len(group))]
            terms = [acc] + group
        else:
            coeffs = [1 << i for i in range(len(group))]
            terms = list(group)
        while len(terms) < 4:
            terms.append(zero)
            coeffs.append(0)
        acc = ReductionGate.reduce_terms(cs, coeffs, terms)
        shift += len(group)
        rest = rest[len(group):]
    return acc


def select_by_bits(cs: ConstraintSystem, values: list, bits: list):
    """Multiplex a list of circuit values (vars or tuples of vars) by index
    bits (LSB first) using Selection gates, log-levels."""
    level = list(values)
    for b in bits:
        nxt = []
        for i in range(0, len(level), 2):
            lo = level[i]
            hi = level[i + 1] if i + 1 < len(level) else level[i]
            if isinstance(lo, tuple):
                sel = tuple(
                    int(SelectionGate.select_batch(
                        cs, np.asarray([h], np.uint64),
                        np.asarray([l], np.uint64), b)[0])
                    for l, h in zip(lo, hi))
            else:
                sel = int(SelectionGate.select_batch(
                    cs, np.asarray([hi], np.uint64),
                    np.asarray([lo], np.uint64), b)[0])
            nxt.append(sel)
        level = nxt
    assert len(level) == 1
    return level[0]


class CircuitMerkle:
    """In-circuit Merkle path verification against a cap of constants or
    allocated cap nodes."""

    def __init__(self, cs: ConstraintSystem, ops: CircuitOps,
                 permutation: str = "poseidon2"):
        self.cs = cs
        self.ops = ops
        self.p2 = (Poseidon2Circuit(cs, ops) if permutation == "poseidon2"
                   else PoseidonCircuit(cs, ops))

    def hash_leaf(self, values: list) -> list:
        """Sponge leaf hash (overwrite mode) -> 4 vars."""
        ops = self.ops
        zero = ops.from_int(0)
        state = [zero] * 12
        chunks = [values[i:i + 8] for i in range(0, len(values), 8)]
        for chunk in chunks:
            chunk = list(chunk)
            if len(chunk) < 8:
                chunk.extend([zero] * (8 - len(chunk)))
            state = chunk + state[8:]
            state = self.p2.permutation(state)
        return state[:4]

    def hash_node(self, left: list, right: list) -> list:
        zero = self.ops.from_int(0)
        state = list(left) + list(right) + [zero] * 4
        state = self.p2.permutation(state)
        return state[:4]

    def verify_path(self, leaf_hash: list, path: list, cap: list,
                    index_bits: list, cap_is_constant: bool = True):
        """leaf_hash: 4 vars; path: list of 4-var sibling nodes; cap: list of
        4-tuples (ints when cap_is_constant, else var handles); index_bits:
        LSB-first bits covering path levels + cap selection. Enforces
        equality of the recomputed node with the selected cap element."""
        cs = self.cs
        ops = self.ops
        current = list(leaf_hash)
        for lvl, sibling in enumerate(path):
            bit = index_bits[lvl]
            new = []
            for k in range(4):
                # bit==1 -> current is the RIGHT child
                l = int(SelectionGate.select_batch(
                    cs, np.asarray([sibling[k]], np.uint64),
                    np.asarray([current[k]], np.uint64), bit)[0])
                r = int(SelectionGate.select_batch(
                    cs, np.asarray([current[k]], np.uint64),
                    np.asarray([sibling[k]], np.uint64), bit)[0])
                new.append((l, r))
            current = self.hash_node([l for (l, _) in new], [r for (_, r) in new])
        cap_bits = index_bits[len(path):]
        if cap_is_constant:
            cap_vals = [tuple(ops.from_int(int(x)) for x in el) for el in cap]
        else:
            cap_vals = [tuple(el) for el in cap]
        chosen = select_by_bits(cs, cap_vals, cap_bits)
        for k in range(4):
            ops.enforce_equal(current[k], chosen[k])
