# Copied from boojum_tpu/gadgets/poseidon2_circuit.py.
"""In-circuit Poseidon2 permutation (for the recursive transcript/tree).

Reference behavior: src/gadgets/poseidon2/mod.rs (circuit form of the
permutation via MatrixMultiplicationGate + sbox fmas; the flattened gate is a
later optimization). Constants shared with the host permutation
(hash/_poseidon_constants.py); output equality with the host permutation is
tested chunk by chunk.
"""

from __future__ import annotations

import numpy as np

from ..cs.cs import ConstraintSystem
from ..cs.gates.arith import MatrixMultiplicationGate
from ..hash import _poseidon_constants as C
from .num import CircuitOps

_RC = C.ALL_ROUND_CONSTANTS
_SHIFTS = C.INNER_DIAGONAL_SHIFTS
_BLOCK = C.EXTERNAL_MDS_BLOCK


def _external_matrix():
    m = [[0] * 12 for _ in range(12)]
    for br in range(3):
        for bc in range(3):
            for r in range(4):
                for c in range(4):
                    m[br * 4 + r][bc * 4 + c] = \
                        _BLOCK[r][c] * (2 if br == bc else 1)
    return m


def _internal_matrix():
    m = [[1] * 12 for _ in range(12)]
    for i in range(12):
        m[i][i] = (1 << _SHIFTS[i]) + 1
    return m


EXTERNAL_MATRIX = _external_matrix()
INTERNAL_MATRIX = _internal_matrix()


def allow_poseidon2_gates(cs: ConstraintSystem, flattened: bool = False):
    """flattened=True uses Poseidon2FlattenedGate (one 130-variable instance
    per permutation, needs >= 130 copy columns) instead of per-round
    MatrixMultiplication gates — ~40x fewer rows per permutation."""
    if flattened:
        from ..cs.gates import Poseidon2FlattenedGate
        assert cs.geometry.num_columns_under_copy_permutation >= 130
        assert cs.geometry.max_allowed_constraint_degree >= 7
        cs.allow_gate(Poseidon2FlattenedGate)
        return
    ext_ev = MatrixMultiplicationGate.make_evaluator((12, EXTERNAL_MATRIX))
    ext_ev.name = "matrix_mul_ext_12"
    cs.allow_evaluator(ext_ev)
    int_ev = MatrixMultiplicationGate.make_evaluator((12, INTERNAL_MATRIX))
    int_ev.name = "matrix_mul_internal_12"
    cs.allow_evaluator(int_ev)


class Poseidon2Circuit:
    def __init__(self, cs: ConstraintSystem, ops: CircuitOps = None):
        self.cs = cs
        self.ops = ops or CircuitOps(cs)

    def _sbox(self, x: int) -> int:
        ops = self.ops
        x2 = ops.mul(x, x)
        x3 = ops.mul(x2, x)
        x4 = ops.mul(x2, x2)
        return ops.mul(x3, x4)

    def _matmul(self, name: str, matrix, state: list) -> list:
        out = MatrixMultiplicationGate.multiply_batch(
            self.cs, name, matrix,
            np.asarray([[v] for v in state], np.uint64))
        return [int(out[i, 0]) for i in range(12)]

    def permutation(self, state: list) -> list:
        """state: 12 variable handles -> 12 variable handles."""
        ops = self.ops
        assert len(state) == 12
        if "poseidon2_flattened" in self.cs.placement_strategy:
            from ..cs.gates import Poseidon2FlattenedGate
            out = Poseidon2FlattenedGate.compute_round_function_batch(
                self.cs, np.asarray([state], np.uint64))
            return [int(v) for v in out[0]]
        st = self._matmul("matrix_mul_ext_12", EXTERNAL_MATRIX, state)
        r = 0
        for _ in range(4):
            st = [ops.add(st[i], ops.from_int(_RC[r * 12 + i])) for i in range(12)]
            st = [self._sbox(v) for v in st]
            st = self._matmul("matrix_mul_ext_12", EXTERNAL_MATRIX, st)
            r += 1
        for _ in range(22):
            st = list(st)
            st[0] = self._sbox(ops.add(st[0], ops.from_int(_RC[r * 12])))
            st = self._matmul("matrix_mul_internal_12", INTERNAL_MATRIX, st)
            r += 1
        for _ in range(4):
            st = [ops.add(st[i], ops.from_int(_RC[r * 12 + i])) for i in range(12)]
            st = [self._sbox(v) for v in st]
            st = self._matmul("matrix_mul_ext_12", EXTERNAL_MATRIX, st)
            r += 1
        return st
