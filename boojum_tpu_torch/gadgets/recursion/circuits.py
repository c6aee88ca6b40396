# Port of the recursion configuration's circuits: tests/test_prove_verify.py:build_small_circuit and scripts/bench_suite.py:bench_recursion_outer.
"""The two circuits of the recursion configuration (BASELINE config 2).

`build_inner_circuit` is the inner circuit (FMA, reduction, constant,
boolean, selection and two public inputs over 16 copy columns), drawing its
values from ``rng`` in the reference test's order, so that
``np.random.default_rng(11)`` gives the reference's circuit.
`build_outer_circuit` is the circuit that verifies a proof of it: 132 copy
columns, 8 constant columns, degree 8, the flattened Poseidon and Poseidon2
gates, `recursive_verify` over the allocated proof.
"""

from __future__ import annotations

import numpy as np

from ...cs import ConstraintSystem, CSConfig, CSGeometry
from ...cs.gates import (BooleanConstraintGate, ConstantsAllocatorGate,
                         FmaGate, FmaGateInExtension, NopGate,
                         PublicInputGate, ReductionGate, SelectionGate,
                         ZeroCheckGate)
from ...utils import npgl
from ..poseidon2_circuit import allow_poseidon2_gates
from .primitives import allow_poseidon_gates
from .verifier import AllocatedProof, recursive_verify

P = npgl.ORDER

INNER_GEOMETRY = CSGeometry(num_columns_under_copy_permutation=16,
                            num_witness_columns=0, num_constant_columns=4,
                            max_allowed_constraint_degree=4)
OUTER_GEOMETRY = CSGeometry(num_columns_under_copy_permutation=132,
                            num_witness_columns=0, num_constant_columns=8,
                            max_allowed_constraint_degree=8)


def build_inner_circuit(rng):
    """tests/test_prove_verify.py:build_small_circuit() (no lookups, two
    public inputs, 30 FMAs) with an explicit ``rng``, padded twice as
    scripts/bench_suite.py does, which doubles its domain from 2^4 to 2^5;
    returns the constraint system."""
    n_fma = 30
    cs = ConstraintSystem(INNER_GEOMETRY, 1 << 10, CSConfig.dev())
    for g in (ConstantsAllocatorGate, FmaGate):
        cs.allow_gate(g)
    cs.allow_gate(ReductionGate, params=4)
    for g in (BooleanConstraintGate, SelectionGate, PublicInputGate, NopGate):
        cs.allow_gate(g)

    a = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    b = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    c = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    d = FmaGate.compute_fma_batch(cs, 3, (a, b), 5, c)
    e = ReductionGate.reduce_terms_batch(
        cs, [1, 2, 3, 4], np.stack([a[:8], b[:8], c[:8], d[:8]]))
    ConstantsAllocatorGate.allocate_constant(cs, 1234)
    bits = BooleanConstraintGate.allocate_batch(cs, [1, 0, 1, 1])
    SelectionGate.select_batch(cs, a[:4], b[:4], bits)
    PublicInputGate.place(cs, int(d[0]))
    PublicInputGate.place(cs, int(e[0]))
    cs.pad_and_shrink()
    cs.pad_and_shrink()
    return cs


def outer_constraint_system(max_trace_len=1 << 17):
    """An empty constraint system of the outer geometry with the gates the
    recursive verifier places."""
    cs = ConstraintSystem(OUTER_GEOMETRY, max_trace_len, CSConfig.dev())
    for g in (ConstantsAllocatorGate, FmaGate, NopGate, BooleanConstraintGate,
              SelectionGate, ZeroCheckGate, FmaGateInExtension):
        cs.allow_gate(g)
    cs.allow_gate(ReductionGate, params=4)
    allow_poseidon2_gates(cs, flattened=True)
    allow_poseidon_gates(cs, flattened=True)
    return cs


def build_outer_circuit(vk, proof, proof_config, transcript_kind="poseidon",
                        hasher="poseidon2", max_trace_len=1 << 17):
    """The circuit that verifies ``proof`` against ``vk`` (made under
    ``proof_config``) in-circuit; returns the padded constraint system. An
    invalid proof gives an unsatisfied circuit."""
    cs = outer_constraint_system(max_trace_len)
    alloc = AllocatedProof.allocate(cs, proof)
    recursive_verify(cs, vk, alloc, proof_config, transcript_kind, hasher)
    cs.pad_and_shrink()
    return cs
