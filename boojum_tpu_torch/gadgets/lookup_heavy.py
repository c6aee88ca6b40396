# Port of scripts/bench_suite.py:84-118 (bench_lookup_heavy's circuit, built with the port's modules).
"""The lookup-heavy circuit (BASELINE config 4): about a million byte-op
lookups through the binop table.

Each lookup is (a, b, (a ^ b) << 32 | (a | b) << 16 | (a & b)) for random
bytes a, b, enforced against `tables.create_binop_table` (2^16 rows), in a
geometry of 32 copy columns, no witness columns, 4 constant columns and
degree 4, with the ConstantsAllocator, Fma and Nop gates, on at most 2^17
rows. ``mode="specialized"`` takes the reference configuration's lookups,
width 3 in 8 specialized repetitions with a shared constant table id;
``mode="general"`` places the same lookups on general-purpose rows under
the lookup marker gate, `LookupParameters.table_id_as_constant(width=3)`
(10 subarguments a row), and changes nothing else.
"""

from __future__ import annotations

import numpy as np

from ..cs import ConstraintSystem, CSConfig, CSGeometry, LookupParameters
from ..cs.gates import ConstantsAllocatorGate, FmaGate, NopGate
from . import tables

MAX_TRACE_LEN = 1 << 17
# 8 specialized repetitions a row: the headroom leaves room for the
# constants rows, so that the trace stays at 2^17 rows
DEFAULT_LOOKUPS = (1 << 20) - 1024


def build_lookup_heavy_circuit(n_lookups=DEFAULT_LOOKUPS, seed=11,
                               mode="specialized"):
    """The padded constraint system of ``n_lookups`` binop lookups of bytes
    drawn from ``np.random.default_rng(seed)``, in lookup ``mode``
    ("specialized" or "general")."""
    if mode == "specialized":
        lookup = LookupParameters.specialized_with_table_id_as_constant(
            width=3, num_repetitions=8, share_table_id=True)
    elif mode == "general":
        lookup = LookupParameters.table_id_as_constant(width=3)
    else:
        raise ValueError("mode must be 'specialized' or 'general', not %r"
                         % (mode,))
    rng = np.random.default_rng(seed)
    geom = CSGeometry(num_columns_under_copy_permutation=32,
                      num_witness_columns=0, num_constant_columns=4,
                      max_allowed_constraint_degree=4)
    cs = ConstraintSystem(geom, MAX_TRACE_LEN, CSConfig.dev())
    cs.allow_lookup(lookup)
    for g in (ConstantsAllocatorGate, FmaGate, NopGate):
        cs.allow_gate(g)
    tid = cs.add_lookup_table(tables.create_binop_table())
    a = rng.integers(0, 256, n_lookups, dtype=np.uint64)
    b = rng.integers(0, 256, n_lookups, dtype=np.uint64)
    packed = ((a ^ b) << np.uint64(32)) | ((a | b) << np.uint64(16)) | (a & b)
    av = cs.alloc_variables_with_values(a)
    bv = cs.alloc_variables_with_values(b)
    cv = cs.alloc_variables_with_values(packed)
    cs.enforce_lookup_batch(tid, np.stack([av, bv, cv]))
    cs.pad_and_shrink()
    return cs
