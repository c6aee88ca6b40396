"""The small lookup circuit of tests/test_prove_verify.py, written against
either package's circuit modules. A module without JAX: the spawned ranks
of tests/test_torch_parallel.py build it from the port alone."""

import importlib

import numpy as np

P = 0xFFFFFFFF00000001


def build_small_circuit(pkg: str, rng, n_fma=30):
    """tests/test_prove_verify.py:build_small_circuit(with_lookup=True),
    written against either package's circuit modules."""
    csm = importlib.import_module(pkg + ".cs")
    g = importlib.import_module(pkg + ".cs.gates")
    geom = csm.CSGeometry(num_columns_under_copy_permutation=16,
                          num_witness_columns=0, num_constant_columns=4,
                          max_allowed_constraint_degree=4)
    cs = csm.ConstraintSystem(geom, 1 << 10, csm.CSConfig.dev())
    cs.allow_lookup(csm.LookupParameters.specialized_with_table_id_as_constant(
        width=3, num_repetitions=2, share_table_id=True))
    cs.allow_gate(g.ConstantsAllocatorGate)
    cs.allow_gate(g.FmaGate)
    cs.allow_gate(g.ReductionGate, params=4)
    cs.allow_gate(g.BooleanConstraintGate)
    cs.allow_gate(g.SelectionGate)
    cs.allow_gate(g.PublicInputGate)
    cs.allow_gate(g.NopGate)
    rows = [(a, b, a ^ b) for a in range(8) for b in range(8)]
    tid = cs.add_lookup_table(csm.LookupTable("xor3", np.asarray(rows, np.uint64),
                                              num_keys=2))
    a = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    b = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    c = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    d = g.FmaGate.compute_fma_batch(cs, 3, (a, b), 5, c)
    e = g.ReductionGate.reduce_terms_batch(
        cs, [1, 2, 3, 4], np.stack([a[:8], b[:8], c[:8], d[:8]]))
    g.ConstantsAllocatorGate.allocate_constant(cs, 1234)
    bits = g.BooleanConstraintGate.allocate_batch(cs, [1, 0, 1, 1])
    g.SelectionGate.select_batch(cs, a[:4], b[:4], bits)
    la = cs.alloc_variables_with_values([1, 2, 3, 7, 5])
    lb = cs.alloc_variables_with_values([6, 2, 1, 7, 0])
    lo = cs.alloc_variables_with_values([1 ^ 6, 0, 3 ^ 1, 0, 5])
    cs.enforce_lookup_batch(tid, np.stack([la, lb, lo]))
    g.PublicInputGate.place(cs, int(d[0]))
    g.PublicInputGate.place(cs, int(e[0]))
    cs.pad_and_shrink()
    return cs
