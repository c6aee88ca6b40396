"""The port's copy of the SHA-256 circuit (the flagship's) against hashlib
and against the JAX package's circuit: same digest, same setup arrays, same
witness columns."""

import hashlib

import numpy as np

from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.prover.prover import \
    materialize_witness_columns as ref_materialize
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.gadgets.sha256 import build_sha256_circuit
from boojum_tpu_torch.prover.prover import materialize_witness_columns
from tests.test_sha256 import build_sha256_circuit as ref_build


def test_sha256_circuit_matches_hashlib_and_reference():
    data = bytes(np.random.default_rng(42).integers(0, 256, 20, dtype=np.uint8))
    cs, out = build_sha256_circuit(data)
    assert bytes(int(cs.get_value(int(v))) for v in out) == \
        hashlib.sha256(data).digest()
    ref_cs, _ = ref_build(data)
    cs.pad_and_shrink()
    ref_cs.pad_and_shrink()
    assert cs.check_if_satisfied()

    sb, ref_sb = create_base_setup(cs), ref_create_base_setup(ref_cs)
    for name in ("copy_permutation_polys", "constant_columns",
                 "lookup_tables_columns"):
        assert np.array_equal(getattr(sb, name), getattr(ref_sb, name)), name
    assert sb.selector_paths == ref_sb.selector_paths
    assert sb.quotient_degree == ref_sb.quotient_degree
    assert sb.domain_size == ref_sb.domain_size == 1 << 14

    n = sb.domain_size
    for got, want in zip(materialize_witness_columns(cs, n),
                         ref_materialize(ref_cs, n)):
        assert np.array_equal(got, want)
