"""The port's recursion layer against the JAX package: the circuit ops
(`CircuitOps`, `CircuitExt2Ops`) against the JAX ones, `Poseidon2Circuit` and
`CircuitTranscript` against the host permutations and transcripts, and the
recursion configuration (BASELINE config 2) as a whole: the JAX inner proof,
carried across through JSON, gives the port an outer circuit with the JAX
one's values, setup and witness columns, which is satisfied and becomes
unsatisfied over a corrupted inner proof; the port's CPU `DeviceProver` gives
the JAX inner proof's bytes. The outer proof's bytes are held in one test
marked slow (the JAX host prove alone takes over a minute on a CPU)."""

import copy

import numpy as np
import pytest

import scripts.torch_reference_digest as trd
from boojum_tpu.cs import gates as ref_gates
from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.gadgets import num as ref_num
from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.prover import create_setup_and_vk, prove
from boojum_tpu.prover.proof import proof_to_json as ref_proof_to_json
from boojum_tpu.prover.prover import \
    materialize_witness_columns as ref_materialize
from boojum_tpu.verifier import verify as ref_verify
from boojum_tpu_torch import transcript as host_transcript
from boojum_tpu_torch.cs import ConstraintSystem, CSConfig, CSGeometry
from boojum_tpu_torch.cs import gates
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.gadgets import num
from boojum_tpu_torch.gadgets.poseidon2_circuit import (Poseidon2Circuit,
                                                        allow_poseidon2_gates)
from boojum_tpu_torch.gadgets.recursion import circuits
from boojum_tpu_torch.gadgets.recursion.primitives import (
    CircuitTranscript, allow_poseidon_gates)
from boojum_tpu_torch.hash import poseidon2
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     prepare_setup_and_vk, prove_one_shot)
from boojum_tpu_torch.prover.proof import proof_to_json
from boojum_tpu_torch.prover.prover import materialize_witness_columns
from boojum_tpu_torch.prover.serialization import proof_from_json
from boojum_tpu_torch.verifier import verify
from tests.test_recursion import make_outer_cs as ref_make_outer_cs
from tests.torch_small_circuit import jitted_reference

P = (1 << 64) - (1 << 32) + 1
INNER_CFG = trd.INNER_CONFIG
OUTER_CFG = trd.CONFIG
SB_ARRAYS = ("copy_permutation_polys", "constant_columns",
             "lookup_tables_columns")
SB_FIELDS = ("selector_paths", "quotient_degree", "domain_size",
             "public_inputs")


def make_outer_cs(max_trace):
    """tests/test_recursion.py:make_outer_cs in the port (60 columns,
    degree 4, per-round Poseidon gates)."""
    geom = CSGeometry(num_columns_under_copy_permutation=60,
                      num_witness_columns=0, num_constant_columns=8,
                      max_allowed_constraint_degree=4)
    cs = ConstraintSystem(geom, max_trace, CSConfig.dev())
    for g in (gates.ConstantsAllocatorGate, gates.FmaGate, gates.NopGate,
              gates.BooleanConstraintGate, gates.SelectionGate,
              gates.ZeroCheckGate, gates.FmaGateInExtension):
        cs.allow_gate(g)
    cs.allow_gate(gates.ReductionGate, params=4)
    allow_poseidon2_gates(cs)
    allow_poseidon_gates(cs)
    return cs


def test_circuit_ops_match_jax():
    """tests/test_recursion.py:test_circuit_ext_ops on both packages: every
    op of `CircuitOps` and `CircuitExt2Ops` gives the JAX circuit's values
    and placements."""
    rng = np.random.default_rng(21)
    vals = [int(v) for v in rng.integers(0, P, 5, dtype=np.uint64)]
    out = []
    for pkg_num, pkg_gates, cs in (
            (num, gates, make_outer_cs(1 << 10)),
            (ref_num, ref_gates, ref_make_outer_cs(1 << 10))):
        ops, eops = pkg_num.CircuitOps(cs), pkg_num.CircuitExt2Ops(cs)
        v = [cs.alloc_variable_with_value(x) for x in vals]
        a, b = (v[0], v[1]), (v[2], v[3])
        got = [ops.add(v[0], v[1]), ops.sub(v[0], v[1]), ops.mul(v[0], v[1]),
               ops.mul_add(v[0], v[1], v[2]), ops.scale(5, v[3]),
               ops.inverse(v[4]), *eops.mul(a, b), *eops.add(a, b),
               *eops.sub(a, b), *eops.mul_by_base(a, v[4]), *eops.inverse(a)]
        bit = pkg_gates.BooleanConstraintGate.allocate_batch(cs, [1])
        got += eops.select(int(bit[0]), a, b)
        cs.pad_and_shrink()
        assert cs.check_if_satisfied()
        out.append(([cs.get_value(x) for x in got], cs.final_trace_len,
                    cs.next_place_idx))
    assert out[0] == out[1]
    values = out[0][0]
    assert values[2] == vals[0] * vals[1] % P
    assert values[5] * vals[4] % P == 1
    assert values[-2:] == vals[:2]  # select(1, a, b) == a


@pytest.mark.parametrize("flattened", [False, True])
def test_poseidon2_circuit_matches_host_permutation(flattened):
    rng = np.random.default_rng(5)
    state = [int(v) for v in rng.integers(0, P, 12, dtype=np.uint64)]
    cs = (circuits.outer_constraint_system(1 << 12) if flattened
          else make_outer_cs(1 << 12))
    out = Poseidon2Circuit(cs).permutation(
        [cs.alloc_variable_with_value(x) for x in state])
    assert [cs.get_value(v) for v in out] == poseidon2.s_permutation(state)
    cs.pad_and_shrink()
    assert cs.check_if_satisfied()


@pytest.mark.parametrize("kind", ["poseidon", "poseidon2"])
def test_circuit_transcript_matches_host(kind):
    """Absorbs of 0, 3, 8 and 13 elements, single and multiple challenges,
    against the host transcript; flattened gates, satisfied."""
    rng = np.random.default_rng(9)
    cs = circuits.outer_constraint_system(1 << 12)
    ops = num.CircuitOps(cs)
    tr = CircuitTranscript(cs, ops, kind)
    host = host_transcript.make_transcript(kind)
    got, want = [], []
    for k in (3, 0, 8, 13):
        els = [int(v) for v in rng.integers(0, P, k, dtype=np.uint64)]
        tr.witness_field_elements([ops.alloc_witness(x) for x in els])
        host.witness_field_elements(els)
        got += [cs.get_value(v) for v in tr.get_multiple_challenges(2)]
        want += host.get_multiple_challenges(2)
        got.append(cs.get_value(tr.get_challenge()))
        want.append(host.get_challenge())
    assert got == want
    cs.pad_and_shrink()
    assert cs.check_if_satisfied()


@pytest.fixture(scope="module")
def config2():
    """The recursion configuration's inner circuit and proof on both sides:
    the JAX host proof (`scripts/torch_reference_digest.py`'s functions,
    the ones of its digest file), carried into the port through JSON, and
    the JAX outer circuit over it."""
    with jitted_reference():
        ref_inner, ref_art, ref_proof = trd.reference_inner()
    inner = circuits.build_inner_circuit(np.random.default_rng(trd.INNER_SEED))
    art = prepare_setup_and_vk(inner, ProofConfig(**INNER_CFG), device="cpu")
    proof = proof_from_json(ref_proof_to_json(ref_proof))
    return dict(ref_art=ref_art, ref_proof=ref_proof,
                ref_outer=trd.reference_outer(ref_art.vk, ref_proof),
                inner=inner, art=art, proof=proof,
                outer=circuits.build_outer_circuit(
                    art.vk, proof, ProofConfig(**INNER_CFG)))


def test_inner_setup_and_proof_match_jax(config2):
    """The port's inner circuit is the JAX one (2^5 rows, two public
    inputs); its CPU DeviceProver gives the JAX host proof's bytes, through
    the host witness path, and the port's verify accepts it."""
    inner, art = config2["inner"], config2["art"]
    assert inner.final_trace_len == 32 and len(inner.public_inputs) == 2
    assert art.vk.setup_merkle_tree_cap == \
        config2["ref_art"].vk.setup_merkle_tree_cap
    prover = DeviceProver(inner, art, ProofConfig(**INNER_CFG), device="cpu")
    proof = prover.prove("poseidon", "poseidon2")
    assert prover.witness_program() is None
    assert proof_to_json(proof) == ref_proof_to_json(config2["ref_proof"])
    assert verify(art.vk, proof, "poseidon", "poseidon2")


def test_outer_circuit_matches_jax_and_is_satisfied(config2):
    outer, ref_outer = config2["outer"], config2["ref_outer"]
    assert outer.final_trace_len == ref_outer.final_trace_len == 4096
    k = outer.next_place_idx
    assert k == ref_outer.next_place_idx
    assert np.array_equal(outer.resolver.values[:k],
                          ref_outer.resolver.values[:k])
    assert outer.check_if_satisfied()
    sb, ref_sb = create_base_setup(outer), ref_create_base_setup(ref_outer)
    for name in SB_ARRAYS:
        assert np.array_equal(getattr(sb, name), getattr(ref_sb, name)), name
    for name in SB_FIELDS:
        assert getattr(sb, name) == getattr(ref_sb, name), name
    n = sb.domain_size
    for got, want in zip(materialize_witness_columns(outer, n),
                         ref_materialize(ref_outer, n)):
        assert np.array_equal(got, want)


def test_corrupted_inner_proof_unsatisfies_outer(config2):
    """tests/test_recursion.py:80-90: one element of values_at_z bumped."""
    bad = copy.deepcopy(config2["proof"])
    v = list(bad.values_at_z[2])
    v[0] = (v[0] + 1) % P
    bad.values_at_z[2] = tuple(v)
    outer = circuits.build_outer_circuit(config2["art"].vk, bad,
                                         ProofConfig(**INNER_CFG))
    assert not outer.check_if_satisfied(verbose=False)


def test_prove_one_shot_defaults_to_the_gpu(config2):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        prove_one_shot(config2["inner"], ProofConfig(**INNER_CFG),
                       "poseidon", "poseidon2")


@pytest.mark.slow
def test_outer_proof_is_byte_identical(config2):
    """The outer proof (4096 rows, 132 columns, degree 8) by the port's CPU
    DeviceProver against the JAX host prove: the same bytes, and both
    verifiers accept it."""
    ref_outer = config2["ref_outer"]
    ref_cfg = RefProofConfig(**OUTER_CFG)
    ref_art = create_setup_and_vk(ref_outer, ref_create_base_setup(ref_outer),
                                  ref_cfg, "poseidon2")
    ref_proof = prove(ref_outer, ref_art, ref_cfg, "poseidon", "poseidon2")
    proof, vk = prove_one_shot(config2["outer"], ProofConfig(**OUTER_CFG),
                               "poseidon", "poseidon2", device="cpu")
    assert proof_to_json(proof) == ref_proof_to_json(ref_proof)
    assert verify(vk, proof, "poseidon", "poseidon2")
    assert ref_verify(ref_art.vk, proof, "poseidon", "poseidon2")
