"""The port's proof formats and its Poseidon gates against the JAX package.

- The checked-in fixture `tests/fixtures/{proof,vk}.json` (the repo's own
  JSON schema, a Poseidon2 proof of the small lookup circuit) verifies with
  the port's `verify`, which rejects the four corruptions of
  tests/test_era_compat.py; both JSON texts round-trip byte for byte through
  the port's `vk_from_json` / `proof_from_json`.
- The era-boojum reference schema (`compat/era.py`): the port's export of
  the fixture's VK and proof equals the JAX package's, and its import reads
  both back to the same objects.
- `era.ERA_PRODUCTION_GATES`: the port builds the evaluators the era
  production VK names, with the reference's names, term counts and degrees;
  the Poseidon2 and Poseidon flattened gates evaluate to the reference's
  terms on the same random inputs and to zero on their own witness.
- Proving artifacts saved by either package load in the other.
"""

import copy
import json
import os

import numpy as np
import pytest

from boojum_tpu.compat import era as ref_era
from boojum_tpu.cs.gates import poseidon2_gate as ref_p2g
from boojum_tpu.cs.gates import poseidon_gate as ref_pg
from boojum_tpu.cs.gates.base import NpOps as RefNpOps
from boojum_tpu.cs.gates.base import TraceView as RefTraceView
from boojum_tpu.prover import serialization as ref_ser
from boojum_tpu.verifier.verifier import build_evaluators as ref_build
from boojum_tpu_torch.compat import era
from boojum_tpu_torch.cs.gates import poseidon2_gate as p2g
from boojum_tpu_torch.cs.gates import poseidon_gate as pg
from boojum_tpu_torch.cs.gates.base import NpOps, TraceView
from boojum_tpu_torch.prover import serialization as ser
from boojum_tpu_torch.prover.proof import proof_to_json
from boojum_tpu_torch.verifier import verifier

P = 0xFFFFFFFF00000001
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _read(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def fixture():
    vk_text, proof_text = _read("vk.json"), _read("proof.json")
    return dict(vk_text=vk_text, proof_text=proof_text,
                vk=ser.vk_from_json(vk_text),
                proof=ser.proof_from_json(proof_text),
                ref_vk=ref_ser.vk_from_json(vk_text),
                ref_proof=ref_ser.proof_from_json(proof_text))


def test_fixture_proof_verifies(fixture):
    assert verifier.verify(fixture["vk"], fixture["proof"], "poseidon2",
                           "poseidon2"), verifier.last_failure()


def _corrupt(proof, what):
    bad = copy.deepcopy(proof)
    if what == "query_leaf":
        bad.queries_per_fri_repetition[0].witness_query.leaf_elements[0] ^= 1
    elif what == "value_at_z":
        bad.values_at_z[5] = (bad.values_at_z[5][0] ^ 1, bad.values_at_z[5][1])
    elif what == "public_input":
        bad.public_inputs[0] ^= 1
    else:
        bad.final_fri_monomials[0][0] ^= 1
    return bad


@pytest.mark.parametrize("what", ["query_leaf", "value_at_z", "public_input",
                                  "final_monomial"])
def test_fixture_proof_rejected_on_corruption(fixture, what):
    bad = _corrupt(fixture["proof"], what)
    assert verifier.verify(fixture["vk"], bad, "poseidon2",
                           "poseidon2") is False


def test_fixture_json_roundtrips(fixture):
    assert ser.vk_to_json(fixture["vk"]) == fixture["vk_text"]
    assert proof_to_json(fixture["proof"]) == fixture["proof_text"]


def test_era_proof_schema_equals_reference(fixture):
    got = era.proof_to_reference_json(fixture["proof"])
    assert got == ref_era.proof_to_reference_json(fixture["ref_proof"])
    back = era.proof_from_reference_json(json.loads(json.dumps(got)))
    assert proof_to_json(back) == fixture["proof_text"]


def test_era_vk_schema_equals_reference(fixture):
    got = era.vk_to_reference_json(fixture["vk"])
    assert got == ref_era.vk_to_reference_json(fixture["ref_vk"])
    f = fixture["vk"].fixed_parameters
    gates = era.EraGateConfig(
        evaluator_specs=tuple(f.evaluator_specs),
        specialized_evaluator_specs=tuple(f.specialized_evaluator_specs or ()),
        gate_spec_layout=tuple(f.gate_spec_layout or ()))
    back = era.vk_from_reference_json(json.loads(json.dumps(got)), gates)
    assert era.vk_to_reference_json(back) == got
    assert verifier.verify(back, fixture["proof"], "poseidon2", "poseidon2")


def test_era_production_gates_build_as_reference():
    specs = list(era.ERA_PRODUCTION_GATES.evaluator_specs) + \
        list(era.ERA_PRODUCTION_GATES.specialized_evaluator_specs)
    assert specs == list(ref_era.ERA_PRODUCTION_GATES.evaluator_specs) + \
        list(ref_era.ERA_PRODUCTION_GATES.specialized_evaluator_specs)
    got = verifier.build_evaluators(specs)
    want = ref_build(specs)
    assert [(e.name, e.num_quotient_terms, e.max_constraint_degree,
             e.num_variables) for e in got] == \
        [(e.name, e.num_quotient_terms, e.max_constraint_degree,
          e.num_variables) for e in want]


@pytest.mark.parametrize("gate", ["poseidon2", "poseidon"])
def test_flattened_gate_terms_equal_reference(gate):
    """Random variables: every term equals the reference's; the gate's own
    witness of 3 random states: every term is zero."""
    mod, ref_mod = (p2g, ref_p2g) if gate == "poseidon2" else (pg, ref_pg)
    ev = (mod.Poseidon2FlattenedEvaluator() if gate == "poseidon2"
          else mod.PoseidonFlattenedEvaluator())
    ref_ev = (ref_mod.Poseidon2FlattenedEvaluator() if gate == "poseidon2"
              else ref_mod.PoseidonFlattenedEvaluator())
    rng = np.random.default_rng(31)
    cols = [rng.integers(0, P, 3, dtype=np.uint64)
            for _ in range(mod.NUM_VARIABLES)]
    got = ev.evaluate(TraceView(cols, [], []), NpOps)
    want = ref_ev.evaluate(RefTraceView(cols, [], []), RefNpOps)
    assert len(got) == mod.NUM_TERMS
    assert all(np.array_equal(g, w) for g, w in zip(got, want))

    states = [rng.integers(0, P, 3, dtype=np.uint64) for _ in range(12)]
    inter, out = mod._np_flat_witness(states)
    ref_inter, ref_out = ref_mod._np_flat_witness(states)
    assert all(np.array_equal(a, b) for a, b in zip(inter + out,
                                                    ref_inter + ref_out))
    terms = ev.evaluate(TraceView(states + out + inter, [], []), NpOps)
    assert all(not np.any(t) for t in terms)


def test_artifacts_load_across_packages(fixture, tmp_path):
    """`save_artifacts` of either package loads in the other (setup base and
    VK), and the VK JSON inside is the same text."""
    from tests.torch_small_circuit import build_small_circuit
    from boojum_tpu_torch.cs.setup import create_base_setup

    cs = build_small_circuit("boojum_tpu_torch", np.random.default_rng(11))
    sb = create_base_setup(cs)
    vk = fixture["vk"]
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    ser.save_artifacts(ours, sb, vk)
    ref_ser.save_artifacts(theirs, ref_ser.load_artifacts(ours)[0],
                           fixture["ref_vk"])
    for path in (ours, theirs):
        sb2, vk2 = ser.load_artifacts(path)
        assert ser.vk_to_json(vk2) == fixture["vk_text"]
        for name in ("copy_permutation_polys", "constant_columns",
                     "lookup_tables_columns"):
            assert np.array_equal(getattr(sb2, name), getattr(sb, name))
        assert sb2.selector_paths == sb.selector_paths
