"""The port's verifier against the JAX package's, on the small lookup circuit
of tests/test_torch_prover.py (built with each package's own circuit code
from the same seed), for the four transcript kinds, each with its tree
hasher (poseidon and poseidon2 with Poseidon2 trees, blake2s and keccak256
with their own): each package's `verify` accepts the other's proof, and
both reject the mutations of tests/test_prove_verify.py (a claimed
evaluation, a query leaf, a public input, a final FRI monomial) and the
cases of tests/test_verifier_hardening.py (pinned security, an
`expected_proof_config`, malformed proofs that return False without
raising). The port's verifier is host code: it dispatches no torch op."""

import copy

import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.verifier import verify as ref_verify
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover import serialization as ser
from boojum_tpu_torch.verifier import verifier
from boojum_tpu_torch.verifier import verify
from tests.torch_small_circuit import (port_proof, reference_proof, setups,
                                      small_circuits)

P = 0xFFFFFFFF00000001
CFG = dict(fri_lde_factor=8, merkle_tree_cap_size=4, security_level=100,
           pow_bits=0)
KINDS = {"poseidon": "poseidon2", "poseidon2": "poseidon2",
         "blake2s": "blake2s", "keccak256": "keccak256"}


@pytest.fixture(scope="module")
def circuits():
    return small_circuits()


class _Proofs:
    """Per transcript kind, built at its first use: (reference VK, port VK,
    reference proof, port proof); the setups and proofs are those of
    tests/test_torch_prover.py, made once a process."""

    def __getitem__(self, kind):
        hasher = KINDS[kind]
        ref_art, art = setups(CFG, hasher)
        return (ref_art.vk, art.vk, reference_proof(CFG, kind, hasher),
                port_proof(CFG, kind, hasher))


@pytest.fixture(scope="module")
def proofs(circuits):
    """Per transcript kind: (reference VK, port VK, reference proof, port
    proof), each kind built lazily at its first use."""
    return _Proofs()


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_verify_accepts_reference_proof(proofs, kind):
    ref_vk, vk, ref_proof, _ = proofs[kind]
    assert verify(vk, ref_proof, kind, KINDS[kind]), verifier.last_failure()
    assert verify(ref_vk, ref_proof, kind, KINDS[kind])


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_verify_accepts_port_proof(proofs, kind):
    ref_vk, vk, _, proof = proofs[kind]
    assert ref_verify(ref_vk, proof, kind, KINDS[kind])
    assert verify(vk, proof, kind, KINDS[kind]), verifier.last_failure()


def _mutate(proof, what):
    bad = copy.deepcopy(proof)
    if what == "value_at_z":
        v = list(bad.values_at_z[3])
        v[0] = (v[0] + 1) % P
        bad.values_at_z[3] = tuple(v)
    elif what == "query_leaf":
        bad.queries_per_fri_repetition[0].witness_query.leaf_elements[0] ^= 1
    elif what == "public_input":
        bad.public_inputs[0] = (bad.public_inputs[0] + 1) % P
    else:
        m0 = list(bad.final_fri_monomials[0])
        m0[0] = (m0[0] + 1) % P
        bad.final_fri_monomials = (m0, bad.final_fri_monomials[1])
    return bad


@pytest.mark.parametrize("what", ["value_at_z", "query_leaf", "public_input",
                                  "final_monomial"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_both_reject_mutations(proofs, kind, what):
    ref_vk, vk, ref_proof, proof = proofs[kind]
    for p in (ref_proof, proof):
        bad = _mutate(p, what)
        assert verify(vk, bad, kind, KINDS[kind]) is False
        assert ref_verify(ref_vk, bad, kind, KINDS[kind]) is False


MALFORMED = {
    "truncated_path": lambda p: setattr(
        p.queries_per_fri_repetition[0].witness_query, "proof",
        p.queries_per_fri_repetition[0].witness_query.proof[:-2]),
    "short_cap": lambda p: setattr(p, "witness_oracle_cap",
                                   p.witness_oracle_cap[:-1]),
    "missing_fri_query": lambda p: setattr(
        p.queries_per_fri_repetition[0], "fri_queries",
        p.queries_per_fri_repetition[0].fri_queries[:-1]),
    "short_values_at_0": lambda p: setattr(p, "values_at_0",
                                           p.values_at_0[:-1]),
    "short_values_at_z": lambda p: setattr(p, "values_at_z",
                                           p.values_at_z[:-3]),
    "no_queries": lambda p: setattr(p, "queries_per_fri_repetition", []),
    "no_final_monomials": lambda p: setattr(p, "final_fri_monomials",
                                            ([], [])),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_malformed_proofs_return_false_not_raise(proofs, kind):
    ref_vk, vk, _, proof = proofs[kind]
    for name, damage in MALFORMED.items():
        bad = copy.deepcopy(proof)
        damage(bad)
        assert verify(vk, bad, kind, KINDS[kind]) is False, name
        assert ref_verify(ref_vk, bad, kind, KINDS[kind]) is False, name
        assert verifier.last_failure(), name


@pytest.mark.parametrize("kind", list(KINDS))
def test_expected_proof_config_pinning(proofs, kind):
    ref_vk, vk, _, proof = proofs[kind]
    assert verify(vk, proof, kind, KINDS[kind],
                  expected_proof_config=ProofConfig(**CFG))
    wrong = ProofConfig(**dict(CFG, security_level=80))
    assert not verify(vk, proof, kind, KINDS[kind],
                      expected_proof_config=wrong)
    assert not ref_verify(ref_vk, proof, kind, KINDS[kind],
                          expected_proof_config=RefProofConfig(
                              **dict(CFG, security_level=80)))


def test_low_security_proof_rejected_by_pinned_vk(circuits, proofs):
    """A proof made at security 4 (2 queries) verifies against nothing set
    up for security 100, in either package."""
    ref_vk, vk, _, _ = proofs["blake2s"]
    cs = circuits["cs"]
    weak = ProofConfig(**dict(CFG, security_level=4))
    art = create_device_setup(cs, create_base_setup(cs), weak, "blake2s",
                              device="cpu")
    weak_proof = DeviceProver(cs, art, weak, device="cpu").prove(
        "blake2s", "blake2s")
    assert len(weak_proof.queries_per_fri_repetition) < 10
    assert verify(art.vk, weak_proof, "blake2s", "blake2s")
    assert not verify(vk, weak_proof, "blake2s", "blake2s")
    assert not ref_verify(ref_vk, weak_proof, "blake2s", "blake2s")


@pytest.mark.parametrize("kind", ["poseidon2", "keccak256"])
def test_vk_serde_roundtrips_pinned_security(proofs, kind):
    """The port's VK JSON (byte caps for the byte hashers) reads back with
    its pinned security and still verifies; the reference reads it too."""
    from boojum_tpu.prover import serialization as ref_ser
    ref_vk, vk, _, proof = proofs[kind]
    text = ser.vk_to_json(vk)
    assert text == ref_ser.vk_to_json(ref_vk)
    vk2 = ser.vk_from_json(text)
    assert vk2.fixed_parameters.security_level == 100
    assert verify(vk2, proof, kind, KINDS[kind])
    assert ref_verify(ref_ser.vk_from_json(text), proof, kind, KINDS[kind])


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_verify_dispatches_no_torch_op(proofs):
    """The verifier is host code on Python ints: no tensor op, so nothing
    is launched on any device."""
    _, vk, _, proof = proofs["blake2s"]
    mode = _OpCount()
    with mode:
        assert verify(vk, proof, "blake2s", "blake2s")
    assert mode.ops == 0
