"""End-to-end: the port's setup, VK and proofs against the JAX package's host
prover on the small lookup circuit of tests/test_prove_verify.py, built once
with each package's own circuit code from the same seed. Proofs must be
byte-identical under `proof_to_json`, and the reference verifier must accept
the port's proofs (and the port's verifier the reference's), for the
algebraic transcripts with Poseidon2 trees, the Poseidon transcript with
classic-Poseidon trees (host and device transcript), the Blake2s and
Keccak-256 configurations, and with proof of work; and the port's host
`prove` and `create_setup_and_vk` against the same reference.

The port's verifier against the JAX package's (in this file so that one
xdist worker makes the shared setups and proofs of
`tests/torch_small_circuit.py` once): for
the four transcript kinds, each with its tree hasher (poseidon and
poseidon2 with Poseidon2 trees, blake2s and keccak256 with their own),
each package's `verify` accepts the other's proof, and both reject the
mutations of tests/test_prove_verify.py (a claimed evaluation, a query
leaf, a public input, a final FRI monomial) and the cases of
tests/test_verifier_hardening.py (pinned security, an
`expected_proof_config`, malformed proofs that return False without
raising). The port's verifier is host code: it dispatches no torch op."""

import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.prover.proof import proof_to_json as ref_proof_to_json
from boojum_tpu.prover.serialization import save_setup_base, vk_to_json
from boojum_tpu.verifier import verify
from boojum_tpu.verifier import verify as ref_verify
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup, create_setup_and_vk)
from boojum_tpu_torch.prover import device_merkle
from boojum_tpu_torch.prover import prove as host_prove
from boojum_tpu_torch.prover import device_transcript as dtm
from boojum_tpu_torch.prover import serialization as ser
from boojum_tpu_torch.prover.proof import proof_to_json
from boojum_tpu_torch.prover.serialization import (load_setup_base,
                                                   setup_base_from_arrays)
from boojum_tpu_torch.verifier import verifier
from boojum_tpu_torch.verifier import verify as port_verify
from tests.torch_small_circuit import (build_small_circuit, port_proof,
                                      port_prover, reference_proof, setups,
                                      small_circuits)

P = 0xFFFFFFFF00000001
CFG = dict(fri_lde_factor=8, merkle_tree_cap_size=4, security_level=100,
           pow_bits=0)
# transcript kind -> its tree hasher in the verifier cases
KINDS = {"poseidon": "poseidon2", "poseidon2": "poseidon2",
         "blake2s": "blake2s", "keccak256": "keccak256"}
SB_ARRAYS = ("copy_permutation_polys", "constant_columns",
             "lookup_tables_columns")
SB_FIELDS = ("table_ids_column_idxes", "selector_paths", "quotient_degree",
             "num_general_constant_columns", "domain_size", "public_inputs")


@pytest.fixture(scope="module")
def both():
    """Both packages' circuits, setups and artifacts (Poseidon2 trees);
    reference host proofs for both transcripts, each made once at its first
    use."""
    ref_art, art = setups(CFG, "poseidon2")
    return dict(small_circuits(), ref_art=ref_art, art=art,
                ref_proofs=_LazyProofs())


class _LazyProofs(dict):
    """kind -> the reference host proof with Poseidon2 trees, made at its
    first use."""

    def __missing__(self, kind):
        self[kind] = reference_proof(CFG, kind, "poseidon2")
        return self[kind]


def test_setup_arrays_and_vk_match_reference(both):
    ref_sb, sb = both["ref_sb"], both["sb"]
    for name in SB_ARRAYS:
        assert np.array_equal(getattr(sb, name), getattr(ref_sb, name)), name
    for name in SB_FIELDS:
        assert getattr(sb, name) == getattr(ref_sb, name), name
    # the reference's own VK serializer reads both VKs alike
    assert vk_to_json(both["art"].vk) == vk_to_json(both["ref_art"].vk)


@pytest.fixture(scope="module")
def warm_prover(both):
    """A CPU prover after its first prove (Poseidon transcript, host
    transcript), which filled its device caches; the proof rides along."""
    return port_prover(CFG, "poseidon", "poseidon2")


@pytest.mark.parametrize("kind", ["poseidon", "poseidon2"])
def test_proof_is_byte_identical_and_verifies(both, warm_prover, kind):
    """A fresh prover's first proof (for the Poseidon transcript, the one
    `warm_prover` made) equals the reference's and verifies."""
    if kind == "poseidon":
        proof = warm_prover[1]
    else:
        proof = port_proof(CFG, kind, "poseidon2")
    assert proof_to_json(proof) == ref_proof_to_json(both["ref_proofs"][kind])
    assert verify(both["ref_art"].vk, proof, kind, "poseidon2")


@pytest.mark.parametrize("kind", ["poseidon", "poseidon2"])
def test_device_transcript_proof_is_byte_identical(both, kind):
    """The device transcript (on the CPU through the plain versions of its
    sponge) gives the reference's proof; the circuit has public inputs, so
    the witness comes from the host."""
    cfg = ProofConfig(**CFG)
    prover = DeviceProver(both["cs"], both["art"], cfg, device="cpu")
    proof = prover.prove(kind, "poseidon2", device_transcript=True)
    assert prover.witness_program() is None
    assert proof_to_json(proof) == ref_proof_to_json(both["ref_proofs"][kind])
    assert verify(both["ref_art"].vk, proof, kind, "poseidon2")


class _OpCount(TorchDispatchMode):
    """Counts the torch ops dispatched while it is on; ``quiet`` > 0 mutes
    it (inside a sponge call, which counts as one op)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.quiet = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += not self.quiet
        return func(*args, **(kwargs or {}))


def _counted_prove(prover, monkeypatch, device_transcript):
    """One prove's torch ops, the device transcript's sponge absorb and
    permute counted as one op each (one kernel launch on the card)."""
    mode = _OpCount()

    def one_op(fn):
        def call(*args):
            mode.ops += 1
            mode.quiet += 1
            try:
                return fn(*args)
            finally:
                mode.quiet -= 1
        return call

    monkeypatch.setitem(dtm._SPONGES, "poseidon",
                        tuple(one_op(fn) for fn in dtm._SPONGES["poseidon"]))
    with mode:
        proof = prover.prove("poseidon", "poseidon2",
                             device_transcript=device_transcript)
    monkeypatch.undo()
    return mode.ops, proof


def test_fetch_collector_flushes_once():
    """`add` (tensors already computed, one or a sequence) and `add_gather`
    (run at the flush) reach the host in one flush; each callback gets u64
    arrays of its entry's shapes; a flush with nothing to do fetches
    nothing."""
    coll = device_merkle.FetchCollector()
    got = {}
    a = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    b = torch.tensor([-1], dtype=torch.int64)  # the u64 pattern 2^64 - 1
    coll.add(a, lambda h: got.__setitem__("a", h))
    coll.add([a, b], lambda h: got.__setitem__("ab", h))
    coll.add_gather(lambda t, i: t[:, i], (a, torch.tensor([2, 0])),
                    lambda h: got.__setitem__("g", h))
    fetches = device_merkle.FETCHES
    coll.flush()
    coll.flush()
    assert device_merkle.FETCHES - fetches == 1
    assert got["a"].dtype == np.uint64
    assert got["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert [x.tolist() for x in got["ab"]] == [[[0, 1, 2], [3, 4, 5]],
                                               [(1 << 64) - 1]]
    assert got["g"].tolist() == [[2, 0], [5, 3]]


def test_device_transcript_ops_and_one_query_fetch(both, warm_prover,
                                                   monkeypatch):
    """A warm prove with the device transcript dispatches at most 1.5 %
    more torch ops than with the host transcript (its challenges are split
    once when drawn and its power tables step in one multiply a doubling);
    in both modes the query phase comes to the host in ONE collector flush,
    and the proof stays the reference's."""
    prover = warm_prover[0]  # its first prove filled the device caches
    want = ref_proof_to_json(both["ref_proofs"]["poseidon"])
    ops = {}
    for mode in (False, True):
        fetches = device_merkle.FETCHES
        ops[mode], proof = _counted_prove(prover, monkeypatch, mode)
        assert device_merkle.FETCHES - fetches == 1
        assert proof_to_json(proof) == want
    assert ops[True] <= 1.015 * ops[False], ops


@pytest.fixture(scope="module")
def unsatisfied():
    """The small circuit with one variable's value changed after synthesis,
    and a CPU prover for it."""
    cs = build_small_circuit("boojum_tpu_torch", np.random.default_rng(11))
    art = create_device_setup(cs, create_base_setup(cs), ProofConfig(**CFG),
                              "poseidon2", device="cpu")
    cs.resolver.set_values(np.asarray([0], np.int64),
                           np.asarray([12345], np.uint64))
    return DeviceProver(cs, art, ProofConfig(**CFG), device="cpu")


@pytest.mark.parametrize("device_transcript", [False, True])
def test_unsatisfied_circuit_raises(unsatisfied, device_transcript):
    """The runtime assertion on the quotient's top coefficient, checked at
    the evaluations' fetch (host transcript) or at the handoff (device
    transcript), still stops the prove."""
    with pytest.raises(AssertionError, match="unsatisfied circuit"):
        unsatisfied.prove("poseidon", "poseidon2",
                          device_transcript=device_transcript)


def test_setup_base_loads_from_reference_npz(both, tmp_path):
    ref_sb = both["ref_sb"]
    path = str(tmp_path / "setup.npz")
    save_setup_base(path, ref_sb)
    loaded = load_setup_base(path)
    built = setup_base_from_arrays(
        **{name: getattr(ref_sb, name) for name in SB_ARRAYS + SB_FIELDS})
    for sb in (loaded, built):
        for name in SB_ARRAYS:
            assert np.array_equal(getattr(sb, name), getattr(ref_sb, name))
        for name in SB_FIELDS:
            assert getattr(sb, name) == getattr(ref_sb, name), name


def _configured_proofs(cfg, transcript, hasher):
    """The reference host proof and the port's CPU proof under ``cfg``, each
    from its own setup of the shared circuit."""
    ref_art, art = setups(cfg, hasher)
    assert vk_to_json(art.vk) == vk_to_json(ref_art.vk)
    return (ref_art, art, reference_proof(cfg, transcript, hasher),
            port_proof(cfg, transcript, hasher))


@pytest.mark.parametrize("kind", ["blake2s", "keccak256"])
def test_byte_hash_proof_is_byte_identical_and_verifies(both, kind):
    """The non-recursive configurations: the byte transcript (on the host)
    and byte trees (kernels K8 / K9, here their plain versions)."""
    ref_art, art, ref_proof, proof = _configured_proofs(CFG, kind, kind)
    assert proof_to_json(proof) == ref_proof_to_json(ref_proof)
    assert verify(ref_art.vk, proof, kind, kind)
    assert port_verify(art.vk, ref_proof, kind, kind)


@pytest.mark.parametrize("pow_hash,kind,hasher", [
    ("blake2s", "blake2s", "blake2s"),
    ("keccak256", "keccak256", "keccak256"),
    ("poseidon2", "poseidon2", "poseidon2")])
def test_pow_proof_is_byte_identical_and_verifies(both, pow_hash, kind,
                                                  hasher, monkeypatch):
    """pow_bits = 8: the grind runs on the host after FRI and gives the
    reference's nonce; both verifiers check it, and a wrong nonce fails.
    The reference grinds through its serial path (`_grind_range` over all
    nonces): its pool forks a process that has threads, which can hang
    under a loaded test run; the nonce is the same smallest one."""
    from boojum_tpu.prover import pow as ref_pow
    monkeypatch.setattr(ref_pow, "_parallel_grind",
                        lambda kind, seed, threshold, block=0:
                        ref_pow._grind_range((kind, seed, threshold, 0,
                                              1 << 40)))
    cfg = dict(CFG, pow_bits=8, pow_hash=pow_hash)
    ref_art, art, ref_proof, proof = _configured_proofs(cfg, kind, hasher)
    assert proof_to_json(proof) == ref_proof_to_json(ref_proof)
    assert verify(ref_art.vk, proof, kind, hasher)
    assert port_verify(art.vk, proof, kind, hasher)
    bad = copy.deepcopy(proof)  # the shared proof stays as it was made
    bad.pow_challenge += 1
    assert not port_verify(art.vk, bad, kind, hasher)


def test_poseidon_tree_vk_matches_reference(both):
    """create_device_setup with classic-Poseidon trees: the VK (its setup
    cap) equals the reference's `create_setup_and_vk`'s."""
    ref_art, art = setups(CFG, "poseidon")
    assert vk_to_json(art.vk) == vk_to_json(ref_art.vk)


@pytest.mark.parametrize("device_transcript", [False, True])
def test_poseidon_tree_proof_is_byte_identical_and_verifies(
        both, device_transcript):
    """The Poseidon transcript with classic-Poseidon trees, through the
    host or the device transcript (the sponge's plain version here): the
    reference host proof's bytes; both verifiers accept it, and the port's
    rejects it with one opened value changed."""
    ref_art, art = setups(CFG, "poseidon")
    ref_proof = reference_proof(CFG, "poseidon", "poseidon")
    prover = DeviceProver(both["cs"], art, ProofConfig(**CFG), device="cpu")
    proof = prover.prove("poseidon", "poseidon",
                         device_transcript=device_transcript)
    assert proof_to_json(proof) == ref_proof_to_json(ref_proof)
    assert verify(ref_art.vk, proof, "poseidon", "poseidon")
    assert port_verify(art.vk, proof, "poseidon", "poseidon")
    bad = copy.deepcopy(proof)
    bad.queries_per_fri_repetition[0].witness_query.leaf_elements[0] ^= 1
    assert not port_verify(art.vk, bad, "poseidon", "poseidon")


@pytest.mark.parametrize("hasher", ["poseidon2", "blake2s"])
def test_host_setup_and_vk_match_reference(both, hasher):
    """The port's `create_setup_and_vk` (the host prove's setup, its LDE
    and tree on the CPU) gives the reference's VK."""
    ref_art = setups(CFG, hasher)[0]
    art = create_setup_and_vk(both["cs"], both["sb"], ProofConfig(**CFG),
                              hasher, device="cpu")
    assert vk_to_json(art.vk) == vk_to_json(ref_art.vk)


@pytest.mark.parametrize("kind,hasher", [("poseidon", "poseidon2"),
                                         ("poseidon2", "poseidon2"),
                                         ("blake2s", "blake2s")])
def test_host_prove_is_the_reference_host_proof(both, kind, hasher):
    """The port's host `prove` (numpy stages, its LDEs, NTTs and trees on
    the CPU) gives the JAX host `prove`'s bytes, for the algebraic
    transcripts with Poseidon2 trees and the Blake2s configuration."""
    art = create_setup_and_vk(both["cs"], both["sb"], ProofConfig(**CFG),
                              hasher, device="cpu")
    proof = host_prove(both["cs"], art, ProofConfig(**CFG), kind, hasher,
                       device="cpu")
    assert proof_to_json(proof) == ref_proof_to_json(
        reference_proof(CFG, kind, hasher))


def test_unported_options_raise(both):
    """What is still not ported raises: the device transcript with a byte
    transcript or byte trees (every tree hasher is ported; general-purpose
    lookups too: tests/test_torch_lookup_modes.py)."""
    prover = DeviceProver(both["cs"], both["art"], ProofConfig(**CFG),
                          device="cpu")
    with pytest.raises(ValueError, match="device transcript"):
        prover.prove("blake2s", "blake2s", device_transcript=True)
    with pytest.raises(ValueError, match="device transcript"):
        prover.prove("poseidon", "blake2s", device_transcript=True)


# ---------------------------------------------------------------------------
# the port's verifier against the JAX package's
# ---------------------------------------------------------------------------


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
    assert port_verify(vk, ref_proof, kind, KINDS[kind]), verifier.last_failure()
    assert port_verify(ref_vk, ref_proof, kind, KINDS[kind])


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_verify_accepts_port_proof(proofs, kind):
    ref_vk, vk, _, proof = proofs[kind]
    assert ref_verify(ref_vk, proof, kind, KINDS[kind])
    assert port_verify(vk, proof, kind, KINDS[kind]), verifier.last_failure()


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
        assert port_verify(vk, bad, kind, KINDS[kind]) is False
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
        assert port_verify(vk, bad, kind, KINDS[kind]) is False, name
        assert ref_verify(ref_vk, bad, kind, KINDS[kind]) is False, name
        assert verifier.last_failure(), name


@pytest.mark.parametrize("kind", list(KINDS))
def test_expected_proof_config_pinning(proofs, kind):
    ref_vk, vk, _, proof = proofs[kind]
    assert port_verify(vk, proof, kind, KINDS[kind],
                  expected_proof_config=ProofConfig(**CFG))
    wrong = ProofConfig(**dict(CFG, security_level=80))
    assert not port_verify(vk, proof, kind, KINDS[kind],
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
    assert port_verify(art.vk, weak_proof, "blake2s", "blake2s")
    assert not port_verify(vk, weak_proof, "blake2s", "blake2s")
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
    assert port_verify(vk2, proof, kind, KINDS[kind])
    assert ref_verify(ref_ser.vk_from_json(text), proof, kind, KINDS[kind])


def test_verify_dispatches_no_torch_op(proofs):
    """The verifier is host code on Python ints: no tensor op, so nothing
    is launched on any device."""
    _, vk, _, proof = proofs["blake2s"]
    mode = _OpCount()
    with mode:
        assert port_verify(vk, proof, "blake2s", "blake2s")
    assert mode.ops == 0
