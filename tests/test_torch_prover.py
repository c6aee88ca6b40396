"""End-to-end: the port's setup, VK and proofs against the JAX package's host
prover on the small lookup circuit of tests/test_prove_verify.py, built once
with each package's own circuit code from the same seed. Proofs must be
byte-identical under `proof_to_json`, and the reference verifier must accept
the port's proofs (and the port's verifier the reference's), for the
algebraic transcripts with Poseidon2 trees, the Blake2s and Keccak-256
configurations, and with proof of work."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.prover import create_setup_and_vk, prove
from boojum_tpu.prover.proof import proof_to_json as ref_proof_to_json
from boojum_tpu.prover.serialization import save_setup_base, vk_to_json
from boojum_tpu.verifier import verify
from boojum_tpu_torch.cs import LookupParameters
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover import device_merkle
from boojum_tpu_torch.prover import device_transcript as dtm
from boojum_tpu_torch.prover.proof import proof_to_json
from boojum_tpu_torch.prover.serialization import (load_setup_base,
                                                   setup_base_from_arrays)
from boojum_tpu_torch.verifier import verify as port_verify

P = 0xFFFFFFFF00000001
CFG = dict(fri_lde_factor=8, merkle_tree_cap_size=4, security_level=100,
           pow_bits=0)
SB_ARRAYS = ("copy_permutation_polys", "constant_columns",
             "lookup_tables_columns")
SB_FIELDS = ("table_ids_column_idxes", "selector_paths", "quotient_degree",
             "num_general_constant_columns", "domain_size", "public_inputs")


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


@pytest.fixture(scope="module")
def both():
    """Both packages' circuits, setups and artifacts; reference host proofs
    for both transcripts, each made once at its first use."""
    ref_cs = build_small_circuit("boojum_tpu", np.random.default_rng(11))
    cs = build_small_circuit("boojum_tpu_torch", np.random.default_rng(11))
    ref_sb = ref_create_base_setup(ref_cs)
    sb = create_base_setup(cs)
    ref_art = create_setup_and_vk(ref_cs, ref_sb, RefProofConfig(**CFG),
                                  "poseidon2")
    art = create_device_setup(cs, sb, ProofConfig(**CFG), "poseidon2",
                              device="cpu")
    ref_proofs = _LazyProofs(lambda kind: prove(
        ref_cs, ref_art, RefProofConfig(**CFG), kind, "poseidon2"))
    return dict(ref_cs=ref_cs, cs=cs, ref_sb=ref_sb, sb=sb, ref_art=ref_art,
                art=art, ref_proofs=ref_proofs)


class _LazyProofs(dict):
    """kind -> the reference host proof, made at its first use."""

    def __init__(self, make):
        super().__init__()
        self._make = make

    def __missing__(self, kind):
        self[kind] = self._make(kind)
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
    prover = DeviceProver(both["cs"], both["art"], ProofConfig(**CFG),
                          device="cpu")
    return prover, prover.prove("poseidon", "poseidon2")


@pytest.mark.parametrize("kind", ["poseidon", "poseidon2"])
def test_proof_is_byte_identical_and_verifies(both, warm_prover, kind):
    """A fresh prover's first proof (for the Poseidon transcript, the one
    `warm_prover` made) equals the reference's and verifies."""
    if kind == "poseidon":
        proof = warm_prover[1]
    else:
        proof = DeviceProver(both["cs"], both["art"], ProofConfig(**CFG),
                             device="cpu").prove(kind, "poseidon2")
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


def _configured_proofs(both, cfg, transcript, hasher):
    """The reference host proof and the port's CPU proof under ``cfg``, each
    from its own setup of the shared circuit."""
    ref_art = create_setup_and_vk(both["ref_cs"], both["ref_sb"],
                                  RefProofConfig(**cfg), hasher)
    art = create_device_setup(both["cs"], both["sb"], ProofConfig(**cfg),
                              hasher, device="cpu")
    assert vk_to_json(art.vk) == vk_to_json(ref_art.vk)
    ref_proof = prove(both["ref_cs"], ref_art, RefProofConfig(**cfg),
                      transcript, hasher)
    fetches = device_merkle.FETCHES
    proof = DeviceProver(both["cs"], art, ProofConfig(**cfg),
                         device="cpu").prove(transcript, hasher)
    assert device_merkle.FETCHES - fetches == 1  # the query phase's one
    return ref_art, art, ref_proof, proof


@pytest.mark.parametrize("kind", ["blake2s", "keccak256"])
def test_byte_hash_proof_is_byte_identical_and_verifies(both, kind):
    """The non-recursive configurations: the byte transcript (on the host)
    and byte trees (kernels K8 / K9, here their plain versions)."""
    ref_art, art, ref_proof, proof = _configured_proofs(both, CFG, kind, kind)
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
    ref_art, art, ref_proof, proof = _configured_proofs(both, cfg, kind,
                                                        hasher)
    assert proof_to_json(proof) == ref_proof_to_json(ref_proof)
    assert verify(ref_art.vk, proof, kind, hasher)
    assert port_verify(art.vk, proof, kind, hasher)
    proof.pow_challenge += 1
    assert not port_verify(art.vk, proof, kind, hasher)


def test_unported_options_raise(both):
    """What is still not ported raises: the classic-Poseidon tree hasher,
    general-purpose lookups, and the device transcript with a byte
    transcript or byte trees."""
    prover = DeviceProver(both["cs"], both["art"], ProofConfig(**CFG),
                          device="cpu")
    with pytest.raises(NotImplementedError):
        prover.prove("poseidon", "poseidon")
    with pytest.raises(NotImplementedError):
        create_device_setup(both["cs"], both["sb"], ProofConfig(**CFG),
                            "poseidon", device="cpu")
    with pytest.raises(ValueError, match="device transcript"):
        prover.prove("blake2s", "blake2s", device_transcript=True)
    with pytest.raises(ValueError, match="device transcript"):
        prover.prove("poseidon", "blake2s", device_transcript=True)
    general = SimpleNamespace(
        lookup_parameters=LookupParameters.table_id_as_constant(width=3))
    with pytest.raises(NotImplementedError, match="general-purpose"):
        create_device_setup(general, both["sb"], ProofConfig(**CFG),
                            device="cpu")
