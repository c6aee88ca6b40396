"""End-to-end: the port's setup, VK and proofs against the JAX package's host
prover on the small lookup circuit of tests/test_prove_verify.py, built once
with each package's own circuit code from the same seed. Proofs must be
byte-identical under `proof_to_json`, and the reference verifier must accept
the port's proofs."""

import importlib

import numpy as np
import pytest

from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.prover import create_setup_and_vk, prove
from boojum_tpu.prover.proof import proof_to_json as ref_proof_to_json
from boojum_tpu.prover.serialization import save_setup_base, vk_to_json
from boojum_tpu.verifier import verify
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover.proof import proof_to_json
from boojum_tpu_torch.prover.serialization import (load_setup_base,
                                                   setup_base_from_arrays)

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
    for both transcripts, made once."""
    ref_cs = build_small_circuit("boojum_tpu", np.random.default_rng(11))
    cs = build_small_circuit("boojum_tpu_torch", np.random.default_rng(11))
    ref_sb = ref_create_base_setup(ref_cs)
    sb = create_base_setup(cs)
    ref_art = create_setup_and_vk(ref_cs, ref_sb, RefProofConfig(**CFG),
                                  "poseidon2")
    art = create_device_setup(cs, sb, ProofConfig(**CFG), "poseidon2",
                              device="cpu")
    ref_proofs = {kind: prove(ref_cs, ref_art, RefProofConfig(**CFG), kind,
                              "poseidon2")
                  for kind in ("poseidon", "poseidon2")}
    return dict(ref_cs=ref_cs, cs=cs, ref_sb=ref_sb, sb=sb, ref_art=ref_art,
                art=art, ref_proofs=ref_proofs)


def test_setup_arrays_and_vk_match_reference(both):
    ref_sb, sb = both["ref_sb"], both["sb"]
    for name in SB_ARRAYS:
        assert np.array_equal(getattr(sb, name), getattr(ref_sb, name)), name
    for name in SB_FIELDS:
        assert getattr(sb, name) == getattr(ref_sb, name), name
    # the reference's own VK serializer reads both VKs alike
    assert vk_to_json(both["art"].vk) == vk_to_json(both["ref_art"].vk)


@pytest.mark.parametrize("kind", ["poseidon", "poseidon2"])
def test_proof_is_byte_identical_and_verifies(both, kind):
    cfg = ProofConfig(**CFG)
    proof = DeviceProver(both["cs"], both["art"], cfg, device="cpu").prove(
        kind, "poseidon2")
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


def test_unported_options_raise(both):
    with pytest.raises(NotImplementedError):
        DeviceProver(both["cs"], both["art"], ProofConfig(**CFG),
                     device="cpu").prove("poseidon", "blake2s")
    with pytest.raises(NotImplementedError):
        create_device_setup(both["cs"], both["sb"],
                            ProofConfig(**dict(CFG, pow_bits=10)),
                            device="cpu")
