"""Every lookup mode of the port against the JAX package: the specialized
modes (a shared constant table id, one id column a repetition, the id as a
variable) and the general-purpose ones (the id as a constant or a variable,
the lookups on the marker gate's rows).

Each mode's small circuit is the one of tests/test_specialized_lookup_modes.py
or tests/test_general_lookup.py, built here in both packages from a fresh
`np.random.default_rng` (those files draw from a module-level RNG, so their
circuits depend on test order). The setups and VKs must be equal; the port's
CPU `DeviceProver` must give the JAX host `prove`'s proof byte for byte, with
the host and with the device transcript; both verifiers must accept it, and
the port's must reject it with one field changed. The device witness program
and the multiplicities of the general-purpose modes, and the lookup-heavy
circuit of BASELINE config 4 (`gadgets.lookup_heavy`) at a reduced lookup
count, are held against the JAX package's host witness and synthesis."""

import copy
import importlib

import numpy as np
import pytest

from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.prover import create_setup_and_vk, prove
from boojum_tpu.prover.proof import proof_to_json as ref_proof_to_json
from boojum_tpu.prover.prover import \
    materialize_witness_columns as ref_materialize
from boojum_tpu.prover.serialization import vk_to_json
from boojum_tpu.verifier import verify as ref_verify
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.gadgets import build_lookup_heavy_circuit
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover.device_witness import DeviceWitnessProgram
from boojum_tpu_torch.prover.proof import proof_to_json
from boojum_tpu_torch.prover.prover import materialize_witness_columns
from boojum_tpu_torch.verifier import verify
from scripts.torch_reference_digest import lookup_heavy_circuit
from tests.torch_small_circuit import jitted_reference

P = 0xFFFFFFFF00000001
CFG = dict(fri_lde_factor=4, merkle_tree_cap_size=16, security_level=100,
           pow_bits=0)
KIND, HASHER = "poseidon", "poseidon2"
# (family, mode): the three specialized modes and the two general-purpose
MODES = [("specialized", "const_share"), ("specialized", "const_noshare"),
         ("specialized", "as_variable"), ("general", "as_constant"),
         ("general", "as_variable")]
MODE_IDS = ["%s-%s" % m for m in MODES]
N_HEAVY = 500_000  # lookups of the reduced lookup-heavy circuit
SB_ARRAYS = ("copy_permutation_polys", "constant_columns",
             "lookup_tables_columns")
SB_FIELDS = ("table_ids_column_idxes", "selector_paths", "quotient_degree",
             "num_general_constant_columns", "domain_size", "public_inputs")


def lookup_parameters(lp_cls, family, mode):
    if family == "general":
        return (lp_cls.table_id_as_constant(width=3) if mode == "as_constant"
                else lp_cls.table_id_as_variable(width=3))
    if mode == "as_variable":
        return lp_cls.specialized_with_table_id_as_variable(
            width=3, num_repetitions=2)
    return lp_cls.specialized_with_table_id_as_constant(
        width=3, num_repetitions=2, share_table_id=mode == "const_share")


def build_circuit(pkg, family, mode, rng, public=True):
    """The circuit of tests/test_general_lookup.py:build_circuit (general
    family) or tests/test_specialized_lookup_modes.py:build_circuit
    (specialized), written against either package, drawing from ``rng``;
    ``public=False`` leaves out its public input (a circuit with public
    inputs takes the host witness path). Padded."""
    csm = importlib.import_module(pkg + ".cs")
    g = importlib.import_module(pkg + ".cs.gates")
    geom = csm.CSGeometry(num_columns_under_copy_permutation=16,
                          num_witness_columns=0, num_constant_columns=4,
                          max_allowed_constraint_degree=4)
    cs = csm.ConstraintSystem(geom, 1 << 10, csm.CSConfig.dev())
    cs.allow_lookup(lookup_parameters(csm.LookupParameters, family, mode))
    if family == "general":
        n_fma, n_lookups = 20, 11
        cs.allow_gate(g.ConstantsAllocatorGate)
        cs.allow_gate(g.FmaGate)
        cs.allow_gate(g.ReductionGate, params=4)
        cs.allow_gate(g.BooleanConstraintGate)
        cs.allow_gate(g.PublicInputGate)
        cs.allow_gate(g.NopGate)
    else:
        n_fma, n_lookups = 16, 23
        for gate in (g.ConstantsAllocatorGate, g.FmaGate, g.NopGate,
                     g.PublicInputGate):
            cs.allow_gate(gate)
    xor_rows = [(a, b, a ^ b) for a in range(8) for b in range(8)]
    tid_xor = cs.add_lookup_table(csm.LookupTable(
        "xor3", np.asarray(xor_rows, np.uint64), num_keys=2))
    and_rows = [(a, b, a & b) for a in range(8) for b in range(8)]
    tid_and = cs.add_lookup_table(csm.LookupTable(
        "and3", np.asarray(and_rows, np.uint64), num_keys=2))
    a = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    b = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    c = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    d = g.FmaGate.compute_fma_batch(cs, 3, (a, b), 5, c)
    ka = rng.integers(0, 8, n_lookups, dtype=np.uint64)
    kb = rng.integers(0, 8, n_lookups, dtype=np.uint64)
    la = cs.alloc_variables_with_values(ka)
    lb = cs.alloc_variables_with_values(kb)
    lx = cs.alloc_variables_with_values(ka ^ kb)
    cs.enforce_lookup_batch(tid_xor, np.stack([la, lb, lx]))
    ln = cs.alloc_variables_with_values(ka & kb)
    cs.enforce_lookup_batch(tid_and, np.stack([la, lb, ln]))
    if public:
        g.PublicInputGate.place(cs, int(d[0]))
    cs.pad_and_shrink()
    return cs


class _Modes(dict):
    """(family, mode) -> both packages' circuits, setups, artifacts and the
    reference host proof, made at the first use."""

    def __missing__(self, key):
        seed = 100 + MODES.index(key)
        ref_cs = build_circuit("boojum_tpu", *key, np.random.default_rng(seed))
        cs = build_circuit("boojum_tpu_torch", *key, np.random.default_rng(seed))
        ref_sb, sb = ref_create_base_setup(ref_cs), create_base_setup(cs)
        with jitted_reference():
            ref_art = create_setup_and_vk(ref_cs, ref_sb,
                                          RefProofConfig(**CFG), HASHER)
            ref_proof = prove(ref_cs, ref_art, RefProofConfig(**CFG), KIND,
                              HASHER)
        art = create_device_setup(cs, sb, ProofConfig(**CFG), HASHER,
                                  device="cpu")
        self[key] = dict(
            ref_cs=ref_cs, cs=cs, ref_sb=ref_sb, sb=sb, ref_art=ref_art,
            art=art, prover=DeviceProver(cs, art, ProofConfig(**CFG),
                                         device="cpu"),
            ref_proof=ref_proof, proofs={})
        return self[key]


@pytest.fixture(scope="module")
def modes():
    return _Modes()


def port_proof(m, device_transcript):
    if device_transcript not in m["proofs"]:
        m["proofs"][device_transcript] = m["prover"].prove(
            KIND, HASHER, device_transcript=device_transcript)
    return m["proofs"][device_transcript]


@pytest.mark.parametrize("key", MODES, ids=MODE_IDS)
def test_setup_and_vk_match_reference(modes, key):
    m = modes[key]
    assert m["cs"].check_if_satisfied() and m["ref_cs"].check_if_satisfied()
    for name in SB_ARRAYS:
        assert np.array_equal(getattr(m["sb"], name),
                              getattr(m["ref_sb"], name)), name
    for name in SB_FIELDS:
        assert getattr(m["sb"], name) == getattr(m["ref_sb"], name), name
    assert vk_to_json(m["art"].vk) == vk_to_json(m["ref_art"].vk)


@pytest.mark.parametrize("device_transcript", [False, True],
                         ids=["host_transcript", "device_transcript"])
@pytest.mark.parametrize("key", MODES, ids=MODE_IDS)
def test_proof_is_the_reference_host_proof(modes, key, device_transcript):
    m = modes[key]
    assert proof_to_json(port_proof(m, device_transcript)) == \
        ref_proof_to_json(m["ref_proof"])


@pytest.mark.parametrize("key", MODES, ids=MODE_IDS)
def test_both_verifiers_accept_and_a_changed_proof_fails(modes, key):
    m = modes[key]
    proof = port_proof(m, False)
    assert verify(m["art"].vk, proof, KIND, HASHER)
    assert ref_verify(m["ref_art"].vk, proof, KIND, HASHER)
    # a lookup A polynomial's value at 0 (the sum argument's own term)
    bad = copy.deepcopy(proof)
    v0 = list(bad.values_at_0[0])
    v0[0] = (v0[0] + 1) % P
    bad.values_at_0[0] = tuple(v0)
    assert not verify(m["art"].vk, bad, KIND, HASHER)


@pytest.mark.parametrize("mode", ["as_constant", "as_variable"])
def test_general_witness_and_multiplicities_match_reference(modes, mode):
    """Without its public input the general circuit takes the device
    witness program, as the JAX package's does; its columns, the
    multiplicity column last, equal the JAX host witness. With it (the
    circuits of the proof tests), both take the host path, and the port's
    host columns equal the JAX ones."""
    from boojum_tpu.prover.device_witness import \
        DeviceWitnessProgram as RefDeviceWitnessProgram
    m = modes[("general", mode)]
    seed = 100 + MODES.index(("general", mode))
    circuits = [(build_circuit("boojum_tpu_torch", "general", mode,
                               np.random.default_rng(seed), public=False),
                 build_circuit("boojum_tpu", "general", mode,
                               np.random.default_rng(seed), public=False)),
                (m["cs"], m["ref_cs"])]
    for public, (cs, ref_cs) in enumerate(circuits):
        n = cs.final_trace_len
        for got, want in zip(cs.lookup_multiplicities,
                             ref_cs.lookup_multiplicities):
            assert np.array_equal(got, want)
        want = np.concatenate(ref_materialize(ref_cs, n), axis=0).T
        supported = DeviceWitnessProgram.supported(cs)
        assert supported == RefDeviceWitnessProgram.supported(ref_cs) \
            == (not public)
        if supported:
            got = DeviceWitnessProgram(cs, n, "cpu")().numpy().view(np.uint64)
        else:
            got = np.concatenate(materialize_witness_columns(cs, n), axis=0).T
        assert np.array_equal(got, want)
        assert want[:, -1].sum() > 0


@pytest.mark.parametrize("mode", ["specialized", "general"])
def test_lookup_heavy_builder_matches_reference(mode):
    """`build_lookup_heavy_circuit` at 500,000 lookups against the same
    construction in the JAX package (`scripts/torch_reference_digest.py`),
    synthesis only: placement, values, constants and multiplicities. The
    table alone takes 2^16 rows, which these lookups nearly fill (a sparser
    circuit spends its time padding the empty rows one by one). The full
    circuit's witness and proof are held to their digests on the card
    (`chip_smoke.py`, phase ``lookup heavy``)."""
    cs = build_lookup_heavy_circuit(n_lookups=N_HEAVY, seed=11, mode=mode)
    ref_cs = lookup_heavy_circuit(mode, n_lookups=N_HEAVY, seed=11)
    assert cs.final_trace_len == ref_cs.final_trace_len == 1 << 16
    for name in ("copy_permutation_data", "specialized_copy_data",
                 "specialized_constants", "gates_application_sets"):
        got, want = getattr(cs, name), getattr(ref_cs, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert np.array_equal(np.asarray(got), np.asarray(want)), name
    assert [list(r) for r in cs.constants_requested_per_row] == \
        [list(r) for r in ref_cs.constants_requested_per_row]
    k = cs.next_place_idx
    assert k == ref_cs.next_place_idx
    assert np.array_equal(cs.resolver.values[:k], ref_cs.resolver.values[:k])
    for got, want in zip(cs.lookup_multiplicities,
                         ref_cs.lookup_multiplicities):
        assert np.array_equal(got, want)
    assert int(sum(np.asarray(m).sum() for m in cs.lookup_multiplicities)) \
        >= N_HEAVY
