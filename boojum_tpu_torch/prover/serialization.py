# Copied from boojum_tpu/prover/serialization.py.
"""Persistence in the reference's formats: the setup base (npz), the
proving artifacts (setup base + VK, uncompressed npz), the VK and the proof
(JSON).

Files either package writes load in the other: `load_setup_base` and
`load_artifacts` read what the JAX package's ``save_setup_base`` /
``save_artifacts`` wrote, `vk_from_json` / `proof_from_json` its JSON, and
`setup_base_from_arrays` builds the same SetupBase from numpy arrays.
"""

from __future__ import annotations

import json

import numpy as np

from ..cs.geometry import CSGeometry, LookupParameters
from ..cs.setup import SetupBase
from .proof import (OracleQuery, Proof, ProofConfig, SingleRoundQueries,
                    VerificationKey, VerificationKeyCircuitGeometry)


# -- setup base (bulk columns as npz) ---------------------------------------


def save_setup_base(path: str, sb: SetupBase):
    np.savez_compressed(
        path,
        copy_permutation_polys=sb.copy_permutation_polys,
        constant_columns=sb.constant_columns,
        lookup_tables_columns=sb.lookup_tables_columns,
        meta=np.frombuffer(json.dumps({
            "table_ids_column_idxes": sb.table_ids_column_idxes,
            "selector_paths": sb.selector_paths,
            "quotient_degree": sb.quotient_degree,
            "num_general_constant_columns": sb.num_general_constant_columns,
            "domain_size": sb.domain_size,
            "public_inputs": sb.public_inputs,
        }).encode(), dtype=np.uint8),
    )


def load_setup_base(path: str) -> SetupBase:
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    return SetupBase(
        copy_permutation_polys=z["copy_permutation_polys"],
        constant_columns=z["constant_columns"],
        lookup_tables_columns=z["lookup_tables_columns"],
        table_ids_column_idxes=list(meta["table_ids_column_idxes"]),
        selectors_placement=None,  # paths are the operative data
        selector_paths=[list(map(bool, p)) for p in meta["selector_paths"]],
        quotient_degree=meta["quotient_degree"],
        num_general_constant_columns=meta["num_general_constant_columns"],
        domain_size=meta["domain_size"],
        public_inputs=[tuple(p) for p in meta["public_inputs"]],
    )


def setup_base_from_arrays(copy_permutation_polys, constant_columns,
                           lookup_tables_columns, table_ids_column_idxes,
                           selector_paths, quotient_degree,
                           num_general_constant_columns, domain_size,
                           public_inputs) -> SetupBase:
    """SetupBase from the fields `save_setup_base` stores, as numpy arrays
    and plain Python values."""
    return SetupBase(
        copy_permutation_polys=np.asarray(copy_permutation_polys, np.uint64),
        constant_columns=np.asarray(constant_columns, np.uint64),
        lookup_tables_columns=np.asarray(lookup_tables_columns, np.uint64),
        table_ids_column_idxes=[int(i) for i in table_ids_column_idxes],
        selectors_placement=None,  # paths are the operative data
        selector_paths=[list(map(bool, p)) for p in selector_paths],
        quotient_degree=int(quotient_degree),
        num_general_constant_columns=int(num_general_constant_columns),
        domain_size=int(domain_size),
        public_inputs=[tuple(int(x) for x in p) for p in public_inputs],
    )


# -- proving artifacts (setup base + VK) --------------------------------------


def save_artifacts(path: str, setup_base: SetupBase, vk: "VerificationKey"):
    """Raw-bytes persistence of everything a prover process needs besides
    synthesis: the base setup columns + the VK (cap included). UNCOMPRESSED
    npz — the memcopy analogue of the reference's MemcopySerializable
    (src/cs/implementations/fast_serialization.rs:17,34): load + device
    re-commit replaces the 30-200 s per-process create_base_setup."""
    np.savez(
        path,
        copy_permutation_polys=setup_base.copy_permutation_polys,
        constant_columns=setup_base.constant_columns,
        lookup_tables_columns=setup_base.lookup_tables_columns,
        meta=np.frombuffer(json.dumps({
            "table_ids_column_idxes": setup_base.table_ids_column_idxes,
            "selector_paths": setup_base.selector_paths,
            "quotient_degree": setup_base.quotient_degree,
            "num_general_constant_columns":
                setup_base.num_general_constant_columns,
            "domain_size": setup_base.domain_size,
            "public_inputs": setup_base.public_inputs,
        }).encode(), dtype=np.uint8),
        vk=np.frombuffer(vk_to_json(vk).encode(), dtype=np.uint8),
    )


def load_artifacts(path: str):
    """-> (SetupBase, VerificationKey). Uncompressed npz: each column array
    loads as one raw read on first access."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    sb = SetupBase(
        copy_permutation_polys=z["copy_permutation_polys"],
        constant_columns=z["constant_columns"],
        lookup_tables_columns=z["lookup_tables_columns"],
        table_ids_column_idxes=list(meta["table_ids_column_idxes"]),
        selectors_placement=None,
        selector_paths=[list(map(bool, p)) for p in meta["selector_paths"]],
        quotient_degree=meta["quotient_degree"],
        num_general_constant_columns=meta["num_general_constant_columns"],
        domain_size=meta["domain_size"],
        public_inputs=[tuple(p) for p in meta["public_inputs"]],
    )
    vk = vk_from_json(bytes(z["vk"]).decode())
    return sb, vk


def create_device_setup_from_artifacts(cs, path: str, proof_config,
                                       hasher: str = "poseidon2",
                                       device="cuda"):
    """Second-process fast path: load persisted artifacts and commit the
    setup oracle on ``device`` (skipping create_base_setup); asserts the
    recommitted cap equals the persisted VK's."""
    from .device_prover import create_device_setup

    sb, vk = load_artifacts(path)
    art = create_device_setup(cs, sb, proof_config, hasher, device=device)
    assert art.vk.setup_merkle_tree_cap == vk.setup_merkle_tree_cap, \
        "persisted VK does not match the recommitted setup"
    return art


# -- VK ---------------------------------------------------------------------


def _cap_to_json(cap):
    out = []
    for el in cap:
        if isinstance(el, (bytes, bytearray)):
            out.append({"bytes": el.hex()})
        else:
            out.append({"felts": [int(x) for x in el]})
    return out


def _cap_from_json(data):
    out = []
    for el in data:
        if "bytes" in el:
            out.append(bytes.fromhex(el["bytes"]))
        else:
            out.append(tuple(el["felts"]))
    return out


def vk_to_json(vk: VerificationKey) -> str:
    f = vk.fixed_parameters
    return json.dumps({
        "geometry": vars(f.geometry),
        "lookup_parameters": vars(f.lookup_parameters),
        "domain_size": f.domain_size,
        "total_tables_len": f.total_tables_len,
        "public_inputs_locations": f.public_inputs_locations,
        "extra_constant_polys_for_selectors": f.extra_constant_polys_for_selectors,
        "table_ids_column_idxes": f.table_ids_column_idxes,
        "quotient_degree": f.quotient_degree,
        "selector_paths": f.selector_paths,
        "evaluator_specs": f.evaluator_specs,
        "fri_lde_factor": f.fri_lde_factor,
        "cap_size": f.cap_size,
        "num_variable_polys": f.num_variable_polys,
        "num_witness_polys": f.num_witness_polys,
        "num_constant_polys": f.num_constant_polys,
        "num_multiplicity_polys": f.num_multiplicity_polys,
        "specialized_evaluator_specs": f.specialized_evaluator_specs,
        "gate_spec_layout": f.gate_spec_layout,
        "security_level": f.security_level,
        "pow_bits": f.pow_bits,
        "setup_merkle_tree_cap": _cap_to_json(vk.setup_merkle_tree_cap),
    })


def vk_from_json(s: str) -> VerificationKey:
    d = json.loads(s)
    fixed = VerificationKeyCircuitGeometry(
        geometry=CSGeometry(**d["geometry"]),
        lookup_parameters=LookupParameters(**{
            k: v for k, v in d["lookup_parameters"].items()
            if k in ("mode", "width", "num_repetitions", "share_table_id")}),
        domain_size=d["domain_size"],
        total_tables_len=d["total_tables_len"],
        public_inputs_locations=[tuple(p) for p in d["public_inputs_locations"]],
        extra_constant_polys_for_selectors=d["extra_constant_polys_for_selectors"],
        table_ids_column_idxes=d["table_ids_column_idxes"],
        quotient_degree=d["quotient_degree"],
        selector_paths=[list(map(bool, p)) for p in d["selector_paths"]],
        evaluator_specs=[tuple(e) for e in d["evaluator_specs"]],
        fri_lde_factor=d["fri_lde_factor"],
        cap_size=d["cap_size"],
        num_variable_polys=d["num_variable_polys"],
        num_witness_polys=d["num_witness_polys"],
        num_constant_polys=d["num_constant_polys"],
        num_multiplicity_polys=d["num_multiplicity_polys"],
        specialized_evaluator_specs=d.get("specialized_evaluator_specs"),
        gate_spec_layout=d.get("gate_spec_layout"),
        security_level=d.get("security_level"),
        pow_bits=d.get("pow_bits"),
    )
    return VerificationKey(fixed_parameters=fixed,
                           setup_merkle_tree_cap=_cap_from_json(
                               d["setup_merkle_tree_cap"]))


# -- proof ------------------------------------------------------------------


def proof_from_json(s: str) -> Proof:
    d = json.loads(s)

    def q(qd):
        return OracleQuery(leaf_elements=qd["leaf_elements"],
                           proof=_cap_from_json(qd["proof"]))

    return Proof(
        proof_config=ProofConfig(
            fri_lde_factor=d["proof_config"]["fri_lde_factor"],
            merkle_tree_cap_size=d["proof_config"]["merkle_tree_cap_size"],
            security_level=d["proof_config"]["security_level"],
            pow_hash=d["proof_config"].get("pow_hash", "blake2s"),
            pow_bits=d["proof_config"]["pow_bits"]),
        public_inputs=d["public_inputs"],
        witness_oracle_cap=_cap_from_json(d["witness_oracle_cap"]),
        stage_2_oracle_cap=_cap_from_json(d["stage_2_oracle_cap"]),
        quotient_oracle_cap=_cap_from_json(d["quotient_oracle_cap"]),
        final_fri_monomials=tuple(d["final_fri_monomials"]),
        values_at_z=[tuple(v) for v in d["values_at_z"]],
        values_at_z_omega=[tuple(v) for v in d["values_at_z_omega"]],
        values_at_0=[tuple(v) for v in d["values_at_0"]],
        fri_base_oracle_cap=_cap_from_json(d["fri_base_oracle_cap"]),
        fri_intermediate_oracles_caps=[
            _cap_from_json(c) for c in d["fri_intermediate_oracles_caps"]],
        queries_per_fri_repetition=[
            SingleRoundQueries(
                witness_query=q(r["witness_query"]),
                stage_2_query=q(r["stage_2_query"]),
                quotient_query=q(r["quotient_query"]),
                setup_query=q(r["setup_query"]),
                fri_queries=[q(f) for f in r["fri_queries"]])
            for r in d["queries_per_fri_repetition"]],
        pow_challenge=d["pow_challenge"],
    )
