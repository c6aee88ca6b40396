# Copied from boojum_tpu/prover/proof.py.
"""Proof / VK objects and JSON (de)serialization.

Reference behavior: src/cs/implementations/proof.rs (Proof :121,
OracleQuery :11-64, SingleRoundQueries) and verifier.rs:31-66
(VerificationKey / VerificationKeyCircuitGeometry).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class ProofConfig:
    fri_lde_factor: int = 8
    merkle_tree_cap_size: int = 16
    fri_folding_schedule: list | None = None
    security_level: int = 100
    pow_bits: int = 0
    # grinding hash: "blake2s" (reference pow.rs:51), "keccak256" (:140), or
    # "poseidon2" — algebraic PoW verifiable in-circuit (pow.py; the
    # reference has no such runner and its circuit PoW is todo!())
    pow_hash: str = "blake2s"


@dataclass
class OracleQuery:
    leaf_elements: list  # base field u64 values of the opened leaf
    proof: list  # sibling hashes, leaf->cap ([F;4] tuples or hex bytes)


@dataclass
class SingleRoundQueries:
    witness_query: OracleQuery
    stage_2_query: OracleQuery
    quotient_query: OracleQuery
    setup_query: OracleQuery
    fri_queries: list  # list[OracleQuery]


@dataclass
class Proof:
    proof_config: ProofConfig
    public_inputs: list  # u64 values
    witness_oracle_cap: list
    stage_2_oracle_cap: list
    quotient_oracle_cap: list
    final_fri_monomials: tuple  # ([c0 coeffs], [c1 coeffs])
    values_at_z: list  # (c0, c1) tuples
    values_at_z_omega: list
    values_at_0: list
    fri_base_oracle_cap: list
    fri_intermediate_oracles_caps: list
    queries_per_fri_repetition: list  # list[SingleRoundQueries]
    pow_challenge: int = 0


@dataclass
class VerificationKeyCircuitGeometry:
    """Everything the verifier needs to rebuild the protocol shape
    (reference VerificationKeyCircuitGeometry)."""

    geometry: object  # CSGeometry
    lookup_parameters: object  # LookupParameters
    domain_size: int
    total_tables_len: int
    public_inputs_locations: list
    extra_constant_polys_for_selectors: int
    table_ids_column_idxes: list
    quotient_degree: int
    selector_paths: list  # per general evaluator: list[bool]
    evaluator_specs: list  # per general evaluator: registry spec (name, params)
    fri_lde_factor: int
    cap_size: int
    num_variable_polys: int
    num_witness_polys: int
    num_constant_polys: int
    num_multiplicity_polys: int
    # specialized (UniqueOnRow) gates: registry specs + (name, start, reps)
    specialized_evaluator_specs: list = None
    gate_spec_layout: list = None
    # pinned proof parameters: when set, verify() rejects proofs whose
    # proof_config declares a different security level / grinding
    # (the proof_config inside a Proof is attacker-controlled)
    security_level: int = None
    pow_bits: int = None


@dataclass
class VerificationKey:
    fixed_parameters: VerificationKeyCircuitGeometry
    setup_merkle_tree_cap: list


# -- JSON helpers -----------------------------------------------------------


def _cap_to_json(cap):
    out = []
    for el in cap:
        if isinstance(el, (bytes, bytearray)):
            out.append({"bytes": el.hex()})
        else:
            out.append({"felts": [int(x) for x in el]})
    return out


def _query_to_json(q: OracleQuery):
    return {"leaf_elements": [int(x) for x in q.leaf_elements],
            "proof": _cap_to_json(q.proof)}


def proof_to_json(p: Proof) -> str:
    return json.dumps({
        "proof_config": {
            "fri_lde_factor": p.proof_config.fri_lde_factor,
            "merkle_tree_cap_size": p.proof_config.merkle_tree_cap_size,
            "security_level": p.proof_config.security_level,
            "pow_bits": p.proof_config.pow_bits,
            "pow_hash": p.proof_config.pow_hash,
        },
        "public_inputs": [int(x) for x in p.public_inputs],
        "witness_oracle_cap": _cap_to_json(p.witness_oracle_cap),
        "stage_2_oracle_cap": _cap_to_json(p.stage_2_oracle_cap),
        "quotient_oracle_cap": _cap_to_json(p.quotient_oracle_cap),
        "final_fri_monomials": [[int(x) for x in m] for m in p.final_fri_monomials],
        "values_at_z": [[int(a), int(b)] for a, b in p.values_at_z],
        "values_at_z_omega": [[int(a), int(b)] for a, b in p.values_at_z_omega],
        "values_at_0": [[int(a), int(b)] for a, b in p.values_at_0],
        "fri_base_oracle_cap": _cap_to_json(p.fri_base_oracle_cap),
        "fri_intermediate_oracles_caps":
            [_cap_to_json(c) for c in p.fri_intermediate_oracles_caps],
        "pow_challenge": p.pow_challenge,
        "queries_per_fri_repetition": [
            {"witness_query": _query_to_json(q.witness_query),
             "stage_2_query": _query_to_json(q.stage_2_query),
             "quotient_query": _query_to_json(q.quotient_query),
             "setup_query": _query_to_json(q.setup_query),
             "fri_queries": [_query_to_json(f) for f in q.fri_queries]}
            for q in p.queries_per_fri_repetition
        ],
    })
