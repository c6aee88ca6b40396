# Copied from boojum_tpu/prover/prover.py (the host parts the device prover uses).
"""Host-side parts of the proving pipeline shared by the device prover.

Reference behavior: prove_cpu_basic (src/cs/implementations/prover.rs:153).
The stage sequence itself is `device_prover.DeviceProver.prove`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cs.cs import ConstraintSystem
from ..cs.setup import SetupBase
from ..utils import npgl
from .proof import ProofConfig, VerificationKey, VerificationKeyCircuitGeometry

P = npgl.ORDER


# ---------------------------------------------------------------------------
# Witness materialization (reference take_witness_using_hints, witness.rs)
# ---------------------------------------------------------------------------


def materialize_witness_columns(cs: ConstraintSystem, n: int):
    """Gather resolved values into (num_var_polys, n), (num_wit_polys, n),
    (num_mult_polys, n) host u64; placeholder cells are zero."""
    copy_cols, wit_cols, spec_cols = cs.materialize_value_columns(n)
    variables = np.concatenate([copy_cols, spec_cols], axis=0)
    mults = _multiplicity_columns(cs, n)
    return variables, wit_cols, mults


def _multiplicity_columns(cs: ConstraintSystem, n: int) -> np.ndarray:
    if not cs.lookup_parameters.lookup_is_allowed:
        return np.zeros((0, n), np.uint64)
    col = np.zeros(n, np.uint64)
    idx = 0
    for mults in cs.lookup_multiplicities:
        m = mults.shape[0]
        col[idx:idx + m] = mults.astype(np.uint64)
        idx += m
    return col[None, :]


def _s2(c):  # host scalar ext tuple
    return (int(c[0]) % P, int(c[1]) % P)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@dataclass
class ProvingArtifacts:
    """Everything reusable across proofs of the same circuit."""
    setup_base: SetupBase
    setup_oracle: "DeviceOracle"
    vk: VerificationKey


def make_vk(cs: ConstraintSystem, setup_base: SetupBase,
            proof_config: ProofConfig, setup_cap) -> VerificationKey:
    """VK from an already-committed setup cap (shared by the host and
    device setup paths; reference materialize_setup_storage_and_vk)."""
    evaluator_specs = [(ev.name, ev.spec_params())
                       for ev in cs.evaluators_general]
    specialized_specs = [(ev.name, ev.spec_params())
                         for ev in cs.evaluators_specialized]
    fixed = VerificationKeyCircuitGeometry(
        geometry=cs.geometry,
        lookup_parameters=cs.lookup_parameters,
        domain_size=setup_base.domain_size,
        total_tables_len=cs.lookups_tables_total_len(),
        public_inputs_locations=list(cs.public_inputs),
        extra_constant_polys_for_selectors=(
            setup_base.num_general_constant_columns
            - cs.geometry.num_constant_columns),
        table_ids_column_idxes=list(setup_base.table_ids_column_idxes),
        quotient_degree=setup_base.quotient_degree,
        selector_paths=[list(p) for p in setup_base.selector_paths],
        evaluator_specs=evaluator_specs,
        fri_lde_factor=proof_config.fri_lde_factor,
        cap_size=proof_config.merkle_tree_cap_size,
        num_variable_polys=(cs.geometry.num_columns_under_copy_permutation
                            + (cs.specialized_copy_data.shape[0]
                               if cs.specialized_copy_data is not None else 0)
                            + (cs.gate_spec_data.shape[0]
                               if cs.gate_spec_data is not None else 0)),
        specialized_evaluator_specs=specialized_specs,
        gate_spec_layout=[list(t) for t in cs.gate_spec_layout],
        num_witness_polys=cs.geometry.num_witness_columns,
        num_constant_polys=setup_base.constant_columns.shape[0],
        num_multiplicity_polys=(1 if cs.lookup_parameters.lookup_is_allowed else 0),
        security_level=proof_config.security_level,
        pow_bits=proof_config.pow_bits,
    )
    return VerificationKey(fixed_parameters=fixed,
                           setup_merkle_tree_cap=setup_cap)


def _u64_from_lsb(bits) -> int:
    v = 0
    for i, b in enumerate(bits):
        if b:
            v |= 1 << i
    return v


class _BoolsBuffer:
    """Reference BoolsBuffer (transcript.rs:369)."""

    def __init__(self, max_needed: int):
        self.available: list[bool] = []
        self.max_needed = max_needed

    def get_bits(self, transcript, num_bits: int):
        while len(self.available) < num_bits:
            if transcript.IS_ALGEBRAIC:
                bits_available = 64 - self.max_needed
                el = transcript.get_challenge()
                for i in range(bits_available):
                    self.available.append(bool((el >> i) & 1))
            else:
                chunk = transcript.get_challenge_bytes(8)
                v = int.from_bytes(chunk, "little")
                for i in range(64):
                    self.available.append(bool((v >> i) & 1))
        out = self.available[:num_bits]
        del self.available[:num_bits]
        return out
