# Port of boojum_tpu/prover/convenience.py onto the device prover.
"""One-call proving / verification helpers.

Reference behavior: src/cs/implementations/convenience.rs:34-198
(`prove_one_shot`, `prepare_base_setup_with_precomputations_and_vk`,
`prove_from_precomputations`, `verify_circuit`). The port has no host
`prove`: the setup is the device setup and the prove is `DeviceProver`'s, on
the GPU unless the caller passes another ``device``.
"""

from __future__ import annotations

from ..cs.cs import ConstraintSystem
from ..cs.setup import create_base_setup
from .device_prover import DeviceProver, create_device_setup
from .proof import ProofConfig
from .prover import ProvingArtifacts


def prepare_setup_and_vk(cs: ConstraintSystem, proof_config: ProofConfig,
                         hasher: str = "poseidon2",
                         device="cuda") -> ProvingArtifacts:
    """Base setup + device setup oracle + VK in one call. The CS must
    already be pad_and_shrink'ed."""
    return create_device_setup(cs, create_base_setup(cs), proof_config,
                               hasher, device=device)


def prove_one_shot(cs: ConstraintSystem, proof_config: ProofConfig = None,
                   transcript_kind: str = "poseidon2",
                   hasher: str = "poseidon2", device="cuda"):
    """Finalize (if needed) + setup + prove on ``device``; returns
    (proof, vk)."""
    proof_config = proof_config or ProofConfig()
    if getattr(cs, "final_trace_len", None) is None:
        cs.pad_and_shrink()
    art = prepare_setup_and_vk(cs, proof_config, hasher, device)
    prover = DeviceProver(cs, art, proof_config, device=device)
    return prover.prove(transcript_kind, hasher), art.vk


def verify_circuit(vk, proof, transcript_kind: str = "poseidon2",
                   hasher: str = "poseidon2") -> bool:
    from ..verifier.verifier import verify
    return verify(vk, proof, transcript_kind, hasher)
