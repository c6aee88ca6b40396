"""Prover: the full IOP pipeline on torch tensors (reference
src/cs/implementations/prover.rs)."""

from .device_prover import DeviceProver, create_device_setup  # noqa: F401
from .proof import Proof, ProofConfig, VerificationKey  # noqa: F401
from .prover import ProvingArtifacts, create_setup_and_vk, prove  # noqa: F401
from .convenience import (prepare_setup_and_vk, prove_one_shot,  # noqa: F401
                          verify_circuit)
