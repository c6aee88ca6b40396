"""A small SHA-256 proof through the port's default stages on the CPU: the
device witness program and the device transcript (through the plain versions
of kernels K5 and K6) give the JAX host `prove`'s proof byte for byte, and
the JAX verifier accepts it. In a file of its own: at 2^14 rows it is the
longest of the port's tests (about 1.5 to 3 minutes) and, under
pytest-xdist, one of the last to start: its prove runs torch on every core
(`tests/torch_small_circuit.share_cores` gives the other workers one share
each), since its 2^16-element tensors gain from threads where the small
ones of the other files do not."""

import os

import numpy as np
import torch

from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.prover import create_setup_and_vk, prove
from boojum_tpu.prover.proof import proof_to_json as ref_proof_to_json
from boojum_tpu.verifier import verify
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.gadgets import sha256 as sha
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover.proof import proof_to_json
from tests.test_sha256 import build_sha256_circuit as ref_build


def test_device_witness_prove_byte_identical():
    """A small SHA-256 proof with the device witness program and the device
    transcript (both through their plain versions on the CPU) equals the JAX
    host `prove`, and the JAX verifier accepts it."""
    data = bytes(np.random.default_rng(5).integers(0, 256, 40, dtype=np.uint8))
    ref_cs, _ = ref_build(data)
    cs, _ = sha.build_sha256_circuit(data)
    for c in (ref_cs, cs):
        c.pad_and_shrink()
    cfg = dict(fri_lde_factor=4, merkle_tree_cap_size=4)
    ref_art = create_setup_and_vk(ref_cs, ref_create_base_setup(ref_cs),
                                  RefProofConfig(**cfg), "poseidon2")
    ref_proof = prove(ref_cs, ref_art, RefProofConfig(**cfg), "poseidon",
                      "poseidon2")
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        art = create_device_setup(cs, create_base_setup(cs),
                                  ProofConfig(**cfg), "poseidon2",
                                  device="cpu")
        prover = DeviceProver(cs, art, ProofConfig(**cfg), device="cpu")
        proof = prover.prove("poseidon", "poseidon2", device_transcript=True)
    finally:
        torch.set_num_threads(threads)
    assert prover.witness_program() is not None
    assert proof_to_json(proof) == ref_proof_to_json(ref_proof)
    assert verify(ref_art.vk, proof, "poseidon", "poseidon2")
