"""Reference digest of the flagship proof, for the PyTorch port's chip smoke.

Runs the JAX package's host `prove` on the flagship 8 kB SHA-256 circuit (the
circuit, input and config of `bench.py`) and writes the sha256 of
`proof_to_json(proof)` to `boojum_tpu_torch/data/flagship_proof_digest.json`,
together with the seed, input length, config and transcript/hasher kinds.
`chip_smoke.py` holds the port's proof against that digest on the GPU, where
JAX is not installed. The host `prove` and `DeviceProver` emit equal bytes
(`tests/test_prove_verify.py::test_device_prover_matches_host`).

Run on a CPU (takes a few minutes):

    python3 scripts/torch_reference_digest.py [--out PATH]
"""

import argparse
import hashlib
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

SEED = 42
INPUT_LEN = 8192
MAX_TRACE_LEN = 1 << 17
CONFIG = dict(fri_lde_factor=8, merkle_tree_cap_size=16, security_level=100,
              pow_bits=0)
TRANSCRIPT, HASHER = "poseidon", "poseidon2"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "boojum_tpu_torch", "data", "flagship_proof_digest.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from boojum_tpu.cs.setup import create_base_setup
    from boojum_tpu.prover import ProofConfig, create_setup_and_vk, prove
    from boojum_tpu.prover.proof import proof_to_json
    from tests.test_sha256 import build_sha256_circuit

    t_all = time.time()
    data = bytes(np.random.default_rng(SEED).integers(0, 256, INPUT_LEN,
                                                      dtype=np.uint8))
    t0 = time.time()
    cs, _ = build_sha256_circuit(data, MAX_TRACE_LEN)
    cs.pad_and_shrink()
    t_synth = time.time() - t0
    t0 = time.time()
    sb = create_base_setup(cs)
    cfg = ProofConfig(**CONFIG)
    art = create_setup_and_vk(cs, sb, cfg, HASHER)
    t_setup = time.time() - t0
    t0 = time.time()
    proof = prove(cs, art, cfg, TRANSCRIPT, HASHER)
    t_prove = time.time() - t0
    text = proof_to_json(proof)
    rec = {
        "circuit": "sha256 (tests/test_sha256.build_sha256_circuit)",
        "seed": SEED,
        "input_len": INPUT_LEN,
        "max_trace_len": MAX_TRACE_LEN,
        "domain": cs.final_trace_len if hasattr(cs, "final_trace_len") else None,
        "config": CONFIG,
        "transcript": TRANSCRIPT,
        "hasher": HASHER,
        "proof_json_chars": len(text),
        "proof_json_sha256": hashlib.sha256(text.encode()).hexdigest(),
        "made_by": "scripts/torch_reference_digest.py (boojum_tpu host prove)",
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({**rec, "synthesis_s": t_synth, "setup_s": t_setup,
                      "prove_s": t_prove, "wall_s": time.time() - t_all}))


if __name__ == "__main__":
    main()
