"""Reference digest of the flagship proof, for the PyTorch port's chip smoke.

Runs the JAX package's host `prove` on the flagship 8 kB SHA-256 circuit (the
circuit, input and config of `bench.py`) and writes the sha256 of
`proof_to_json(proof)` to `boojum_tpu_torch/data/flagship_proof_digest.json`,
together with the seed, input length, config and transcript/hasher kinds.
`chip_smoke.py` holds the port's proof against that digest on the GPU, where
JAX is not installed. The host `prove` and `DeviceProver` emit equal bytes
(`tests/test_prove_verify.py::test_device_prover_matches_host`).

Run on a CPU (a few minutes for the Poseidon2 and Blake2s trees; the
reference's Keccak-256 trees hash in pure Python and take about an hour):

    python3 scripts/torch_reference_digest.py [--transcript KIND]
        [--hasher KIND] [--out PATH]

The defaults are the flagship's Poseidon transcript and Poseidon2 trees
(`flagship_proof_digest.json`); `--transcript blake2s --hasher blake2s`
writes `flagship_blake2s_proof_digest.json` and `--transcript keccak256
--hasher keccak256` writes `flagship_keccak256_proof_digest.json`.
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
KINDS = ("poseidon", "poseidon2", "blake2s", "keccak256")


def default_out(transcript, hasher):
    name = ("flagship_proof_digest.json"
            if (transcript, hasher) == ("poseidon", "poseidon2")
            else "flagship_%s_proof_digest.json" % hasher)
    return os.path.join(ROOT, "boojum_tpu_torch", "data", name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--transcript", default="poseidon", choices=KINDS)
    ap.add_argument("--hasher", default="poseidon2", choices=KINDS[1:])
    ap.add_argument("--out", default=None,
                    help="default: boojum_tpu_torch/data/flagship_proof_"
                    "digest.json, or flagship_<hasher>_proof_digest.json "
                    "for another configuration")
    args = ap.parse_args()
    transcript, hasher = args.transcript, args.hasher
    out_path = args.out or default_out(transcript, hasher)

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
    art = create_setup_and_vk(cs, sb, cfg, hasher)
    t_setup = time.time() - t0
    t0 = time.time()
    proof = prove(cs, art, cfg, transcript, hasher)
    t_prove = time.time() - t0
    text = proof_to_json(proof)
    rec = {
        "circuit": "sha256 (tests/test_sha256.build_sha256_circuit)",
        "seed": SEED,
        "input_len": INPUT_LEN,
        "max_trace_len": MAX_TRACE_LEN,
        "domain": cs.final_trace_len if hasattr(cs, "final_trace_len") else None,
        "config": CONFIG,
        "transcript": transcript,
        "hasher": hasher,
        "proof_json_chars": len(text),
        "proof_json_sha256": hashlib.sha256(text.encode()).hexdigest(),
        "made_by": "scripts/torch_reference_digest.py (boojum_tpu host prove)",
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({**rec, "synthesis_s": t_synth, "setup_s": t_setup,
                      "prove_s": t_prove, "wall_s": time.time() - t_all}))


if __name__ == "__main__":
    main()
