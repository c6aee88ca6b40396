"""Where a prove's time goes on the GPU, for the PyTorch port.

Builds one configuration's circuit (seed, input and proof config from its
digest file in `boojum_tpu_torch/data/`), runs setup and one warm-up prove
on the card, then one prove under `torch.profiler` (CUDA activity) and
prints one JSON line: the prove's wall time, the summed device time of its
kernels, the device's idle share (1 - busy / wall), the launch count, and
the kernels with the most device time. The profiler's own overhead
inflates the wall time of the profiled prove, so the idle share is also
given against the unprofiled warm prove's wall time.

    python3 scripts/torch_profile_flagship.py [--config NAME]

``--config flagship`` (the default): the 8 kB SHA-256 circuit
(`flagship_proof_digest.json`). ``flagship_poseidon``: the same circuit
with classic-Poseidon trees (`flagship_poseidon_proof_digest.json`: tree
hasher "poseidon", kernels `poseidon_leaf_hashes` / `poseidon_node_layer`).
``keccak256``: the 1 kB Keccak-256 circuit
(`keccak256_1kB_proof_digest.json`). ``recursion_outer``: the outer proof
of the recursion configuration (`recursion_outer_proof_digest.json`; its
inner proof is made first). ``lookup_heavy`` / ``lookup_heavy_general``:
the lookup-heavy circuit of BASELINE config 4, specialized or
general-purpose (`lookup_heavy_proof_digest.json`,
`lookup_heavy_general_proof_digest.json`). Each prove's digest is checked.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOP = 12  # kernels listed by device time


def build(config):
    """The prover of ``config`` on the card, its proof kinds and the
    reference digest of its proof."""
    import numpy as np
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup,
                                         prepare_setup_and_vk)

    def load(name):
        with open(os.path.join(ROOT, "boojum_tpu_torch", "data", name)) as f:
            return json.load(f)

    if config == "recursion_outer":
        from boojum_tpu_torch.gadgets.recursion.circuits import (
            build_inner_circuit, build_outer_circuit)
        ref = load("recursion_outer_proof_digest.json")
        iref, ref = ref["inner"], ref["outer"]
        icfg = ProofConfig(**iref["config"])
        inner = build_inner_circuit(np.random.default_rng(iref["seed"]))
        iart = prepare_setup_and_vk(inner, icfg, iref["hasher"], device="cuda")
        inner_proof = DeviceProver(inner, iart, icfg, device="cuda").prove(
            iref["transcript"], iref["hasher"])
        cs = build_outer_circuit(iart.vk, inner_proof, icfg,
                                 iref["transcript"], iref["hasher"],
                                 ref["max_trace_len"])
    elif config.startswith("lookup_heavy"):
        from boojum_tpu_torch.gadgets.lookup_heavy import \
            build_lookup_heavy_circuit
        ref = load(config + "_proof_digest.json")
        cs = build_lookup_heavy_circuit(
            ref["n_lookups"], ref["seed"],
            "general" if config.endswith("general") else "specialized")
    else:
        if config == "keccak256":
            from boojum_tpu_torch.gadgets.keccak256 import \
                build_keccak256_circuit as build_circuit
            ref = load("keccak256_1kB_proof_digest.json")
        else:
            from boojum_tpu_torch.gadgets.sha256 import \
                build_sha256_circuit as build_circuit
            ref = load("flagship_poseidon_proof_digest.json"
                       if config == "flagship_poseidon"
                       else "flagship_proof_digest.json")
        data = bytes(np.random.default_rng(ref["seed"]).integers(
            0, 256, ref["input_len"], dtype=np.uint8))
        cs, _ = build_circuit(data, ref["max_trace_len"])
        cs.pad_and_shrink()
    cfg = ProofConfig(**ref["config"])
    art = create_device_setup(cs, create_base_setup(cs), cfg, ref["hasher"],
                              device="cuda")
    prover = DeviceProver(cs, art, cfg, device="cuda")
    return prover, (ref["transcript"], ref["hasher"]), ref["proof_json_sha256"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "flagship_poseidon", "keccak256",
                             "recursion_outer", "lookup_heavy",
                             "lookup_heavy_general"))
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_flagship: CUDA is not available", file=sys.stderr)
        return 1
    from boojum_tpu_torch.prover.proof import proof_to_json

    prover, kinds, sha = build(args.config)

    def check(proof):
        if hashlib.sha256(proof_to_json(proof).encode()).hexdigest() != sha:
            raise AssertionError("the %s proof differs from the reference"
                                 % args.config)

    check(prover.prove(*kinds))
    torch.cuda.synchronize()
    t0 = time.time()
    check(prover.prove(*kinds))
    torch.cuda.synchronize()
    warm = time.time() - t0

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        proof = prover.prove(*kinds)
        torch.cuda.synchronize()
        wall = time.time() - t0
    check(proof)
    t0 = time.time()

    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:  # union of kernel intervals
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    first = spans[0][0] if spans else 0.0
    last = max((e for _, e in spans), default=0.0)
    by_name = {}
    for e in events:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.end - e.time_range.start
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "config": args.config,
        "card": card,
        "warm_prove_s": warm,
        "profiled_prove_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_span_s": (last - first) / 1e6,
        "idle_share_of_span": 1 - busy_us / max(last - first, 1e-9),
        "idle_share_of_warm_prove": 1 - busy_us / 1e6 / warm,
        "kernel_launches": len(events),
        "profile_processing_s": time.time() - t0,
        "top_kernels": [{"name": n[:90], "device_ms": t / 1e3, "count": c}
                        for n, (t, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
