"""Where the flagship prove's time goes on the GPU, for the PyTorch port.

Synthesizes the flagship 8 kB SHA-256 circuit (seed, input length and proof
config from `boojum_tpu_torch/data/flagship_proof_digest.json`), runs setup and one warm-up prove on the card, then one prove under
`torch.profiler` and prints one JSON line: the prove's wall time, the summed
device time of its kernels, the device's idle share (1 - busy / wall), the
launch count, and the kernels with the most device time. The profiler's own
overhead inflates the wall time of the profiled prove, so the idle share is
also given against the unprofiled warm prove's wall time.

    python3 scripts/torch_profile_flagship.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOP = 12  # kernels listed by device time


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_flagship: CUDA is not available", file=sys.stderr)
        return 1
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.gadgets.sha256 import build_sha256_circuit
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)

    with open(os.path.join(ROOT, "boojum_tpu_torch", "data",
                           "flagship_proof_digest.json")) as f:
        ref = json.load(f)
    data = bytes(np.random.default_rng(ref["seed"]).integers(
        0, 256, ref["input_len"], dtype=np.uint8))
    cs, _ = build_sha256_circuit(data, max_trace_len=ref["max_trace_len"])
    cs.pad_and_shrink()
    cfg = ProofConfig(**ref["config"])
    art = create_device_setup(cs, create_base_setup(cs), cfg, ref["hasher"],
                              device="cuda")
    prover = DeviceProver(cs, art, cfg, device="cuda")
    kinds = (ref["transcript"], ref["hasher"])
    prover.prove(*kinds)
    torch.cuda.synchronize()
    t0 = time.time()
    prover.prove(*kinds)
    torch.cuda.synchronize()
    warm = time.time() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        prover.prove(*kinds)
        torch.cuda.synchronize()
        wall = time.time() - t0

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
        "card": card,
        "warm_prove_s": warm,
        "profiled_prove_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_span_s": (last - first) / 1e6,
        "idle_share_of_span": 1 - busy_us / max(last - first, 1e-9),
        "idle_share_of_warm_prove": 1 - busy_us / 1e6 / warm,
        "kernel_launches": len(events),
        "top_kernels": [{"name": n[:90], "device_ms": t / 1e3, "count": c}
                        for n, (t, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
