"""What a multiply by a scalar costs on the GPU, by the scalar's kind.

The prover multiplies column tensors by challenges. With the host
transcript a challenge is a Python int; with the device transcript it lives
on the card, either as a 0-dim tensor (split into limbs at every call) or
as a `goldilocks.Prepared` scalar (split once when drawn). This script
times, on one (2^16,) int64 field tensor (the flagship's base-domain
columns), one raw torch op with each operand kind and one `gl.mul` /
`ext2.scale` with each scalar kind: the host wall clock a call (N calls
back to back, then one synchronize: the launch-bound rate the prove sees)
and the kernels a call launches (`torch.profiler`, CUDA activity). Prints
one JSON line a case and the card's name and power limit.

    python3 scripts/torch_scalar_cost.py
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N = 2000  # calls timed a case
SIZE = 1 << 16


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_scalar_cost: CUDA is not available", file=sys.stderr)
        return 1
    from boojum_tpu_torch.field import extension as ext2
    from boojum_tpu_torch.field import goldilocks as gl

    rng = np.random.default_rng(3)
    a = gl.from_u64(rng.integers(0, gl.ORDER, SIZE, dtype=np.uint64), "cuda")
    b = gl.from_u64(rng.integers(0, gl.ORDER, SIZE, dtype=np.uint64), "cuda")
    c = [int(v) for v in rng.integers(0, gl.ORDER, 2, dtype=np.uint64)]
    pair = gl.from_u64(np.asarray(c, np.uint64), "cuda")  # a device challenge
    scalar = pair[0]  # a 0-dim device tensor
    prepared = ext2.prepare(pair)[0]
    cases = {
        "raw a * host int": lambda: a * 0xFFFF,
        "raw a * 0-dim device tensor": lambda: a * scalar,
        "gl.mul by host int": lambda: gl.mul(a, c[0]),
        "gl.mul by 0-dim device tensor (split each call)":
            lambda: gl.mul(a, scalar),
        "gl.mul by Prepared": lambda: gl.mul(a, prepared.c0),
        "ext2.scale by host pair": lambda: ext2.scale((a, b), tuple(c)),
        "ext2.scale by (2,) device tensor (split each call)":
            lambda: ext2.scale((a, b), pair),
        "ext2.scale by PreparedExt": lambda: ext2.scale((a, b), prepared),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    # in turns: every case twice, the second pass in reverse order
    order = list(cases) + list(cases)[::-1]
    walls = {name: [] for name in cases}
    for name in order:
        fn = cases[name]
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N):
            fn()
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) / N * 1e6)
    for name, fn in cases.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        print(json.dumps(dict(
            case=name, card=card, us_per_call=[round(w, 2) for w in
                                               walls[name]],
            kernels_per_call=len(kernels),
            device_us_per_call=round(sum(e.time_range.end
                                         - e.time_range.start
                                         for e in kernels), 2))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
