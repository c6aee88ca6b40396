"""Reference digest of a 2^24-point NTT, for the PyTorch port's chip smoke.

Runs the JAX package's `ntt.ntt_fourstep_cols` (natural -> bitreversed, the
same function as `pallas_ntt.ntt_any`; `tests/test_torch_pallas_ntt.py` holds
the two equal at small sizes) jitted under XLA:CPU on the (2^24, 8) input
``np.random.default_rng(5).integers(0, P, (2**24, 8), dtype=np.uint64)`` and
writes the sha256 of the output's u64 bytes (C order, little-endian) to
`boojum_tpu_torch/data/ntt_2e24_digest.json`, with the seed, the shape and
the first two output rows. Those two rows are checked against exact sums
first: bitreversed row 0 is f(1), the column sum, and row 1 is f(-1), the
alternating sum. `chip_smoke.py` holds the port's `pallas_ntt.ntt_any` and
`ntt.ntt_fourstep_cols` against the digest on the GPU, where JAX is not
installed.

Run on a CPU (about a minute, 7.3 GB of host memory at its peak):

    python3 scripts/torch_reference_ntt_digest.py [--out PATH]
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

SEED = 5
SHAPE = (1 << 24, 8)


def _col_sums_mod_p(x, p):
    """Exact sum mod p of each column of a u64 array (32-bit halves, so the
    partial sums of up to 2^31 rows stay below 2^63)."""
    lo = (x & np.uint64(0xFFFFFFFF)).sum(axis=0, dtype=np.uint64)
    hi = (x >> np.uint64(32)).sum(axis=0, dtype=np.uint64)
    return [(int(h) * (1 << 32) + int(lo_)) % p for lo_, h in zip(lo, hi)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "boojum_tpu_torch", "data", "ntt_2e24_digest.json"))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from boojum_tpu.field import goldilocks as gl
    from boojum_tpu.ntt import ntt

    p = gl.ORDER
    t0 = time.time()
    x = np.random.default_rng(SEED).integers(0, p, SHAPE, dtype=np.uint64)
    out = gl.to_u64(jax.jit(ntt.ntt_fourstep_cols)(gl.from_u64(x)))
    t_ntt = time.time() - t0
    even, odd = _col_sums_mod_p(x[0::2], p), _col_sums_mod_p(x[1::2], p)
    assert [int(v) for v in out[0]] == [(e + o) % p for e, o in zip(even, odd)]
    assert [int(v) for v in out[1]] == [(e - o) % p for e, o in zip(even, odd)]
    rec = {
        "function": "boojum_tpu.ntt.ntt.ntt_fourstep_cols (XLA:CPU)",
        "seed": SEED,
        "shape": list(SHAPE),
        "input": "np.random.default_rng(seed).integers(0, P, shape, "
                 "dtype=np.uint64)",
        "output_u64_sha256": hashlib.sha256(
            out.astype("<u8").tobytes()).hexdigest(),
        "rows_0_1": [[str(int(v)) for v in out[r]] for r in (0, 1)],
        "made_by": "scripts/torch_reference_ntt_digest.py",
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({"output_u64_sha256": rec["output_u64_sha256"],
                      "ntt_s": t_ntt, "wall_s": time.time() - t0}))


if __name__ == "__main__":
    main()
