"""The plain Poseidon2 permutation on the CPU in chunks against one batch.

`boojum_tpu_torch.hash.poseidon2` runs a batch of CPU states in chunks of
`_CPU_STATES_PER_THREAD` states a thread. This times, for a few batch sizes
of random states, the chunked permutation and the whole batch in one
`_permutation_one`, twice each in turns, checks that both agree, and
prints one line a run: states, torch threads, route, seconds.

    python3 scripts/torch_plain_permutation_chunks.py [THREADS]
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from boojum_tpu_torch.field import goldilocks as gl  # noqa: E402
from boojum_tpu_torch.hash import poseidon2 as p2  # noqa: E402


def main(threads):
    torch.set_num_threads(threads)
    for states in (1 << 14, 1 << 16, 1 << 18):
        st = gl.from_u64(np.random.default_rng(1).integers(
            0, gl.ORDER, (12, states), dtype=np.uint64))
        outs = []
        for route, f in (("chunked", p2._permutation_stacked),
                         ("whole", p2._permutation_one)) * 2:
            t = time.perf_counter()
            outs.append(f(st))
            print(states, threads, route, time.perf_counter() - t,
                  flush=True)
        assert all(torch.equal(o, outs[0]) for o in outs)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
