"""Warm proves of two versions of the port, in turns, on one card.

Each version is ``LABEL=DIR``: a directory holding a tree of this
repository (its `boojum_tpu_torch` package and
`scripts/torch_profile_flagship.py`), for example the parent commit
unpacked by ``git archive <commit> | tar -x -C DIR`` into a directory that
`.gitignore` lists. For each configuration the versions run in the order
A B B A, one process a run: it builds the configuration
(`torch_profile_flagship.build`: circuit, setup and prover, each version
with its own code and kernels, built into its own `_build/`), proves it
once cold and ``--warm`` times warm, each proof held to the reference
digest, and prints one JSON line; then one line a configuration gives each
version's warm proves. ``--prover`` is `torch_profile_flagship.build`'s
``prover_kind`` (device, host or sharded). Needs the card:

    python3 scripts/torch_prove_compare.py [--config flagship,recursion_outer] [--warm 3] [--prover sharded] old=DIR new=.
"""

import argparse
import json
import os
import subprocess
import sys

# one run: build, a cold prove and the warm proves, each digest checked
CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, ".")
import torch
from scripts.torch_profile_flagship import build
from boojum_tpu_torch.prover.proof import proof_to_json
config, warm, prover = sys.argv[1], int(sys.argv[2]), sys.argv[3]
run, sha = build(config, prover)
times = []
for _ in range(1 + warm):
    t = time.time()
    proof = run()
    torch.cuda.synchronize()
    times.append(time.time() - t)
    if hashlib.sha256(proof_to_json(proof).encode()).hexdigest() != sha:
        raise SystemExit("a %s proof differs from the reference" % config)
print(json.dumps(dict(cold_s=round(times[0], 4),
                      warm_s=[round(t, 4) for t in times[1:]])))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="flagship,recursion_outer",
                    help="comma-separated configurations of "
                         "torch_profile_flagship.build")
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--prover", default="device",
                    choices=("device", "host", "sharded"))
    ap.add_argument("versions", nargs=2, metavar="LABEL=DIR")
    args = ap.parse_args()
    versions = [v.split("=", 1) for v in args.versions]
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(out, flush=True)
    for config in args.config.split(","):
        warm = {label: [] for label, _ in versions}
        for label, tree in versions + versions[::-1]:
            res = subprocess.run(
                [sys.executable, "-c", CHILD, config, str(args.warm),
                 args.prover],
                cwd=os.path.abspath(tree), capture_output=True, text=True)
            if res.returncode != 0:
                sys.stderr.write(res.stdout + res.stderr)
                raise SystemExit("%s failed on %s" % (label, config))
            line = json.loads(res.stdout.strip().splitlines()[-1])
            warm[label] += line["warm_s"]
            print(json.dumps(dict(config=config, version=label, **line)),
                  flush=True)
        print(json.dumps(dict(config=config, warm_s={
            label: dict(runs=ts, mean=round(sum(ts) / len(ts), 4))
            for label, ts in warm.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
