"""Where a prove's time goes on the GPU, for the PyTorch port.

Builds one configuration's circuit (seed, input and proof config from its
digest file in `boojum_tpu_torch/data/`), runs setup and one warm-up prove
on the card, then one prove under `torch.profiler` (CUDA activity) and
prints one JSON line: the prove's wall time, the summed device time of its
kernels, the device's idle share (1 - busy / wall), the launch count, and
the kernels with the most device time, and the port's hand kernels'
launches in the timed prove. The profiler's own overhead
inflates the wall time of the profiled prove, so the idle share is also
given against the unprofiled warm prove's wall time.

    python3 scripts/torch_profile_flagship.py [--config NAME] [--prover host|sharded]

``--config flagship`` (the default): the 8 kB SHA-256 circuit
(`flagship_proof_digest.json`). ``flagship_poseidon``: the same circuit
with classic-Poseidon trees (`flagship_poseidon_proof_digest.json`: tree
hasher "poseidon", kernels `poseidon_leaf_hashes` / `poseidon_node_layers`).
``keccak256``: the 1 kB Keccak-256 circuit
(`keccak256_1kB_proof_digest.json`). ``recursion_outer``: the outer proof
of the recursion configuration (`recursion_outer_proof_digest.json`; its
inner proof is made first). ``lookup_heavy`` / ``lookup_heavy_general``:
the lookup-heavy circuit of BASELINE config 4, specialized or
general-purpose (`lookup_heavy_proof_digest.json`,
`lookup_heavy_general_proof_digest.json`). Each prove's digest is checked.

``--prover host`` proves with the port's host `prove` (host numpy stages;
LDEs, NTTs and trees on the card) and its `create_setup_and_vk` instead of
`DeviceProver`: one timed prove, no warm-up (a host prove keeps no device
state between proves), then the profiled one. ``--prover sharded`` proves
through `parallel/` (`create_device_setup` and `DeviceProver` with
``mesh=make_mesh()``) over an NCCL group of one rank made in the process
(its store a FileStore in a temporary directory), as `chip_smoke.py`'s
sharded flagship does.
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


def one_rank_mesh():
    """The mesh of an NCCL group of one rank in this process, on cuda:0;
    the group is destroyed and its store removed at exit."""
    import atexit
    import shutil
    import tempfile
    import torch.distributed as dist
    from boojum_tpu_torch.parallel import make_mesh
    tmp = tempfile.mkdtemp(prefix="torch_profile_store_")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    atexit.register(shutil.rmtree, tmp, True)
    atexit.register(dist.destroy_process_group)
    return make_mesh()


def build(config, prover_kind="device"):
    """A prove of ``config`` on the card by ``prover_kind`` (`DeviceProver`,
    the host `prove`, or "sharded": `DeviceProver` over `one_rank_mesh`),
    as a function of no arguments, and the reference digest of its
    proof."""
    import numpy as np
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup,
                                         create_setup_and_vk,
                                         prepare_setup_and_vk, prove)

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
    kinds = (ref["transcript"], ref["hasher"])
    if prover_kind == "host":
        art = create_setup_and_vk(cs, create_base_setup(cs), cfg,
                                  ref["hasher"], device="cuda")
        return (lambda: prove(cs, art, cfg, *kinds, device="cuda"),
                ref["proof_json_sha256"])
    if prover_kind == "sharded":
        mesh = one_rank_mesh()
        art = create_device_setup(cs, create_base_setup(cs), cfg,
                                  ref["hasher"], mesh=mesh)
        prover = DeviceProver(cs, art, cfg, mesh=mesh)
    else:
        art = create_device_setup(cs, create_base_setup(cs), cfg,
                                  ref["hasher"], device="cuda")
        prover = DeviceProver(cs, art, cfg, device="cuda")
    return (lambda: prover.prove(*kinds)), ref["proof_json_sha256"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "flagship_poseidon", "keccak256",
                             "recursion_outer", "lookup_heavy",
                             "lookup_heavy_general"))
    ap.add_argument("--prover", default="device",
                    choices=("device", "host", "sharded"))
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_flagship: CUDA is not available", file=sys.stderr)
        return 1
    from boojum_tpu_torch.prover.proof import proof_to_json

    run, sha = build(args.config, args.prover)
    from boojum_tpu_torch.gadgets import sha256_witness as sw
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.hash import poseidon
    from boojum_tpu_torch.ntt import mxu_ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    from boojum_tpu_torch.prover import quotient, stage23

    def launches():
        """The hand kernels' launch counters."""
        return dict(ntt_stage=mxu_ntt.LAUNCHES, ntt_small=pn.LAUNCHES,
                    poseidon2_leaf_hashes=pp.LEAF_LAUNCHES,
                    poseidon2_node_layer=pp.NODE_LAUNCHES,
                    poseidon2_node_layers=pp.NODE_LAYERS_LAUNCHES,
                    stage23_rows=stage23.LAUNCHES["stage23_rows"],
                    stage23_scan=stage23.LAUNCHES["stage23_scan"],
                    quotient_sweep=quotient.LAUNCHES["quotient_sweep"],
                    poseidon_sponge=poseidon.LAUNCHES,
                    poseidon_leaf_hashes=poseidon.LEAF_LAUNCHES,
                    poseidon_node_layer=poseidon.NODE_LAUNCHES,
                    poseidon_node_layers=poseidon.NODE_LAYERS_LAUNCHES,
                    sha256_witness=sw.LAUNCHES)

    def check(proof):
        if hashlib.sha256(proof_to_json(proof).encode()).hexdigest() != sha:
            raise AssertionError("the %s proof differs from the reference"
                                 % args.config)

    if args.prover != "host":
        check(run())  # the warm-up: the device prover's caches
    torch.cuda.synchronize()
    before = launches()
    t0 = time.time()
    check(run())
    torch.cuda.synchronize()
    warm = time.time() - t0
    hand = {k: v - before[k] for k, v in launches().items()}

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        proof = run()
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
        "prover": args.prover,
        "card": card,
        "warm_prove_s": warm,
        "profiled_prove_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_span_s": (last - first) / 1e6,
        "idle_share_of_span": 1 - busy_us / max(last - first, 1e-9),
        "idle_share_of_warm_prove": 1 - busy_us / 1e6 / warm,
        "kernel_launches": len(events),
        "hand_kernel_launches": hand,
        "profile_processing_s": time.time() - t0,
        "top_kernels": [{"name": n[:90], "device_ms": t / 1e3, "count": c}
                        for n, (t, c) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
