"""The ranks of tests/test_torch_parallel.py: one process each, joined by a
gloo process group (torch and the port only, no JAX). Every rank runs the
port's distributed functions on its block of seeded inputs, in a group of
all ranks and in the group of ranks 0 and 1, and pickles what it got;
ranks 0 and 1 also prove the small circuit of tests/torch_circuits.py
sharded, and rank 2 proves it on one device.

    python -m tests.torch_parallel_ranks OUT_DIR   # with RANK, WORLD_SIZE
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

P = 0xFFFFFFFF00000001
# the distributed NTTs: rows 2^LOG_N, B columns, the coset of the coset legs
LOG_N, B, COSET = 10, 4, 7
# the sharded commit step: rows, LDE factor, columns (sharded over them)
COMMIT = dict(log_n=8, lde=4, k=16)
# the sharded trees: leaf elements, leaves, caps
TREE_K, TREE_M, TREE_CAPS = 12, 1 << 10, (8, 2)
TREE_LEAVES = (0, 5, 100, (1 << 10) - 1)  # whose paths are compared
GP_N = 1 << 10
PROOF_CFG = dict(fri_lde_factor=8, merkle_tree_cap_size=4, security_level=100,
                 pow_bits=0)


def inputs():
    """The seeded inputs, as host u64 arrays (the parent makes the same)."""
    def rand(seed, shape):
        return np.random.default_rng(seed).integers(0, P, shape,
                                                    dtype=np.uint64)
    return dict(ntt=rand(7, (1 << LOG_N, B)), gp=rand(11, (2, GP_N)),
                sum=rand(13, (16,)),
                commit=rand(3, (1 << COMMIT["log_n"], COMMIT["k"])),
                tree=rand(5, (TREE_K, TREE_M)))


def run_mesh(mesh, data):
    """Each distributed function on this rank's blocks; host u64 results."""
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.parallel import sharding as sh

    def t(a):
        return gl.from_u64(np.ascontiguousarray(a))

    out = {}
    x = t(data["ntt"][mesh.blocks(1 << LOG_N)])
    for coset in (1, COSET):
        y = sh.distributed_ntt(mesh, x, LOG_N, coset)
        out["ntt", coset] = gl.to_u64(y)
        out["intt", coset] = gl.to_u64(sh.distributed_intt(mesh, y, LOG_N,
                                                           coset))
    own = mesh.blocks(GP_N)
    gp = sh.distributed_grand_product(mesh, (t(data["gp"][0, own]),
                                             t(data["gp"][1, own])))
    out["gp"] = np.stack([gl.to_u64(c) for c in gp])
    out["sum"] = gl.to_u64(sh.distributed_sum_reduce(
        mesh, t(data["sum"][mesh.blocks(data["sum"].shape[0])])))
    cols = data["commit"][:, mesh.blocks(COMMIT["k"])]
    leaves, cap = sh.distributed_commit_step(mesh, t(cols), COMMIT["log_n"],
                                             COMMIT["lde"])
    out["commit"] = (gl.to_u64(leaves), gl.to_u64(cap))
    leaf_cols = t(data["tree"][:, mesh.blocks(TREE_M)])
    for cap_size in TREE_CAPS:
        tree = sh.build_sharded_tree(mesh, leaf_cols, cap_size)
        out["tree", cap_size] = (tree.get_cap(),
                                 [tree.get_proof(i) for i in TREE_LEAVES])
    return out


def prove(mesh):
    """The small circuit's proof (Poseidon transcript, Poseidon2 trees) on
    the CPU: sharded over ``mesh``, or on one device without one. Returns
    its `proof_to_json` and whether the port's `verify` accepts it."""
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)
    from boojum_tpu_torch.prover.proof import proof_to_json
    from boojum_tpu_torch.verifier import verify
    from tests.torch_circuits import build_small_circuit

    cs = build_small_circuit("boojum_tpu_torch", np.random.default_rng(11))
    cfg = ProofConfig(**PROOF_CFG)
    art = create_device_setup(cs, create_base_setup(cs), cfg, "poseidon2",
                              device="cpu", mesh=mesh)
    proof = DeviceProver(cs, art, cfg, device="cpu", mesh=mesh).prove(
        "poseidon", "poseidon2")
    return proof_to_json(proof), verify(art.vk, proof, "poseidon",
                                        "poseidon2")


def main(out_dir):
    from boojum_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out_dir, "store"), rank=rank, world_size=world)
    try:
        data = inputs()
        pair = dist.new_group([0, 1])  # every rank takes part in making it
        out = {world: run_mesh(make_mesh(device="cpu"), data)}
        if rank < 2:
            mesh = make_mesh(pair, device="cpu")
            out[2] = run_mesh(mesh, data)
            out["proof"] = prove(mesh)
        elif rank == 2:
            out["proof"] = prove(None)
        with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
