"""Reference proof digests for the PyTorch port's chip smoke.

Runs the JAX package's host `prove` on one of the BASELINE configurations and
writes the sha256 of `proof_to_json(proof)` to a file under
`boojum_tpu_torch/data/`, together with the seed, input, configs, domain and
transcript/hasher kinds. `chip_smoke.py` holds the port's proofs against
those digests on the GPU, where JAX is not installed. The host `prove` and
`DeviceProver` emit equal bytes
(`tests/test_prove_verify.py::test_device_prover_matches_host`).

    python3 scripts/torch_reference_digest.py [--config NAME]
        [--transcript KIND] [--hasher KIND] [--out PATH]

``--config flagship`` (the default): the 8 kB SHA-256 circuit of `bench.py`
with the Poseidon transcript and Poseidon2 trees
(`flagship_proof_digest.json`, a few minutes); `--transcript blake2s
--hasher blake2s` writes `flagship_blake2s_proof_digest.json` (a few
minutes) and `--transcript keccak256 --hasher keccak256`
`flagship_keccak256_proof_digest.json` (about an hour: the reference's
Keccak-256 trees hash in pure Python).

``--config keccak256``: the 1 kB Keccak-256 circuit of
`scripts/bench_suite.py` (`tests/test_keccak_gadget.build` over 1024 bytes
from `default_rng(7)`, `max_trace=1 << 17`), Poseidon transcript, Poseidon2
trees, LDE 8, cap 16, security 100 (`keccak256_1kB_proof_digest.json`).

``--config recursion_outer``: the recursion configuration of
`scripts/bench_suite.py`: the inner proof of
`tests/test_prove_verify.build_small_circuit()` (its RNG fresh from
`default_rng(11)`; LDE 8, cap 8, security 100), then the outer circuit that
verifies it (132 copy columns, 8 constant columns, degree 8, flattened
Poseidon and Poseidon2 gates) proved at LDE 8, cap 16, security 100; both
digests go to `recursion_outer_proof_digest.json`.

``--config lookup_heavy``: the lookup-heavy circuit of
`scripts/bench_suite.py` (`bench_lookup_heavy`): 1,047,552 binop lookups
(a, b and the packed xor / or / and from `default_rng(11)`) at width 3 in 8
specialized repetitions with a shared constant table id, 32 copy columns,
4 constant columns, a 2^17-row domain; Poseidon transcript, Poseidon2
trees, LDE 8, cap 16, security 100 (`lookup_heavy_proof_digest.json`).
``--config lookup_heavy_general``: the same construction with the
general-purpose `LookupParameters.table_id_as_constant(width=3)` in place
of the specialized mode (`lookup_heavy_general_proof_digest.json`). Both
records carry the seconds the run took.
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
MADE_BY = "scripts/torch_reference_digest.py (boojum_tpu host prove)"
KINDS = ("poseidon", "poseidon2", "blake2s", "keccak256")
KECCAK_SEED = 7
KECCAK_INPUT_LEN = 1024
INNER_SEED = 11
INNER_CONFIG = dict(fri_lde_factor=8, merkle_tree_cap_size=8,
                    security_level=100, pow_bits=0)
LOOKUP_SEED = 11
LOOKUP_COUNT = (1 << 20) - 1024
LOOKUP_GEOMETRY = dict(num_columns_under_copy_permutation=32,
                       num_witness_columns=0, num_constant_columns=4,
                       max_allowed_constraint_degree=4)
OUTER_GEOMETRY = dict(num_columns_under_copy_permutation=132,
                      num_witness_columns=0, num_constant_columns=8,
                      max_allowed_constraint_degree=8)


def default_out(transcript, hasher):
    name = ("flagship_proof_digest.json"
            if (transcript, hasher) == ("poseidon", "poseidon2")
            else "flagship_%s_proof_digest.json" % hasher)
    return os.path.join(ROOT, "boojum_tpu_torch", "data", name)


def flagship(transcript, hasher):
    from boojum_tpu.cs.setup import create_base_setup
    from boojum_tpu.prover import ProofConfig, create_setup_and_vk, prove
    from tests.test_sha256 import build_sha256_circuit

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
    chars, sha = digest(proof)
    return {
        "circuit": "sha256 (tests/test_sha256.build_sha256_circuit)",
        "seed": SEED,
        "input_len": INPUT_LEN,
        "max_trace_len": MAX_TRACE_LEN,
        "domain": cs.final_trace_len if hasattr(cs, "final_trace_len") else None,
        "config": CONFIG,
        "transcript": transcript,
        "hasher": hasher,
        "proof_json_chars": chars,
        "proof_json_sha256": sha,
        "made_by": MADE_BY,
    }, dict(synthesis_s=t_synth, setup_s=t_setup, prove_s=t_prove)


def digest(proof):
    from boojum_tpu.prover.proof import proof_to_json
    text = proof_to_json(proof)
    return len(text), hashlib.sha256(text.encode()).hexdigest()


def keccak256():
    from boojum_tpu.cs.setup import create_base_setup
    from boojum_tpu.prover import ProofConfig, create_setup_and_vk, prove
    from tests.test_keccak_gadget import build

    data = bytes(np.random.default_rng(KECCAK_SEED).integers(
        0, 256, KECCAK_INPUT_LEN, dtype=np.uint8))
    t0 = time.time()
    cs, _ = build(data, max_trace=MAX_TRACE_LEN)
    cs.pad_and_shrink()
    t_synth = time.time() - t0
    t0 = time.time()
    sb = create_base_setup(cs)
    cfg = ProofConfig(**CONFIG)
    art = create_setup_and_vk(cs, sb, cfg, "poseidon2")
    t_setup = time.time() - t0
    t0 = time.time()
    proof = prove(cs, art, cfg, "poseidon", "poseidon2")
    t_prove = time.time() - t0
    chars, sha = digest(proof)
    return {
        "circuit": "keccak256 (tests/test_keccak_gadget.build)",
        "seed": KECCAK_SEED,
        "input_len": KECCAK_INPUT_LEN,
        "max_trace_len": MAX_TRACE_LEN,
        "domain": cs.final_trace_len,
        "config": CONFIG,
        "transcript": "poseidon",
        "hasher": "poseidon2",
        "proof_json_chars": chars,
        "proof_json_sha256": sha,
        "made_by": MADE_BY,
    }, dict(synthesis_s=t_synth, setup_s=t_setup, prove_s=t_prove)


def reference_inner(seed=INNER_SEED):
    """The inner circuit of bench_suite.py's recursion_outer, padded again
    as that script does, its artifacts and its host proof."""
    import tests.test_prove_verify as tpv
    from boojum_tpu.cs.setup import create_base_setup
    from boojum_tpu.prover import ProofConfig, create_setup_and_vk, prove

    rng, tpv.RNG = tpv.RNG, np.random.default_rng(seed)
    try:
        inner = tpv.build_small_circuit()
    finally:
        tpv.RNG = rng
    inner.pad_and_shrink()
    cfg = ProofConfig(**INNER_CONFIG)
    art = create_setup_and_vk(inner, create_base_setup(inner), cfg,
                              "poseidon2")
    return inner, art, prove(inner, art, cfg, "poseidon", "poseidon2")


def reference_outer(vk, proof):
    """The outer circuit of bench_suite.py's recursion_outer over ``proof``
    (made under INNER_CONFIG), padded."""
    from boojum_tpu.cs import ConstraintSystem, CSConfig, CSGeometry
    from boojum_tpu.cs.gates import (BooleanConstraintGate,
                                     ConstantsAllocatorGate, FmaGate,
                                     NopGate, ReductionGate, SelectionGate,
                                     ZeroCheckGate)
    from boojum_tpu.cs.gates.arith import FmaGateInExtension
    from boojum_tpu.gadgets.poseidon2_circuit import allow_poseidon2_gates
    from boojum_tpu.gadgets.recursion.primitives import allow_poseidon_gates
    from boojum_tpu.gadgets.recursion.verifier import (AllocatedProof,
                                                       recursive_verify)
    from boojum_tpu.prover import ProofConfig

    outer = ConstraintSystem(CSGeometry(**OUTER_GEOMETRY), MAX_TRACE_LEN,
                             CSConfig.dev())
    for g in (ConstantsAllocatorGate, FmaGate, NopGate, BooleanConstraintGate,
              SelectionGate, ZeroCheckGate, FmaGateInExtension):
        outer.allow_gate(g)
    outer.allow_gate(ReductionGate, params=4)
    allow_poseidon2_gates(outer, flattened=True)
    allow_poseidon_gates(outer, flattened=True)
    recursive_verify(outer, vk, AllocatedProof.allocate(outer, proof),
                     ProofConfig(**INNER_CONFIG), "poseidon", "poseidon2")
    outer.pad_and_shrink()
    return outer


def recursion_outer():
    """The inner proof and the outer proof of bench_suite.py's
    recursion_outer configuration, both by the host prove."""
    from boojum_tpu.cs.setup import create_base_setup
    from boojum_tpu.prover import ProofConfig, create_setup_and_vk, prove
    from boojum_tpu.verifier import verify

    times = {}
    t0 = time.time()
    inner, art, inner_proof = reference_inner()
    assert verify(art.vk, inner_proof, "poseidon", "poseidon2")
    times["inner_s"] = time.time() - t0

    t0 = time.time()
    outer = reference_outer(art.vk, inner_proof)
    times["outer_synthesis_s"] = time.time() - t0
    t0 = time.time()
    assert outer.check_if_satisfied()
    times["outer_check_s"] = time.time() - t0
    t0 = time.time()
    outer_sb = create_base_setup(outer)
    cfg = ProofConfig(**CONFIG)
    outer_art = create_setup_and_vk(outer, outer_sb, cfg, "poseidon2")
    times["outer_setup_s"] = time.time() - t0
    t0 = time.time()
    outer_proof = prove(outer, outer_art, cfg, "poseidon", "poseidon2")
    times["outer_prove_s"] = time.time() - t0
    assert verify(outer_art.vk, outer_proof, "poseidon", "poseidon2")
    inner_chars, inner_sha = digest(inner_proof)
    outer_chars, outer_sha = digest(outer_proof)
    return {
        "inner": {
            "circuit": "tests/test_prove_verify.build_small_circuit(), "
                       "padded again as scripts/bench_suite.py does",
            "seed": INNER_SEED,
            "domain": inner.final_trace_len,
            "config": INNER_CONFIG,
            "transcript": "poseidon",
            "hasher": "poseidon2",
            "proof_json_chars": inner_chars,
            "proof_json_sha256": inner_sha,
        },
        "outer": {
            "circuit": "gadgets/recursion/verifier.recursive_verify over the "
                       "inner proof, flattened Poseidon and Poseidon2 gates",
            "geometry": OUTER_GEOMETRY,
            "max_trace_len": MAX_TRACE_LEN,
            "domain": outer.final_trace_len,
            "config": CONFIG,
            "transcript": "poseidon",
            "hasher": "poseidon2",
            "proof_json_chars": outer_chars,
            "proof_json_sha256": outer_sha,
        },
        "made_by": MADE_BY,
    }, times


def lookup_heavy_circuit(mode, n_lookups=LOOKUP_COUNT, seed=LOOKUP_SEED):
    """`scripts/bench_suite.py:bench_lookup_heavy`'s circuit, built with the
    JAX package and padded; ``mode`` "general" takes
    `LookupParameters.table_id_as_constant(width=3)` instead of the
    specialized width-3 x 8 mode."""
    from boojum_tpu.cs import (ConstraintSystem, CSConfig, CSGeometry,
                               LookupParameters)
    from boojum_tpu.cs.gates import ConstantsAllocatorGate, FmaGate, NopGate
    from boojum_tpu.gadgets import tables

    rng = np.random.default_rng(seed)
    cs = ConstraintSystem(CSGeometry(**LOOKUP_GEOMETRY), MAX_TRACE_LEN,
                          CSConfig.dev())
    if mode == "general":
        cs.allow_lookup(LookupParameters.table_id_as_constant(width=3))
    else:
        cs.allow_lookup(LookupParameters.specialized_with_table_id_as_constant(
            width=3, num_repetitions=8, share_table_id=True))
    for g in (ConstantsAllocatorGate, FmaGate, NopGate):
        cs.allow_gate(g)
    tid = cs.add_lookup_table(tables.create_binop_table())
    a = rng.integers(0, 256, n_lookups, dtype=np.uint64)
    b = rng.integers(0, 256, n_lookups, dtype=np.uint64)
    packed = ((a ^ b) << np.uint64(32)) | ((a | b) << np.uint64(16)) | (a & b)
    av = cs.alloc_variables_with_values(a)
    bv = cs.alloc_variables_with_values(b)
    cv = cs.alloc_variables_with_values(packed)
    cs.enforce_lookup_batch(tid, np.stack([av, bv, cv]))
    cs.pad_and_shrink()
    return cs


def lookup_heavy(mode):
    """The host proof of the lookup-heavy circuit in ``mode``."""
    from boojum_tpu.cs.setup import create_base_setup
    from boojum_tpu.prover import ProofConfig, create_setup_and_vk, prove

    t0 = time.time()
    cs = lookup_heavy_circuit(mode)
    t_synth = time.time() - t0
    t0 = time.time()
    sb = create_base_setup(cs)
    cfg = ProofConfig(**CONFIG)
    art = create_setup_and_vk(cs, sb, cfg, "poseidon2")
    t_setup = time.time() - t0
    t0 = time.time()
    proof = prove(cs, art, cfg, "poseidon", "poseidon2")
    t_prove = time.time() - t0
    chars, sha = digest(proof)
    lp = cs.lookup_parameters
    times = dict(synthesis_s=t_synth, setup_s=t_setup, prove_s=t_prove)
    return {
        "circuit": "lookup_heavy (scripts/bench_suite.py:bench_lookup_heavy)"
                   + (", general-purpose table_id_as_constant(width=3)"
                      if mode == "general" else ""),
        "mode": mode,
        "seed": LOOKUP_SEED,
        "n_lookups": LOOKUP_COUNT,
        "lookup_parameters": dict(mode=lp.mode, width=lp.width,
                                  num_repetitions=lp.num_repetitions,
                                  share_table_id=lp.share_table_id),
        "subarguments": lp.num_sublookup_arguments_for_geometry(cs.geometry),
        "geometry": LOOKUP_GEOMETRY,
        "max_trace_len": MAX_TRACE_LEN,
        "domain": cs.final_trace_len,
        "config": CONFIG,
        "transcript": "poseidon",
        "hasher": "poseidon2",
        "proof_json_chars": chars,
        "proof_json_sha256": sha,
        "made_by": MADE_BY,
        "runtime_s": {k: round(v, 1) for k, v in times.items()},
    }, times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="flagship",
                    choices=("flagship", "keccak256", "recursion_outer",
                             "lookup_heavy", "lookup_heavy_general"))
    ap.add_argument("--transcript", default="poseidon", choices=KINDS,
                    help="flagship only")
    ap.add_argument("--hasher", default="poseidon2", choices=KINDS[1:],
                    help="flagship only")
    ap.add_argument("--out", default=None,
                    help="default: boojum_tpu_torch/data/flagship_proof_"
                    "digest.json, flagship_<hasher>_proof_digest.json for "
                    "another flagship transcript, keccak256_1kB_proof_"
                    "digest.json, recursion_outer_proof_digest.json or "
                    "lookup_heavy[_general]_proof_digest.json")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    t_all = time.time()
    if args.config == "flagship":
        rec, times = flagship(args.transcript, args.hasher)
        out_path = args.out or default_out(args.transcript, args.hasher)
    else:
        rec, times = {"keccak256": keccak256,
                      "recursion_outer": recursion_outer,
                      "lookup_heavy": lambda: lookup_heavy("specialized"),
                      "lookup_heavy_general": lambda: lookup_heavy("general"),
                      }[args.config]()
        out_path = args.out or os.path.join(
            ROOT, "boojum_tpu_torch", "data",
            {"keccak256": "keccak256_1kB_proof_digest.json",
             "recursion_outer": "recursion_outer_proof_digest.json",
             "lookup_heavy": "lookup_heavy_proof_digest.json",
             "lookup_heavy_general": "lookup_heavy_general_proof_digest.json",
             }[
                 args.config])
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({**rec, **times, "wall_s": time.time() - t_all}))


if __name__ == "__main__":
    main()
