"""Chip smoke test of the PyTorch/CUDA port on one GPU.

Builds the port's CUDA kernels from `boojum_tpu_torch/csrc/`, prints each
kernel's SASS instruction counts (`cuobjdump -sass`; the Poseidon2 and the
classic-Poseidon tree entries by pipe, a permutation's share and its issue
time at each timed shape), and holds every kernel
entry bit-exactly against its plain PyTorch version on the card: `ntt_stage`
at every template instance (R 128 / 256 x forward / inverse x twiddle mode
0 / 1 / 2) and at a ragged width, `poseidon2_permute`,
`poseidon2_leaf_hashes` and `poseidon2_node_layer` at the trees' shapes,
`poseidon2_node_layers` (a tree's node layers in one or two launches, the
narrow levels on 4 lanes a state) against the plain per-layer chain at m =
2, 32, 1000 (cap 1) and at every tree of a flagship prove (cap 16; every
launch shape of a prove again in its per-prove costs),
`ntt_small` at every template instance (log n 0 .. 12 x forward / forward
with the cross twiddle / inverse) at two ragged batches and at the NTT
path's two shapes with its real twiddle tables, `sha256_witness` at 1, 3,
129 (the flagship) and 1000 chained blocks, the Poseidon sponge
(`poseidon_absorb` at 0 .. 130 elements from several states, and
`poseidon_permute`), the classic-Poseidon tree entries of the same library
(`poseidon_leaf_hashes` at k = 1, 7, 8, 9, 16, 93 elements a leaf and on a
strided view, `poseidon_node_layer` at m = 2, 32, 1000, and
`poseidon_node_layers`, a tree's node layers in one or two launches,
against the plain per-layer chain at m = 2, 32, 1000 and every tree of a
Poseidon-tree prove: three of 2^19 leaves, one each of 2^16, 2^13, 2^10
and 2^7, cap 16; all three also at every launch shape of that prove), and
the Blake2s (K8) and Keccak-256
(K9) tree hashes
(`*_leaf_hashes` at k = 1, 8, 16, 17, 34, 93 elements a leaf, the block
boundaries of both hashes, and on a strided view; `*_node_layers`, every
node layer of a tree in one launch (two above 2^17 leaves), against the
plain per-layer chain at
m = 2, 32 and 1000 with cap 1, at every tree of a prove (2^19, 2^16, 2^13,
2^10, 2^7 and 2^4 leaves, cap 16) and at caps 1 and 4), and the two
kernels of stages 2+3 (`stage23_rows` and `stage23_scan` of
`csrc/stage23.cu`) against `stage23_plain` at 1, 32, 256, 512, 1613 (no
multiple of the scan's tile) and 4096 rows, at a row of 150 inverses, and
at the flagship's key at 2^16 and 2^17 rows, with a zero lookup
aggregate, a zero table aggregate, a zero copy-permutation denominator and
a row whose every inverse is zero among the rows (the scan also alone
against the plain grand product and partials), and the quotient sweep
(`quotient_sweep` of `csrc/quotient.cu`, the gate terms from the
circuit's recorded tape) against `quotient_plain` at made-up keys
(`quotient.made_up_case`: no lookup, the specialized lookups with a table
id a repetition and shared, the general-purpose ones with the selector,
general gates under selector paths, the flattened Poseidon and Poseidon2
gates, each at 8 and 4096 rows, a point of zeros and one of p - 1 among
the points; the Poseidon gates at qd 16, 2^19 points, the flagship's
widths timed); every shape it
times is held against the plain version first. Then it drives these
paths, each with the launch counts set to 0 just before it and read just
after; the single-device proves of a path (each path counts its own) must
launch `stage23_rows`, `stage23_scan` (`stage23.scan_launches`: one launch
a call) and `quotient_sweep` once each, a sharded prove `quotient_sweep`
once, and no path a plain version (after the
paths the three kernels are held and timed at every key the proves
launched). Each configuration's op-counted prove gives the "quotient
sweep" stage's torch ops and wall, all printed on one line at the end:
at most 1,000 ops for the flagship with the device transcript and 2,000
for the recursion outer prove (88,174 and 520,406 op by op):

- the flagship: proves the 8 kB SHA-256 circuit (2^16 rows, LDE 8, cap 16,
  Poseidon transcript, Poseidon2 trees) through the port's entry points and
  requires the sha256 of `proof_to_json(proof)` to equal the reference
  digest in `boojum_tpu_torch/data/flagship_proof_digest.json` (made by
  `scripts/torch_reference_digest.py` from the JAX package). The default
  prove must take the device witness program (`sha256_witness` once a
  prove, `materialize_witness_columns` never) and the device transcript
  (`poseidon_sponge` more than once a prove). A warm prove with the
  device transcript alternates with one with the host transcript
  (`device_transcript=False`), which must give the same digest; both times
  are printed. Every Poseidon2-tree prove (here and in the paths below but
  the sharded one) must build its trees' node layers through
  `poseidon2_node_layers`, at most MAX_NODE_LAUNCHES launches a prove, and
  never through the one-layer `poseidon2_node_layer`. Each mode's stage split comes from synced proves
  alternated with the other mode's, and each stage's torch ops from one
  prove a mode with its ops counted (`scripts/torch_profile_flagship.py`
  gives a prove's kernels, device time and idle share under
  `torch.profiler`). One warm prove
  in each mode is run under `torch.cuda.set_sync_debug_mode("warn")` to
  count its synchronizing calls by source line: at most 3 with the device
  transcript (the handoff, the query phase's one fetch, the closing
  synchronize) and 12 with the host one. It records the kernel launches of one
  prove by shape, holds each shape bit-exactly against its plain version,
  times it and prints, per kernel, the sum over a prove of launches x time
  and of launches x (time - bound) (likewise the byte hashes' shapes of a
  Blake2s and a Keccak-256 prove, a `*_node_layers` launch bound by the
  summed bound of its layers, and the shapes of a Keccak-256 circuit prove,
  of a recursion outer prove and of the lookup-heavy circuit's proves, each
  shape checked and timed once);
- the sharded flagship: the same circuit, base setup and configuration
  proved through `boojum_tpu_torch/parallel/`: an NCCL process group of
  one rank made in this process (a FileStore in a temporary directory,
  the group bound to cuda:0, destroyed after the phase),
  `create_device_setup(..., mesh=make_mesh())` (its cap the single-device
  setup's) and `DeviceProver(..., mesh=)`, one cold and one warm prove,
  each held to `flagship_proof_digest.json`, with its synchronizing calls
  counted (a warm prove at most 12: the sharded prove takes the host
  transcript and the host witness, as the reference's mesh path does) and
  its collectives by kind printed, and one prove with its torch ops
  counted by stage; it must launch `ntt_stage`, the Poseidon2 leaf and
  node entries and `quotient_sweep` (once a prove, over the rank's blocks),
  and no plain version; then one sharded
  classic-Poseidon tree of 2^19 leaves (`build_sharded_tree`, hasher
  "poseidon", one `poseidon_node_layer` launch a layer) whose layers must
  equal the single-device tree's;
- the Poseidon-tree flagship: the same circuit and base setup, Poseidon
  transcript, classic-Poseidon trees (tree hasher "poseidon", entries
  `poseidon_leaf_hashes` / `poseidon_node_layers`), LDE 8, cap 16: its
  device setup, one cold and one warm prove with the device transcript,
  each held to `boojum_tpu_torch/data/flagship_poseidon_proof_digest.json`
  and with its synchronizing calls counted (the warm prove at most 3), one
  prove with its torch ops counted by stage, and the peak device memory;
  the proves must launch the two tree entries, `ntt_stage`,
  `sha256_witness` and `poseidon_sponge`, and no Poseidon2 tree entry and
  no plain version, and no prove may make more than 16 Poseidon node
  launches;
- the non-recursive flagship: the same circuit in the reference's own
  non-recursive configuration, the Blake2s transcript (on the host) and
  Blake2s trees (K8), LDE 8, cap 16, security 100, no PoW: setup, one cold
  and one warm prove, each proof's digest equal to
  `boojum_tpu_torch/data/flagship_blake2s_proof_digest.json`, the stage
  split and torch ops of an op-counted prove, and at most 12 synchronizing
  calls in a warm prove; then one Keccak-256 prove (K9) against
  `flagship_keccak256_proof_digest.json` and one op-counted. Both must
  launch their tree
  kernels, `ntt_stage` and `sha256_witness`, and no plain version, and
  no prove may launch `*_node_layers` more than 16 times;
- the Keccak-256 circuit (BASELINE config 3): the 1 kB Keccak-256 gadget
  circuit (2^16 rows), Poseidon transcript, Poseidon2 trees: synthesis,
  then the per-circuit path `circuit_path`: setup, one cold and one warm
  prove, each proof's digest equal to
  `boojum_tpu_torch/data/keccak256_1kB_proof_digest.json` and its
  synchronizing calls counted (a warm prove at most 3), and one with its
  torch ops counted by stage, whose synced stages also give the stage
  split (`scripts/torch_profile_flagship.py --config keccak256` profiles
  it).
  The proves must take the device witness program
  (`materialize_witness_columns` never called) and launch `ntt_stage`, the
  Poseidon2 leaf and node-layers entries and `poseidon_sponge`, and no plain
  version;
- the recursion configuration (BASELINE config 2): the inner proof of a
  2^5-row circuit with two public inputs and the outer proof of the circuit
  that verifies it (4096 rows, 132 copy columns, degree 8, flattened
  Poseidon and Poseidon2 gates), both made on the card through the host
  witness path, as in the reference, and held to the digests in
  `boojum_tpu_torch/data/recursion_outer_proof_digest.json` (the inner
  prove once more with its torch ops counted by stage): the outer
  circuit's synthesis and `check_if_satisfied`, its setup, a cold prove
  with its torch ops counted by stage and a warm prove timed
  (`scripts/torch_profile_flagship.py --config recursion_outer`
  profiles it; `torch.profiler` takes minutes on a prove of a million
  launches); the outer circuit over an inner proof with one value at z
  bumped must be unsatisfied;
- the lookup-heavy circuit (BASELINE config 4): 1,047,552 binop lookups
  on 32 copy columns, a 2^17-row domain, Poseidon transcript, Poseidon2
  trees, LDE 8, cap 16, in its specialized lookup mode (the reference's:
  width 3 in 8 repetitions, a shared constant table id) and in the
  general-purpose mode (`table_id_as_constant(width=3)`, the lookups on
  the marker gate's rows): for each, synthesis, then `circuit_path` as for
  the Keccak-256 circuit: setup, one cold and one warm prove, each timed,
  held to
  `boojum_tpu_torch/data/lookup_heavy_proof_digest.json` or
  `lookup_heavy_general_proof_digest.json` and with its synchronizing calls
  counted (a warm prove at most 3), one with its torch ops counted by
  stage (and its stage split), and the peak device memory
  (`scripts/torch_profile_flagship.py --config lookup_heavy` or
  `lookup_heavy_general` profiles a prove); every prove must take the
  device witness program;
- the host prove: the port's host `prove` (host numpy stages, its LDEs,
  NTTs and trees on the card) and `create_setup_and_vk` on the recursion
  configuration's inner circuit, held to its digest in
  `recursion_outer_proof_digest.json` (the flagship's host prove takes over
  a minute; `scripts/torch_profile_flagship.py --prover host` times it);
- the verifier: the port's `verify` (host code, no launch) accepts the
  Poseidon, sharded, Poseidon-tree, Blake2s and Keccak-256 flagship
  proofs, the host prove's proof, the
  Keccak-256 circuit proof, the recursion configuration's inner and outer
  proofs and the lookup-heavy circuit's two proofs, each timed, and rejects
  the Blake2s and the Poseidon-tree proofs with one witness leaf element
  flipped, in four spawned processes that run while the card checks and
  times each kernel at every shape the proves gave it and runs the two
  paths below (each worker's launches must stay 0);
- the standalone NTT: runs `pallas_ntt.ntt_any` at (2^24, 8), whose output
  must equal the digest in `boojum_tpu_torch/data/ntt_2e24_digest.json`
  (made by `scripts/torch_reference_ntt_digest.py`) and the radix-256 route
  `ntt.ntt_fourstep_cols`; it must launch `ntt_small` 4 times, with no
  plain version and no torch cross-twiddle multiply on the card (both
  cross twiddles ride in the kernel's store);
- the batch permutation: `pallas_poseidon2.permutation_stacked_fast` on 2^20
  random states, against its plain version. No path of the port calls it
  since the trees hash through the leaf and node entries; this phase keeps
  the `poseidon2_permute` entry launched and checked.

    python3 chip_smoke.py                 # everything, as above
    python3 chip_smoke.py --kernels-only  # build, SASS, kernel checks; stop

Prints the card's `name, power.limit`, a `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, with no result line, when
CUDA or nvidia-smi is unavailable or any phase fails.
"""

import collections
import contextlib
import functools
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# The kernels' work is 32-bit integer multiply-adds (IMAD). The data sheet's
# non-tensor fp32 peak is 67 TFLOP/s with an FMA counted as 2 ops, i.e.
# 33.5e12 FMA/s from 128 fp32 lanes per SM per clock; Hopper issues IMAD on
# 64 lanes per SM per clock, half that rate. A Goldilocks multiply needs at
# least the 4 32x32->64-bit partial products of its 64x64-bit product.
H100_IMAD_PER_S = 67e12 / 2 / 2
IMAD_PER_FIELD_MUL = 4
# s-box multiplies of one Poseidon2 permutation: 8 full rounds x 12 x 4,
# 22 partial rounds x 4
P2_MULS = 8 * 12 * 4 + 22 * 4
P2_REPLACES = "boojum_tpu/hash/pallas_poseidon2.py:43"
# the classic Poseidon of the transcript has the same s-box multiplies
POSEIDON_MULS = P2_MULS
K5_REPLACES = "boojum_tpu/gadgets/sha256.py:545"
# warm flagship proves in each transcript mode, alternated (two until the
# Poseidon-tree flagship came: the run has to stay within its time)
WARM_ROUNDS = 1
# synced proves a mode, alternated, for the stage split of each mode
PROFILE_ROUNDS = 1
# most synchronizing calls a warm prove may make: the device transcript's
# handoff, the query phase's one fetch and the closing synchronize; the
# host transcript adds its cap reads, the evaluations and the final layer
MAX_SYNCS = {"device": 3, "host": 12}
# warm proves of the sharded flagship (world size 1 under NCCL) after its
# cold prove; it takes the host transcript, so MAX_SYNCS["host"] holds
SHARDED_WARM_PROVES = 1
K6_REPLACES = "boojum_tpu/prover/device_transcript.py:87"
# the classic-Poseidon tree entries of csrc/poseidon.cu replace the batched
# jnp sponge behind the reference's host AlgebraicMerkleTree; by launch
# shape: ("leaf", k, m), ("nodes", m, levels) (a tree's layers in one or two
# launches) and ("node", m) (a layer, the sharded trees')
PTREE_NAMES = {"leaf": "poseidon_leaf_hashes", "nodes": "poseidon_node_layers",
               "node": "poseidon_node_layer"}
PTREE_REPLACES = {"leaf": "boojum_tpu/hash/sponge.py:116",
                  "nodes": "boojum_tpu/hash/sponge.py:147",
                  "node": "boojum_tpu/hash/sponge.py:147"}
# the trees of a Poseidon-tree prove, cap 16: its three 2^19-leaf oracles
# and the FRI layers (the 2^4-leaf one has no node layer above its cap)
PTREE_PROVE_TREES = (1 << 19,) * 3 + (1 << 16, 1 << 13, 1 << 10, 1 << 7)
# warm proves of the Poseidon-tree flagship after its cold prove
PTREE_WARM_PROVES = 1
# the compiled JAX loops that K8 (Blake2s) and K9 (Keccak-256) replace
BYTE_REPLACES = {
    ("blake2s", "leaf"): "boojum_tpu/hash/device_bytes_hash.py:123",
    ("blake2s", "node"): "boojum_tpu/hash/device_bytes_hash.py:149",
    ("keccak256", "leaf"): "boojum_tpu/hash/device_bytes_hash.py:300",
    ("keccak256", "node"): "boojum_tpu/hash/device_bytes_hash.py:309"}
BYTE_SOURCES = {"blake2s": "boojum_tpu_torch/csrc/blake2s.cu",
                "keccak256": "boojum_tpu_torch/csrc/keccak.cu"}
BYTE_LIBS = {"blake2s": "blake2s", "keccak256": "keccak"}
# H100 integer pipe: 64 lanes per SM per clock (the rate the IMAD bound
# above uses) for the ALU pipe (the byte hashes' adds, xors, funnel shifts)
# and for the FMA pipe (IMAD) each; an SM issues 128 thread-instructions a
# clock in all
H100_INT_PER_S = H100_IMAD_PER_S
# warm proves of the Blake2s configuration (two until the Poseidon-tree
# flagship came: the run has to stay within its time)
BYTE_WARM_PROVES = 1
# warm proves of the Keccak-256 circuit after its cold prove (two before)
KECCAK_WARM_PROVES = 1
# warm proves of each variant of the lookup-heavy circuit (BASELINE config
# 4), after its cold prove: the specialized (the reference's) and the
# general-purpose variant (the specialized one took two before)
LOOKUP_VARIANTS = (("specialized", "lookup_heavy_proof_digest.json", 1),
                   ("general", "lookup_heavy_general_proof_digest.json", 1))
# most `*_node_layers` launches a byte-tree, Poseidon-tree or Poseidon2-tree
# prove may make: the flagship makes 10, two for each 2^19-leaf tree and one
# for the 2^16, 2^13, 2^10 and 2^7 ones
MAX_NODE_LAUNCHES = 16
# Dependency-chain model of the two sequential kernels (not a measured
# bound): a SHA-256 round's critical path, e -> s1 -> tmp1 -> tmp1w -> te,
# is about 8 dependent integer instructions; a Poseidon round's about 3
# dependent field multiplies of the s-box and one 12-term MDS sum, taken as
# 60 dependent instructions; about 4 cycles each on the SM clock.
SHA_ROUND_DEP = 8
POSEIDON_ROUND_DEP = 60
DEP_CYCLES = 4


def log(msg):
    print(msg, flush=True)


def card_line():
    """The card's ``name, power.limit``; raises when nvidia-smi cannot say,
    since every number of the run is reported beside it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError("nvidia-smi failed (rc %d): %s"
                           % (out.returncode, out.stderr.strip()))
    return lines[0]


def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_run(fn, timed):
    """``fn()`` (a plain version) once, and with ``timed`` its time on the
    card between CUDA events: the plain versions take 0.06 to 6 s a call,
    so the one call that the bit-equality check needs is also the timed
    one, with no warm-up. Returns (output, ms or None)."""
    import torch
    if not timed:
        return fn(), None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes, field_muls):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = field_muls * IMAD_PER_FIELD_MUL / H100_IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b):
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    ha, hb = gl.to_u64(a), gl.to_u64(b)
    if ha.shape != hb.shape:
        raise AssertionError("shapes differ: %s vs %s" % (ha.shape, hb.shape))
    if np.array_equal(ha, hb):
        return 0.0
    return float(np.max(np.abs(ha.astype(np.float64) - hb.astype(np.float64))))


def rand_field(rng, shape):
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    return gl.from_u64(rng.integers(0, gl.ORDER, shape, dtype=np.uint64),
                       "cuda")


def require_equal(got, want, what):
    err = max_abs_err(got, want)
    if err != 0.0:
        raise AssertionError("%s differs from its plain version (max abs err "
                             "%g)" % (what, err))
    return err


# ---------------------------------------------------------------------------
# SASS
# ---------------------------------------------------------------------------


def k4_elements(log_n):
    """Elements one thread of a `ntt_small` instance holds: 2^A rows of C
    columns, A = min(log n, 3), C = 2 (csrc/ntt_small.cu, Shape<L>)."""
    return 2 << min(log_n, 3)


def sass_report():
    """Instruction counts of the built kernels (the Poseidon2 and the
    classic-Poseidon tree entries by pipe: `p2_sass`, `ptree_sass`). The
    ntt_stage and ntt_small instances are straight-line code over the
    elements a thread holds (32 for ntt_stage; 2^A rows of C columns for
    ntt_small), so theirs is per element."""
    import re
    from boojum_tpu_torch.utils import cuda_build

    report = {}
    for lib in ("sha256_witness", "poseidon"):
        for kname, instrs in sorted(
                cuda_build.sass(cuda_build._lib_path(lib)).items()):
            if any(t in kname for t in ("leaf_kernel", "node_kernel",
                                        "nodes_kernel")):
                continue  # the tree entries: ptree_sass
            s = cuda_build.sass_summary(instrs)
            short = next((t for t in ("absorb_kernel", "permute_kernel",
                                      "sha256_witness_kernel")
                          if t in kname), kname)
            s["integer_per_round"] = cuda_build.chain_per_round(lib, instrs,
                                                                s)
            report["%s/%s" % (lib, short)] = s
            log("sass %s %s: %d instructions, %d integer-pipe, %d IMAD, "
                "%d loops, %s integer per round" % (
                    lib, short, s["total"], s["integer"], s["imad"],
                    len(s["loops"]), s["integer_per_round"]))
    for lib in ("ntt_stage", "ntt_small"):
        for kname, instrs in sorted(
                cuda_build.sass(cuda_build._lib_path(lib)).items()):
            s = cuda_build.sass_summary(instrs)
            short, per_elem = kname, 32
            for tag in ("ntt_stage_kernel",):
                if tag in kname:
                    short = tag + kname.split(tag, 1)[1][:14]
            k4 = re.search(r"ntt_small_kernelILi(\d+)ELb([01])ELb([01])E",
                           kname)
            if k4:
                log_n, inv, epi = (int(g) for g in k4.groups())
                short = "ntt_small_kernel<%d,%s%s>" % (
                    log_n, "inv" if inv else "fwd", ",tw" if epi else "")
                per_elem = k4_elements(log_n)
            s["integer_per_element"] = s["integer"] / per_elem
            report[short] = s
            log("sass %s: %d instructions, %d integer-pipe, %d IMAD, "
                "%d loops (%.1f integer per element)"
                % (short, s["total"], s["integer"], s["imad"],
                   len(s["loops"]), s["integer_per_element"]))
    return report


# ---------------------------------------------------------------------------
# kernel checks against the plain versions
# ---------------------------------------------------------------------------


def k1_args(rng, r, m, inverse, twmode, width=256):
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.ntt import ntt
    x = rand_field(rng, (r, m))
    tw = None
    if twmode:
        log_w = min(width, m).bit_length() - 1
        tw = gl.from_u64(ntt.fourstep_twiddles_host(r.bit_length() - 1, log_w,
                                                    inverse), "cuda")
    return x, dict(inverse=inverse, tw=tw, tw_pre=twmode == 2)


def k1_bound(r, m, inverse, twmode, width):
    log_r = r.bit_length() - 1
    nbytes = 2 * r * m * 8 + (r * width * 8 if twmode else 0)
    muls = (r // 2) * log_r * m + r * m * (int(inverse) + int(twmode > 0))
    return bound(nbytes, muls)


def check_ntt_stage(rng):
    """K1 at every template instance, and at ragged widths (odd M takes the
    8-byte path), bit-equal to its plain version."""
    from boojum_tpu_torch.ntt import mxu_ntt

    errs = []
    cases = [(r, 1 << 14, inv, tw) for r in (128, 256) for inv in (False, True)
             for tw in (0, 1, 2)]
    cases += [(r, m, inv, 0) for r in (128, 256) for m in (1000, 1001)
              for inv in (False, True)]
    for (r, m, inverse, twmode) in cases:
        x, kw = k1_args(rng, r, m, inverse, twmode)
        errs.append(require_equal(
            mxu_ntt.ntt_cols_matmul(x, **kw), mxu_ntt.ntt_stage_plain(x, **kw),
            "ntt_stage R=%d M=%d inverse=%d twmode=%d" % (r, m, inverse,
                                                          twmode)))
    log("ntt_stage: bit-equal at %d cases (R 128/256 x inverse x twmode "
        "0/1/2 at M = 2^14; ragged M 1000, 1001)" % len(cases))
    return max(errs)


def time_ntt_stage(rng, r, m, inverse, twmode, width, plain=False):
    """K1 at one shape: bit-equal to its plain version, then timed."""
    from boojum_tpu_torch.ntt import mxu_ntt
    x, kw = k1_args(rng, r, m, inverse, twmode, width)
    want, plain_ms = plain_run(lambda: mxu_ntt.ntt_stage_plain(x, **kw),
                               plain)
    err = require_equal(
        mxu_ntt.ntt_cols_matmul(x, **kw), want,
        "ntt_stage R=%d M=%d inverse=%d twmode=%d W=%d"
        % (r, m, inverse, twmode, width))
    res = dict(err=err,
               ms=cuda_ms(lambda: mxu_ntt.ntt_cols_matmul(x, **kw), 20))
    if plain:
        res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"] = k1_bound(r, m, inverse, twmode, width)
    return res


def check_poseidon2(rng):
    """The three K2 entries, bit-equal to their plain versions, and timed at
    the reported shapes. Returns {entry: (max err, timing at its shape)}."""
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp

    out = {}
    errs, timing = [], None
    for b in (1, 127, 1 << 16, 1 << 20):
        st = rand_field(rng, (12, b))
        errs.append(require_equal(pp.permutation_stacked_fast(st),
                                  pp.permutation_plain(st),
                                  "poseidon2_permute B=%d" % b))
        if b == 1 << 16:
            timing = time_p2(("permute", b), st, plain=True)
    out["poseidon2_permute"] = (max(errs), timing)
    log("poseidon2_permute: bit-equal at B = 1, 127, 2^16, 2^20")

    errs = []
    for (k, m) in ((64, 1 << 19), (8, 1 << 19), (13, 1 << 16)):
        cols = rand_field(rng, (k, m))
        errs.append(require_equal(pp.leaf_hashes(cols),
                                  pp.leaf_hashes_plain(cols),
                                  "poseidon2_leaf_hashes (%d, %d)" % (k, m)))
        if (k, m) == (64, 1 << 19):
            timing = time_p2(("leaf", k, m), cols, plain=True)
    strided = rand_field(rng, (8, 1 << 12))[:, :1 << 11]  # a row stride > m
    errs.append(require_equal(pp.leaf_hashes(strided),
                              pp.leaf_hashes_plain(strided),
                              "poseidon2_leaf_hashes on a strided view"))
    out["poseidon2_leaf_hashes"] = (max(errs), timing)
    log("poseidon2_leaf_hashes: bit-equal at (64, 2^19), (8, 2^19), "
        "(13, 2^16) padded, and a strided (8, 2^11) view")

    errs = []
    for m in (1 << 19, 32):
        cur = rand_field(rng, (4, m))
        errs.append(require_equal(pp.node_layer(cur), pp.node_layer_plain(cur),
                                  "poseidon2_node_layer m=%d" % m))
        if m == 1 << 19:
            timing = time_p2(("node", m), cur, plain=True)
    out["poseidon2_node_layer"] = (max(errs), timing)
    log("poseidon2_node_layer: bit-equal at m = 2^19, 32")

    errs = [check_p2_nodes(rand_field(rng, (4, m)), cap)[0]
            for m, cap in [(2, 1), (32, 1), (1000, 1)]
            + [(m, 16) for m in PTREE_PROVE_TREES]]
    timing = time_p2(("nodes", 1 << 19, 15), rand_field(rng, (4, 1 << 19)),
                     plain=True)
    out["poseidon2_node_layers"] = (max(errs + [timing["err"]]), timing)
    log("poseidon2_node_layers: bit-equal to the plain chain at m = 2, 32, "
        "1000 (cap 1), at the trees of a prove %s (cap 16) and on a "
        "2^19-leaf tree to cap 16" % (list(PTREE_PROVE_TREES),))
    return out


def p2_bound(shape):
    kind = shape[0]
    if kind == "nodes":  # summed over its layers, bound by its widest's
        parts = [p2_bound(("node", shape[1] >> j)) for j in range(shape[2])]
        return sum(t for t, _ in parts), parts[0][1]
    if kind == "permute":
        b = shape[1]
        return bound(2 * 12 * 8 * b, P2_MULS * b)
    if kind == "leaf":
        k, m = shape[1:]
        return bound((k + 4) * m * 8, -(-k // 8) * P2_MULS * m)
    m = shape[1]
    return bound((4 * m + 2 * m) * 8, P2_MULS * (m // 2))


def check_p2_nodes(cur, cap, timed=False):
    """`pallas_poseidon2.node_layers` against the plain chain
    (`check_tree_nodes`)."""
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    return check_tree_nodes(
        "poseidon2_node_layers", lambda: pp.node_layers(cur, cap),
        lambda: pp.node_layers_plain(cur, cap),
        lambda: pp.NODE_LAYERS_LAUNCHES, cur, cap, timed)


P2_NAMES = {"permute": "poseidon2_permute", "leaf": "poseidon2_leaf_hashes",
            "node": "poseidon2_node_layer", "nodes": "poseidon2_node_layers"}


def time_p2(shape, x, plain=False):
    """A K2 entry at one shape, ("permute", B), ("leaf", k, m), ("node", m)
    or ("nodes", m, levels) (`node_layers` of m nodes to m >> levels: one
    launch of a prove, or a whole tree): bit-equal to its plain version,
    then timed."""
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    if shape[0] == "nodes":
        cap = shape[1] >> shape[2]

        def fn():
            return pp.node_layers(x, cap)
        err, plain_ms = check_p2_nodes(x, cap, plain)
    else:
        fn, plain_fn = {"permute": (pp.permutation_stacked_fast,
                                    pp.permutation_plain),
                        "leaf": (pp.leaf_hashes, pp.leaf_hashes_plain),
                        "node": (pp.node_layer, pp.node_layer_plain)
                        }[shape[0]]
        want, plain_ms = plain_run(lambda: plain_fn(x), plain)
        err = require_equal(fn(x), want, "poseidon2 %s" % (shape,))
        fn = functools.partial(fn, x)
    res = dict(err=err, ms=cuda_ms(fn, 20))
    if plain:
        res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"] = p2_bound(shape)
    res["sass_ms"] = p2_sass_ms(shape)
    perms = {"permute": shape[-1], "leaf": shape[-1] * -(-shape[1] // 8),
             "node": shape[-1] // 2}.get(
        shape[0], shape[1] - (shape[1] >> shape[-1]))
    log("%s %s: bit-equal, %.4f ms kernel (%.1f M perm/s%s), bound %.4f ms "
        "(%s), %.1f%% of bound; its SASS at the issue rates %.4f ms (%.1f%%)"
        % (P2_NAMES[shape[0]], shape[1:], res["ms"], perms / res["ms"] / 1e3,
           ", plain %.3f ms" % res["plain_ms"] if plain else "",
           res["bound_ms"], res["bound_by"],
           100 * res["bound_ms"] / res["ms"], res["sass_ms"],
           100 * res["sass_ms"] / res["ms"]))
    return res


def k4_tables():
    """The two cross-twiddle tables of `ntt_any` at (2^24, 8), as the path
    hands them to K4: the inner (512, 8) table at shift 15 and the outer
    (4096, 4096) table re-laid to (8, 2^21) at shift 3."""
    import torch
    from boojum_tpu_torch.ntt import ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    dev = torch.device("cuda")
    inner = ntt.fourstep_twiddles_device(9, 3, False, dev)
    outer = pn.relaid_twiddles(ntt.fourstep_twiddles_device(12, 12, False,
                                                            dev), 9)
    return {9: (inner, 15), 3: (outer, 3)}


def check_ntt_small(rng):
    """K4 against its plain version at every template instance (log n 0 ..
    12; forward, forward with the cross twiddle, inverse), each at an odd
    batch (8-byte path) and an even one (16-byte path); then timed at the
    two shapes of the NTT path, (512, 2^18) and (8, 2^24), forward and
    inverse, and forward with the path's real twiddle tables. Returns the
    largest error and the timings by (log_n, B, mode)."""
    from boojum_tpu_torch.ntt import pallas_ntt as pn

    errs = []
    for log_n in range(pn.MAX_KERNEL_LOG + 1):
        n = 1 << log_n
        for b in (1001, 2050):
            x = rand_field(rng, (n, b))
            shift = 1 if b % 2 == 0 else 0
            tw = rand_field(rng, (n, b >> shift))
            for mode in ("forward", "twiddle", "inverse"):
                kw = dict(tw=tw, tw_shift=shift) if mode == "twiddle" else {}
                inv = mode == "inverse"
                errs.append(require_equal(
                    pn.ntt_small(x, log_n, inv, **kw),
                    pn.ntt_small_plain(x, log_n, inv, **kw),
                    "ntt_small n=%d B=%d %s" % (n, b, mode)))
    log("ntt_small: bit-equal at every instance (log n 0..12 x forward / "
        "twiddle / inverse) at B = 1001 and 2050")

    tables, timings = k4_tables(), {}
    for (log_n, b) in ((9, 1 << 18), (3, 1 << 24)):
        n = 1 << log_n
        x = rand_field(rng, (n, b))
        tw, shift = tables[log_n]
        for mode in ("forward", "twiddle", "inverse"):
            kw = dict(tw=tw, tw_shift=shift) if mode == "twiddle" else {}
            inv = mode == "inverse"
            want, plain_ms = plain_run(
                lambda: pn.ntt_small_plain(x, log_n, inv, **kw), True)
            err = require_equal(pn.ntt_small(x, log_n, inv, **kw), want,
                                "ntt_small n=%d B=%d %s" % (n, b, mode))
            errs.append(err)
            del want
            ms = cuda_ms(lambda: pn.ntt_small(x, log_n, inv, **kw), 20)
            tw_bytes = tw.numel() * 8 if mode == "twiddle" else 0
            muls = (n // 2) * log_n * b + n * b * int(mode != "forward")
            b_ms, b_by = bound(2 * n * b * 8 + n * 8 + tw_bytes, muls)
            log("ntt_small n=%d B=%d %s: bit-equal, %.4f ms kernel, %.3f ms "
                "plain, bound %.4f ms (%s), %.1f%% of bound"
                % (n, b, mode, ms, plain_ms, b_ms, b_by, 100 * b_ms / ms))
            timings[(log_n, b, mode)] = dict(ms=ms, plain_ms=plain_ms,
                                             bound_ms=b_ms, bound_by=b_by,
                                             err=err)
        del x
    return max(errs), timings


def sm_clock_hz():
    """The SM's maximum clock from nvidia-smi, for the chain model."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def k5_inputs(rng, nb):
    import torch
    from boojum_tpu_torch.gadgets.sha256 import INITIAL_STATE
    blocks = torch.as_tensor(rng.integers(0, 256, (nb, 64)),
                             dtype=torch.int64).cuda()
    return blocks, torch.tensor(INITIAL_STATE, dtype=torch.int64).cuda()


def k5_bound(nb):
    """Bytes of the values the witness reads: per block W (64), the schedule
    sums lo / hi (2 x 48), 14 round rows (14 x 64), state_in (8) and fin
    lo / hi (2 x 8), plus the input bytes and the initial state; the zero
    padding of the (ROWS, nb, 64) layout is not counted."""
    used = 64 + 2 * 48 + 14 * 64 + 8 + 2 * 8
    return bound((nb * 64 + 8 + used * nb) * 8, 0)


def time_k5(rng, nb, plain=False):
    """K5 at nb chained blocks: bit-equal to its plain version, then timed;
    the chain model beside the roofline bound."""
    from boojum_tpu_torch.gadgets import sha256_witness as sw
    blocks, init = k5_inputs(rng, nb)
    want, plain_ms = plain_run(lambda: sw.compress_chain_plain(blocks, init),
                               plain)
    err = require_equal(sw.compress_chain(blocks, init), want,
                        "sha256_witness nb=%d" % nb)
    res = dict(err=err, ms=cuda_ms(lambda: sw.compress_chain(blocks, init),
                                   20))
    if plain:
        res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"] = k5_bound(nb)
    res["chain_ms"] = nb * 64 * SHA_ROUND_DEP * DEP_CYCLES / sm_clock_hz() * 1e3
    log("sha256_witness nb=%d: bit-equal, %.4f ms kernel%s, roofline bound "
        "%.5f ms (%s), chain model %.4f ms (%d rounds x %d dependent "
        "instructions x %d cycles)" % (
            nb, res["ms"], ", %.1f ms plain" % res["plain_ms"] if plain
            else "", res["bound_ms"], res["bound_by"], res["chain_ms"],
            nb * 64, SHA_ROUND_DEP, DEP_CYCLES))
    return res


def check_sha256_witness(rng):
    """K5 bit-equal to its plain version at 1, 3, 129 (the flagship's
    blocks) and 1000 chained blocks; timed at 129."""
    errs, timing = [], None
    for nb in (1, 3, 129, 1000):
        if nb == 129:
            timing = time_k5(rng, nb, plain=True)
            errs.append(timing["err"])
            continue
        from boojum_tpu_torch.gadgets import sha256_witness as sw
        blocks, init = k5_inputs(rng, nb)
        errs.append(require_equal(sw.compress_chain(blocks, init),
                                  sw.compress_chain_plain(blocks, init),
                                  "sha256_witness nb=%d" % nb))
    log("sha256_witness: bit-equal at nb = 1, 3, 129, 1000")
    return max(errs), timing


def k6_bound(shape):
    nblocks = shape[1] if shape[0] == "absorb" else 1
    k = max(nblocks * 8 - 1, 0) if shape[0] == "absorb" else 0
    b = bound((k + 2 * 12) * 8, nblocks * POSEIDON_MULS)
    return b


def time_k6(rng, shape, plain=False):
    """A K6 entry at one shape (("absorb", rate blocks) or ("permute",)):
    bit-equal to its plain version, then timed."""
    from boojum_tpu_torch.hash import poseidon
    st = rand_field(rng, (12,))
    if shape[0] == "absorb":
        el = rand_field(rng, (shape[1] * 8 - 1,))
        fn = lambda: poseidon.sponge_absorb(st, el)  # noqa: E731
        plain_fn = lambda: poseidon.sponge_absorb_plain(st, el)  # noqa: E731
    else:
        fn = lambda: poseidon.sponge_permute(st)  # noqa: E731
        plain_fn = lambda: poseidon.sponge_permute_plain(st)  # noqa: E731
    want, plain_ms = plain_run(plain_fn, plain)
    err = require_equal(fn(), want, "poseidon sponge %s" % (shape,))
    res = dict(err=err, ms=cuda_ms(fn, 20))
    if plain:
        res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"] = k6_bound(shape)
    nperm = shape[1] if shape[0] == "absorb" else 1
    res["chain_ms"] = nperm * 30 * POSEIDON_ROUND_DEP * DEP_CYCLES \
        / sm_clock_hz() * 1e3
    log("poseidon_sponge %s: bit-equal, %.4f ms kernel%s, roofline bound "
        "%.6f ms (%s), chain model %.4f ms" % (
            shape, res["ms"], ", %.2f ms plain" % res["plain_ms"] if plain
            else "", res["bound_ms"], res["bound_by"], res["chain_ms"]))
    return res


def check_poseidon_sponge(rng):
    """K6: `poseidon_absorb` at every length 0 .. 130 (the lengths whose
    pad fills one more block among them) from the zero state and three
    random states, each launch against the batched plain version, and
    `poseidon_permute`, timed. The `kernels` row is timed later, at the
    flagship prove's largest absorb."""
    import torch
    from boojum_tpu_torch.hash import poseidon

    states = [torch.zeros(12, dtype=torch.int64, device="cuda")] + \
        [rand_field(rng, (12,)) for _ in range(3)]
    lanes, elems = [], []
    for st in states:
        for k in range(131):
            lanes.append(st)
            elems.append(rand_field(rng, (k,)))
    got = torch.stack([poseidon.sponge_absorb(st, el)
                       for st, el in zip(lanes, elems)], dim=1)
    want = poseidon.sponge_absorb_plain_many(torch.stack(lanes, dim=1), elems)
    errs = [require_equal(got, want, "poseidon_absorb, lengths 0..130")]
    st = torch.stack(states, dim=1)
    got = torch.stack([poseidon.sponge_permute(st[:, i])
                       for i in range(st.shape[1])], dim=1)
    errs.append(require_equal(got, poseidon.permutation_stacked(st),
                              "poseidon_permute"))
    log("poseidon_sponge: poseidon_absorb bit-equal at lengths 0..130 from "
        "4 states (%d launches), poseidon_permute at 4 states" % len(lanes))
    timing = time_k6(rng, ("permute",))
    return max(errs + [timing["err"]])


# ---------------------------------------------------------------------------
# the classic-Poseidon tree entries (poseidon_leaf_hashes,
# poseidon_node_layers, poseidon_node_layer)
# ---------------------------------------------------------------------------

# entry ("leaf", "nodes" or "node") -> {"fixed": counts, "per_perm": counts},
# from SASS, by pipe as `pipe_counts` gives them
PTREE_SASS = {}
PTREE_KERNELS = {"leaf_kernel": "leaf", "nodes_kernel": "nodes",
                 "node_kernel": "node"}
# trips of the classic-Poseidon tree permutation's round loops (4 full, 22
# partial, 4 full rounds), and of the 4-lane Poseidon2 permutation's
PTREE_ROUND_TRIPS = (4, 22, 4)


def ptree_sass_counts(lib_path):
    """SASS of the tree entries in a built `poseidon` library, split into a
    fixed part and a part a permutation: {entry: {"fixed": counts,
    "per_perm": counts, "summary": `sass_summary`}}, entry "leaf", "nodes"
    or "node" (an older library may lack "nodes"). The innermost loops are
    the three round loops (4 full, 22 partial, 4 full rounds,
    `PTREE_ROUND_TRIPS`; the dense A_0 between them is unrolled), each body
    counted its trips; a leaf permutation is the body of the leaf kernel's
    rate-block loop with its round loops expanded, a `poseidon_node_layers`
    one the body of the level loop (its loads, barriers and stores
    included) inside the stage loop, and the rest of each is fixed; a
    `poseidon_node_layer` thread runs one permutation, so that whole kernel
    counts as one."""
    from boojum_tpu_torch.utils import cuda_build

    def comb(a, b, kb=1):
        return {p: a[p] + kb * b[p] for p in PIPES}

    out = {}
    for kname, instrs in cuda_build.sass(lib_path).items():
        entry = next((e for t, e in PTREE_KERNELS.items() if t in kname),
                     None)
        if entry is None:
            continue
        s = cuda_build.sass_summary(instrs, PTREE_ROUND_TRIPS)
        loops = s["loops"]
        inner = sorted((lp for lp in loops if not any(
            o is not lp and lp["start"] <= o["start"] and o["end"] <= lp["end"]
            for o in loops)), key=lambda lp: lp["start"])
        outer = sorted((lp for lp in loops if lp not in inner),
                       key=lambda lp: lp["end"] - lp["start"])
        if len(inner) != 3 or len(outer) != {"leaf": 1, "nodes": 2,
                                             "node": 0}[entry]:
            raise AssertionError("sass poseidon %s: %d loops, not the "
                                 "kernel's structure" % (kname, len(loops)))
        whole = pipe_counts(instrs)
        body = pipe_counts(instrs, outer[0]["start"], outer[0]["end"]) \
            if outer else whole
        per = body
        for t, lp in zip(PTREE_ROUND_TRIPS, inner):
            per = comb(per, pipe_counts(instrs, lp["start"], lp["end"]), t - 1)
        out[entry] = dict(fixed=comb(whole, body, -1), per_perm=per,
                          summary=s)
    return out


def ptree_sass():
    """`ptree_sass_counts` of the built library, kept in `PTREE_SASS` and
    printed."""
    from boojum_tpu_torch.utils import cuda_build
    for entry, c in ptree_sass_counts(
            cuda_build._lib_path("poseidon")).items():
        PTREE_SASS[entry] = dict(fixed=c["fixed"], per_perm=c["per_perm"])
        s = c["summary"]
        log("sass poseidon %s: %d instructions, %d integer-pipe, %d IMAD, "
            "%d loops; per permutation %s, fixed %s"
            % (PTREE_NAMES[entry], s["total"], s["integer"], s["imad"],
               len(s["loops"]), json.dumps(c["per_perm"]),
               json.dumps(c["fixed"])))


def ptree_perms(shape):
    """(threads, permutations) of one launch: ("leaf", k, m), ("nodes", m,
    levels) (a thread a first-level parent; a permutation a parent of any
    level) or ("node", m)."""
    if shape[0] == "leaf":
        return shape[2], shape[2] * -(-shape[1] // 8)
    if shape[0] == "nodes":
        return shape[1] // 2, shape[1] - (shape[1] >> shape[2])
    return shape[1] // 2, shape[1] // 2


def ptree_bound(shape):
    """`p2_bound`'s (the same 472 s-box multiplies a permutation, the same
    bytes); a ("nodes", m, levels) launch the sum over its layers, bound by
    what bounds its widest."""
    if shape[0] == "nodes":
        parts = [p2_bound(("node", shape[1] >> j)) for j in range(shape[2])]
        return sum(t for t, _ in parts), parts[0][1]
    return p2_bound(shape)


def ptree_sass_ms(shape):
    """The time the entry's own SASS (`ptree_sass`) takes for one launch at
    the card's issue rates: 64 thread-instructions a clock on an SM for the
    ALU pipe and for the FMA pipe each, 128 issue slots in all, whichever
    is longest; the bound from the instructions the compiled round issues,
    beside `ptree_bound`'s from the s-box multiplies alone."""
    threads, perms = ptree_perms(shape)
    c = PTREE_SASS[shape[0]]
    counts = {p: threads * c["fixed"][p] + perms * c["per_perm"][p]
              for p in PIPES}
    return max(counts["alu"], counts["fma"],
               counts["all"] / 2) / H100_INT_PER_S * 1e3


# K2's kernels by entry ("permute", "leaf", "node", "nodes"), and
# "entry/rolled" or "entry/unrolled" (the kernel's two builds: the full
# rounds' s-boxes in a rolled loop, or unrolled, `pallas_poseidon2.ROLL_FROM`
# picks by launch width) -> {"fixed": counts, "per_perm": counts} from SASS
# by pipe (`pipe_counts`); "nodes/..." also has "per_lane", one lane's share
# of a state hashed on 4 lanes at a narrow level
P2_KERNELS = {"permute_kernel": "permute", "leaf_kernel": "leaf",
              "node_kernel": "node", "nodes_kernel": "nodes"}
P2_SASS = {}
P2_LANES = 4


def p2_sass_counts(lib_path):
    """SASS of K2's kernels in a built `poseidon2` library, split into a
    fixed part and a part a permutation: {entry: {"fixed", "per_perm",
    "summary"}} (an older library lacks "nodes"). The permutation's loops
    are its round loops and the block loops inside the full ones
    (`P2_ROUND_TRIPS`, by start address; an older library's three round
    loops take `PTREE_ROUND_TRIPS`), each instruction counted the product
    of the trips of the loops that hold it. A `poseidon2_permute` or
    `poseidon2_node_layer` thread runs one permutation, so its whole kernel
    is one; a leaf permutation is the body of the rate-block loop (the
    outermost loop). The `poseidon2_node_layers` kernel runs the same
    one-thread permutation ("per_perm", taken from the node layer kernel)
    and, at narrow levels, the 4-lane one: "per_lane", a lane's round loops
    (the three innermost loops with warp shuffles, 4 full, 22 partial, 4
    full rounds) counted their trips, the code around them left out; its
    "fixed" part is left at 0."""
    from boojum_tpu_torch.utils import cuda_build

    def weighted(instrs, lo, hi, loops, trips):
        out = dict(alu=0, fma=0, all=0)
        for addr, op, text in instrs:
            if not lo <= addr <= hi:
                continue
            w = 1
            for t, lp in zip(trips, loops):
                if lp["start"] <= addr <= lp["end"]:
                    w *= t
            for p, n in pipe_counts([(addr, op, text)]).items():
                out[p] += w * n
        return out

    out, nodes = {}, {}
    for kname, instrs in cuda_build.sass(lib_path).items():
        entry = next((e for t, e in P2_KERNELS.items() if t in kname), None)
        if entry is None:
            continue
        build = "rolled" if "ILb1E" in kname else "unrolled"
        s = cuda_build.sass_summary(instrs)
        loops = sorted(s["loops"], key=lambda lp: lp["start"])
        if entry == "nodes":
            inner = [lp for lp in loops if not any(
                o is not lp and lp["start"] <= o["start"] and
                o["end"] <= lp["end"] for o in loops)]
            nodes[build] = (instrs, [lp for lp in inner if any(
                op.startswith("SHFL") for a, op, _ in instrs
                if lp["start"] <= a <= lp["end"])], s)
            continue
        lo, hi = instrs[0][0], instrs[-1][0]
        if entry == "leaf":  # the rate-block loop around the permutation
            outer = max(loops, key=lambda lp: lp["end"] - lp["start"])
            loops.remove(outer)
            lo, hi = outer["start"], outer["end"]
        trips = {len(cuda_build.P2_ROUND_TRIPS): cuda_build.P2_ROUND_TRIPS,
                 len(PTREE_ROUND_TRIPS): PTREE_ROUND_TRIPS}.get(len(loops))
        if trips is None:
            raise AssertionError("sass poseidon2 %s: %d permutation loops, "
                                 "not the kernel's structure"
                                 % (kname, len(loops)))
        body = pipe_counts(instrs, lo, hi)
        out["%s/%s" % (entry, build)] = dict(
            fixed={p: v - body[p] for p, v in pipe_counts(instrs).items()},
            per_perm=weighted(instrs, lo, hi, loops, trips), summary=s)
    for build, (instrs, shfl, s) in nodes.items():
        entry = out["nodes/" + build] = dict(
            fixed={p: 0 for p in PIPES},
            per_perm=out["node/" + build]["per_perm"], summary=s)
        if len(shfl) == 3:
            per = weighted(instrs, shfl[0]["start"], shfl[-1]["end"], shfl,
                           PTREE_ROUND_TRIPS)
            # the code between the three loops is not the lane's: out
            gaps = pipe_counts(instrs, shfl[0]["start"], shfl[-1]["end"])
            for lp in shfl:
                inside = pipe_counts(instrs, lp["start"], lp["end"])
                gaps = {p: gaps[p] - inside[p] for p in PIPES}
            entry["per_lane"] = {p: per[p] - gaps[p] for p in PIPES}
        s["shfl_loops"] = len(shfl)
    return out


def p2_sass():
    """`p2_sass_counts` of the built library, kept in `P2_SASS` and
    printed."""
    from boojum_tpu_torch.utils import cuda_build
    for entry, c in sorted(p2_sass_counts(
            cuda_build._lib_path("poseidon2")).items()):
        P2_SASS[entry] = {k: v for k, v in c.items() if k != "summary"}
        s = c["summary"]
        name, build = entry.split("/")
        log("sass poseidon2 %s (%s): %d instructions, %d integer-pipe, %d "
            "IMAD, %d loops; per permutation %s%s, fixed %s"
            % (P2_NAMES[name], build, s["total"], s["integer"], s["imad"],
               len(s["loops"]), json.dumps(c["per_perm"]),
               "; per lane of a 4-lane state %s" % json.dumps(c["per_lane"])
               if "per_lane" in c else "", json.dumps(c["fixed"])))


def p2_levels(m, levels):
    """The levels of one `poseidon2_node_layers` launch over m nodes, as
    (parents, narrow): byte_tree.cuh's stages of NODE_STAGE levels, a
    block's subtree over 2 NODE_THREADS nodes of the stage's input, a level
    narrow where a block has at most NODE_THREADS / 4 parents."""
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    out = []
    for lv in range(levels):
        width = m >> (dbh.NODE_STAGE * (lv // dbh.NODE_STAGE))
        per_block = min(2 * dbh.NODE_THREADS, width) >> (
            lv % dbh.NODE_STAGE + 1)
        out.append((m >> (lv + 1),
                    per_block * P2_LANES <= dbh.NODE_THREADS))
    return out


def p2_sass_ms(shape):
    """The time a K2 launch's own SASS (`p2_sass`) takes at the card's issue
    rates (as `ptree_sass_ms`): ("permute", B), ("leaf", k, m), ("node",
    m) or ("nodes", m, levels), the last from its levels' permutations, a
    narrow level's on 4 lanes; the kernel build the launch takes
    (`pallas_poseidon2.rolled`, `node_layers_rolled`)."""
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    kind = shape[0]
    width = {"permute": shape[-1], "leaf": shape[-1]}.get(
        kind, shape[1] // 2)
    roll = pp.node_layers_rolled(*shape[1:]) if kind == "nodes" \
        else pp.rolled(width)
    c = P2_SASS["%s/%s" % (kind, "rolled" if roll else "unrolled")]
    if kind == "nodes":
        threads = -(-shape[1] // (2 * dbh.NODE_THREADS)) * dbh.NODE_THREADS
        counts = {p: threads * c["fixed"][p] for p in PIPES}
        for parents, narrow in p2_levels(*shape[1:]):
            for p in PIPES:
                counts[p] += parents * (
                    P2_LANES * c["per_lane"][p] if narrow and "per_lane" in c
                    else c["per_perm"][p])
    else:
        threads = width
        perms = width * -(-shape[1] // 8) if kind == "leaf" else width
        counts = {p: threads * c["fixed"][p] + perms * c["per_perm"][p]
                  for p in PIPES}
    return max(counts["alu"], counts["fma"],
               counts["all"] / 2) / H100_INT_PER_S * 1e3


def check_ptree_nodes(cur, cap, timed=False):
    """`poseidon.node_layers` against the plain chain (`check_tree_nodes`)."""
    from boojum_tpu_torch.hash import poseidon
    return check_tree_nodes(
        "poseidon_node_layers", lambda: poseidon.node_layers(cur, cap),
        lambda: poseidon.node_layers_plain(cur, cap),
        lambda: poseidon.NODE_LAYERS_LAUNCHES, cur, cap, timed)


def time_ptree(rng, shape, plain=False):
    """A tree entry at one shape, ("leaf", k, m), ("nodes", m, levels)
    (`node_layers` of m nodes to m >> levels: one launch of a prove, or a
    whole tree) or ("node", m): bit-equal to its plain version, then
    timed."""
    from boojum_tpu_torch.hash import poseidon
    x = rand_field(rng, shape[1:] if shape[0] == "leaf" else (4, shape[1]))
    if shape[0] == "nodes":
        cap = shape[1] >> shape[2]

        def fn():
            return poseidon.node_layers(x, cap)
        err, plain_ms = check_ptree_nodes(x, cap, plain)
    else:
        fn, plain_fn = {
            "leaf": (poseidon.leaf_hashes, poseidon.leaf_hashes_plain),
            "node": (poseidon.node_layer, poseidon.node_layer_plain)
        }[shape[0]]
        want, plain_ms = plain_run(lambda: plain_fn(x), plain)
        err = require_equal(fn(x), want, "%s %s" % (PTREE_NAMES[shape[0]],
                                                    shape[1:]))
        fn = functools.partial(fn, x)
    res = dict(err=err, ms=cuda_ms(fn, 20))
    if plain:
        res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"] = ptree_bound(shape)
    res["sass_ms"] = ptree_sass_ms(shape)
    _, perms = ptree_perms(shape)
    log("%s %s: bit-equal, %.4f ms kernel (%.1f M perm/s%s), bound %.4f ms "
        "(%s), %.1f%% of bound; its SASS at the issue rates %.4f ms (%.1f%%)"
        % (PTREE_NAMES[shape[0]], shape[1:], res["ms"],
           perms / res["ms"] / 1e3,
           ", plain %.2f ms" % res["plain_ms"] if plain else "",
           res["bound_ms"], res["bound_by"],
           100 * res["bound_ms"] / res["ms"], res["sass_ms"],
           100 * res["sass_ms"] / res["ms"]))
    return res


def check_poseidon_tree(rng):
    """The classic-Poseidon tree entries bit-equal to their plain versions:
    leaves at k = 1, 7, 8, 9, 16, 93 (a partial block, whole blocks, one
    more element, the flagship's witness width) on m = 1000 + k and on a
    strided view; `poseidon_node_layers` against the plain chain at m = 2,
    32, 1000 (cap 1) and at every tree of a prove (`PTREE_PROVE_TREES`, cap
    16: three of 2^19 leaves, in two launches each); `poseidon_node_layer`
    at m = 2, 32, 1000; each entry's row timed with its plain version at
    (93, 2^19), a 2^19-leaf tree to cap 16 and m = 2^19. Every launch shape
    of a prove is checked and timed again in `per_prove_costs`. Returns
    {entry name: (largest error, timing of the row's shape)}."""
    from boojum_tpu_torch.hash import poseidon
    errs = []
    for k in (1, 7, 8, 9, 16, 93):
        x = rand_field(rng, (k, 1000 + k))
        errs.append(require_equal(poseidon.leaf_hashes(x),
                                  poseidon.leaf_hashes_plain(x),
                                  "poseidon_leaf_hashes k=%d" % k))
    view = rand_field(rng, (9, 4096))[:, :2048]  # a row stride > m
    errs.append(require_equal(poseidon.leaf_hashes(view),
                              poseidon.leaf_hashes_plain(view),
                              "poseidon_leaf_hashes on a strided view"))
    t = time_ptree(rng, ("leaf", 93, 1 << 19), plain=True)
    out = {"poseidon_leaf_hashes": (max(errs + [t["err"]]), t)}
    errs = [check_ptree_nodes(rand_field(rng, (4, m)), cap)[0]
            for m, cap in [(2, 1), (32, 1), (1000, 1)]
            + [(m, 16) for m in PTREE_PROVE_TREES]]
    t = time_ptree(rng, ("nodes", 1 << 19, 15), plain=True)
    out["poseidon_node_layers"] = (max(errs + [t["err"]]), t)
    errs = []
    for m in (2, 32, 1000):
        cur = rand_field(rng, (4, m))
        errs.append(require_equal(poseidon.node_layer(cur),
                                  poseidon.node_layer_plain(cur),
                                  "poseidon_node_layer m=%d" % m))
    t = time_ptree(rng, ("node", 1 << 19), plain=True)
    out["poseidon_node_layer"] = (max(errs + [t["err"]]), t)
    log("poseidon tree: leaf hashes bit-equal at k = 1, 7, 8, 9, 16, 93 and a "
        "strided (9, 2^11) view; node_layers bit-equal to the plain chain at "
        "m = 2, 32, 1000 (cap 1) and at the trees of a prove %s (cap 16), and "
        "on a 2^19-leaf tree to cap 16; node_layer at m = 2, 32, 1000 and "
        "2^19" % (list(PTREE_PROVE_TREES),))
    return out


# ---------------------------------------------------------------------------
# K8 (Blake2s) and K9 (Keccak-256)
# ---------------------------------------------------------------------------

# Blake2s message blocks and Keccak-256 absorbs of a leaf of k elements
BYTE_BLOCKS = {"blake2s": lambda k: max(-(-k // 8), 1),
               "keccak256": lambda k: k // 17 + 1}
# (algo, entry) -> {"fixed": counts, "per_block": counts}, from SASS; counts
# by pipe: "alu" integer-pipe instructions but IMAD, "fma" IMAD (the FMA
# pipe), "all" every instruction (the issue slots)
BYTE_SASS = {}
PIPES = ("alu", "fma", "all")


def pipe_counts(instrs, lo=None, hi=None):
    """Thread-instructions of a kernel's SASS (or of its address range
    [lo, hi]) by the pipe that issues them; uniform-datapath instructions
    run once a warp and count only as issue slots."""
    from boojum_tpu_torch.utils import cuda_build
    out = dict(alu=0, fma=0, all=0)
    for addr, op, _ in instrs:
        if lo is not None and not lo <= addr <= hi:
            continue
        base = op.split(".")[0]
        out["all"] += 1
        if base == "IMAD":
            out["fma"] += 1
        elif base in cuda_build.INT_OPCODES and not base.startswith("U"):
            out["alu"] += 1
    return out


def byte_sass():
    """SASS of the four byte-hash entries, split into a fixed part and a
    part per message block (a Blake2s compression, a Keccak-f permutation)
    by the kernels' loops: the Blake2s leaf kernel's block loop and its
    node kernel's level loop (inside its stage loop) each hold one unrolled
    compression (the level loop also its loads, barriers and stores); the
    Keccak kernels' innermost loop is the 24-trip round loop, which the
    leaf kernel's block loop and the node kernel's level loop hold. The
    node kernels' stage loop (the hand-on) counts as fixed."""
    from boojum_tpu_torch.utils import cuda_build

    def comb(a, b, kb=1):
        return {p: a[p] + kb * b[p] for p in PIPES}

    for algo, lib in BYTE_LIBS.items():
        for kname, instrs in cuda_build.sass(cuda_build._lib_path(lib)).items():
            entry = "leaf" if "leaf_kernel" in kname else "nodes"
            s = cuda_build.sass_summary(instrs)
            loops = [pipe_counts(instrs, lp["start"], lp["end"]) for lp in
                     sorted(s["loops"], key=lambda lp: lp["end"] - lp["start"])]
            whole = pipe_counts(instrs)
            nest = (1 if algo == "blake2s" else 2) + (entry == "nodes")
            if len(loops) == nest and algo == "blake2s":
                fixed, per = comb(whole, loops[0], -1), loops[0]
            elif len(loops) == nest:
                inner, outer = loops[:2]
                fixed, per = comb(whole, outer, -1), comb(outer, inner, 23)
            else:
                raise AssertionError("sass %s/%s: %d loops, not the kernel's "
                                     "structure" % (algo, entry, len(loops)))
            BYTE_SASS[(algo, entry)] = dict(fixed=fixed, per_block=per)
            log("sass %s %s_kernel: %d instructions, %d integer-pipe, %d "
                "loops; per %s %s, fixed %s" % (
                    lib, entry, s["total"], s["integer"], len(loops),
                    "compression" if algo == "blake2s" else "permutation",
                    json.dumps(per), json.dumps(fixed)))


def byte_algo_ops(algo, shape):
    """The 32-bit instructions the hash itself needs for one launch, from
    the algorithm, not the kernel: (ALU-only, either pipe). Xors, rotates
    (funnel shifts or byte permutes) and Keccak's chi (one LOP3) issue only
    on the ALU pipe; an add can also issue as IMAD on the FMA pipe. Blake2s
    compression: 80 G functions of 4 xors, 4 rotates and 4 adds (a + b + m
    one three-input add), and the feed-forward's 8 three-input xors.
    Keccak-f on 64-bit lanes as two 32-bit halves, a round: the column
    parities (5 lanes x 2 halves x 2 three-input xors), the rotate by 1 of
    each parity (5 x 2 funnel shifts), theta's xor into every lane with
    D unformed (25 x 2 three-input xors), the 24 rho rotates (none by 0 or
    32: 24 x 2 funnel shifts), chi (25 x 2), iota (one xor a nonzero half of
    the round constant); a leaf absorbs its lanes after the first block with
    one xor a half. The counter, the flags and the pad are constants or
    warp-uniform and are not counted. shape: ("leaf", k, m) or ("node",
    m)."""
    from boojum_tpu_torch.hash.keccak import _RC
    if algo == "blake2s":
        blocks = BYTE_BLOCKS[algo](shape[1]) if shape[0] == "leaf" else 1
        alu, either = blocks * (80 * 8 + 8), blocks * 80 * 4
    else:
        iota = sum((rc & 0xFFFFFFFF != 0) + (rc >> 32 != 0) for rc in _RC)
        perm = 24 * (20 + 10 + 50 + 48 + 50) + iota
        if shape[0] == "leaf":
            k = shape[1]
            alu = BYTE_BLOCKS[algo](k) * perm + 2 * max(k - 17, 0)
        else:
            alu = perm
        either = 0
    hashes = shape[2] if shape[0] == "leaf" else shape[1] // 2
    return hashes * alu, hashes * either


def byte_bound(algo, shape):
    """Least time for one launch: the bytes (each input element read once,
    each 32-byte digest written, or read as a child, once) over the memory
    rate, or the hash's own instructions (`byte_algo_ops`) at the card's
    rates: 64 thread-instructions a clock on an SM for the ALU pipe, 128
    issue slots in all, whichever takes longest. shape: ("leaf", k, m),
    ("node", m) (one layer), or ("nodes", m, levels): the sum over its
    layers, bound by what bounds its first (widest) layer."""
    if shape[0] == "nodes":
        parts = [byte_bound(algo, ("node", shape[1] >> j))
                 for j in range(shape[2])]
        return sum(p[0] for p in parts), parts[0][1]
    if shape[0] == "leaf":
        k, m = shape[1:]
        nbytes = k * m * 8 + m * 32
    else:
        m = shape[1]
        nbytes = m * 32 + (m // 2) * 32
    alu, either = byte_algo_ops(algo, shape)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max(alu, (alu + either) / 2) / H100_INT_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def byte_sass_ms(algo, shape):
    """A diagnostic beside the bound, not a bound: the time the kernel's own
    SASS (`byte_sass`: its address arithmetic, selects and the compiler's
    split between the pipes included) takes at the same issue rates, the
    FMA pipe also at 64 a clock."""
    if shape[0] == "leaf":
        threads = hashes = shape[2]
        blocks = BYTE_BLOCKS[algo](shape[1])
    else:  # a thread a first-level parent; a hash a parent of any level
        threads, blocks = shape[1] // 2, 1
        hashes = shape[1] - (shape[1] >> shape[2])
    c = BYTE_SASS[(algo, shape[0])]
    counts = {p: threads * c["fixed"][p] + hashes * blocks * c["per_block"][p]
              for p in PIPES}
    return max(counts["alu"], counts["fma"],
               counts["all"] / 2) / H100_INT_PER_S * 1e3


def byte_input(rng, shape):
    import numpy as np
    from boojum_tpu_torch.field import goldilocks as gl
    if shape[0] == "leaf":
        return rand_field(rng, shape[1:])
    return gl.from_u64(rng.integers(0, 1 << 32, (8, shape[1]),
                                    dtype=np.uint64), "cuda")


def check_tree_nodes(entry, run, plain, launched, cur, cap, timed=False):
    """A tree's node-layers entry (`run()`, its layer list) bit-equal to the
    plain chain (`plain()`), layer by layer, in the launches `node_launches`
    plans (`launched()` reads the entry's count); returns the error and,
    with ``timed``, the plain chain's time (`plain_run`)."""
    import torch
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    before = launched()
    got = run()
    launches = launched() - before
    want, plain_ms = plain_run(plain, timed)
    what = "%s m=%d cap=%d" % (entry, cur.shape[1], cap)
    if [g.shape for g in got] != [w.shape for w in want] or \
            launches != len(dbh.node_launches(cur.shape[1], len(want))):
        raise AssertionError("%s: layers %s, %d launches" % (
            what, [tuple(g.shape) for g in got], launches))
    if not got:
        return 0.0, plain_ms
    flat = [torch.cat([t.reshape(-1) for t in ts]) for ts in (got, want)]
    return require_equal(flat[0], flat[1], what), plain_ms


def check_node_layers(algo, cur, cap, timed=False):
    """`device_bytes_hash.node_layers` against the plain chain
    (`check_tree_nodes`)."""
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    return check_tree_nodes(
        "%s node_layers" % algo, lambda: dbh.node_layers(cur, algo, cap),
        lambda: dbh.node_layers_plain(cur, algo, cap),
        lambda: dbh.NODE_LAUNCHES[algo], cur, cap, timed)


def time_byte(rng, algo, shape, plain=False):
    """A K8 / K9 entry at one shape, ("leaf", k, m) or ("nodes", m, levels)
    (`node_layers` of m digests to m >> levels: one launch of a prove, or a
    whole tree): bit-equal to its plain version, then timed."""
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    x = byte_input(rng, shape)
    if shape[0] == "leaf":
        def fn():
            return dbh.leaf_hashes(x, algo)

        want, plain_ms = plain_run(lambda: dbh._PLAIN[algo][0](x), plain)
        err = require_equal(fn(), want, "%s %s" % (algo, shape))
    else:
        cap = shape[1] >> shape[2]

        def fn():
            return dbh.node_layers(x, algo, cap)
        err, plain_ms = check_node_layers(algo, x, cap, plain)
    res = dict(err=err, ms=cuda_ms(fn, 20))
    if plain:
        res["plain_ms"] = plain_ms
    res["bound_ms"], res["bound_by"] = byte_bound(algo, shape)
    res["sass_ms"] = byte_sass_ms(algo, shape)
    log("%s %s %s: bit-equal, %.4f ms kernel%s, bound %.4f ms (%s), %.1f%% "
        "of bound; its SASS at the issue rates %.4f ms" % (
            algo, shape[0], shape[1:], res["ms"],
            ", %.2f ms plain" % res["plain_ms"] if plain else "",
            res["bound_ms"], res["bound_by"],
            100 * res["bound_ms"] / res["ms"], res["sass_ms"]))
    return res


# (m, cap) of the `node_layers` checks: small and odd-stopping widths, every
# tree a prove builds (cap 16), and caps 1 and 4
NODE_CHECKS = ((2, 1), (32, 1), (1000, 1), (1 << 19, 16), (1 << 16, 16),
               (1 << 13, 16), (1 << 10, 16), (1 << 7, 16), (1 << 4, 16),
               (1 << 19, 1), (1 << 19, 4), (1 << 12, 4))
# the kernels-line shape of `*_node_layers`: a 2^19-leaf tree to its cap of
# 16, the widest a prove builds (two launches)
NODE_ROW = ("nodes", 1 << 19, 15)


def check_bytes_hash(rng):
    """K8 and K9: the leaf entry bit-equal to its plain version at the
    block-boundary widths (k = 8, 16: whole Blake2s blocks; 17, 34: the
    Keccak pad in a block of its own) on a small m, on a strided view, and
    at the row's shape, (93, 2^19) (the flagship's witness oracle); the node
    entry, `node_layers`, bit-equal to the plain per-layer chain in the
    launches it plans at each of `NODE_CHECKS` and at the row's shape, a
    2^19-leaf tree to cap 16 (two launches); both rows timed with their
    plain versions. Returns
    {entry name: (largest error, timing of the row's shape)}."""
    out = {}
    for algo in BYTE_LIBS:
        from boojum_tpu_torch.hash import device_bytes_hash as dbh
        errs = []
        for k in (1, 8, 16, 17, 34, 93):
            x = rand_field(rng, (k, 1000 + k))
            errs.append(require_equal(dbh.leaf_hashes(x, algo),
                                      dbh._PLAIN[algo][0](x),
                                      "%s leaf k=%d" % (algo, k)))
        view = rand_field(rng, (17, 4096))[:, :2048]
        errs.append(require_equal(dbh.leaf_hashes(view, algo),
                                  dbh._PLAIN[algo][0](view),
                                  "%s leaf on a strided view" % algo))
        t = time_byte(rng, algo, ("leaf", 93, 1 << 19), plain=True)
        out["%s_leaf_hashes" % algo] = (max(errs + [t["err"]]), t)
        errs = [check_node_layers(algo, byte_input(rng, ("node", m)), cap)[0]
                for m, cap in NODE_CHECKS]
        t = time_byte(rng, algo, NODE_ROW, plain=True)
        out["%s_node_layers" % algo] = (max(errs + [t["err"]]), t)
        log("%s: leaf hashes bit-equal at k = 1, 8, 16, 17, 34, 93 and a "
            "strided view; node_layers bit-equal to the plain chain at "
            "(m, cap) %s and at %s" % (
                algo, list(NODE_CHECKS), NODE_ROW))
    return out


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# stages 2+3 (csrc/stage23.cu): the row kernel and the scan
# ---------------------------------------------------------------------------


STAGE23_SOURCE = "boojum_tpu_torch/csrc/stage23.cu"
STAGE23_REPLACES = "boojum_tpu/prover/device_prover.py:1704"
# the row-kernel keys (`stage23.Launch.key`) that the proves of every path
# launched, with their launches, gathered by `reset_counts` and
# `stage23_path_shapes`
STAGE23_SHAPES = collections.Counter()
STAGE23_ITERS = 20


def stage23_path_shapes():
    """Moves the row-kernel launches by key since the last call into
    STAGE23_SHAPES."""
    from boojum_tpu_torch.prover import stage23
    for key, n in stage23.SHAPES.items():
        if key[0] == "rows":
            STAGE23_SHAPES[key] += n
    stage23.SHAPES.clear()


def stage23_key(n, nv, qd, mode=None, nsub=0, width=0, ntid=0, ntab=0,
                consts=4):
    """A row-kernel key for made-up inputs: witness (n, nv + 1) with the
    multiplicity last; setup (n, nv + consts + ntab), the table ids first
    among the constants; lookups "specialized" (width columns a repetition
    at the end of the variables, the id in a constant column) or
    "general" (width + 1 columns from column 0, a selector)."""
    from boojum_tpu_torch.prover import stage23
    lk = None
    if mode:
        pw = width if mode == "specialized" else width + 1
        lk = stage23.LookupInputs(
            beta=None, gamma_pows=None, width=width, pw=pw,
            base_off=nv - nsub * pw if mode == "specialized" else 0,
            num_subargs=nsub, tid_cols=tuple(range(nv, nv + ntid)),
            table_off=nv + consts, num_table=ntab, mult_col=nv)
    kw, ks = nv + 1, nv + consts + ntab
    return ("rows",) + tuple(stage23.row_params(n, nv, qd, kw, ks, lk, kw,
                                                ks)[:15]) + (
        mode == "general",)


def stage23_inputs(rng, key, device_scalars):
    """Random inputs on the card for a row-kernel key, as `stage23.stage23`
    arguments (`stage23.random_inputs`: the table ids in the first constant
    columns), and the rows made zero: a zero aggregate of repetition 0 on
    row n/3, of the table on row n/2 (with lookups), a zero denominator of
    copy column 0 on row 2n/3 (z is zero after it), and every inverse of
    row 5n/6 zero (at n >= 6). The challenges are device scalars
    (`ext2.PreparedExt`) or host pairs."""
    from boojum_tpu_torch.prover import stage23
    (n, nv, qd, ldw, lds, _, lookup, nsub, pw, base_off, width, ntid,
     table_off, ntab, mult_col, has_sel) = key[1:]
    lk = None
    if lookup:
        lk = dict(width=width, pw=pw, base_off=base_off, num_subargs=nsub,
                  tid_cols=tuple(range(nv, nv + ntid)), table_off=table_off,
                  num_table=ntab, mult_col=mult_col, sel=has_sel)
    rows = dict(a=n // 3, b=n // 2, den=2 * n // 3, all=5 * n // 6)
    if n < 6:
        rows = {}
    inputs = stage23.random_inputs(
        rng, n, nv, qd, ldw, lds, lk,
        (rows["a"], rows["b"], rows["den"]) if rows else None,
        {rows["all"]: range(key[6] // 2)} if rows else None)
    if not lookup:
        rows.pop("a", None)
        rows.pop("b", None)
    return stage23.args_on(inputs, "cuda", device_scalars), rows


def stage23_plain_scan(rows_out, chunks):
    """The scan's plain version over the row kernel's output: z, the
    exclusive prefix product of the totals (`device.grand_product_
    exclusive`), then the partials, in the z and partial columns."""
    from boojum_tpu_torch.field import extension as ext2
    from boojum_tpu_torch.prover import device as dops
    out = rows_out.clone()
    part = dops.grand_product_exclusive((out[:, 0], out[:, 1]))
    out[:, 0], out[:, 1] = part
    for c in range(chunks - 1):
        part = ext2.mul(part, (out[:, 2 + 2 * c], out[:, 3 + 2 * c]))
        out[:, 2 + 2 * c], out[:, 3 + 2 * c] = part
    return out


# field multiplies of an ext product (Karatsuba: three products; the
# non-residue 7 is a shift and a subtraction) and of one base inversion by
# `stage23.INVERSE_CHAIN` (63 squarings, 9 multiplies)
EXT_MUL, CHAIN_MULS = 3, 72


def stage23_row_muls(nv, qd, lookup, nsub, pw, ntid, ntab, has_sel):
    """The least field multiplies a row of `stage23_rows`' function needs,
    whatever the kernel does: each copy factor w + (β·k_j)·x + γ or
    w + β·σ_j + γ takes 2 (β·k_j is one constant a column), each chunk's
    numerator and denominator the product of its factors, each chunk's
    ratio one product, the row's total G - 1; every inverse of the row (G
    denominators, with lookups an aggregate a repetition and the table's)
    the norm c0^2 - 7·c1^2 (2) and the conjugate's scaling (2), all the
    row's norms in one batch inversion that masks zeros (3 a norm and one
    chain); an aggregate β_l + Σ γ^t·col_t (+ γ^width·id) 2 a column past
    γ^0 = 1, sel and the multiplicity 2 each."""
    chunks = -(-nv // qd)
    inverses = chunks + (nsub + 1 if lookup else 0)
    muls = 4 * nv + EXT_MUL * (2 * (nv - chunks) + 2 * chunks - 1) \
        + 7 * inverses - 3 + CHAIN_MULS
    if lookup:
        muls += nsub * 2 * (pw - 1 + (ntid > 0) + has_sel) \
            + 2 * (ntab - 1) + 2
    return muls


def stage23_bounds(key):
    """The bound of each kernel at a key: the larger of its bytes (each
    input read once, each output written once) at the HBM rate and the
    field multiplies its function needs (`stage23_row_muls`; the scan's:
    z's product and the G - 1 partials, an ext product each a row) at
    IMAD_PER_FIELD_MUL each."""
    (n, nv, qd, _, _, ldo, lookup, nsub, pw, base_off, width, ntid,
     table_off, ntab, mult_col, has_sel) = key[1:]
    chunks = -(-nv // qd)
    wit_cols = set(range(nv)) | {mult_col} if lookup else set(range(nv))
    setup_cols = set(range(nv))
    if lookup:
        wit_cols |= set(range(base_off, base_off + nsub * pw))
        setup_cols |= set(range(nv, nv + ntid)) | set(
            range(table_off, table_off + ntab))
    rows_bytes = 8 * n * (len(wit_cols) + len(setup_cols) + 1 + has_sel
                          + ldo)
    scan_bytes = 8 * n * 2 * (2 * chunks)
    return (bound(rows_bytes, n * stage23_row_muls(
        nv, qd, lookup, nsub, pw, ntid, ntab, has_sel)),
        bound(scan_bytes, n * EXT_MUL * chunks))


def check_stage23(rng, key, timed=False, device_scalars=True):
    """`stage23.stage23` on the card at a row-kernel key against
    `stage23_plain` on the same inputs (with zero rows: `stage23_inputs`),
    bit-equal, the zero rows showing; the scan alone against its plain
    version over the same row-kernel output; with ``timed`` each kernel
    alone, the plain versions and the bounds. Returns the largest error and
    the timings by kernel."""
    import numpy as np
    import torch
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.prover import stage23
    args, rows = stage23_inputs(rng, key, device_scalars)
    got = stage23.stage23(*args)
    want, plain_ms = plain_run(lambda: stage23.stage23_plain(*args), timed)
    what = "stage23 %s" % (key[1:],)
    err = require_equal(got, want, what)
    host = gl.to_u64(got)
    chunks = -(-key[2] // key[3])
    zeros = False
    if rows:
        zeros = host[rows["den"] + 1:, :2].any() \
            or not host[rows["den"], :2].any()
    if "a" in rows:
        zeros = zeros or host[rows["a"], 2 * chunks:2 * chunks + 2].any() \
            or host[rows["b"], -2:].any()
    launch = stage23.Launch(*args)
    launch.rows()
    rows_out = launch.out.clone()
    if rows:  # the row kernel's every output of that row is 0
        zeros = zeros or bool(rows_out[rows["all"]].any())
    if zeros:
        raise AssertionError("%s: the zero rows do not show" % what)
    launch.scan()
    want_scan, scan_plain_ms = plain_run(
        lambda: stage23_plain_scan(rows_out, chunks), timed)
    err = max(err, require_equal(launch.out, want_scan, what + " scan"))
    if not timed:
        return err, None
    (rb, rby), (sb, sby) = stage23_bounds(key)
    rows_ms = cuda_ms(launch.rows, STAGE23_ITERS)
    scan_ms = cuda_ms(launch.scan, STAGE23_ITERS)
    out = {"stage23_rows": dict(err=err, ms=rows_ms, plain_ms=plain_ms,
                                bound_ms=rb, bound_by=rby),
           "stage23_scan": dict(err=err, ms=scan_ms, plain_ms=scan_plain_ms,
                                bound_ms=sb, bound_by=sby)}
    for name, t in out.items():
        log("%s %s: bit-equal, %.4f ms, plain %.3f ms (%s), bound %.3g ms "
            "(%s), %.1f%% of bound" % (
                name, key[1:], t["ms"], t["plain_ms"],
                "the whole stage23_plain" if name == "stage23_rows"
                else "grand product and partials", t["bound_ms"],
                t["bound_by"], 100 * t["bound_ms"] / t["ms"]))
    torch.cuda.synchronize()
    return err, out


# the flagship's row-kernel key (2^16 rows, 92 copy columns of which 32
# are the 8 width-4 lookups', quotient degree 4, one shared table id, 8
# constant and 5 table columns) for --kernels-only; the proves' own keys
# are checked after the paths
STAGE23_FLAGSHIP_KEY = dict(n=1 << 16, nv=92, qd=4, mode="specialized",
                            nsub=8, width=4, ntid=1, ntab=5, consts=8)


def check_stage23_kernels(rng):
    """Both stage-2+3 kernels bit-equal to their plain versions at made-up
    keys: one row (one inverse, one lane a row); around the scan's tile (32
    rows, 256, 512 = one tile, 1613 = three tiles and a ragged one); the
    recursion outer circuit's width (132 copy columns, no lookups); a row of
    150 inverses (the row kernel's 16-slot build); in both lookup modes,
    with host and device challenges; and at the flagship's key at 2^17 and
    (timed) 2^16 rows."""
    errs = []
    for kw, dev in ((dict(n=1, nv=3, qd=4), False),
                    (dict(n=32, nv=14, qd=4, mode="specialized", nsub=2,
                          width=3, ntid=2, ntab=4), False),
                    (dict(n=256, nv=20, qd=8, mode="general", nsub=4,
                          width=3, ntab=4), True),
                    (dict(n=512, nv=132, qd=8), True),
                    (dict(n=1613, nv=5, qd=4, mode="general", nsub=1,
                          width=3, ntab=4), True),
                    (dict(n=1000, nv=300, qd=2), True),
                    (dict(n=1 << 12, nv=11, qd=4, mode="specialized",
                          nsub=1, width=3, ntid=1, ntab=4), False),
                    (dict(STAGE23_FLAGSHIP_KEY, n=1 << 17), True)):
        errs.append(check_stage23(rng, stage23_key(**kw),
                                  device_scalars=dev)[0])
    err, timing = check_stage23(rng, stage23_key(**STAGE23_FLAGSHIP_KEY),
                                timed=True)
    log("stage23_rows / stage23_scan: bit-equal at n = 1, 32, 256, 512, "
        "1613, 4096, at 150 inverses a row and at the flagship's key (2^16, "
        "2^17 rows), the zero rows showing")
    from boojum_tpu_torch.prover import stage23
    stage23.SHAPES.clear()  # made-up keys, not a prove's
    return max(errs + [err]), timing


def check_stage23_prove_shapes(rng):
    """Both kernels at every row-kernel key that the proves launched
    (STAGE23_SHAPES), each against its plain version and timed; returns
    the largest error, the timings by key and the sums of launches x time
    and x bound."""
    stage23_path_shapes()
    errs, timings = [], {}
    for key, launches in sorted(STAGE23_SHAPES.items()):
        err, t = check_stage23(rng, key, timed=True)
        errs.append(err)
        timings[key] = (launches, t)
    log("stage23 prove keys (launches, rows ms, scan ms): %s" % json.dumps(
        [[list(k[1:]), n, round(t["stage23_rows"]["ms"], 4),
          round(t["stage23_scan"]["ms"], 4)]
         for k, (n, t) in timings.items()]))
    return max(errs), timings


def check_stage_launches(counts, what, proves, sharded=0):
    """The ``proves`` single-device proves of a path (each path knows its
    own) launched stage23_rows once each, stage23_scan as often as their
    row counts ask (`stage23.scan_launches`, from the row-kernel keys of
    the path in `stage23.SHAPES`), these and the path's ``sharded`` proves
    (whose stages 2+3 run op by op) quotient_sweep once each (its keys in
    `quotient.SHAPES`), and no plain version ran."""
    from boojum_tpu_torch.prover import quotient, stage23
    keys = {k: c for k, c in stage23.SHAPES.items() if k[0] == "rows"}
    scans = sum(c * stage23.scan_launches(k[1]) for k, c in keys.items())
    log("%s: %d single-device and %d sharded proves, stage23_rows %d, "
        "stage23_scan %d launches (%d wanted), quotient_sweep %d" % (
            what, proves, sharded, counts["stage23_rows"],
            counts["stage23_scan"], scans, counts["quotient_sweep"]))
    if counts["stage23_rows"] != proves or sum(keys.values()) != proves \
            or counts["stage23_scan"] != scans:
        raise AssertionError("the %s proves (%d) launched stage23_rows %d "
                             "and stage23_scan %d times (%d wanted)" % (
                                 what, proves, counts["stage23_rows"],
                                 counts["stage23_scan"], scans))
    if counts["quotient_sweep"] != proves + sharded \
            or sum(quotient.SHAPES.values()) != proves + sharded:
        raise AssertionError("the %s proves (%d) launched quotient_sweep %d "
                             "times" % (what, proves + sharded,
                                        counts["quotient_sweep"]))
    if counts["plain_on_cuda"]:
        raise AssertionError("a plain version ran on a CUDA tensor")


# ---------------------------------------------------------------------------
# the quotient sweep (csrc/quotient.cu)
# ---------------------------------------------------------------------------


QUOTIENT_SOURCE = "boojum_tpu_torch/csrc/quotient.cu"
QUOTIENT_REPLACES = "boojum_tpu/prover/device_prover.py:165"
# the keys (`quotient.Launch.key`: layout, rows a coset, the oracles'
# columns and LDE factor) that the proves of every path launched, with
# their launches, gathered by `reset_counts` and `quotient_path_shapes`
QUOTIENT_SHAPES = collections.Counter()
QUOTIENT_ITERS = 20
# the "quotient sweep" stage of each configuration's op-counted prove:
# label -> (torch ops, wall s), filled by `log_stage_ops` and
# `stage_profiles`
QUOTIENT_STAGE = {}
# most torch ops the stage may take: the flagship's (with the device
# transcript) and the recursion outer prove's (88,174 and 520,406 when the
# sweep ran op by op)
MAX_QUOTIENT_OPS = {"flagship, device transcript": 1000,
                    "recursion outer cold": 2000}


def quotient_path_shapes():
    """Moves the quotient launches by key since the last call into
    QUOTIENT_SHAPES."""
    from boojum_tpu_torch.prover import quotient
    QUOTIENT_SHAPES.update(quotient.SHAPES)
    quotient.SHAPES.clear()


def check_quotient(rng, key, timed=False, device_scalars=True):
    """`quotient.quotient_sweep` on the card at a key (layout, rows, the
    oracles' witness / setup / stage-2 columns and LDE factor) against
    `quotient_plain` on the same random inputs (`quotient.random_inputs`:
    every input zero at one point and p - 1 at another), bit-equal, one
    launch; with ``timed`` the kernel alone, the plain version and the
    bound (`quotient.quotient_bound`: the bytes read and written once, the
    function's multiplies). Returns the error and the timing."""
    import torch
    from boojum_tpu_torch.prover import quotient
    q, rows, kw, ks, k2, lde = key
    if k2 != q.stage2_cols:
        raise AssertionError("a quotient key with %d stage-2 columns, its "
                             "layout %d" % (k2, q.stage2_cols))
    args = quotient.args_on(quotient.random_inputs(rng, q, rows, kw, ks, lde),
                            "cuda", device_scalars)
    before = quotient.LAUNCHES["quotient_sweep"]
    got = quotient.quotient_sweep(*args)
    if quotient.LAUNCHES["quotient_sweep"] != before + 1:
        raise AssertionError("quotient_sweep did not launch its kernel once")
    want, plain_ms = plain_run(lambda: quotient.quotient_plain(*args), timed)
    what = "quotient_sweep (qd %d, %d rows, %d + %d + %d columns, tape %d)" \
        % (q.qd, rows, kw, ks, k2, len(q.tape.code))
    err = require_equal(got, want, what)
    if not timed:
        return err, None
    launch = quotient.Launch(*args)
    ms = cuda_ms(launch.run, QUOTIENT_ITERS)
    bound_ms, bound_by = bound(*quotient.quotient_bound(q, rows))
    log("%s: bit-equal, %.4f ms, plain %.3f ms, bound %.3g ms (%s), %.1f%% "
        "of bound; tape %d instructions, %d slots, %d multiplies a point"
        % (what, ms, plain_ms, bound_ms, bound_by, 100 * bound_ms / ms,
           len(q.tape.code), q.tape.slots, q.tape.muls()))
    torch.cuda.synchronize()
    return err, dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by)


def made_up_quotient_key(name, rows, qd=None, lde=8):
    """The key of `quotient.made_up_case` ``name`` at ``rows`` (its qd
    replaced by ``qd``)."""
    import dataclasses
    from boojum_tpu_torch.prover import quotient
    q, kw, ks = quotient.made_up_case(name)
    if qd is not None:
        q = dataclasses.replace(q, qd=qd)
    return (q, rows, kw, ks, q.stage2_cols, max(lde, q.qd))


def check_quotient_kernels(rng):
    """`quotient_sweep` bit-equal to `quotient_plain` at made-up keys
    (`quotient.made_up_case`): no lookup; the specialized lookups with the
    table id in a constant column a repetition and shared; the
    general-purpose lookups with the marker's selector; general gates under
    selector paths and a specialized gate; the flattened Poseidon and
    Poseidon2 gates, also at qd 16 over 4096 rows (the recursion outer
    prove's shape); one partial block (8 rows); 2^19 points (the
    lookup-heavy prove's); each with a point of zeros and one of p - 1,
    host and device challenges; then timed at the flagship's widths
    (`flagship_like`, 2^16 rows)."""
    from boojum_tpu_torch.prover import quotient
    errs = []
    for name in quotient.MADE_UP_CASES:
        for rows, dev in ((8, False), (1 << 12, True)):
            errs.append(check_quotient(rng, made_up_quotient_key(name, rows),
                                       device_scalars=dev)[0])
    for key in (made_up_quotient_key("poseidon_gates", 1 << 12, qd=16),
                made_up_quotient_key("specialized_shared_id", 1 << 17)):
        errs.append(check_quotient(rng, key)[0])
    err, timing = check_quotient(rng, made_up_quotient_key(
        "flagship_like", 1 << 16), timed=True)
    log("quotient_sweep: bit-equal at the made-up keys %s (8 and 4096 "
        "rows), Poseidon gates at qd 16, 2^19 points and the flagship's "
        "widths" % ", ".join(quotient.MADE_UP_CASES))
    quotient.SHAPES.clear()  # made-up keys, not a prove's
    return max(errs + [err]), timing


def check_quotient_prove_shapes(rng):
    """The kernel at every key that the proves launched (QUOTIENT_SHAPES),
    against its plain version and timed; returns the largest error and the
    timings by key with their launches."""
    quotient_path_shapes()
    errs, timings = [], {}
    for key, launches in QUOTIENT_SHAPES.items():
        err, t = check_quotient(rng, key, timed=True)
        errs.append(err)
        timings[key] = (launches, t)
    log("quotient prove keys (qd, rows, tape instructions, slots, launches, "
        "ms, bound ms): %s" % json.dumps(
            [[k[0].qd, k[1], len(k[0].tape.code), k[0].tape.slots, n,
              round(t["ms"], 4), round(t["bound_ms"], 4)]
             for k, (n, t) in timings.items()]))
    return max(errs), timings


def reset_counts():
    from boojum_tpu_torch.gadgets import sha256_witness as sw
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.hash import poseidon
    from boojum_tpu_torch.ntt import mxu_ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    for mod in (mxu_ntt, pp, pn, sw, poseidon):
        mod.LAUNCHES = 0
        mod.PLAIN_CUDA_CALLS = 0
        if hasattr(mod, "SHAPES"):
            mod.SHAPES.clear()
    pp.LEAF_LAUNCHES = pp.NODE_LAUNCHES = pp.NODE_LAYERS_LAUNCHES = 0
    poseidon.LEAF_LAUNCHES = poseidon.NODE_LAUNCHES = 0
    poseidon.NODE_LAYERS_LAUNCHES = 0
    pn.TORCH_TWIDDLE_MULS = 0
    dbh.LEAF_LAUNCHES.clear()
    dbh.NODE_LAUNCHES.clear()
    dbh.SHAPES.clear()
    dbh.PLAIN_CUDA_CALLS = 0
    from boojum_tpu_torch.prover import quotient, stage23
    stage23_path_shapes()  # the last path's row-kernel keys, kept
    stage23.LAUNCHES.clear()
    stage23.PLAIN_CUDA_CALLS = 0
    quotient_path_shapes()  # the last path's quotient keys, kept
    quotient.LAUNCHES.clear()
    quotient.PLAIN_CUDA_CALLS = 0


def read_counts():
    """Launches of every kernel entry, plain calls on CUDA tensors, and torch
    cross-twiddle multiplies on CUDA tensors."""
    from boojum_tpu_torch.gadgets import sha256_witness as sw
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.hash import poseidon
    from boojum_tpu_torch.ntt import mxu_ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn
    from boojum_tpu_torch.prover import quotient, stage23
    return dict(ntt_stage=mxu_ntt.LAUNCHES, poseidon2_permute=pp.LAUNCHES,
                poseidon2_leaf_hashes=pp.LEAF_LAUNCHES,
                poseidon2_node_layer=pp.NODE_LAUNCHES,
                poseidon2_node_layers=pp.NODE_LAYERS_LAUNCHES,
                ntt_small=pn.LAUNCHES, sha256_witness=sw.LAUNCHES,
                poseidon_sponge=poseidon.LAUNCHES,
                poseidon_leaf_hashes=poseidon.LEAF_LAUNCHES,
                poseidon_node_layer=poseidon.NODE_LAUNCHES,
                poseidon_node_layers=poseidon.NODE_LAYERS_LAUNCHES,
                blake2s_leaf_hashes=dbh.LEAF_LAUNCHES["blake2s"],
                blake2s_node_layers=dbh.NODE_LAUNCHES["blake2s"],
                keccak256_leaf_hashes=dbh.LEAF_LAUNCHES["keccak256"],
                keccak256_node_layers=dbh.NODE_LAUNCHES["keccak256"],
                stage23_rows=stage23.LAUNCHES["stage23_rows"],
                stage23_scan=stage23.LAUNCHES["stage23_scan"],
                quotient_sweep=quotient.LAUNCHES["quotient_sweep"],
                plain_on_cuda=mxu_ntt.PLAIN_CUDA_CALLS + pp.PLAIN_CUDA_CALLS
                + pn.PLAIN_CUDA_CALLS + sw.PLAIN_CUDA_CALLS
                + poseidon.PLAIN_CUDA_CALLS + dbh.PLAIN_CUDA_CALLS
                + stage23.PLAIN_CUDA_CALLS + quotient.PLAIN_CUDA_CALLS,
                torch_twiddle_muls=pn.TORCH_TWIDDLE_MULS)


def ntt_path(k4):
    """The standalone NTT entry point at 2^24 x 8: `pallas_ntt.ntt_any` (the
    K4 route) against the committed JAX digest and against the K1 route
    (`ntt.ntt_fourstep_cols`), with both routes timed. ``k4`` maps a K4
    shape (log_n, B, mode) to its timing from `check_ntt_small`."""
    import numpy as np
    import torch
    from boojum_tpu_torch.field import goldilocks as gl
    from boojum_tpu_torch.ntt import ntt
    from boojum_tpu_torch.ntt import pallas_ntt as pn

    ref = load_digest("ntt_2e24_digest.json")
    n, b = ref["shape"]
    log_n = n.bit_length() - 1
    x = gl.from_u64(np.random.default_rng(ref["seed"]).integers(
        0, gl.ORDER, (n, b), dtype=np.uint64), "cuda")

    reset_counts()  # counts of the NTT path only
    out = pn.ntt_any(x, log_n)
    torch.cuda.synchronize()
    counts = read_counts()
    log("ntt path (%d, %d): launches %s" % (n, b, json.dumps(counts)))
    if counts["ntt_small"] != 4 or log_n != 24:
        raise AssertionError("ntt_any at 2^24 should launch ntt_small 4 "
                             "times, got %d at 2^%d"
                             % (counts["ntt_small"], log_n))
    if counts["plain_on_cuda"] or counts["torch_twiddle_muls"]:
        raise AssertionError("a plain version or a torch twiddle multiply "
                             "ran on a CUDA tensor")

    host = gl.to_u64(out)
    digest = hashlib.sha256(host.astype("<u8").tobytes()).hexdigest()
    log("ntt path output sha256 %s (reference %s, %s)"
        % (digest, ref["output_u64_sha256"], ref["function"]))
    if digest != ref["output_u64_sha256"]:
        rows = [[str(int(v)) for v in host[r]] for r in (0, 1)]
        raise AssertionError("ntt_any output differs from the reference "
                             "(rows 0-1 %s equal the reference's)"
                             % ("" if rows == ref["rows_0_1"] else "do not"))
    del host
    k1_out = ntt.ntt_fourstep_cols(x)
    if not torch.equal(out, k1_out):
        raise AssertionError("ntt_any differs from ntt.ntt_fourstep_cols")
    log("ntt path: ntt_any equals the K1 route ntt.ntt_fourstep_cols")
    del out, k1_out

    ms_k4 = cuda_ms(lambda: pn.ntt_any(x, log_n), 3)
    ms_k1 = cuda_ms(lambda: ntt.ntt_fourstep_cols(x), 3)
    # One K4-route call at 2^24 splits 2^12 x 2^12, and each 2^12 pass
    # 2^9 x 2^3: 4 kernel launches -- (512, 2^18) with the inner twiddle
    # twice, (8, 2^24) with the outer twiddle once and without once -- and
    # 6 transpose copies (4 inner, 2 outer), each pass over all 2^27
    # elements. Kernels from check_ntt_small; transposes timed alone here.
    inner, outer = x.view(512, 8, -1), x.view(4096, 4096, b)
    parts = dict(
        kernels=2 * k4[(9, n * b // 512, "twiddle")]["ms"]
        + k4[(3, n * b // 8, "twiddle")]["ms"]
        + k4[(3, n * b // 8, "forward")]["ms"],
        transpose_inner=4 * cuda_ms(
            lambda: inner.transpose(0, 1).reshape(8, -1), 10),
        transpose_outer=2 * cuda_ms(
            lambda: outer.transpose(0, 1).reshape(4096, -1), 10))
    b_ms, _ = bound((10 * 2 * n * b + 2 * 512 * 8 + 2 ** 24) * 8, 0)
    log("ntt path ntt_any (K4 route): %.3f ms per call, %.3f ms per 2^%d "
        "transform, %.2f NTT/s; byte bound of its 4 kernel passes (with "
        "their twiddle tables) + 6 transposes %.3f ms"
        % (ms_k4, ms_k4 / b, log_n, b * 1e3 / ms_k4, b_ms))
    log("ntt path split per call (parts timed alone, ms): " + json.dumps(
        {k: round(v, 4) for k, v in parts.items()}))
    log("ntt path ntt_fourstep_cols (K1 route, cross twiddles kept on the "
        "card): %.3f ms per call, %.3f ms per transform, %.2f NTT/s"
        % (ms_k1, ms_k1 / b, b * 1e3 / ms_k1))
    return counts


def per_prove_costs(rng, label, k1_shapes, p2_shapes, k5_blocks, k6_shapes,
                    byte_shapes, memo):
    """Holds every kernel shape that ``label`` (one prove, or a setup)
    launched against its plain version, times it and sums, per kernel,
    launches x time, launches x bound and launches x (time - bound) over
    it. A shape already in ``memo`` (checked and timed for an earlier
    path) is taken from there. Returns the sums and each kernel's largest
    error."""
    totals = collections.defaultdict(lambda: [0, 0.0, 0.0])
    errs = collections.defaultdict(float)

    def add(name, n, shape, timing):
        if (name, shape) not in memo:
            memo[(name, shape)] = timing()
        t = memo[(name, shape)]
        errs[name] = max(errs[name], t["err"])
        tot = totals[name]
        tot[0] += n
        tot[1] += n * t["ms"]
        tot[2] += n * t["bound_ms"]

    for nb, n in sorted(k5_blocks.items()):
        log("per %s: sha256_witness nb=%d x %d" % (label, nb, n))
        add("sha256_witness", n, nb, lambda: time_k5(rng, nb))
    for shape, n in sorted(k6_shapes.items()):
        if shape[0] in PTREE_NAMES:  # the classic-Poseidon tree entries
            name = PTREE_NAMES[shape[0]]
            log("per %s: %s %s x %d" % (label, name, shape[1:], n))
            add(name, n, shape, lambda: time_ptree(rng, shape))
            continue
        log("per %s: poseidon_sponge %s x %d" % (label, shape, n))
        add("poseidon_sponge", n, shape, lambda: time_k6(rng, shape))
    for shape, n in sorted(k1_shapes.items()):
        r, m, inverse, twmode, width = shape

        def k1():
            t = time_ntt_stage(rng, r, m, inverse, twmode, width or 256)
            log("ntt_stage (R=%d, M=%d, inverse=%d, twmode=%d, W=%d): "
                "bit-equal, %.4f ms, bound %.4f ms (%s), %.1f%% of bound"
                % (r, m, inverse, twmode, width, t["ms"], t["bound_ms"],
                   t["bound_by"], 100 * t["bound_ms"] / t["ms"]))
            return t
        log("per %s: ntt_stage %s x %d" % (label, shape, n))
        add("ntt_stage", n, shape, k1)
    for shape, n in sorted(p2_shapes.items()):
        def p2():
            if shape[0] == "permute":
                x = rand_field(rng, (12, shape[1]))
            elif shape[0] == "leaf":
                x = rand_field(rng, shape[1:])
            else:
                x = rand_field(rng, (4, shape[1]))
            return time_p2(shape, x)
        log("per %s: %s x %d" % (label, shape, n))
        add(P2_NAMES[shape[0]], n, shape, p2)
    for key, n in sorted(byte_shapes.items()):
        algo, shape = key[0], key[1:]
        name = "%s_%s" % (algo, "leaf_hashes" if shape[0] == "leaf"
                          else "node_layers")
        log("per %s: %s %s x %d" % (label, name, shape[1:], n))
        add(name, n, key, lambda: time_byte(rng, algo, shape))
    out = {k: dict(launches=v[0], sum_ms=round(v[1], 4),
                   bound_ms=round(v[2], 4), lost_ms=round(v[1] - v[2], 4))
           for k, v in totals.items()}
    log("per %s, by kernel (launches, sum of launches x time, of "
        "launches x bound, and of launches x (time - bound)): %s"
        % (label, json.dumps(out)))
    return out, errs


def check_p2_node_launches(p2_shapes, what):
    """A single-device Poseidon2-tree prove's node launches (``p2_shapes``:
    its `pallas_poseidon2.SHAPES`): all through `poseidon2_node_layers`
    (none a layer), at most MAX_NODE_LAUNCHES; logged."""
    nodes = sorted((sh[1:], n) for sh, n in p2_shapes.items()
                   if sh[0] == "nodes")
    layer = sum(n for sh, n in p2_shapes.items() if sh[0] == "node")
    total = sum(n for _, n in nodes)
    log("%s prove: %d poseidon2_node_layers launches (at most %d), %d "
        "poseidon2_node_layer: %s" % (what, total, MAX_NODE_LAUNCHES, layer,
                                      json.dumps(nodes)))
    if total > MAX_NODE_LAUNCHES or layer:
        raise AssertionError("a %s prove made %d poseidon2_node_layers "
                             "launches (at most %d) and %d "
                             "poseidon2_node_layer launches (none)"
                             % (what, total, MAX_NODE_LAUNCHES, layer))


def count_syncs(fn):
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") and return its
    synchronizing calls, as a Counter of the innermost line of the port (or
    of this script) that made each, and fn's result."""
    import traceback
    import warnings
    import torch

    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = "?"
        for fr in reversed(traceback.extract_stack()[:-1]):
            if "boojum_tpu_torch" in fr.filename or \
                    fr.filename.endswith("chip_smoke.py"):
                site = "%s:%d" % (os.path.relpath(fr.filename, ROOT),
                                  fr.lineno)
                break
        sites[site] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites, out


def host_witness_calls():
    """The calls of the host witness path (`materialize_witness_columns`)
    so far; the first call starts counting them."""
    from boojum_tpu_torch.prover import device_prover
    if not hasattr(device_prover.materialize_witness_columns, "calls"):
        materialize = device_prover.materialize_witness_columns

        def counted(*args, **kwargs):
            counted.calls += 1
            return materialize(*args, **kwargs)

        counted.calls = 0
        device_prover.materialize_witness_columns = counted
    return device_prover.materialize_witness_columns.calls


def stage_profiles(prover, ref):
    """Where each transcript mode's prove spends its time, stage by stage,
    from one process: PROFILE_ROUNDS synced proves a mode, alternated (the
    order flipped every round), give each stage's host wall clock (the mean;
    the device syncs at every stage end); then one prove a mode with its
    torch ops counted (`op_counted_prove`) gives each stage's ops, about one
    kernel launch each. Every proof must be the reference's. Prints one JSON
    line a mode and returns them. (`scripts/torch_profile_flagship.py`
    gives a prove's kernels, device time and idle share under
    `torch.profiler`.)"""
    modes = {"device": {}, "host": dict(device_transcript=False)}
    walls = {m: collections.defaultdict(list) for m in modes}
    for i in range(PROFILE_ROUNDS):
        for mode in (("device", "host") if i % 2 == 0 else ("host", "device")):
            proof = prover.prove(ref["transcript"], ref["hasher"],
                                 on_stage=lambda label: None, **modes[mode])
            if proof_digest(proof) != ref["proof_json_sha256"]:
                raise AssertionError("the %s-transcript proof differs from "
                                     "the reference" % mode)
            for label, t in prover.last_stage_times.items():
                walls[mode][label].append(t)
    out = {}
    for mode, kw in modes.items():
        proof, ops = op_counted_prove(lambda on_stage: prover.prove(
            ref["transcript"], ref["hasher"], on_stage=on_stage, **kw))
        if proof_digest(proof) != ref["proof_json_sha256"]:
            raise AssertionError("the op-counted %s-transcript proof differs "
                                 "from the reference" % mode)
        rows = {}
        for label, n in ops.items():
            ts = walls[mode][label]
            rows[label] = dict(torch_ops=n,
                               wall_s=round(sum(ts) / len(ts), 4),
                               counted_wall_s=round(
                                   prover.last_stage_times[label], 4))
        out[mode] = rows
        QUOTIENT_STAGE["flagship, %s transcript" % mode] = (
            rows["quotient sweep"]["torch_ops"],
            rows["quotient sweep"]["wall_s"])
        log("flagship stage profile, %s transcript (wall: mean of %d synced "
            "proves, alternated; torch ops: one counted prove): %s"
            % (mode, PROFILE_ROUNDS, json.dumps(rows)))
    for mode in modes:
        log("flagship synced proves, %s transcript: total wall %.4f s a "
            "prove (mean), %d torch ops (counted)" % (
                mode, sum(r["wall_s"] for r in out[mode].values()),
                sum(r["torch_ops"] for r in out[mode].values())))
    return out


def flagship():
    """Synthesis, setup, one cold prove and WARM_ROUNDS warm proves in each
    transcript mode on the card (the default prove: device witness program
    and device transcript). Returns
    the launch counts of the path and one prove's launches by shape."""
    import numpy as np
    import torch
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.gadgets.sha256 import build_sha256_circuit
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.hash import poseidon
    from boojum_tpu_torch.ntt import mxu_ntt
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)

    host_witness = host_witness_calls()
    ref = load_digest("flagship_proof_digest.json")
    data = bytes(np.random.default_rng(ref["seed"]).integers(
        0, 256, ref["input_len"], dtype=np.uint8))
    t0 = time.time()
    cs, _ = build_sha256_circuit(data, max_trace_len=ref["max_trace_len"])
    cs.pad_and_shrink()
    t_synth = time.time() - t0
    log("flagship synthesis %.2f s, domain %d" % (t_synth, cs.final_trace_len))

    reset_counts()  # counts of the main path only
    t0 = time.time()
    sb = create_base_setup(cs)
    t_base = time.time() - t0
    cfg = ProofConfig(**ref["config"])
    t0 = time.time()
    art = create_device_setup(cs, sb, cfg, ref["hasher"], device="cuda")
    prover = DeviceProver(cs, art, cfg, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.time() - t0
    log("flagship create_base_setup %.2f s, create_device_setup %.2f s"
        % (t_base, t_setup))

    def prove(**kw):
        t = time.time()
        proof = prover.prove(ref["transcript"], ref["hasher"], **kw)
        torch.cuda.synchronize()
        return proof, time.time() - t

    torch.cuda.reset_peak_memory_stats()
    proof, t_cold = prove()
    # warm proves of the two transcript modes, alternated in one process
    # (the first of each pair flips every round): the default (device
    # transcript) and device_transcript=False (host transcript)
    warm = {"device": [], "host": []}
    last = {}  # the launches of the last default prove, by kernel and shape

    def warm_device():
        before = read_counts()
        shapes = (mxu_ntt.SHAPES.copy(), pp.SHAPES.copy(),
                  poseidon.SHAPES.copy())
        last["proof"], t = prove()
        warm["device"].append(t)
        after = read_counts()
        last["per_prove"] = {k: after[k] - before[k] for k in after}
        last["shapes"] = [c - b for c, b in zip(
            (mxu_ntt.SHAPES, pp.SHAPES, poseidon.SHAPES), shapes)]
        check_p2_node_launches(last["shapes"][1], "flagship warm (device "
                               "transcript)")

    def warm_host():
        before = pp.SHAPES.copy()
        host_proof, t = prove(device_transcript=False)
        warm["host"].append(t)
        check_p2_node_launches(pp.SHAPES - before, "flagship warm (host "
                               "transcript)")
        if proof_digest(host_proof) != ref["proof_json_sha256"]:
            raise AssertionError("the host-transcript proof differs from "
                                 "the reference")

    for i in range(WARM_ROUNDS):
        for fn in ((warm_device, warm_host) if i % 2 == 0
                   else (warm_host, warm_device)):
            fn()
    proof, per_prove = last["proof"], last["per_prove"]
    k1_shapes, p2_shapes, k6_shapes = last["shapes"]
    counts = read_counts()
    # message blocks of the padded input (a 1 bit and the 64-bit length)
    k5_blocks = collections.Counter({(ref["input_len"] + 9 + 63) // 64:
                                     per_prove["sha256_witness"]})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("flagship prove cold %.3f s, peak device memory %.2f GB"
        % (t_cold, peak_gb))
    for mode, ts in warm.items():
        log("flagship warm proves, %s transcript (alternated): %s s, mean "
            "%.4f s" % (mode, ", ".join("%.4f" % t for t in ts),
                        sum(ts) / len(ts)))
    log("flagship launches (setup + %d proves): %s; per default prove: %s"
        % (1 + 2 * WARM_ROUNDS, json.dumps(counts), json.dumps(per_prove)))
    for name in ("ntt_stage", "poseidon2_leaf_hashes", "poseidon2_node_layers",
                 "sha256_witness", "poseidon_sponge"):
        if counts[name] <= 0:
            raise AssertionError("%s never launched on the main path" % name)
    if counts["poseidon2_node_layer"]:
        raise AssertionError("the main path launched poseidon2_node_layer "
                             "(a tree's node layers take node_layers)")
    check_stage_launches(counts, "flagship", 1 + 2 * WARM_ROUNDS)
    if per_prove["sha256_witness"] != 1 or per_prove["poseidon_sponge"] < 2:
        raise AssertionError("the default prove should launch sha256_witness "
                             "once and poseidon_sponge more than once, got %d "
                             "and %d" % (per_prove["sha256_witness"],
                                         per_prove["poseidon_sponge"]))
    host_witness = host_witness_calls() - host_witness
    if host_witness:
        raise AssertionError("the default prove called "
                             "materialize_witness_columns %d times"
                             % host_witness)
    log("flagship default prove: device witness program (sha256_witness %d "
        "launch a prove, materialize_witness_columns never called) and "
        "device transcript (poseidon_sponge %d launches a prove: %s)"
        % (per_prove["sha256_witness"], per_prove["poseidon_sponge"],
           json.dumps({"%s" % (k,): v for k, v in sorted(k6_shapes.items())})))

    digest = proof_digest(proof)
    log("flagship proof_to_json: sha256 %s (reference %s)"
        % (digest, ref["proof_json_sha256"]))
    if digest != ref["proof_json_sha256"]:
        raise AssertionError("flagship proof differs from the reference")

    stage_profiles(prover, ref)
    for mode, kw in (("device", {}), ("host", dict(device_transcript=False))):
        sites, (_, t) = count_syncs(lambda: prove(**kw))
        log("flagship synchronizing calls, one warm prove with the %s "
            "transcript: %d (%.3f s); by source line: %s" % (
                mode, sum(sites.values()), t,
                json.dumps(dict(sites.most_common()))))
        if sum(sites.values()) > MAX_SYNCS[mode]:
            raise AssertionError(
                "a warm prove with the %s transcript made %d synchronizing "
                "calls, more than %d" % (mode, sum(sites.values()),
                                         MAX_SYNCS[mode]))
    ctx = dict(cs=cs, sb=sb, ref=ref, proof=proof, vk=art.vk)
    return counts, k1_shapes, p2_shapes, k5_blocks, k6_shapes, ctx


def poseidon_tree_flagship(ctx):
    """The flagship circuit (the circuit and base setup of `flagship`) with
    classic-Poseidon trees: the Poseidon transcript (the device one, by
    default on the card), tree hasher "poseidon" (`poseidon_leaf_hashes`,
    `poseidon_node_layers`), LDE 8, cap 16, security 100, no PoW. Its
    device setup, one cold and PTREE_WARM_PROVES warm proves, each held to
    `flagship_poseidon_proof_digest.json` and with its synchronizing calls
    counted (a warm prove at most MAX_SYNCS["device"]) and its Poseidon
    node launches (at most MAX_NODE_LAUNCHES), then one prove with its
    torch ops counted by stage; peak device memory. Every prove must take
    the device witness program and launch the tree entries, `ntt_stage`,
    `sha256_witness` and `poseidon_sponge`, and neither a Poseidon2 tree
    entry nor a plain version. Returns the counts of the path, the launches
    by shape of its setup and of its last warm prove, and its VK and
    proof."""
    import torch
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)

    name = "poseidon-tree flagship"
    ref = load_digest("flagship_poseidon_proof_digest.json")
    base = ctx["ref"]
    if [ref[k] for k in ("seed", "input_len", "max_trace_len", "config")] != \
            [base[k] for k in ("seed", "input_len", "max_trace_len",
                               "config")] or \
            (ref["transcript"], ref["hasher"]) != ("poseidon", "poseidon"):
        raise AssertionError("the poseidon-tree digest file is for another "
                             "circuit or configuration")
    sha = ref["proof_json_sha256"]
    cfg = ProofConfig(**ref["config"])
    host_witness = host_witness_calls()
    reset_counts()  # counts of this path only
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    art, setup_shapes = launch_shapes(lambda: create_device_setup(
        ctx["cs"], ctx["sb"], cfg, "poseidon", device="cuda"))
    prover = DeviceProver(ctx["cs"], art, cfg, device="cuda")
    torch.cuda.synchronize()
    log("%s: create_device_setup %.2f s" % (name, time.time() - t0))

    def prove():
        t = time.time()
        proof = prover.prove("poseidon", "poseidon")
        torch.cuda.synchronize()
        return proof, time.time() - t

    times, shapes = [], None
    for i in range(1 + PTREE_WARM_PROVES):
        (sites, (proof, t)), shapes = launch_shapes(
            lambda: count_syncs(prove))
        times.append(t)
        syncs = sum(sites.values())
        log("%s %s prove: %.4f s, proof_to_json sha256 %s (reference %s); "
            "synchronizing calls %d, by source line: %s"
            % (name, "warm" if i else "cold", t, proof_digest(proof), sha,
               syncs, json.dumps(dict(sites.most_common()))))
        if proof_digest(proof) != sha:
            raise AssertionError("a %s proof differs from the reference"
                                 % name)
        if i > 0 and syncs > MAX_SYNCS["device"]:
            raise AssertionError("a warm %s prove made %d synchronizing "
                                 "calls, more than %d"
                                 % (name, syncs, MAX_SYNCS["device"]))
        nodes = sum(n for sh, n in shapes[2].items()
                    if sh[0] in ("node", "nodes"))
        log("%s %s prove: %d Poseidon node launches (at most %d): %s"
            % (name, "warm" if i else "cold", nodes, MAX_NODE_LAUNCHES,
               json.dumps(sorted((sh, n) for sh, n in shapes[2].items()
                                 if sh[0] in ("node", "nodes")))))
        if nodes > MAX_NODE_LAUNCHES:
            raise AssertionError("a %s prove made %d Poseidon node "
                                 "launches, more than %d"
                                 % (name, nodes, MAX_NODE_LAUNCHES))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counted, rows = op_counted_prove(lambda on_stage: prover.prove(
        "poseidon", "poseidon", on_stage=on_stage))
    if proof_digest(counted) != sha:
        raise AssertionError("the op-counted %s proof differs" % name)
    ops = log_stage_ops(name, rows, prover.last_stage_times)
    counts = read_counts()
    host_witness = host_witness_calls() - host_witness
    k1, _, k6 = shapes
    tree = {e: sum(n for sh, n in k6.items() if sh[0] == e)
            for e in PTREE_NAMES}
    log("%s: cold prove %.4f s, warm %s s; peak device memory %.2f GB; %d "
        "torch ops a prove; a warm prove's launches: %d "
        "poseidon_leaf_hashes %s, %d poseidon_node_layers, %d ntt_stage, %d "
        "poseidon_sponge; launches (setup + %d proves): %s"
        % (name, times[0], ", ".join("%.4f" % t for t in times[1:]),
           peak_gb, ops, tree["leaf"], json.dumps(sorted(
               (sh[1:], n) for sh, n in k6.items() if sh[0] == "leaf")),
           tree["nodes"], sum(k1.values()),
           sum(n for sh, n in k6.items() if sh[0] not in PTREE_NAMES),
           2 + PTREE_WARM_PROVES, json.dumps(counts)))
    for kernel in ("ntt_stage", "poseidon_leaf_hashes", "poseidon_node_layers",
                   "sha256_witness", "poseidon_sponge"):
        if counts[kernel] <= 0:
            raise AssertionError("%s never launched on the %s path"
                                 % (kernel, name))
    if counts["poseidon2_leaf_hashes"] or counts["poseidon2_node_layer"] or \
            counts["poseidon2_node_layers"]:
        raise AssertionError("the %s path hashed with Poseidon2 trees" % name)
    check_stage_launches(counts, name, 2 + PTREE_WARM_PROVES)
    if host_witness:
        raise AssertionError("the %s prove called materialize_witness_"
                             "columns %d times" % (name, host_witness))
    return counts, dict(setup=setup_shapes, prove=shapes), (art.vk, proof)


def nccl_world():
    """An NCCL process group of one rank in this process, bound to cuda:0:
    its store a FileStore in a fresh temporary directory (no network).
    Returns that directory, to be removed with the group."""
    import tempfile
    import torch
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    try:
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
    except TypeError:  # a torch without device_id
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    return tmp


def sharded_flagship(ctx):
    """The flagship proved sharded (`parallel/`): the circuit, base setup and
    configuration of `flagship`, `create_device_setup(..., mesh=)` and
    `DeviceProver(..., mesh=make_mesh())` over an NCCL group of one rank
    made in this process (every collective called, at world size 1), one
    cold and SHARDED_WARM_PROVES warm proves. The setup's cap must be the
    single-device setup's, every proof's digest the flagship's
    (`flagship_proof_digest.json`), a warm prove's synchronizing calls at
    most MAX_SYNCS["host"] (the sharded prove takes the host transcript, as
    the reference's mesh path does); it prints the collectives of a prove by
    kind and the launches of each kernel, and no plain version may run.
    The group is destroyed at the end, so later phases run without it.
    Returns the counts of the path and the VK and last proof."""
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    from boojum_tpu_torch.parallel import make_mesh, sharding
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)

    name = "sharded flagship"
    ref = ctx["ref"]
    sha = ref["proof_json_sha256"]
    cfg = ProofConfig(**ref["config"])
    from boojum_tpu_torch.prover.device_merkle import build_device_tree
    # a classic-Poseidon tree of 2^19 leaves: the single-device layers
    # first, outside the path's counts
    ptree_cols = rand_field(np.random.default_rng(19), (8, 1 << 19))
    ptree_want = build_device_tree(ptree_cols, 16, "poseidon").layers
    store_dir = nccl_world()
    try:
        mesh = make_mesh()
        log("%s: NCCL group of %d rank(s), device %s, backend %s"
            % (name, mesh.size, mesh.device, dist.get_backend()))
        reset_counts()  # counts of this path only
        sharding.COLLECTIVES.clear()
        t0 = time.time()
        art = create_device_setup(ctx["cs"], ctx["sb"], cfg, ref["hasher"],
                                  mesh=mesh)
        prover = DeviceProver(ctx["cs"], art, cfg, mesh=mesh)
        torch.cuda.synchronize()
        log("%s: create_device_setup %.2f s, %s collectives %s"
            % (name, time.time() - t0, mesh.device,
               json.dumps(dict(sharding.COLLECTIVES))))
        if art.vk.setup_merkle_tree_cap != ctx["vk"].setup_merkle_tree_cap:
            raise AssertionError("the sharded setup's cap differs from the "
                                 "single-device setup's")

        def prove():
            t = time.time()
            proof = prover.prove(ref["transcript"], ref["hasher"])
            torch.cuda.synchronize()
            return proof, time.time() - t

        times = []
        for i in range(1 + SHARDED_WARM_PROVES):
            before = read_counts()
            colls = sharding.COLLECTIVES.copy()
            sites, (proof, t) = count_syncs(prove)
            after = read_counts()
            times.append(t)
            syncs = sum(sites.values())
            log("%s %s prove: %.4f s, proof_to_json sha256 %s (reference "
                "%s); synchronizing calls %d, by source line: %s; "
                "collectives by kind: %s; launches: %s"
                % (name, "warm" if i else "cold", t, proof_digest(proof), sha,
                   syncs, json.dumps(dict(sites.most_common())),
                   json.dumps(dict(sharding.COLLECTIVES - colls)),
                   json.dumps({k: after[k] - before[k] for k in after
                               if after[k] - before[k]})))
            if proof_digest(proof) != sha:
                raise AssertionError("a %s proof differs from the reference"
                                     % name)
            if i > 0 and syncs > MAX_SYNCS["host"]:
                raise AssertionError("a warm %s prove made %d synchronizing "
                                     "calls, more than %d"
                                     % (name, syncs, MAX_SYNCS["host"]))
        # the stage split and each stage's torch ops
        counted, rows = op_counted_prove(lambda on_stage: prover.prove(
            ref["transcript"], ref["hasher"], on_stage=on_stage))
        if proof_digest(counted) != sha:
            raise AssertionError("the op-counted %s proof differs" % name)
        log_stage_ops(name, rows, prover.last_stage_times)
        before = read_counts()["poseidon_node_layer"]
        ptree = sharding.build_sharded_tree(mesh, ptree_cols, 16, "poseidon")
        launched = read_counts()["poseidon_node_layer"] - before
        if len(ptree.layers) != len(ptree_want) or not all(
                torch.equal(a, b) for a, b in zip(ptree.layers, ptree_want)):
            raise AssertionError("the sharded classic-Poseidon tree differs "
                                 "from the single-device one")
        log("%s: a sharded classic-Poseidon tree of 2^19 leaves, cap 16: "
            "its %d layers equal the single-device tree's; %d "
            "poseidon_node_layer launches" % (name, len(ptree.layers),
                                              launched))
        counts = read_counts()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    log("%s: cold prove %.4f s, warm %s s; launches (setup + %d proves): "
        "ntt_stage %d, ntt_small %d, poseidon2_leaf_hashes %d, "
        "poseidon2_node_layer %d; all: %s"
        % (name, times[0], ", ".join("%.4f" % t for t in times[1:]),
           1 + SHARDED_WARM_PROVES, counts["ntt_stage"], counts["ntt_small"],
           counts["poseidon2_leaf_hashes"], counts["poseidon2_node_layer"],
           json.dumps(counts)))
    for kernel in ("ntt_stage", "poseidon2_leaf_hashes",
                   "poseidon2_node_layer", "poseidon_node_layer"):
        if counts[kernel] <= 0:
            raise AssertionError("%s never launched on the %s path"
                                 % (kernel, name))
    check_stage_launches(counts, name, 0, sharded=2 + SHARDED_WARM_PROVES)
    return counts, (art.vk, proof)


def host_prove_path():
    """The port's host `prove` (host numpy stages; LDEs, NTTs and trees on
    the card): `create_setup_and_vk` and one prove of the recursion
    configuration's inner circuit, held to its digest in
    `recursion_outer_proof_digest.json`, timed, with its kernel launches.
    No plain version may run. (The flagship's host prove takes over a
    minute: `scripts/torch_profile_flagship.py --prover host` times it.)
    Returns the counts and the (VK, proof, transcript, hasher) of the
    proof."""
    import numpy as np
    import torch
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.gadgets.recursion.circuits import \
        build_inner_circuit
    from boojum_tpu_torch.prover import (ProofConfig, create_setup_and_vk,
                                         prove)

    rec = load_digest("recursion_outer_proof_digest.json")["inner"]
    inner = build_inner_circuit(np.random.default_rng(rec["seed"]))
    cases = [("recursion inner", inner, create_base_setup(inner), rec)]
    reset_counts()  # counts of this path only
    proofs = {}
    for label, cs, sb, ref in cases:
        before = read_counts()
        cfg = ProofConfig(**ref["config"])
        t0 = time.time()
        art = create_setup_and_vk(cs, sb, cfg, ref["hasher"], device="cuda")
        torch.cuda.synchronize()
        t_setup = time.time() - t0
        t0 = time.time()
        proof = prove(cs, art, cfg, ref["transcript"], ref["hasher"],
                      device="cuda")
        torch.cuda.synchronize()
        t = time.time() - t0
        after = read_counts()
        log("host prove, %s (domain %d): create_setup_and_vk %.2f s, prove "
            "%.3f s, proof_to_json sha256 %s (reference %s); launches: %s"
            % (label, sb.domain_size, t_setup, t, proof_digest(proof),
               ref["proof_json_sha256"],
               json.dumps({k: after[k] - before[k] for k in after
                           if after[k] - before[k]})))
        if proof_digest(proof) != ref["proof_json_sha256"]:
            raise AssertionError("the host prove of the %s differs from the "
                                 "reference" % label)
        proofs["host prove " + label] = (art.vk, proof, ref["transcript"],
                                         ref["hasher"])
    counts = read_counts()
    for kernel in ("poseidon2_leaf_hashes", "poseidon2_node_layers"):
        if counts[kernel] <= 0:
            raise AssertionError("%s never launched on the host prove path"
                                 % kernel)
    check_stage_launches(counts, "host prove", 0)
    return counts, proofs


def byte_flagship(ctx, kind, warm):
    """The reference's non-recursive configuration on the flagship circuit
    (the circuit and base setup of `flagship`): the ``kind`` transcript
    (blake2s or keccak256) on the host and ``kind`` trees on K8 / K9, LDE 8,
    cap 16, security 100, no PoW. Setup, one cold prove and ``warm`` warm
    proves, each proof's digest against the reference's; one prove with its
    torch ops counted by stage (its stages end in syncs: the stage split);
    with warm proves the synchronizing calls of one more (at most the host
    transcript's 12: a byte transcript runs on the host). Returns the
    counts of the path, the byte-hash launches of its last prove by shape,
    and its proof and VK."""
    import torch
    from boojum_tpu_torch.hash import device_bytes_hash as dbh
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)

    ref = load_digest("flagship_%s_proof_digest.json" % kind)
    base = ctx["ref"]
    if [ref[k] for k in ("seed", "input_len", "max_trace_len")] != \
            [base[k] for k in ("seed", "input_len", "max_trace_len")] or \
            (ref["transcript"], ref["hasher"]) != (kind, kind):
        raise AssertionError("%s digest file is for another circuit or "
                             "configuration" % kind)
    cfg = ProofConfig(**ref["config"])
    reset_counts()  # counts of this path only
    t0 = time.time()
    art = create_device_setup(ctx["cs"], ctx["sb"], cfg, kind, device="cuda")
    prover = DeviceProver(ctx["cs"], art, cfg, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.time() - t0

    def prove(**kw):
        t = time.time()
        proof = prover.prove(kind, kind, **kw)
        torch.cuda.synchronize()
        return proof, time.time() - t

    def check(proof, what):
        digest = proof_digest(proof)
        if digest != ref["proof_json_sha256"]:
            raise AssertionError("the %s %s proof differs from the reference "
                                 "(sha256 %s)" % (kind, what, digest))
        return digest

    def check_node_launches(shapes, what):
        n = sum(c for key, c in shapes.items() if key[1] == "nodes")
        log("%s %s prove: %d %s_node_layers launches (at most %d): %s" % (
            kind, what, n, kind, MAX_NODE_LAUNCHES, json.dumps(sorted(
                (key[2:], c) for key, c in shapes.items()
                if key[1] == "nodes"))))
        if n > MAX_NODE_LAUNCHES:
            raise AssertionError("a %s %s prove launched %s_node_layers %d "
                                 "times, more than %d" % (
                                     kind, what, kind, n, MAX_NODE_LAUNCHES))

    before = dbh.SHAPES.copy()
    proof, t_cold = prove()
    shapes = dbh.SHAPES - before
    digest = check(proof, "cold")
    check_node_launches(shapes, "cold")
    times = []
    for _ in range(warm):
        before = dbh.SHAPES.copy()
        proof, t = prove()
        shapes = dbh.SHAPES - before
        check(proof, "warm")
        check_node_launches(shapes, "warm")
        times.append(t)
    counts = read_counts()
    log("%s flagship: create_device_setup %.2f s, prove cold %.3f s%s; "
        "proof_to_json sha256 %s (reference %s)" % (
            kind, t_setup, t_cold, "".join(
                ", warm %.4f s" % t for t in times), digest,
            ref["proof_json_sha256"]))
    log("%s flagship launches (setup + %d proves): %s" % (
        kind, 1 + warm, json.dumps(counts)))
    leaf, node = "%s_leaf_hashes" % kind, "%s_node_layers" % kind
    for name in ("ntt_stage", "sha256_witness", leaf, node):
        if counts[name] <= 0:
            raise AssertionError("%s never launched on the %s path"
                                 % (name, kind))
    check_stage_launches(counts, "%s flagship" % kind, 1 + warm)
    if counts["poseidon2_leaf_hashes"] or counts["poseidon_sponge"] or \
            counts["poseidon_leaf_hashes"]:
        raise AssertionError("the %s configuration hashed with Poseidon2 "
                             "or Poseidon trees or the Poseidon sponge" % kind)
    # the stage split and each stage's torch ops from one synced prove
    staged, rows = op_counted_prove(lambda on_stage: prover.prove(
        kind, kind, on_stage=on_stage))
    check(staged, "op-counted")
    log_stage_ops("%s flagship" % kind, rows, prover.last_stage_times)
    if warm:
        sites, (synced, t) = count_syncs(lambda: prove())
        check(synced, "sync-counted")
        log("%s flagship synchronizing calls, one warm prove: %d (%.3f s); "
            "by source line: %s" % (kind, sum(sites.values()), t,
                                    json.dumps(dict(sites.most_common()))))
        if sum(sites.values()) > MAX_SYNCS["host"]:
            raise AssertionError("a warm %s prove made %d synchronizing "
                                 "calls, more than %d" % (
                                     kind, sum(sites.values()),
                                     MAX_SYNCS["host"]))
    return counts, shapes, proof, art.vk


def load_digest(name):
    with open(os.path.join(ROOT, "boojum_tpu_torch", "data", name)) as f:
        return json.load(f)


def proof_digest(proof):
    from boojum_tpu_torch.prover.proof import proof_to_json
    return hashlib.sha256(proof_to_json(proof).encode()).hexdigest()


def launch_shapes(fn):
    """Runs ``fn()`` (a setup or a prove) and returns its result and the
    launches it made of K1, K2 and K6, by shape."""
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    from boojum_tpu_torch.hash import poseidon
    from boojum_tpu_torch.ntt import mxu_ntt
    mods = (mxu_ntt, pp, poseidon)
    before = [m.SHAPES.copy() for m in mods]
    out = fn()
    return out, [m.SHAPES - b for m, b in zip(mods, before)]


def timed_proves(name, prover, ref, sha, count):
    """``count`` proves in turn by ``prover`` with the default device
    transcript, each timed (to the closing synchronize) and held to the
    digest ``sha``. Returns the last proof, the times and the last prove's
    launches by shape."""
    import torch

    def prove():
        t = time.time()
        proof = prover.prove(ref["transcript"], ref["hasher"])
        torch.cuda.synchronize()
        t = time.time() - t
        if proof_digest(proof) != sha:
            raise AssertionError("a %s proof differs from the reference "
                                 "(sha256 %s)" % (name, proof_digest(proof)))
        return proof, t

    times, shapes = [], None
    for _ in range(count):
        (proof, t), shapes = launch_shapes(prove)
        times.append(t)
    log("%s: %d proves in turn, %s s; each proof_to_json sha256 %s (the "
        "reference's)" % (name, count, ", ".join("%.4f" % t for t in times),
                          sha))
    return proof, times, shapes


def op_counted_prove(prove):
    """Runs ``prove(on_stage)`` with every torch op it dispatches counted,
    stage by stage through the prove's ``on_stage`` hook (a
    `TorchDispatchMode`: on the card each op is about one kernel launch;
    the hand kernels, launched through ctypes, are not in it). Far cheaper
    than `torch.profiler` on a prove of a million launches. Returns the
    proof and, by stage, the ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    rows, last = {}, [0]
    mode = Count()

    def on_stage(label):
        rows[label] = mode.ops - last[0]
        last[0] = mode.ops

    with mode:
        proof = prove(on_stage)
    return proof, rows


def log_stage_ops(name, rows, walls):
    """Prints an op-counted prove's torch ops and wall clock by stage
    (``walls``: the prover's `last_stage_times`, a synced prove); returns
    its op count."""
    rows = {label: dict(torch_ops=n, wall_s=round(walls[label], 4))
            for label, n in rows.items()}
    if "quotient sweep" in rows:
        QUOTIENT_STAGE[name] = (rows["quotient sweep"]["torch_ops"],
                                rows["quotient sweep"]["wall_s"])
    ops = sum(r["torch_ops"] for r in rows.values())
    log("%s prove, by stage (torch ops dispatched, synced wall): %s; %d "
        "torch ops, %.4f s" % (name, json.dumps(rows), ops,
                               sum(r["wall_s"] for r in rows.values())))
    return ops


def circuit_path(name, cs, ref, warm):
    """The path of one circuit at full size (`keccak_circuit` and each
    variant of `lookup_heavy`), with the launch counts set to 0 before it
    and read after it: base setup and device setup of the synthesized
    ``cs``, one cold and ``warm`` warm proves with the default device
    transcript, each timed, held to the digest of ``ref`` and with its
    synchronizing calls counted (a warm prove at most MAX_SYNCS["device"]),
    then one prove with its torch ops counted by stage (its stages end in
    syncs, so it also gives the stage split, with the counting's own cost
    in each stage's wall); peak device memory. Every prove must take the device
    witness program (`materialize_witness_columns` never called) and launch
    `ntt_stage`, the Poseidon2 leaf and node-layers entries and
    `poseidon_sponge`,
    and no plain version. Returns the counts of the path, the launches by
    shape of its setup and of its last warm prove, and its VK and proof."""
    import torch
    from boojum_tpu_torch.cs.setup import create_base_setup
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         create_device_setup)

    sha = ref["proof_json_sha256"]
    host_witness = host_witness_calls()
    reset_counts()  # counts of this path only
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sb = create_base_setup(cs)
    t_base = time.time() - t0
    cfg = ProofConfig(**ref["config"])
    t0 = time.time()
    art, setup_shapes = launch_shapes(lambda: create_device_setup(
        cs, sb, cfg, ref["hasher"], device="cuda"))
    prover = DeviceProver(cs, art, cfg, device="cuda")
    torch.cuda.synchronize()
    log("%s: domain %d, create_base_setup %.2f s, create_device_setup %.2f s"
        % (name, cs.final_trace_len, t_base, time.time() - t0))

    def prove():
        t = time.time()
        proof = prover.prove(ref["transcript"], ref["hasher"])
        torch.cuda.synchronize()
        return proof, time.time() - t

    times, shapes = [], None
    for i in range(1 + warm):
        (sites, (proof, t)), shapes = launch_shapes(
            lambda: count_syncs(prove))
        times.append(t)
        syncs = sum(sites.values())
        log("%s %s prove: %.4f s, proof_to_json sha256 %s; synchronizing "
            "calls %d, by source line: %s"
            % (name, "warm" if i else "cold", t, proof_digest(proof), syncs,
               json.dumps(dict(sites.most_common()))))
        check_p2_node_launches(shapes[1], "%s %s" % (
            name, "warm" if i else "cold"))
        if proof_digest(proof) != sha:
            raise AssertionError("a %s proof differs from the reference "
                                 "(sha256 %s)" % (name, sha))
        if i > 0 and syncs > MAX_SYNCS["device"]:
            raise AssertionError("a warm %s prove made %d synchronizing "
                                 "calls, more than %d"
                                 % (name, syncs, MAX_SYNCS["device"]))
    counted, rows = op_counted_prove(lambda on_stage: prover.prove(
        ref["transcript"], ref["hasher"], on_stage=on_stage))
    if proof_digest(counted) != sha:
        raise AssertionError("the op-counted %s proof differs" % name)
    log_stage_ops(name, rows, prover.last_stage_times)
    counts = read_counts()
    host_witness = host_witness_calls() - host_witness
    log("%s: cold prove %.4f s, warm %s s; peak device memory %.2f GB; "
        "host witness calls %d; launches (setup + %d proves): %s"
        % (name, times[0], ", ".join("%.4f" % t for t in times[1:]),
           torch.cuda.max_memory_allocated() / 1e9, host_witness, 2 + warm,
           json.dumps(counts)))
    for kernel in ("ntt_stage", "poseidon2_leaf_hashes",
                   "poseidon2_node_layers", "poseidon_sponge"):
        if counts[kernel] <= 0:
            raise AssertionError("%s never launched on the %s path"
                                 % (kernel, name))
    check_stage_launches(counts, name, 2 + warm)
    if host_witness:
        raise AssertionError("the %s prove called materialize_witness_"
                             "columns %d times" % (name, host_witness))
    return counts, dict(setup=setup_shapes, prove=shapes), (art.vk, proof)


def keccak_circuit():
    """BASELINE config 3: the 1 kB Keccak-256 circuit (domain 2^16, the
    flagship's geometry), Poseidon transcript, Poseidon2 trees, LDE 8, cap
    16: synthesis, then `circuit_path` with KECCAK_WARM_PROVES warm proves,
    held to `keccak256_1kB_proof_digest.json`."""
    import numpy as np
    from boojum_tpu_torch.gadgets.keccak256 import build_keccak256_circuit

    ref = load_digest("keccak256_1kB_proof_digest.json")
    data = bytes(np.random.default_rng(ref["seed"]).integers(
        0, 256, ref["input_len"], dtype=np.uint8))
    t0 = time.time()
    cs, _ = build_keccak256_circuit(data, ref["max_trace_len"])
    cs.pad_and_shrink()
    log("keccak256 circuit (%d bytes): synthesis %.2f s" % (
        ref["input_len"], time.time() - t0))
    if cs.final_trace_len != ref["domain"]:
        raise AssertionError("the keccak256 circuit has %d rows, the "
                             "reference %d" % (cs.final_trace_len,
                                               ref["domain"]))
    return circuit_path("keccak256 circuit", cs, ref, KECCAK_WARM_PROVES)


def recursion_outer():
    """BASELINE config 2: the inner proof of the 2^5-row circuit (LDE 8, cap
    8, security 100) made on the card and held to its digest (then once
    more with its torch ops counted by stage), the outer
    circuit that verifies it (132 copy columns, degree 8, flattened Poseidon
    and Poseidon2 gates) synthesized and checked, its setup, then a cold
    prove with its torch ops counted by stage and a warm prove timed, each
    held to the outer digest of
    `recursion_outer_proof_digest.json`; and the outer circuit over the
    inner proof with one value at z bumped must be unsatisfied. Both circuits take the host witness path,
    as in the reference. Returns the counts of the path, the launches by
    shape of each setup, of the inner prove and of one outer prove, and the
    inner and outer proofs and VKs."""
    import copy
    import numpy as np
    import torch
    from boojum_tpu_torch.gadgets.recursion.circuits import (
        build_inner_circuit, build_outer_circuit)
    from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                         prepare_setup_and_vk)

    ref = load_digest("recursion_outer_proof_digest.json")
    iref, oref = ref["inner"], ref["outer"]
    icfg, ocfg = ProofConfig(**iref["config"]), ProofConfig(**oref["config"])
    host_witness = host_witness_calls()
    reset_counts()  # counts of this path only
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    inner = build_inner_circuit(np.random.default_rng(iref["seed"]))
    iart, inner_setup = launch_shapes(lambda: prepare_setup_and_vk(
        inner, icfg, iref["hasher"], device="cuda"))
    iprover = DeviceProver(inner, iart, icfg, device="cuda")
    torch.cuda.synchronize()
    t_isetup = time.time() - t0
    inner_proof, _, inner_shapes = timed_proves(
        "recursion inner (domain %d, cold)" % inner.final_trace_len, iprover,
        iref, iref["proof_json_sha256"], 1)
    counted, rows = op_counted_prove(lambda on_stage: iprover.prove(
        iref["transcript"], iref["hasher"], on_stage=on_stage))
    if proof_digest(counted) != iref["proof_json_sha256"]:
        raise AssertionError("the op-counted inner proof differs")
    log_stage_ops("recursion inner", rows, iprover.last_stage_times)

    t0 = time.time()
    outer = build_outer_circuit(iart.vk, inner_proof, icfg, iref["transcript"],
                                iref["hasher"], oref["max_trace_len"])
    t_synth = time.time() - t0
    t0 = time.time()
    if not outer.check_if_satisfied():
        raise AssertionError("the outer circuit is not satisfied")
    t_check = time.time() - t0
    g = outer.geometry
    log("recursion outer: inner synthesis and setup %.2f s; outer synthesis "
        "%.2f s, check_if_satisfied %.2f s; outer domain %d, %d copy "
        "columns, degree %d" % (
            t_isetup, t_synth, t_check, outer.final_trace_len,
            g.num_columns_under_copy_permutation,
            g.max_allowed_constraint_degree))
    if (outer.final_trace_len, g.num_columns_under_copy_permutation) != \
            (oref["domain"], 132):
        raise AssertionError("the outer circuit is not the reference's shape")
    t0 = time.time()
    oart, outer_setup = launch_shapes(lambda: prepare_setup_and_vk(
        outer, ocfg, oref["hasher"], device="cuda"))
    oprover = DeviceProver(outer, oart, ocfg, device="cuda")
    torch.cuda.synchronize()
    log("recursion outer: setup (base + device) %.2f s, quotient degree %d"
        % (time.time() - t0, oart.setup_base.quotient_degree))

    sha = oref["proof_json_sha256"]

    def counted(what):
        (proof, rows), shapes = launch_shapes(lambda: op_counted_prove(
            lambda on_stage: oprover.prove(oref["transcript"], oref["hasher"],
                                           on_stage=on_stage)))
        if proof_digest(proof) != sha:
            raise AssertionError("the %s outer proof differs from the "
                                 "reference (sha256 %s)"
                                 % (what, proof_digest(proof)))
        return log_stage_ops("recursion outer %s" % what, rows,
                             oprover.last_stage_times), shapes

    cold_ops, cold_shapes = counted("cold")
    check_p2_node_launches(cold_shapes[1], "recursion outer cold")
    outer_proof, times, shapes = timed_proves("recursion outer (warm)",
                                              oprover, oref, sha, 1)
    log("recursion outer: torch ops of the cold prove %d; warm prove %.4f s; "
        "peak device memory %.2f GB" % (
            cold_ops, times[0], torch.cuda.max_memory_allocated() / 1e9))

    bad = copy.deepcopy(inner_proof)
    v = list(bad.values_at_z[2])
    v[0] = (v[0] + 1) % ((1 << 64) - (1 << 32) + 1)
    bad.values_at_z[2] = tuple(v)
    bad_outer = build_outer_circuit(iart.vk, bad, icfg, iref["transcript"],
                                    iref["hasher"], oref["max_trace_len"])
    if bad_outer.check_if_satisfied(verbose=False):
        raise AssertionError("the outer circuit over a corrupted inner proof "
                             "is satisfied")
    log("recursion outer: over the inner proof with values_at_z[2] bumped, "
        "the outer circuit is unsatisfied")

    counts = read_counts()
    log("recursion path launches (setups + %d proves): %s; host witness "
        "path calls %d" % (4, json.dumps(counts),
                           host_witness_calls() - host_witness))
    for name in ("poseidon2_leaf_hashes", "poseidon2_node_layers",
                 "poseidon_sponge"):
        if counts[name] <= 0:
            raise AssertionError("%s never launched on the recursion path"
                                 % name)
    for what, sh in (("recursion inner", inner_shapes),
                     ("recursion outer", shapes)):
        check_p2_node_launches(sh[1], what)
    check_stage_launches(counts, "recursion", 4)
    return counts, {"inner setup": inner_setup, "inner prove": inner_shapes,
                    "outer setup": outer_setup, "outer prove": shapes}, dict(
        inner=(iart.vk, inner_proof), outer=(oart.vk, outer_proof))


def lookup_heavy():
    """BASELINE config 4, the lookup-heavy circuit (`scripts/bench_suite.py`
    `bench_lookup_heavy`): 1,047,552 binop lookups at width 3 on 32 copy
    columns and a 2^17-row domain (an LDE of 2^20 rows), Poseidon
    transcript, Poseidon2 trees, LDE 8, cap 16, built by
    `gadgets.lookup_heavy.build_lookup_heavy_circuit` in each of the
    LOOKUP_VARIANTS: the specialized lookups (8 repetitions, a shared
    constant table id) and the general-purpose ones (the lookup marker's
    rows, 10 subarguments a row). Each variant: synthesis, then
    `circuit_path` with its number of warm proves, held to its digest.
    Returns `circuit_path`'s result by variant."""
    import torch
    from boojum_tpu_torch.gadgets.lookup_heavy import \
        build_lookup_heavy_circuit

    out = {}
    for variant, digest_file, warm in LOOKUP_VARIANTS:
        name = "lookup heavy %s" % variant
        ref = load_digest(digest_file)
        t0 = time.time()
        cs = build_lookup_heavy_circuit(ref["n_lookups"], ref["seed"], variant)
        lp = cs.lookup_parameters
        subargs = lp.num_sublookup_arguments_for_geometry(cs.geometry)
        log("%s (%d lookups, %s, %d subarguments): synthesis %.2f s"
            % (name, ref["n_lookups"], lp.mode, subargs, time.time() - t0))
        if (cs.final_trace_len, subargs) != (ref["domain"],
                                             ref["subarguments"]):
            raise AssertionError("the %s circuit has %d rows and %d "
                                 "subarguments, the reference %d and %d"
                                 % (name, cs.final_trace_len, subargs,
                                    ref["domain"], ref["subarguments"]))
        out[variant] = circuit_path(name, cs, ref, warm)
        del cs
        torch.cuda.empty_cache()
    return out


def _verify_one(job):
    """One verification of `verify_in_background`, in a spawned worker: the
    port's `verify` on a proof (a pickled copy), with one witness leaf
    element flipped if ``flip``. Returns whether it accepted, its seconds,
    the failure it reports, and the worker's kernel launches."""
    (vk, proof, kind, hasher), flip = job
    from boojum_tpu_torch.verifier import verifier
    if flip:
        proof.queries_per_fri_repetition[0].witness_query.leaf_elements[0] ^= 1
    reset_counts()
    t = time.time()
    ok = verifier.verify(vk, proof, kind, hasher)
    return ok, time.time() - t, verifier.last_failure(), read_counts()


@contextlib.contextmanager
def verify_in_background(proofs, flips=("blake2s", "poseidon trees"),
                         workers=4):
    """The port's `verify` (host code on Python ints) on each proof, and on
    the ``flips`` proofs with one witness leaf element flipped, which it
    must reject, in a pool of ``workers`` spawned processes that start at
    once, so that the card's phases run meanwhile. Yields a function that
    waits for them, logs each (timed in its worker), fails if a proof is
    rejected, a flipped one accepted or a worker launched a kernel, and
    returns the seconds by proof. The pool is shut down on leaving."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(workers,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        jobs = [(name, False) for name in proofs]
        jobs += [(name, True) for name in flips]
        futures = [pool.submit(_verify_one, (proofs[name], flip))
                   for name, flip in jobs]

        def results():
            secs = {}
            for (name, flip), fut in zip(jobs, futures):
                ok, sec, failure, counts = fut.result()
                kind, hasher = proofs[name][2:]
                if any(counts.values()):
                    raise AssertionError("verify launched kernels: %s"
                                         % json.dumps(counts))
                if flip:
                    if ok is not False:
                        raise AssertionError(
                            "the port's verify accepted the %s proof with a "
                            "flipped leaf element" % name)
                    log("verify: the %s proof with a flipped witness leaf "
                        "element is rejected (%s)" % (name, failure))
                    continue
                secs[name] = round(sec, 3)
                log("verify %s proof (%s transcript, %s trees): %s in %.3f "
                    "s%s" % (name, kind, hasher, ok, secs[name],
                             "" if ok else " (%s)" % failure))
                if not ok:
                    raise AssertionError("the port's verify rejected the %s "
                                         "proof" % name)
            return secs
        yield results
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def permute_path(rng):
    """The batch permutation entry point on 2^20 random states, against its
    plain version. No path of the port calls `permutation_stacked_fast` (the
    trees use the leaf and node entries); this phase is made up so that the
    `poseidon2_permute` entry still launches once."""
    import torch
    from boojum_tpu_torch.hash import pallas_poseidon2 as pp
    st = rand_field(rng, (12, 1 << 20))
    reset_counts()  # counts of this path only
    out = pp.permutation_stacked_fast(st)
    torch.cuda.synchronize()
    counts = read_counts()
    log("permute path (12, 2^20): launches %s" % json.dumps(counts))
    if counts["poseidon2_permute"] != 1 or counts["plain_on_cuda"]:
        raise AssertionError("the permute path should launch "
                             "poseidon2_permute once and no plain version")
    require_equal(out, pp.permutation_plain(st), "permute path output")
    return counts


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 1
    from boojum_tpu_torch.utils import cuda_build

    kernels_only = "--kernels-only" in sys.argv[1:]
    card = card_line()  # name, power.limit as nvidia-smi prints them
    log(card)
    t_start = t0 = time.time()
    cuda_build.build_all(verbose=True)
    log("build: %.1f s (%s)" % (time.time() - t0, ", ".join(cuda_build.KERNELS)))
    from boojum_tpu_torch.utils import native
    log("host field arithmetic (utils/npgl.py): %s" % (
        "the native witness engine (g++, boojum_tpu_torch/_build/)"
        if native.available() else "numpy (no native witness engine)"))
    sass = sass_report()
    p2_sass()
    ptree_sass()
    byte_sass()

    def phase(name):
        log("phase %s done at %.1f s" % (name, time.time() - t_start))

    rng = np.random.default_rng(7)
    phase("build and SASS")
    k1_err = check_ntt_stage(rng)
    k1 = time_ntt_stage(rng, 256, 1 << 17, False, 1, 256, plain=True)
    log("ntt_stage (256, 2^17) twmode 1: %.4f ms kernel, %.3f ms plain, "
        "bound %.4f ms (%s), %.1f%% of bound"
        % (k1["ms"], k1["plain_ms"], k1["bound_ms"], k1["bound_by"],
           100 * k1["bound_ms"] / k1["ms"]))
    p2 = check_poseidon2(rng)
    phase("ntt_stage and poseidon2 checks")
    k4_err, k4 = check_ntt_small(rng)
    phase("ntt_small checks")
    k5_err, k5 = check_sha256_witness(rng)
    k6_err = check_poseidon_sponge(rng)
    phase("sha256_witness and poseidon_sponge checks")
    ptree_checks = check_poseidon_tree(rng)
    phase("poseidon tree checks")
    byte_checks = check_bytes_hash(rng)
    st23_err, _ = check_stage23_kernels(rng)
    quot_err, quot_made_up = check_quotient_kernels(rng)
    phase("kernel checks")
    if kernels_only:
        log("chip_smoke: --kernels-only, stopping after the kernel checks")
        return 0

    counts, k1_shapes, p2_shapes, k5_blocks, k6_shapes, ctx = flagship()
    phase("poseidon flagship")
    sh_counts, (sh_vk, sh_proof) = sharded_flagship(ctx)
    phase("sharded flagship")
    pt_counts, pt_shapes, (pt_vk, pt_proof) = poseidon_tree_flagship(ctx)
    phase("poseidon-tree flagship")
    b2s_counts, b2s_shapes, b2s_proof, b2s_vk = byte_flagship(
        ctx, "blake2s", BYTE_WARM_PROVES)
    phase("blake2s flagship")
    kec_counts, kec_shapes, kec_proof, kec_vk = byte_flagship(
        ctx, "keccak256", 0)
    phase("keccak256 flagship")
    kcc_counts, kcc_shapes, (kcc_vk, kcc_proof) = keccak_circuit()
    phase("keccak256 circuit")
    rec_counts, rec_shapes, rec_proofs = recursion_outer()
    phase("recursion outer")
    lookups = lookup_heavy()
    phase("lookup heavy")
    host_counts, host_proofs = host_prove_path()
    phase("host prove")
    # the verifications run in spawned processes while the card's last
    # phases run
    with verify_in_background({
        "poseidon": (ctx["vk"], ctx["proof"], ctx["ref"]["transcript"],
                     ctx["ref"]["hasher"]),
        "poseidon trees": (pt_vk, pt_proof, "poseidon", "poseidon"),
        "sharded flagship": (sh_vk, sh_proof, ctx["ref"]["transcript"],
                             ctx["ref"]["hasher"]),
        **host_proofs,
        "blake2s": (b2s_vk, b2s_proof, "blake2s", "blake2s"),
        "keccak256": (kec_vk, kec_proof, "keccak256", "keccak256"),
        "keccak256 circuit": (kcc_vk, kcc_proof, "poseidon", "poseidon2"),
        "recursion inner": (*rec_proofs["inner"], "poseidon", "poseidon2"),
        "recursion outer": (*rec_proofs["outer"], "poseidon", "poseidon2"),
        **{"lookup heavy " + v: (*lk[2], "poseidon", "poseidon2")
           for v, lk in lookups.items()}}) as verified:
        memo = {}
        costs, prove_errs = per_prove_costs(
            rng, "flagship prove", k1_shapes, p2_shapes, k5_blocks, k6_shapes,
            b2s_shapes + kec_shapes, memo)
        path_costs = {"flagship prove": costs}
        new_paths = [("poseidon-tree flagship " + k, v)
                     for k, v in pt_shapes.items()]
        new_paths += [("keccak256 circuit " + k, v)
                      for k, v in kcc_shapes.items()]
        new_paths += [("recursion " + k, v) for k, v in rec_shapes.items()]
        new_paths += [("lookup heavy %s %s" % (variant, k), v)
                      for variant, lk in lookups.items()
                      for k, v in lk[1].items()]
        for label, shapes in new_paths:
            path_costs[label], errs = per_prove_costs(
                rng, label, *shapes[:2], {}, shapes[2], {}, memo)
            for name, err in errs.items():
                prove_errs[name] = max(prove_errs[name], err)
        st23_prove_err, st23_prove = check_stage23_prove_shapes(rng)
        quot_prove_err, quot_prove = check_quotient_prove_shapes(rng)
        # K6's row: the prove's largest absorb (the values at z)
        k6 = time_k6(rng, max(s for s in k6_shapes if s[0] == "absorb"),
                     plain=True)
        phase("per-prove kernel costs")
        ntt_counts = ntt_path(k4)
        perm_counts = permute_path(rng)
        phase("ntt and permute paths")
        verify_secs = verified()
        phase("verify")

    def row(name, source, replaces, launches, err, t):
        # launches: the kernel's main paths, the flagship's or its own, and
        # the poseidon-tree flagship's, the keccak256 circuit's, the
        # recursion configuration's and the lookup-heavy circuit's two
        # variants'
        launches += pt_counts[name] + kcc_counts[name] + rec_counts[name] \
            + sum(lk[0][name] for lk in lookups.values()) \
            + sh_counts[name] + host_counts[name]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=None)

    p2_src = "boojum_tpu_torch/csrc/poseidon2.cu"
    kernels = [
        row("ntt_stage", "boojum_tpu_torch/csrc/ntt_stage.cu",
            "boojum_tpu/ntt/mxu_ntt.py:339", counts["ntt_stage"],
            max(k1_err, k1["err"], prove_errs["ntt_stage"]), k1),
        row("poseidon2_permute", p2_src, P2_REPLACES,
            perm_counts["poseidon2_permute"], *p2["poseidon2_permute"]),
        row("ntt_small", "boojum_tpu_torch/csrc/ntt_small.cu",
            "boojum_tpu/ntt/pallas_ntt.py:52", ntt_counts["ntt_small"],
            k4_err, k4[(9, 1 << 18, "twiddle")]),
        row("poseidon2_leaf_hashes", p2_src, P2_REPLACES,
            counts["poseidon2_leaf_hashes"],
            max(p2["poseidon2_leaf_hashes"][0],
                prove_errs["poseidon2_leaf_hashes"]),
            p2["poseidon2_leaf_hashes"][1]),
        row("poseidon2_node_layers", p2_src, P2_REPLACES,
            counts["poseidon2_node_layers"],
            max(p2["poseidon2_node_layers"][0],
                prove_errs["poseidon2_node_layers"]),
            p2["poseidon2_node_layers"][1]),
        row("poseidon2_node_layer", p2_src, P2_REPLACES,
            counts["poseidon2_node_layer"],
            max(p2["poseidon2_node_layer"][0],
                prove_errs["poseidon2_node_layer"]),
            p2["poseidon2_node_layer"][1]),
        row("sha256_witness", "boojum_tpu_torch/csrc/sha256_witness.cu",
            K5_REPLACES, counts["sha256_witness"],
            max(k5_err, prove_errs["sha256_witness"]), k5),
        row("poseidon_sponge", "boojum_tpu_torch/csrc/poseidon.cu",
            K6_REPLACES, counts["poseidon_sponge"],
            max(k6_err, k6["err"], prove_errs["poseidon_sponge"]), k6),
    ]
    for entry, name in PTREE_NAMES.items():
        err, t = ptree_checks[name]
        kernels.append(row(name, "boojum_tpu_torch/csrc/poseidon.cu",
                           PTREE_REPLACES[entry], 0,
                           max(err, prove_errs[name]), t))
    for algo, path_counts in (("blake2s", b2s_counts),
                              ("keccak256", kec_counts)):
        for entry, name in (("leaf", "%s_leaf_hashes" % algo),
                            ("node", "%s_node_layers" % algo)):
            err, t = byte_checks[name]
            kernels.append(row(name, BYTE_SOURCES[algo],
                               BYTE_REPLACES[(algo, entry)],
                               path_counts[name],
                               max(err, prove_errs[name]), t))
    # stages 2+3: the flagship circuit's key (the most launched: the
    # flagship, Poseidon-tree and byte flagships prove that circuit)
    st23_launches, st23_t = max(st23_prove.values(), key=lambda v: v[0])
    for name in ("stage23_rows", "stage23_scan"):
        kernels.append(row(name, STAGE23_SOURCE, STAGE23_REPLACES,
                           counts[name] + b2s_counts[name] + kec_counts[name],
                           max(st23_err, st23_prove_err), st23_t[name]))
    # the quotient sweep: the flagship circuit's key (the most launched)
    quot_launches, quot_t = max(quot_prove.values(), key=lambda v: v[0])
    kernels.append(row("quotient_sweep", QUOTIENT_SOURCE, QUOTIENT_REPLACES,
                       counts["quotient_sweep"] + b2s_counts["quotient_sweep"]
                       + kec_counts["quotient_sweep"],
                       max(quot_err, quot_prove_err), quot_t))
    log("quotient sweep stage by configuration (torch ops, wall s of an "
        "op-counted prove): " + json.dumps(QUOTIENT_STAGE))
    for label, most in MAX_QUOTIENT_OPS.items():
        if QUOTIENT_STAGE[label][0] > most:
            raise AssertionError("the %s prove's quotient sweep took %d "
                                 "torch ops, more than %d" % (
                                     label, QUOTIENT_STAGE[label][0], most))
    log("verify seconds per proof: " + json.dumps(verify_secs))
    log("summary: " + json.dumps(dict(per_prove=path_costs, sass={
        k: {f: v[f] for f in ("total", "integer", "imad", "integer_per_pass",
                              "integer_per_element") if f in v}
        for k, v in sass.items()}, byte_sass={
            "%s/%s" % k: v for k, v in BYTE_SASS.items()},
        poseidon2_sass=P2_SASS, poseidon_tree_sass=PTREE_SASS)))
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
