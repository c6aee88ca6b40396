"""GPU-only checks of the port: a whole small proof, and the standalone NTT
entry point, on the card against the same calls on the CPU, and each entry
of the redesigned kernels bit-equal to its plain version on the card
(`ntt_stage` at every template instance and a ragged width; `ntt_small` at
every template instance, with and without its cross twiddle; the four
Poseidon2 entries at the trees' shapes, the node-layers entry against the
plain per-layer chain across the two-launch split; the SHA-256 witness chain at 1 and 3
blocks; the Poseidon sponge's absorb and permute; the classic-Poseidon
tree entries at the block-boundary widths and on a strided view, and its
node-layers entry against the plain per-layer chain across the two-launch
split; the Blake2s and
Keccak-256 leaf entries at the block-boundary widths and the flagship's
widest leaf, and their node-layers entries against the plain per-layer
chain), the device witness program of a small SHA-256
circuit on the card against the CPU, a small Blake2s and Keccak-256
proof on the card against the CPU, the two kernels of stages 2+3
against their plain version at the flagship's shape (with zero rows), the
quotient sweep against its plain version at made-up layouts, and the
flagship proved on the card to its reference digest. It
skips
without a GPU. This file
imports no JAX, so on the GPU machine (which has none) it runs without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from boojum_tpu_torch.cs import (ConstraintSystem, CSConfig, CSGeometry,
                                 LookupParameters, LookupTable)
from boojum_tpu_torch.cs.gates import (ConstantsAllocatorGate, FmaGate,
                                       NopGate, PublicInputGate, ReductionGate)
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.gadgets import sha256_witness as sw
from boojum_tpu_torch.gadgets.sha256 import INITIAL_STATE, build_sha256_circuit
from boojum_tpu_torch.hash import device_bytes_hash as dbh
from boojum_tpu_torch.hash import pallas_poseidon2 as pp
from boojum_tpu_torch.hash import poseidon
from boojum_tpu_torch.ntt import mxu_ntt, ntt, pallas_ntt
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover.device_witness import DeviceWitnessProgram
from boojum_tpu_torch.prover.proof import proof_to_json

P = gl.ORDER
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _small_circuit():
    geom = CSGeometry(num_columns_under_copy_permutation=16,
                      num_witness_columns=0, num_constant_columns=4,
                      max_allowed_constraint_degree=4)
    cs = ConstraintSystem(geom, 1 << 10, CSConfig.dev())
    cs.allow_lookup(LookupParameters.specialized_with_table_id_as_constant(
        width=3, num_repetitions=2, share_table_id=True))
    cs.allow_gate(ConstantsAllocatorGate)
    cs.allow_gate(FmaGate)
    cs.allow_gate(ReductionGate, params=4)
    cs.allow_gate(PublicInputGate)
    cs.allow_gate(NopGate)
    rows = [(a, b, a ^ b) for a in range(8) for b in range(8)]
    tid = cs.add_lookup_table(LookupTable("xor3", np.asarray(rows, np.uint64),
                                          num_keys=2))
    rng = np.random.default_rng(5)
    a, b, c = (cs.alloc_variables_with_values(rng.integers(0, P, 20, dtype=np.uint64))
               for _ in range(3))
    d = FmaGate.compute_fma_batch(cs, 3, (a, b), 5, c)
    ReductionGate.reduce_terms_batch(cs, [1, 2, 3, 4],
                                     np.stack([a[:8], b[:8], c[:8], d[:8]]))
    la = cs.alloc_variables_with_values([1, 2, 3, 7])
    lb = cs.alloc_variables_with_values([6, 2, 1, 7])
    lo = cs.alloc_variables_with_values([1 ^ 6, 0, 3 ^ 1, 0])
    cs.enforce_lookup_batch(tid, np.stack([la, lb, lo]))
    PublicInputGate.place(cs, int(d[0]))
    cs.pad_and_shrink()
    return cs


def test_small_proof_on_gpu_equals_cpu(cuda):
    cs = _small_circuit()
    sb = create_base_setup(cs)
    cfg = ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4)
    proofs = []
    for device in ("cpu", cuda):
        art = create_device_setup(cs, sb, cfg, "poseidon2", device=device)
        proofs.append(proof_to_json(DeviceProver(cs, art, cfg, device=device)
                                    .prove("poseidon", "poseidon2")))
    assert proofs[0] == proofs[1]


@pytest.mark.parametrize("kind", ["blake2s", "keccak256"])
def test_small_byte_proof_on_gpu_equals_cpu(cuda, kind):
    """The byte transcript on the host, the byte trees on kernel K8 / K9."""
    cs = _small_circuit()
    sb = create_base_setup(cs)
    cfg = ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4)
    proofs = []
    for device in ("cpu", cuda):
        art = create_device_setup(cs, sb, cfg, kind, device=device)
        proofs.append(proof_to_json(DeviceProver(cs, art, cfg, device=device)
                                    .prove(kind, kind)))
    assert proofs[0] == proofs[1]


def test_ntt_any_on_gpu_equals_cpu(cuda):
    x = np.random.default_rng(6).integers(0, P, (1 << 14, 3), dtype=np.uint64)
    got = pallas_ntt.ntt_any(gl.from_u64(x, cuda), 14)
    want = pallas_ntt.ntt_any(gl.from_u64(x), 14)
    assert np.array_equal(gl.to_u64(got), gl.to_u64(want))
    with pytest.raises(ValueError):  # beyond the kernel's shared memory
        pallas_ntt.ntt_small(gl.from_u64(np.zeros((1 << 13, 1)), cuda), 13)


def _rand(cuda, seed, shape):
    return gl.from_u64(np.random.default_rng(seed).integers(
        0, P, shape, dtype=np.uint64), cuda)


@pytest.mark.parametrize("r", [128, 256])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("twmode", [0, 1, 2])
def test_ntt_stage_instances_equal_plain(cuda, r, inverse, twmode):
    x = _rand(cuda, r + twmode, (r, 1 << 14))
    tw = None
    if twmode:
        tw = gl.from_u64(ntt.fourstep_twiddles_host(r.bit_length() - 1, 8,
                                                    inverse), cuda)
    kw = dict(inverse=inverse, tw=tw, tw_pre=twmode == 2)
    assert torch.equal(mxu_ntt.ntt_cols_matmul(x, **kw),
                       mxu_ntt.ntt_stage_plain(x, **kw))


@pytest.mark.parametrize("m", [1000, 1001])
def test_ntt_stage_ragged_equals_plain(cuda, m):
    for r in (128, 256):
        for inverse in (False, True):
            x = _rand(cuda, m + r, (r, m))
            assert torch.equal(mxu_ntt.ntt_cols_matmul(x, inverse=inverse),
                               mxu_ntt.ntt_stage_plain(x, inverse=inverse))


@pytest.mark.parametrize("log_n", range(13))
@pytest.mark.parametrize("mode", ["forward", "twiddle", "inverse"])
def test_ntt_small_instances_equal_plain(cuda, log_n, mode):
    n = 1 << log_n
    for b in (1001, 2050):  # the 8-byte and the 16-byte path
        x = _rand(cuda, n + b, (n, b))
        shift = 1 if b % 2 == 0 else 0
        kw = {}
        if mode == "twiddle":
            kw = dict(tw=_rand(cuda, n + b + 1, (n, b >> shift)),
                      tw_shift=shift)
        inverse = mode == "inverse"
        assert torch.equal(pallas_ntt.ntt_small(x, log_n, inverse, **kw),
                           pallas_ntt.ntt_small_plain(x, log_n, inverse, **kw))


@pytest.mark.parametrize("b", [1, 127, 1 << 16, 1 << 20])
def test_poseidon2_permute_equals_plain(cuda, b):
    st = _rand(cuda, b, (12, b))
    assert torch.equal(pp.permutation_stacked_fast(st),
                       pp.permutation_plain(st))


@pytest.mark.parametrize("k,m", [(64, 1 << 19), (8, 1 << 19), (13, 1 << 12)])
def test_poseidon2_leaf_hashes_equal_plain(cuda, k, m):
    cols = _rand(cuda, k, (k, m))
    assert torch.equal(pp.leaf_hashes(cols), pp.leaf_hashes_plain(cols))
    view = cols[:, :m // 2]  # a row stride wider than the leaf count
    assert torch.equal(pp.leaf_hashes(view), pp.leaf_hashes_plain(view))


@pytest.mark.parametrize("m", [1 << 19, 32])
def test_poseidon2_node_layer_equals_plain(cuda, m):
    cur = _rand(cuda, m, (4, m))
    assert torch.equal(pp.node_layer(cur), pp.node_layer_plain(cur))


@pytest.mark.parametrize("m,cap", [(2, 1), (1000, 1), (1 << 12, 16),
                                   (1 << 19, 16)])
def test_poseidon2_node_layers_equal_plain(cuda, m, cap):
    """A tree's node layers (one launch, two above 2^17 nodes; the narrow
    levels on 4 lanes a state) against the plain per-layer chain."""
    cur = _rand(cuda, m + cap, (4, m))
    before = pp.NODE_LAYERS_LAUNCHES
    got = pp.node_layers(cur, cap)
    want = pp.node_layers_plain(cur, cap)
    assert pp.NODE_LAYERS_LAUNCHES - before == len(
        dbh.node_launches(m, len(want)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k,m", [(1, 1000), (7, 4096), (9, 4096),
                                 (93, 1 << 16)])
def test_poseidon_leaf_hashes_equal_plain(cuda, k, m):
    cols = _rand(cuda, k, (k, m))
    assert torch.equal(poseidon.leaf_hashes(cols),
                       poseidon.leaf_hashes_plain(cols))
    view = cols[:, :m // 2]  # a row stride wider than the leaf count
    assert torch.equal(poseidon.leaf_hashes(view),
                       poseidon.leaf_hashes_plain(view))


@pytest.mark.parametrize("m", [2, 32, 1000, 1 << 18])
def test_poseidon_node_layer_equals_plain(cuda, m):
    cur = _rand(cuda, m, (4, m))
    assert torch.equal(poseidon.node_layer(cur), poseidon.node_layer_plain(cur))


@pytest.mark.parametrize("m,cap", [(2, 1), (1000, 1), (1 << 12, 16),
                                   (1 << 17, 1), (1 << 17, 16), (1 << 18, 1),
                                   (1 << 18, 16), (16, 16)])
def test_poseidon_node_layers_equal_plain(cuda, m, cap):
    """A tree's node layers against the plain per-layer chain, in the
    launches `node_launches` plans: one a tree up to `NODE_SPLIT` = 2^17
    nodes, two above it; 1000 stops at the odd width 125; 16 at cap 16 has
    none."""
    cur = _rand(cuda, m, (4, m))
    launches = poseidon.NODE_LAYERS_LAUNCHES
    got = poseidon.node_layers(cur, cap)
    assert poseidon.NODE_LAYERS_LAUNCHES - launches == \
        len(dbh.node_launches(m, len(got)))
    want = poseidon.node_layers_plain(cur, cap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("algo", ["blake2s", "keccak256"])
@pytest.mark.parametrize("k,m", [(1, 1000), (8, 4096), (16, 4096),
                                 (17, 4096), (34, 333), (93, 1 << 16)])
def test_byte_leaf_hashes_equal_plain(cuda, algo, k, m):
    """k = 8, 16: whole Blake2s blocks; k = 17, 34: the Keccak pad in a
    block of its own; 93: the flagship's witness leaf."""
    cols = _rand(cuda, k, (k, m))
    assert torch.equal(dbh.leaf_hashes(cols, algo),
                       dbh._PLAIN[algo][0](cols))
    view = cols[:, :m // 2]  # a row stride wider than the leaf count
    assert torch.equal(dbh.leaf_hashes(view, algo),
                       dbh._PLAIN[algo][0](view))


@pytest.mark.parametrize("algo", ["blake2s", "keccak256"])
@pytest.mark.parametrize("m,cap", [(2, 1), (32, 1), (1000, 1), (1 << 16, 16),
                                   (1 << 16, 1), (1 << 12, 4), (16, 16),
                                   (1 << 18, 16)])
def test_byte_node_layers_equal_plain(cuda, algo, m, cap):
    """The kernel's layers against the plain per-layer chain, in the
    launches `node_launches` plans: 1000 stops at the odd width 125, 16 at
    cap 16 has none, 2^18 takes two launches."""
    cur = gl.from_u64(np.random.default_rng(m).integers(
        0, 1 << 32, (8, m), dtype=np.uint64), cuda)
    launches = dbh.NODE_LAUNCHES[algo]
    got = dbh.node_layers(cur, algo, cap)
    assert dbh.NODE_LAUNCHES[algo] - launches == \
        len(dbh.node_launches(m, len(got)))
    want = dbh.node_layers_plain(cur, algo, cap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nb", [1, 3, 33, 129])
def test_sha256_witness_equals_plain(cuda, nb):
    """nb = 33 crosses the kernel's 32-block chunk; 129 is the flagship's."""
    blocks = torch.as_tensor(np.random.default_rng(nb).integers(
        0, 256, (nb, 64)), dtype=torch.int64).to(cuda)
    init = torch.tensor(INITIAL_STATE, dtype=torch.int64).to(cuda)
    assert torch.equal(sw.compress_chain(blocks, init),
                       sw.compress_chain_plain(blocks, init))


@pytest.mark.parametrize("k", [0, 1, 7, 8, 9, 17, 495])
def test_poseidon_sponge_equals_plain(cuda, k):
    """k = 495: the flagship's largest absorb (62 rate blocks)."""
    st = _rand(cuda, 100 + k, (12,))
    el = _rand(cuda, k, (k,))
    assert torch.equal(poseidon.sponge_absorb(st, el),
                       poseidon.sponge_absorb_plain(st, el))
    assert torch.equal(poseidon.sponge_permute(st),
                       poseidon.sponge_permute_plain(st))


def test_poseidon_sponge_edge_values_equal_plain(cuda):
    """A state of p - 1 and 2^64 - 1 (not canonical) and elements of
    2^64 - 1 and p: the kernel's lazy arithmetic takes any u64."""
    st = gl.from_u64(np.asarray([P - 1] * 6 + [(1 << 64) - 1] * 6,
                                np.uint64), cuda)
    el = gl.from_u64(np.asarray([(1 << 64) - 1, P] * 8, np.uint64), cuda)
    assert torch.equal(poseidon.sponge_absorb(st, el),
                       poseidon.sponge_absorb_plain(st, el))
    assert torch.equal(poseidon.sponge_permute(st),
                       poseidon.sponge_permute_plain(st))


def test_device_witness_on_gpu_equals_cpu(cuda):
    data = bytes(np.random.default_rng(3).integers(0, 256, 40, dtype=np.uint8))
    cs, _ = build_sha256_circuit(data)
    cs.pad_and_shrink()
    n = cs.final_trace_len
    got = DeviceWitnessProgram(cs, n, cuda)()
    want = DeviceWitnessProgram(cs, n, "cpu")()
    assert torch.equal(got.cpu(), want)


# the flagship's layout: 2^16 rows, 92 copy columns (the last 32 the 8
# width-4 lookups'), the multiplicity after them, 8 constants (the table
# id first) and 5 table columns
FLAGSHIP_STAGE23 = dict(n=1 << 16, num_var=92, qd=4, wit_cols=93,
                        setup_cols=105, lookup=dict(
                            width=4, pw=4, base_off=60, num_subargs=8,
                            tid_cols=(92,), table_off=100, num_table=5,
                            mult_col=92, sel=False))


@pytest.mark.parametrize("layout,device_scalars", [
    (FLAGSHIP_STAGE23, True),
    (FLAGSHIP_STAGE23, False),
    (dict(n=32, num_var=20, qd=8, wit_cols=21, setup_cols=28, lookup=dict(
        width=3, pw=4, base_off=0, num_subargs=4, tid_cols=(),
        table_off=24, num_table=4, mult_col=20, sel=True)), True),
    # the recursion outer circuit's
    (dict(n=4096, num_var=132, qd=16, wit_cols=132, setup_cols=142), True),
])
def test_stage23_equals_plain(cuda, layout, device_scalars):
    """Both kernels of stages 2+3 (`stage23_rows`, `stage23_scan`) against
    `stage23_plain` on the same inputs, one launch each, with a zero lookup
    aggregate, a zero table aggregate, a zero copy-permutation denominator
    and a row whose every inverse is zero among the rows
    (`stage23.random_inputs`)."""
    from boojum_tpu_torch.prover import stage23
    n, lk = layout["n"], layout.get("lookup")
    slots = -(-layout["num_var"] // layout["qd"]) + (
        lk["num_subargs"] + 1 if lk else 0)
    inputs = stage23.random_inputs(np.random.default_rng(15), **layout,
                                   zero_rows=(n // 3, n // 2, 2 * n // 3),
                                   zero_slots={5 * n // 6: range(slots)})
    args = stage23.args_on(inputs, cuda, device_scalars)
    before = stage23.LAUNCHES.copy()
    got = stage23.stage23(*args)
    launched = stage23.LAUNCHES - before
    assert launched == {"stage23_rows": 1, "stage23_scan": 1}
    assert torch.equal(got, stage23.stage23_plain(*args))
    assert not got[5 * n // 6].any()  # z is 0 past row 2n/3, A and B too


@pytest.mark.parametrize("name,rows,device_scalars", [
    ("no_lookup", 8, False),  # one partial block
    ("specialized_ids_per_rep", 1 << 12, True),
    ("specialized_shared_id", 1 << 12, False),
    ("general_with_sel", 1 << 12, True),
    ("poseidon_gates", 1 << 10, True),
    ("flagship_like", 1 << 16, True),
])
def test_quotient_sweep_equals_plain(cuda, name, rows, device_scalars):
    """`quotient_sweep` (`csrc/quotient.cu`) against `quotient_plain` on the
    same inputs at made-up layouts (`quotient.made_up_case`), one launch,
    with every input zero at one point and p - 1 at another."""
    from boojum_tpu_torch.prover import quotient
    q, kw, ks = quotient.made_up_case(name)
    inputs = quotient.random_inputs(np.random.default_rng(21), q, rows, kw,
                                    ks, lde=8)
    args = quotient.args_on(inputs, cuda, device_scalars)
    before = quotient.LAUNCHES.copy()
    got = quotient.quotient_sweep(*args)
    assert quotient.LAUNCHES - before == {"quotient_sweep": 1}
    assert torch.equal(got, quotient.quotient_plain(*args))


def test_flagship_proof_digest_on_gpu(cuda):
    """The flagship (the 8 kB SHA-256 circuit, 2^16 rows, LDE 8, cap 16)
    proved on the card, its quotient in one `quotient_sweep` launch, its
    `proof_to_json` digest the reference's
    (`boojum_tpu_torch/data/flagship_proof_digest.json`)."""
    import hashlib
    import json
    import os
    from boojum_tpu_torch.prover import quotient
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "boojum_tpu_torch", "data",
                           "flagship_proof_digest.json")) as f:
        ref = json.load(f)
    data = bytes(np.random.default_rng(ref["seed"]).integers(
        0, 256, ref["input_len"], dtype=np.uint8))
    cs, _ = build_sha256_circuit(data, max_trace_len=ref["max_trace_len"])
    cs.pad_and_shrink()
    cfg = ProofConfig(**ref["config"])
    art = create_device_setup(cs, create_base_setup(cs), cfg, ref["hasher"],
                              device=cuda)
    before = quotient.LAUNCHES.copy()
    proof = DeviceProver(cs, art, cfg, device=cuda).prove(ref["transcript"],
                                                          ref["hasher"])
    assert quotient.LAUNCHES - before == {"quotient_sweep": 1}
    assert hashlib.sha256(proof_to_json(proof).encode()).hexdigest() == \
        ref["proof_json_sha256"]
