"""The classic-Poseidon Merkle tree of the port (tree hasher "poseidon"):
the plain versions of its kernel entries (`poseidon.leaf_hashes_plain`,
`node_layer_plain`, `node_layers_plain`, the wrappers' CPU path) against
the JAX package's batched sponge (`boojum_tpu.hash.sponge.hash_leaves` /
`hash_nodes`), the port's device tree against the JAX host
`AlgebraicMerkleTree` (caps and paths), the sparse partial rounds'
constants (`poseidon_sparse`) against the JAX package's permutation, a
Python-int emulation of the Hopper kernels' (`csrc/poseidon.cu`
`permute_regs` in `leaf_kernel`, `node_kernel` and `nodes_kernel`) lazy
arithmetic in their operation order, range-checked at every step, and of
`csrc/byte_tree.cuh`'s schedule around the Poseidon node hash, against the
JAX permutation and the plain versions: the only check of those kernels
this CPU can run. Exact equality throughout.

The JAX sponge's batched permutation runs jitted here
(`tests/torch_small_circuit.use_jax_poseidon_perm`, the package's rolled
`poseidon._permutation_rolled_gl`); eagerly each call takes tens of
seconds."""

import pathlib

import numpy as np
import pytest
import torch

from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.hash import poseidon as ref_poseidon
from boojum_tpu.hash import sponge as ref_sponge
from boojum_tpu.hash.merkle import AlgebraicMerkleTree
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.hash import device_bytes_hash as dbh
from boojum_tpu_torch.hash import pallas_poseidon2, poseidon, poseidon_sparse
from boojum_tpu_torch.hash.merkle import \
    AlgebraicMerkleTree as PortMerkleTree
from boojum_tpu_torch.prover.device_merkle import build_any_device_tree
from tests.test_torch_bytes_hash import _cuda_int, _emulate_node_layers
from tests.test_torch_poseidon2_fused import (EPS, M64, M128, _sbox7,
                                              add_canon_lazy, canonicalize,
                                              reduce96, reduce128_lazy,
                                              times_eps)
from tests.torch_small_circuit import use_jax_poseidon_perm

P = gl.ORDER


@pytest.fixture(scope="module")
def jax_poseidon():
    with pytest.MonkeyPatch.context() as mp:
        use_jax_poseidon_perm(mp.setattr)
        yield


def _cols(seed, k, m):
    return np.random.default_rng(seed).integers(0, P, (k, m), dtype=np.uint64)


def _counts():
    return (poseidon.LAUNCHES, poseidon.LEAF_LAUNCHES, poseidon.NODE_LAUNCHES,
            poseidon.NODE_LAYERS_LAUNCHES, poseidon.PLAIN_CUDA_CALLS)


@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 93])
def test_plain_leaves_match_jax(jax_poseidon, k):
    """Leaves of k elements (a partial block, whole blocks, one more
    element, the flagship's witness width) at m = 64."""
    cols = _cols(k, k, 64)
    before = _counts()
    got = poseidon.leaf_hashes_plain(gl.from_u64(cols))
    assert torch.equal(poseidon.leaf_hashes(gl.from_u64(cols)), got)
    want = ref_sponge.hash_leaves(ref_gl.from_u64(cols), "poseidon")
    assert np.array_equal(gl.to_u64(got), ref_gl.to_u64(want))
    # on CPU tensors the wrappers run the plain versions and count nothing
    assert _counts() == before


def test_plain_nodes_match_jax(jax_poseidon):
    cur = _cols(5, 4, 1 << 10)
    got = poseidon.node_layer_plain(gl.from_u64(cur))
    assert got.shape == (4, 1 << 9)
    assert torch.equal(poseidon.node_layer(gl.from_u64(cur)), got)
    want = ref_sponge.hash_nodes(ref_gl.from_u64(cur[:, 0::2]),
                                 ref_gl.from_u64(cur[:, 1::2]), "poseidon")
    assert np.array_equal(gl.to_u64(got), ref_gl.to_u64(want))


@pytest.mark.parametrize("log_m,cap", [(10, 1), (11, 4), (12, 16)])
def test_tree_matches_jax(jax_poseidon, log_m, cap):
    """The port's tree of one-element leaves against the reference's host
    tree: the cap, and the leaf hash and path of a handful of leaves, each
    of which the port's verifier opens over the cap."""
    cols = _cols(log_m, 1, 1 << log_m)
    ref = AlgebraicMerkleTree.from_leaf_columns(ref_gl.from_u64(cols), cap,
                                                "poseidon")
    tree = build_any_device_tree(gl.from_u64(cols), cap, "poseidon")
    assert tree.get_cap() == ref.get_cap()
    assert len(tree.layers) - 1 == log_m - cap.bit_length() + 1
    for idx in (0, 1, 5, (1 << log_m) - 1, 1 << (log_m - 1)):
        leaf, path = tree.get_proof(idx)
        assert (leaf, path) == ref.get_proof(idx)
        assert PortMerkleTree.verify_proof_over_cap(path, tree.get_cap(), leaf,
                                                    idx, "poseidon")


# ---------------------------------------------------------------------------
# The sparse partial rounds (boojum_tpu_torch/hash/poseidon_sparse.py)
# ---------------------------------------------------------------------------

CSRC = pathlib.Path(poseidon.__file__).parents[1] / "csrc"


def _states(kind):
    """Test states: random canonical, 0, p - 1, and lazy u64 values (the
    kernels take any u64 and reduce it mod p)."""
    rng = np.random.default_rng(41)
    return {
        "random": [[int(v) for v in col] for col in _cols(42, 12, 3).T],
        "p_minus_1": [[P - 1] * 12],
        "u64_max": [[M64] * 12],
        "zeros": [[0] * 12],
        "lazy_random": [[int(v) for v in rng.integers(0, M64, 12,
                                                       dtype=np.uint64,
                                                       endpoint=True)]
                        for _ in range(3)],
    }[kind]


KINDS = ["random", "p_minus_1", "u64_max", "zeros", "lazy_random"]


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_constants_match_jax_permutation(kind):
    """The sparse form's constants applied in exact ints (A_0, each partial
    round's k, w and v, the residual in round 26's constants) give the JAX
    package's permutation."""
    for st in _states(kind):
        assert poseidon_sparse.s_permutation(st) == \
            ref_poseidon.s_permutation([v % P for v in st])


def _mat(a, b):
    return [[sum(x * y for x, y in zip(row, col)) % P for col in zip(*b)]
            for row in a]


def _eye(n):
    return [[int(i == j) for j in range(n)] for i in range(n)]


def test_sparse_constants_recomputed():
    """The kernel's table from the definitions: ``M_r = B_r A_r`` for every
    partial round, ``M_r = A_{r+1} M`` (``A_22 = I``), ``A_r = diag(1,
    N^(22 - r))``, ``B_r`` the identity but for row 0 ``(1, w_r)`` and
    column 0 ``v_r``; the constants pushed forward; the layout
    `csrc/poseidon.cu` reads."""
    c = poseidon_sparse.constants()
    m = poseidon_sparse.mds()
    n = [row[1:] for row in m[1:]]
    a_next, nr = _eye(12), n
    for r in reversed(range(22)):
        b = _eye(12)
        b[0][1:] = c["w_hat"][r]
        for i in range(11):
            b[1 + i][0] = c["v"][r][i]
        a = [[1] + [0] * 11] + [[0] + row for row in nr]
        assert _mat(b, a) == _mat(a_next, m)
        a_next, nr = a, _mat(nr, n)
    assert c["a0"] == [row[1:] for row in a_next[1:]]
    carry = [0] * 12
    rc = poseidon._RC
    for r in range(22):
        eff = [(x + y) % P for x, y in zip(rc[(4 + r) * 12:(5 + r) * 12],
                                           carry)]
        assert c["k"][r] == eff[0]
        carry = _mat(m, [[0]] + [[x] for x in eff[1:]])
        carry = [row[0] for row in carry]
    assert c["residual"] == carry
    table = poseidon_sparse.kernel_table()
    assert _cuda_int(CSRC / "poseidon.cu", "PARTIAL_STRIDE") == \
        poseidon_sparse.PARTIAL_STRIDE == 23
    assert len(table) == 8 * 12 + 121 + 22 * 23
    assert table[:48] == list(rc[:48])
    assert table[48:60] == [(x + y) % P for x, y in zip(rc[312:324], carry)]
    assert table[60:96] == list(rc[324:360])
    assert table[96:217] == [x for row in c["a0"] for x in row]
    for r in range(22):
        assert table[217 + 23 * r:][:23] == \
            [c["k"][r]] + c["w_hat"][r] + c["v"][r]


# ---------------------------------------------------------------------------
# csrc/poseidon.cu permute_regs in its operation order: one thread a state in
# registers, lazy values. Full rounds: constants and the s-box on every
# element, the circulant with each term split into 32-bit halves summed in
# two u64 accumulators (an IMAD.WIDE.U32 by 2^e a half-term)
# and one reduce96 an output. A_0 once. Partial rounds: the s-box on
# s0 + k, element 0's eleven products in an `Acc` (128-bit sum and carry
# count, one reduction), s_i + v_i y reduced from below 2^128.
# ---------------------------------------------------------------------------


class Acc:
    """`Acc` of csrc/poseidon.cu: lo, hi (u64) and a 32-bit carry count."""

    def __init__(self, first=0):
        self.lo, self.hi, self.top = first, 0, 0
        self.exact = first

    def mac(self, x, w):
        assert 0 <= x <= M64 and 0 <= w < P
        p = x * w
        s = self.lo + (self.hi << 64) + (self.top << 128) + p
        self.exact += p
        self.lo, self.hi, self.top = s & M64, (s >> 64) & M64, s >> 128
        assert self.top < 1 << 32

    def reduce(self):
        assert self.top <= 15
        hi_hi, hi_lo = self.hi >> 32, self.hi & EPS
        v = self.lo + (hi_lo << 32) - (hi_lo + hi_hi + (self.top << 32))
        assert -(1 << 64) < v < 1 << 65
        w = v & M128
        k = w >> 64
        assert k in (0, 1, M64)
        out = ((w & M64) + times_eps(k)) & M64
        assert out == (w & M64) + {0: 0, 1: EPS, M64: -EPS}[k], "wrap"
        assert out % P == self.exact % P
        return out


def _mds_regs(s):
    out = []
    for r in range(12):
        lo = hi = 0
        for c in range(12):
            e = poseidon._EXPS[(12 - r + c) % 12]
            lo += (s[c] & EPS) << e
            hi += (s[c] >> 32) << e
            assert lo <= M64 and hi <= M64  # every u64 accumulation
        out.append(reduce96((hi << 32) + lo))
    return out


def emulate_tree_permute(s):
    """`permute_regs`: lazy in, lazy out."""
    tab = poseidon_sparse.kernel_table()
    a0_at = poseidon_sparse.FULL_SIZE
    partial_at = a0_at + poseidon_sparse.A0_SIZE
    stride = poseidon_sparse.PARTIAL_STRIDE

    def full_round(s, r):
        return _mds_regs([_sbox7(add_canon_lazy(s[i], tab[r * 12 + i]))
                          for i in range(12)])

    for r in range(4):
        s = full_round(s, r)
    out = []
    for i in range(11):
        a = Acc()
        for j in range(11):
            a.mac(s[1 + j], tab[a0_at + i * 11 + j])
        out.append(a.reduce())
    s = [s[0]] + out
    for r in range(22):
        pc = tab[partial_at + r * stride:][:stride]
        y = _sbox7(add_canon_lazy(s[0], pc[0]))
        a = Acc(y)
        for i in range(1, 12):
            a.mac(s[i], pc[i])
        new = []
        for i in range(1, 12):
            v = y * pc[11 + i] + s[i]
            assert v <= M128
            new.append(reduce128_lazy(v))
        s = [a.reduce()] + new
    for r in range(4, 8):
        s = full_round(s, r)
    return s


def emulate_leaf(col):
    """`leaf_kernel` for one column of k values: the zero state, the rate
    overwritten a block at a time with rows past k read as zero."""
    s = [0] * 12
    for r0 in range(0, len(col), 8):
        s = [col[r0 + i] if r0 + i < len(col) else 0 for i in range(8)] + \
            s[8:]
        s = emulate_tree_permute(s)
    return [canonicalize(v) for v in s[:4]]


def emulate_node(left, right):
    return [canonicalize(v)
            for v in emulate_tree_permute(list(left) + list(right) + [0] * 4)
            [:4]]


@pytest.mark.parametrize("kind", KINDS)
def test_tree_kernel_order_matches_jax_permutation(kind):
    """The kernels' operation order on lazy values, canonicalized once,
    equals the JAX package's Poseidon permutation (its exact scalar twin)
    mod p."""
    for st in _states(kind):
        got = [canonicalize(v) for v in emulate_tree_permute(st)]
        assert got == ref_poseidon.s_permutation([v % P for v in st])


def test_tree_kernel_leaf_and_node_order_match_plain():
    """Leaves of k = 1, 9 and 16 (the state lazy between blocks, rows past
    k zero) and sibling pairs equal the plain versions."""
    for k in (1, 9, 16):
        cols = _cols(50 + k, k, 3)
        cols[:, 1] = P - 1
        want = gl.to_u64(poseidon.leaf_hashes_plain(gl.from_u64(cols)))
        for j in range(cols.shape[1]):
            assert emulate_leaf([int(v) for v in cols[:, j]]) == \
                [int(v) for v in want[:, j]]
    cur = _cols(60, 4, 4)
    want = gl.to_u64(poseidon.node_layer_plain(gl.from_u64(cur)))
    for j in range(2):
        assert emulate_node([int(v) for v in cur[:, 2 * j]],
                            [int(v) for v in cur[:, 2 * j + 1]]) == \
            [int(v) for v in want[:, j]]


# ---------------------------------------------------------------------------
# The node layers of a tree in one or two launches (poseidon_node_layers,
# csrc/byte_tree.cuh's schedule around the Poseidon node hash)
# ---------------------------------------------------------------------------


def test_node_launches_plan_a_prove():
    """A Poseidon-tree prove's trees (the three 2^19-leaf oracles and the
    FRI layers of 2^16, 2^13, 2^10, 2^7 and 2^4 leaves, cap 16: 75 node
    layers) take the byte trees' plan: two launches for each 2^19-leaf
    tree (its first stage of 3 layers, then 12), one for each smaller tree,
    none for the 2^4-leaf tree, 10 in all."""
    trees = [1 << 19] * 3 + [1 << 16, 1 << 13, 1 << 10, 1 << 7, 1 << 4]
    widths = [dbh.node_widths(m, 16) for m in trees]
    assert sum(len(w) for w in widths) == 75
    plans = [dbh.node_launches(m, len(w)) for m, w in zip(trees, widths)]
    assert plans == [[(1 << 19, 3), (1 << 16, 12)]] * 3 + [
        [(1 << 16, 12)], [(1 << 13, 9)], [(1 << 10, 6)], [(1 << 7, 3)], []]
    assert sum(len(p) for p in plans) == 10
    assert sum(dbh.node_tickets(m, lv) for p in plans for m, lv in p) == \
        3 * (128 // 8 + 2 + 1) + (16 + 2 + 1) + (2 + 1) + 1


@pytest.mark.parametrize("m,cap", [(1 << 8, 1), (96, 1), (1 << 7, 16)])
def test_node_layers_match_jax(jax_poseidon, m, cap):
    """`node_layers` on the CPU (its plain version) against the JAX
    `hash_nodes` a layer at a time, down to the cap or the odd width (96:
    48, 24, 12, 6, 3)."""
    cur = _cols(m + cap, 4, m)
    before = _counts()
    got = poseidon.node_layers(gl.from_u64(cur), cap)
    assert _counts() == before
    want, ref = [], ref_gl.from_u64(cur)
    while ref.shape[1] > cap and ref.shape[1] % 2 == 0:
        ref = ref_sponge.hash_nodes(ref[:, 0::2], ref[:, 1::2], "poseidon")
        want.append(ref_gl.to_u64(ref))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.array_equal(gl.to_u64(g), w)


SCHEDULE_CASES = [(1 << 11, 1, False), (3 << 9, 1, False),
                  (1 << 11, 16, True)]


@pytest.mark.parametrize("hasher,m,cap,split", [
    pytest.param("poseidon", *case, id="%d-%d-%s" % case)
    for case in SCHEDULE_CASES] + [
    pytest.param("poseidon2", *case, id="poseidon2-%d-%d-%s" % case)
    for case in SCHEDULE_CASES + [(1000, 1, False), (96, 16, False)]])
def test_node_schedule_matches_plain_chain(hasher, m, cap, split):
    """csrc/byte_tree.cuh's schedule (the emulation of the byte trees'
    tests) around the Poseidon node hash, or the Poseidon2 one with its
    narrow levels on 4 lanes a state (its opt-in in a launch that takes the
    unrolled build: a level of at most 64 parents a block, thread 4t + w on
    word w of parent t), digests of 4 u64
    planes: every element of the one buffer stored once, every group's
    counter drawn by each of its blocks, the layers equal to the plain
    chain; also split into two launches as `node_launches` splits a tree
    above 2^17 nodes."""
    mod = {"poseidon": poseidon, "poseidon2": pallas_poseidon2}[hasher]
    lanes = 1
    if hasher == "poseidon2":  # the unrolled build's narrow levels
        assert _cuda_int(CSRC / "poseidon2.cu", "STATE_LANES") == 4

        def lanes(w, levels):
            return 1 if pallas_poseidon2.node_layers_rolled(w, levels) else 4
    cur = gl.from_u64(_cols(m, 4, m))
    n = len(dbh.node_widths(m, cap))
    plan = [(m, dbh.NODE_STAGE), (m >> dbh.NODE_STAGE, n - dbh.NODE_STAGE)] \
        if split else None
    got, writes, tickets = _emulate_node_layers(
        cur, mod.node_layer_plain, cap, dbh.NODE_THREADS,
        dbh.NODE_STAGE, np.random.default_rng(m), plan, lanes)
    assert (writes == 1).all()
    assert (tickets >= 1).all() and (tickets <= dbh.NODE_GROUP).all()
    want = mod.node_layers_plain(cur, cap)
    assert len(want) == n
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_tree_entries_check_inputs():
    with pytest.raises(TypeError):
        poseidon.node_layer(gl.from_u64(_cols(5, 5, 4)))
    with pytest.raises(TypeError):
        poseidon.node_layers(gl.from_u64(_cols(5, 8, 4)), 1)
    with pytest.raises(RuntimeError):  # a kernel or an error: no fallback
        poseidon.node_layers(torch.zeros((4, 8), dtype=torch.int64,
                                         device="meta"), 1)
    with pytest.raises(ValueError):
        poseidon.node_layer(gl.from_u64(_cols(5, 4, 3)))
    with pytest.raises(TypeError):
        poseidon.leaf_hashes(torch.zeros((8, 4), dtype=torch.int32))
