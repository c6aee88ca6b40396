"""The fused Poseidon2 tree entries of the port (the plain versions of the
`poseidon2_leaf_hashes` and `poseidon2_node_layer` kernels) against the JAX
package's `_leaf_hashes_traced` / `_node_layer_traced`, and a Python-int
emulation of the Hopper kernels' lazy Goldilocks arithmetic
(`csrc/goldilocks.cuh`) in the exact operation order of `csrc/poseidon2.cu`
against the canonical permutation, and of `csrc/poseidon.cu` (the
transcript's Poseidon, kernel K6) against the JAX package's permutation. The emulation checks every lazy result
for range and congruence, so a range error shows here before the kernel
runs on a card. Exact equality throughout."""

import functools

import numpy as np
import pytest
import torch

from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.hash import poseidon as ref_poseidon
from boojum_tpu.hash import poseidon2 as ref_p2
from boojum_tpu.prover import device_merkle as ref_dm
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.hash import pallas_poseidon2 as pp
from boojum_tpu_torch.hash import poseidon
from boojum_tpu_torch.hash import poseidon2 as p2

P = gl.ORDER
EPS = (1 << 32) - 1
M64 = (1 << 64) - 1


M128 = (1 << 128) - 1


# ---------------------------------------------------------------------------
# goldilocks.cuh, lazy half, on Python ints (every result checked)
# ---------------------------------------------------------------------------


def _lazy(out, exact):
    assert 0 <= out <= M64, "lazy result out of u64 range"
    assert out % P == exact % P, "lazy result not congruent"
    return out


def times_eps(c):
    """(c << 32) - c on u64: c * EPS for c in {0, 1}, -EPS for 2^64 - 1."""
    return ((c << 32) - c) & M64


def reduce96(v):
    assert 0 <= v < 1 << 96
    hi = v >> 64
    t = (v & M64) + times_eps(hi)
    assert t >> 64 in (0, 1)
    out = (t & M64) + times_eps(t >> 64)
    assert out <= M64, "second carry in reduce96"
    return _lazy(out, v)


def reduce128_lazy(v):
    lo, hi = v & M64, v >> 64
    hi_hi, hi_lo = hi >> 32, hi & EPS
    w = (lo + (hi_lo << 32) - (hi_lo + hi_hi)) & M128
    k = w >> 64
    assert k in (0, 1, M64)
    exact = (w & M64) + {0: 0, 1: EPS, M64: -EPS}[k]
    assert 0 <= exact <= M64, "wrap in reduce128_lazy"
    return _lazy(exact, v)


def add_lazy(a, b):
    return _lazy(reduce96(a + b), a + b)


def add_canon_lazy(a, c):
    assert c < P
    s = a + c
    out = (s & M64) + times_eps(s >> 64)
    assert out <= M64
    return _lazy(out, s)


def sub_lazy(a, b):
    d = (a - b) & M128
    e = ((d & M64) - times_eps((d >> 64) & 1)) & M128
    out = (e & M64) - times_eps((e >> 64) & 1)
    assert out >= 0, "third borrow in sub_lazy"
    return _lazy(out, a - b)


def mul_lazy(a, b):
    return reduce128_lazy(a * b)


def square_lazy(a):
    a0, a1 = a & EPS, a >> 32
    sq = ((a1 * a1) << 64) + a0 * a0 + ((a0 * a1) << 33)
    assert sq == a * a
    return reduce128_lazy(sq)


def canonicalize(a):
    out = a - P if a >= P else a
    assert 0 <= out < P
    return out


EDGES = [0, 1, 2, EPS - 1, EPS, EPS + 1, 1 << 32, (1 << 63) - 1, 1 << 63,
         P - 2, P - 1, P, P + 1, M64 - EPS - 1, M64 - EPS, M64 - EPS + 1,
         M64 - 1, M64]


# ---------------------------------------------------------------------------
# poseidon2.cu in its operation order
# ---------------------------------------------------------------------------


def _sbox7(x):
    x2 = square_lazy(x)
    x3 = mul_lazy(x, x2)
    x4 = square_lazy(x2)
    return mul_lazy(x3, x4)


def _external_mds(el):
    """Delayed reduction: exact sums (< 2^71), one reduce96 per output."""
    b = []
    for k in range(3):
        x0, x1, x2, x3 = el[4 * k:4 * k + 4]
        t0, t1 = x0 + x1, x2 + x3
        t2, t3 = 2 * x1 + t1, 2 * x3 + t0
        t4, t5 = 4 * t1 + t3, 4 * t0 + t2
        b.append((t3 + t5, t5, t2 + t4, t4))
    out = [0] * 12
    for j in range(4):
        total = b[0][j] + b[1][j] + b[2][j]
        for k in range(3):
            out[4 * k + j] = reduce96(b[k][j] + total)
    return out


def _full_sboxes(el, r, rolled):
    """A full round's constants and s-boxes: all 12 in order, or (the
    rolled build) a block of 4 at a time at el[0 .. 3], the blocks rotated
    down after each of the three turns."""
    rc = p2._RC
    if not rolled:
        return [_sbox7(add_canon_lazy(e, rc[r * 12 + i]))
                for i, e in enumerate(el)]
    el = list(el)
    for k in range(3):
        el[:4] = [_sbox7(add_canon_lazy(el[i], rc[r * 12 + 4 * k + i]))
                  for i in range(4)]
        el = el[4:] + el[:4]
    return el


def emulate_permute(el, rolled=False):
    """The kernel's `permute<rolled>`: lazy in, lazy out."""
    rc = p2._RC
    el = _external_mds(list(el))
    r = 0
    for phase, rounds in (("full", 4), ("partial", 22), ("full", 4)):
        for _ in range(rounds):
            if phase == "full":
                el = _external_mds(_full_sboxes(el, r, rolled))
            else:
                rest = sum(el[1:])  # before the s-box: < 11 * 2^64, exact
                el[0] = _sbox7(add_canon_lazy(el[0], rc[r * 12]))
                total = rest + el[0]
                el = [reduce96((e << p2._DIAG_SHIFTS[i]) + total)
                      for i, e in enumerate(el)]
            r += 1
    return el


def emulate_leaf(col, rolled=False):
    """The kernel's leaf entry for one column of k values."""
    el = [0] * 12
    for r0 in range(0, len(col), 8):
        block = list(col[r0:r0 + 8])
        el[:8] = block + [0] * (8 - len(block))
        el = emulate_permute(el, rolled)
    return [canonicalize(e) for e in el[:4]]


# ---------------------------------------------------------------------------
# poseidon2.cu's `Lanes` (the narrow levels of poseidon2_node_layers): one
# state on 4 lanes, lane j holding x[j][k] = el[4k + j]. Each exchange is an
# index map (`_xor_lane`: lane j reads lane j ^ m, __shfl_xor_sync); the
# linear layers sum 32-bit halves in 64-bit words (every sum checked below
# 2^64) and reduce each output once from lo + hi * 2^32.
# ---------------------------------------------------------------------------

M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]


def _xor_lane(vals, m):
    """The 4 lanes' values after __shfl_xor_sync(..., m): lane j's is lane
    j ^ m's."""
    return [vals[j ^ m] for j in range(4)]


def _half(x, h):
    return x >> 32 if h else x & EPS


def _u64(v):
    assert 0 <= v <= M64, "a 64-bit sum overflowed"
    return v


def _reduce_halves(lo, hi):
    return reduce96((_u64(hi) << 32) + _u64(lo))


def _lanes_mds(x):
    """`Lanes::mds` on every lane: out_k[j] = (M4 x_k)[j] + (M4 s)[j] from
    the other lanes' elements, y[m][k] = x_k of lane j ^ m."""
    y = [[x[j][k] for k in range(3)] for j in range(4)]
    ys = [y] + [[_xor_lane([y[j][k] for j in range(4)], m) for k in range(3)]
                for m in (1, 2, 3)]
    out = []
    for j in range(4):
        mine = [[y[j][k] for k in range(3)]] + [
            [ys[m][k][j] for k in range(3)] for m in (1, 2, 3)]
        coef = [M4[j][j ^ m] for m in range(4)]
        acc = [[0] * 3 for _ in range(2)]
        for h in range(2):
            t = 0
            for m in range(4):
                s = sum(_half(v, h) for v in mine[m])
                assert s < 3 << 32
                t = _u64(t + s * coef[m])
            for k in range(3):
                acc[h][k] = _u64(t + sum(coef[m] * _half(mine[m][k], h)
                                         for m in range(4)))
        out.append([_reduce_halves(acc[0][k], acc[1][k]) for k in range(3)])
    return out


def emulate_lanes_permute(el):
    """`Lanes::permute` on the 4 lanes: lazy in, lazy out."""
    rc, shifts = p2._RC, p2._DIAG_SHIFTS
    x = [[el[4 * k + j] for k in range(3)] for j in range(4)]
    x = _lanes_mds(x)
    for r in list(range(4)) + list(range(26, 30)):
        if r == 26:  # the partial rounds come between
            for r2 in range(4, 26):
                # the other elements' sum over the lanes, then lane 0's
                # s-box output (every lane computes one; lane 0's is
                # broadcast, the others dropped)
                rest = []
                for h in range(2):
                    a = [_u64(sum(_half(v, h) for v in x[j][1 if j == 0
                                                            else 0:]))
                         for j in range(4)]
                    a = [_u64(u + v) for u, v in zip(a, _xor_lane(a, 1))]
                    a = [_u64(u + v) for u, v in zip(a, _xor_lane(a, 2))]
                    assert a == [a[0]] * 4  # every lane holds the sum
                    rest.append(a[0])
                y0 = [_sbox7(add_canon_lazy(x[j][0], rc[r2 * 12] if j == 0
                                            else 0)) for j in range(4)]
                x[0][0] = y0[0]
                tot = [_u64(rest[h] + _half(y0[0], h)) for h in range(2)]
                x = [[_reduce_halves(
                    _u64(_half(v, 0) * (1 << shifts[4 * k + j]) + tot[0]),
                    _u64(_half(v, 1) * (1 << shifts[4 * k + j]) + tot[1]))
                    for k, v in enumerate(x[j])] for j in range(4)]
        x = [[_sbox7(add_canon_lazy(x[j][k], rc[r * 12 + 4 * k + j]))
              for k in range(3)] for j in range(4)]
        x = _lanes_mds(x)
    return [x[i % 4][i // 4] for i in range(12)]


def _states(seed, b):
    return np.random.default_rng(seed).integers(0, P, (12, b), dtype=np.uint64)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry,k", [("leaf", 8), ("leaf", 64), ("leaf", 13),
                                     ("node", 4)])
def test_plain_entries_match_reference(entry, k):
    """leaf_hashes_plain / node_layer_plain against the JAX tree functions
    at m = 2^10 (k = 13 needs the padding to the rate)."""
    m = 1 << 10
    cols = np.random.default_rng(k).integers(0, P, (k, m), dtype=np.uint64)
    before = (pp.LAUNCHES, pp.LEAF_LAUNCHES, pp.NODE_LAUNCHES,
              pp.PLAIN_CUDA_CALLS)
    if entry == "leaf":
        got = pp.leaf_hashes_plain(gl.from_u64(cols))
        ref_cols = ref_dm._pad_cols_to_rate(ref_gl.from_u64(cols))
        want = ref_dm._leaf_hashes_traced(ref_cols)
        assert torch.equal(pp.leaf_hashes(gl.from_u64(cols)), got)
    else:
        got = pp.node_layer_plain(gl.from_u64(cols))
        want = ref_dm._node_layer_traced(ref_gl.from_u64(cols))
        assert torch.equal(pp.node_layer(gl.from_u64(cols)), got)
        assert got.shape == (4, m // 2)
    assert np.array_equal(gl.to_u64(got), ref_gl.to_u64(want))
    # on CPU tensors the wrappers run the plain versions and count nothing
    assert (pp.LAUNCHES, pp.LEAF_LAUNCHES, pp.NODE_LAUNCHES,
            pp.PLAIN_CUDA_CALLS) == before


@functools.lru_cache(maxsize=None)
def _jax_node_layer():
    """The JAX `_node_layer_traced`, jitted (eagerly, each new width costs
    seconds of tracing on the CPU)."""
    import jax
    return jax.jit(ref_dm._node_layer_traced)


@pytest.mark.parametrize("m,cap", [(1 << 8, 1), (96, 1), (1 << 7, 16)])
def test_node_layers_match_jax(m, cap):
    """`node_layers` on the CPU (its plain version, a layer at a time)
    against a chain of the JAX `_node_layer_traced`, down to the cap or the
    odd width (96: 48, 24, 12, 6, 3)."""
    cur = np.random.default_rng(m + cap).integers(0, P, (4, m),
                                                  dtype=np.uint64)
    before = (pp.NODE_LAYERS_LAUNCHES, pp.NODE_LAUNCHES, pp.PLAIN_CUDA_CALLS)
    got = pp.node_layers(gl.from_u64(cur), cap)
    assert (pp.NODE_LAYERS_LAUNCHES, pp.NODE_LAUNCHES,
            pp.PLAIN_CUDA_CALLS) == before
    want, ref = [], cur
    while ref.shape[1] > cap and ref.shape[1] % 2 == 0:
        w = ref.shape[1]
        # one compiled shape for every layer: the layer zero-padded to 256
        # nodes, its first w / 2 parents kept
        pad = np.zeros((4, 256), np.uint64)
        pad[:, :w] = ref
        ref = ref_gl.to_u64(_jax_node_layer()(ref_gl.from_u64(pad)))[:, :w // 2]
        want.append(ref)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.array_equal(gl.to_u64(g), w)


def test_lazy_primitives_on_edge_values():
    """Every pair of edge values (lazy inputs up to 2^64 - 1) through each
    lazy primitive: in range and congruent (checked inside each)."""
    for a in EDGES:
        square_lazy(a)
        canonicalize(a)
        for s in (1, 4, 14, 31):  # the internal matrix's a * 2^s + sum
            reduce96((a << s) + 12 * M64)
        for b in EDGES:
            add_lazy(a, b)
            sub_lazy(a, b)
            mul_lazy(a, b)
            if b < P:
                add_canon_lazy(a, b)
            for c in (0, 1, EPS):  # reduce96 takes v < 2^96
                reduce96((c << 64) + a)


@pytest.mark.parametrize("kind", ["random", "p_minus_1", "u64_max", "zeros",
                                  "lazy_random"])
def test_kernel_operation_order_matches_permutation(kind):
    """The kernel's exact operation order on lazy values, canonicalized once
    at the end, equals the canonical permutation of the inputs mod p."""
    rng = np.random.default_rng(3)
    states = {
        "random": [[int(v) for v in col] for col in _states(4, 3).T],
        "p_minus_1": [[P - 1] * 12],
        "u64_max": [[M64] * 12],
        "zeros": [[0] * 12],
        "lazy_random": [[int(v) for v in rng.integers(0, M64, 12,
                                                       dtype=np.uint64,
                                                       endpoint=True)]
                        for _ in range(3)],
    }[kind]
    for st in states:
        for rolled in (False, True):  # the kernel's two builds
            got = [canonicalize(e) for e in emulate_permute(st, rolled)]
            assert got == p2.s_permutation([v % P for v in st])


@pytest.mark.parametrize("kind", ["random", "p_minus_1", "u64_max", "zeros",
                                  "lazy_random"])
def test_lanes_order_matches_jax_permutation(kind):
    """The 4-lane permutation of the node layers' narrow levels, its
    exchanges as index maps, canonicalized once at the end, equals the JAX
    package's Poseidon2 permutation (its exact scalar twin) mod p."""
    rng = np.random.default_rng(5)
    states = {
        "random": [[int(v) for v in col] for col in _states(6, 3).T],
        "p_minus_1": [[P - 1] * 12],
        "u64_max": [[M64] * 12],
        "zeros": [[0] * 12],
        "lazy_random": [[int(v) for v in rng.integers(0, M64, 12,
                                                       dtype=np.uint64,
                                                       endpoint=True)]
                        for _ in range(3)],
    }[kind]
    for st in states:
        got = [canonicalize(e) for e in emulate_lanes_permute(st)]
        assert got == ref_p2.s_permutation([v % P for v in st])


def test_kernel_leaf_and_node_order_match_plain():
    """The leaf entry keeps lazy state between permutations and pads rows
    past k with zeros in registers; the node entry zeroes the capacity. Both
    emulations equal the plain versions (k = 13: one full, one partial
    block)."""
    cols = np.random.default_rng(9).integers(0, P, (13, 4), dtype=np.uint64)
    cols[:, 1] = P - 1
    want = gl.to_u64(pp.leaf_hashes_plain(gl.from_u64(cols)))
    for j in range(cols.shape[1]):
        for rolled in (False, True):
            assert emulate_leaf([int(v) for v in cols[:, j]], rolled) == \
                [int(v) for v in want[:, j]]
    cur = np.random.default_rng(10).integers(0, P, (4, 4), dtype=np.uint64)
    want = gl.to_u64(pp.node_layer_plain(gl.from_u64(cur)))
    for j in range(2):
        st = [int(v) for v in cur[:, 2 * j]] + \
             [int(v) for v in cur[:, 2 * j + 1]] + [0] * 4
        for perm in (emulate_permute, lambda st: emulate_permute(st, True),
                     emulate_lanes_permute):  # node layer, node layers
            assert [canonicalize(e) for e in perm(st)[:4]] == \
                [int(v) for v in want[:, j]]


# ---------------------------------------------------------------------------
# poseidon.cu (kernel K6, the classic Poseidon of the transcript) in its
# operation order: lane i holds element i; the MDS sum is rotated so lane i
# adds v[(i + j) % 12] * 2^EXPS[j] over the 32-bit halves in two u64
# accumulators; a partial round sums lanes 1..11 from the pre-s-box values
# and adds lane 0's s-box output times the lane's own power of two
# ---------------------------------------------------------------------------


def _k6_round(s, r):
    rc, exps = poseidon._RC, poseidon._EXPS
    full = r < 4 or r >= 26
    t = [add_canon_lazy(s[i], rc[r * 12 + i]) for i in range(12)]
    y = [_sbox7(x) for x in t]
    out = []
    for lane in range(12):
        lo = hi = 0
        for j in range(12):
            src = (lane + j) % 12
            v = y[src] if full else (0 if src == 0 else t[src])
            lo += (v & EPS) << exps[j]
            hi += (v >> 32) << exps[j]
        if not full:
            pow0 = 1 << exps[(12 - lane) % 12]
            lo += (y[0] & EPS) * pow0
            hi += (y[0] >> 32) * pow0
        assert lo < 1 << 52 and hi < 1 << 52  # the u64 accumulators
        out.append(reduce96((hi << 32) + lo))
    return out


def emulate_k6_permute(st):
    """`permute_lanes`: lazy in, lazy out."""
    for r in range(30):
        st = _k6_round(st, r)
    return st


def emulate_k6_absorb(st, elements):
    """`absorb_kernel`: the pad, the rate overwritten with lazy inputs, the
    state lazy between blocks and canonicalized once."""
    blk = list(elements) + [1]
    blk += [0] * (-len(blk) % 8)
    for i in range(0, len(blk), 8):
        st = emulate_k6_permute(blk[i:i + 8] + st[8:])
    return [canonicalize(v) for v in st]


@pytest.mark.parametrize("kind", ["random", "p_minus_1", "u64_max", "zeros",
                                  "lazy_random"])
def test_k6_operation_order_matches_jax_permutation(kind):
    """K6's operation order on lazy values, canonicalized once, equals the
    JAX package's Poseidon permutation (its exact scalar twin) mod p."""
    rng = np.random.default_rng(31)
    states = {
        "random": [[int(v) for v in col] for col in _states(32, 3).T],
        "p_minus_1": [[P - 1] * 12],
        "u64_max": [[M64] * 12],
        "zeros": [[0] * 12],
        "lazy_random": [[int(v) for v in rng.integers(0, M64, 12,
                                                       dtype=np.uint64,
                                                       endpoint=True)]
                        for _ in range(3)],
    }[kind]
    for st in states:
        got = [canonicalize(e) for e in emulate_k6_permute(st)]
        assert got == ref_poseidon.s_permutation([v % P for v in st])


@pytest.mark.parametrize("k", [0, 7, 8, 17])
def test_k6_absorb_order_matches_plain(k):
    """The absorb loop (k + 1 counted: k = 7 fills one block with the pad's
    one), from a lazy state with u64 edge values, equals the plain sponge."""
    rng = np.random.default_rng(40 + k)
    st = [int(v) for v in rng.integers(0, P, 12, dtype=np.uint64)]
    st[9], st[10] = M64, P
    el = [int(v) for v in rng.integers(0, M64, k, dtype=np.uint64,
                                       endpoint=True)]
    want = poseidon.sponge_absorb_plain(
        gl.from_u64([v % P for v in st]),
        gl.from_u64(np.asarray(el, np.uint64)))
    assert emulate_k6_absorb(st, el) == [int(v) for v in gl.to_u64(want)]


def test_k6_exponents_match_the_kernel_source():
    """csrc/poseidon.cu's compile-time MDS exponents are the host table's."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(poseidon.__file__), os.pardir,
                            "csrc", "poseidon.cu")).read()
    got = re.search(r"EXPS\[WIDTH\] = \{([^}]*)\}", src).group(1)
    assert [int(v) for v in got.split(",")] == list(poseidon._EXPS)


def test_kernel_builds_match_the_source():
    """The wrapper's mirror of the kernel's choice of build: the rolled
    full rounds from ROLL_FROM permutations side by side, and for the node
    layers only in a launch of at most one stage (a wide tree's first)."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(pp.__file__), os.pardir, "csrc",
                            "poseidon2.cu")).read()
    log = int(re.search(r"ROLL_FROM = 1LL << (\d+);", src).group(1))
    assert pp.ROLL_FROM == 1 << log
    assert pp.rolled(pp.ROLL_FROM) and not pp.rolled(pp.ROLL_FROM - 1)
    assert "rolled(m / 2) && levels <= byte_tree::STAGE" in src
    assert pp.node_layers_rolled(1 << 19, 3)
    assert not pp.node_layers_rolled(1 << 19, 4)
    assert not pp.node_layers_rolled(1 << 16, 12)
    assert not pp.node_layers_rolled(1 << 16, 3)


def test_tree_entries_check_inputs():
    with pytest.raises(TypeError):
        pp.node_layer(gl.from_u64(_states(5, 4)[:5]))
    with pytest.raises(TypeError):
        pp.node_layers(gl.from_u64(_states(5, 8)[:5]), 1)
    with pytest.raises(RuntimeError):  # a kernel or an error: no fallback
        pp.node_layers(torch.zeros((4, 8), dtype=torch.int64,
                                   device="meta"), 1)
    with pytest.raises(ValueError):
        pp.node_layer(gl.from_u64(_states(5, 3)[:4]))
    with pytest.raises(TypeError):
        pp.leaf_hashes(torch.zeros((8, 4), dtype=torch.int32))
