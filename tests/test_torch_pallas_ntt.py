"""The port's all-stage small NTT (the wrapper of kernel K4, which runs its
plain version on CPU tensors) and the four-step recursion around it, against
the JAX package's `pallas_ntt` with its Pallas kernel in interpret mode; the
cross twiddle that the port multiplies in the kernel's store against the
JAX multiply after it; and a Python-int emulation of `csrc/ntt_small.cu`'s
order of operations (register phases, exchanges, lazy arithmetic,
power-of-two twiddles, epilogue) against the plain version. Exact equality
of canonical u64 values throughout."""

import numpy as np
import pytest
import torch

from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.ntt import pallas_ntt as ref_pn
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.ntt import ntt
from boojum_tpu_torch.ntt import pallas_ntt as pn

P = gl.ORDER


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


@pytest.mark.parametrize("log_n,b", [(3, 5), (9, 130)])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_small_matches_pallas_interpret(log_n, b, inverse):
    x = _rand(100 + log_n + inverse, (1 << log_n, b))
    got = gl.to_u64(pn.ntt_small(gl.from_u64(x), log_n, inverse))
    want = ref_gl.to_u64(ref_pn.ntt_small(ref_gl.from_u64(x), log_n, inverse,
                                          interpret=True))
    assert np.array_equal(got, want)
    back = pn.ntt_small(gl.from_u64(got), log_n, not inverse)
    assert np.array_equal(gl.to_u64(back), x)


@pytest.mark.parametrize("log_n,b,log_n1", [(12, 2, None), (11, 3, 4),
                                           (12, 2, 10)])
def test_recursion_matches_pallas_interpret(log_n, b, log_n1):
    """`ntt_any` (its own split) and `ntt_fourstep` with an explicit split
    (log_n1 = 10 nests a four-step in pass 1, so the outer table reaches the
    inner pass 2 re-laid); all equal the K1 route, `ntt.ntt_fourstep_cols`."""
    x = _rand(200 + log_n, (1 << log_n, b))
    if log_n1 is None:
        got = pn.ntt_any(gl.from_u64(x), log_n)
        want = ref_pn.ntt_any(ref_gl.from_u64(x), log_n)
    else:
        got = pn.ntt_fourstep(gl.from_u64(x), log_n, log_n1)
        want = ref_pn.ntt_fourstep(ref_gl.from_u64(x), log_n, log_n1)
    got = gl.to_u64(got)
    assert np.array_equal(got, ref_gl.to_u64(want))
    assert np.array_equal(
        got, gl.to_u64(ntt.ntt_fourstep_cols(gl.from_u64(x))))


@pytest.mark.parametrize("log_n", [1, 5, 12])
def test_stage_tables_match_reference(log_n):
    for inverse in (False, True):
        got = pn._stage_tables_host(log_n, inverse)
        assert got.dtype == np.uint64 and got.shape == (1 << log_n,)
        assert np.array_equal(got, ref_pn._stage_tables_host(log_n, inverse))


def test_ntt_small_checks_inputs():
    with pytest.raises(TypeError):
        pn.ntt_small(torch.zeros((8, 4), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        pn.ntt_small(gl.from_u64(_rand(1, (8, 4))), 4)
    with pytest.raises(ValueError):
        pn.ntt_fourstep(gl.from_u64(_rand(1, (8, 4))), 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        pn.ntt_small(torch.zeros((8, 4), dtype=torch.int64, device="meta"), 3)
    counts = (pn.LAUNCHES, pn.PLAIN_CUDA_CALLS)
    x = gl.from_u64(_rand(2, (1, 6)))  # log_n = 0 is the identity
    for inverse in (False, True):
        assert torch.equal(pn.ntt_small(x, 0, inverse), x)
    assert (pn.LAUNCHES, pn.PLAIN_CUDA_CALLS) == counts  # CPU: plain, uncounted


def _expand(tw, shift):
    """A (n, B >> shift) table widened to one column per output column."""
    return np.repeat(tw, 1 << shift, axis=1)


@pytest.mark.parametrize("log_n,b,shift", [(9, 128, 4), (3, 64, 3)])
def test_ntt_small_twiddle_matches_pallas_then_mul(log_n, b, shift):
    """The cross twiddle in the store equals the JAX kernel's output times
    the same table, multiplied afterwards as the reference does."""
    x = _rand(300 + log_n, (1 << log_n, b))
    tw = _rand(310 + log_n, (1 << log_n, b >> shift))
    got = gl.to_u64(pn.ntt_small(gl.from_u64(x), log_n, tw=gl.from_u64(tw),
                                 tw_shift=shift))
    out = ref_pn.ntt_small(ref_gl.from_u64(x), log_n, False, interpret=True)
    want = ref_gl.to_u64(ref_gl.mul(out, ref_gl.from_u64(_expand(tw, shift))))
    assert np.array_equal(got, want)


def test_relaid_outer_table_formula_and_cache():
    """The outer table of the (2^24, 8) layout, on a small analogue: 2^12 =
    2^6 x 2^6 with B = 8, the first 2^6 pass split 2^3 x 2^3. Row p2' of the
    inner pass 2's table at column p1'·n2 + j2 (output column
    (p1'·n2 + j2)·8 + c, shift 3) is W[p1'·8 + p2', j2]. Made once per
    table, then hit."""
    w = ntt.fourstep_twiddles_host(6, 6)
    pn.relaid_twiddles.cache_clear()
    wd = gl.from_u64(w)
    got = gl.to_u64(pn.relaid_twiddles(wd, 3))
    assert got.shape == (8, 8 * 64)
    for p2 in range(8):
        for p1 in range(8):
            assert np.array_equal(got[p2, p1 * 64:(p1 + 1) * 64], w[p1 * 8 + p2])
    assert np.array_equal(got, w.reshape(8, 8, 64).transpose(1, 0, 2)
                          .reshape(8, 8 * 64))
    assert pn.relaid_twiddles(wd, 3) is pn.relaid_twiddles(wd, 3)
    # through the recursion: a four-step nested in pass 1 re-lays its
    # caller's (cached) table once, and finds it the second time
    pn.relaid_twiddles.cache_clear()
    x = gl.from_u64(_rand(320, (1 << 12, 2)))
    outs = [pn.ntt_fourstep(x, 12, 10) for _ in range(2)]
    info = pn.relaid_twiddles.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert torch.equal(outs[0], outs[1])


def test_ntt_small_twiddle_checks_inputs():
    x = gl.from_u64(_rand(3, (8, 16)))
    good = gl.from_u64(_rand(4, (8, 4)))
    assert pn.ntt_small(x, 3, tw=good, tw_shift=2).shape == (8, 16)
    with pytest.raises(ValueError, match="twiddle table"):  # bad shape
        pn.ntt_small(x, 3, tw=gl.from_u64(_rand(4, (8, 3))), tw_shift=2)
    with pytest.raises(ValueError, match="twiddle table"):  # bad type
        pn.ntt_small(x, 3, tw=good.to(torch.int32), tw_shift=2)
    with pytest.raises(ValueError, match="forward only"):
        pn.ntt_small(x, 3, True, tw=good, tw_shift=2)
    with pytest.raises(ValueError, match="multiple"):  # B = 16, 2^5
        pn.ntt_small(x, 3, tw=good, tw_shift=5)
    with pytest.raises(ValueError, match="contiguous"):
        pn.ntt_small(x, 3, tw=gl.from_u64(_rand(4, (4, 8))).t(), tw_shift=2)


# ---------------------------------------------------------------------------
# csrc/ntt_small.cu in its order of operations, on Python ints
# ---------------------------------------------------------------------------


def mul_pow2_96(x, e):
    """goldilocks.cuh mul_pow2_96: x * 2^e for 0 <= e < 96, lazy."""
    from tests.test_torch_poseidon2_fused import (EPS, M64, reduce96,
                                                  reduce128_lazy, sub_lazy)
    assert 0 <= x <= M64 and 0 <= e < 96
    if e == 0:
        return x
    if e <= 32:
        return reduce96(x << e)
    if e < 64:
        return reduce128_lazy(x << e)
    xl, xh = x & EPS, x >> 32
    assert xl << e < 1 << 128 and xh << (e - 64) <= M64
    out = sub_lazy(reduce128_lazy(xl << e), xh << (e - 64))
    assert out % P == x * pow(2, e, P) % P
    return out


def mul_pow2(x, e):
    """goldilocks.cuh mul_pow2: x * 2^e for 0 <= e < 192 (2^96 = -1)."""
    from tests.test_torch_poseidon2_fused import _lazy, sub_lazy
    out = mul_pow2_96(x, e) if e < 96 else sub_lazy(0, mul_pow2_96(x, e - 96))
    return _lazy(out, x * pow(2, e, P))


def _k4_shape(log_n):
    """Shape<L> of the kernel: rows a thread holds (2^A), phases P."""
    a = min(log_n, 3)
    return a, (1 if log_n == 0 else -(-log_n // a))


def _k4_phase(log_n, ph):
    """(lowest bit, highest bit, first held bit) of phase ph."""
    a, p = _k4_shape(log_n)
    lo = a * (p - 1 - ph)
    return lo, min(lo + a - 1, log_n - 1), min(lo, log_n - a)


def _k4_row(log_n, q, h, co):
    a = _k4_shape(log_n)[0]
    return (q & ((1 << co) - 1)) | (h << co) | ((q >> co) << (co + a))


def _k4_root_exp(bit):
    return (39 << (5 - bit)) % 192


def _emulate_ntt_small(x, log_n, inverse, tt=None, shift=0):
    """`csrc/ntt_small.cu` on Python ints, column by column and thread by
    thread: each thread q loads the rows of the first phase, runs the
    phase's stages on lazy values (power-of-two twiddles where the phase
    holds bit 0 and the stage spans at most 64 points, the stage table
    otherwise), the exchange hands each thread the next phase's rows, and
    the store applies n^-1 = 2^(192 - L) (inverse) or the cross twiddle
    (forward), then one canonicalization."""
    from tests.test_torch_poseidon2_fused import (add_lazy, canonicalize,
                                                  mul_lazy, sub_lazy)
    a, p = _k4_shape(log_n)
    n, g, hn = 1 << log_n, 1 << (log_n - a), 1 << a
    tws = [int(v) for v in pn._stage_tables_host(log_n, inverse)]
    order = list(range(p))[::-1] if inverse else list(range(p))

    def stages(r, q, ph):
        lo, hi, co = _k4_phase(log_n, ph)
        j_lo = q & ((1 << co) - 1)
        for bit in (range(lo, hi + 1) if inverse else range(hi, lo - 1, -1)):
            d = bit - co
            for h in range(hn):
                if h >> d & 1:
                    continue
                hp, jh = h + (1 << d), (h & ((1 << d) - 1)) << co
                j = j_lo | jh
                assert j == _k4_row(log_n, q, h, co) & ((1 << bit) - 1)
                w = tws[n - (2 << bit) + j]
                u, v = r[h], r[hp]
                if bit == 0 or (co == 0 and bit <= 5):
                    f = _k4_root_exp(bit) * jh % 192
                    e = (192 - f) % 192 if inverse else f
                    assert pow(2, e, P) == w
                    if inverse:
                        t = mul_pow2_96(v, e % 96)
                        s_, d_ = add_lazy(u, t), sub_lazy(u, t)
                        r[h], r[hp] = (s_, d_) if e < 96 else (d_, s_)
                    else:
                        dd = sub_lazy(u, v) if e < 96 else sub_lazy(v, u)
                        r[h], r[hp] = add_lazy(u, v), mul_pow2_96(dd, e % 96)
                elif inverse:
                    t = mul_lazy(v, w)
                    r[h], r[hp] = add_lazy(u, t), sub_lazy(u, t)
                else:
                    r[h], r[hp] = add_lazy(u, v), mul_lazy(sub_lazy(u, v), w)

    b = len(x[0])
    out = [[None] * b for _ in range(n)]
    for col in range(b):
        co = _k4_phase(log_n, order[0])[2]
        regs = [[x[_k4_row(log_n, q, h, co)][col] for h in range(hn)]
                for q in range(g)]
        for step, ph in enumerate(order):
            if step:
                prev, cur = (_k4_phase(log_n, order[step - 1])[2],
                             _k4_phase(log_n, ph)[2])
                tile = {_k4_row(log_n, q, h, prev): regs[q][h]
                        for q in range(g) for h in range(hn)}
                assert len(tile) == n
                regs = [[tile[_k4_row(log_n, q, h, cur)] for h in range(hn)]
                        for q in range(g)]
            for q in range(g):
                stages(regs[q], q, ph)
        co = _k4_phase(log_n, order[-1])[2]
        for q in range(g):
            for h in range(hn):
                row, u = _k4_row(log_n, q, h, co), regs[q][h]
                if inverse:
                    u = mul_pow2(u, (192 - log_n) % 192)
                if tt is not None:
                    u = mul_lazy(u, tt[row][col >> shift])
                out[row][col] = canonicalize(u)
    return out


@pytest.mark.parametrize("log_n", [1, 3, 4, 9, 12])
@pytest.mark.parametrize("mode", ["forward", "twiddle", "inverse"])
def test_kernel_order_matches_plain(log_n, mode):
    """The K4 kernel's phases, exchanges and lazy arithmetic, emulated,
    equal the plain version (2 columns, one of them all p - 1)."""
    n = 1 << log_n
    x = _rand(400 + log_n, (n, 2))
    x[:, 1] = P - 1
    inverse, tt = mode == "inverse", None
    kw = {}
    if mode == "twiddle":
        tt = _rand(410 + log_n, (n, 1))
        kw = dict(tw=gl.from_u64(tt), tw_shift=1)
    want = gl.to_u64(pn.ntt_small(gl.from_u64(x), log_n, inverse, **kw))
    got = _emulate_ntt_small([[int(v) for v in row] for row in x], log_n,
                             inverse, None if tt is None else
                             [[int(v) for v in row] for row in tt], 1)
    assert got == [[int(v) for v in row] for row in want]


def test_mul_pow2_ranges():
    """mul_pow2 at every exponent below 192 on the edge values: in u64 range
    and congruent to x * 2^e (checked inside)."""
    from tests.test_torch_poseidon2_fused import M64
    for e in range(192):
        for x in (0, 1, P - 1, P, M64):
            mul_pow2(x, e)
