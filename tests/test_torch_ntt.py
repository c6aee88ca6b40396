"""The port's NTT against the JAX package: the plain version of the
`ntt_stage` kernel (K1) against the reference's jnp-dot stage and its
butterflies, against the v2 and v1 Pallas stage kernels in interpret mode,
the four-step at 2^14, and the all-coset LDE. Exact equality of canonical
u64 values throughout."""

import numpy as np
import pytest
import torch

from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.ntt import mxu_ntt as ref_mxu
from boojum_tpu.ntt import ntt as ref_ntt
from boojum_tpu.ntt.pallas_ntt import _fourstep_twiddles_host
from boojum_tpu.prover import device as ref_device
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.ntt import mxu_ntt, ntt
from boojum_tpu_torch.prover import device

P = gl.ORDER


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def _tw_table(log_r, width, inverse):
    """A (R, width) cross-twiddle table, as the four-step passes use."""
    return ntt.fourstep_twiddles_host(log_r, width.bit_length() - 1, inverse)


@pytest.mark.parametrize("log_r", [7, 8])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("twmode", [0, 1, 2])
def test_plain_stage_matches_reference_stage(log_r, inverse, twmode):
    r, m, width = 1 << log_r, 256, 64
    x = _rand(log_r * 10 + twmode, (r, m))
    tw = _tw_table(log_r, width, inverse) if twmode else None
    got = gl.to_u64(mxu_ntt.ntt_cols_matmul(
        gl.from_u64(x), inverse=inverse,
        tw=gl.from_u64(tw) if twmode else None, tw_pre=twmode == 2))
    ref_tw = None if tw is None else (
        ref_gl.from_u64(tw).lo, ref_gl.from_u64(tw).hi)
    want = ref_gl.to_u64(ref_mxu.ntt_cols_matmul(
        ref_gl.from_u64(x), inverse=inverse, fused=False, tw=ref_tw,
        tw_pre=twmode == 2))
    assert np.array_equal(got, want)
    if twmode == 0:
        plan = ref_ntt.get_plan(log_r)
        fn = ref_ntt.intt_cols if inverse else ref_ntt.ntt_cols
        assert np.array_equal(got, ref_gl.to_u64(fn(ref_gl.from_u64(x), plan)))
        # the stage is the matrix product of _w_matrix_u64
        w = mxu_ntt._w_matrix_u64(log_r, inverse)
        assert np.array_equal(w, ref_mxu._w_matrix_u64(log_r, inverse))
        col = [int(v) for v in x[:, 3]]
        for p in (0, 1, r - 1):
            want_p = sum(int(w[p, j]) * col[j] for j in range(r)) % P
            assert int(got[p, 3]) == want_p


@pytest.mark.parametrize("version,inverse", [(2, False), (2, True), (1, False),
                                             (1, True)])
def test_plain_stage_matches_pallas_interpret(version, inverse):
    """Against the TPU kernels themselves (v2 = K1, v1 = K3) at twmode 0."""
    x = _rand(40 + version * 2 + inverse, (256, 256))
    fn = ref_mxu._stage_pallas_jit(8, 256, inverse, True, version=version)
    rx = ref_gl.from_u64(x)
    lo, hi = fn(rx.lo, rx.hi)
    want = ref_gl.to_u64(ref_gl.GL(lo, hi))
    got = gl.to_u64(mxu_ntt.ntt_cols_matmul(gl.from_u64(x), inverse=inverse))
    assert np.array_equal(got, want)


def test_plain_stage_matches_pallas_interpret_twiddle():
    """The v2 kernel's fused forward cross twiddle (twmode 1)."""
    x = _rand(50, (256, 256))
    tw = _tw_table(8, 128, False)
    rx, rtw = ref_gl.from_u64(x), ref_gl.from_u64(tw)
    fn = ref_mxu._stage_pallas_jit(8, 256, False, True, version=2, twmode=1,
                                   tw_width=128)
    lo, hi = fn(rx.lo, rx.hi, rtw.lo, rtw.hi)
    want = ref_gl.to_u64(ref_gl.GL(lo, hi))
    got = gl.to_u64(mxu_ntt.ntt_cols_matmul(gl.from_u64(x),
                                            tw=gl.from_u64(tw)))
    assert np.array_equal(got, want)


def test_stage_wrapper_checks_inputs():
    with pytest.raises(ValueError):
        mxu_ntt.ntt_cols_matmul(gl.from_u64(_rand(1, (64, 8))))
    with pytest.raises(TypeError):
        mxu_ntt.ntt_cols_matmul(torch.zeros((128, 8), dtype=torch.int32))
    with pytest.raises(ValueError):  # width does not divide M
        mxu_ntt.ntt_cols_matmul(gl.from_u64(_rand(1, (128, 8))),
                                tw=gl.from_u64(_rand(2, (128, 3))))


def test_cross_twiddle_table_matches_reference():
    for (a, b) in ((7, 7), (8, 8), (8, 2)):
        w = ntt.fourstep_twiddles_host(a, b)
        lo, hi = _fourstep_twiddles_host(a, b)
        assert np.array_equal(w, lo.astype(np.uint64)
                              | (hi.astype(np.uint64) << np.uint64(32)))


def test_fourstep_2_14_matches_reference():
    x = _rand(60, (1 << 14, 2))
    got = gl.to_u64(ntt.ntt_fourstep_cols(gl.from_u64(x)))
    want = ref_gl.to_u64(ref_ntt.ntt_fourstep_cols(ref_gl.from_u64(x)))
    assert np.array_equal(got, want)
    back = gl.to_u64(ntt.intt_fourstep_cols(gl.from_u64(want)))
    want_back = ref_gl.to_u64(ref_ntt.intt_fourstep_cols(ref_gl.from_u64(want)))
    assert np.array_equal(back, want_back)
    assert np.array_equal(back, x)


def test_small_coset_ntt_matches_naive_dft():
    x = _rand(70, (1 << 6, 2))
    plan = ntt.get_plan(6)
    got = gl.to_u64(ntt.coset_ntt_cols(gl.from_u64(x), 7, plan))
    omega = ref_gl.domain_generator(6)
    rev = ref_ntt.bitreverse_indices(6)
    for i in (0, 1, 17, 63):
        pt = 7 * pow(omega, int(rev[i]), P) % P
        for c in range(2):
            want = sum(int(x[j, c]) * pow(pt, j, P) for j in range(64)) % P
            assert int(got[i, c]) == want
    assert np.array_equal(gl.to_u64(ntt.coset_intt_cols(gl.from_u64(got), 7, plan)), x)
    assert ntt.lde_cosets(10, 8) == ref_ntt.lde_cosets(10, 8)
    assert np.array_equal(ntt.bitreverse_indices(9), ref_ntt.bitreverse_indices(9))


def test_monomials_to_lde_matches_reference():
    x = _rand(80, (1 << 10, 3))
    mono = device.cols_to_monomials(gl.from_u64(x))
    ref_mono = ref_device.cols_to_monomials(ref_gl.from_u64(x))
    assert np.array_equal(gl.to_u64(mono), ref_gl.to_u64(ref_mono))
    got = gl.to_u64(device.monomials_to_lde(mono, 8))
    want = ref_gl.to_u64(ref_device.monomials_to_lde(ref_mono, 8))
    assert got.shape == (8, 1 << 10, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(device.x_poly_lde_host(64, 4),
                          ref_device.x_poly_lde_host(64, 4))

