"""The port's all-stage small NTT (the wrapper of kernel K4, which runs its
plain version on CPU tensors) and the four-step recursion around it, against
the JAX package's `pallas_ntt` with its Pallas kernel in interpret mode.
Exact equality of canonical u64 values throughout."""

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


@pytest.mark.parametrize("log_n,b,log_n1", [(12, 2, None), (11, 3, 4)])
def test_recursion_matches_pallas_interpret(log_n, b, log_n1):
    """`ntt_any` (its own split) and `ntt_fourstep` with an explicit split;
    both also equal the K1 route, `ntt.ntt_fourstep_cols`."""
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
