# Port of boojum_tpu/ntt/mxu_ntt.py: the radix-R NTT stage, kernel K1.
"""One radix-R NTT stage (R = 128 or 256) along axis 0 of an (R, M) batch.

`ntt_cols_matmul` computes Y = W·X with the stage matrix of
`_w_matrix_u64` (forward: natural in, bitreversed out; inverse: bitreversed
in, natural out, times 1/R), optionally with the four-step cross twiddle
``tw[r, l % W]`` multiplied into the output (forward) or the input
(``tw_pre``, inverse). On a CUDA tensor it launches the hand-written Hopper
kernel ``csrc/ntt_stage.cu``, which replaces the TPU's byte-digit matrix-unit
kernel (`boojum_tpu/ntt/mxu_ntt.py:_mxu_kernel_v2`) with in-shared-memory
Goldilocks butterflies; on a CPU tensor it runs `ntt_stage_plain`, the same
function in plain torch. Outputs are canonical and bit-identical either way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from ..utils import npgl
from .ntt import bitreverse_indices, get_plan, intt_cols, ntt_cols

# launches of the CUDA kernel, and calls of the plain version on a CUDA
# tensor (chip_smoke.py reads both around the flagship prove)
LAUNCHES = 0
PLAIN_CUDA_CALLS = 0


@functools.lru_cache(maxsize=None)
def _w_matrix_u64(log_r: int, inverse: bool) -> np.ndarray:
    """The exact radix-R stage matrix, host u64.

    forward:  W[p, j] = ω^{bitrev(p)·j}            (natural -> bitreversed)
    inverse:  W[j, p] = R⁻¹·ω^{-j·bitrev(p)}       (bitreversed -> natural)
    """
    r = 1 << log_r
    omega = gl.domain_generator(log_r)
    rev = bitreverse_indices(log_r)
    out = np.empty((r, r), np.uint64)
    if not inverse:
        for p in range(r):
            base = pow(omega, int(rev[p]), ORDER)
            acc = 1
            for j in range(r):
                out[p, j] = acc
                acc = acc * base % ORDER
    else:
        omega_inv = pow(omega, ORDER - 2, ORDER)
        r_inv = pow(r, ORDER - 2, ORDER)
        for j in range(r):
            base = pow(omega_inv, j, ORDER)
            acc = r_inv
            for p_nat in range(r):
                out[j, rev[p_nat]] = acc
                acc = acc * base % ORDER
    return out


@functools.lru_cache(maxsize=None)
def _stage_twiddles_host(log_r: int, inverse: bool) -> np.ndarray:
    """w^j for j < R/2, w = ω_R (or ω_R⁻¹): the kernel's butterfly table."""
    omega = gl.domain_generator(log_r)
    if inverse:
        omega = gl.s_inv(omega)
    return npgl.powers(omega, (1 << log_r) // 2)


@functools.lru_cache(maxsize=None)
def _stage_twiddles_device(log_r: int, inverse: bool, device) -> torch.Tensor:
    """The butterfly table on ``device``, uploaded once per device."""
    return gl.from_u64(_stage_twiddles_host(log_r, inverse), device)


def _tile_tw(tw: torch.Tensor, m: int) -> torch.Tensor:
    return tw.repeat(1, m // tw.shape[1])


def ntt_stage_plain(x: torch.Tensor, inverse: bool = False,
                    tw: torch.Tensor = None, tw_pre: bool = False):
    """Plain torch version of the kernel: the radix-R butterflies of
    `ntt.ntt_cols` / `ntt.intt_cols`, with the cross twiddle tiled over M."""
    global PLAIN_CUDA_CALLS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    plan = get_plan(x.shape[0].bit_length() - 1)
    if tw is not None and tw_pre:
        x = gl.mul(x, _tile_tw(tw, x.shape[1]))
    out = intt_cols(x, plan) if inverse else ntt_cols(x, plan)
    if tw is not None and not tw_pre:
        out = gl.mul(out, _tile_tw(tw, x.shape[1]))
    return out


def _check(x: torch.Tensor, tw):
    if x.dtype != torch.int64 or x.dim() != 2:
        raise TypeError("ntt stage wants a 2-D int64 field tensor, got %s %s"
                        % (x.dtype, tuple(x.shape)))
    r, m = x.shape
    if r not in (128, 256):
        raise ValueError("ntt stage radix must be 128 or 256, got %d" % r)
    if tw is not None:
        if tw.dtype != torch.int64 or tw.dim() != 2 or tw.shape[0] != r \
                or m % tw.shape[1]:
            raise ValueError("cross twiddle must be int64 (R, W) with W | M")
        if tw.device != x.device:
            raise ValueError("cross twiddle is on %s, input on %s"
                             % (tw.device, x.device))


def ntt_cols_matmul(x: torch.Tensor, inverse: bool = False,
                    tw: torch.Tensor = None, tw_pre: bool = False):
    """The radix-R stage of `_w_matrix_u64` on (R, M); see the module doc.
    CPU tensors run `ntt_stage_plain`; CUDA tensors launch the kernel."""
    global LAUNCHES
    _check(x, tw)
    if x.device.type == "cpu":
        return ntt_stage_plain(x, inverse, tw, tw_pre)
    if x.device.type != "cuda":
        raise RuntimeError("ntt stage has no kernel for device %s" % x.device)
    from ..utils import cuda_build

    r, m = x.shape
    log_r = r.bit_length() - 1
    fn = cuda_build.load("ntt_stage").ntt_stage
    x = x.contiguous()
    y = torch.empty_like(x)
    table = _stage_twiddles_device(log_r, inverse, x.device)
    twmode = 0 if tw is None else (2 if tw_pre else 1)
    twc = tw.contiguous() if tw is not None else None
    scale = gl.s_inv(r) if inverse else 1
    rc = fn(x.data_ptr(), y.data_ptr(), table.data_ptr(),
            twc.data_ptr() if twc is not None else None, log_r, m,
            int(inverse), twmode, twc.shape[1] if twc is not None else 1,
            scale, cuda_build.stream_handle(x))
    cuda_build.check(rc, "ntt_stage")
    LAUNCHES += 1
    return y
