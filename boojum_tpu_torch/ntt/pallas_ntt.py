# Port of boojum_tpu/ntt/pallas_ntt.py: the all-stage small NTT, kernel K4.
"""All radix-2 stages of a small NTT in one kernel, and the four-step
recursion that builds any power-of-two size from it.

`ntt_small` transforms axis 0 of an ``(n, B)`` int64 field tensor, n ≤ 4096
on the GPU: forward natural -> bitreversed (DIF), inverse bitreversed ->
natural times n⁻¹, the semantics of `ntt.ntt_cols` / `ntt.intt_cols`. A
forward call may take a cross-twiddle table ``tw`` of shape
``(n, B >> tw_shift)``: the output is then ``NTT(x)[r, c] · tw[r, c >>
tw_shift]``. On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/ntt_small.cu`` (which replaces
`boojum_tpu/ntt/pallas_ntt.py:_kernel_body`): each element is read once and
written once, the stages run in registers with at most three exchanges
through shared memory, and the twiddle multiply happens at the store. On a
CPU tensor it runs `ntt_small_plain`, the same function in plain torch. Any
B ≥ 1 works; the tile width is the kernel's business.

`ntt_any` and `ntt_fourstep` keep the reference's routing (passes of at most
2^MAX_SMALL_LOG rows, the same splits and transposes), so the launches and
their shapes are the TPU path's. Where the reference multiplies the cross
twiddles between the passes as a separate jnp pass, the port hands each
table to the store of the kernel launch that produces those rows: a
four-step's own table to its first pass, and a table it was given for its
output to its second pass, re-laid into that pass's coordinates.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from ..utils import npgl
from .ntt import fourstep_twiddles_device, get_plan, intt_cols, ntt_cols

# launches of the CUDA kernel, calls of the plain version on a CUDA tensor,
# and torch field multiplies by a cross twiddle on a CUDA tensor (which only
# the plain version does); chip_smoke.py reads all three around the NTT path
LAUNCHES = 0
PLAIN_CUDA_CALLS = 0
TORCH_TWIDDLE_MULS = 0

MAX_KERNEL_LOG = 12  # the kernel's limit
MAX_SMALL_LOG = 9  # the reference's pass size for the recursion


def _stage_tables_host(log_n: int, inverse: bool) -> np.ndarray:
    """Concatenated per-stage twiddles, shape (n-1,) u64 (+1 pad slot):
    stage k holds ω^{j·2^k} (ω⁻¹ for the inverse), j < n >> (k+1)."""
    n = 1 << log_n
    omega = gl.domain_generator(log_n)
    if inverse:
        omega = pow(omega, ORDER - 2, ORDER)
    full = npgl.powers(omega, max(n // 2, 1))
    parts = [np.ascontiguousarray(full[:: 1 << k][:n >> (k + 1)])
             for k in range(log_n)]
    out = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    return np.concatenate([out, np.zeros(1, np.uint64)])  # pad to n


@functools.lru_cache(maxsize=None)
def _stage_tables_device(log_n: int, inverse: bool, device) -> torch.Tensor:
    """The stage table on ``device``, uploaded once per device."""
    return gl.from_u64(_stage_tables_host(log_n, inverse), device)


def _check_twiddle(x: torch.Tensor, tw: torch.Tensor, tw_shift: int,
                   inverse: bool):
    n, b = x.shape
    if inverse:
        raise ValueError("ntt_small: the cross twiddle is forward only")
    if tw_shift < 0 or b % (1 << tw_shift):
        raise ValueError("ntt_small: B = %d is not a multiple of 2^%d"
                         % (b, tw_shift))
    if tw.dtype != torch.int64 or tuple(tw.shape) != (n, b >> tw_shift):
        raise ValueError("ntt_small: twiddle table %s %s, want int64 %s"
                         % (tw.dtype, tuple(tw.shape), (n, b >> tw_shift)))
    if tw.device != x.device or not tw.is_contiguous():
        raise ValueError("ntt_small: the twiddle table must be contiguous "
                         "on %s" % x.device)


def ntt_small_plain(x: torch.Tensor, log_n: int, inverse: bool = False,
                    tw: torch.Tensor = None, tw_shift: int = 0):
    """Plain torch version of the kernel: the butterflies of `ntt.ntt_cols`
    / `ntt.intt_cols`, then the cross twiddle."""
    global PLAIN_CUDA_CALLS, TORCH_TWIDDLE_MULS
    if x.is_cuda:
        PLAIN_CUDA_CALLS += 1
    plan = get_plan(log_n)
    y = intt_cols(x, plan) if inverse else ntt_cols(x, plan)
    if tw is None:
        return y
    if x.is_cuda:
        TORCH_TWIDDLE_MULS += 1
    n, b = y.shape
    return gl.mul(y.reshape(n, b >> tw_shift, 1 << tw_shift),
                  tw[:, :, None]).reshape(n, b)


def ntt_small(x: torch.Tensor, log_n: int, inverse: bool = False,
              tw: torch.Tensor = None, tw_shift: int = 0):
    """NTT along axis 0 of (2^log_n, B), times ``tw[r, c >> tw_shift]`` when
    a (forward) twiddle table is given; see the module doc. CPU tensors run
    `ntt_small_plain`; CUDA tensors launch the kernel (log_n ≤ 12)."""
    global LAUNCHES
    if x.dtype != torch.int64 or x.dim() != 2:
        raise TypeError("ntt_small wants a 2-D int64 field tensor, got %s %s"
                        % (x.dtype, tuple(x.shape)))
    if x.shape[0] != 1 << log_n:
        raise ValueError("ntt_small: %d rows is not 2^%d" % (x.shape[0], log_n))
    if tw is not None:
        _check_twiddle(x, tw, tw_shift, inverse)
    if x.device.type == "cpu":
        return ntt_small_plain(x, log_n, inverse, tw, tw_shift)
    if x.device.type != "cuda":
        raise RuntimeError("ntt_small has no kernel for device %s" % x.device)
    if log_n > MAX_KERNEL_LOG:
        raise ValueError("ntt_small's kernel takes n ≤ 2^%d, got 2^%d"
                         % (MAX_KERNEL_LOG, log_n))
    from ..utils import cuda_build

    fn = cuda_build.load("ntt_small").ntt_small
    x = x.contiguous()
    y = torch.empty_like(x)
    table = _stage_tables_device(log_n, inverse, x.device)
    rc = fn(x.data_ptr(), y.data_ptr(), table.data_ptr(),
            None if tw is None else tw.data_ptr(), log_n, x.shape[1],
            int(inverse), tw_shift if tw is not None else 0,
            cuda_build.stream_handle(x))
    cuda_build.check(rc, "ntt_small")
    LAUNCHES += 1
    return y


def ntt_any(x: torch.Tensor, log_n: int, tw: torch.Tensor = None,
            tw_shift: int = 0) -> torch.Tensor:
    """Forward NTT natural -> bitreversed for any 2^log_n, recursing through
    the four-step decomposition until passes have at most 2^MAX_SMALL_LOG
    rows; times ``tw[r, c >> tw_shift]`` when a table is given."""
    if log_n <= MAX_SMALL_LOG:
        return ntt_small(x, log_n, tw=tw, tw_shift=tw_shift)
    log_n1 = min(MAX_SMALL_LOG, log_n - 1)
    if log_n - log_n1 > MAX_SMALL_LOG:
        log_n1 = log_n // 2
    return ntt_fourstep(x, log_n, log_n1, tw, tw_shift)


@functools.lru_cache(maxsize=16)
def relaid_twiddles(out_tw: torch.Tensor, log_n1: int) -> torch.Tensor:
    """A four-step's table in output coordinates, (n1·n2, b >> s), laid out
    for its second pass, whose rows are p2 and columns (p1, c):
    ``out_tw.reshape(n1, n2, b >> s).transpose(0, 1).reshape(n2, -1)``.
    Made once per table and kept (128 MB for the outer table at 2^24)."""
    n1 = 1 << log_n1
    cols = out_tw.shape[1]
    return out_tw.reshape(n1, -1, cols).transpose(0, 1).reshape(
        out_tw.shape[0] // n1, n1 * cols).contiguous()


def ntt_fourstep(x: torch.Tensor, log_n: int, log_n1: int = None,
                 out_tw: torch.Tensor = None, out_shift: int = 0):
    """Forward NTT (natural -> bitreversed) of (n, B) via two passes over
    n = n1·n2 (default n1 = 2^⌈log_n / 2⌉), times ``out_tw[r, c >>
    out_shift]`` when a table is given.

    With j = j1·n2 + j2 and k = k1 + n1·k2,
      ω^{jk} = ω_{n1}^{j1·k1} · ω_n^{j2·k1} · ω_{n2}^{j2·k2},
    so   A[k1, j2] = NTT_{n1} over j1,
         B[k1, k2] = NTT_{n2} over j2 of (A[k1, j2] · ω_n^{j2·k1}).
    Both passes emit bitreversed rows (p1 ↦ bitrev k1, p2 ↦ bitrev k2), so
    the row-major flatten of B'[p1, p2] is the full bitreversed output. The
    cross twiddle ω_n^{j2·k1} is multiplied in pass 1's store: its column
    j2·B + c takes table column j2 = column >> log2 B (B a power of two; any
    other B gets the table widened to one column per output column).
    """
    n, b = x.shape
    if n != 1 << log_n:
        raise ValueError("ntt_fourstep: %d rows is not 2^%d" % (n, log_n))
    if log_n1 is None:
        log_n1 = (log_n + 1) // 2
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    w = fourstep_twiddles_device(log_n1, log_n2, False, x.device)
    if b & (b - 1):
        w, w_shift = w.repeat_interleave(b, dim=1), 0
    else:
        w_shift = b.bit_length() - 1
    # pass 1: NTT_{n1} over j1 (the slow index of j), batched over (j2, c)
    s1 = ntt_any(x.reshape(n1, n2 * b), log_n1, w, w_shift)
    # pass 2: NTT_{n2} over j2, moved to axis 0
    tw2 = None if out_tw is None else relaid_twiddles(out_tw, log_n1)
    s2 = ntt_any(s1.reshape(n1, n2, b).transpose(0, 1).reshape(n2, n1 * b),
                 log_n2, tw2, out_shift)
    return s2.reshape(n2, n1, b).transpose(0, 1).reshape(n, b)
