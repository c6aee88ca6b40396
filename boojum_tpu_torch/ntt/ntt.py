# Port of boojum_tpu/ntt/ntt.py (with pallas_ntt._fourstep_twiddles_host).
"""Radix-2 NTT / iNTT / LDE over Goldilocks on torch tensors.

Semantics (reference src/fft/mod.rs :398 / :464):

    ntt_cols(x)[i, l]  = f_l(ω^{bitrev(i)})     natural in, bitreversed out
    intt_cols(y)       = inverse of the above    bitreversed in, natural out

The primitive transforms axis 0 of an ``(n, B)`` int64 field tensor; B is a
batch of polynomial columns. Large transforms go through the four-step
decomposition (`ntt_fourstep_cols`): every pass of 128 or 256 rows is one
radix stage of `mxu_ntt.ntt_cols_matmul` (the Hopper `ntt_stage` kernel on
the GPU), passes of other sizes run the butterflies below, exactly as the
TPU route of the reference splits them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from ..utils import npgl


def bitreverse_indices(log_n: int) -> np.ndarray:
    """Host-side bitreversal permutation (reference src/fft/mod.rs:41)."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _bitreverse_device(log_n: int, device) -> torch.Tensor:
    return torch.from_numpy(bitreverse_indices(log_n)).to(device)


def bitreverse(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Apply the bitreversal permutation along ``dim``."""
    n = x.shape[dim]
    return x.index_select(dim, _bitreverse_device(n.bit_length() - 1,
                                                  x.device))


@functools.lru_cache(maxsize=None)
def _powers_u64(base: int, count: int) -> np.ndarray:
    """Exact host table [base^0, ..., base^(count-1)] mod p."""
    return npgl.powers(base, count)


class NttPlan:
    """Host twiddle tables for one domain size, one per butterfly stage:
    stage k uses ω^{j·2^k} for j < n >> (k+1)."""

    def __init__(self, log_n: int):
        self.log_n = log_n
        n = 1 << log_n
        self.n = n
        omega = gl.domain_generator(log_n)
        self.omega = omega
        self.n_inv = gl.s_inv(n)
        fwd_full = _powers_u64(omega, max(n // 2, 1))
        inv_full = _powers_u64(gl.s_inv(omega), max(n // 2, 1))
        self._device_twiddles = {}
        self.fwd_twiddles_host = []
        self.inv_twiddles_host = []
        for k in range(log_n):
            half = n >> (k + 1)
            self.fwd_twiddles_host.append(np.ascontiguousarray(fwd_full[:: 1 << k][:half]))
            self.inv_twiddles_host.append(np.ascontiguousarray(inv_full[:: 1 << k][:half]))

    def twiddle(self, k: int, inverse: bool, device) -> torch.Tensor:
        """Stage k's twiddles on ``device``, uploaded once per device (an
        upload per call would make the host wait for the device)."""
        key = (k, inverse, str(device))
        if key not in self._device_twiddles:
            host = self.inv_twiddles_host[k] if inverse \
                else self.fwd_twiddles_host[k]
            self._device_twiddles[key] = gl.from_u64(host, device)
        return self._device_twiddles[key]


@functools.lru_cache(maxsize=None)
def get_plan(log_n: int) -> NttPlan:
    return NttPlan(log_n)


def _butterfly_fwd(x, tw, k: int, n: int, batch: int):
    half = n >> (k + 1)
    x = x.reshape(1 << k, 2, half, batch)
    u = x[:, 0]
    v = x[:, 1]
    s = gl.add(u, v)
    t = gl.mul(gl.sub(u, v), tw[None, :, None])
    return torch.stack([s, t], dim=1).reshape(n, batch)


def _butterfly_inv(x, tw, k: int, n: int, batch: int):
    half = n >> (k + 1)
    x = x.reshape(1 << k, 2, half, batch)
    s = x[:, 0]
    t = x[:, 1]
    tv = gl.mul(t, tw[None, :, None])
    return torch.stack([gl.add(s, tv), gl.sub(s, tv)], dim=1).reshape(n, batch)


def ntt_cols(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward NTT along axis 0 of (n, B): natural coeffs -> bitreversed evals."""
    n, batch = x.shape
    assert n == plan.n
    for k in range(plan.log_n):
        x = _butterfly_fwd(x, plan.twiddle(k, False, x.device), k, n, batch)
    return x


def intt_cols(y: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse NTT along axis 0 of (n, B): bitreversed evals -> natural coeffs."""
    n, batch = y.shape
    assert n == plan.n
    for k in reversed(range(plan.log_n)):
        y = _butterfly_inv(y, plan.twiddle(k, True, y.device), k, n, batch)
    return gl.mul(y, plan.n_inv)


@functools.lru_cache(maxsize=None)
def _powers_device(base: int, n: int, device) -> torch.Tensor:
    return gl.from_u64(_powers_u64(base, n), device)


def distribute_powers(x: torch.Tensor, base: int) -> torch.Tensor:
    """x[i, :] *= base^i (reference src/fft/mod.rs:308)."""
    return gl.mul(x, _powers_device(base, x.shape[0], x.device)[:, None])


def coset_ntt_cols(x, coset: int, plan: NttPlan):
    """Evals of f on the coset ``coset·<ω>`` in bitreversed order."""
    if coset != 1:
        x = distribute_powers(x, coset)
    return ntt_cols(x, plan)


def coset_intt_cols(y, coset: int, plan: NttPlan):
    """Inverse of :func:`coset_ntt_cols`."""
    x = intt_cols(y, plan)
    if coset != 1:
        x = distribute_powers(x, gl.s_inv(coset))
    return x


def lde_cosets(log_n: int, lde_factor: int) -> list[int]:
    """The coset shifts g·ω_{n·lde}^{bitrev_lde(k)}, k < lde_factor, in the
    order whose concatenated per-coset bitreversed evaluations equal the
    bitreversed evaluation of f over g·<ω_{n·lde}> (reference
    src/cs/implementations/utils.rs:311)."""
    full_log = log_n + (lde_factor.bit_length() - 1)
    omega_big = gl.domain_generator(full_log)
    g = gl.MULTIPLICATIVE_GENERATOR
    log_lde = lde_factor.bit_length() - 1
    rev = bitreverse_indices(log_lde) if log_lde > 0 else np.array([0])
    return [gl.s_mul(g, gl.s_pow(omega_big, int(rev[k]))) for k in range(lde_factor)]


# ---------------------------------------------------------------------------
# four-step
# ---------------------------------------------------------------------------


def _pass_ntt(xv, log_r: int, inverse: bool = False):
    """One four-step pass: transform axis 0 of (2^log_r, M). Radix 128/256
    runs the `ntt_stage` kernel, larger passes recurse, smaller ones run the
    butterflies (the reference's TPU route, ntt.py:222-232)."""
    if log_r in (7, 8):
        from .mxu_ntt import ntt_cols_matmul
        return ntt_cols_matmul(xv, inverse=inverse)
    if log_r > 8:
        return (intt_fourstep_cols if inverse else ntt_fourstep_cols)(xv)
    plan = get_plan(log_r)
    return intt_cols(xv, plan) if inverse else ntt_cols(xv, plan)


def _fourstep_split(log_n: int) -> int:
    """log_n1: radix-256 first passes above 2^16, balanced otherwise."""
    if log_n > 16:
        return 8
    return (log_n + 1) // 2


@functools.lru_cache(maxsize=None)
def fourstep_twiddles_host(log_n1: int, log_n2: int,
                           inverse: bool = False) -> np.ndarray:
    """w[p1, j2] = ω_n^{bitrev_{n1}(p1)·j2}, u64 (n1, n2): the cross twiddles
    between the passes (pallas_ntt._fourstep_twiddles_host); their
    inverses with ``inverse``."""
    n1, n2 = 1 << log_n1, 1 << log_n2
    if inverse:
        w = fourstep_twiddles_host(log_n1, log_n2)
        return npgl.batch_inv(w.reshape(-1)).reshape(n1, n2)
    omega = gl.domain_generator(log_n1 + log_n2)
    rev = bitreverse_indices(log_n1)
    return np.stack([npgl.powers(pow(omega, int(rev[p1]), ORDER), n2)
                     for p1 in range(n1)])


@functools.lru_cache(maxsize=None)
def fourstep_twiddles_device(log_n1: int, log_n2: int, inverse: bool,
                             device) -> torch.Tensor:
    """`fourstep_twiddles_host` on ``device``, made and uploaded once per
    (shape, direction, device) and kept there (128 MB at 2^24)."""
    return gl.from_u64(fourstep_twiddles_host(log_n1, log_n2, inverse), device)


def _pass_tw_fwd(xv, log_r: int, tw):
    """Forward pass + cross twiddle: stage(xv)[r, l] * tw[r, l % W]."""
    if log_r in (7, 8):
        from .mxu_ntt import ntt_cols_matmul
        return ntt_cols_matmul(xv, tw=tw)
    s = _pass_ntt(xv, log_r)
    return gl.mul(s, tw.repeat(1, s.shape[1] // tw.shape[1]))


def _pass_tw_inv(s1, log_r: int, wi):
    """Inverse cross twiddle + inverse pass: istage(s1 * wi)."""
    if log_r in (7, 8):
        from .mxu_ntt import ntt_cols_matmul
        return ntt_cols_matmul(s1, inverse=True, tw=wi, tw_pre=True)
    s1 = gl.mul(s1, wi.repeat(1, s1.shape[1] // wi.shape[1]))
    return _pass_ntt(s1, log_r, inverse=True)


def ntt_fourstep_cols(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT (natural -> bitreversed) of one large (n, B) batch by the
    four-step decomposition. With j = j1·n2 + j2, k = k1 + n1·k2 and both
    passes emitting bitreversed rows, the row-major (p1, p2) flatten is the
    full bitreversed output. Lanes are batch-major (c, j2): the cross
    twiddle of lane l is column l % n2 of the (n1, n2) table."""
    n, b = x.shape
    log_n = n.bit_length() - 1
    log_n1 = _fourstep_split(log_n)
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    tw = fourstep_twiddles_device(log_n1, log_n2, False, x.device)
    xv = x.reshape(n1, n2, b).transpose(1, 2).reshape(n1, b * n2)
    s1 = _pass_tw_fwd(xv, log_n1, tw)  # rows p1, lanes (c, j2)
    s1t = s1.reshape(n1, b, n2).permute(2, 1, 0).reshape(n2, b * n1)
    s2 = _pass_ntt(s1t, log_n2)  # rows p2, lanes (c, p1)
    return s2.reshape(n2, b, n1).permute(2, 0, 1).reshape(n, b)


def intt_fourstep_cols(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`ntt_fourstep_cols`: inverse passes in reverse order,
    dividing the cross twiddles."""
    n, b = y.shape
    log_n = n.bit_length() - 1
    log_n1 = _fourstep_split(log_n)
    log_n2 = log_n - log_n1
    n1, n2 = 1 << log_n1, 1 << log_n2
    wi = fourstep_twiddles_device(log_n1, log_n2, True, y.device)
    s2t = y.reshape(n1, n2, b).permute(1, 2, 0).reshape(n2, b * n1)
    s1t = _pass_ntt(s2t, log_n2, inverse=True)  # rows j2, lanes (c, p1)
    s1 = s1t.reshape(n2, b, n1).permute(2, 1, 0).reshape(n1, b * n2)
    x = _pass_tw_inv(s1, log_n1, wi)  # rows j1, lanes (c, j2)
    return x.reshape(n1, b, n2).permute(0, 2, 1).reshape(n, b)


def coset_intt_fourstep_cols(y, coset: int):
    """coset_intt_cols via the four-step inverse (large single polys)."""
    x = intt_fourstep_cols(y)
    if coset != 1:
        x = distribute_powers(x, gl.s_inv(coset))
    return x
