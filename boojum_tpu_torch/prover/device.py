# Port of boojum_tpu/prover/device.py to torch tensors.
"""Column-batch building blocks of the prover on torch tensors.

- column batches are int64 field tensors shaped (n, num_polys): rows on
  axis 0, so the NTT transforms axis 0 and polys ride the batch;
- an LDE is (lde, n, num_polys) with axis 0 in *bitreversed coset
  enumeration*, so flattening axes (0, 1) gives the bitreversed enumeration
  of the full lde·n domain over g·<ω_{lde·n}> (reference GenericLdeStorage);
- transforms run over fixed COL_BLOCK-wide column blocks with the cosets
  folded into the NTT's batch axis, so at 2^16 rows every four-step pass is
  one (256, 8·64·256) `ntt_stage` launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import extension as ext2
from ..field import goldilocks as gl
from ..ntt import ntt
from ..utils import npgl


def to_device_cols(cols_u64: np.ndarray, device) -> torch.Tensor:
    """(num_polys, n) host u64 -> (n, num_polys) int64 tensor on ``device``."""
    return gl.from_u64(np.ascontiguousarray(np.asarray(cols_u64, np.uint64).T),
                       device)


def from_device(a: torch.Tensor) -> np.ndarray:
    return gl.to_u64(a)


COL_BLOCK = 64  # fixed column-block width of every NTT/LDE call


def _blocked(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply fn over COL_BLOCK-wide column blocks of (n, k), padding the
    last block with zero columns; outputs concatenate on their last axis."""
    n, k = x.shape
    outs = []
    for start in range(0, k, COL_BLOCK):
        blk = x[:, start:start + COL_BLOCK]
        pad = COL_BLOCK - blk.shape[1]
        if pad:
            blk = torch.cat([blk, blk.new_zeros((n, pad))], dim=1)
        outs.append(fn(blk.contiguous()))
    return torch.cat(outs, dim=-1)[..., :k]


def _intt_natural(cols: torch.Tensor) -> torch.Tensor:
    log_n = cols.shape[0].bit_length() - 1
    if log_n >= 14:
        return ntt.intt_fourstep_cols(ntt.bitreverse(cols))
    return ntt.intt_cols(ntt.bitreverse(cols), ntt.get_plan(log_n))


def cols_to_monomials(cols: torch.Tensor) -> torch.Tensor:
    """Lagrange values (n, k) on the plain domain -> monomial coeffs (n, k)."""
    return _blocked(_intt_natural, cols)


@functools.lru_cache(maxsize=None)
def _coset_powers_host(log_n: int, lde_factor: int) -> np.ndarray:
    """(lde, n) host u64 powers of each coset shift, bitreversed-coset order."""
    n = 1 << log_n
    return np.stack([npgl.powers(int(c), n)
                     for c in ntt.lde_cosets(log_n, lde_factor)])


def _lde_block(blk: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
    """One (n, B) monomial block -> (lde, n, B). Lanes are (coset, column):
    the coset-scaled copies sit side by side in one (n, lde·B) NTT batch."""
    n, b = blk.shape
    lde_factor = pows.shape[0]
    x = gl.mul(blk.repeat(1, lde_factor), pows.T.repeat_interleave(b, dim=1))
    log_n = n.bit_length() - 1
    if log_n >= 14:
        out = ntt.ntt_fourstep_cols(x)
    else:
        out = ntt.ntt_cols(x, ntt.get_plan(log_n))
    return out.reshape(n, lde_factor, b).transpose(0, 1)


def monomials_to_lde(mono: torch.Tensor, lde_factor: int) -> torch.Tensor:
    """(n, k) monomials -> (lde, n, k) bitreversed coset evals."""
    n = mono.shape[0]
    pows = gl.from_u64(_coset_powers_host(n.bit_length() - 1, lde_factor),
                       mono.device)
    return _blocked(lambda b: _lde_block(b, pows), mono)


# ---------------------------------------------------------------------------
# Extension-field array helpers
# ---------------------------------------------------------------------------


def grand_product_exclusive(ratios):
    """z[0] = 1, z[i] = prod_{k<i} ratios[k] for an ext array (c0, c1)."""
    return ext2.exclusive_prefix_mul(ratios)


def powers_of_ext(z, n: int, device):
    """[z^0 .. z^(n-1)] of the ext scalar z as an (n,) ext array."""
    return ext2.powers(z, n, device)


def eval_monomials_at_ext(mono: torch.Tensor, z_pows) -> list:
    """Σ c_i·z^i for base-coefficient polys (n, k) at an ext point given by
    its (n,) power table; returns one host (c0, c1) int pair per poly."""
    s0 = gl.sum_mod(gl.mul(mono, z_pows[0][:, None]), 0)
    s1 = gl.sum_mod(gl.mul(mono, z_pows[1][:, None]), 0)
    r0 = gl.to_u64(s0)
    r1 = gl.to_u64(s1)
    return [(int(a), int(b)) for a, b in zip(r0, r1)]


def sum_ext(a, dim: int = 0):
    return ext2.sum_mod(a, dim)


# ---------------------------------------------------------------------------
# Domain constants (host)
# ---------------------------------------------------------------------------


def x_poly_lde_host(n: int, lde_factor: int) -> np.ndarray:
    """Values of the identity poly X over the LDE cosets, host u64,
    shape (lde, n) in the standard bitreversed layout."""
    log_n = n.bit_length() - 1
    omega = gl.domain_generator(log_n)
    rev = ntt.bitreverse_indices(log_n)
    base = npgl.powers(omega, n)[rev]  # ω^bitrev(i)
    cosets = ntt.lde_cosets(log_n, lde_factor)
    out = np.empty((lde_factor, n), np.uint64)
    for k, c in enumerate(cosets):
        out[k] = npgl.mul_scalar(base, c)
    return out


def vanishing_inverse_per_coset(n: int, lde_factor: int) -> np.ndarray:
    """(X^n - 1)^{-1} is constant per LDE coset; (lde,) host u64."""
    cosets = ntt.lde_cosets(n.bit_length() - 1, lde_factor)
    out = np.empty(lde_factor, np.uint64)
    for k, c in enumerate(cosets):
        v = (pow(c, n, npgl.ORDER) - 1) % npgl.ORDER
        out[k] = pow(v, npgl.ORDER - 2, npgl.ORDER)
    return out


def unnormalized_l1_lde(n: int, lde_factor: int, device) -> torch.Tensor:
    """(X^n - 1)/(X - 1) over the LDE cosets, (lde, n) on ``device``
    (reference prover.rs unnormalized_l1_inverse; the host original's
    numpy inverse runs here as a tensor inverse)."""
    x = gl.from_u64(x_poly_lde_host(n, lde_factor), device)
    cosets = ntt.lde_cosets(n.bit_length() - 1, lde_factor)
    num = gl.from_u64(np.asarray(
        [(pow(c, n, npgl.ORDER) - 1) % npgl.ORDER for c in cosets],
        np.uint64), device)
    return gl.mul(num[:, None], gl.inverse(gl.sub(x, 1)))
