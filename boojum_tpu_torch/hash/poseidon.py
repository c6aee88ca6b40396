# Port of boojum_tpu/hash/poseidon.py: the tensor and scalar permutations,
# the wrapper of the transcript-sponge kernel K6, and the wrappers of the
# Merkle tree's leaf and node kernels.
"""Classic Poseidon permutation over Goldilocks, width 12 (Plonky2-compatible).

Reference behavior: src/implementations/poseidon_goldilocks_naive.rs (full and
partial rounds at :123-147, MDS circulant of powers of two, constants shared
with Poseidon2). Used by the ``GoldilocksPoisedonTranscript`` (reference
transcript.rs:131-139) and by the classic-Poseidon Merkle trees.

- `permutation_stacked`: B states stacked as a (12, B) int64 tensor, in plain
  torch (the counterpart of `permutation_gl` / `_permutation_rolled_gl`);
- `sponge_absorb` / `sponge_permute`: the device transcript's sponge on ONE
  (12,) state, one launch of the Hopper kernel ``csrc/poseidon.cu`` on a CUDA
  tensor (entries ``poseidon_absorb``, ``poseidon_permute``; it replaces the
  permutation inside `boojum_tpu/prover/device_transcript.py` `_flush_jit`,
  `_perm_jit` and `_ext_extract_cross_jit`), their plain versions
  `sponge_absorb_plain` / `sponge_permute_plain` on a CPU tensor;
- `leaf_hashes` / `node_layer`: the Merkle tree of the ``"poseidon"`` tree
  hasher, (k, m) leaf columns -> (4, m) leaf hashes and (4, m) -> (4, m/2)
  parents, one launch each of the entries ``poseidon_leaf_hashes`` /
  ``poseidon_node_layer`` of ``csrc/poseidon.cu`` on a CUDA tensor (they
  replace the batched jnp sponge of `boojum_tpu/hash/sponge.py`
  `hash_leaves` / `hash_nodes` behind the reference's host
  `AlgebraicMerkleTree`), their plain versions `leaf_hashes_plain` /
  `node_layer_plain` (`sponge.hash_leaves` / `hash_nodes`) on a CPU tensor;
- `s_permutation`: the exact Python-int twin of the host transcript.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from . import _poseidon_constants as C
from . import sponge
from .poseidon2 import _s_sbox7, _sbox7  # same x^7 S-box

STATE_WIDTH = C.STATE_WIDTH
RATE = C.RATE
CAPACITY = C.CAPACITY

_RC = C.ALL_ROUND_CONSTANTS
_R_F_HALF = C.HALF_NUM_FULL_ROUNDS
_R_P = C.NUM_PARTIAL_ROUNDS
_EXPS = C.MDS_MATRIX_EXPS

# MDS[row][col] = 2^EXPS[(12 - row + col) % 12]
_MDS_POW = [[1 << _EXPS[(12 - r + c) % 12] for c in range(12)] for r in range(12)]

# launches of the sponge kernel's two entries, of the tree's leaf and node
# entries, and calls of a plain version on a CUDA tensor (chip_smoke.py reads
# them around each path)
LAUNCHES = 0
LEAF_LAUNCHES = 0
NODE_LAUNCHES = 0
PLAIN_CUDA_CALLS = 0
# launches by shape: ("absorb", rate blocks), ("permute",), ("leaf", k, m)
# or ("node", m)
SHAPES = collections.Counter()


# ----------------------------------------------------------------------------
# Batched torch permutation on a stacked (12, B) state
# ----------------------------------------------------------------------------


_M32 = 0xFFFFFFFF


def _mds_stacked(st: torch.Tensor) -> torch.Tensor:
    """The circulant on (12, B): row r is sum_c st[c] * 2^e[r][c], summed
    exactly as two int64 sums of 32-bit halves times 2^e (< 2^52 each), then
    reduced with 2^64 = 2^32 - 1 (mod p)."""
    exps = torch.tensor([[_EXPS[(12 - r + c) % 12] for c in range(12)]
                         for r in range(12)], dtype=torch.int64,
                        device=st.device)[:, :, None]
    lo = ((st & _M32)[None] << exps).sum(1)  # (12, B), < 2^52
    hi = ((gl._lsr32(st))[None] << exps).sum(1)
    # value = lo + hi * 2^32, hi = a * 2^32 + b: b * 2^32 + a * (2^32 - 1)
    a, b = hi >> 32, hi & _M32
    out = gl.add(lo, gl.canonicalize(b << 32))
    return gl.sub(gl.add(out, a << 32), a)


def _rc_column(r: int, device) -> torch.Tensor:
    return torch.tensor([gl.i64(c) for c in _RC[r * 12:(r + 1) * 12]],
                        dtype=torch.int64, device=device)[:, None]


def permutation_stacked(st: torch.Tensor) -> torch.Tensor:
    """Poseidon on a canonical (12, B) int64 state -> canonical (12, B)."""
    for r in range(2 * _R_F_HALF + _R_P):
        st = gl.add(st, _rc_column(r, st.device))
        if _R_F_HALF <= r < _R_F_HALF + _R_P:
            st = torch.cat([_sbox7(st[:1]), st[1:]])
        else:
            st = _sbox7(st)
        st = _mds_stacked(st)
    return st


# ----------------------------------------------------------------------------
# The transcript sponge (kernel K6) on one (12,) state
# ----------------------------------------------------------------------------


def _count_plain(t: torch.Tensor):
    global PLAIN_CUDA_CALLS
    if t.is_cuda:
        PLAIN_CUDA_CALLS += 1


def pad_blocks(elements: torch.Tensor) -> torch.Tensor:
    """(k,) elements -> (ceil((k + 1) / RATE), RATE) canonical rate blocks
    with the rescue-prime pad: a one after the elements, then zeros."""
    k = elements.shape[0]
    nblocks = (k + RATE) // RATE
    out = elements.new_zeros(nblocks * RATE)
    out[:k] = gl.canonicalize(elements)
    out[k].fill_(1)  # (an indexed assignment would sync on the card)
    return out.reshape(nblocks, RATE)


def sponge_absorb_plain(state: torch.Tensor, elements: torch.Tensor
                        ) -> torch.Tensor:
    """The plain torch version of ``poseidon_absorb``."""
    return sponge_absorb_plain_many(state[:, None], [elements])[:, 0]


def sponge_absorb_plain_many(states: torch.Tensor, elements: list
                             ) -> torch.Tensor:
    """``sponge_absorb_plain`` of B states (12, B) and B element tensors of
    any lengths at once: one stacked permutation per rate block, a lane
    keeping its state once its own blocks are done."""
    _count_plain(states)
    blocks = [pad_blocks(e) for e in elements]
    most = max(b.shape[0] for b in blocks)
    nblocks = torch.tensor([b.shape[0] for b in blocks], device=states.device)
    padded = torch.stack([torch.cat([b, b.new_zeros((most - b.shape[0], RATE))])
                          for b in blocks], dim=2)  # (most, RATE, B)
    st = states
    for i in range(most):
        new = permutation_stacked(torch.cat([padded[i], st[RATE:]]))
        st = torch.where(nblocks > i, new, st)
    return st


def sponge_permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``poseidon_permute``."""
    _count_plain(state)
    return permutation_stacked(state[:, None])[:, 0]


_TABLES = {}  # device -> the kernel's round constants on it


def _table(device) -> torch.Tensor:
    """The round constants, round-major, uploaded once per device (the MDS
    exponents are compile-time constants of the kernel)."""
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = gl.from_u64(np.asarray(_RC, np.uint64), device)
    return _TABLES[key]


def _check(state: torch.Tensor, elements: torch.Tensor = None):
    if state.dtype != torch.int64 or tuple(state.shape) != (STATE_WIDTH,):
        raise TypeError("the Poseidon sponge wants a (12,) int64 state, got "
                        "%s %s" % (state.dtype, tuple(state.shape)))
    if elements is not None:
        if elements.dtype != torch.int64 or elements.dim() != 1:
            raise TypeError("the Poseidon sponge absorbs a 1-D int64 tensor, "
                            "got %s %s" % (elements.dtype,
                                           tuple(elements.shape)))
        if elements.device != state.device:
            raise ValueError("state and elements lie on %s and %s"
                             % (state.device, elements.device))
    if state.device.type not in ("cpu", "cuda"):
        raise RuntimeError("the Poseidon sponge has no kernel for device %s"
                           % state.device)


def sponge_absorb(state: torch.Tensor, elements: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode absorb of the (k,) elements, padded with a one and
    zeros to whole rate blocks, into the (12,) state -> the new state."""
    global LAUNCHES
    _check(state, elements)
    if state.device.type == "cpu":
        return sponge_absorb_plain(state, elements)
    from ..utils import cuda_build

    lib = cuda_build.load("poseidon")
    state, elements = state.contiguous(), elements.contiguous()
    out = torch.empty_like(state)
    k = elements.shape[0]
    rc = lib.poseidon_absorb(state.data_ptr(), elements.data_ptr(), k,
                             out.data_ptr(), _table(state.device).data_ptr(),
                             cuda_build.stream_handle(state))
    cuda_build.check(rc, "poseidon_absorb")
    LAUNCHES += 1
    SHAPES[("absorb", (k + RATE) // RATE)] += 1
    return out


def sponge_permute(state: torch.Tensor) -> torch.Tensor:
    """The permutation of one (12,) state."""
    global LAUNCHES
    _check(state)
    if state.device.type == "cpu":
        return sponge_permute_plain(state)
    from ..utils import cuda_build

    lib = cuda_build.load("poseidon")
    state = state.contiguous()
    out = torch.empty_like(state)
    rc = lib.poseidon_permute(state.data_ptr(), out.data_ptr(),
                              _table(state.device).data_ptr(),
                              cuda_build.stream_handle(state))
    cuda_build.check(rc, "poseidon_permute")
    LAUNCHES += 1
    SHAPES[("permute",)] += 1
    return out


# ----------------------------------------------------------------------------
# The Merkle tree's leaf and node hashes on m independent sponges
# ----------------------------------------------------------------------------


def leaf_hashes_plain(cols: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``poseidon_leaf_hashes``."""
    _count_plain(cols)
    return sponge.hash_leaves(cols, "poseidon")


def node_layer_plain(cur: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``poseidon_node_layer``."""
    _count_plain(cur)
    return sponge.hash_nodes(cur[:, 0::2], cur[:, 1::2], "poseidon")


def _check_tree(t: torch.Tensor, what: str, rows=None):
    if t.dtype != torch.int64 or t.dim() != 2 or \
            (rows is not None and t.shape[0] != rows):
        raise TypeError("the Poseidon tree wants %s as a 2-D int64 tensor%s, "
                        "got %s %s" % (what, "" if rows is None
                                       else " of %d rows" % rows, t.dtype,
                                       tuple(t.shape)))
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError("the Poseidon tree has no kernel for device %s"
                           % t.device)


def leaf_hashes(cols: torch.Tensor) -> torch.Tensor:
    """Leaf hashes (4, m) of canonical leaf columns (k, m), k >= 1: leaf i
    is column i, absorbed in overwrite mode from the zero state, the last
    rate block zero-filled."""
    global LEAF_LAUNCHES
    _check_tree(cols, "the leaf columns")
    if cols.device.type == "cpu":
        return leaf_hashes_plain(cols)
    from ..utils import cuda_build

    k, m = cols.shape
    if k < 1 or m < 1:
        raise ValueError("no leaves to hash: (%d, %d)" % (k, m))
    if cols.stride(1) != 1 or (k > 1 and cols.stride(0) < m):
        cols = cols.contiguous()
    ld = cols.stride(0) if k > 1 else m
    lib = cuda_build.load("poseidon")
    out = cols.new_empty((CAPACITY, m))
    rc = lib.poseidon_leaf_hashes(cols.data_ptr(), out.data_ptr(), k, m, ld,
                                  _table(cols.device).data_ptr(),
                                  cuda_build.stream_handle(cols))
    cuda_build.check(rc, "poseidon_leaf_hashes")
    LEAF_LAUNCHES += 1
    SHAPES[("leaf", k, m)] += 1
    return out


def node_layer(cur: torch.Tensor) -> torch.Tensor:
    """(4, m) canonical nodes, m even -> (4, m/2) parents: the hash of each
    (left, right) sibling pair."""
    global NODE_LAUNCHES
    _check_tree(cur, "the node layer", CAPACITY)
    m = cur.shape[1]
    if m % 2 or m == 0:
        raise ValueError("a node layer needs an even width, got %d" % m)
    if cur.device.type == "cpu":
        return node_layer_plain(cur)
    from ..utils import cuda_build

    cur = cur.contiguous()
    if cur.data_ptr() % 16:  # the kernel reads each pair with one 16-byte load
        cur = cur.clone()
    lib = cuda_build.load("poseidon")
    out = cur.new_empty((CAPACITY, m // 2))
    rc = lib.poseidon_node_layer(cur.data_ptr(), out.data_ptr(), m,
                                 _table(cur.device).data_ptr(),
                                 cuda_build.stream_handle(cur))
    cuda_build.check(rc, "poseidon_node_layer")
    NODE_LAUNCHES += 1
    SHAPES[("node", m)] += 1
    return out


# ----------------------------------------------------------------------------
# Exact scalar twin
# ----------------------------------------------------------------------------


def _s_mds(state):
    return [sum(state[c] * _MDS_POW[r][c] for c in range(12)) % ORDER for r in range(12)]


def s_permutation(state: list[int]) -> list[int]:
    assert len(state) == STATE_WIDTH
    r = 0
    for _ in range(_R_F_HALF):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(s) for s in state]
        state = _s_mds(state)
        r += 1
    for _ in range(_R_P):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(state[0])] + state[1:]
        state = _s_mds(state)
        r += 1
    for _ in range(_R_F_HALF):
        state = [(s + _RC[r * 12 + i]) % ORDER for i, s in enumerate(state)]
        state = [_s_sbox7(s) for s in state]
        state = _s_mds(state)
        r += 1
    return state
