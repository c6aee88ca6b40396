# Port of boojum_tpu/hash/pallas_poseidon2.py: the batched permutation, kernel K2.
"""Poseidon2 for the Merkle trees: the batched permutation, and the leaf and
node hashes of a tree, each one launch of the Hopper kernel
``csrc/poseidon2.cu`` on a CUDA tensor (it replaces the TPU kernel
`boojum_tpu/hash/pallas_poseidon2.py:_kernel` and, for the trees, the loops
of `boojum_tpu/prover/device_merkle.py` around it).

- `permutation_stacked_fast`: states stacked element-major as a (12, B)
  int64 tensor (entry ``poseidon2_permute``);
- `leaf_hashes`: (k, m) leaf columns -> (4, m) leaf hashes, overwrite-mode
  absorption of the k/8 rate blocks of each column (entry
  ``poseidon2_leaf_hashes``; the kernel keeps the state in registers between
  blocks and reads the rows past k as zero, as the padding to the rate does);
- `node_layers`: (4, m) -> every node layer above it down to the cap, one
  launch a tree, two above `device_bytes_hash.NODE_SPLIT` nodes (entry
  ``poseidon2_node_layers``, ``csrc/byte_tree.cuh``'s schedule; the trees
  of `prover.device_merkle.build_device_tree`);
- `node_layer`: (4, m) -> (4, m/2), the hash of each sibling pair (entry
  ``poseidon2_node_layer``; the sharded trees' layers).

On a CPU tensor each runs its plain torch version (`permutation_plain`,
`leaf_hashes_plain`, `node_layers_plain`, `node_layer_plain`); the TPU's
minimum-batch threshold is gone. Both give the same canonical outputs.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from . import device_bytes_hash as dbh
from . import poseidon2 as p2
from . import sponge

CAP = 4

# launches of each CUDA entry, and calls of a plain version on a CUDA tensor
# (chip_smoke.py reads them around the flagship prove)
LAUNCHES = 0  # poseidon2_permute
LEAF_LAUNCHES = 0
NODE_LAUNCHES = 0
NODE_LAYERS_LAUNCHES = 0
PLAIN_CUDA_CALLS = 0
# launches by (entry, shape): ("permute", B), ("leaf", k, m), ("node", m),
# ("nodes", m, levels)
SHAPES = collections.Counter()

# csrc/poseidon2.cu's ROLL_FROM: a launch of this many one-thread
# permutations side by side or more takes the kernel build whose full rounds
# run their s-boxes in a rolled loop (`rolled`)
ROLL_FROM = 1 << 16

_CONSTANTS_SET = set()  # devices whose constant memory holds the tables


def rolled(n: int) -> bool:
    """Whether a launch of n permutations side by side takes the rolled
    build (as the kernel's entry points pick it)."""
    return n >= ROLL_FROM


def node_layers_rolled(m: int, levels: int) -> bool:
    """Whether a ``poseidon2_node_layers`` launch of ``levels`` layers above
    m nodes takes the rolled build (one thread a state throughout): a wide
    tree's first launch, at most one stage of `device_bytes_hash.NODE_STAGE`
    levels; every other launch takes the unrolled build, its narrow levels
    on 4 lanes a state."""
    return rolled(m // 2) and levels <= dbh.NODE_STAGE


def _count_plain(t: torch.Tensor):
    global PLAIN_CUDA_CALLS
    if t.is_cuda:
        PLAIN_CUDA_CALLS += 1


def permutation_plain(st: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``poseidon2_permute``."""
    _count_plain(st)
    return p2._permutation_stacked(st)


def leaf_hashes_plain(cols: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``poseidon2_leaf_hashes``: one stacked
    permutation per rate-8 block in overwrite mode, the last block padded
    with zeros."""
    _count_plain(cols)
    return sponge.hash_leaves(cols, "poseidon2")


def node_layer_plain(cur: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``poseidon2_node_layer``."""
    _count_plain(cur)
    return sponge.hash_nodes(cur[:, 0::2], cur[:, 1::2], "poseidon2")


def node_layers_plain(cur: torch.Tensor, cap_size: int) -> list:
    """The plain torch version of ``poseidon2_node_layers``: one
    `node_layer_plain` a layer."""
    layers = []
    for _ in dbh.node_widths(cur.shape[1], cap_size):
        cur = node_layer_plain(cur)
        layers.append(cur)
    return layers


def _lib(device):
    from ..utils import cuda_build

    lib = cuda_build.load("poseidon2")
    key = torch.device(device).index or 0
    if key not in _CONSTANTS_SET:
        rc = np.asarray(p2._RC, np.uint64)
        shifts = np.asarray(p2._DIAG_SHIFTS, np.int64)
        with torch.cuda.device(key):
            cuda_build.check(lib.poseidon2_set_constants(
                rc.ctypes.data, shifts.ctypes.data), "poseidon2_set_constants")
        _CONSTANTS_SET.add(key)
    return lib


def _check(t: torch.Tensor, what: str, rows=None):
    if t.dtype != torch.int64 or t.dim() != 2 or \
            (rows is not None and t.shape[0] != rows):
        raise TypeError("poseidon2 wants %s as a 2-D int64 tensor%s, got %s %s"
                        % (what, "" if rows is None else " of %d rows" % rows,
                           t.dtype, tuple(t.shape)))
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError("poseidon2 has no kernel for device %s" % t.device)


def permutation_stacked_fast(st: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on a canonical (12, B) int64 state -> canonical (12, B)."""
    global LAUNCHES
    _check(st, "the state", 12)
    if st.device.type == "cpu":
        return permutation_plain(st)
    from ..utils import cuda_build

    lib = _lib(st.device)
    st = st.contiguous()
    out = torch.empty_like(st)
    b = st.shape[1]
    rc = lib.poseidon2_permute(st.data_ptr(), out.data_ptr(), b,
                               cuda_build.stream_handle(st))
    cuda_build.check(rc, "poseidon2_permute")
    LAUNCHES += 1
    SHAPES[("permute", b)] += 1
    return out


def leaf_hashes(cols: torch.Tensor) -> torch.Tensor:
    """Leaf hashes (4, m) of canonical leaf columns (k, m), any k >= 1."""
    global LEAF_LAUNCHES
    _check(cols, "the leaf columns")
    if cols.device.type == "cpu":
        return leaf_hashes_plain(cols)
    from ..utils import cuda_build

    k, m = cols.shape
    if cols.stride(1) != 1 or (k > 1 and cols.stride(0) < m):
        cols = cols.contiguous()
    ld = cols.stride(0) if k > 1 else m
    lib = _lib(cols.device)
    out = cols.new_empty((CAP, m))
    rc = lib.poseidon2_leaf_hashes(cols.data_ptr(), out.data_ptr(), k, m, ld,
                                   cuda_build.stream_handle(cols))
    cuda_build.check(rc, "poseidon2_leaf_hashes")
    LEAF_LAUNCHES += 1
    SHAPES[("leaf", k, m)] += 1
    return out


def node_layer(cur: torch.Tensor) -> torch.Tensor:
    """(4, m) canonical nodes, m even -> (4, m/2) parents: the hash of each
    (left, right) sibling pair."""
    global NODE_LAUNCHES
    _check(cur, "the node layer", CAP)
    m = cur.shape[1]
    if m % 2:
        raise ValueError("a node layer needs an even width, got %d" % m)
    if cur.device.type == "cpu":
        return node_layer_plain(cur)
    from ..utils import cuda_build

    cur = cur.contiguous()
    if cur.data_ptr() % 16:  # the kernel reads each pair with one 16-byte load
        cur = cur.clone()
    lib = _lib(cur.device)
    out = cur.new_empty((CAP, m // 2))
    rc = lib.poseidon2_node_layer(cur.data_ptr(), out.data_ptr(), m,
                                  cuda_build.stream_handle(cur))
    cuda_build.check(rc, "poseidon2_node_layer")
    NODE_LAUNCHES += 1
    SHAPES[("node", m)] += 1
    return out


def node_layers(cur: torch.Tensor, cap_size: int) -> list:
    """(4, m) canonical nodes -> the node layers above them, (4, m/2),
    (4, m/4), ..., down to ``cap_size`` nodes or to the first odd width. On
    a CUDA tensor the launches of ``poseidon2_node_layers`` that
    `device_bytes_hash.node_launches` plans (one a tree, two above
    `device_bytes_hash.NODE_SPLIT` nodes) compute them all into one buffer
    (each layer a (4, m_l) view into it)."""
    _check(cur, "the node layer", CAP)
    if cur.device.type == "cpu":
        return node_layers_plain(cur, cap_size)
    widths = dbh.node_widths(cur.shape[1], cap_size)
    if not widths:
        return []

    def counted(m, levels):
        global NODE_LAYERS_LAUNCHES
        NODE_LAYERS_LAUNCHES += 1
        SHAPES[("nodes", m, levels)] += 1

    return dbh.launch_node_layers(
        cur, widths, _lib(cur.device).poseidon2_node_layers,
        "poseidon2_node_layers", counted)
