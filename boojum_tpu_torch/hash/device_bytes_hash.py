# Port of boojum_tpu/hash/device_bytes_hash.py: Blake2s-256 and Keccak-256 tree hashes, kernels K8 and K9.
"""Blake2s-256 and Keccak-256 leaf and node hashes of the byte Merkle trees.

Reference behavior: the byte tree hashers at src/cs/oracle/mod.rs:179
(Blake2s256) and :247 (Keccak256): a leaf's input is its field elements as
little-endian u64 bytes, column by column; a node's input is
left_digest || right_digest (64 bytes). The reference's own non-recursive
SHA-256 bench (sha256_bench_non_recursive.sh) uses the Blake2s tree and
transcript.

Each hash has two entries, each launching a Hopper kernel on a CUDA tensor
(``csrc/blake2s.cu``, K8; ``csrc/keccak.cu``, K9), and its plain torch
version on a CPU tensor:

- `leaf_hashes(cols, algo)`: canonical (k, m) int64
  leaf columns -> (8, m) digests, leaf i being column i (the JAX
  `blake2s_leaves_traced` / `keccak_leaves_traced`, a ``lax.scan`` over
  the message blocks); one launch;
- `node_layers(cur, algo, cap_size)`: a (8, m) digest layer -> the node
  layers above it down to the cap, each parent the hash of its (left,
  right) sibling pair (the JAX `blake2s_nodes_traced` /
  `keccak_nodes_traced` a layer); one launch for the whole tree, two for
  a tree above 2^17 digests (``csrc/byte_tree.cuh``: blocks of 256
  threads hash subtrees of 3 levels in shared memory, and the last block
  of every 8 goes on up the tree), all layers views of one buffer. The
  schedule's planner (`node_widths`, `node_launches`, `node_tickets`) and
  launch loop (`launch_node_layers`) also serve the classic-Poseidon
  tree's `poseidon.node_layers`.

A digest is held as the reference's 8 little-endian u32 word planes, each
word an int64 in [0, 2^32) (torch's uint32 lacks shifts on some CPU builds);
`digests_to_bytes` turns host planes into 32-byte strings. Eager torch would
need about 1,100 launches for one Blake2s compression; the kernels take one
thread per leaf or parent with the whole state in registers.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .keccak import _RC as _K_RC
from .keccak import _ROT as _K_ROT

# launches of each kernel entry by hash, and calls of a plain version on a
# CUDA tensor (chip_smoke.py reads them around the proves)
LEAF_LAUNCHES = collections.Counter()  # "blake2s" / "keccak256"
NODE_LAUNCHES = collections.Counter()
PLAIN_CUDA_CALLS = 0
# launches by (hash, entry, shape): (algo, "leaf", k, m),
# (algo, "nodes", m, levels)
SHAPES = collections.Counter()
# the node kernels' schedule (csrc/byte_tree.cuh): threads a block, levels a
# stage, and blocks of a stage that hand their digests on to one block
NODE_THREADS = 256
NODE_STAGE = 3
NODE_GROUP = 1 << NODE_STAGE
# a tree above this many digests takes two launches, its first stage alone:
# measured faster for Blake2s and Keccak-256 at 2^18 and 2^19 digests, and
# slower at 2^16 and below (scripts/torch_byte_tree_compare.py --sweep)
NODE_SPLIT = 1 << 17

_M32 = 0xFFFFFFFF
DIGEST_WORDS = 8


def _count_plain(t: torch.Tensor):
    global PLAIN_CUDA_CALLS
    if t.is_cuda:
        PLAIN_CUDA_CALLS += 1


def _words(cols: torch.Tensor) -> list:
    """(k, m) int64 elements -> 2k u32 word rows (m,): lo, hi of each
    element, in byte order (the JAX `_interleave_words`)."""
    out = []
    for j in range(cols.shape[0]):
        out.append(cols[j] & _M32)
        out.append((cols[j] >> 32) & _M32)
    return out


# ---------------------------------------------------------------------------
# Blake2s
# ---------------------------------------------------------------------------

B2S_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
# parameter block of unkeyed Blake2s-256: digest length 32, fanout 1, depth 1
B2S_PARAM0 = 0x01010020

B2S_SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)
# the four column and four diagonal G applications of a round
_B2S_G = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
          (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _ror32(x, r):
    return ((x >> r) | (x << (32 - r))) & _M32


def _b2s_compress(h: list, msg: list, t: int, last: bool) -> list:
    """One Blake2s compression of u32 word rows: the chaining value ``h``
    (8), the message block ``msg`` (16), the byte counter ``t`` (< 2^32)."""
    v = list(h) + [torch.full_like(h[0], c) for c in B2S_IV]
    v[12] = v[12] ^ t
    if last:
        v[14] = v[14] ^ _M32
    for sigma in B2S_SIGMA:
        for g, (a, b, c, d) in enumerate(_B2S_G):
            x, y = msg[sigma[2 * g]], msg[sigma[2 * g + 1]]
            v[a] = (v[a] + v[b] + x) & _M32
            v[d] = _ror32(v[d] ^ v[a], 16)
            v[c] = (v[c] + v[d]) & _M32
            v[b] = _ror32(v[b] ^ v[c], 12)
            v[a] = (v[a] + v[b] + y) & _M32
            v[d] = _ror32(v[d] ^ v[a], 8)
            v[c] = (v[c] + v[d]) & _M32
            v[b] = _ror32(v[b] ^ v[c], 7)
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _b2s_h0(like: torch.Tensor) -> list:
    h = [torch.full_like(like, c) for c in B2S_IV]
    h[0] = h[0] ^ B2S_PARAM0
    return h


def blake2s_leaves_plain(cols: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``blake2s_leaf_hashes``: the 8k leaf bytes
    in 64-byte blocks, the last one zero-padded, with the byte counter and
    the last-block flag of the reference."""
    _count_plain(cols)
    k, m = cols.shape
    words = _words(cols)
    nb = max(-(-k // 8), 1)
    words += [cols.new_zeros(m)] * (16 * nb - 2 * k)
    h = _b2s_h0(cols.new_zeros(m))
    for b in range(nb):
        h = _b2s_compress(h, words[16 * b:16 * (b + 1)],
                          min(64 * (b + 1), 8 * k), b == nb - 1)
    return torch.stack(h)


def blake2s_nodes_plain(cur: torch.Tensor) -> torch.Tensor:
    """One node layer of ``blake2s_node_layers``'s plain chain: one
    compression of the 64 bytes left || right per parent."""
    _count_plain(cur)
    left, right = cur[:, 0::2], cur[:, 1::2]
    msg = [left[i] for i in range(8)] + [right[i] for i in range(8)]
    return torch.stack(_b2s_compress(_b2s_h0(left[0]), msg, 64, True))


# ---------------------------------------------------------------------------
# Keccak-256 (legacy 0x01 padding, Ethereum style; see hash/keccak.py)
# ---------------------------------------------------------------------------

RATE_LANES = 17  # the 136-byte rate of Keccak-256
_SIGN = -(1 << 63)  # the int64 of lane bit 63 (the pad's final 0x80 byte)


def _rol64(x, s):
    if s == 0:
        return x
    return (x << s) | ((x >> (64 - s)) & ((1 << s) - 1))


def _keccak_f(a: list) -> list:
    """Keccak-f[1600] on 25 int64 lane rows, lane i = (x, y) = (i % 5, i // 5)
    (the reference's `keccak_f1600`, lanes[x][y])."""
    for rc in _K_RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol64(c[(x + 1) % 5], 1) for x in range(5)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol64(a[x + 5 * y] ^ d[x],
                                                          _K_ROT[x][y])
        a = [b[i] ^ (~b[(i % 5 + 1) % 5 + 5 * (i // 5)]
                     & b[(i % 5 + 2) % 5 + 5 * (i // 5)]) for i in range(25)]
        a[0] = a[0] ^ (rc - (1 << 64) if rc >> 63 else rc)
    return a


def _keccak_absorb(lanes: list) -> torch.Tensor:
    """Keccak-256 of message lanes (int64 rows (m,), the u64 little-endian
    words of the input): pad with 0x01 ... 0x80 to whole 136-byte blocks,
    absorb, and return the (8, m) digest word planes."""
    k = len(lanes)
    zero = torch.zeros_like(lanes[0])
    nb = k // RATE_LANES + 1  # the pad takes at least one byte
    msg = list(lanes) + [zero] * (nb * RATE_LANES - k)
    msg[k] = msg[k] ^ 1
    msg[-1] = msg[-1] ^ _SIGN
    a = [zero] * 25
    for b in range(nb):
        a = _keccak_f([a[i] ^ msg[b * RATE_LANES + i] if i < RATE_LANES
                       else a[i] for i in range(25)])
    out = []
    for i in range(4):
        out.extend((a[i] & _M32, (a[i] >> 32) & _M32))
    return torch.stack(out)


def keccak_leaves_plain(cols: torch.Tensor) -> torch.Tensor:
    """The plain torch version of ``keccak256_leaf_hashes``: a leaf's k
    elements are its k message lanes."""
    _count_plain(cols)
    return _keccak_absorb([cols[j] for j in range(cols.shape[0])])


def keccak_nodes_plain(cur: torch.Tensor) -> torch.Tensor:
    """One node layer of ``keccak256_node_layers``'s plain chain: the 64
    bytes left || right as 8 lanes, one absorbed block."""
    _count_plain(cur)
    halves = (cur[:, 0::2], cur[:, 1::2])
    return _keccak_absorb([h[2 * i] | (h[2 * i + 1] << 32)
                           for h in halves for i in range(4)])


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

_LIBS = {"blake2s": "blake2s", "keccak256": "keccak"}
_PLAIN = {"blake2s": (blake2s_leaves_plain, blake2s_nodes_plain),
          "keccak256": (keccak_leaves_plain, keccak_nodes_plain)}


def _check(t: torch.Tensor, what: str, algo: str, rows=None):
    if t.dtype != torch.int64 or t.dim() != 2 or \
            (rows is not None and t.shape[0] != rows):
        raise TypeError("%s wants %s as a 2-D int64 tensor%s, got %s %s"
                        % (algo, what, "" if rows is None
                           else " of %d rows" % rows, t.dtype,
                           tuple(t.shape)))
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError("%s has no kernel for device %s" % (algo, t.device))


def leaf_hashes(cols: torch.Tensor, algo: str) -> torch.Tensor:
    """Digests (8, m) of canonical leaf columns (k, m), k >= 1: one launch
    of ``<algo>_leaf_hashes`` on a CUDA tensor."""
    _check(cols, "the leaf columns", algo)
    if cols.device.type == "cpu":
        return _PLAIN[algo][0](cols)
    from ..utils import cuda_build

    k, m = cols.shape
    if cols.stride(1) != 1 or (k > 1 and cols.stride(0) < m):
        cols = cols.contiguous()
    ld = cols.stride(0) if k > 1 else m
    lib = cuda_build.load(_LIBS[algo])
    out = cols.new_empty((DIGEST_WORDS, m))
    entry = "%s_leaf_hashes" % _LIBS[algo]
    rc = getattr(lib, entry)(cols.data_ptr(), out.data_ptr(), k, m, ld,
                             cuda_build.stream_handle(cols))
    cuda_build.check(rc, entry)
    LEAF_LAUNCHES[algo] += 1
    SHAPES[(algo, "leaf", k, m)] += 1
    return out


def node_widths(m: int, cap_size: int) -> list:
    """Widths of the node layers above an m-digest layer: halving while the
    width is above ``cap_size`` and even."""
    widths = []
    while m > cap_size and m % 2 == 0:
        m //= 2
        widths.append(m)
    return widths


def node_launches(m: int, levels: int) -> list:
    """The launches of ``<algo>_node_layers`` for ``levels`` layers above m
    digests, as (input width, levels): one, or above `NODE_SPLIT` digests
    two, the first stage alone and then the rest."""
    if m > NODE_SPLIT and levels > NODE_STAGE:
        return [(m, NODE_STAGE), (m >> NODE_STAGE, levels - NODE_STAGE)]
    return [(m, levels)] if levels else []


def node_tickets(m: int, levels: int) -> int:
    """Hand-on counters one launch of ``<algo>_node_layers`` needs for
    ``levels`` layers above m digests (csrc/byte_tree.cuh): one for each
    group of `NODE_GROUP` blocks of every stage but the last."""
    n = done = 0
    while done + NODE_STAGE < levels:
        blocks = -(-m // (2 * NODE_THREADS))
        n += -(-blocks // NODE_GROUP)
        m >>= NODE_STAGE
        done += NODE_STAGE
    return n


def node_layers_plain(cur: torch.Tensor, algo: str, cap_size: int) -> list:
    """The plain torch version of ``node_layers``: the plain node hash of
    ``algo``, one layer at a time."""
    layers = []
    for _ in node_widths(cur.shape[1], cap_size):
        cur = _PLAIN[algo][1](cur)
        layers.append(cur)
    return layers


def node_buffer(cur: torch.Tensor, widths: list,
                words: int = DIGEST_WORDS) -> list:
    """One buffer on ``cur``'s device for node layers of these widths, one
    after the other: the (words, w) views into it."""
    buf = cur.new_empty(words * sum(widths))
    layers, at = [], 0
    for w in widths:
        layers.append(buf.as_strided((words, w), (w, 1), at))
        at += words * w
    return layers


def launch_node_layers(cur: torch.Tensor, widths: list, launch, entry: str,
                       counted) -> list:
    """The CUDA branch of a ``csrc/byte_tree.cuh`` tree entry: the node
    layers of ``widths`` above the (words, m) digests ``cur``, views of one
    `node_buffer`, computed by the launches `node_launches` plans, each
    ``launch(cur, out, m, levels, tickets, stream)`` (the ctypes entry
    ``entry``) and then ``counted(m, levels)``."""
    from ..utils import cuda_build

    cur = cur.contiguous()
    if cur.data_ptr() % 16:  # the kernels read each pair with one 16-byte load
        cur = cur.clone()
    layers = node_buffer(cur, widths, cur.shape[0])
    launches = node_launches(cur.shape[1], len(widths))
    # the hand-on counters of every launch, zeroed at once
    counts = [node_tickets(m, levels) for m, levels in launches]
    tickets = torch.zeros(max(sum(counts), 1), dtype=torch.int32,
                          device=cur.device)
    stream = cuda_build.stream_handle(cur)
    src, done, first = cur, 0, 0
    for (m, levels), n in zip(launches, counts):
        rc = launch(src.data_ptr(), layers[done].data_ptr(), m, levels,
                    tickets[first:].data_ptr(), stream)
        cuda_build.check(rc, entry)
        counted(m, levels)
        done += levels
        first += n
        src = layers[done - 1]
    return layers


def node_layers(cur: torch.Tensor, algo: str, cap_size: int) -> list:
    """(8, m) digests -> the node layers above them, (8, m/2), (8, m/4), ...,
    down to ``cap_size`` digests or to the first odd width. On a CUDA
    tensor, the launches of ``<algo>_node_layers`` that `node_launches`
    plans (one, or two for a wide tree) compute them all into one buffer
    (each layer an (8, m_l) view into it)."""
    _check(cur, "the node layer", algo, DIGEST_WORDS)
    if cur.device.type == "cpu":
        return node_layers_plain(cur, algo, cap_size)
    widths = node_widths(cur.shape[1], cap_size)
    if not widths:
        return []
    from ..utils import cuda_build

    def counted(m, levels):
        NODE_LAUNCHES[algo] += 1
        SHAPES[(algo, "nodes", m, levels)] += 1

    entry = "%s_node_layers" % _LIBS[algo]
    return launch_node_layers(
        cur, widths, getattr(cuda_build.load(_LIBS[algo]), entry), entry,
        counted)


def digests_to_bytes(words: np.ndarray) -> list[bytes]:
    """(8, m) host word planes (u32 values in any integer type) -> m 32-byte
    digests."""
    le = np.ascontiguousarray(np.asarray(words).T.astype("<u4"))
    raw = le.tobytes()
    return [raw[32 * i:32 * (i + 1)] for i in range(le.shape[0])]
