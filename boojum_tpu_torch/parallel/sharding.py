# Port of boojum_tpu/parallel/sharding.py to torch.distributed.
"""Sharded proving over a process group: one process a device (SPMD).

The reference runs one controller over a `jax.sharding.Mesh` and lets XLA
partition every array. Here every rank runs the whole prover; a sharded
tensor is the rank's block of rows, and every exchange is an explicit
collective of the mesh's process group (NCCL for CUDA tensors, gloo for CPU
tensors). With S ranks and a domain of n rows (nl = n / S), rank d owns:

- **base domain** (Lagrange values, monomial coefficients, natural order):
  rows ``[d·nl, (d+1)·nl)``;
- **LDE domain** (L cosets of n points, each in bitreversed order, the
  oracles' flat layout ``c·n + i``): in every coset c the rows
  ``[d·nl, (d+1)·nl)``, stored coset-major, so local position ``c·nl + r``
  is global ``c·n + d·nl + r``. This is what `distributed_ntt` gives for
  each coset, and no exchange re-lays it out: the reference's
  ``lde.reshape(L·n, k)`` of a sharded stack has no counterpart;
- **trees** over such a layout: the rank's L blocks of leaves. Leaf hashes
  and every node layer whose blocks still hold two or more nodes are local;
  the layer of one node a block (or the cap, when it is reached first) is
  all-gathered into global order, and the layers above it are built on
  every rank (replicated). The cap is therefore replicated, and a path is
  answered by the owner of each of its local levels;
- **FRI layers**: the same coset-major blocks, halved by each fold (a fold
  pairs adjacent elements, and every block stays even). A layer is
  committed sharded while each rank's block of each coset holds at least
  one leaf (2^k elements); below that the layer is all-gathered and FRI
  goes on replicated (`device_merkle.do_fri_device`).

Queries are answered by the owner of each row or node: every rank gathers
its own entries and zeros elsewhere, and one ``all_reduce`` of the query
phase's single fetch combines them (`device_merkle.FetchCollector` with a
mesh). Each entry has exactly one nonzero contribution, so the integer sum
is a selection and exact. Field sums are not: modular addition does not
commute with the int64 wrap of an ``all_reduce``, so `distributed_sum_reduce`
gathers the partial sums and folds them with the field add, as the
reference does.

The local passes of the distributed four-step NTT run through the port's
kernels: radix 128 / 256 passes on `mxu_ntt.ntt_cols_matmul` (K1
``ntt_stage``, cross twiddle in its store), other passes up to 2^12 on
`pallas_ntt.ntt_small` (K4), larger ones through the four-step recursions.
"""

from __future__ import annotations

import collections
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from ..field import extension as ext2
from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from ..ntt import mxu_ntt, ntt, pallas_ntt
from ..prover.device import upload
from ..prover.device_merkle import _ALGEBRAIC, DeviceTree, _flush_alone
from ..utils import npgl

# collectives issued through a Mesh, by kind (chip_smoke.py reads them
# around the sharded prove)
COLLECTIVES = collections.Counter()

# all_gather into one tensor (named all_gather_into_tensor before torch 2.13)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

# the backend a mesh on each device type needs
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """A 1-D mesh: the process group, its size S, this process's rank in it,
    and the one device the rank proves on."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = device

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (S, ...): block s goes to rank s; block r of the result is
        what rank r sent this rank."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        COLLECTIVES["all_to_all"] += 1
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(S, *x.shape): rank r's ``x`` at index r."""
        out = x.new_empty((self.size,) + tuple(x.shape))
        # the concatenation of (1, ...) pieces along dim 0 (gloo takes that
        # form only)
        _all_gather_single(out, x.contiguous()[None], group=self.group)
        COLLECTIVES["all_gather"] += 1
        return out

    def select(self, x: torch.Tensor) -> torch.Tensor:
        """In place: each element takes the one rank's value that is not
        zero (an integer ``all_reduce`` sum; exact because every element
        has at most one nonzero contribution)."""
        dist.all_reduce(x, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return x

    def blocks(self, total: int) -> slice:
        """This rank's block of ``total`` rows split into S equal blocks."""
        if total % self.size:
            raise ValueError("%d rows do not split into %d equal blocks"
                             % (total, self.size))
        b = total // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def _backend_for(group, device_type: str) -> str:
    """The group's backend for tensors of ``device_type`` (a group made
    with several backends names them as ``cpu:gloo,cuda:nccl``)."""
    backend = str(dist.get_backend(group))
    if ":" not in backend:
        return backend
    per_type = dict(part.split(":") for part in backend.split(","))
    return per_type.get(device_type, "")


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the whole world) for this process.
    ``device`` defaults to ``cuda:{LOCAL_RANK}``; the CPU only when asked.
    A mesh of CUDA tensors needs the NCCL backend and one of CPU tensors
    gloo; anything else raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs torch.distributed's process group "
                           "(dist.init_process_group) first")
    group = dist.group.WORLD if group is None else group
    if dist.get_rank(group) < 0:
        raise ValueError("this process is not a member of the group")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for but CUDA is not "
                               "available; pass device='cpu' with a gloo group")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
    want = _BACKENDS.get(dev.type)
    if want is None:
        raise ValueError("no mesh on device %s: CUDA devices use NCCL, the "
                         "CPU gloo" % dev)
    have = _backend_for(group, dev.type)
    if have != want:
        raise ValueError("a mesh on %s needs the %s backend, the group's is %r"
                         % (dev, want, have))
    return Mesh(group, dev)


# ---------------------------------------------------------------------------
# Distributed four-step NTT: two all_to_all exchanges bracket local passes.
#
# With n = n1·n2, j = j1·n2 + j2, k = k1 + n1·k2 (pallas_ntt.ntt_fourstep):
#   rank d starts with the j1-block [d·n1/S, (d+1)·n1/S) (natural rows),
#   exchange 1 -> all j1 for the j2-block of d,
#   local NTT_{n1} over j1 (bitreversed p1), times the cross twiddle
#   w[p1, j2] (the rank's j2 columns) in the pass's store,
#   exchange 2 -> all j2 for the p1-block of d,
#   local NTT_{n2} over j2 (bitreversed p2),
#   flatten (p1_local, p2): rank d holds the block [d·n/S, (d+1)·n/S) of
#   the full bitreversed output.
# In the n1 pass the lanes are (column b, j2_local), so the cross-twiddle
# table's column is the lane mod n2/S, the convention of K1's store.
# ---------------------------------------------------------------------------


def _fourstep_split(log_n: int, n_shards: int):
    log_s = int(n_shards).bit_length() - 1
    if 1 << log_s != n_shards:
        raise ValueError("the mesh size %d is not a power of two" % n_shards)
    log_n1 = max((log_n + 1) // 2, log_s)
    log_n2 = log_n - log_n1
    if log_n2 < log_s:
        raise ValueError("2^%d rows are too few for %d ranks (need n2 >= S "
                         "for the j2 exchange)" % (log_n, n_shards))
    return log_n1, log_n2


def fourstep_cross_twiddles(log_n: int, n_shards: int,
                            inverse: bool = False) -> np.ndarray:
    """Host (n1, n2) u64 cross twiddles w[p1, j2] = ω^{bitrev(p1)·j2}, or
    their inverses."""
    log_n1, log_n2 = _fourstep_split(log_n, n_shards)
    return ntt.fourstep_twiddles_host(log_n1, log_n2, inverse)


def coset_power_factors(log_n: int, n_shards: int, coset: int):
    """coset^j factored as pj1[j1]·pj2[j2] (j = j1·n2 + j2): host u64
    arrays (pj1, pj2)."""
    log_n1, log_n2 = _fourstep_split(log_n, n_shards)
    pj2 = npgl.powers(coset, 1 << log_n2)
    c_n2 = int(pow(coset, 1 << log_n2, ORDER))
    pj1 = npgl.powers(c_n2, 1 << log_n1)
    return pj1, pj2


@functools.lru_cache(maxsize=None)
def _coset_scale(log_n: int, n_shards: int, rank: int, coset: int, device):
    """coset^j over the rank's natural rows j, (n/S,) on ``device``, from
    the factored powers."""
    pj1, pj2 = coset_power_factors(log_n, n_shards, coset)
    n1l = pj1.shape[0] // n_shards
    own = pj1[rank * n1l:(rank + 1) * n1l]
    return gl.from_u64(npgl.mul(np.repeat(own, pj2.shape[0]),
                                np.tile(pj2, n1l)), device)


@functools.lru_cache(maxsize=None)
def _cross_twiddles(log_n: int, n_shards: int, rank: int, inverse: bool,
                    device):
    """The rank's j2 columns of the cross twiddles (their inverses with
    ``inverse``), (n1, n2/S) on ``device``."""
    w = fourstep_cross_twiddles(log_n, n_shards, inverse)
    n2l = w.shape[1] // n_shards
    return gl.from_u64(np.ascontiguousarray(
        w[:, rank * n2l:(rank + 1) * n2l]), device)


def _local_pass(x: torch.Tensor, log_r: int, inverse: bool = False,
                tw: torch.Tensor = None) -> torch.Tensor:
    """A local pass along axis 0 of (2^log_r, M) through the port's kernel
    entries, times the cross twiddle ``tw[r, l % W]`` on the output
    (forward) or on the input (inverse). Radix 128 / 256: K1 with the
    twiddle in its store; up to 2^12 rows: K4 (forward with the table tiled
    to the lanes); above: the four-step recursions."""
    if log_r in (7, 8):
        return mxu_ntt.ntt_cols_matmul(x, inverse=inverse, tw=tw,
                                       tw_pre=inverse and tw is not None)
    tiled = None if tw is None else tw.repeat(1, x.shape[1] // tw.shape[1])
    if inverse:
        if tiled is not None:
            x = gl.mul(x, tiled)
        if log_r <= pallas_ntt.MAX_KERNEL_LOG:
            return pallas_ntt.ntt_small(x, log_r, inverse=True)
        return ntt.intt_fourstep_cols(x)
    if log_r <= pallas_ntt.MAX_KERNEL_LOG:
        return pallas_ntt.ntt_small(x, log_r, tw=tiled)
    return pallas_ntt.ntt_any(x, log_r, tiled)


def distributed_ntt(mesh: Mesh, x: torch.Tensor, log_n: int,
                    coset: int = 1) -> torch.Tensor:
    """Sharded forward NTT of one (n, B) column batch: the rank's natural
    rows (n/S, B) -> its block of the bitreversed evaluations on the coset
    ``coset``·<ω> (coset 1: the plain domain)."""
    S, d = mesh.size, mesh.rank
    log_n1, log_n2 = _fourstep_split(log_n, S)
    n1, n2 = 1 << log_n1, 1 << log_n2
    n1l, n2l = n1 // S, n2 // S
    rows, b = x.shape
    if rows != n1l * n2:
        raise ValueError("distributed_ntt: %d local rows, want 2^%d / %d"
                         % (rows, log_n, S))
    if coset % ORDER != 1:
        x = gl.mul(x, _coset_scale(log_n, S, d, coset % ORDER,
                                   x.device)[:, None])
    # exchange 1: the j2-block s of every local j1 row goes to rank s
    a = mesh.all_to_all(x.reshape(n1l, S, n2l, b).permute(1, 0, 3, 2))
    a = _local_pass(a.reshape(n1, b * n2l), log_n1,
                    tw=_cross_twiddles(log_n, S, d, False, x.device))
    # exchange 2: the p1-block s goes to rank s
    recv = mesh.all_to_all(a.reshape(S, n1l, b, n2l))
    bt = _local_pass(recv.permute(0, 3, 1, 2).reshape(n2, n1l * b), log_n2)
    return bt.reshape(n2, n1l, b).transpose(0, 1).reshape(n1l * n2, b)


def distributed_intt(mesh: Mesh, y: torch.Tensor, log_n: int,
                     coset: int = 1) -> torch.Tensor:
    """Inverse of `distributed_ntt` with the same ``coset``: the rank's
    block of bitreversed evaluations (n/S, B) -> its natural rows of the
    coefficients. Local iNTT_{n2}, exchange to full p1 columns, iNTT_{n1}
    with the inverse cross twiddles on its input, exchange back to natural
    j1-blocks, then the coset's powers divided out."""
    S, d = mesh.size, mesh.rank
    log_n1, log_n2 = _fourstep_split(log_n, S)
    n1, n2 = 1 << log_n1, 1 << log_n2
    n1l, n2l = n1 // S, n2 // S
    rows, b = y.shape
    if rows != n1l * n2:
        raise ValueError("distributed_intt: %d local rows, want 2^%d / %d"
                         % (rows, log_n, S))
    s = _local_pass(y.reshape(n1l, n2, b).transpose(0, 1)
                    .reshape(n2, n1l * b), log_n2, inverse=True)
    # the j2-block s of every local p1 row goes to rank s
    a = mesh.all_to_all(s.reshape(S, n2l, n1l, b).permute(0, 2, 3, 1))
    a = _local_pass(a.reshape(n1, b * n2l), log_n1, inverse=True,
                    tw=_cross_twiddles(log_n, S, d, True, y.device))
    # the j1-block s goes to rank s; what comes back is a j2-block each
    recv = mesh.all_to_all(a.reshape(S, n1l, b, n2l))
    x = recv.permute(1, 0, 3, 2).reshape(n1l * n2, b)
    if coset % ORDER != 1:
        x = gl.mul(x, _coset_scale(log_n, S, d, gl.s_inv(coset % ORDER),
                                   y.device)[:, None])
    return x


@functools.lru_cache(maxsize=None)
def _bitreverse_plan(log_n: int, n_shards: int, rank: int, device):
    """Index tensors of `distributed_bitreverse` for this rank: the local
    rows it sends (grouped by destination, each group in increasing output
    position), and where each received row lands."""
    n = 1 << log_n
    nl = n // n_shards
    rev = ntt.bitreverse_indices(log_n)
    pos = np.arange(n)
    # rows whose output position p (y[p] = x[rev[p]]) reads this rank's rows
    mine = pos[rev // nl == rank]
    send = rev[mine] - rank * nl
    own = np.arange(rank * nl, (rank + 1) * nl)
    order = np.argsort(rev[own] // nl, kind="stable")  # by source rank
    land = own[order] - rank * nl
    return (torch.from_numpy(send).to(device),
            torch.from_numpy(np.argsort(land)).to(device))


def distributed_bitreverse(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The rank's natural rows (n/S, B) -> its block of the bitreversed
    permutation (y[p] = x[bitrev(p)]), one all_to_all."""
    rows, b = x.shape
    log_n = (rows * mesh.size).bit_length() - 1
    send, take = _bitreverse_plan(log_n, mesh.size, mesh.rank, x.device)
    recv = mesh.all_to_all(x.index_select(0, send).reshape(mesh.size, -1, b))
    return recv.reshape(rows, b).index_select(0, take)


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------


def distributed_grand_product(mesh: Mesh, ratios):
    """Exclusive grand product of an ext array (c0, c1) whose rows are
    sharded in natural order (the copy-permutation z recurrence): a local
    exclusive scan, one all_gather of the shard totals, then the product of
    the earlier shards' totals folded in."""
    local = ext2.exclusive_prefix_mul(ratios)
    total = ext2.mul((local[0][-1:], local[1][-1:]),
                     (ratios[0][-1:], ratios[1][-1:]))
    totals = mesh.all_gather(torch.stack(total))  # (S, 2, 1)
    offset = ext2.ones((1,), ratios[0].device)
    for r in range(mesh.rank):
        offset = ext2.mul(offset, (totals[r, 0], totals[r, 1]))
    return ext2.mul(local, offset)


def distributed_sum_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Field sum over axis 0 of the rows of every rank, replicated: the
    local modular sum, one all_gather of the S partials, and a fold with the
    field add (an int64 all_reduce would wrap mod 2^64, not mod p)."""
    return gl.sum_mod(mesh.all_gather(gl.sum_mod(x, 0)), 0)


def distributed_commit_step(mesh: Mesh, cols: torch.Tensor, log_n: int,
                            lde_factor: int):
    """The sharded commit of monomial columns sharded over the columns:
    this rank's (n, k/S) -> (leaf hashes (4, L·n/S) of its row block, the
    replicated cap (4, S)). A local LDE of the rank's columns, one
    all_to_all to row blocks, local Poseidon2 leaf hashes and subtree, and
    one all_gather of the S subtree roots."""
    from ..hash import pallas_poseidon2
    from ..prover import device as dops

    S = mesh.size
    lde = dops.monomials_to_lde(cols, lde_factor)  # (L, n, k/S)
    lanes, n, kl = lde.shape
    if n != 1 << log_n:
        raise ValueError("distributed_commit_step: %d rows, want 2^%d"
                         % (n, log_n))
    block = lanes * n // S
    rows = mesh.all_to_all(lde.reshape(S, block, kl))  # (source, rows, k/S)
    rows = rows.permute(0, 2, 1).reshape(S * kl, block)  # columns in order
    leaves = pallas_poseidon2.leaf_hashes(rows)
    cur = leaves
    while cur.shape[1] > 1:
        cur = pallas_poseidon2.node_layer(cur)
    return leaves, mesh.all_gather(cur[:, 0]).T.contiguous()


# ---------------------------------------------------------------------------
# Sharded Merkle trees
# ---------------------------------------------------------------------------


def _algebraic(hasher: str):
    if hasher not in _ALGEBRAIC:
        raise ValueError("sharded trees hash with poseidon2 or poseidon, not "
                         "%r" % (hasher,))
    return _ALGEBRAIC[hasher]


def gather_blocks(mesh: Mesh, x: torch.Tensor, blocks: int) -> torch.Tensor:
    """A coset-major block layout (..., blocks·b) -> the global order
    (..., blocks·S·b) on every rank: one all_gather."""
    lead = tuple(x.shape[:-1])
    b = x.shape[-1] // blocks
    got = mesh.all_gather(x.reshape(lead + (blocks, b)))  # (S, ..., L, b)
    got = got.movedim(0, -2)  # (..., L, S, b)
    return got.reshape(lead + (blocks * mesh.size * b,))


def sharded_tree_layers(mesh: Mesh, cols: torch.Tensor, cap_size: int,
                        hasher: str = "poseidon2", blocks: int = 1):
    """Leaf columns (k, blocks·m) of this rank's ``blocks`` blocks of m
    leaves (local leaf c·m + r is global c·S·m + rank·m + r) -> (local
    layers, replicated layers). The local layers are the leaf hashes and
    the node layers whose blocks keep two or more nodes; the first layer
    that is the cap or has one node a block is all-gathered into global
    order, and the layers above it down to the cap are replicated."""
    leaf_hashes, node_layer = _algebraic(hasher)
    S = mesh.size
    m = cols.shape[1] // blocks
    if m * blocks != cols.shape[1] or m & (m - 1) or m < 1:
        raise ValueError("a sharded tree wants %d blocks of a power-of-two "
                         "count of leaves, got %d leaves" % (blocks,
                                                             cols.shape[1]))
    if cap_size > blocks * S * m:
        raise ValueError("cap %d above the %d leaves" % (cap_size,
                                                         blocks * S * m))
    cur = leaf_hashes(cols)
    local = [cur]
    while blocks * S * m > cap_size and m > 1:
        cur = node_layer(cur)
        m //= 2
        local.append(cur)
    top = gather_blocks(mesh, local.pop(), blocks)
    rep = [top]
    while top.shape[1] > cap_size:
        top = node_layer(top)
        rep.append(top)
    return local, rep


def build_sharded_tree(mesh: Mesh, cols: torch.Tensor, cap_size: int,
                       hasher: str = "poseidon2",
                       blocks: int = 1) -> "ShardedTree":
    """The Merkle-cap tree of this rank's leaf columns (see
    `sharded_tree_layers`); its cap and paths are the single-device tree's
    of the leaves in global order."""
    local, rep = sharded_tree_layers(mesh, cols, cap_size, hasher, blocks)
    return ShardedTree(mesh, local, rep, blocks, cols.shape[1] // blocks)


def _owner(g, level: int, m_loc: int, n_shards: int):
    """Owner rank and local index of global node ``g`` (numpy array) at a
    local ``level`` of a tree whose blocks held ``m_loc`` leaves a rank."""
    m = m_loc >> level
    c, within = np.divmod(g, n_shards * m)
    owner, r = np.divmod(within, m)
    return owner, c * m + r


def owner_gather_index(mesh: Mesh, owner, local):
    """Index and mask tensors of a gather answered by its owners: this
    rank's local indices where it owns the entry (0 elsewhere), and 1
    where it owns it (0 elsewhere)."""
    mine = owner == mesh.rank
    return (upload(np.where(mine, local, 0).astype(np.int64), mesh.device),
            upload(mine.astype(np.int64), mesh.device))


class ShardedTree(DeviceTree):
    """A `DeviceTree` whose lower layers are this rank's blocks (``local``)
    and whose upper layers, the cap last, are replicated. Paths are
    answered by the owner of each local level and by rank 0 for the
    replicated ones, combined in the collector's one exchange."""

    def __init__(self, mesh: Mesh, local, rep, blocks: int, m_loc: int):
        super().__init__(list(local) + list(rep))
        self.mesh = mesh
        self.num_local = len(local)
        self.blocks = blocks
        self.m_loc = m_loc

    def owner(self, leaf_indices):
        """Owner ranks and local leaf indices of global leaves."""
        return _owner(np.asarray(leaf_indices, np.int64), 0, self.m_loc,
                      self.mesh.size)

    def prefetch_proofs(self, leaf_indices, collector=None):
        idxs = sorted(set(int(i) for i in leaf_indices) - set(self._path_cache))
        if not idxs:
            return
        mesh = self.mesh
        depth = len(self.layers) - 1
        g = np.asarray(idxs, np.int64)
        owners, locs = [], []
        for level in range(depth + 1):
            node = g if level == depth else (g >> level) ^ 1
            lv = 0 if level == depth else level  # the leaf itself last
            if lv < self.num_local:
                o, loc = _owner(node, lv, self.m_loc, mesh.size)
            else:
                o, loc = np.zeros_like(node), node  # replicated: rank 0
            owners.append(o)
            locs.append(loc)
        idx, mask = owner_gather_index(mesh, np.stack(owners), np.stack(locs))

        def gather(idx, mask):
            parts = [self.layers[lv if lv < depth else 0][:, idx[lv]]
                     for lv in range(depth + 1)]
            return torch.stack(parts) * mask[:, None, :]  # (depth+1, w, q)

        def ingest(arr):
            for qi, leaf_idx in enumerate(idxs):
                nodes = self._nodes(arr[:, :, qi].T)
                self._path_cache[leaf_idx] = (nodes[depth], nodes[:depth])

        coll, alone = _flush_alone(collector, mesh)
        coll.add_gather(gather, (idx, mask), ingest, sharded=True)
        if alone:
            coll.flush()
