# Port of boojum_tpu/parallel/sharded_oracle.py to torch.distributed.
"""Sharded committed oracles: the multi-GPU twin of `DeviceOracle`.

The row layout is `sharding`'s: the rank's natural rows of the base domain,
and its coset-major blocks of the LDE domain. Composition:

- monomials by the distributed inverse four-step NTT (two all_to_alls),
  after a bitreversal exchange when the Lagrange values were computed on
  the device (host columns are bitreversed on the host);
- the LDE by one distributed forward NTT a column block, every coset in its
  batch (the coset powers scale the rank's coefficient rows);
- the Merkle tree by `sharding.build_sharded_tree` over the LDE's first
  ``tree_lde`` cosets;
- queries and evaluations answered by the rows' owners: `query_many` rides
  the query phase's collector, and `eval_monomial_sets_at` sums the rank's
  partial sums with one gather and the field add.

Caps, paths, leaf values and evaluations equal the single-device
`DeviceOracle`'s (the reference's `ShardedOracle` sets ``flat`` but never
the ``flat_t`` that its queries read, boojum_tpu/parallel/sharded_oracle.py:100;
here the queries are the owners' gathers).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import extension as ext2
from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from ..ntt import ntt
from ..prover import device as dops
from ..prover.device_merkle import DeviceFlatOracle, _flush_alone
from ..prover.oracles import DeviceOracle, _Rows
from ..utils import npgl
from . import sharding as sh


def _log2(v: int) -> int:
    return v.bit_length() - 1


def sharded_cols_to_monomials(mesh, cols: torch.Tensor) -> torch.Tensor:
    """Lagrange values on the plain domain, the rank's natural rows
    (n/S, k) -> its monomial rows (n/S, k): a bitreversal exchange, then
    the distributed inverse NTT."""
    log_n = _log2(cols.shape[0] * mesh.size)
    return sh.distributed_intt(mesh, sh.distributed_bitreverse(mesh, cols),
                               log_n)


@functools.lru_cache(maxsize=None)
def _coset_powers_rows(log_n: int, lde_factor: int, n_shards: int, rank: int,
                       device) -> torch.Tensor:
    """The LDE cosets' powers over the rank's natural rows, (n/S, lde) on
    ``device``."""
    pows = dops._coset_powers_host(log_n, lde_factor)  # (lde, n)
    nl = pows.shape[1] // n_shards
    return gl.from_u64(np.ascontiguousarray(
        pows[:, rank * nl:(rank + 1) * nl].T), device)


def sharded_monomials_to_lde(mesh, mono: torch.Tensor,
                             lde_factor: int) -> torch.Tensor:
    """(n/S, k) monomial rows -> (lde, n/S, k): in each coset the rank's
    block of bitreversed evaluations. Every coset rides the batch of one
    distributed NTT a block of `device.COL_BLOCK` columns."""
    rows, k = mono.shape
    log_n = _log2(rows * mesh.size)
    pows = _coset_powers_rows(log_n, lde_factor, mesh.size, mesh.rank,
                              mono.device)
    outs = []
    for start in range(0, k, dops.COL_BLOCK):
        blk = mono[:, start:start + dops.COL_BLOCK]
        b = blk.shape[1]
        # lanes (coset, column): each coset's scaled copy side by side
        x = gl.mul(blk.repeat(1, lde_factor),
                   pows.repeat_interleave(b, dim=1))
        out = sh.distributed_ntt(mesh, x, log_n)
        outs.append(out.reshape(rows, lde_factor, b).transpose(0, 1))
    return torch.cat(outs, dim=2)


class ShardedOracle(DeviceOracle):
    """`DeviceOracle` over a mesh; the same interface and the same bytes.
    ``lagrange`` is the rank's natural rows (n/S, k) of the Lagrange
    values, ``monomials`` its rows of the coefficients, ``flat_t`` (k,
    L·n/S) its coset-major blocks of the LDE, ``n`` the whole domain."""

    def __init__(self, mesh, lagrange_cols, lde_factor: int, cap_size: int,
                 hasher: str, tree_lde: int = None, monomials=None):
        self.mesh = mesh
        S, dev = mesh.size, mesh.device
        if monomials is None:
            if isinstance(lagrange_cols, torch.Tensor):  # the rank's rows
                self.lagrange = lagrange_cols
                monomials = sharded_cols_to_monomials(mesh, lagrange_cols)
            else:  # host (k, n): bitreversed on the host, no exchange
                cols = np.asarray(lagrange_cols, np.uint64)
                n = cols.shape[1]
                own = mesh.blocks(n)
                rev = ntt.bitreverse_indices(_log2(n))
                # pinned uploads: the host does not wait for the device
                self.lagrange = dops.upload(cols[:, own].T, dev)
                monomials = sh.distributed_intt(
                    mesh, dops.upload(cols[:, rev[own]].T, dev), _log2(n))
        else:
            self.lagrange = None
        self.monomials = monomials
        self.rows, self.num_polys = monomials.shape
        self.n = self.rows * S
        self.lde_factor = lde_factor
        self.tree_lde = tree_lde or lde_factor
        assert self.tree_lde <= lde_factor
        lde = sharded_monomials_to_lde(mesh, monomials, lde_factor)
        self.flat_t = lde.permute(2, 0, 1).reshape(
            self.num_polys, lde_factor * self.rows).contiguous()
        del lde
        self.tree = sh.build_sharded_tree(
            mesh, self.flat_t[:, :self.tree_lde * self.rows], cap_size,
            hasher, blocks=self.tree_lde)

    def flat(self, poly: int, num_cosets: int) -> torch.Tensor:
        """The rank's blocks of poly ``poly`` over the first ``num_cosets``
        cosets, (c·n/S,)."""
        return self.flat_t[poly, :num_cosets * self.rows]

    def query_many(self, flat_indices, collector=None):
        """Leaf values of all queries (global flat indices c·n + i), each
        gathered by its owner; see `DeviceOracle.query_many`."""
        f = np.asarray(flat_indices, np.int64)
        c, i = np.divmod(f, self.n)
        owner, r = np.divmod(i, self.rows)
        idx, mask = sh.owner_gather_index(self.mesh, owner, c * self.rows + r)
        out = _Rows()
        coll, alone = _flush_alone(collector, self.mesh)
        coll.add_gather(lambda i, m: self.flat_t[:, i].T * m[:, None],
                        (idx, mask), lambda rows: setattr(out, "value", rows),
                        sharded=True)
        if alone:
            coll.flush()
            return out.value
        return out

    def eval_monomials_at(self, point):
        """The polys at the ext ``point`` (a host pair): (c0, c1) tensors
        (k,), replicated."""
        return eval_monomial_sets_at(self.mesh, [(self.monomials, point)])[0]


def eval_monomial_sets_at(mesh, sets, extra=()):
    """sets: (monomial rows (n/S, k), host ext point) pairs; each rank sums
    its rows' terms Σ c_j·z^j (j its global rows), and one gather with the
    field add sums the ranks'. ``extra``: (w,) tensors summed across the
    ranks with them (a value that one rank holds, zeros elsewhere).
    Returns, per set, the replicated (c0, c1) (k,) tensors, then the
    extras."""
    tables = {}
    parts = []
    for mono, point in sets:
        rows = mono.shape[0]
        key = (int(point[0]) % ORDER, int(point[1]) % ORDER)
        if key not in tables:
            pows = ext2.powers(key, rows, mono.device)
            start = ext2.s2_pow(key, mesh.rank * rows)  # z^(first row)
            tables[key] = ext2.scale(pows, start)
        parts.extend(dops.eval_monomials_at_ext(mono, tables[key]))
    parts.extend(extra)
    sizes = [p.shape[0] for p in parts]
    total = sh.distributed_sum_reduce(mesh, torch.cat(parts)[None])
    out = list(torch.split(total, sizes))
    pairs = [(out[2 * i], out[2 * i + 1]) for i in range(len(sets))]
    return pairs + out[2 * len(sets):]


def _vandermonde_inverse(points) -> list:
    """The inverse of V[c][k] = points[c]^k mod p (Gauss-Jordan on ints)."""
    q = len(points)
    a = [[pow(t, k, ORDER) for k in range(q)] + [int(r == c) for r in range(q)]
         for c, t in enumerate(points)]
    for col in range(q):
        piv = next(r for r in range(col, q) if a[r][col])
        a[col], a[piv] = a[piv], a[col]
        inv = pow(a[col][col], ORDER - 2, ORDER)
        a[col] = [v * inv % ORDER for v in a[col]]
        for r in range(q):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [(v - f * w) % ORDER for v, w in zip(a[r], a[col])]
    return [row[q:] for row in a]


@functools.lru_cache(maxsize=None)
def _quotient_tables(log_n: int, qd: int, n_shards: int, rank: int, device):
    """For the chunked quotient: s_c^(-j) over the rank's rows j, (n/S, qd),
    and the (qd, qd) matrix that maps R_c to the chunks Q_k."""
    n = 1 << log_n
    cosets = ntt.lde_cosets(log_n, qd)
    nl = n // n_shards
    unscale = np.stack([npgl.powers(gl.s_inv(s), n)[rank * nl:(rank + 1) * nl]
                        for s in cosets], axis=1)
    vinv = _vandermonde_inverse([pow(s, n, ORDER) for s in cosets])
    return (gl.from_u64(unscale, device),
            gl.from_u64(np.asarray(vinv, np.uint64), device))


def sharded_quotient_monomials(mesh, acc, qd: int) -> torch.Tensor:
    """The quotient's chunk monomials from its values on the flat domain:
    ``acc`` = (c0, c1), the rank's coset-major blocks (qd·n/S,) of the
    values on the qd cosets s_c·<ω> -> (n/S, 2·qd), column 2k + component
    the rank's rows of chunk k (Q = Σ_k X^{kn}·Q_k), as the single-device
    coset iNTT of the whole flat domain gives them.

    On coset c, Q(s_c·x) = Σ_k t_c^k·Q_k(s_c·x) with t_c = s_c^n, a poly
    R_c of degree < n: one distributed iNTT of all cosets' blocks gives
    the R_c (times s_c^j, divided out), and the inverse Vandermonde matrix
    of the t_c gives the Q_k, row by row on each rank."""
    rows = acc[0].shape[0] // qd
    log_n = _log2(rows * mesh.size)
    unscale, vinv = _quotient_tables(log_n, qd, mesh.size, mesh.rank,
                                     acc[0].device)
    vals = torch.stack([acc[0].reshape(qd, rows), acc[1].reshape(qd, rows)],
                       dim=2)  # (qd, rows, 2)
    a = sh.distributed_intt(mesh, vals.permute(1, 0, 2).reshape(rows, 2 * qd),
                            log_n)
    r = gl.mul(a.reshape(rows, qd, 2), unscale[:, :, None])  # R_c, (j, c, comp)
    q = gl.sum_mod(gl.mul(r[:, None], vinv[None, :, :, None]), 2)  # (j, k, comp)
    return q.reshape(rows, 2 * qd)


# ---------------------------------------------------------------------------
# FRI layers
# ---------------------------------------------------------------------------


class ShardedFlatOracle(DeviceFlatOracle):
    """A FRI layer sharded as the flat domain: ``c0``, ``c1`` the rank's
    coset-major blocks; leaf i holds the 2^k consecutive elements of chunk
    i, gathered by its owner."""

    def __init__(self, mesh, c0, c1, elems_per_leaf: int, tree):
        super().__init__(c0, c1, elems_per_leaf, tree)
        self.mesh = mesh

    def prefetch(self, flat_indices, collector=None):
        e = self.elems_per_leaf
        leaf_idxs = sorted(set(int(i) // e for i in flat_indices))
        coll, alone = _flush_alone(collector, self.mesh)
        self.tree.prefetch_proofs(leaf_idxs, coll)
        owner, local = self.tree.owner(leaf_idxs)
        starts, mask = sh.owner_gather_index(self.mesh, owner, local)

        def gather(starts, mask):
            gidx = (starts[:, None] * e
                    + torch.arange(e, device=starts.device)).reshape(-1)
            keep = mask.repeat_interleave(e)
            return torch.stack([self.c0[gidx], self.c1[gidx]]) * keep

        def ingest(both):
            v0 = both[0].reshape(-1, e)
            v1 = both[1].reshape(-1, e)
            for row, li in enumerate(leaf_idxs):
                self._chunk_cache[li] = ([int(x) for x in v0[row]],
                                         [int(x) for x in v1[row]])

        coll.add_gather(gather, (starts, mask), ingest, sharded=True)
        if alone:
            coll.flush()


def commit_sharded_layer(mesh, c0, c1, k: int, cap_size: int, hasher: str,
                         blocks: int) -> ShardedFlatOracle:
    """A sharded FRI layer's oracle: leaf columns (2·2^k, leaves) of the
    rank's blocks (leaf = [c0 chunk, c1 chunk]) and their sharded tree."""
    e = 1 << k
    leaves = c0.shape[0] // e
    cols = torch.cat([c0.reshape(leaves, e).T, c1.reshape(leaves, e).T])
    tree = sh.build_sharded_tree(mesh, cols, cap_size, hasher, blocks=blocks)
    return ShardedFlatOracle(mesh, c0, c1, e, tree)


def sharded_fold_roots(mesh, roots: torch.Tensor, blocks: int):
    """``roots_at(m)`` for a fold step over the rank's blocks: its m local
    pairs are, in each of the ``blocks`` cosets, the rank's block of the
    step's m·S global pairs, so it reads those blocks of the table's
    prefix."""
    S, d = mesh.size, mesh.rank

    def roots_at(m):
        return roots[:m * S].reshape(blocks, S, m // blocks)[:, d].reshape(-1)
    return roots_at
