# Port of boojum_tpu/prover/oracles.py (build_tree, CommittedOracle, FlatOracle, DeviceOracle) to torch tensors.
"""Committed oracles: LDE storage + Merkle-cap tree + query opening.

Reference behavior: the per-oracle flow in prover.rs (LDE columns -> tree ->
cap -> per-query leaf + path; OracleQuery::construct proof.rs:64). Leaf i of
an oracle holds one value per source poly at flat position i of the
(lde, n) bitreversed-coset layout; FRI oracles chunk 2^k consecutive flat
positions per leaf, c0 block then c1 block.

`CommittedOracle` and `FlatOracle` serve the host `prover.prove`: their
LDEs and trees are computed on a torch device (the kernels on a GPU) and
their values kept on the host. `DeviceOracle` serves `DeviceProver`: its
LDE stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import goldilocks as gl
from . import device as dops
from .device_merkle import _flush_alone, build_any_device_tree
from .proof import OracleQuery


def build_tree(leaf_cols_u64: np.ndarray, cap_size: int, hasher: str,
               device):
    """The Merkle-cap tree of host leaf columns (num_els_per_leaf,
    tree_size), built on ``device``."""
    return build_any_device_tree(gl.from_u64(leaf_cols_u64, device),
                                 cap_size, hasher)


class CommittedOracle:
    """A set of committed base polys: host Lagrange columns -> device
    monomials + LDEs -> Merkle tree, with host copies of the monomials and
    the LDE. ``polys`` order defines leaf layout."""

    def __init__(self, lagrange_cols_u64: np.ndarray, lde_factor: int,
                 cap_size: int, hasher: str, tree_lde: int = None,
                 device="cuda"):
        cols_dev = dops.to_device_cols(lagrange_cols_u64, device)  # (n, k)
        monomials = dops.cols_to_monomials(cols_dev)  # (n, k)
        self._init_from_monomials(monomials, lde_factor, cap_size, hasher,
                                  tree_lde)

    @classmethod
    def from_monomials(cls, monomials: torch.Tensor, lde_factor: int,
                       cap_size: int, hasher: str, tree_lde: int = None):
        self = cls.__new__(cls)
        self._init_from_monomials(monomials, lde_factor, cap_size, hasher,
                                  tree_lde)
        return self

    def _init_from_monomials(self, monomials, lde_factor, cap_size, hasher,
                             tree_lde):
        self.n = monomials.shape[0]
        self.num_polys = monomials.shape[1]
        self.lde_factor = lde_factor
        # bitreversed coset enumeration: the first L blocks of a larger LDE
        # ARE the L-coset LDE, so the tree can hash a prefix subset
        self.tree_lde = tree_lde or lde_factor
        assert self.tree_lde <= lde_factor
        self.monomials = monomials
        self.monomials_host = dops.from_device(monomials)  # (n, k)
        lde = dops.monomials_to_lde(monomials, lde_factor)  # (L, n, k)
        self.lde_host = dops.from_device(lde)
        # the leaf columns straight from the device LDE
        self.tree = build_any_device_tree(
            dops.leaf_columns(lde[:self.tree_lde]).contiguous(), cap_size,
            hasher)

    def get_cap(self):
        return self.tree.get_cap()

    def query(self, coset_idx: int, inner_idx: int) -> OracleQuery:
        leaf_idx = coset_idx * self.n + inner_idx
        leaf, path = self.tree.get_proof(leaf_idx)
        values = [int(self.lde_host[coset_idx, inner_idx, p])
                  for p in range(self.num_polys)]
        return OracleQuery(leaf_elements=values, proof=path)


class FlatOracle:
    """Oracle over flat (already folded) value arrays with 2^k-element leaf
    chunks: sources = [c0_flat, c1_flat] host u64 (FRI layers); the tree is
    built on ``device``."""

    def __init__(self, sources: list, elems_per_leaf: int, cap_size: int,
                 hasher: str, device="cuda"):
        self.sources = sources
        self.elems_per_leaf = elems_per_leaf
        size = sources[0].shape[0]
        tree_size = size // elems_per_leaf
        cols = np.concatenate(
            [s.reshape(tree_size, elems_per_leaf).T for s in sources], axis=0)
        self.tree = build_tree(cols, cap_size, hasher, device)

    def get_cap(self):
        return self.tree.get_cap()

    def query(self, flat_idx: int) -> OracleQuery:
        leaf_idx = flat_idx // self.elems_per_leaf
        leaf, path = self.tree.get_proof(leaf_idx)
        start = leaf_idx * self.elems_per_leaf
        values = []
        for s in self.sources:
            values.extend(int(x) for x in s[start:start + self.elems_per_leaf])
        return OracleQuery(leaf_elements=values, proof=path)


class DeviceOracle:
    """Device-resident oracle. ``flat_t`` is the transposed flat LDE, shaped
    (k, L·n): row p is poly p over the whole bitreversed-coset domain, so the
    Merkle leaf columns are its prefix and every per-poly consumer (quotient
    sweeps, DEEP sources, query gathers) reads a contiguous row."""

    def __init__(self, lagrange_cols, lde_factor: int, cap_size: int,
                 hasher: str, device, tree_lde: int = None, monomials=None):
        if monomials is None:
            if not isinstance(lagrange_cols, torch.Tensor):
                lagrange_cols = dops.to_device_cols(lagrange_cols, device)
            self.lagrange = lagrange_cols  # (n, k) plain-domain values
            monomials = dops.cols_to_monomials(lagrange_cols)
        else:
            self.lagrange = None
        self.monomials = monomials  # (n, k)
        self.n, self.num_polys = monomials.shape
        self.lde_factor = lde_factor
        self.tree_lde = tree_lde or lde_factor
        assert self.tree_lde <= lde_factor
        lde = dops.monomials_to_lde(monomials, lde_factor)  # (L, n, k)
        self.flat_t = lde.reshape(lde_factor * self.n, self.num_polys).T \
            .contiguous()
        del lde
        self.tree = build_any_device_tree(
            self.flat_t[:, :self.tree_lde * self.n], cap_size, hasher)

    def flat(self, poly: int, num_cosets: int) -> torch.Tensor:
        """Poly ``poly`` over the first ``num_cosets`` cosets, flat (c·n,)."""
        return self.flat_t[poly, :num_cosets * self.n]

    def get_cap(self):
        return self.tree.get_cap()

    def query_many(self, flat_indices, collector=None):
        """Leaf values of all queries at once -> (q, k) host u64. With a
        ``collector`` the gather rides its flush, and the returned holder
        has the rows as ``.value`` once it has flushed."""
        idx = dops.upload(np.asarray(flat_indices, np.int64),
                          self.flat_t.device)
        out = _Rows()
        coll, alone = _flush_alone(collector)
        coll.add_gather(lambda i: self.flat_t[:, i].T, (idx,),
                        lambda rows: setattr(out, "value", rows))
        if alone:
            coll.flush()
            return out.value
        return out

    def query(self, coset_idx: int, inner_idx: int, cached_rows,
              row_pos: int) -> OracleQuery:
        leaf_idx = coset_idx * self.n + inner_idx
        _, path = self.tree.get_proof(leaf_idx)
        vals = cached_rows[row_pos]
        return OracleQuery(leaf_elements=[int(v) for v in vals], proof=path)


class _Rows:
    """Rows of a deferred `DeviceOracle.query_many`, set at the flush."""

    __slots__ = ("value",)


def eval_monomial_sets_at(sets) -> list:
    """sets: list of (monomials (n, k), point) with ``point`` an ext scalar:
    a (c0, c1) tuple of host ints, or a device scalar (a `PreparedExt` or a
    (2,) tensor). Returns, per set,
    the two (k,) component tensors (Σ c_i·(z^i)_c0, Σ c_i·(z^i)_c1) on the
    device; one power table per distinct point."""
    tables = {}
    out = []
    for mono, point in sets:
        dev_point = not isinstance(point, tuple)
        key = id(point) if dev_point else (int(point[0]), int(point[1]))
        if key not in tables:
            tables[key] = dops.powers_of_ext(
                point if dev_point else key, mono.shape[0], mono.device)
        out.append(dops.eval_monomials_at_ext(mono, tables[key]))
    return out
