# Port of boojum_tpu/prover/oracles.py (DeviceOracle) to torch tensors.
"""Committed oracles: device LDE storage + Merkle-cap tree + query opening.

Reference behavior: the per-oracle flow in prover.rs (LDE columns -> tree ->
cap -> per-query leaf + path; OracleQuery::construct proof.rs:64). Leaf i of
an oracle holds one value per source poly at flat position i of the
(lde, n) bitreversed-coset layout.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as dops
from .device_merkle import TREE_HASHERS, _flush_alone, build_any_device_tree
from .proof import OracleQuery


class DeviceOracle:
    """Device-resident oracle. ``flat_t`` is the transposed flat LDE, shaped
    (k, L·n): row p is poly p over the whole bitreversed-coset domain, so the
    Merkle leaf columns are its prefix and every per-poly consumer (quotient
    sweeps, DEEP sources, query gathers) reads a contiguous row."""

    def __init__(self, lagrange_cols, lde_factor: int, cap_size: int,
                 hasher: str, device, tree_lde: int = None, monomials=None):
        if hasher not in TREE_HASHERS:
            raise NotImplementedError("the %r tree hasher is not ported"
                                      % (hasher,))
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
