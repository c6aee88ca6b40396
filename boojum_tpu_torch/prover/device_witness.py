# Port of boojum_tpu/prover/device_witness.py to torch tensors.
"""On-device witness materialization.

The recorded witness program (cs/resolver.py) is a short list of vectorized
nodes; when every computation node carries a ``device_twin`` (a torch mirror
of its numpy closure: int64 tensors of u64 bit patterns in, the same out) or
``device_lookup`` metadata (multiplicity counting), the whole program runs
on the device:

    (the set values: circuit inputs and constants, one int64 upload)
        -> one write into a device value buffer
        -> per twin node: gather -> twin -> scatter
        -> multiplicity counts, the column gathers
        -> the witness oracle's (n, K) Lagrange matrix

Only the circuit inputs cross to the device, in place of the host path's
witness columns (`prover.materialize_witness_columns`). This is the
device-side answer to the reference's ``take_witness_using_hints``
(src/cs/implementations/witness.rs:325). The twins compute the same integer
values, so the columns and proofs are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cs import places
from .device import upload

# a packed table key space up to this size counts through a dense key -> row
# map, a larger one through searchsorted on the sorted packed table
_DENSE_KEYS = 1 << 16


def _table_shift(tbl):
    """Per-key bit shift for a 32-bit packing of the table keys, or None if
    the keys cannot fit 32 bits. Packing with a smaller shift is
    order-isomorphic to the host's 16-bit-shift u64 packing (lexicographic
    either way), so the host's sort order carries over (asserted at build)."""
    tbl._ensure_index()
    keys = [tbl.content[:, i] for i in range(tbl.num_keys)]
    s = max(max(int(k.max(initial=0)).bit_length(), 1) for k in keys)
    if tbl.num_keys * s > 32:
        return None
    return s


def _pack(keys: list, s: int):
    packed = keys[0]
    for k in keys[1:]:
        packed = (packed << s) | k
    return packed


class DeviceWitnessProgram:
    """The device witness materializer of one circuit on ``device``: the
    GPU unless the caller passes another."""

    def __init__(self, cs, n: int, device="cuda"):
        self.cs = cs
        self.n = n
        self.device = torch.device(device)
        self._build(cs, n)

    @staticmethod
    def supported(cs) -> bool:
        if cs.public_inputs:
            return False  # the host needs public values before the prove
        if cs.resolver is None or not cs.resolver.record:
            return False
        for fn, ins, outs in cs.resolver.record:
            if fn is None:
                continue
            if getattr(fn, "device_twin", None) is not None:
                continue
            if getattr(fn, "device_lookup", None) is not None:
                # multiplicity counting is re-derived from the placed lookup
                # instances (lookup_multiplicity_groups), not this node
                continue
            return False
        if cs.lookup_parameters.lookup_is_allowed:
            for tbl in cs.lookup_tables:
                if _table_shift(tbl) is None:
                    return False
        return True

    def _build(self, cs, n: int):
        dev = self.device

        def up(arr):  # static index data: uploaded once, here
            return torch.as_tensor(np.asarray(arr, np.int64)).to(dev)

        # every set node merges into ONE write at the top: a set node never
        # depends on anything and every place resolves exactly once
        # (resolver invariant), so hoisting preserves the semantics
        self._nodes = []  # (twin, in_idx, ins shape, out_idx)
        set_vals, set_places = [], []
        v_max = 0
        for fn, ins, outs in cs.resolver.record:
            out_idx = places.index_of(np.asarray(outs, np.uint64))
            if out_idx.size:
                v_max = max(v_max, int(out_idx.max()))
            if fn is None:
                set_vals.append(np.asarray(ins, np.uint64).reshape(-1))
                set_places.append(np.asarray(outs, np.uint64).reshape(-1))
            elif getattr(fn, "device_lookup", None) is None:
                in_idx = places.index_of(np.asarray(ins, np.uint64))
                if in_idx.size:
                    v_max = max(v_max, int(in_idx.max()))
                self._nodes.append((fn.device_twin, up(in_idx.reshape(-1)),
                                    tuple(ins.shape), up(out_idx.reshape(-1))))
        # multiplicity counting: static per-table groups of placed lookup
        # instances (mirrors recount_multiplicities, so padding lookups,
        # which never enter the record, are counted and replay_witness stays
        # correct)
        groups = []  # (tbl_idx, key_idx (num_keys, cnt))
        for tbl_idx, key_places in cs.lookup_multiplicity_groups():
            key_idx = places.index_of(key_places)
            if key_idx.size:
                v_max = max(v_max, int(key_idx.max()))
            groups.append((tbl_idx, key_idx))
        #: concatenated (values, places) of every set node: the program's
        #: inputs, replayable with new values through __call__(overrides)
        self._set_values = (np.concatenate(set_vals) if set_vals
                            else np.zeros(0, np.uint64))
        set_places_flat = (np.concatenate(set_places) if set_places
                           else np.zeros(0, np.uint64))
        self._set_pos = {int(p): i for i, p in enumerate(set_places_flat)}
        set_out_idx = places.index_of(set_places_flat)
        if set_out_idx.size:
            v_max = max(v_max, int(set_out_idx.max()))
        self._V = v_max + 1
        # width classes of the recorded inputs: overrides must keep them
        self._idx8 = np.nonzero(self._set_values < (1 << 8))[0]
        self._idx32 = np.nonzero((self._set_values >= (1 << 8))
                                 & (self._set_values < (1 << 32)))[0]
        # the resolver allocates set places in order, so the set values are
        # usually one contiguous slice of the buffer
        self._set_start = None
        self._set_idx = up(set_out_idx)
        if set_out_idx.size and np.array_equal(
                set_out_idx, np.arange(set_out_idx[0],
                                       set_out_idx[0] + set_out_idx.size)):
            self._set_start = int(set_out_idx[0])

        # multiplicity counting per group: the packed keys index a dense
        # key -> table row map when the packed key space is small, else they
        # are searched in the sorted packed table (as the JAX program does)
        lp = cs.lookup_parameters
        self._mult_sizes = ([m.shape[0] for m in cs.lookup_multiplicities]
                            if lp.lookup_is_allowed else [])
        self._has_mult = lp.lookup_is_allowed
        self._mult = []  # (tbl_idx, key_idx, shape, shift, lut or (sorted, order))
        for tbl_idx, key_idx in groups:
            tbl = cs.lookup_tables[tbl_idx]
            s = _table_shift(tbl)
            keys = [tbl.content[:, i].astype(np.uint64)
                    for i in range(tbl.num_keys)]
            packed = _pack(keys, np.uint64(s)).astype(np.int64)
            if (1 << (tbl.num_keys * s)) <= _DENSE_KEYS:
                lut = np.zeros(1 << (tbl.num_keys * s), np.int64)
                lut[packed] = np.arange(packed.shape[0])
                how = ("dense", up(lut))
            else:
                order = np.asarray(tbl._sort_order, np.int64)
                srt = packed[order]
                assert np.all(srt[1:] > srt[:-1]), \
                    "the device table packing must keep the host sort order"
                how = ("sorted", up(srt), up(order))
            self._mult.append((tbl_idx, up(key_idx.reshape(-1)),
                               tuple(key_idx.shape), s, how))

        # column gathers and placeholder masks, in the prover's leaf order:
        # copy, specialized, witness (the multiplicity column follows)
        def col_meta(data):
            if data is None or data.shape[0] == 0:
                return None
            d = data[:, :n]
            idx = places.index_of(d).astype(np.int64)
            ph = (d & np.uint64(places.PLACEHOLDER_BIT)) != 0
            return up(np.minimum(idx, self._V - 1)), \
                torch.as_tensor(ph).to(dev)

        metas = [col_meta(cs.copy_permutation_data)]
        if cs.specialized_copy_data is not None:
            metas.append(col_meta(cs.specialized_copy_data))
        if cs.gate_spec_data is not None:
            metas.append(col_meta(cs.gate_spec_data))
        metas.append(col_meta(cs.witness_placement_data))
        self._cols = [m for m in metas if m is not None]

    def __call__(self, overrides: dict = None) -> torch.Tensor:
        """Run the device program -> the witness oracle's Lagrange matrix
        (n, K) int64 on the device, columns in leaf order (copy,
        specialized, witness, multiplicity).

        ``overrides`` maps input PLACES to new values (the replay_witness
        contract, cs/resolver.py): only the input values change; everything
        else recomputes on the device."""
        vals = self._set_values
        if overrides:
            vals = vals.copy()
            for p, v in overrides.items():
                pos = self._set_pos.get(int(p))
                if pos is not None:
                    vals[pos] = v
            # overrides must keep the recorded width classes (circuit inputs
            # keep their value range across replays by construction)
            assert (vals[self._idx8] < (1 << 8)).all() and \
                (vals[self._idx32] < (1 << 32)).all(), \
                "override value exceeds its recorded width class"
        dev = self.device
        set_vals = upload(vals, dev)
        buf = torch.zeros(self._V, dtype=torch.int64, device=dev)
        if self._set_start is not None:
            buf[self._set_start:self._set_start + set_vals.shape[0]] = set_vals
        elif set_vals.shape[0]:
            buf.index_copy_(0, self._set_idx, set_vals)
        for twin, in_idx, ins_shape, out_idx in self._nodes:
            out = twin(buf[in_idx].reshape(ins_shape))
            buf.index_copy_(0, out_idx, out.reshape(-1))

        mults = [torch.zeros(sz, dtype=torch.int64, device=dev)
                 for sz in self._mult_sizes]
        for tbl_idx, key_idx, shape, s, how in self._mult:
            keys = buf[key_idx].reshape(shape)
            packed = _pack([keys[i] for i in range(shape[0])], s)
            if how[0] == "dense":
                rows = how[1][packed]
            else:
                rows = how[2][torch.searchsorted(how[1], packed)]
            mults[tbl_idx].index_add_(0, rows, torch.ones_like(rows))

        groups = []
        for idx, ph in self._cols:
            g = buf[idx]
            groups.append(torch.where(ph, torch.zeros_like(g), g))
        if self._has_mult:
            pad = self.n - sum(self._mult_sizes)
            groups.append(torch.cat(
                mults + [buf.new_zeros(pad)])[None, :])
        return torch.cat(groups, dim=0).T.contiguous()
