# Copied from boojum_tpu/cs/resolver.py.
"""Witness resolver: dependency-ordered vectorized witness program.

Replaces the reference's lock-free multithreaded DAG resolver (src/dag/,
7.5k LoC — MtCircuitResolver, Guide, ResolutionWindow) with the TPU-idiomatic
design from SURVEY §2.6: gadgets register *vectorized* resolution nodes
(numpy closures over whole variable batches); execution is immediate (gadget
code registers dependencies after their inputs exist — the invariant the
reference's StCircuitResolver also relies on), and every node is recorded so
repeated proving replays the program without re-synthesis (the reference's
ResolutionRecord playback, src/dag/resolvers/mt/sorters/sorter_playback.rs).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from . import places

_GROW = 1 << 16


class WitnessResolver:
    def __init__(self, max_variables: int = 1 << 26, paranoia: bool = False):
        self.max_variables = max_variables
        #: cr_paranoia analogue (reference src/dag/resolvers/mt/mod.rs:172):
        #: assert every resolution input is already resolved instead of
        #: silently reading 0 — the TPU-design equivalent of the reference's
        #: resolver-order tracking (our invariant is immediate execution).
        self.paranoia = paranoia
        self.values = np.zeros(_GROW, np.uint64)
        self.resolved = np.zeros(_GROW, bool)
        self.record: list[tuple[Callable | None, np.ndarray | None, np.ndarray]] = []
        self.track_record = True
        # observability (reference resolver Stats, src/dag/resolvers/mt/mod.rs:51)
        self.stats = {"registrations": 0, "values_set": 0,
                      "resolution_fn_calls": 0, "resolution_time_s": 0.0}

    def _ensure(self, max_idx: int):
        if max_idx >= self.values.shape[0]:
            new_size = max(self.values.shape[0] * 2, max_idx + 1)
            self.values = np.resize(self.values, new_size)
            self.values[max_idx:] = 0
            self.resolved = np.resize(self.resolved, new_size)
            self.resolved[max_idx:] = False

    # -- write paths ---------------------------------------------------------

    def set_value(self, place: int, value: int):
        idx = places.index_of(place)
        self._ensure(idx)
        self.values[idx] = value
        self.resolved[idx] = True
        if self.track_record:
            self.record.append((None, np.asarray([value], np.uint64),
                                np.asarray([place], np.uint64)))

    def set_values(self, plcs, values):
        """Vectorized set of constants: plcs/values are 1-D arrays."""
        plcs = np.asarray(plcs, np.uint64)
        values = np.asarray(values, np.uint64)
        idx = places.index_of(plcs)
        if idx.size:
            self._ensure(int(idx.max()))
            self.values[idx] = values
            self.resolved[idx] = True
        if self.track_record:
            self.record.append((None, values.copy(), plcs.copy()))

    def add_resolution(self, ins, outs, fn: Callable):
        """fn maps the gathered input value array (same shape as ``ins``) to
        an array shaped like ``outs``. Executed immediately; recorded for
        playback. ``ins``/``outs`` may be any-shaped uint64 place arrays."""
        import time as _time
        ins = np.asarray(ins, np.uint64)
        outs = np.asarray(outs, np.uint64)
        in_idx = places.index_of(ins)
        if self.paranoia and in_idx.size:
            flat = in_idx.reshape(-1)
            in_range = flat < self.resolved.shape[0]
            ok = np.zeros(flat.shape, bool)
            ok[in_range] = self.resolved[flat[in_range]]
            if not ok.all():
                bad = ins.reshape(-1)[~ok][:8]
                raise AssertionError(
                    f"paranoia: resolution reads unresolved places {bad}")
        _t0 = _time.perf_counter()
        out_vals = np.asarray(fn(self.values[in_idx]), np.uint64)
        self.stats["resolution_fn_calls"] += 1
        self.stats["resolution_time_s"] += _time.perf_counter() - _t0
        self.stats["registrations"] += 1
        self.stats["values_set"] += int(out_vals.size)
        out_idx = places.index_of(outs)
        if out_idx.size:
            self._ensure(int(out_idx.max()))
            self.values[out_idx] = out_vals.reshape(out_idx.shape)
            self.resolved[out_idx] = True
        if self.track_record:
            self.record.append((fn, ins.copy(), outs.copy()))

    # -- read paths ----------------------------------------------------------

    def get_value(self, place: int) -> int:
        idx = places.index_of(place)
        assert self.resolved[idx], f"place {place} not resolved"
        return int(self.values[idx])

    def get_values(self, plcs) -> np.ndarray:
        idx = places.index_of(np.asarray(plcs, np.uint64))
        return self.values[idx]

    # -- playback ------------------------------------------------------------

    def playback(self, record, overrides: dict = None) -> "WitnessResolver":
        """Execute a recorded program into a fresh resolver (no re-recording).

        ``overrides`` maps input places to NEW values: repeated proving of
        the same circuit with fresh inputs replays the witness program
        without re-synthesis (reference prove_from_witness_vec /
        ResolutionRecord playback, convenience.rs:151,
        sorters/sorter_playback.rs:28)."""
        out = WitnessResolver(self.max_variables, paranoia=self.paranoia)
        out.track_record = False
        if overrides:
            okeys = np.fromiter(overrides.keys(), np.uint64,
                                count=len(overrides))
            ovals = np.fromiter((overrides[int(k)] for k in okeys), np.uint64,
                                count=len(overrides))
            order = np.argsort(okeys)
            okeys, ovals = okeys[order], ovals[order]
        for fn, ins, outs in record:
            if fn is None:
                vals = ins
                if overrides:
                    flat = outs.reshape(-1)
                    pos = np.searchsorted(okeys, flat)
                    pos = np.minimum(pos, okeys.shape[0] - 1)
                    hit = okeys[pos] == flat
                    if hit.any():
                        vals = ins.reshape(-1).copy()
                        vals[hit] = ovals[pos[hit]]
                        vals = vals.reshape(ins.shape)
                out.set_values(outs, vals)
            else:
                out.add_resolution(ins, outs, fn)
        return out
