# Copied from boojum_tpu/cs/cs.py.
"""The constraint system: synthesis-time state + frozen assembly.

Reference behavior: src/cs/implementations/reference_cs.rs (state fields :26),
src/cs/implementations/cs.rs (ConstraintSystem impl), gate placement helpers
(src/cs/gates/mod.rs:176-341), lookup placement
(src/cs/implementations/lookup_placement.rs), pad_and_shrink
(src/cs/implementations/setup.rs:99-373).

TPU-first deviations from the reference:
- trace handle storage is preallocated numpy (columns x max_trace_len uint64)
  so gadget batches place thousands of gate instances with vectorized
  scatters instead of per-instance method calls;
- the witness "DAG" is the vectorized immediate resolver
  (boojum_tpu_torch.cs.resolver);
- gate evaluators are registered as plain Python objects evaluated through
  the ops protocol (no type-level machinery; dead paths are cut by config
  flags at runtime, cf. src/config.rs type-level configs).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils import npgl
from . import places
from .geometry import CSGeometry, LookupParameters, INITIAL_LOOKUP_TABLE_ID_VALUE
from .resolver import WitnessResolver


@dataclass(frozen=True)
class CSConfig:
    """Runtime analogue of the reference's type-level CSConfig presets
    (src/config.rs:27-131)."""

    evaluate_witness: bool = True
    keep_setup: bool = True
    runtime_asserts: bool = True
    #: cr_paranoia analogue (reference feature "cr_paranoia_mode",
    #: src/dag/resolvers/mt/mod.rs:172): deep witness-resolver invariant
    #: checks — every resolution input must already be resolved (instead of
    #: silently reading 0), and pad_and_shrink verifies every variable placed
    #: in the trace was resolved. Costs a mask gather per resolution node.
    paranoia: bool = False

    @staticmethod
    def dev():
        return CSConfig(True, True, True)

    @staticmethod
    def paranoid():
        return CSConfig(True, True, True, True)

    @staticmethod
    def setup():
        return CSConfig(False, True, False)

    @staticmethod
    def proving():
        return CSConfig(True, False, False)


@dataclass
class LookupTable:
    """A lookup table: content rows are (keys..., values...) canonical u64.

    Reference: src/cs/implementations/lookup_table.rs:188. ``content`` is a
    numpy (num_rows, width) array; lookup_row resolves key tuples to row ids.
    """

    name: str
    content: np.ndarray  # (num_rows, width) uint64
    num_keys: int

    # packed sorted-key index for vectorized lookups (built lazily)
    _packed_sorted: np.ndarray = field(default=None, repr=False)
    _sort_order: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        self.content = np.asarray(self.content, np.uint64)

    @property
    def width(self):
        return self.content.shape[1]

    def __len__(self):
        return self.content.shape[0]

    def _pack(self, key_cols) -> np.ndarray:
        """Pack key columns into one u64 (keys are table inputs — each fits
        16 bits for every reference table shape; asserted when indexing)."""
        packed = key_cols[0].astype(np.uint64)
        for c in key_cols[1:]:
            packed = (packed << np.uint64(16)) | c.astype(np.uint64)
        return packed

    def _ensure_index(self):
        if self._packed_sorted is None:
            keys = [self.content[:, i] for i in range(self.num_keys)]
            for c in keys[1:]:
                assert int(c.max(initial=0)) < (1 << 16), \
                    "non-leading lookup key exceeds 16 bits"
            packed = self._pack(keys)
            order = np.argsort(packed, kind="stable")
            self._sort_order = order
            self._packed_sorted = packed[order]

    def lookup_rows(self, keys: np.ndarray) -> np.ndarray:
        """keys: (num_keys, n) -> row indices (n,) via packed-key
        searchsorted (vectorized; replaces the per-element dict loop)."""
        self._ensure_index()
        packed = self._pack([keys[i] for i in range(self.num_keys)])
        pos = np.searchsorted(self._packed_sorted, packed)
        if pos.size and (pos.max(initial=0) >= self._packed_sorted.size or
                         not np.array_equal(self._packed_sorted[pos], packed)):
            bad = np.nonzero(self._packed_sorted[
                np.minimum(pos, self._packed_sorted.size - 1)] != packed)[0]
            raise KeyError(f"lookup key not in table '{self.name}' "
                           f"(first bad input index {int(bad[0])})")
        return self._sort_order[pos]

    def lookup_values(self, keys: np.ndarray) -> np.ndarray:
        rows = self.lookup_rows(keys)
        return self.content[rows, self.num_keys:].T.copy()


def _lookup_columns_cleanup(cs: "ConstraintSystem", final_len: int):
    """Pad partial lookup rows with their own table's first row, and fill all
    vacant rows below ``final_len`` with table-1 dummy lookups, counting
    multiplicities (reference lookup_marker.rs pad_partial_rows /
    pad_full_rows)."""
    lp = cs.lookup_parameters
    pw = lp.specialized_columns_per_repetition()
    cap = lp.num_repetitions

    def pad_instances(table_idx: int, row: int, start_rep: int, count: int):
        table = cs.lookup_tables[table_idx]
        first = table.content[0]
        if cs.config.evaluate_witness:
            cs.lookup_multiplicities[table_idx][0] += count
            vs = cs.alloc_variables_with_values(np.tile(first, count))
        else:
            vs = cs.alloc_variables(count * table.width)
        vs = vs.reshape(count, table.width)
        table_id = table_idx + INITIAL_LOOKUP_TABLE_ID_VALUE
        for r in range(count):
            rep = start_rep + r
            for j in range(table.width):
                cs.specialized_copy_data[rep * pw + j, row] = vs[r, j]
            if lp.id_in_constant:
                if not lp.share_table_id:
                    cs.specialized_constants[rep, row] = table_id
            else:
                cs.specialized_copy_data[rep * pw + table.width, row] = \
                    cs.table_ids_as_variables[table_idx]

    # partial rows per tooling slot (per table for id-in-constant; the one
    # shared slot pads with table 1 for id-as-variable)
    for t_idx, state in enumerate(cs.lookup_tooling):
        if state is not None:
            row, count = state
            pad_instances(t_idx, row, count, cap - count)
            cs.lookup_tooling[t_idx] = None
    # full vacant rows -> table 1 (index 0)
    for row in range(cs.lookup_next_row, final_len):
        if lp.id_in_constant and lp.share_table_id:
            cs.specialized_constants[0, row] = INITIAL_LOOKUP_TABLE_ID_VALUE
        pad_instances(0, row, 0, cap)
    cs.lookup_next_row = final_len


def _general_lookup_partial_row_cleanup(cs: "ConstraintSystem", final_len: int):
    """Fill partially-occupied general-purpose lookup rows with real lookups
    of the row's own table (first content row), counting multiplicities — the
    general-mode analogue of the reference's pad_partial_rows
    (lookup_marker.rs LookupFinalizationHint). Unlike specialized mode there
    is no full-row padding: rows without the marker gate have selector 0 and
    contribute nothing to the A polys."""
    lp = cs.lookup_parameters
    tool = cs.tooling.get("lookup_formal", {})
    marker = cs.evaluators_general[cs.general_idx_by_name["lookup_formal"]]
    cap = marker.num_repetitions(cs.geometry)
    for key in list(tool.keys()):
        _, tid = key
        table_id = tid if lp.id_in_constant else INITIAL_LOOKUP_TABLE_ID_VALUE
        table = cs.get_table(table_id)
        _, count = tool[key]
        num_to_add = cap - count
        first = table.content[0]
        if cs.config.evaluate_witness:
            vs = cs.alloc_variables_with_values(np.tile(first, num_to_add))
        else:
            vs = cs.alloc_variables(num_to_add * table.width)
        kv = vs.reshape(num_to_add, table.width).T
        cs._enforce_lookup_general_batch(table_id, kv)
        assert key not in tool, "partial lookup row not filled"


class ConstraintSystem:
    def __init__(self, geometry: CSGeometry, max_trace_len: int,
                 config: CSConfig = None, max_variables: int = 1 << 26):
        self.geometry = geometry
        self.max_trace_len = max_trace_len
        self.config = config or CSConfig.dev()
        self.lookup_parameters = LookupParameters.no_lookup()

        nc = geometry.num_columns_under_copy_permutation
        nw = geometry.num_witness_columns
        if self.config.keep_setup:
            self.copy_permutation_data = np.full(
                (nc, max_trace_len), places.PLACEHOLDER, np.uint64)
            self.witness_placement_data = np.full(
                (nw, max_trace_len), places.PLACEHOLDER, np.uint64) if nw else \
                np.zeros((0, max_trace_len), np.uint64)
        else:
            self.copy_permutation_data = None
            self.witness_placement_data = None
        self.constants_requested_per_row: list[list[int]] = []
        self.gates_application_sets: list[int] = []
        self.next_available_row = 0
        self.next_place_idx = 0

        # specialized-column storage (lookups)
        self.specialized_copy_data = None  # allocated on allow_lookup
        self.specialized_constants = None
        self.specialized_next_row = 0
        # specialized GATE columns (reference GatePlacementType::UniqueOnRow
        # over dedicated columns, tiling every row — keccak-style configs)
        self.gate_spec_data = None  # (total_cols, max_trace) handle storage
        self.gate_spec_layout = []  # (name, start_col, reps)
        self.gate_spec_next_row = {}  # name -> next row

        # evaluator registries
        self.evaluators_general = []  # ordered GateEvaluator list
        self.general_idx_by_name: dict[str, int] = {}
        self.evaluators_specialized = []
        self.specialized_idx_by_name: dict[str, int] = {}
        self.placement_strategy: dict[str, str] = {}  # name -> 'general'|'specialized'

        # tooling
        self.tooling: dict[str, dict] = {}
        self.static_tools: dict[str, dict] = {}
        self.lookup_tooling: list = []  # per table: None | (row, count)
        self.lookup_next_row = 0
        self.table_ids_as_variables: list[int] = []  # id-as-variable modes

        self.lookup_tables: list[LookupTable] = []
        self.lookup_multiplicities: list[np.ndarray] = []

        self.public_inputs: list[tuple[int, int]] = []
        self.row_cleanups = []
        self.columns_cleanups = []

        self.resolver = WitnessResolver(max_variables,
                                        paranoia=self.config.paranoia) \
            if self.config.evaluate_witness else None

    # -- registration --------------------------------------------------------

    def allow_gate(self, gate_cls, placement: str = "general", params=None,
                   specialized_reps: int = 1):
        ev = gate_cls.make_evaluator(params) if params is not None \
            else gate_cls.make_evaluator()
        self.allow_evaluator(ev, placement, specialized_reps)
        if hasattr(gate_cls, "init_tools"):
            gate_cls.init_tools(self)
        return self

    def allow_evaluator(self, ev, placement: str = "general",
                        specialized_reps: int = 1):
        """Register a prebuilt evaluator instance (parametrized gates)."""
        if ev.name in self.placement_strategy:
            return self
        self.placement_strategy[ev.name] = placement
        if placement == "general":
            self.general_idx_by_name[ev.name] = len(self.evaluators_general)
            self.evaluators_general.append(ev)
        else:
            # specialized gate: claim a dedicated column block, active every
            # row (no selectors); constants must be baked into the evaluator
            assert getattr(ev, "num_constants", 0) == 0, \
                "specialized gates keep constants inside the evaluator"
            assert getattr(ev, "num_witnesses", 0) == 0
            self.specialized_idx_by_name[ev.name] = len(self.evaluators_specialized)
            self.evaluators_specialized.append(ev)
            ncols = ev.num_variables * specialized_reps
            start = self.gate_spec_data.shape[0] if self.gate_spec_data is not None else 0
            if self.config.keep_setup:
                block = np.full((ncols, self.max_trace_len), places.PLACEHOLDER,
                                np.uint64)
                self.gate_spec_data = block if self.gate_spec_data is None else \
                    np.concatenate([self.gate_spec_data, block], axis=0)
            self.gate_spec_layout.append((ev.name, start, specialized_reps))
            self.gate_spec_next_row[ev.name] = 0
        self.tooling[ev.name] = {}
        return self

    def place_specialized_gate_batch(self, name: str, vars_2d: np.ndarray):
        """Place n instances of a specialized gate, tiling ``reps`` per row
        in its dedicated column block (active on every row; vacant rows hold
        zeros, so the relation must vanish on the all-zero assignment)."""
        if not self.config.keep_setup:
            return
        (_, start, reps), = [t for t in self.gate_spec_layout if t[0] == name]
        ev = self.evaluators_specialized[self.specialized_idx_by_name[name]]
        pw = ev.num_variables
        vars_2d = np.asarray(vars_2d, np.uint64)
        n = vars_2d.shape[0]
        assert vars_2d.shape[1] == pw
        row0 = self.gate_spec_next_row[name]
        idx = np.arange(n)
        rows = row0 + idx // reps
        offs = idx % reps
        for j in range(pw):
            self.gate_spec_data[start + offs * pw + j, rows] = vars_2d[:, j]
        self.gate_spec_next_row[name] = int(rows[-1]) + 1

    def gate_is_allowed(self, name: str) -> bool:
        return name in self.placement_strategy

    def allow_lookup(self, params: LookupParameters):
        assert not self.lookup_parameters.lookup_is_allowed
        self.lookup_parameters = params
        if params.is_specialized and self.config.keep_setup:
            ncols = params.total_specialized_lookup_variable_columns()
            self.specialized_copy_data = np.full(
                (ncols, self.max_trace_len), places.PLACEHOLDER, np.uint64)
            nconst = params.total_specialized_lookup_constant_columns()
            self.specialized_constants = np.zeros(
                (nconst, self.max_trace_len), np.uint64)
            # every trace row must carry valid lookups in every repetition
            # (A(x)·(Σγⁱcolᵢ+β) == 1 holds on ALL rows — reference
            # lookup_marker.rs:259 columns_finalization_function)
            self.columns_cleanups.append(_lookup_columns_cleanup)
        elif not params.is_specialized:
            # GENERAL-PURPOSE lookups: the LookupFormalGate marker must be
            # general evaluator 0 (reference compute_table_ids_column_idxes,
            # setup.rs:963, asserts lookup_table_evaluator_idx == 0)
            assert len(self.evaluators_general) == 0, \
                "allow_lookup (general-purpose) must precede gate registration"
            from .gates.simple import LookupMarkerEvaluator
            self.allow_evaluator(LookupMarkerEvaluator(
                params.columns_per_subargument(), params.id_in_constant),
                "general")
            self.columns_cleanups.append(_general_lookup_partial_row_cleanup)
        return self

    # -- variables -----------------------------------------------------------

    def alloc_variable(self) -> int:
        idx = self.next_place_idx
        self.next_place_idx += 1
        return idx

    def alloc_variables(self, n: int) -> np.ndarray:
        start = self.next_place_idx
        self.next_place_idx += n
        return np.arange(start, start + n, dtype=np.uint64)

    def alloc_witness(self) -> int:
        return self.alloc_variable() | places.WITNESS_BIT

    def alloc_witness_with_value(self, value: int) -> int:
        w = self.alloc_witness()
        if self.resolver is not None:
            self.resolver.set_value(w, value % npgl.ORDER)
        return w

    def alloc_variable_with_value(self, value: int) -> int:
        v = self.alloc_variable()
        if self.resolver is not None:
            self.resolver.set_value(v, value % npgl.ORDER)
        return v

    def alloc_variables_with_values(self, values) -> np.ndarray:
        values = np.asarray(values, np.uint64)
        vs = self.alloc_variables(values.shape[0])
        if self.resolver is not None:
            self.resolver.set_values(vs, values)
        return vs

    def set_values_with_dependencies(self, ins, outs, fn):
        if self.resolver is not None:
            self.resolver.add_resolution(ins, outs, fn)

    def get_value(self, place) -> int:
        return self.resolver.get_value(place)

    def get_values(self, plcs) -> np.ndarray:
        return self.resolver.get_values(plcs)

    # -- row claiming / placement -------------------------------------------

    def _claim_rows(self, m: int, evaluator_idx: int) -> np.ndarray:
        start = self.next_available_row
        assert start + m <= self.max_trace_len, "out of trace rows"
        self.next_available_row += m
        self.gates_application_sets.extend([evaluator_idx] * m)
        self.constants_requested_per_row.extend([] for _ in range(m))
        return np.arange(start, start + m, dtype=np.int64)

    def place_general_gate_batch(self, name: str, key, constants: list[int],
                                 vars_2d: np.ndarray, constants_per_instance=False,
                                 wits_2d: np.ndarray = None):
        """Place n instances of a general-purpose gate sharing tooling ``key``.

        vars_2d: (n, principal_width) variable handles. ``constants`` are the
        row-shared constants (written once per claimed row) unless
        ``constants_per_instance`` (ConstantsAllocator-style: each instance
        appends its own constants to the row). ``wits_2d``: (n, num_witnesses)
        witness places for gates that keep non-copiable values in witness
        columns (reference SatisfiabilityCheckRowView witness section).

        Mirrors find_next_gate (src/cs/gates/mod.rs:176) batched.
        """
        if not self.config.keep_setup:
            return
        ev_idx = self.general_idx_by_name[name]
        ev = self.evaluators_general[ev_idx]
        cap = ev.num_repetitions(self.geometry)
        vars_2d = np.asarray(vars_2d, np.uint64)
        n, pw = vars_2d.shape
        assert pw == ev.num_variables

        rows = np.empty(n, np.int64)
        offsets = np.empty(n, np.int64)
        tool = self.tooling[name]
        i = 0
        if key in tool:
            row, count = tool.pop(key)
            take = min(cap - count, n)
            rows[:take] = row
            offsets[:take] = count + np.arange(take)
            i = take
            count += take
            if count < cap:
                tool[key] = (row, count)
        if i < n:
            rem = n - i
            num_new = -(-rem // cap)
            new_rows = self._claim_rows(num_new, ev_idx)
            if not constants_per_instance:
                for r in new_rows:
                    self.constants_requested_per_row[r] = list(constants)
            idx = np.arange(rem)
            rows[i:] = new_rows[idx // cap]
            offsets[i:] = idx % cap
            last_count = rem - (num_new - 1) * cap
            if last_count < cap:
                tool[key] = (int(new_rows[-1]), last_count)
        if constants_per_instance:
            # each instance contributes num_constants constants at its offset
            for j in range(n):
                row_consts = self.constants_requested_per_row[rows[j]]
                want_len = (offsets[j] + 1) * len(constants[j])
                while len(row_consts) < want_len:
                    row_consts.append(0)
                for t, c in enumerate(constants[j]):
                    row_consts[offsets[j] * len(constants[j]) + t] = c
        # scatter variables
        col_base = offsets * pw
        for j in range(pw):
            self.copy_permutation_data[col_base + j, rows] = vars_2d[:, j]
        if wits_2d is not None:
            wits_2d = np.asarray(wits_2d, np.uint64)
            nwit = wits_2d.shape[1]
            wit_base = offsets * nwit
            for j in range(nwit):
                self.witness_placement_data[wit_base + j, rows] = wits_2d[:, j]
        return rows, offsets

    def place_nop_rows(self, count: int):
        ev_idx = self.general_idx_by_name["nop"]
        self._claim_rows(count, ev_idx)

    def set_public(self, column: int, row: int):
        assert (column, row) not in self.public_inputs
        self.public_inputs.append((column, row))

    # -- lookups -------------------------------------------------------------

    def add_lookup_table(self, table: LookupTable) -> int:
        assert self.lookup_parameters.lookup_is_allowed
        assert table.width == self.lookup_parameters.lookup_width()
        table_id = len(self.lookup_tables) + INITIAL_LOOKUP_TABLE_ID_VALUE
        self.lookup_tables.append(table)
        self.lookup_multiplicities.append(np.zeros(len(table), np.int64))
        self.lookup_tooling.append(None)
        if not self.lookup_parameters.id_in_constant:
            # id-as-variable: a formal constant-valued variable holds the id
            # (reference cs.rs:978 — allocate_constant per table)
            assert self.gate_is_allowed("constants_allocator"), \
                "id-as-variable lookups need the constants_allocator gate"
            from .gates.simple import ConstantsAllocatorGate
            self.table_ids_as_variables.append(
                ConstantsAllocatorGate.allocate_constant(self, table_id))
        return table_id

    def get_table(self, table_id: int) -> LookupTable:
        return self.lookup_tables[table_id - INITIAL_LOOKUP_TABLE_ID_VALUE]

    def lookups_tables_total_len(self) -> int:
        return sum(len(t) for t in self.lookup_tables)

    def enforce_lookup_batch(self, table_id: int, keys_and_values: np.ndarray):
        """keys_and_values: (width, n) variable handles; counts multiplicities
        and places n lookup instances in the specialized columns (or on
        general-purpose rows under the LookupFormalGate for the
        TableIdAsConstant/TableIdAsVariable modes).

        Mirrors enforce_lookup_over_specialized_columns
        (src/cs/implementations/lookup_placement.rs:112) batched.
        """
        lp = self.lookup_parameters
        if not lp.is_specialized:
            return self._enforce_lookup_general_batch(table_id, keys_and_values)
        tbl_idx = table_id - INITIAL_LOOKUP_TABLE_ID_VALUE
        kv = np.asarray(keys_and_values, np.uint64)
        width, n = kv.shape
        assert width == lp.width

        if self.config.evaluate_witness:
            table = self.lookup_tables[tbl_idx]
            mults = self.lookup_multiplicities[tbl_idx]
            num_keys = table.num_keys

            def count_fn(vals):
                rows = table.lookup_rows(vals[:num_keys])
                np.add.at(mults, rows, 1)
                return np.zeros((0,), np.uint64)

            count_fn.device_lookup = (tbl_idx, num_keys)
            self.resolver.add_resolution(kv, np.zeros((0,), np.uint64), count_fn)

        if not self.config.keep_setup:
            return
        cap = lp.num_repetitions
        # tooling slot: per-table for id-in-constant (each row holds one
        # table's lookups), one SHARED slot for id-as-variable (rows may mix
        # tables; the id rides with each repetition) — reference
        # lookup_placement.rs:157 tooling_subid
        tool_idx = tbl_idx if lp.id_in_constant else 0
        rows = np.empty(n, np.int64)
        offsets = np.empty(n, np.int64)
        i = 0
        state = self.lookup_tooling[tool_idx]
        if state is not None:
            row, count = state
            take = min(cap - count, n)
            rows[:take] = row
            offsets[:take] = count + np.arange(take)
            i = take
            count += take
            self.lookup_tooling[tool_idx] = (row, count) if count < cap else None
        if i < n:
            rem = n - i
            num_new = -(-rem // cap)
            new_rows = self.lookup_next_row + np.arange(num_new)
            self.lookup_next_row += num_new
            assert self.lookup_next_row <= self.max_trace_len
            idx = np.arange(rem)
            rows[i:] = new_rows[idx // cap]
            offsets[i:] = idx % cap
            last_count = rem - (num_new - 1) * cap
            self.lookup_tooling[tool_idx] = \
                (int(new_rows[-1]), last_count) if last_count < cap else None
            # shared table-id constant column: id per row
            if lp.id_in_constant and lp.share_table_id:
                self.specialized_constants[0, new_rows] = table_id
        pwidth = lp.specialized_columns_per_repetition()
        col_base = offsets * pwidth
        for j in range(width):
            self.specialized_copy_data[col_base + j, rows] = kv[j]
        if lp.id_in_constant:
            if not lp.share_table_id:
                # one constant column PER repetition: write this instance's
                # repetition slot (reference place_constants_specialized)
                self.specialized_constants[offsets, rows] = table_id
        else:
            # id-as-variable: the formal id variable is the last column of
            # each repetition (reference lookup_placement.rs:195)
            self.specialized_copy_data[col_base + width, rows] = \
                self.table_ids_as_variables[tbl_idx]

    def _count_lookup_multiplicities(self, table_id: int, kv: np.ndarray):
        tbl_idx = table_id - INITIAL_LOOKUP_TABLE_ID_VALUE
        table = self.lookup_tables[tbl_idx]
        mults = self.lookup_multiplicities[tbl_idx]
        num_keys = table.num_keys

        def count_fn(vals):
            rows = table.lookup_rows(vals[:num_keys])
            np.add.at(mults, rows, 1)
            return np.zeros((0,), np.uint64)

        count_fn.device_lookup = (tbl_idx, num_keys)
        self.resolver.add_resolution(kv, np.zeros((0,), np.uint64), count_fn)

    def _enforce_lookup_general_batch(self, table_id: int,
                                      keys_and_values: np.ndarray):
        """Place lookups on general-purpose rows under the LookupFormalGate
        (reference enforce_lookup_over_general_purpose_columns,
        src/cs/implementations/lookup_placement.rs:21): chunks of
        columns_per_subargument copy columns per instance; the row's gate is
        the marker; id-as-constant writes the table id as the row constant,
        id-as-variable appends the table's formal id variable to the chunk."""
        lp = self.lookup_parameters
        kv = np.asarray(keys_and_values, np.uint64)
        width, n = kv.shape
        assert width == lp.width

        if self.config.evaluate_witness:
            self._count_lookup_multiplicities(table_id, kv)
        if not self.config.keep_setup:
            return
        if lp.id_in_constant:
            vars_2d = kv.T
            key = ("table", table_id)
            constants = [table_id]
        else:
            idv = self.table_ids_as_variables[
                table_id - INITIAL_LOOKUP_TABLE_ID_VALUE]
            vars_2d = np.concatenate(
                [kv.T, np.full((n, 1), idv, np.uint64)], axis=1)
            key = ("table", 0)  # one shared tooling slot (lookup_placement.rs:73)
            constants = []
        self.place_general_gate_batch("lookup_formal", key, constants, vars_2d)

    def enforce_lookup(self, table_id: int, keys_and_values):
        kv = np.asarray(keys_and_values, np.uint64).reshape(-1, 1)
        self.enforce_lookup_batch(table_id, kv)

    # -- finalization --------------------------------------------------------

    def pad_and_shrink(self):
        """Pad to power-of-two trace length (reference setup.rs:99): run row
        cleanups, reserve one unusable row, cover lookup tables, fill the
        rest with NOPs. Returns the final trace length (the hint analogue)."""
        for cleanup in self.row_cleanups:
            cleanup(self)
        required = self.next_available_row + 1
        required = max(required, self.lookups_tables_total_len(),
                       self.lookup_next_row + 1,
                       max(self.gate_spec_next_row.values(), default=0) + 1)
        final_len = 1 << (required - 1).bit_length()
        assert final_len <= self.max_trace_len
        for cleanup in self.columns_cleanups:
            cleanup(self, final_len)
        nops = final_len - self.next_available_row
        if "nop" in self.general_idx_by_name and nops > 0:
            self.place_nop_rows(nops)
        self.final_trace_len = final_len
        if self.config.paranoia and self.resolver is not None \
                and self.copy_permutation_data is not None:
            # every variable placed in the trace must have been resolved
            for block in (self.copy_permutation_data,
                          self.witness_placement_data,
                          self.specialized_copy_data, self.gate_spec_data):
                if block is None:
                    continue
                placed = block[~places.is_placeholder(block)]
                idx = places.index_of(placed)
                ok = self.resolver.resolved[
                    np.minimum(idx, self.resolver.resolved.shape[0] - 1)] \
                    & (idx < self.resolver.resolved.shape[0])
                assert ok.all(), \
                    f"paranoia: {int((~ok).sum())} placed-but-unresolved " \
                    f"variables, e.g. {placed[~ok][:8]}"
        return final_len

    def replay_witness(self, overrides: dict):
        """Repeated proving: replay the recorded witness program with new
        input values (place -> value) and recount lookup multiplicities.
        The trace layout, setup and VK are unchanged — only values move."""
        assert self.resolver is not None
        new = self.resolver.playback(self.resolver.record, overrides)
        new.record = self.resolver.record
        self.resolver = new
        # the device witness program (prover/device_witness.py) replays the
        # same record on-chip from the recorded inputs + these overrides
        self.witness_overrides = dict(overrides)
        self.recount_multiplicities()

    def _general_lookup_live_chunks(self):
        """Yield (table_id, values_block (cps, k)) for every live lookup
        chunk on general-purpose marker rows (placement + current values)."""
        lp = self.lookup_parameters
        marker_idx = self.general_idx_by_name["lookup_formal"]
        cps = lp.columns_per_subargument()
        app = np.asarray(self.gates_application_sets, np.int64)
        rows = np.nonzero(app == marker_idx)[0]
        if rows.size == 0:
            return
        cap = self.geometry.num_columns_under_copy_permutation // cps
        vals = self.resolver.values
        for chunk in range(cap):
            handles = self.copy_permutation_data[
                chunk * cps:(chunk + 1) * cps][:, rows]
            live = (handles[0] & np.uint64(places.PLACEHOLDER_BIT)) == 0
            if not live.any():
                continue
            block = vals[places.index_of(handles[:, live])]
            if lp.id_in_constant:
                ids = np.asarray(
                    [self.constants_requested_per_row[r][0]
                     for r in rows[live]], np.uint64)
            else:
                ids = block[cps - 1]
            yield ids, block

    def recount_multiplicities(self):
        """Recount lookup multiplicities from the CURRENT witness values of
        every placed lookup instance (needed after replay_witness)."""
        lp = self.lookup_parameters
        if not lp.lookup_is_allowed:
            return
        if not lp.is_specialized:
            for m in self.lookup_multiplicities:
                m[:] = 0
            for ids, block in self._general_lookup_live_chunks():
                for tid in np.unique(ids):
                    table = self.get_table(int(tid))
                    sel = ids == tid
                    rows_ = table.lookup_rows(block[:table.num_keys][:, sel])
                    np.add.at(self.lookup_multiplicities[
                        int(tid) - INITIAL_LOOKUP_TABLE_ID_VALUE], rows_, 1)
            return
        for m in self.lookup_multiplicities:
            m[:] = 0
        pw = lp.specialized_columns_per_repetition()
        nrows = self.lookup_next_row
        if nrows == 0:
            return
        vals = self.resolver.values
        for rep in range(lp.num_repetitions):
            handles = self.specialized_copy_data[rep * pw:(rep + 1) * pw,
                                                 :nrows]
            live = (handles[0] & np.uint64(places.PLACEHOLDER_BIT)) == 0
            if not live.any():
                continue
            block = vals[places.index_of(handles[:, live])]
            if not lp.id_in_constant:
                row_ids = block[lp.width]  # id-variable column value
            elif lp.share_table_id:
                row_ids = self.specialized_constants[0, :nrows][live]
            else:
                row_ids = self.specialized_constants[rep, :nrows][live]
            for tid in np.unique(row_ids):
                table = self.get_table(int(tid))
                sel = row_ids == tid
                keys = block[:table.num_keys][:, sel]
                rows = table.lookup_rows(keys)
                np.add.at(self.lookup_multiplicities[
                    int(tid) - INITIAL_LOOKUP_TABLE_ID_VALUE], rows, 1)

    def lookup_multiplicity_groups(self):
        """The STATIC structure of recount_multiplicities: yield
        (tbl_idx, key_places (num_keys, cnt) u64 place handles) for every
        placed lookup instance grouped by table. Table ids come from
        constant columns or from the (synthesis-fixed) table-id variables'
        current values — they are not replay-overridable, so the grouping
        is valid across replay_witness. Used by the device witness program
        to count multiplicities on-chip from materialized key values."""
        lp = self.lookup_parameters
        if not lp.lookup_is_allowed:
            return
        if not lp.is_specialized:
            marker_idx = self.general_idx_by_name["lookup_formal"]
            cps = lp.columns_per_subargument()
            app = np.asarray(self.gates_application_sets, np.int64)
            rows_all = np.nonzero(app == marker_idx)[0]
            if rows_all.size == 0:
                return
            cap = self.geometry.num_columns_under_copy_permutation // cps
            vals = self.resolver.values
            for chunk in range(cap):
                handles = self.copy_permutation_data[
                    chunk * cps:(chunk + 1) * cps][:, rows_all]
                live = (handles[0] & np.uint64(places.PLACEHOLDER_BIT)) == 0
                if not live.any():
                    continue
                handles = handles[:, live]
                if lp.id_in_constant:
                    ids = np.asarray(
                        [self.constants_requested_per_row[r][0]
                         for r in rows_all[live]], np.uint64)
                else:
                    ids = vals[places.index_of(handles[cps - 1])]
                for tid in np.unique(ids):
                    table = self.get_table(int(tid))
                    sel = ids == tid
                    yield (int(tid) - INITIAL_LOOKUP_TABLE_ID_VALUE,
                           handles[:table.num_keys][:, sel])
            return
        pw = lp.specialized_columns_per_repetition()
        nrows = self.lookup_next_row
        if nrows == 0:
            return
        vals = self.resolver.values
        for rep in range(lp.num_repetitions):
            handles = self.specialized_copy_data[rep * pw:(rep + 1) * pw,
                                                 :nrows]
            live = (handles[0] & np.uint64(places.PLACEHOLDER_BIT)) == 0
            if not live.any():
                continue
            handles = handles[:, live]
            if not lp.id_in_constant:
                ids = vals[places.index_of(handles[lp.width])]
            elif lp.share_table_id:
                ids = self.specialized_constants[0, :nrows][live]
            else:
                ids = self.specialized_constants[rep, :nrows][live]
            for tid in np.unique(ids):
                table = self.get_table(int(tid))
                sel = ids == tid
                yield (int(tid) - INITIAL_LOOKUP_TABLE_ID_VALUE,
                       handles[:table.num_keys][:, sel])

    # -- satisfiability oracle (reference satisfiability_test.rs:15) ---------

    def materialize_value_columns(self, n: int):
        """Gather resolved values into (num_copy_cols, n) uint64; placeholder
        cells read as zero. Also specialized columns and witness columns."""
        vals = self.resolver.values

        def gather(data):
            idx = places.index_of(data[:, :n])
            ph = (data[:, :n] & np.uint64(places.PLACEHOLDER_BIT)) != 0
            out = vals[np.minimum(idx, vals.shape[0] - 1)]
            out[ph] = 0
            return out

        copy_cols = gather(self.copy_permutation_data)
        wit_cols = gather(self.witness_placement_data) \
            if self.witness_placement_data is not None and \
            self.witness_placement_data.shape[0] else np.zeros((0, n), np.uint64)
        spec_cols = gather(self.specialized_copy_data) \
            if self.specialized_copy_data is not None else np.zeros((0, n), np.uint64)
        if self.gate_spec_data is not None:
            spec_cols = np.concatenate(
                [spec_cols, gather(self.gate_spec_data)], axis=0)
        return copy_cols, wit_cols, spec_cols

    def check_if_satisfied(self, verbose: bool = True) -> bool:
        from .gates.base import NpOps, TraceView
        n = getattr(self, "final_trace_len", None) or self.next_available_row
        copy_cols, wit_cols, spec_cols = self.materialize_value_columns(n)
        app = np.asarray(self.gates_application_sets, np.int64)
        app = app[:n] if app.shape[0] >= n else np.concatenate(
            [app, np.full(n - app.shape[0], -1, np.int64)])

        # per-row constants at gate-relative offset 0
        max_c = max((len(c) for c in self.constants_requested_per_row), default=0)
        max_c = max(max_c, self.geometry.num_constant_columns)
        const_cols = np.zeros((max_c, n), np.uint64)
        for r, consts in enumerate(self.constants_requested_per_row[:n]):
            for j, c in enumerate(consts):
                const_cols[j, r] = c

        ok = True
        for idx, ev in enumerate(self.evaluators_general):
            if ev.num_quotient_terms == 0:
                continue
            mask = app == idx
            if not mask.any():
                continue
            src = TraceView([copy_cols[i] for i in range(copy_cols.shape[0])],
                            [wit_cols[i] for i in range(wit_cols.shape[0])],
                            [const_cols[i] for i in range(const_cols.shape[0])])
            terms = ev.evaluate_repetitions(src, NpOps, self.geometry)
            for t_i, term in enumerate(terms):
                bad = mask & (np.broadcast_to(term, (n,)) != 0)
                if bad.any():
                    ok = False
                    if verbose:
                        rows = np.nonzero(bad)[0][:5]
                        print(f"gate {ev.name} term {t_i} violated at rows {rows}")
        # specialized gates: the relation holds on EVERY row of the gate's
        # dedicated column block (vacant rows are all-zero)
        if self.gate_spec_data is not None:
            lookup_cols = self.specialized_copy_data.shape[0] \
                if self.specialized_copy_data is not None else 0
            for (name, start, reps) in self.gate_spec_layout:
                ev = self.evaluators_specialized[
                    self.specialized_idx_by_name[name]]
                pw = ev.num_variables
                base = lookup_cols + start
                for rep in range(reps):
                    off = base + rep * pw
                    src = TraceView(
                        [spec_cols[off + i] for i in range(pw)], [], [])
                    for t_i, term in enumerate(ev.evaluate(src, NpOps)):
                        bad = np.broadcast_to(term, (n,)) != 0
                        if bad.any():
                            ok = False
                            if verbose:
                                rows = np.nonzero(bad)[0][:5]
                                print(f"specialized gate {name} rep {rep} "
                                      f"term {t_i} violated at rows {rows}")
        # lookup membership (general-purpose rows)
        lp = self.lookup_parameters
        if lp.lookup_is_allowed and not lp.is_specialized:
            for ids, block in self._general_lookup_live_chunks():
                for tid in np.unique(ids):
                    table = self.get_table(int(tid))
                    sel = ids == tid
                    sub = block[:, sel]
                    try:
                        rows_ = table.lookup_rows(sub[:table.num_keys])
                    except KeyError:
                        ok = False
                        if verbose:
                            print(f"general lookup key miss (table {tid})")
                        continue
                    want = table.content[rows_].T
                    if not np.array_equal(sub[:table.width], want):
                        ok = False
                        if verbose:
                            print(f"general lookup value mismatch (table {tid})")
                    if not lp.id_in_constant and \
                            not np.all(sub[table.width] == tid):
                        ok = False
                        if verbose:
                            print("general lookup id variable mismatch")
        if lp.is_specialized and self.specialized_copy_data is not None:
            pw = lp.specialized_columns_per_repetition()
            n_lookup_rows = self.lookup_next_row
            for rep in range(lp.num_repetitions):
                block = spec_cols[rep * pw:(rep + 1) * pw, :n_lookup_rows]
                handles = self.specialized_copy_data[
                    rep * pw, :n_lookup_rows]
                live = (handles & np.uint64(places.PLACEHOLDER_BIT)) == 0
                if not lp.id_in_constant:
                    ids = block[lp.width]  # id-variable column value
                elif lp.share_table_id:
                    ids = self.specialized_constants[0, :n_lookup_rows]
                else:
                    ids = self.specialized_constants[rep, :n_lookup_rows]
                # the live rows of each table at once (the reference loops
                # over the rows one by one; the verdict is the same)
                rows = np.nonzero(live)[0]
                for tid in np.unique(ids[rows]):
                    table = self.get_table(int(tid))
                    at = rows[ids[rows] == tid]
                    try:
                        row_idx = table.lookup_rows(
                            block[:table.num_keys, at])
                    except KeyError as err:
                        ok = False
                        if verbose:
                            print(f"lookup miss at rep {rep}: {err}")
                        continue
                    bad = np.any(table.content[row_idx].T
                                 != block[:table.width, at], axis=0)
                    if bad.any():
                        ok = False
                        if verbose:
                            print(f"lookup value mismatch rep {rep} rows "
                                  f"{at[bad][:5]}")
        return ok


def print_gate_stats(cs: "ConstraintSystem"):
    """Per-gate row occupancy (reference setup.rs:1300 print_gate_stats)."""
    from collections import Counter
    counts = Counter(cs.gates_application_sets)
    total = max(len(cs.gates_application_sets), 1)
    print(f"total general-purpose rows: {total}")
    for idx, ev in enumerate(cs.evaluators_general):
        c = counts.get(idx, 0)
        if c:
            print(f"  {ev.name:32s} {c:8d} rows ({100.0 * c / total:5.1f}%)")
    if cs.lookup_parameters.lookup_is_allowed:
        print(f"specialized lookup rows: {cs.lookup_next_row}")
        for t_i, table in enumerate(cs.lookup_tables):
            mult = int(cs.lookup_multiplicities[t_i].sum()) \
                if cs.config.evaluate_witness else 0
            print(f"  table {table.name:24s} len {len(table):6d} "
                  f"lookups {mult}")
