# Copied from boojum_tpu/cs/setup.py.
"""Setup generation: selector tree, constant polys, copy-permutation sigmas,
lookup table columns.

Reference behavior: src/cs/implementations/setup.rs —
compute_selectors_and_constants_placement (:504, the deterministic
unbalanced-tree search reproduced exactly for identical setups),
create_constant_setup_polys (:728), create_permutation_polys (:419),
create_lookup_tables_columns_polys (:910); non-residues from
src/cs/implementations/utils.rs:636.

All outputs are host numpy Lagrange-form columns; the prover LDEs/commits
them on device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field.goldilocks import ORDER
from ..utils import npgl
from . import places
from .cs import ConstraintSystem
from .geometry import INITIAL_LOOKUP_TABLE_ID_VALUE


# ---------------------------------------------------------------------------
# Selector placement tree (exact reproduction of setup.rs:1346-1580)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GateDescription:
    gate_idx: int
    num_constants: int
    degree: int
    needs_selector: bool
    is_lookup: bool

    def degree_at_depth(self, depth: int) -> int:
        if not self.is_lookup:
            return depth + self.degree
        return max(depth, 2)


class TreeNode:
    """Empty | GateOnly(desc) | Fork(left, right)."""

    def __init__(self, kind: str, desc=None, left=None, right=None):
        self.kind = kind
        self.desc = desc
        self.left = left
        self.right = right

    @staticmethod
    def empty():
        return TreeNode("empty")

    @staticmethod
    def gate(desc):
        return TreeNode("gate", desc=desc)

    @staticmethod
    def fork(left, right):
        return TreeNode("fork", left=left, right=right)

    def compute_stats_at_depth(self, depth: int):
        if self.kind == "empty":
            assert depth == 0
            return (0, 0)
        if self.kind == "gate":
            return (self.desc.degree_at_depth(depth), self.desc.num_constants + depth)
        ld, lc = self.left.compute_stats_at_depth(depth + 1)
        rd, rc = self.right.compute_stats_at_depth(depth + 1)
        return (max(ld, rd), max(lc, rc))

    def compute_stats(self):
        return self.compute_stats_at_depth(0)

    def output_placement(self, gate_idx: int):
        """Selector path: list of bools, True = left branch."""
        if self.kind == "empty":
            return None
        if self.kind == "gate":
            return [] if self.desc.gate_idx == gate_idx else None
        p = self.left.output_placement(gate_idx)
        if p is not None:
            return [True] + p
        p = self.right.output_placement(gate_idx)
        if p is not None:
            return [False] + p
        return None

    def try_add_gate(self, gate: GateDescription, max_degree: int,
                     max_constants: int, depth: int):
        if self.kind == "empty":
            if gate.degree_at_depth(depth) > max_degree or \
                    gate.num_constants > max_constants:
                return None
            return TreeNode.gate(gate)
        if self.kind == "gate":
            for pair in ((TreeNode.gate(self.desc), TreeNode.gate(gate)),
                         (TreeNode.gate(gate), TreeNode.gate(self.desc))):
                new = TreeNode.fork(*pair)
                d, c = new.compute_stats_at_depth(depth)
                if d <= max_degree and c <= max_constants:
                    return new
            return None
        nl = self.left.try_add_gate(gate, max_degree, max_constants, depth + 1)
        if nl is not None:
            return TreeNode.fork(nl, self.right)
        nr = self.right.try_add_gate(gate, max_degree, max_constants, depth + 1)
        if nr is not None:
            return TreeNode.fork(self.left, nr)
        return None


def _try_find_placement_for_degree(gates, degree_bound, starting_num_constants):
    n = max(len(gates), 1)
    ub = (n - 1).bit_length()  # trailing_zeros(next_power_of_two(n))
    for i in range(ub + 2):
        bound = starting_num_constants + i
        tree = TreeNode.empty()
        ok = True
        for g in gates:
            new = tree.try_add_gate(g, degree_bound, bound, 0)
            if new is None:
                ok = False
                break
            tree = new
        if ok:
            return tree
    return None


def compute_selectors_placement(cs: ConstraintSystem) -> TreeNode:
    """Reference compute_selectors_and_constants_placement (setup.rs:504)."""
    evs = cs.evaluators_general
    assert len(evs) > 0
    lp = cs.lookup_parameters
    if len(evs) == 1:
        assert not lp.lookup_is_allowed or lp.is_specialized
        ev = evs[0]
        return TreeNode.gate(GateDescription(
            0, ev.num_required_constants(cs.geometry),
            ev.max_constraint_degree, ev.needs_selector, False))

    all_gates = []
    for i, ev in enumerate(evs):
        is_lookup = False
        num_constants = ev.num_required_constants(cs.geometry)
        if lp.mode in ("table_id_as_constant", "table_id_as_variable") and i == 0:
            # general-purpose lookup marker must be first
            is_lookup = True
            if lp.mode == "table_id_as_constant":
                num_constants = 1
        desc = GateDescription(i, num_constants, ev.max_constraint_degree,
                               ev.needs_selector, is_lookup)
        if desc.degree > 0 or desc.needs_selector or desc.is_lookup:
            all_gates.append(desc)

    max_degree = max(g.degree_at_depth(0) for g in all_gates) - 1
    max_num_constants = max(g.num_constants for g in all_gates)
    # stable sort: degree desc, then num_constants desc
    all_gates.sort(key=lambda g: (-g.degree, -g.num_constants))

    if max_degree > 0 and (max_degree & (max_degree - 1)) == 0:
        target = max_degree
    else:
        target = 1 << max_degree.bit_length() if max_degree > 0 else 1

    assert cs.geometry.num_constant_columns >= max_num_constants
    for _ in range(4):
        tree = _try_find_placement_for_degree(all_gates, target, max_num_constants)
        if tree is not None:
            return tree
        target *= 2
    raise RuntimeError(f"no placement for target degree {target}")


# ---------------------------------------------------------------------------
# Non-residues (utils.rs:636)
# ---------------------------------------------------------------------------


def make_non_residues(num: int, domain_size: int) -> list[int]:
    non_residues = []
    current = 1
    half = (ORDER - 1) // 2
    while len(non_residues) < num:
        current += 1
        if pow(current, half, ORDER) != ORDER - 1:
            continue  # quadratic residue (or zero) — skip
        tmp = pow(current, domain_size, ORDER)
        if tmp == 1:
            continue
        if any(tmp == pow(t, domain_size, ORDER) for t in non_residues):
            continue
        non_residues.append(current)
    return non_residues


def non_residues_for_copy_permutation(domain_size: int, num_columns: int) -> list[int]:
    return [1] + make_non_residues(num_columns - 1, domain_size)


# ---------------------------------------------------------------------------
# Setup polys
# ---------------------------------------------------------------------------


@dataclass
class SetupBase:
    """Host Lagrange-form setup columns (reference SetupBaseStorage)."""

    copy_permutation_polys: np.ndarray  # (num_copy_total, n) sigmas
    constant_columns: np.ndarray  # (num_const_total, n)
    lookup_tables_columns: np.ndarray  # (width+1, n) or (0, n)
    table_ids_column_idxes: list[int]
    selectors_placement: TreeNode
    selector_paths: list[list[bool]]  # per general evaluator
    quotient_degree: int
    num_general_constant_columns: int
    domain_size: int
    public_inputs: list[tuple[int, int]]


def create_permutation_polys(cs: ConstraintSystem, n: int) -> np.ndarray:
    """Sigmas via vectorized cycle rotation (reference setup.rs:419: each
    occurrence of a variable receives the previous occurrence's base value,
    the first receives the last's; encounter order is column-major)."""
    num_copy = cs.geometry.num_columns_under_copy_permutation
    spec = cs.specialized_copy_data[:, :n] if cs.specialized_copy_data is not None \
        else np.zeros((0, n), np.uint64)
    gate_spec = cs.gate_spec_data[:, :n] if cs.gate_spec_data is not None \
        else np.zeros((0, n), np.uint64)
    handles = np.concatenate([cs.copy_permutation_data[:, :n], spec,
                              gate_spec], axis=0)
    capacity = handles.shape[0]

    omega = _domain_generator(n)
    x = npgl.powers(omega, n)
    non_res = np.asarray(non_residues_for_copy_permutation(n, capacity), np.uint64)
    init = npgl.mul(non_res[:, None], x[None, :])  # (capacity, n)
    sigma = init.copy()

    mask = (handles & np.uint64(places.PLACEHOLDER_BIT)) == 0
    cols_idx, rows_idx = np.nonzero(mask)  # C-order == column-major encounter
    if cols_idx.size == 0:
        return sigma
    var = places.index_of(handles[mask])
    perm = np.argsort(var, kind="stable")
    var_s = var[perm]
    starts = np.empty(var_s.shape, bool)
    starts[0] = True
    starts[1:] = var_s[1:] != var_s[:-1]
    gid = np.cumsum(starts) - 1
    end_positions = np.nonzero(np.append(starts[1:], True))[0]
    prev_sorted = np.arange(var_s.shape[0]) - 1
    prev_sorted[starts] = end_positions[gid[starts]]
    tgt = perm
    src = perm[prev_sorted]
    sigma[cols_idx[tgt], rows_idx[tgt]] = init[cols_idx[src], rows_idx[src]]
    return sigma


def _domain_generator(n: int) -> int:
    from ..field.goldilocks import domain_generator
    return domain_generator(n.bit_length() - 1)


def create_constant_setup_polys(cs: ConstraintSystem, n: int):
    """(constant columns (num_total, n), tree, quotient_degree_general).

    Layout per row: selector path bits of the row's gate, then the gate's
    requested constants; specialized-mode constant columns appended after the
    general block (reference setup.rs:728-910)."""
    tree = compute_selectors_placement(cs)
    max_deg, num_general_consts = tree.compute_stats()
    quotient_degree_general = max(max_deg - 1, 0)

    paths = []
    for idx, ev in enumerate(cs.evaluators_general):
        if not ev.needs_selector and ev.num_quotient_terms == 0:
            paths.append([])
            continue
        p = tree.output_placement(idx)
        assert p is not None, f"no placement for gate {ev.name}"
        paths.append(p)

    num_spec_consts = cs.specialized_constants.shape[0] \
        if cs.specialized_constants is not None else 0
    total = num_general_consts + num_spec_consts
    cols = np.zeros((total, n), np.uint64)
    app = np.asarray(cs.gates_application_sets, np.int64)[:n]
    nrows = app.shape[0]

    # selector-path bits: one gather per evaluator-indexed bit table
    max_path = max((len(p) for p in paths), default=0)
    path_bits = np.zeros((len(paths), max_path), np.uint64)
    path_lens = np.zeros(len(paths), np.int64)
    for i, p in enumerate(paths):
        path_lens[i] = len(p)
        for j, bit in enumerate(p):
            path_bits[i, j] = 1 if bit else 0
    if max_path:
        cols[:max_path, :nrows] = path_bits[app].T

    # per-row gate constants land right after the row's path bits; group rows
    # by (path length, constants length) and scatter each group vectorized
    consts_list = cs.constants_requested_per_row
    lens = np.fromiter((len(consts_list[r]) for r in range(nrows)),
                       np.int64, nrows)
    offs = path_lens[app]
    for L in np.unique(lens):
        if L == 0:
            continue
        rows_l = np.nonzero(lens == L)[0]
        block = np.asarray([consts_list[r] for r in rows_l],
                           np.uint64)  # (m, L)
        row_offs = offs[rows_l]
        for j in range(L):
            cols[row_offs + j, rows_l] = block[:, j]

    if num_spec_consts:
        cols[num_general_consts:, :] = cs.specialized_constants[:, :n]
    return cols, tree, paths, quotient_degree_general, num_general_consts


def create_lookup_tables_columns(cs: ConstraintSystem, n: int) -> np.ndarray:
    lp = cs.lookup_parameters
    if not lp.lookup_is_allowed:
        return np.zeros((0, n), np.uint64)
    width = lp.lookup_width()
    cols = np.zeros((width + 1, n), np.uint64)
    idx = 0
    for t_i, table in enumerate(cs.lookup_tables):
        table_id = t_i + INITIAL_LOOKUP_TABLE_ID_VALUE
        m = len(table)
        cols[:width, idx:idx + m] = table.content.T
        cols[width, idx:idx + m] = table_id
        idx += m
    return cols


def create_base_setup(cs: ConstraintSystem) -> SetupBase:
    n = cs.final_trace_len
    consts, tree, paths, q_general, num_general_consts = \
        create_constant_setup_polys(cs, n)
    sigmas = create_permutation_polys(cs, n)
    tables = create_lookup_tables_columns(cs, n)

    # quotient degree: general gates + specialized gates (lookup B relation
    # B·(Σγⁱtᵢ+β)-m is degree 2 → contributes 1; the general-purpose A
    # relation's selector-product degree is already in the tree stats)
    q_spec = 1 if cs.lookup_parameters.lookup_is_allowed else 0
    for ev in cs.evaluators_specialized:
        q_spec = max(q_spec, ev.max_constraint_degree - 1)
    q = max(q_general, q_spec, 1)
    quotient_degree = 1 << (q - 1).bit_length()

    # reference compute_table_ids_column_idxes (setup.rs:963)
    table_id_idx = []
    lp = cs.lookup_parameters
    if lp.lookup_is_allowed and lp.id_in_constant:
        if lp.is_specialized:
            # one constant column when shared, one PER repetition otherwise
            table_id_idx = [
                num_general_consts + r
                for r in range(lp.total_specialized_lookup_constant_columns())]
        else:
            # general-purpose: the marker gate (evaluator 0) places the id
            # constant at offset 0 of its constant segment
            table_id_idx = [len(paths[0])]

    return SetupBase(
        copy_permutation_polys=sigmas,
        constant_columns=consts,
        lookup_tables_columns=tables,
        table_ids_column_idxes=table_id_idx,
        selectors_placement=tree,
        selector_paths=paths,
        quotient_degree=quotient_degree,
        num_general_constant_columns=num_general_consts,
        domain_size=n,
        public_inputs=list(cs.public_inputs),
    )
