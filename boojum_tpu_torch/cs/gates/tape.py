# Port of what jax.jit traces of boojum_tpu/prover/device_prover.py:1621 `_gate_sweep_body` and the selector products of :244.
"""The gate tape: every gate term of a circuit's quotient as one recorded
program that the `quotient_sweep` kernel (``csrc/quotient.cu``) interprets.

Every evaluator of `cs/gates/` is written against the ops protocol
(`add`, `sub`, `mul`, `from_int`, `zero`, `one`), so one evaluation under
`TapeOps` records it, as tracing records the reference's gate sweeps into
its one quotient program. A `TraceView` whose columns are leaves resolves
each ``var`` / ``wit`` / ``const`` to an absolute column of the witness or
the setup oracle: a specialized gate's variables from its base column on,
a general gate's constants after its selector path's columns (the port's
`const_flat[len(path):]`). Constant-only subtrees fold, x·1, x + 0 and
x - 0 fold away, equal nodes of a gate are one node, and the constant
pool holds each value once.

The program is a list of four-int32 instructions ``[op, dst, a, b]``:

- ``ADD`` / ``SUB`` / ``MUL``: slot ``dst`` = a op b over the base field;
- ``TERM``: the gate's GL2 sum += α^``dst``·a (``dst`` the term's alpha
  index; every term has its TERM, a zero one too, in the alphas' order, so
  the kernel weighs them by a running power of α);
- ``FLUSH``: the quotient's sum += the gate's sum (times the selector a
  when ``dst`` is 1: a general gate's selector-path product, built on the
  tape from the constant columns as c or 1 - c), and the gate's sum = 0.

An operand is ``index << 2 | kind``: a slot, a witness column, a setup
column or an entry of the constant pool. Slots are given by liveness: a
value's slot is free again after its last reader, so a tape needs as many
slots as its largest live set. The alpha indices follow the port's order:
the lookup terms, then every specialized gate's terms (gate, repetition,
term), then every general gate's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...field.goldilocks import ORDER as P
from .base import TraceView

OP_ADD, OP_SUB, OP_MUL, OP_TERM, OP_FLUSH = range(5)
# operand kinds, in an operand's low two bits
SLOT, WIT, SETUP, CONST = range(4)
WORDS = 4  # int32 words an instruction


class TapeOps:
    """The ops protocol over recorded values: ``("c", value)`` a constant,
    ``("w", col)`` / ``("s", col)`` a witness / setup column, ``("r", id)``
    the node ``id`` of `nodes` (``(op, a, b)``, in creation order)."""

    name = "tape"

    def __init__(self):
        self.nodes = []
        self._ids = {}  # (op, a, b) -> its node, so equal nodes are one

    def _node(self, op, a, b):
        if a[0] == "c" and b[0] == "c":
            x, y = a[1], b[1]
            return ("c", (x + y if op == OP_ADD else x - y if op == OP_SUB
                          else x * y) % P)
        if op == OP_MUL:
            if a[0] == "c":
                a, b = b, a
            if b == ("c", 1):
                return a
            if b == ("c", 0):
                return b
        elif b == ("c", 0):
            return a
        elif op == OP_ADD and a == ("c", 0):
            return b
        if op != OP_SUB and b < a:  # one key for a op b and b op a
            a, b = b, a
        key = (op, a, b)
        ref = self._ids.get(key)
        if ref is None:
            ref = self._ids[key] = ("r", len(self.nodes))
            self.nodes.append(key)
        return ref

    def forget(self):
        """Later nodes are not merged with the nodes made so far."""
        self._ids.clear()

    def add(self, a, b):
        return self._node(OP_ADD, a, b)

    def sub(self, a, b):
        return self._node(OP_SUB, a, b)

    def mul(self, a, b):
        return self._node(OP_MUL, a, b)

    @staticmethod
    def from_int(c):
        return ("c", int(c) % P)

    @staticmethod
    def zero():
        return ("c", 0)

    @staticmethod
    def one():
        return ("c", 1)


@dataclass(frozen=True)
class GateSweep:
    """One gate's repetitions in the quotient: ``reps`` evaluations of
    ``evaluator``, the first reading variable ``var_base`` (an absolute
    witness column), witness column ``wit_base`` and setup column
    ``const_base``, each next one shifted by the evaluator's
    ``per_chunk_offset`` (a specialized gate: ``num_variables`` columns, no
    witness or constant columns). ``path`` is a general gate's selector
    path over setup columns ``sel_base`` .. (None: a specialized gate, on
    every row); its terms take alphas ``alpha`` .. in (repetition, term)
    order."""

    evaluator: object
    reps: int
    var_base: int
    wit_base: int
    const_base: int
    path: tuple
    sel_base: int
    alpha: int

    @property
    def num_terms(self) -> int:
        return self.evaluator.num_quotient_terms * self.reps

    def views(self, var_cols, wit_cols, const_cols):
        """The TraceView of each repetition over the oracles' columns
        ``var_cols`` (every variable column), ``wit_cols`` and ``const_cols``
        (every witness / setup column, absolute), as the port's quotient
        reads them."""
        ev = self.evaluator
        if self.path is None:
            for rep in range(self.reps):
                start = self.var_base + rep * ev.num_variables
                yield TraceView(var_cols[start:start + ev.num_variables],
                                [], [])
            return
        view = TraceView(var_cols, wit_cols[self.wit_base:],
                         const_cols[self.const_base:])
        for _ in range(self.reps):
            yield view
            view = view.shifted(*ev.per_chunk_offset)


def gate_sweeps(cs, setup_base, first_alpha: int) -> list:
    """The circuit's gates as `GateSweep`s in the quotient's order: the
    specialized gates (`cs.gate_spec_layout`), then every general gate with
    quotient terms under its selector path (`setup_base.selector_paths`);
    their alphas from ``first_alpha`` (the lookup terms' count) on."""
    geometry = cs.geometry
    num_var = setup_base.copy_permutation_polys.shape[0]
    lookup_spec_cols = cs.specialized_copy_data.shape[0] \
        if cs.specialized_copy_data is not None else 0
    out, alpha = [], first_alpha
    for (name, start, reps) in cs.gate_spec_layout:
        ev = cs.evaluators_specialized[cs.specialized_idx_by_name[name]]
        base = geometry.num_columns_under_copy_permutation + \
            lookup_spec_cols + start
        out.append(GateSweep(ev, reps, base, 0, 0, None, 0, alpha))
        alpha += out[-1].num_terms
    for idx, ev in enumerate(cs.evaluators_general):
        if ev.num_quotient_terms == 0:
            continue
        path = tuple(setup_base.selector_paths[idx])
        out.append(GateSweep(ev, ev.num_repetitions(geometry), 0, num_var,
                             num_var + len(path), path, num_var, alpha))
        alpha += out[-1].num_terms
    return out


@dataclass(frozen=True)
class Tape:
    """A recorded quotient tape: ``code`` (m, WORDS) int32, the constant
    pool ``consts`` (k,) uint64, the ``slots`` it needs, its ``num_terms``
    and the witness / setup columns it reads."""

    code: np.ndarray
    consts: np.ndarray
    slots: int
    num_terms: int
    wit_cols: tuple
    setup_cols: tuple

    def muls(self) -> int:
        """Base-field multiplies a point: MUL 1, TERM 2, a selector FLUSH 2."""
        op, dst = self.code[:, 0], self.code[:, 1]
        return int((op == OP_MUL).sum() + 2 * (op == OP_TERM).sum()
                   + 2 * ((op == OP_FLUSH) & (dst == 1)).sum())


def record_tape(sweeps, num_witness_cols: int, num_setup_cols: int) -> Tape:
    """Records every gate of ``sweeps`` (`GateSweep`s) over leaf columns of
    a witness oracle of ``num_witness_cols`` and a setup oracle of
    ``num_setup_cols`` columns, then numbers the live nodes' slots and packs
    the program."""
    ops = TapeOps()
    wit = [("w", j) for j in range(num_witness_cols)]
    setup = [("s", j) for j in range(num_setup_cols)]
    events = []  # ("term", value, alpha) / ("flush", selector or None)
    num_terms = 0
    for g in sweeps:
        # equal nodes are one within a gate only: a node shared with a
        # later gate would hold its slot across every gate between
        ops.forget()
        alpha = g.alpha
        for view in g.views(wit, wit, setup):
            terms = g.evaluator.evaluate(view, ops)
            assert len(terms) == g.evaluator.num_quotient_terms
            for t in terms:  # every alpha, a zero term too, in order
                events.append(("term", t, alpha))
                alpha += 1
        num_terms += g.num_terms
        sel = None
        if g.path is not None:
            sel = ops.one()
            for k, bit in enumerate(g.path):
                c = setup[g.sel_base + k]
                sel = ops.mul(sel, c if bit else ops.sub(ops.one(), c))
        events.append(("flush", sel))
    return _pack(ops.nodes, events, num_terms)


def quotient_gates(cs, setup_base):
    """`gate_sweeps` of a circuit (from the lookup terms' count on) and its
    oracles' column counts: the witness oracle's (variables, witness
    columns, multiplicities) and the setup oracle's (sigmas, constants,
    tables), the arguments of `record_tape`."""
    geometry = cs.geometry
    lp = cs.lookup_parameters
    lookup_terms = lp.num_sublookup_arguments_for_geometry(geometry) + 1 \
        if lp.lookup_is_allowed else 0
    num_var = setup_base.copy_permutation_polys.shape[0]
    wit_cols = num_var + geometry.num_witness_columns + \
        int(lp.lookup_is_allowed)
    setup_cols = num_var + setup_base.constant_columns.shape[0] + \
        setup_base.lookup_tables_columns.shape[0]
    return gate_sweeps(cs, setup_base, lookup_terms), wit_cols, setup_cols


def _pack(nodes, events, num_terms) -> Tape:
    """The nodes each event needs, in creation order, before it; then
    liveness slots, the int32 program and the constant pool."""
    stream = []
    emitted = [False] * len(nodes)

    def emit(v):
        order = []
        stack = [v]
        while stack:
            v = stack.pop()
            if v is None or v[0] != "r" or emitted[v[1]]:
                continue
            order.append(v[1])
            emitted[v[1]] = True
            _, a, b = nodes[v[1]]
            stack += [a, b]
        for i in sorted(order):  # creation order: operands first
            stream.append(("node", i))

    for ev in events:
        emit(ev[1])
        stream.append(ev)
    last = {}
    for pos, item in enumerate(stream):
        ins = nodes[item[1]][1:] if item[0] == "node" else (item[1],)
        for v in ins:
            if v is not None and v[0] == "r":
                last[v[1]] = pos
    pool, pool_idx = [], {}

    def operand(v, slot_of):
        if v[0] == "r":
            return slot_of[v[1]] << 2 | SLOT
        if v[0] == "w":
            return v[1] << 2 | WIT
        if v[0] == "s":
            return v[1] << 2 | SETUP
        if v[1] not in pool_idx:
            pool_idx[v[1]] = len(pool)
            pool.append(v[1])
        return pool_idx[v[1]] << 2 | CONST

    slot_of, free, slots = {}, [], 0
    code = []
    wit_cols, setup_cols = set(), set()
    for pos, item in enumerate(stream):
        ins = nodes[item[1]][1:] if item[0] == "node" else (item[1],)
        for v in ins:
            if v is not None and v[0] in "ws":
                (wit_cols if v[0] == "w" else setup_cols).add(v[1])
        words = [operand(v, slot_of) if v is not None else 0 for v in ins]
        for v in set(ins):  # a value's slot is free after its last reader
            if v is not None and v[0] == "r" and last[v[1]] == pos:
                free.append(slot_of[v[1]])
        if item[0] == "node":
            op = nodes[item[1]][0]
            if free:
                free.sort(reverse=True)
                slot = free.pop()
            else:
                slot, slots = slots, slots + 1
            slot_of[item[1]] = slot
            code.append([op, slot] + words)
        elif item[0] == "term":
            code.append([OP_TERM, item[2], words[0], 0])
        else:
            code.append([OP_FLUSH, int(item[1] is not None), words[0], 0])
    code = np.asarray(code, np.int32).reshape(-1, WORDS)
    return Tape(code, np.asarray(pool, np.uint64), slots, num_terms,
                tuple(sorted(wit_cols)), tuple(sorted(setup_cols)))


def replay(tape: Tape, wit, setup, alphas=None):
    """The tape on one point in Python ints: ``wit(col)`` / ``setup(col)``
    give a column's value there. Returns the (alpha index, value) of every
    TERM and each FLUSH's (gate sum, selector or None); with ``alphas``
    (ext pairs by index) the gate sums are α-weighted GL2 pairs, else
    None."""
    slots = [None] * tape.slots

    def val(v):
        kind, idx = v & 3, v >> 2
        if kind == SLOT:
            return slots[idx]
        if kind == WIT:
            return wit(idx)
        return setup(idx) if kind == SETUP else int(tape.consts[idx])

    terms, flushes, gacc = [], [], (0, 0)
    for op, dst, a, b in tape.code.tolist():
        if op in (OP_ADD, OP_SUB, OP_MUL):
            x, y = val(a), val(b)
            slots[dst] = (x + y if op == OP_ADD else x - y if op == OP_SUB
                          else x * y) % P
        elif op == OP_TERM:
            t = val(a)
            terms.append((dst, t))
            if alphas is not None:
                al = alphas[dst]
                gacc = ((gacc[0] + al[0] * t) % P, (gacc[1] + al[1] * t) % P)
        else:
            sel = val(a) if dst else None
            flushes.append((gacc if alphas is not None else None, sel))
            gacc = (0, 0)
    return terms, flushes
