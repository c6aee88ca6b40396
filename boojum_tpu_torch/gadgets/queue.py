# Copied from boojum_tpu/gadgets/queue.py.
"""Hash-chained circuit queue (reference src/gadgets/queue/mod.rs:29).

A commitment queue: pushing absorbs elements into the tail state, popping
advances the head state with prover-supplied elements; when the queue is
emptied the head must equal the tail — which proves pops returned exactly
the pushed sequence. States are Poseidon2 sponge states (capacity-4 chain,
like the tree hasher's node hash).
"""

from __future__ import annotations

import numpy as np

from ..cs.cs import ConstraintSystem
from ..cs.gates import ConstantsAllocatorGate
from .num import CircuitOps
from .poseidon2_circuit import Poseidon2Circuit


class CircuitQueue:
    def __init__(self, cs: ConstraintSystem, ops: CircuitOps = None,
                 element_width: int = 4):
        assert element_width <= 8
        self.cs = cs
        self.ops = ops or CircuitOps(cs)
        self.p2 = Poseidon2Circuit(cs, self.ops)
        self.element_width = element_width
        zero = self.ops.from_int(0)
        self.head = [zero] * 4
        self.tail = [zero] * 4
        self.length = 0  # host-tracked; the chain states carry soundness
        self._witness_log: list[list[int]] = []  # popped values source

    def _absorb(self, state: list, values: list) -> list:
        zero = self.ops.from_int(0)
        block = list(values) + [zero] * (8 - len(values))
        st = block + state  # rate 8 + capacity 4
        return self.p2.permutation(st)[:4]

    def push(self, values: list):
        """values: element_width variable handles."""
        assert len(values) == self.element_width
        self.tail = self._absorb(self.tail, values)
        self._witness_log.append([self.cs.get_value(v) for v in values]
                                 if self.cs.resolver is not None else [])
        self.length += 1

    def pop(self) -> list:
        """Allocate the popped element as witness and advance the head."""
        assert self.length > 0
        vals = self._witness_log.pop(0) if self._witness_log else \
            [0] * self.element_width
        out = [self.cs.alloc_variable_with_value(v) for v in vals]
        self.head = self._absorb(self.head, out)
        self.length -= 1
        return out

    def enforce_consistency(self):
        """Call once the queue is fully drained: head chain == tail chain."""
        assert self.length == 0, "queue must be empty"
        for a, b in zip(self.head, self.tail):
            self.ops.enforce_equal(a, b)


class FullStateCircuitQueue:
    """Queue whose chain state is the FULL 12-wide sponge state (reference
    src/gadgets/queue/full_state_queue.rs:20-116): push overwrites the rate
    with the element and permutes; the capacity section threads the chain.
    Used where the state doubles as a running commitment (recursion queues).
    """

    STATE_WIDTH = 12
    RATE = 8

    def __init__(self, cs: ConstraintSystem, ops: CircuitOps = None,
                 element_width: int = 8):
        assert element_width <= self.RATE
        self.cs = cs
        self.ops = ops or CircuitOps(cs)
        self.p2 = Poseidon2Circuit(cs, self.ops)
        self.element_width = element_width
        zero = self.ops.from_int(0)
        self.head = [zero] * self.STATE_WIDTH
        self.tail = [zero] * self.STATE_WIDTH
        self.length = 0
        self._witness_log: list[list[int]] = []

    def _advance(self, state: list, values: list) -> list:
        zero = self.ops.from_int(0)
        block = list(values) + [zero] * (self.RATE - len(values))
        return self.p2.permutation(block + state[self.RATE:])

    def push(self, values: list):
        assert len(values) == self.element_width
        self.tail = self._advance(self.tail, values)
        self._witness_log.append([self.cs.get_value(v) for v in values]
                                 if self.cs.resolver is not None else [])
        self.length += 1

    def pop(self) -> list:
        assert self.length > 0
        vals = self._witness_log.pop(0) if self._witness_log else \
            [0] * self.element_width
        out = [self.cs.alloc_variable_with_value(v) for v in vals]
        self.head = self._advance(self.head, out)
        self.length -= 1
        return out

    def enforce_consistency(self):
        assert self.length == 0, "queue must be empty"
        for a, b in zip(self.head, self.tail):
            self.ops.enforce_equal(a, b)


class SpongeOptimizer:
    """Batches deferred round-function applications from independent call
    sites into one multi-instance gate placement per flush (reference
    src/gadgets/queue/queue_optimizer/ — the sponge optimizer).

    Constraint (same as the reference): requests inside one flush cycle must
    be independent — a queue can defer at most one chain step per cycle.
    With Poseidon2FlattenedGate allowed, a flush of k requests costs k rows;
    without it, requests fall back to per-instance matrix-gate permutations.
    """

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self._requests: list = []  # (state12, callback)

    def request_round_function(self, state12: list, on_result):
        assert len(state12) == 12
        self._requests.append((list(state12), on_result))

    def flush(self):
        if not self._requests:
            return
        cs = self.cs
        states = np.asarray([s for s, _ in self._requests], np.uint64)
        if "poseidon2_flattened" in cs.placement_strategy:
            from ..cs.gates import Poseidon2FlattenedGate
            outs = Poseidon2FlattenedGate.compute_round_function_batch(
                cs, states)
            outs = [[int(v) for v in row] for row in outs]
        else:
            p2 = Poseidon2Circuit(cs)
            outs = [p2.permutation([int(v) for v in row]) for row in states]
        requests, self._requests = self._requests, []
        for (_, cb), out in zip(requests, outs):
            cb(out)


class OptimizedCircuitQueue(FullStateCircuitQueue):
    """FullStateCircuitQueue whose chain steps route through a shared
    SpongeOptimizer; call optimizer.flush() after each batch of operations
    (at most one op per queue between flushes)."""

    def __init__(self, cs, optimizer: SpongeOptimizer, element_width: int = 8):
        super().__init__(cs, element_width=element_width)
        self.optimizer = optimizer
        self._pending = False

    def _advance_deferred(self, state: list, values: list, assign):
        assert not self._pending, "one deferred op per queue per flush cycle"
        zero = self.ops.from_int(0)
        block = list(values) + [zero] * (self.RATE - len(values))

        def cb(out):
            assign(out)
            self._pending = False

        self._pending = True
        self.optimizer.request_round_function(block + state[self.RATE:], cb)

    def push(self, values: list):
        assert len(values) == self.element_width
        self._witness_log.append([self.cs.get_value(v) for v in values]
                                 if self.cs.resolver is not None else [])
        self.length += 1

        def assign(out):
            self.tail = out

        self._advance_deferred(self.tail, values, assign)

    def pop(self) -> list:
        assert self.length > 0
        vals = self._witness_log.pop(0) if self._witness_log else \
            [0] * self.element_width
        out_vars = [self.cs.alloc_variable_with_value(v) for v in vals]

        def assign(out):
            self.head = out

        self._advance_deferred(self.head, out_vars, assign)
        self.length -= 1
        return out_vars
