# Copied from boojum_tpu/cs/gates/base.py, with TorchOps in place of GLOps.
"""Gate evaluator framework.

Reference behavior: src/cs/traits/evaluator.rs (GateConstraintEvaluator:
instance width, degree/terms, per-chunk offsets, evaluate_once) and
src/cs/traits/gate.rs. The reference's single most important design idea —
one evaluator body that runs scalar, SIMD, symbolic and in-circuit
(SURVEY §1 cross-layer conventions) — maps here to ONE Python ``evaluate``
written against an ``ops`` protocol + a trace-source view, which then runs:

- over numpy uint64 row vectors (satisfiability oracle, host),
- over torch int64 field tensors on the LDE domain (prover quotient),
- over host extension-field scalars at the point z (verifier),
- over circuit variables (recursive verifier, later rounds).

This replaces both the reference's four per-ISA evaluator instantiations and
the whole GPU-synthesizer layer (SURVEY §2.9).
"""

from __future__ import annotations

from ...field import extension as ext2
from ...field import goldilocks as gl
from ...utils import npgl


class NpOps:
    """Host numpy uint64 field ops (vectorized rows)."""
    name = "np"

    @staticmethod
    def add(a, b):
        return npgl.add(a, b)

    @staticmethod
    def sub(a, b):
        return npgl.sub(a, b)

    @staticmethod
    def mul(a, b):
        return npgl.mul(a, b)

    @staticmethod
    def from_int(c):
        import numpy as np
        return np.uint64(c % npgl.ORDER)

    @staticmethod
    def zero():
        import numpy as np
        return np.uint64(0)

    @staticmethod
    def one():
        import numpy as np
        return np.uint64(1)


class TorchOps:
    """Torch int64 field-tensor ops on one device (prover LDE sweeps).
    An instance carries the device its constants go to."""
    name = "torch"

    def __init__(self, device):
        self.device = device

    add = staticmethod(gl.add)
    sub = staticmethod(gl.sub)
    mul = staticmethod(gl.mul)

    def from_int(self, c):
        return gl.full((), c, self.device)

    def zero(self):
        return gl.full((), 0, self.device)

    def one(self):
        return gl.full((), 1, self.device)


class Ext2Ops:
    """Host extension-field scalar ops ((c0, c1) int tuples) — verifier at z."""
    name = "ext2"

    add = staticmethod(ext2.s2_add)
    sub = staticmethod(ext2.s2_sub)
    mul = staticmethod(ext2.s2_mul)

    @staticmethod
    def from_int(c):
        return (c % gl.ORDER, 0)

    @staticmethod
    def zero():
        return (0, 0)

    @staticmethod
    def one():
        return (1, 0)


class TraceView:
    """Trace source for one gate repetition: resolves relative indices into
    column value vectors/scalars (any ops domain)."""

    def __init__(self, var_cols, wit_cols, const_cols,
                 var_offset=0, wit_offset=0, const_offset=0):
        self.var_cols = var_cols
        self.wit_cols = wit_cols
        self.const_cols = const_cols
        self.var_offset = var_offset
        self.wit_offset = wit_offset
        self.const_offset = const_offset

    def var(self, i):
        return self.var_cols[self.var_offset + i]

    def wit(self, i):
        return self.wit_cols[self.wit_offset + i]

    def const(self, i):
        return self.const_cols[self.const_offset + i]

    def shifted(self, dvar, dwit, dconst):
        return TraceView(self.var_cols, self.wit_cols, self.const_cols,
                         self.var_offset + dvar, self.wit_offset + dwit,
                         self.const_offset + dconst)


class GateEvaluator:
    """Base: subclasses define the per-instance relation.

    Attributes mirror reference GateConstraintEvaluator metadata
    (src/cs/traits/evaluator.rs:105-):
      name                  unique identifier (type_name analogue)
      num_variables / num_witnesses / num_constants   principal instance width
      max_constraint_degree / num_quotient_terms
      per_chunk_offset      (vars, wits, consts) step between repetitions
      needs_selector        False only for pure markers
      total_quotient_terms_in_geometry  num_quotient_terms * repetitions
    """

    name = "abstract"
    num_variables = 0
    num_witnesses = 0
    num_constants = 0
    max_constraint_degree = 0
    num_quotient_terms = 0
    needs_selector = True

    @property
    def per_chunk_offset(self):
        return (self.num_variables, self.num_witnesses, 0)

    # optional cap on instances per row (reference bounded_*_allocator.rs:
    # BoundedBooleanConstraintGate / BoundedConstantAllocatorGate)
    max_repetitions_bound = None

    def num_repetitions(self, geometry) -> int:
        width = self.num_variables
        if width == 0:
            return 1
        reps = geometry.num_columns_under_copy_permutation // width
        if self.max_repetitions_bound is not None:
            reps = min(reps, self.max_repetitions_bound)
        return reps

    def num_required_constants(self, geometry) -> int:
        return self.num_constants

    def evaluate(self, src: TraceView, ops) -> list:
        """Return the list of quotient terms (len == num_quotient_terms)."""
        raise NotImplementedError

    def evaluate_repetitions(self, src: TraceView, ops, geometry) -> list:
        """All repetitions on a row; returns flat list of terms."""
        dv, dw, dc = self.per_chunk_offset
        out = []
        view = src
        for _ in range(self.num_repetitions(geometry)):
            out.extend(self.evaluate(view, ops))
            view = view.shifted(dv, dw, dc)
        return out

    # identity for registries / setup serialization
    def key(self):
        return self.name

    def spec_params(self):
        """Parameters sufficient to rebuild this evaluator from the VK
        (paired with `name` in evaluator_specs)."""
        return getattr(self, "n", None)
