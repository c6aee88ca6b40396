# Copied from boojum_tpu/cs/gates/testing.py.
"""Gate-evaluator testing tools.

Reference behavior: src/cs/gates/testing_tools.rs — ``test_evaluator`` runs
an evaluator against a counting TraceSource/EvaluationDestination and checks
that (a) it pushes exactly the number of quotient terms it claims and (b) it
only touches columns within its declared instance width — plus the
placeholder assertion helpers of src/cs/gates/mod.rs:360-390.
"""

from __future__ import annotations

import numpy as np

from .. import places
from .base import NpOps, TraceView


class _CountingCols:
    """Zero-valued column list that records the max index accessed (the
    TestSource analogue, testing_tools.rs:9-38)."""

    def __init__(self, claimed: int):
        self.claimed = claimed
        self.max_accessed = -1

    def __getitem__(self, i):
        self.max_accessed = max(self.max_accessed, i)
        return np.uint64(0)

    def __len__(self):
        return self.claimed


def test_evaluator(ev) -> None:
    """Assert the evaluator's claimed metadata against an actual run
    (reference test_evaluator, testing_tools.rs:56-91): it must push exactly
    ``num_quotient_terms`` terms and read only within its declared variable/
    witness/constant widths."""
    var_src = _CountingCols(ev.num_variables)
    wit_src = _CountingCols(ev.num_witnesses)
    const_src = _CountingCols(max(ev.num_constants, 64))
    src = TraceView(var_src, wit_src, const_src)
    terms = ev.evaluate(src, NpOps)
    assert len(terms) == ev.num_quotient_terms, (
        "gate %s claims %d terms, but pushed %d"
        % (ev.name, ev.num_quotient_terms, len(terms)))
    assert var_src.max_accessed < ev.num_variables, (
        "gate %s read variable %d beyond claimed width %d"
        % (ev.name, var_src.max_accessed, ev.num_variables))
    assert wit_src.max_accessed < max(ev.num_witnesses, 1), (
        "gate %s read witness %d beyond claimed width %d"
        % (ev.name, wit_src.max_accessed, ev.num_witnesses))


test_evaluator.__test__ = False  # a harness, not a pytest case


def assert_not_placeholder(place) -> None:
    """Reference assert_not_placeholder (gates/mod.rs:360)."""
    assert not places.is_placeholder(int(place)), "placeholder place"


def assert_no_placeholders(plcs) -> None:
    """Reference assert_no_placeholders (gates/mod.rs:369)."""
    arr = np.asarray(plcs, np.uint64)
    assert not places.is_placeholder(arr).any(), "placeholder place(s)"
