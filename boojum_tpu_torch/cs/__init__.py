# Copied from boojum_tpu/cs/__init__.py.
"""Constraint-system core (reference src/cs/)."""

from .cs import ConstraintSystem, CSConfig, LookupTable  # noqa: F401
from .geometry import CSGeometry, LookupParameters  # noqa: F401
