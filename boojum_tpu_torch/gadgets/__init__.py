# Copied from boojum_tpu/gadgets/__init__.py.
"""Gadget library (reference src/gadgets/)."""

from . import sha256, tables, uints  # noqa: F401
