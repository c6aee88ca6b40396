# Copied from boojum_tpu/compat/__init__.py.
"""Compatibility with era-boojum's own artifacts (JSON VK and proof)."""

from . import era  # noqa: F401
