# Copied from boojum_tpu/verifier/__init__.py.
"""Verifier (reference src/cs/implementations/verifier.rs): host code on
Python ints."""

from .verifier import verify  # noqa: F401
