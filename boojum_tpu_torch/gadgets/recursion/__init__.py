# Copied from boojum_tpu/gadgets/recursion/__init__.py (empty there).
"""The recursion layer: a proof's verification as circuit constraints
(reference src/gadgets/recursion/)."""
