# Copied from boojum_tpu/cs/places.py.
"""Variable / witness handles.

Reference behavior: src/cs/mod.rs:35-185 — u64 handles, bit 63 = placeholder,
bit 62 = witness (non-copiable), low 48 bits = index. We keep the same bit
layout so handle arrays are plain numpy uint64 vectors (synthesis is
vectorized over handles wherever gadgets batch).
"""

from __future__ import annotations

import numpy as np

PLACEHOLDER_BIT = 1 << 63
WITNESS_BIT = 1 << 62
LOW_U48_MASK = (1 << 48) - 1

PLACEHOLDER = PLACEHOLDER_BIT  # canonical placeholder handle


def variable(index: int) -> int:
    return index


def witness(index: int) -> int:
    return index | WITNESS_BIT


def is_placeholder(v) -> bool:
    return bool(np.bitwise_and(np.uint64(v) if np.isscalar(v) else v,
                               np.uint64(PLACEHOLDER_BIT)) != 0) if np.isscalar(v) \
        else (np.asarray(v, np.uint64) & np.uint64(PLACEHOLDER_BIT)) != 0


def is_witness(v):
    return (np.uint64(v) & np.uint64(WITNESS_BIT)) != 0


def index_of(v):
    """Low-48-bit index (works on scalars and arrays)."""
    if np.isscalar(v) or isinstance(v, (int, np.integer)):
        return int(v) & LOW_U48_MASK
    return np.asarray(v, np.uint64) & np.uint64(LOW_U48_MASK)
