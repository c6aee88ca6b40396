# Copied from boojum_tpu/gadgets/tables.py.
"""Lookup-table builders.

Reference behavior: src/gadgets/tables/ — trixor4.rs, ch4.rs, maj4.rs,
chunk4bits.rs (split-at-1/2 with "reversed" merge column), and8.rs, xor8.rs,
byte_split.rs, range_check_16_bits.rs. Table content is pure data; ids are
assigned in add order (1-based).
"""

from __future__ import annotations

import numpy as np

from ..cs.cs import LookupTable


def create_tri_xor_table() -> LookupTable:
    """(a, b, c) -> a ^ b ^ c over 4-bit values (4096 rows, width 4)."""
    a, b, c = np.meshgrid(np.arange(16), np.arange(16), np.arange(16),
                          indexing="ij")
    a, b, c = a.reshape(-1), b.reshape(-1), c.reshape(-1)
    rows = np.stack([a, b, c, a ^ b ^ c], axis=1).astype(np.uint64)
    return LookupTable("TriXor4", rows, num_keys=3)


def create_ch4_table() -> LookupTable:
    """(a, b, c) -> (a & b) ^ (~a & c) per 4-bit chunks (sha256 Ch)."""
    a, b, c = np.meshgrid(np.arange(16), np.arange(16), np.arange(16),
                          indexing="ij")
    a, b, c = a.reshape(-1), b.reshape(-1), c.reshape(-1)
    v = ((a & b) ^ ((~a) & c)) & 0xF
    rows = np.stack([a, b, c, v], axis=1).astype(np.uint64)
    return LookupTable("Ch4", rows, num_keys=3)


def create_maj4_table() -> LookupTable:
    """(a, b, c) -> (a & b) ^ (a & c) ^ (b & c) per 4-bit chunks."""
    a, b, c = np.meshgrid(np.arange(16), np.arange(16), np.arange(16),
                          indexing="ij")
    a, b, c = a.reshape(-1), b.reshape(-1), c.reshape(-1)
    v = (a & b) ^ (a & c) ^ (b & c)
    rows = np.stack([a, b, c, v], axis=1).astype(np.uint64)
    return LookupTable("Maj4", rows, num_keys=3)


def create_4bit_chunk_split_table(split_at: int) -> LookupTable:
    """a -> (low = a & (2^s - 1), high = a >> s, reversed = low<<(4-s) | high)
    (reference chunk4bits.rs; symmetric, only s in {1, 2} needed)."""
    assert 1 <= split_at <= 2
    a = np.arange(16)
    low = a & ((1 << split_at) - 1)
    high = a >> split_at
    reversed_ = (low << (4 - split_at)) | high
    rows = np.stack([a, low, high, reversed_], axis=1).astype(np.uint64)
    return LookupTable(f"Split4BitChunk_{split_at}", rows, num_keys=1)


def create_xor8_table() -> LookupTable:
    """(a, b) -> a ^ b over bytes (65536 rows, width 3)."""
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    rows = np.stack([a, b, a ^ b], axis=1).astype(np.uint64)
    return LookupTable("Xor8", rows, num_keys=2)


def create_and8_table() -> LookupTable:
    a, b = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    rows = np.stack([a, b, a & b], axis=1).astype(np.uint64)
    return LookupTable("And8", rows, num_keys=2)


def create_byte_split_table(split_at: int) -> LookupTable:
    """byte -> (low, high) split at bit ``split_at`` (width 3)."""
    a = np.arange(256)
    rows = np.stack([a, a & ((1 << split_at) - 1), a >> split_at],
                    axis=1).astype(np.uint64)
    return LookupTable(f"ByteSplit_{split_at}", rows, num_keys=1)


def create_binop_table() -> LookupTable:
    """(a, b) -> xor<<32 | or<<16 | and packed in one value (width 3;
    reference binop_table.rs:9-35)."""
    a, b = np.meshgrid(np.arange(256, dtype=np.uint64),
                       np.arange(256, dtype=np.uint64), indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    value = ((a ^ b) << np.uint64(32)) | ((a | b) << np.uint64(16)) | (a & b)
    rows = np.stack([a, b, value], axis=1).astype(np.uint64)
    return LookupTable("Binop table", rows, num_keys=2)


def create_range_check_table(bits: int, width: int = 1) -> LookupTable:
    """Membership table [0, 2^bits): rows (x, 0, ..., 0) padded to ``width``
    so it can live in any CS lookup geometry (reference
    range_check_16_bits.rs / range_check_table.rs)."""
    col = np.arange(1 << bits, dtype=np.uint64)[:, None]
    rows = np.concatenate(
        [col, np.zeros((1 << bits, width - 1), np.uint64)], axis=1)
    return LookupTable(f"RangeCheck_{bits}", rows, num_keys=1)
