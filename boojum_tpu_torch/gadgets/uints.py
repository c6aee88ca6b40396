# Copied from boojum_tpu/gadgets/uints.py; the device-witness twins run on torch.
"""Byte / u32 allocation helpers (reference src/gadgets/u8, u32 essentials).

UInt8 range checks go through the sha256 4-bit tables when present
(byte = hi·16 + lo with both chunks checked by TriXor lookups), mirroring the
bench circuit's table budget.

Each resolver closure carries a ``device_twin`` for
`prover/device_witness.DeviceWitnessProgram`: it takes and returns int64
tensors of u64 bit patterns, shaped like the node's input and output places
(the JAX twins take (lo, hi) u32 pairs instead).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cs.cs import ConstraintSystem
from ..cs.gates import ConstantsAllocatorGate, FmaGate


def allocate_u8_checked_batch(cs: ConstraintSystem, values, table_ids) -> np.ndarray:
    """Allocate byte variables with values, range-checked via 4-bit split +
    TriXor lookups (batched across all bytes)."""
    values = np.asarray(values, np.uint64)
    n = values.shape[0]
    bytes_v = cs.alloc_variables_with_values(values)
    los = cs.alloc_variables(n)
    his = cs.alloc_variables(n)

    def fn(vals):
        v = vals[0]
        return np.stack([v & np.uint64(0xF), v >> np.uint64(4)])

    def fn_dev(vals):
        v = vals[0]
        return torch.stack([v & 0xF, v >> 4])

    fn.device_twin = fn_dev
    cs.set_values_with_dependencies(bytes_v[None, :], np.stack([los, his]), fn)
    one = ConstantsAllocatorGate.allocate_constant(cs, 1)
    ones = np.full(n, one, np.uint64)
    FmaGate.enforce_fma_batch(cs, 1 << 4, (ones, his), 1, los, bytes_v)

    # range check all chunks in triples via TriXor lookups
    zero = ConstantsAllocatorGate.allocate_constant(cs, 0)
    chunks = np.concatenate([los, his])
    pad = (-len(chunks)) % 3
    if pad:
        chunks = np.concatenate([chunks, np.full(pad, zero, np.uint64)])
    tri = chunks.reshape(-1, 3).T
    out = cs.alloc_variables(tri.shape[1])

    def xor_fn(vals):
        return vals[0] ^ vals[1] ^ vals[2]

    def xor_fn_dev(vals):
        return vals[0] ^ vals[1] ^ vals[2]

    xor_fn.device_twin = xor_fn_dev
    cs.set_values_with_dependencies(tri, out, xor_fn)
    cs.enforce_lookup_batch(table_ids["tri_xor"],
                            np.concatenate([tri, out[None, :]]))
    return bytes_v
