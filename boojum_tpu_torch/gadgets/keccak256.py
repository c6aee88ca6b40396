# Copied from boojum_tpu/gadgets/keccak256.py; the device-witness twins run on torch.
"""Keccak-256 circuit gadget (Ethereum-style legacy padding).

Reference behavior: src/gadgets/keccak256/ (keccak-f[1600] round gadget).
This build keeps every 64-bit lane as 16 four-bit chunk variables — keccak is
purely bitwise, so lanes never recompose to field elements:

- θ column parities and all XORs: TriXor4 lookups;
- χ's (~a)&b: the Ch4 table with b = 0 (ch(a,0,c) = (~a)&c);
- lane rotations: chunk rolls for multiples of 4, otherwise every chunk is
  split by a Split4BitChunk lookup and adjacent (low, high) pieces re-merge
  with one FMA per chunk;
- ι: XOR with per-round constant chunks.

Table budget: the same five tables as the sha256 bench circuit.

Every resolver closure carries a ``device_twin`` for
`prover/device_witness.DeviceWitnessProgram`: it takes and returns int64
tensors of u64 bit patterns shaped like its node's input and output places
(the JAX twins take (lo, hi) u32 pairs), so the circuit's witness runs on
the device from its input bytes alone. `build_keccak256_circuit` is the
circuit of tests/test_keccak_gadget.py:build.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cs import CSConfig, CSGeometry, LookupParameters
from ..cs.cs import ConstraintSystem
from ..cs.gates import ConstantsAllocatorGate, FmaGate, NopGate, ReductionGate
from ..hash.keccak import _RC as ROUND_CONSTANTS  # 24 iota constants (data)
from .sha256 import Sha256Gadget, add_sha256_tables
from .uints import allocate_u8_checked_batch

RATE_BYTES = 136  # 1088-bit rate for 256-bit output
CHUNKS_PER_LANE = 16

# rotation offsets r[x][y] (keccak spec), lanes indexed A[x, y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


class _Keccak:
    def __init__(self, cs: ConstraintSystem, g: Sha256Gadget):
        self.cs = cs
        self.g = g
        self.zero = g.constant(0)
        self._const_chunks = {}

    def constant_lane(self, value: int) -> np.ndarray:
        if value not in self._const_chunks:
            chunks = [(value >> (4 * i)) & 0xF for i in range(CHUNKS_PER_LANE)]
            self._const_chunks[value] = np.asarray(
                [self.g.constant(c) for c in chunks], np.uint64)
        return self._const_chunks[value]

    def xor2(self, a, b):
        zeros = np.full(len(a), self.zero, np.uint64)
        return self.g._tri_xor_batch(np.asarray(a, np.uint64),
                                     np.asarray(b, np.uint64), zeros)

    def xor3(self, a, b, c):
        return self.g._tri_xor_batch(np.asarray(a, np.uint64),
                                     np.asarray(b, np.uint64),
                                     np.asarray(c, np.uint64))

    def not_and(self, a, b):
        """(~a) & b per chunk: ch(a, 0, b)."""
        zeros = np.full(len(a), self.zero, np.uint64)
        return self.g._table3_batch(
            self.g.t["ch"], np.asarray(a, np.uint64), zeros,
            np.asarray(b, np.uint64),
            lambda v: ((~v[0]) & v[2]) & np.uint64(0xF),
            dev_fn=lambda v: (~v[0] & v[2]) & 0xF)

    def _split_chunks(self, chunks, s: int):
        """Split every chunk at bit s via lookups; returns (lows, highs)."""
        cs = self.cs
        g = self.g
        n = len(chunks)
        chunks = np.asarray(chunks, np.uint64)
        lows = cs.alloc_variables(n)
        highs = cs.alloc_variables(n)
        if s in (1, 2):
            def fn(vals):
                v = vals[0]
                return np.stack([v & np.uint64((1 << s) - 1),
                                 v >> np.uint64(s)])

            def fn_dev(vals, s=s):
                v = vals[0]
                return torch.stack([v & ((1 << s) - 1), v >> s])

            fn.device_twin = fn_dev
            cs.set_values_with_dependencies(chunks[None, :],
                                            np.stack([lows, highs]), fn)
            revs = cs.alloc_variables(n)

            def rev_fn(vals):
                lo, hi = vals
                return (lo << np.uint64(4 - s)) | hi

            def rev_fn_dev(vals, s=s):
                return (vals[0] << (4 - s)) | vals[1]

            rev_fn.device_twin = rev_fn_dev
            cs.set_values_with_dependencies(np.stack([lows, highs]), revs, rev_fn)
            cs.enforce_lookup_batch(
                g.t[f"split{s}"], np.stack([chunks, lows, highs, revs]))
        else:  # s == 3: symmetric use of split-at-1
            assert s == 3

            def fn(vals):
                v = vals[0]
                return np.stack([v & np.uint64(0x7), v >> np.uint64(3)])

            def fn_dev(vals):
                v = vals[0]
                return torch.stack([v & 0x7, v >> 3])

            fn.device_twin = fn_dev
            cs.set_values_with_dependencies(chunks[None, :],
                                            np.stack([lows, highs]), fn)
            keys = cs.alloc_variables(n)

            def key_fn(vals):
                lo, hi = vals
                return (lo << np.uint64(1)) | hi

            def key_fn_dev(vals):
                return (vals[0] << 1) | vals[1]

            key_fn.device_twin = key_fn_dev
            cs.set_values_with_dependencies(np.stack([lows, highs]), keys, key_fn)
            # table1 over key: low1(key) = high, high3(key) = low,
            # reversed(key) = original chunk — binds everything
            cs.enforce_lookup_batch(
                g.t["split1"], np.stack([keys, highs, lows, chunks]))
        return lows, highs

    def rotl(self, chunks, r: int):
        """Left-rotate a chunked lane by r bits."""
        r %= 64
        q, m = divmod(r, 4)
        z = np.roll(np.asarray(chunks, np.uint64), q)
        if m == 0:
            return z
        return self._rotl_group(z[None, :], m)[0]

    def _rotl_group(self, z: np.ndarray, m: int) -> np.ndarray:
        """Sub-chunk rotate a (g, 16) GROUP of pre-rolled lanes by the SAME
        m in one split batch + one FMA batch (synthesis is Python-call-bound:
        per-lane calls made keccak synthesis ~8 s — SURVEY §2.6's 'lean on
        batching' note)."""
        g_count = z.shape[0]
        lows, highs = self._split_chunks(z.reshape(-1), 4 - m)
        lows = np.asarray(lows, np.uint64).reshape(g_count, CHUNKS_PER_LANE)
        highs = np.asarray(highs, np.uint64).reshape(g_count, CHUNKS_PER_LANE)
        one = self.g.constant(1)
        # y[i] = low[i]·2^m + high[i-1] (per lane)
        y = FmaGate.compute_fma_batch(
            self.cs, 1 << m,
            (np.full(g_count * CHUNKS_PER_LANE, one, np.uint64),
             lows.reshape(-1)),
            1, np.roll(highs, 1, axis=1).reshape(-1))
        return np.asarray(y, np.uint64).reshape(g_count, CHUNKS_PER_LANE)


def keccak_f(cs: ConstraintSystem, st: _Keccak, lanes: list) -> list:
    """keccak-f[1600] on 25 chunked lanes (A[x + 5y] convention).

    Every step batches ALL its lookups into one gadget call per table
    (theta parities, the 5 D-rotations, the 25 chi terms) and rho+pi lanes
    group by their sub-chunk shift — ~14 vectorized calls per round instead
    of ~110 per-lane ones."""
    A = np.stack([np.asarray(l, np.uint64) for l in lanes])  # (25, 16)
    shp = (5, 5, CHUNKS_PER_LANE)  # [y, x, chunk] for index x + 5y
    for rnd in range(24):
        # theta: C[x] = xor of column x — two xor3 batches over (5, 16)
        col = A.reshape(shp)
        t = st.xor3(col[0].reshape(-1), col[1].reshape(-1),
                    col[2].reshape(-1))
        C = st.xor3(t, col[3].reshape(-1), col[4].reshape(-1)) \
            .reshape(5, CHUNKS_PER_LANE)
        # D[x] = C[x-1] ^ rotl(C[x+1], 1) — one grouped rotation (m=1)
        rot = st._rotl_group(C[[1, 2, 3, 4, 0]], 1)
        D = st.xor2(C[[4, 0, 1, 2, 3]].reshape(-1), rot.reshape(-1)) \
            .reshape(5, CHUNKS_PER_LANE)
        # A ^= D (broadcast D[x] over y)
        A = st.xor2(A.reshape(-1),
                    np.broadcast_to(D[None], shp).reshape(-1)) \
            .reshape(25, CHUNKS_PER_LANE)
        # rho + pi: B[y + 5*((2x+3y)%5)] = rotl(A[x + 5y], r[x][y]),
        # lanes grouped by sub-chunk shift m (same split table per group)
        B = np.empty_like(A)
        groups = {}
        for x in range(5):
            for y in range(5):
                q, m = divmod(_ROT[x][y] % 64, 4)
                src = np.roll(A[x + 5 * y], q)
                dst = y + 5 * ((2 * x + 3 * y) % 5)
                groups.setdefault(m, []).append((dst, src))
        for m, items in sorted(groups.items()):
            z = np.stack([s for (_, s) in items])
            out = z if m == 0 else st._rotl_group(z, m)
            for (dst, _), row in zip(items, out):
                B[dst] = row
        # chi: A[x] = B[x] ^ ((~B[x+1]) & B[x+2]) — one not_and + one xor2
        Br = B.reshape(shp)
        na = st.not_and(Br[:, [1, 2, 3, 4, 0]].reshape(-1),
                        Br[:, [2, 3, 4, 0, 1]].reshape(-1))
        A = st.xor2(B.reshape(-1), na).reshape(25, CHUNKS_PER_LANE)
        # iota
        A[0] = st.xor2(A[0], st.constant_lane(ROUND_CONSTANTS[rnd]))
    return [A[i] for i in range(25)]


def keccak256(cs: ConstraintSystem, input_bytes_vars: np.ndarray,
              table_ids: dict) -> np.ndarray:
    """Keccak-256 digest of the input bytes as 32 byte variables."""
    g = Sha256Gadget(cs, table_ids)
    st = _Keccak(cs, g)

    # bytes -> chunk pairs (each byte = lo4 + hi4·16, constrained by fma;
    # chunks range-checked by their xor uses in the absorb step)
    msg = [int(v) for v in input_bytes_vars]
    # legacy multirate padding: 0x01 ... 0x80 (single 0x81 if one byte left)
    pad_len = RATE_BYTES - (len(msg) % RATE_BYTES)
    if pad_len == 1:
        msg.append(g.constant(0x81))
    else:
        msg.append(g.constant(0x01))
        msg.extend(g.constant(0x00) for _ in range(pad_len - 2))
        msg.append(g.constant(0x80))
    assert len(msg) % RATE_BYTES == 0

    def byte_to_chunks(byte_vars):
        """(k,) byte vars -> (2k,) chunk vars with byte = lo + 16·hi."""
        b = np.asarray(byte_vars, np.uint64)
        k = b.shape[0]
        lows = cs.alloc_variables(k)
        highs = cs.alloc_variables(k)

        def fn(vals):
            v = vals[0]
            return np.stack([v & np.uint64(0xF), v >> np.uint64(4)])

        def fn_dev(vals):
            v = vals[0]
            return torch.stack([v & 0xF, v >> 4])

        fn.device_twin = fn_dev
        cs.set_values_with_dependencies(b[None, :], np.stack([lows, highs]), fn)
        one = g.constant(1)
        FmaGate.enforce_fma_batch(cs, 16, (np.full(k, one, np.uint64), highs),
                                  1, lows, b)
        out = np.empty(2 * k, np.uint64)
        out[0::2] = lows
        out[1::2] = highs
        return out

    zero_lane = np.full(CHUNKS_PER_LANE, st.zero, np.uint64)
    lanes = [zero_lane.copy() for _ in range(25)]

    for off in range(0, len(msg), RATE_BYTES):
        block = msg[off:off + RATE_BYTES]
        chunks = byte_to_chunks(block)  # 272 chunks = 17 lanes
        for lane_i in range(RATE_BYTES // 8):
            lane_chunks = chunks[16 * lane_i:16 * (lane_i + 1)]
            lanes[lane_i] = st.xor2(lanes[lane_i], lane_chunks)
        lanes = keccak_f(cs, st, lanes)

    # squeeze 32 bytes = first 4 lanes
    one = g.constant(1)
    out = []
    for lane_i in range(4):
        ch = lanes[lane_i]
        for b in range(8):
            lo, hi = int(ch[2 * b]), int(ch[2 * b + 1])
            out.append(FmaGate.compute_fma(cs, 16, (one, hi), 1, lo))
    return np.asarray(out, np.uint64)


def build_keccak256_circuit(data: bytes, max_trace_len=1 << 16):
    """The Keccak-256 circuit of tests/test_keccak_gadget.py:build: the
    digest of ``data`` with 60 copy columns, 4 constant columns and width-4
    specialized lookups in 8 repetitions over the five SHA-256 tables.
    Returns the constraint system (not yet padded) and the 32 digest byte
    variables."""
    geometry = CSGeometry(num_columns_under_copy_permutation=60,
                          num_witness_columns=0, num_constant_columns=4,
                          max_allowed_constraint_degree=4)
    lookup = LookupParameters.specialized_with_table_id_as_constant(
        width=4, num_repetitions=8, share_table_id=True)
    cs = ConstraintSystem(geometry, max_trace_len, CSConfig.dev())
    cs.allow_lookup(lookup)
    for g in (ConstantsAllocatorGate, FmaGate, NopGate):
        cs.allow_gate(g)
    cs.allow_gate(ReductionGate, params=4)
    tids = add_sha256_tables(cs)
    in_vars = allocate_u8_checked_batch(
        cs, np.frombuffer(data, np.uint8).astype(np.uint64), tids)
    return cs, keccak256(cs, in_vars, tids)
