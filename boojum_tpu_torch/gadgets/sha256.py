# Copied from boojum_tpu/gadgets/sha256.py; the device-witness twins run on torch.
"""SHA-256 circuit gadget — the flagship benchmark circuit.

Reference behavior: src/gadgets/sha256/mod.rs (:35 padding/blocks/digest) and
round_function.rs — 32-bit words as variables, bitwise ops through 4-bit
chunked lookups (TriXor4 / Ch4 / Maj4), rotations via the
split-at-(r mod 4) decomposition with a Split4BitChunk seam lookup, mod-2^32
additions as free-width field sums range-reduced through 36-bit decomposition
(range_check_36 / split_36_unchecked), deferred 4-bit range checks flushed in
triples through TriXor lookups.

The circuit semantics match the reference; the synthesis is batched where a
step has independent parts (all 8 chunks of a word hit the lookup argument in
one enforce_lookup_batch; deferred range checks flush as one batch).

The resolver closures that the flagship records carry ``device_twin``s for
`prover/device_witness.DeviceWitnessProgram`: each takes and returns int64
tensors of u64 bit patterns shaped like its node's input and output places
(the JAX twins take (lo, hi) u32 pairs). The witness pass's twin is
`_sha256_witness_dev`, whose compression chain is kernel K5
(`sha256_witness.compress_chain`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cs.cs import ConstraintSystem
from ..cs.gates import ConstantsAllocatorGate, FmaGate, ReductionGate
from . import tables

SHA256_ROUNDS = 64
SHA256_BLOCK_SIZE = 64
SHA256_DIGEST_SIZE = 32

INITIAL_STATE = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

ROUND_CONSTANTS = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2]

_MASK4 = 0xF


def add_sha256_tables(cs: ConstraintSystem) -> dict:
    """Add the five bench tables in the reference's order (sha256/mod.rs:388)."""
    ids = {}
    ids["tri_xor"] = cs.add_lookup_table(tables.create_tri_xor_table())
    ids["ch"] = cs.add_lookup_table(tables.create_ch4_table())
    ids["maj"] = cs.add_lookup_table(tables.create_maj4_table())
    ids["split1"] = cs.add_lookup_table(tables.create_4bit_chunk_split_table(1))
    ids["split2"] = cs.add_lookup_table(tables.create_4bit_chunk_split_table(2))
    return ids


class Sha256Gadget:
    def __init__(self, cs: ConstraintSystem, table_ids: dict):
        self.cs = cs
        self.t = table_ids
        self._const_cache = {}
        # value-handle -> 4-bit chunk handles, so words whose decomposition
        # already exists (rotated state words, range-check outputs) are not
        # re-decomposed each round (the reference caches via its
        # decomposition tooling, u32/mod.rs:96)
        self._chunk_cache = {}

    # -- small helpers ------------------------------------------------------

    def constant(self, v: int) -> int:
        return ConstantsAllocatorGate.allocate_constant(self.cs, v)

    def _tri_xor_batch(self, a, b, c):
        """a, b, c: (k,) handle arrays -> xor handle array; performs the
        lookup which also range-checks all inputs to 4 bits."""
        cs = self.cs
        a = np.asarray(a, np.uint64)
        b = np.asarray(b, np.uint64)
        c = np.asarray(c, np.uint64)
        out = cs.alloc_variables(a.shape[0])

        def fn(vals):
            return vals[0] ^ vals[1] ^ vals[2]

        def fn_dev(vals):
            return vals[0] ^ vals[1] ^ vals[2]

        fn.device_twin = fn_dev
        cs.set_values_with_dependencies(np.stack([a, b, c]), out, fn)
        cs.enforce_lookup_batch(self.t["tri_xor"], np.stack([a, b, c, out]))
        return out

    def _table3_batch(self, tid, a, b, c, np_fn, dev_fn=None):
        cs = self.cs
        a = np.asarray(a, np.uint64)
        out = cs.alloc_variables(a.shape[0])
        if dev_fn is not None:
            np_fn.device_twin = dev_fn
        cs.set_values_with_dependencies(
            np.stack([a, np.asarray(b, np.uint64), np.asarray(c, np.uint64)]),
            out, np_fn)
        cs.enforce_lookup_batch(tid, np.stack([a, b, c, out]))
        return out

    def ch_batch(self, a, b, c):
        return self._table3_batch(
            self.t["ch"], a, b, c,
            lambda v: ((v[0] & v[1]) ^ ((~v[0]) & v[2])) & np.uint64(_MASK4),
            dev_fn=lambda v: ((v[0] & v[1]) ^ (~v[0] & v[2])) & _MASK4)

    def maj_batch(self, a, b, c):
        return self._table3_batch(
            self.t["maj"], a, b, c,
            lambda v: (v[0] & v[1]) ^ (v[0] & v[2]) ^ (v[1] & v[2]),
            dev_fn=lambda v: (v[0] & v[1]) ^ (v[0] & v[2]) ^ (v[1] & v[2]))

    def range_check_chunks(self, chunks):
        """Range-check a list of 4-bit chunk handles in triples via TriXor
        lookups (reference's deferred-check flush)."""
        zero = self.constant(0)
        chunks = list(chunks)
        while len(chunks) % 3:
            chunks.append(zero)
        arr = np.asarray(chunks, np.uint64).reshape(-1, 3).T
        self._tri_xor_batch(arr[0], arr[1], arr[2])

    # -- decompositions -----------------------------------------------------

    def uint32_into_4bit_chunks(self, v: int) -> np.ndarray:
        cached = self._chunk_cache.get(int(v))
        if cached is not None:
            return cached
        cs = self.cs
        chunks = cs.alloc_variables(8)

        def fn(vals):
            x = vals[0, 0]
            return np.asarray([(int(x) >> (4 * i)) & _MASK4 for i in range(8)],
                              np.uint64)

        cs.set_values_with_dependencies(
            np.asarray([[v]], np.uint64), chunks, fn)
        self._constrain_chunk_recomposition(v, chunks)
        self._chunk_cache[int(v)] = chunks
        return chunks

    def _constrain_chunk_recomposition(self, v: int, chunks):
        """v == Σ chunks[i]·16^i via two reductions + one fma."""
        cs = self.cs
        c16 = [1, 1 << 4, 1 << 8, 1 << 12]
        low = ReductionGate.reduce_terms(cs, c16, list(chunks[:4]))
        high = ReductionGate.reduce_terms(cs, c16, list(chunks[4:8]))
        one = self.constant(1)
        FmaGate.enforce_fma_batch(cs, 1 << 16, ([one], [high]), 1, [low], [v])

    def uint32_from_4bit_chunks(self, chunks) -> int:
        return int(self.uint32_from_4bit_chunks_batch(
            np.asarray(chunks, np.uint64)[None, :])[0])

    def uint32_from_4bit_chunks_batch(self, chunks_2d) -> np.ndarray:
        """(n, 8) chunk handles -> (n,) u32 handles, batched reductions."""
        cs = self.cs
        chunks_2d = np.asarray(chunks_2d, np.uint64)
        c16 = [1, 1 << 4, 1 << 8, 1 << 12]
        low = ReductionGate.reduce_terms_batch(cs, c16, chunks_2d[:, :4].T)
        high = ReductionGate.reduce_terms_batch(cs, c16, chunks_2d[:, 4:8].T)
        one = self.constant(1)
        ones = np.full(low.shape[0], one, np.uint64)
        out = FmaGate.compute_fma_batch(cs, 1 << 16, (ones, high), 1, low)
        for i in range(out.shape[0]):
            self._chunk_cache[int(out[i])] = chunks_2d[i]
        return out

    def split_and_rotate(self, v: int, rotation: int):
        """Right-rotation by ``rotation``: returns (rotated 8 chunks,
        decompose_low, decompose_high). Chunks are range-checked by their
        later lookup uses; the seam (low, high) pair is bound and checked by
        a Split4BitChunk lookup (reference round_function.rs:414)."""
        cs = self.cs
        m = rotation % 4
        k = rotation // 4
        if m == 0:
            chunks = self.uint32_into_4bit_chunks(v)
            rotated = np.roll(chunks, -k)
            # low/high pieces for shift tricks: not meaningful here
            zero = self.constant(0)
            return rotated, zero, zero

        # decompose: low (m bits), 7 aligned 4-bit chunks, high (4-m bits)
        parts = cs.alloc_variables(9)

        def fn(vals):
            x = int(vals[0, 0])
            out = [x & ((1 << m) - 1)]
            x >>= m
            for _ in range(7):
                out.append(x & _MASK4)
                x >>= 4
            out.append(x)
            return np.asarray(out, np.uint64)

        cs.set_values_with_dependencies(np.asarray([[v]], np.uint64), parts, fn)
        low, aligned, high = int(parts[0]), parts[1:8], int(parts[8])

        # recomposition: v == low + Σ aligned[i]·2^{m+4i} + high·2^{m+28}
        t = ReductionGate.reduce_terms(
            cs, [1, 1 << m, 1 << (m + 4), 1 << (m + 8)],
            [low, int(aligned[0]), int(aligned[1]), int(aligned[2])])
        t = ReductionGate.reduce_terms(
            cs, [1, 1 << (m + 12), 1 << (m + 16), 1 << (m + 20)],
            [t, int(aligned[3]), int(aligned[4]), int(aligned[5])])
        zero = self.constant(0)
        t2 = ReductionGate.reduce_terms(
            cs, [1, 1 << (m + 24), 1 << (m + 28), 0],
            [t, int(aligned[6]), high, zero])
        # t2 must equal v
        one = self.constant(1)
        FmaGate.enforce_fma_batch(cs, 1, ([one], [t2]), 0, [zero], [v])

        # seam chunk: merged original-order a = high<<m | low; rotated-order
        # seam = low<<(4-m) | high. Split tables exist for m in {1, 2}; m == 3
        # uses the symmetric table with (low, high) roles swapped.
        seam_key = cs.alloc_variables(1)
        seam_rev = cs.alloc_variables(1)

        if m in (1, 2):
            tid = self.t[f"split{m}"]

            def seam_fn(vals):
                lo, hi = int(vals[0, 0]), int(vals[1, 0])
                key = (hi << m) | lo
                rev = (lo << (4 - m)) | hi
                return np.asarray([key, rev], np.uint64)

            cs.set_values_with_dependencies(
                np.asarray([[low], [high]], np.uint64),
                np.concatenate([seam_key, seam_rev]), seam_fn)
            cs.enforce_lookup_batch(
                tid, np.asarray([[int(seam_key[0])], [low], [high],
                                 [int(seam_rev[0])]], np.uint64))
            seam = int(seam_rev[0])
        else:  # m == 3: use split-at-1 on the rotated-order value
            tid = self.t["split1"]

            def seam_fn(vals):
                lo, hi = int(vals[0, 0]), int(vals[1, 0])
                key = (lo << 1) | hi  # rotated-order value, split at 1
                rev = (hi << 3) | lo  # original-order value
                return np.asarray([key, rev], np.uint64)

            cs.set_values_with_dependencies(
                np.asarray([[low], [high]], np.uint64),
                np.concatenate([seam_key, seam_rev]), seam_fn)
            # table: key -> (key&1, key>>1, (key&1)<<3 | key>>1)
            #        = (high, low, original-order merge)
            cs.enforce_lookup_batch(
                tid, np.asarray([[int(seam_key[0])], [high], [low],
                                 [int(seam_rev[0])]], np.uint64))
            seam = int(seam_key[0])

        # rotated chunks: [aligned[k..7], seam, aligned[0..k]]
        rotated = np.empty(8, np.uint64)
        for i in range(7 - k):
            rotated[i] = aligned[k + i]
        rotated[7 - k] = seam
        for i in range(k):
            rotated[8 - k + i] = aligned[i]
        return rotated, low, high

    def split_36_unchecked(self, v: int):
        """v (< 2^36) == low_u32 + high·2^32; high returned unchecked."""
        cs = self.cs
        parts = cs.alloc_variables(2)

        def fn(vals):
            x = int(vals[0, 0])
            return np.asarray([x & 0xFFFFFFFF, x >> 32], np.uint64)

        cs.set_values_with_dependencies(np.asarray([[v]], np.uint64), parts, fn)
        one = self.constant(1)
        FmaGate.enforce_fma_batch(cs, 1 << 32, ([one], [int(parts[1])]),
                                  1, [int(parts[0])], [v])
        return int(parts[0]), int(parts[1])

    def range_check_36(self, v: int):
        """Full check: v = Σ_{i<9} chunk_i·16^i with all chunks 4-bit."""
        cs = self.cs
        chunks = cs.alloc_variables(9)

        def fn(vals):
            x = int(vals[0, 0])
            return np.asarray([(x >> (4 * i)) & _MASK4 for i in range(9)],
                              np.uint64)

        cs.set_values_with_dependencies(np.asarray([[v]], np.uint64), chunks, fn)
        c16 = [1, 1 << 4, 1 << 8, 1 << 12]
        low = ReductionGate.reduce_terms(cs, c16, [int(x) for x in chunks[:4]])
        high = ReductionGate.reduce_terms(cs, c16, [int(x) for x in chunks[4:8]])
        one = self.constant(1)
        u32_part = FmaGate.compute_fma(cs, 1 << 16, (one, high), 1, low)
        FmaGate.enforce_fma_batch(cs, 1 << 32, ([one], [int(chunks[8])]),
                                  1, [u32_part], [v])
        self._tri_xor_batch(chunks[0::3][:3], chunks[1::3][:3], chunks[2::3][:3])
        self._chunk_cache[int(u32_part)] = np.asarray(chunks[:8], np.uint64)
        return u32_part, chunks

    def range_check_u32(self, v: int):
        chunks = self.uint32_into_4bit_chunks(v)
        self._chunk_cache[int(v)] = np.asarray(chunks, np.uint64)
        a = np.asarray([chunks[0], chunks[3], chunks[6]], np.uint64)
        b = np.asarray([chunks[1], chunks[4], chunks[7]], np.uint64)
        c = np.asarray([chunks[2], chunks[5], chunks[0]], np.uint64)
        self._tri_xor_batch(a, b, c)
        return chunks


# ---------------------------------------------------------------------------
# Batched witness-first pipeline
# ---------------------------------------------------------------------------
#
# The constraint inventory is the same as the reference gadget
# (round_function.rs): 4-bit chunked TriXor/Ch/Maj lookups, rotations via the
# split-at-(r mod 4) decomposition with a Split4BitChunk seam lookup,
# mod-2^32 additions range-reduced through 36-bit decompositions, deferred
# 4-bit checks flushed in TriXor triples. The synthesis strategy differs:
# the whole witness (every intermediate of every block) is computed first as
# one vectorized numpy pass and registered as a single resolver node, then
# each constraint family is placed with one batched gate/lookup call over
# all (block x round) instances. This turns ~750k per-scalar resolver and
# placement calls into ~60 array-sized ones.

_C16 = [1, 1 << 4, 1 << 8, 1 << 12]
_U = np.uint64


def _ror32(v, r):
    r = _U(r)
    return ((v >> r) | (v << (_U(32) - r))) & _U(0xFFFFFFFF)


def _chunks8(v):
    """(n,) u32 values -> (n, 8) 4-bit chunk values."""
    return np.stack([(v >> _U(4 * i)) & _U(0xF) for i in range(8)], axis=-1)


def _rot_parts(v, rotation):
    """Witness values of one rotation decomposition: (n,) -> (n, 13)
    [low, a0..a6, high, t1, t2, seam_key, seam_rev]."""
    m = rotation % 4
    assert m != 0
    low = v & _U((1 << m) - 1)
    aligned = [(v >> _U(m + 4 * i)) & _U(0xF) for i in range(7)]
    high = v >> _U(m + 28)
    t1 = low + (aligned[0] << _U(m)) + (aligned[1] << _U(m + 4)) \
        + (aligned[2] << _U(m + 8))
    t2 = t1 + (aligned[3] << _U(m + 12)) + (aligned[4] << _U(m + 16)) \
        + (aligned[5] << _U(m + 20))
    if m in (1, 2):
        skey = (high << _U(m)) | low
        srev = (low << _U(4 - m)) | high
    else:  # m == 3
        skey = (low << _U(1)) | high
        srev = (high << _U(3)) | low
    return np.stack([low, *aligned, high, t1, t2, skey, srev], axis=-1)


def _rot_chunks(v, rotation):
    return _chunks8(_ror32(v, rotation))


def _from_chunks_parts(word):
    """(n,) u32 -> (n, 3) [low16, high16, word] reduce/fma temporaries."""
    return np.stack([word & _U(0xFFFF), word >> _U(16), word], axis=-1)


def _range36_parts(t):
    """(n,) <2^36 values -> (n, 12) [chunk0..8, low16, high16, u32]."""
    chunks = [(t >> _U(4 * i)) & _U(0xF) for i in range(9)]
    u32 = t & _U(0xFFFFFFFF)
    return np.stack([*chunks, u32 & _U(0xFFFF), u32 >> _U(16), u32], axis=-1)


def _dec_parts(word):
    """(n,) u32 -> (n, 10) [chunk0..7, low16, high16] decomposition temps."""
    ch = [(word >> _U(4 * i)) & _U(0xF) for i in range(8)]
    return np.stack([*ch, word & _U(0xFFFF), word >> _U(16)], axis=-1)


def _sha256_witness(blocks: np.ndarray, init_state: np.ndarray) -> dict:
    """blocks: (nb, 64) byte values -> ordered dict of every intermediate
    the circuit allocates, vectorized over blocks. The same function runs at
    synthesis and at witness playback (it is the body of the one resolver
    node the gadget registers)."""
    nb = blocks.shape[0]
    out = {}

    be = blocks.reshape(nb, 16, 4).astype(np.uint64)
    W = np.zeros((nb, 64), _U)
    W[:, :16] = (be[:, :, 0] << _U(24)) | (be[:, :, 1] << _U(16)) | \
                (be[:, :, 2] << _U(8)) | be[:, :, 3]
    sch_t = np.zeros((nb, 48), _U)
    for i in range(16, 64):
        x0, x1 = W[:, i - 15], W[:, i - 2]
        s0 = _ror32(x0, 7) ^ _ror32(x0, 18) ^ (x0 >> _U(3))
        s1 = _ror32(x1, 17) ^ _ror32(x1, 19) ^ (x1 >> _U(10))
        t = s0 + s1 + W[:, i - 7] + W[:, i - 16]
        sch_t[:, i - 16] = t
        W[:, i] = t & _U(0xFFFFFFFF)
    out["W"] = W
    out["sch_t"] = sch_t
    x0 = W[:, 1:49].reshape(-1)   # schedule sigma0 inputs, idx-major later
    x1 = W[:, 14:62].reshape(-1)
    for r in (7, 18):
        out[f"rot_x0_{r}"] = _rot_parts(x0, r).reshape(nb, 48, 13)
    for r in (17, 19, 10):
        out[f"rot_x1_{r}"] = _rot_parts(x1, r).reshape(nb, 48, 13)
    s0w = _ror32(x0, 7) ^ _ror32(x0, 18) ^ (x0 >> _U(3))
    s1w = _ror32(x1, 17) ^ _ror32(x1, 19) ^ (x1 >> _U(10))
    out["sch_s0x"] = _chunks8(s0w).reshape(nb, 48, 8)
    out["sch_s1x"] = _chunks8(s1w).reshape(nb, 48, 8)
    out["sch_s0w"] = _from_chunks_parts(s0w).reshape(nb, 48, 3)
    out["sch_s1w"] = _from_chunks_parts(s1w).reshape(nb, 48, 3)
    out["sch_hi"] = (sch_t[:, :46] >> _U(32))
    out["sch_rc36"] = _range36_parts(sch_t[:, 46:48].reshape(-1)) \
        .reshape(nb, 2, 12)

    # rounds: chaining state is sequential across blocks
    state_in = np.zeros((nb, 8), _U)
    new_e = np.zeros((nb, 64), _U)
    new_a = np.zeros((nb, 64), _U)
    rnd = {k: np.zeros((nb, 64), _U)
           for k in ("s1w_", "chw_", "s0w_", "majw_", "tmp1", "tmp1w",
                     "te", "ta")}
    fin_t = np.zeros((nb, 8), _U)
    state_out = np.zeros((nb, 8), _U)
    cur = init_state.astype(_U)
    for b in range(nb):
        state_in[b] = cur
        a, bb, c, d, e, f, g, h = (int(x) for x in cur)
        for r in range(64):
            s1 = int(_ror32(_U(e), 6) ^ _ror32(_U(e), 11) ^ _ror32(_U(e), 25))
            ch = (e & f) ^ ((~e & 0xFFFFFFFF) & g)
            tmp1 = h + s1 + ch + ROUND_CONSTANTS[r]
            tmp1w = tmp1 + int(W[b, r])
            te = tmp1w + d
            s0 = int(_ror32(_U(a), 2) ^ _ror32(_U(a), 13) ^ _ror32(_U(a), 22))
            maj = (a & bb) ^ (a & c) ^ (bb & c)
            ta = s0 + maj + tmp1w
            rnd["s1w_"][b, r] = s1
            rnd["chw_"][b, r] = ch
            rnd["s0w_"][b, r] = s0
            rnd["majw_"][b, r] = maj
            rnd["tmp1"][b, r] = tmp1
            rnd["tmp1w"][b, r] = tmp1w
            rnd["te"][b, r] = te
            rnd["ta"][b, r] = ta
            ne, na = te & 0xFFFFFFFF, ta & 0xFFFFFFFF
            new_e[b, r], new_a[b, r] = ne, na
            h, g, f, e = g, f, e, ne
            d, c, bb, a = c, bb, a, na
        fin = np.asarray([a, bb, c, d, e, f, g, h], _U)
        fin_t[b] = state_in[b] + fin
        cur = fin_t[b] & _U(0xFFFFFFFF)
        state_out[b] = cur

    out["new_e"] = new_e
    out["new_a"] = new_a
    # rotation families over e_r / a_r for r in 0..63
    e_in = np.concatenate([state_in[:, 4:5], new_e[:, :63]], axis=1).reshape(-1)
    a_in = np.concatenate([state_in[:, 0:1], new_a[:, :63]], axis=1).reshape(-1)
    for r in (6, 11, 25):
        out[f"rot_e_{r}"] = _rot_parts(e_in, r).reshape(nb, 64, 13)
    for r in (2, 13):
        out[f"rot_a_{r}"] = _rot_parts(a_in, r).reshape(nb, 64, 13)
    out["rnd_s1x"] = _chunks8(rnd["s1w_"].reshape(-1)).reshape(nb, 64, 8)
    out["rnd_chx"] = _chunks8(rnd["chw_"].reshape(-1)).reshape(nb, 64, 8)
    out["rnd_s0x"] = _chunks8(rnd["s0w_"].reshape(-1)).reshape(nb, 64, 8)
    out["rnd_majx"] = _chunks8(rnd["majw_"].reshape(-1)).reshape(nb, 64, 8)
    for k in ("s1w_", "chw_", "s0w_", "majw_"):
        out["rnd_" + k] = _from_chunks_parts(rnd[k].reshape(-1)) \
            .reshape(nb, 64, 3)
    out["rnd_tmp1"] = rnd["tmp1"]
    out["rnd_tmp1w"] = rnd["tmp1w"]
    out["rnd_te"] = rnd["te"]
    out["rnd_ta"] = rnd["ta"]
    out["rnd_e36"] = _range36_parts(rnd["te"].reshape(-1)).reshape(nb, 64, 12)
    out["rnd_a36"] = _range36_parts(rnd["ta"].reshape(-1)).reshape(nb, 64, 12)
    out["fin_t"] = fin_t
    out["fin_hi"] = fin_t >> _U(32)
    out["state_out"] = state_out
    out["state_dec"] = _dec_parts(state_out.reshape(-1)).reshape(nb, 8, 10)
    out["init_dec"] = _dec_parts(init_state.astype(_U))

    # digest bytes from the last block's state chunks (BE byte order)
    dchunks = out["state_dec"][-1, :, :8]  # (8 words, 8 chunks)
    dig = []
    for w in range(8):
        word_bytes = [(dchunks[w, 2 * i + 1] << _U(4)) | dchunks[w, 2 * i]
                      for i in range(4)]
        dig.extend(reversed(word_bytes))
    out["digest"] = np.asarray(dig, _U)

    # deferred 4-bit flush: inputs in fixed order, xor outputs as values
    flush = np.concatenate([out["sch_hi"].reshape(-1),
                            out["fin_hi"].reshape(-1),
                            out["state_dec"][:, :, :8].reshape(-1),
                            out["init_dec"][:, :8].reshape(-1)])
    pad = (-flush.shape[0]) % 3
    flush = np.concatenate([flush, np.zeros(pad, _U)])
    tri = flush.reshape(-1, 3)
    out["flush_x"] = tri[:, 0] ^ tri[:, 1] ^ tri[:, 2]
    # rc36 chunk self-checks (3 triples per instance, 9 chunks each)
    for k in ("sch_rc36", "rnd_e36", "rnd_a36"):
        ch = out[k][..., :9].reshape(-1, 9)
        out[k + "_x"] = ch[:, 0::3] ^ ch[:, 1::3] ^ ch[:, 2::3]
    return out


def _flatten_witness(wit: dict) -> np.ndarray:
    return np.concatenate([v.reshape(-1) for v in wit.values()])


# ---------------------------------------------------------------------------
# Device twin of _sha256_witness: the SAME witness values as one int64 tensor
# on the device, so repeated proving uploads only the input bytes instead of
# the witness columns (the device-side answer to the reference's
# take_witness_using_hints, src/cs/implementations/witness.rs:325). The
# schedule and the chained rounds are kernel K5; the decompositions that
# follow are elementwise torch ops on its (nb, 64) outputs.
# ---------------------------------------------------------------------------


def _t_ror(v, r):
    return ((v >> r) | (v << (32 - r))) & 0xFFFFFFFF


def _t_chunks8(v):
    return torch.stack([(v >> (4 * i)) & 0xF for i in range(8)], dim=-1)


def _t_rot_parts(v, rotation):
    m = rotation % 4
    low = v & ((1 << m) - 1)
    aligned = [(v >> (m + 4 * i)) & 0xF for i in range(7)]
    high = v >> (m + 28)
    t1 = low + (aligned[0] << m) + (aligned[1] << (m + 4)) \
        + (aligned[2] << (m + 8))
    t2 = t1 + (aligned[3] << (m + 12)) + (aligned[4] << (m + 16)) \
        + (aligned[5] << (m + 20))
    if m in (1, 2):
        skey = (high << m) | low
        srev = (low << (4 - m)) | high
    else:  # m == 3
        skey = (low << 1) | high
        srev = (high << 3) | low
    return torch.stack([low, *aligned, high, t1, t2, skey, srev], dim=-1)


def _t_from_chunks_parts(word):
    return torch.stack([word & 0xFFFF, word >> 16, word], dim=-1)


def _t_range36_parts(t):
    chunks = [(t >> (4 * i)) & 0xF for i in range(9)]
    u32 = t & 0xFFFFFFFF
    return torch.stack([*chunks, u32 & 0xFFFF, u32 >> 16, u32], dim=-1)


def _t_dec_parts(word):
    ch = [(word >> (4 * i)) & 0xF for i in range(8)]
    return torch.stack([*ch, word & 0xFFFF, word >> 16], dim=-1)


@functools.lru_cache(maxsize=None)
def _device_words(words: tuple, device) -> torch.Tensor:
    """A constant word vector on ``device``, uploaded once."""
    return torch.tensor(words, dtype=torch.int64).to(device)


def _sha256_witness_dev(vals: torch.Tensor, nb: int, init_state) -> torch.Tensor:
    """(nb·64,) int64 message bytes -> the flattened witness of
    `_sha256_witness`, in its order, as int64 values (the wide sums as full
    values lo + hi·2^32)."""
    from .sha256_witness import ROW, compress_chain

    init = _device_words(tuple(int(x) for x in init_state), vals.device)
    rows = compress_chain(vals.reshape(nb, 64), init)

    def wide(name, cols):
        return rows[ROW[name + "_lo"], :, :cols] \
            | (rows[ROW[name + "_hi"], :, :cols] << 32)

    out = {}
    w = rows[ROW["W"]]
    out["W"] = w
    out["sch_t"] = wide("sch", 48)
    x0 = w[:, 1:49].reshape(-1)
    x1 = w[:, 14:62].reshape(-1)
    for r in (7, 18):
        out[f"rot_x0_{r}"] = _t_rot_parts(x0, r).reshape(nb, 48, 13)
    for r in (17, 19, 10):
        out[f"rot_x1_{r}"] = _t_rot_parts(x1, r).reshape(nb, 48, 13)
    s0w = _t_ror(x0, 7) ^ _t_ror(x0, 18) ^ (x0 >> 3)
    s1w = _t_ror(x1, 17) ^ _t_ror(x1, 19) ^ (x1 >> 10)
    out["sch_s0x"] = _t_chunks8(s0w).reshape(nb, 48, 8)
    out["sch_s1x"] = _t_chunks8(s1w).reshape(nb, 48, 8)
    out["sch_s0w"] = _t_from_chunks_parts(s0w).reshape(nb, 48, 3)
    out["sch_s1w"] = _t_from_chunks_parts(s1w).reshape(nb, 48, 3)
    out["sch_hi"] = rows[ROW["sch_hi"], :, :46]
    out["sch_rc36"] = _t_range36_parts(out["sch_t"][:, 46:48].reshape(-1)) \
        .reshape(nb, 2, 12)

    state_in = rows[ROW["state_in"], :, :8]
    new_e, new_a = rows[ROW["new_e"]], rows[ROW["new_a"]]
    out["new_e"] = new_e
    out["new_a"] = new_a
    e_in = torch.cat([state_in[:, 4:5], new_e[:, :63]], dim=1).reshape(-1)
    a_in = torch.cat([state_in[:, 0:1], new_a[:, :63]], dim=1).reshape(-1)
    for r in (6, 11, 25):
        out[f"rot_e_{r}"] = _t_rot_parts(e_in, r).reshape(nb, 64, 13)
    for r in (2, 13):
        out[f"rot_a_{r}"] = _t_rot_parts(a_in, r).reshape(nb, 64, 13)
    words = {"s1w_": rows[ROW["s1"]], "chw_": rows[ROW["ch"]],
             "s0w_": rows[ROW["s0"]], "majw_": rows[ROW["maj"]]}
    out["rnd_s1x"] = _t_chunks8(words["s1w_"])
    out["rnd_chx"] = _t_chunks8(words["chw_"])
    out["rnd_s0x"] = _t_chunks8(words["s0w_"])
    out["rnd_majx"] = _t_chunks8(words["majw_"])
    for k, v in words.items():
        out["rnd_" + k] = _t_from_chunks_parts(v)
    for k in ("tmp1", "tmp1w", "te", "ta"):
        out["rnd_" + k] = wide(k, 64)
    out["rnd_e36"] = _t_range36_parts(out["rnd_te"])
    out["rnd_a36"] = _t_range36_parts(out["rnd_ta"])
    fin_t = wide("fin", 8)
    out["fin_t"] = fin_t
    out["fin_hi"] = rows[ROW["fin_hi"], :, :8]
    state_out = rows[ROW["fin_lo"], :, :8]
    out["state_out"] = state_out
    out["state_dec"] = _t_dec_parts(state_out)  # (nb, 8, 10)
    out["init_dec"] = _t_dec_parts(init)

    dchunks = out["state_dec"][-1, :, :8]  # (8 words, 8 chunks)
    # big-endian bytes of each word: byte i = chunk 2i+1 << 4 | chunk 2i
    word_bytes = (dchunks[:, 1::2] << 4) | dchunks[:, 0::2]  # (8, 4)
    out["digest"] = word_bytes.flip(1).reshape(-1)

    flush = torch.cat([out["sch_hi"].reshape(-1), out["fin_hi"].reshape(-1),
                       out["state_dec"][:, :, :8].reshape(-1),
                       out["init_dec"][:, :8].reshape(-1)])
    pad = (-flush.shape[0]) % 3
    if pad:
        flush = torch.cat([flush, flush.new_zeros(pad)])
    tri = flush.reshape(-1, 3)
    out["flush_x"] = tri[:, 0] ^ tri[:, 1] ^ tri[:, 2]
    for k in ("sch_rc36", "rnd_e36", "rnd_a36"):
        ch = out[k][..., :9].reshape(-1, 9)
        out[k + "_x"] = ch[:, 0::3] ^ ch[:, 1::3] ^ ch[:, 2::3]
    return torch.cat([v.reshape(-1) for v in out.values()])


def sha256(cs: ConstraintSystem, input_bytes_vars: np.ndarray,
           table_ids: dict) -> np.ndarray:
    """input_bytes_vars: (len,) byte variable handles (range-checked by the
    caller). Returns 32 byte variable handles of the digest.

    Reference behavior: sha256/mod.rs:35 (pad, per-block round function,
    digest recomposition); synthesis is the batched witness-first pipeline
    described above."""
    g = Sha256Gadget(cs, table_ids)
    msg = [int(v) for v in input_bytes_vars]
    length = len(msg)

    last = length % SHA256_BLOCK_SIZE
    num_zeros = (64 - 1 - 8 - last) if last <= 55 else (128 - 1 - 8 - last)
    msg.append(g.constant(0x80))
    msg.extend([g.constant(0x00)] * num_zeros)
    for byte in (length * 8).to_bytes(8, "big"):
        msg.append(g.constant(byte))
    assert len(msg) % SHA256_BLOCK_SIZE == 0
    nb = len(msg) // SHA256_BLOCK_SIZE
    msg_h = np.asarray(msg, np.uint64)

    init_state = np.asarray(INITIAL_STATE, _U)
    init_state_h = np.asarray([g.constant(x) for x in INITIAL_STATE], _U)

    # -- witness pass ---------------------------------------------------------
    byte_vals = cs.get_values(msg_h)
    wit = _sha256_witness(byte_vals.reshape(nb, 64), init_state)
    flat_vals = _flatten_witness(wit)
    all_h = cs.alloc_variables(flat_vals.shape[0])

    def witness_fn(vals):
        return _flatten_witness(_sha256_witness(
            np.asarray(vals, _U).reshape(nb, 64), init_state))

    def witness_fn_dev(vals):
        return _sha256_witness_dev(vals.reshape(-1), nb, init_state)

    witness_fn.device_twin = witness_fn_dev
    cs.set_values_with_dependencies(msg_h, all_h, witness_fn)

    # unpack handles with the witness layout
    h = {}
    off = 0
    for k, v in wit.items():
        h[k] = all_h[off:off + v.size].reshape(v.shape)
        off += v.size
    assert off == all_h.shape[0]

    _place_constraints(cs, g, h, msg_h, init_state_h, nb)
    return h["digest"]


def _enforce_rotation(cs, g, v_h, fam, rotation):
    """fam: (n, 13) part handles; returns (n, 8) rotated chunk handles and
    the (low, high) pieces (reference split_and_rotate, batched)."""
    m, k = rotation % 4, rotation // 4
    n = fam.shape[0]
    low, aligned, high = fam[:, 0], fam[:, 1:8], fam[:, 8]
    t1, t2, skey, srev = fam[:, 9], fam[:, 10], fam[:, 11], fam[:, 12]
    zero = g.constant(0)
    zeros = np.full(n, zero, _U)
    ReductionGate.enforce_reduce_batch(
        cs, [1, 1 << m, 1 << (m + 4), 1 << (m + 8)],
        np.stack([low, aligned[:, 0], aligned[:, 1], aligned[:, 2]]), t1)
    ReductionGate.enforce_reduce_batch(
        cs, [1, 1 << (m + 12), 1 << (m + 16), 1 << (m + 20)],
        np.stack([t1, aligned[:, 3], aligned[:, 4], aligned[:, 5]]), t2)
    ReductionGate.enforce_reduce_batch(
        cs, [1, 1 << (m + 24), 1 << (m + 28), 0],
        np.stack([t2, aligned[:, 6], high, zeros]), v_h)
    if m in (1, 2):
        cs.enforce_lookup_batch(g.t[f"split{m}"],
                                np.stack([skey, low, high, srev]))
        seam = srev
    else:
        cs.enforce_lookup_batch(g.t["split1"],
                                np.stack([skey, high, low, srev]))
        seam = skey
    rotated = np.concatenate(
        [aligned[:, k:7], seam[:, None], aligned[:, :k]], axis=1)
    return rotated, low, high


def _enforce_from_chunks(cs, g, chunks, fam3):
    """chunks: (n, 8); fam3: (n, 3) [low16, high16, word]."""
    one = g.constant(1)
    ones = np.full(fam3.shape[0], one, _U)
    ReductionGate.enforce_reduce_batch(cs, _C16, chunks[:, :4].T, fam3[:, 0])
    ReductionGate.enforce_reduce_batch(cs, _C16, chunks[:, 4:8].T, fam3[:, 1])
    FmaGate.enforce_fma_batch(cs, 1 << 16, (ones, fam3[:, 1]), 1,
                              fam3[:, 0], fam3[:, 2])


def _enforce_range36(cs, g, t_h, u32_h, fam12):
    """t == Σ chunk_i·16^i over 9 chunks; u32 part bound to u32_h.
    fam12: (n, 12) [chunk0..8, low16, high16, u32] (u32 slot == u32_h)."""
    one = g.constant(1)
    n = fam12.shape[0]
    ones = np.full(n, one, _U)
    chunks = fam12[:, :9]
    ReductionGate.enforce_reduce_batch(cs, _C16, chunks[:, :4].T, fam12[:, 9])
    ReductionGate.enforce_reduce_batch(cs, _C16, chunks[:, 4:8].T, fam12[:, 10])
    FmaGate.enforce_fma_batch(cs, 1 << 16, (ones, fam12[:, 10]), 1,
                              fam12[:, 9], u32_h)
    FmaGate.enforce_fma_batch(cs, 1 << 32, (ones, chunks[:, 8]), 1,
                              u32_h, t_h)


def _enforce_dec(cs, g, word_h, fam10):
    """word == Σ chunk_i·16^i over 8 chunks. fam10: (n, 10)."""
    one = g.constant(1)
    ones = np.full(fam10.shape[0], one, _U)
    ReductionGate.enforce_reduce_batch(cs, _C16, fam10[:, :4].T, fam10[:, 8])
    ReductionGate.enforce_reduce_batch(cs, _C16, fam10[:, 4:8].T, fam10[:, 9])
    FmaGate.enforce_fma_batch(cs, 1 << 16, (ones, fam10[:, 9]), 1,
                              fam10[:, 8], word_h)


def _place_constraints(cs, g, h, msg_h, init_state_h, nb):
    one = g.constant(1)
    zero = g.constant(0)
    W = h["W"]

    # message words from big-endian bytes
    be = msg_h.reshape(nb, 16, 4)
    ReductionGate.enforce_reduce_batch(
        cs, [1 << 24, 1 << 16, 1 << 8, 1],
        be.reshape(-1, 4).T, W[:, :16].reshape(-1))

    # -- message schedule -----------------------------------------------------
    x0 = W[:, 1:49].reshape(-1)
    x1 = W[:, 14:62].reshape(-1)
    rot7, _, rot7_hi = _enforce_rotation(cs, g, x0, h["rot_x0_7"].reshape(-1, 13), 7)
    rot18, _, _ = _enforce_rotation(cs, g, x0, h["rot_x0_18"].reshape(-1, 13), 18)
    shifted3 = np.concatenate(
        [rot7[:, 7:8], rot7[:, 0:6], rot7_hi[:, None]], axis=1)
    s0x = h["sch_s0x"].reshape(-1, 8)
    cs.enforce_lookup_batch(g.t["tri_xor"], np.stack([
        rot7.reshape(-1), rot18.reshape(-1), shifted3.reshape(-1),
        s0x.reshape(-1)]))

    rot17, _, _ = _enforce_rotation(cs, g, x1, h["rot_x1_17"].reshape(-1, 13), 17)
    rot19, _, _ = _enforce_rotation(cs, g, x1, h["rot_x1_19"].reshape(-1, 13), 19)
    rot10, _, rot10_hi = _enforce_rotation(cs, g, x1, h["rot_x1_10"].reshape(-1, 13), 10)
    n = rot10.shape[0]
    zeros = np.full((n, 1), zero, _U)
    shifted10 = np.concatenate(
        [rot10[:, 0:5], rot10_hi[:, None], zeros, zeros], axis=1)
    s1x = h["sch_s1x"].reshape(-1, 8)
    cs.enforce_lookup_batch(g.t["tri_xor"], np.stack([
        rot17.reshape(-1), rot19.reshape(-1), shifted10.reshape(-1),
        s1x.reshape(-1)]))

    _enforce_from_chunks(cs, g, s0x, h["sch_s0w"].reshape(-1, 3))
    _enforce_from_chunks(cs, g, s1x, h["sch_s1w"].reshape(-1, 3))

    # word sums: t = s0 + s1 + W[i-7] + W[i-16]
    ReductionGate.enforce_reduce_batch(
        cs, [1, 1, 1, 1],
        np.stack([h["sch_s0w"][:, :, 2].reshape(-1),
                  h["sch_s1w"][:, :, 2].reshape(-1),
                  W[:, 9:57].reshape(-1), W[:, 0:48].reshape(-1)]),
        h["sch_t"].reshape(-1))
    # split: W[idx] + 2^32·hi == t (idx 16..61), full 36-bit check for 62, 63
    ones46 = np.full(nb * 46, one, _U)
    FmaGate.enforce_fma_batch(
        cs, 1 << 32, (ones46, h["sch_hi"].reshape(-1)), 1,
        W[:, 16:62].reshape(-1), h["sch_t"][:, :46].reshape(-1))
    _enforce_range36(cs, g, h["sch_t"][:, 46:48].reshape(-1),
                     W[:, 62:64].reshape(-1), h["sch_rc36"].reshape(-1, 12))

    # -- rounds ---------------------------------------------------------------
    state_in = np.concatenate([init_state_h[None, :], h["state_out"][:-1]],
                              axis=0)  # (nb, 8)
    new_e, new_a = h["new_e"], h["new_a"]
    e_in = np.concatenate([state_in[:, 4:5], new_e[:, :63]], axis=1).reshape(-1)
    a_in = np.concatenate([state_in[:, 0:1], new_a[:, :63]], axis=1).reshape(-1)

    e6, _, _ = _enforce_rotation(cs, g, e_in, h["rot_e_6"].reshape(-1, 13), 6)
    e11, _, _ = _enforce_rotation(cs, g, e_in, h["rot_e_11"].reshape(-1, 13), 11)
    e25, _, _ = _enforce_rotation(cs, g, e_in, h["rot_e_25"].reshape(-1, 13), 25)
    s1x = h["rnd_s1x"].reshape(-1, 8)
    cs.enforce_lookup_batch(g.t["tri_xor"], np.stack([
        e6.reshape(-1), e11.reshape(-1), e25.reshape(-1), s1x.reshape(-1)]))

    a2, _, _ = _enforce_rotation(cs, g, a_in, h["rot_a_2"].reshape(-1, 13), 2)
    a13, _, _ = _enforce_rotation(cs, g, a_in, h["rot_a_13"].reshape(-1, 13), 13)
    a22 = np.concatenate([a2[:, 5:8], a2[:, 0:5]], axis=1)  # roll by 5
    s0x = h["rnd_s0x"].reshape(-1, 8)
    cs.enforce_lookup_batch(g.t["tri_xor"], np.stack([
        a2.reshape(-1), a13.reshape(-1), a22.reshape(-1), s0x.reshape(-1)]))

    # e/f/g and a/b/c chunk sequences (init decs + range36 chunks)
    state_in_dec = np.concatenate(
        [h["init_dec"][None, :, :8], h["state_dec"][:-1, :, :8]], axis=0)
    e_seq = np.concatenate([state_in_dec[:, 6:7], state_in_dec[:, 5:6],
                            state_in_dec[:, 4:5],
                            h["rnd_e36"][:, :63, :8]], axis=1)  # (nb, 66, 8)
    a_seq = np.concatenate([state_in_dec[:, 2:3], state_in_dec[:, 1:2],
                            state_in_dec[:, 0:1],
                            h["rnd_a36"][:, :63, :8]], axis=1)
    # ch(e,f,g) at round r: e=seq[r+2], f=seq[r+1], g=seq[r]
    chx = h["rnd_chx"].reshape(-1)
    cs.enforce_lookup_batch(g.t["ch"], np.stack([
        e_seq[:, 2:66].reshape(-1), e_seq[:, 1:65].reshape(-1),
        e_seq[:, 0:64].reshape(-1), chx]))
    majx = h["rnd_majx"].reshape(-1)
    cs.enforce_lookup_batch(g.t["maj"], np.stack([
        a_seq[:, 2:66].reshape(-1), a_seq[:, 1:65].reshape(-1),
        a_seq[:, 0:64].reshape(-1), majx]))

    for k in ("rnd_s1w_", "rnd_chw_", "rnd_s0w_", "rnd_majw_"):
        xk = "rnd_" + k[4:-2] + "x"
        _enforce_from_chunks(cs, g, h[xk].reshape(-1, 8),
                             h[k].reshape(-1, 3))

    # tmp1 = h + s1 + ch + K[r]
    rc_h = np.asarray([g.constant(x) for x in ROUND_CONSTANTS], _U)
    e_words = np.concatenate(  # e-lineage: e_{-3}..e_{63}
        [state_in[:, 7:8], state_in[:, 6:7], state_in[:, 5:6],
         state_in[:, 4:5], new_e[:, :63]], axis=1)  # (nb, 67)
    a_words = np.concatenate(
        [state_in[:, 3:4], state_in[:, 2:3], state_in[:, 1:2],
         state_in[:, 0:1], new_a[:, :63]], axis=1)
    h_r = e_words[:, 0:64].reshape(-1)
    d_r = a_words[:, 0:64].reshape(-1)
    ReductionGate.enforce_reduce_batch(
        cs, [1, 1, 1, 1],
        np.stack([h_r, h["rnd_s1w_"][:, :, 2].reshape(-1),
                  h["rnd_chw_"][:, :, 2].reshape(-1),
                  np.tile(rc_h, nb)]),
        h["rnd_tmp1"].reshape(-1))
    nr = nb * 64
    ones_r = np.full(nr, one, _U)
    FmaGate.enforce_fma_batch(cs, 1, (ones_r, h["rnd_tmp1"].reshape(-1)), 1,
                              W.reshape(-1), h["rnd_tmp1w"].reshape(-1))
    FmaGate.enforce_fma_batch(cs, 1, (ones_r, h["rnd_tmp1w"].reshape(-1)), 1,
                              d_r, h["rnd_te"].reshape(-1))
    _enforce_range36(cs, g, h["rnd_te"].reshape(-1), new_e.reshape(-1),
                     h["rnd_e36"].reshape(-1, 12))
    zeros_r = np.full(nr, zero, _U)
    ReductionGate.enforce_reduce_batch(
        cs, [1, 1, 1, 0],
        np.stack([h["rnd_s0w_"][:, :, 2].reshape(-1),
                  h["rnd_majw_"][:, :, 2].reshape(-1),
                  h["rnd_tmp1w"].reshape(-1), zeros_r]),
        h["rnd_ta"].reshape(-1))
    _enforce_range36(cs, g, h["rnd_ta"].reshape(-1), new_a.reshape(-1),
                     h["rnd_a36"].reshape(-1, 12))

    # -- chaining -------------------------------------------------------------
    fin = np.stack([new_a[:, 63], new_a[:, 62], new_a[:, 61], new_a[:, 60],
                    new_e[:, 63], new_e[:, 62], new_e[:, 61], new_e[:, 60]],
                   axis=1)  # (nb, 8) final a..h
    ones_f = np.full(nb * 8, one, _U)
    FmaGate.enforce_fma_batch(cs, 1, (ones_f, state_in.reshape(-1)), 1,
                              fin.reshape(-1), h["fin_t"].reshape(-1))
    FmaGate.enforce_fma_batch(cs, 1 << 32, (ones_f, h["fin_hi"].reshape(-1)),
                              1, h["state_out"].reshape(-1),
                              h["fin_t"].reshape(-1))
    _enforce_dec(cs, g, h["state_out"].reshape(-1),
                 h["state_dec"].reshape(-1, 10))
    _enforce_dec(cs, g, init_state_h, h["init_dec"])

    # digest bytes: byte = chunk_lo + 16·chunk_hi (BE order within words)
    dchunks = h["state_dec"][-1, :, :8]
    lo = np.stack([dchunks[w, 2 * i] for w in range(8) for i in (3, 2, 1, 0)])
    hi = np.stack([dchunks[w, 2 * i + 1] for w in range(8)
                   for i in (3, 2, 1, 0)])
    ones_d = np.full(32, one, _U)
    FmaGate.enforce_fma_batch(cs, 1 << 4, (ones_d, hi), 1, lo, h["digest"])

    # -- deferred 4-bit flush -------------------------------------------------
    flush = np.concatenate([h["sch_hi"].reshape(-1),
                            h["fin_hi"].reshape(-1),
                            h["state_dec"][:, :, :8].reshape(-1),
                            h["init_dec"][:, :8].reshape(-1)])
    pad = (-flush.shape[0]) % 3
    flush = np.concatenate([flush, np.full(pad, zero, _U)])
    tri = flush.reshape(-1, 3)
    cs.enforce_lookup_batch(g.t["tri_xor"], np.stack(
        [tri[:, 0], tri[:, 1], tri[:, 2], h["flush_x"]]))
    for k in ("sch_rc36", "rnd_e36", "rnd_a36"):
        ch = h[k][..., :9].reshape(-1, 9)
        xs = h[k + "_x"].reshape(-1, 3)
        cs.enforce_lookup_batch(g.t["tri_xor"], np.stack([
            ch[:, 0::3].reshape(-1), ch[:, 1::3].reshape(-1),
            ch[:, 2::3].reshape(-1), xs.reshape(-1)]))


def build_sha256_circuit(input_bytes: bytes, max_trace_len=1 << 14):
    """The flagship circuit: SHA-256 of ``input_bytes`` with 60 copy columns,
    4 constant columns and width-4 specialized lookups in 8 repetitions
    (copied from tests/test_sha256.py:build_sha256_circuit). Returns the
    constraint system and the 32 digest byte variables."""
    from ..cs import ConstraintSystem, CSConfig, CSGeometry, LookupParameters
    from ..cs.gates import NopGate
    from .uints import allocate_u8_checked_batch

    geometry = CSGeometry(num_columns_under_copy_permutation=60,
                          num_witness_columns=0, num_constant_columns=4,
                          max_allowed_constraint_degree=4)
    lookup = LookupParameters.specialized_with_table_id_as_constant(
        width=4, num_repetitions=8, share_table_id=True)
    cs = ConstraintSystem(geometry, max_trace_len, CSConfig.dev())
    cs.allow_lookup(lookup)
    cs.allow_gate(ConstantsAllocatorGate)
    cs.allow_gate(FmaGate)
    cs.allow_gate(ReductionGate, params=4)
    cs.allow_gate(NopGate)
    tids = add_sha256_tables(cs)
    in_vars = allocate_u8_checked_batch(
        cs, np.frombuffer(input_bytes, np.uint8).astype(np.uint64), tids)
    out_vars = sha256(cs, in_vars, tids)
    cs.input_variables = in_vars
    return cs, out_vars
