# Copied from boojum_tpu/gadgets/blake2s.py.
"""Blake2s circuit gadget.

Reference behavior: src/gadgets/blake2s/mod.rs (10 rounds, 64-byte blocks,
sequential-mode single-depth hashing with the IV-0 twist for 32-byte
digests). Uses the same 4-bit table budget as the sha256 circuit: XOR via
TriXor4 lookups (third input zero), rotations by 16/12/8 are chunk-aligned
rolls, rotation by 7 uses the Split4BitChunk seam trick, mod-2^32 additions
are free-width field sums reduced through 34-bit decomposition.
"""

from __future__ import annotations

import numpy as np

from ..cs.cs import ConstraintSystem
from ..cs.gates import ConstantsAllocatorGate, FmaGate, ReductionGate
from .sha256 import Sha256Gadget, add_sha256_tables  # shared chunk machinery

BLAKE2S_ROUNDS = 10
BLOCK_SIZE = 64
DIGEST_SIZE = 32

IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
IV_0_TWIST = 0x6A09E667 ^ 0x01010000 ^ 32

SIGMAS = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


class _B2s:
    """Word state kept in both u32-variable and 8x4-bit-chunk form lazily."""

    def __init__(self, g: Sha256Gadget):
        self.g = g
        self.zero = g.constant(0)

    def xor_chunks(self, a_chunks, b_chunks):
        zeros = np.full(8, self.zero, np.uint64)
        return self.g._tri_xor_batch(np.asarray(a_chunks, np.uint64),
                                     np.asarray(b_chunks, np.uint64), zeros)

    def rot_chunks(self, chunks, rotation: int):
        """Right-rotate a chunked u32. 16/12/8 are chunk-aligned; 7 needs
        re-splitting (handled at the word level by split_and_rotate)."""
        assert rotation % 4 == 0
        return np.roll(np.asarray(chunks, np.uint64), -(rotation // 4))

    def add3(self, a_var, b_var, x_var):
        """(a + b + x) mod 2^32: free-width sum then 34-bit split; the high
        part (< 4) rides the deferred range-check buffer."""
        g = self.g
        t = ReductionGate.reduce_terms(g.cs, [1, 1, 1, 0],
                                       [a_var, b_var, x_var, self.zero])
        u32_part, high = g.split_36_unchecked(t)
        self.pending.append(high)
        return u32_part

    def add2(self, a_var, b_var):
        g = self.g
        one = g.constant(1)
        t = FmaGate.compute_fma(g.cs, 1, (one, a_var), 1, b_var)
        u32_part, high = g.split_36_unchecked(t)
        self.pending.append(high)
        return u32_part


def blake2s(cs: ConstraintSystem, input_bytes_vars: np.ndarray,
            table_ids: dict) -> np.ndarray:
    """Single-depth blake2s-256 of the input bytes; returns 32 byte vars.

    Mirrors reference blake2s/mod.rs:35 (sequential mode, final block flag)."""
    g = Sha256Gadget(cs, table_ids)
    st = _B2s(g)
    st.pending = []

    msg = [int(v) for v in input_bytes_vars]
    length = len(msg)
    # zero-pad to block multiple (blake2s pads with zeros, no length suffix)
    while len(msg) % BLOCK_SIZE != 0 or len(msg) == 0:
        msg.append(g.constant(0x00))

    h = [g.constant(IV_0_TWIST if i == 0 else IV[i]) for i in range(8)]
    num_blocks = len(msg) // BLOCK_SIZE

    for blk in range(num_blocks):
        block = msg[blk * BLOCK_SIZE:(blk + 1) * BLOCK_SIZE]
        # little-endian u32 words
        m = []
        for i in range(16):
            b0, b1, b2, b3 = block[4 * i:4 * i + 4]
            m.append(ReductionGate.reduce_terms(
                cs, [1, 1 << 8, 1 << 16, 1 << 24], [b0, b1, b2, b3]))
        is_last = blk == num_blocks - 1
        t_counter = min((blk + 1) * BLOCK_SIZE, length)
        v = list(h) + [g.constant(IV[i]) for i in range(8)]
        # v[12] ^= t (low counter word); constants — fold on host
        v[12] = g.constant(IV[4] ^ t_counter)
        if is_last:
            v[14] = g.constant(IV[6] ^ 0xFFFFFFFF)

        def G(a, b, c, d, x, y):
            v[a] = st.add3(v[a], v[b], x)
            # v[d] = (v[d] ^ v[a]) >>> 16
            d_c = g.uint32_into_4bit_chunks(v[d])
            a_c = g.uint32_into_4bit_chunks(v[a])
            xd = st.xor_chunks(d_c, a_c)
            v[d] = g.uint32_from_4bit_chunks(st.rot_chunks(xd, 16))
            v[c] = st.add2(v[c], v[d])
            b_c = g.uint32_into_4bit_chunks(v[b])
            c_c = g.uint32_into_4bit_chunks(v[c])
            xb = st.xor_chunks(b_c, c_c)
            v[b] = g.uint32_from_4bit_chunks(st.rot_chunks(xb, 12))
            v[a] = st.add3(v[a], v[b], y)
            d_c = g.uint32_into_4bit_chunks(v[d])
            a_c = g.uint32_into_4bit_chunks(v[a])
            xd = st.xor_chunks(d_c, a_c)
            v[d] = g.uint32_from_4bit_chunks(st.rot_chunks(xd, 8))
            v[c] = st.add2(v[c], v[d])
            b_c = g.uint32_into_4bit_chunks(v[b])
            c_c = g.uint32_into_4bit_chunks(v[c])
            xb = st.xor_chunks(b_c, c_c)
            # rotate right by 7: xor result recomposed, then seam rotation
            xb_word = g.uint32_from_4bit_chunks(xb)
            rot7, _, _ = g.split_and_rotate(xb_word, 7)
            v[b] = g.uint32_from_4bit_chunks(rot7)

        for rnd in range(BLAKE2S_ROUNDS):
            s = SIGMAS[rnd]
            G(0, 4, 8, 12, m[s[0]], m[s[1]])
            G(1, 5, 9, 13, m[s[2]], m[s[3]])
            G(2, 6, 10, 14, m[s[4]], m[s[5]])
            G(3, 7, 11, 15, m[s[6]], m[s[7]])
            G(0, 5, 10, 15, m[s[8]], m[s[9]])
            G(1, 6, 11, 12, m[s[10]], m[s[11]])
            G(2, 7, 8, 13, m[s[12]], m[s[13]])
            G(3, 4, 9, 14, m[s[14]], m[s[15]])

        # h = h ^ v[0..8] ^ v[8..16]
        new_h = []
        for i in range(8):
            hc = g.uint32_into_4bit_chunks(h[i])
            vc = g.uint32_into_4bit_chunks(v[i])
            wc = g.uint32_into_4bit_chunks(v[8 + i])
            x = g._tri_xor_batch(hc, vc, wc)
            new_h.append(g.uint32_from_4bit_chunks(x))
        h = new_h

    g.range_check_chunks(st.pending)
    st.pending = []

    # digest: little-endian bytes of h
    out = []
    one = g.constant(1)
    for i in range(8):
        chunks = g.uint32_into_4bit_chunks(h[i])
        # range-check the output chunks (they feed nothing else)
        g.range_check_chunks([int(x) for x in chunks])
        for j in range(4):
            lo, hi = int(chunks[2 * j]), int(chunks[2 * j + 1])
            out.append(FmaGate.compute_fma(cs, 1 << 4, (one, hi), 1, lo))
    return np.asarray(out, np.uint64)
