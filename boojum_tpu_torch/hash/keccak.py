# Port of boojum_tpu/hash/keccak.py (the permutation on a flat 25-lane
# state, its theta folded into rho and pi).
"""Keccak-256 (legacy 0x01 padding, pre-NIST) — host-side.

Reference behavior: the ``sha3::Keccak256`` tree hasher / transcript
(src/cs/oracle/mod.rs:247, src/cs/implementations/transcript.rs:264) — note
this is Ethereum-style Keccak-256, NOT NIST SHA3-256 (different padding), so
hashlib.sha3_256 cannot be used. Used only for alternative transcript/tree
configs; never on the device hot path.
"""

from __future__ import annotations

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK = (1 << 64) - 1


# rho and pi as one table on the flat state a[x + 5y] = lanes[x][y]:
# (source, destination, rotation), b[y][(2x + 3y) % 5] = rol(a[x][y], r)
_RHO_PI = tuple((x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5), _ROT[x][y])
                for x in range(5) for y in range(5))


def _f1600_flat(a):
    """Keccak-f[1600] in place on the flat 25-lane state a[x + 5y]."""
    b = [0] * 25
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[x - 1] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63))
                         & _MASK) for x in range(5)]
        # rho + pi
        for src, dst, r in _RHO_PI:
            v = a[src] ^ d[src % 5]
            b[dst] = ((v << r) | (v >> (64 - r))) & _MASK if r else v
        # chi
        for y in range(0, 25, 5):
            b0, b1, b2, b3, b4 = b[y:y + 5]
            a[y] = b0 ^ (~b1 & b2)
            a[y + 1] = b1 ^ (~b2 & b3)
            a[y + 2] = b2 ^ (~b3 & b4)
            a[y + 3] = b3 ^ (~b4 & b0)
            a[y + 4] = b4 ^ (~b0 & b1)
        # iota
        a[0] ^= rc
    return a


def keccak_f1600(lanes):
    """lanes: 5x5 list of 64-bit ints, lanes[x][y]."""
    a = _f1600_flat([lanes[i % 5][i // 5] for i in range(25)])
    for i in range(25):
        lanes[i % 5][i // 5] = a[i]
    return lanes


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for 256-bit output
    # legacy multi-rate padding with 0x01 domain byte
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    a = [0] * 25  # a[x + 5y] = lanes[x][y]: lane i of a block at a[i]
    for off in range(0, len(padded), rate):
        for i in range(rate // 8):
            a[i] ^= int.from_bytes(padded[off + 8 * i:off + 8 * i + 8],
                                   "little")
        _f1600_flat(a)
    return b"".join(a[i].to_bytes(8, "little") for i in range(4))
