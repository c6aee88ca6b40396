"""The SHA-256 compression chain of the device witness, kernel K5.

`compress_chain` computes, for nb message blocks chained from an initial
state, every value of the message schedule and of the 64 rounds of each block
that the SHA-256 circuit's witness holds: one launch of the Hopper kernel
``csrc/sha256_witness.cu`` on a CUDA tensor, its plain torch version
`compress_chain_plain` on a CPU tensor. It replaces the two ``lax.scan``s of
`boojum_tpu/gadgets/sha256.py:_sha256_witness_dev` (the schedule and the
round/block scans), which XLA compiles into one loop each; in eager torch the
8,256 dependent rounds of the flagship would be about 370,000 launches.

Values are u32 words in int64. The wide sums (schedule t, tmp1, tmp1w, te,
ta and the final state additions, all < 2^36) are returned as (lo, hi) with
lo = sum mod 2^32 and hi = sum >> 32: the exact carries of the JAX
`add_pairs` / `pair_add`. The result is one (ROWS, nb, 64) int64 tensor whose
rows are named by `ROW`; rows that hold fewer than 64 values per block (the
48 schedule sums, the 8 state words) leave the rest zero.
"""

from __future__ import annotations

import torch

from .sha256 import ROUND_CONSTANTS

# launches of the kernel, and calls of the plain version on a CUDA tensor
LAUNCHES = 0
PLAIN_CUDA_CALLS = 0

# output rows; the kernel writes the same layout (csrc/sha256_witness.cu)
ROW = {name: i for i, name in enumerate((
    "W", "sch_lo", "sch_hi", "s1", "ch", "s0", "maj", "tmp1_lo", "tmp1_hi",
    "tmp1w_lo", "tmp1w_hi", "te_lo", "te_hi", "ta_lo", "ta_hi", "new_e",
    "new_a", "state_in", "fin_lo", "fin_hi"))}
ROWS = len(ROW)

_M32 = 0xFFFFFFFF


def _ror(v, r):
    return ((v >> r) | (v << (32 - r))) & _M32


def _count_plain(t: torch.Tensor):
    global PLAIN_CUDA_CALLS
    if t.is_cuda:
        PLAIN_CUDA_CALLS += 1


def compress_chain_plain(blocks: torch.Tensor, init: torch.Tensor
                         ) -> torch.Tensor:
    """The plain torch version of ``sha256_witness``: the schedule vectorized
    over blocks, then the rounds one by one on 0-dim tensors."""
    _count_plain(blocks)
    nb = blocks.shape[0]
    be = blocks.reshape(nb, 16, 4)
    ws = [((be[:, i, 0] << 24) | (be[:, i, 1] << 16) | (be[:, i, 2] << 8)
           | be[:, i, 3]) & _M32 for i in range(16)]
    sch = []
    for i in range(16, 64):
        x0, x1 = ws[i - 15], ws[i - 2]
        s0 = _ror(x0, 7) ^ _ror(x0, 18) ^ (x0 >> 3)
        s1 = _ror(x1, 17) ^ _ror(x1, 19) ^ (x1 >> 10)
        t = s0 + s1 + ws[i - 7] + ws[i - 16]
        sch.append(t)
        ws.append(t & _M32)
    w = torch.stack(ws, dim=1)  # (nb, 64)
    sch_t = torch.stack(sch, dim=1)  # (nb, 48)

    names = ("s1", "ch", "s0", "maj", "tmp1", "tmp1w", "te", "ta")
    per_round = {k: [] for k in names}
    state_in, fin = [], []
    cur = [init[i] for i in range(8)]
    for b in range(nb):
        state_in.append(torch.stack(cur))
        a, bb, c, d, e, f, g, h = cur
        for r in range(64):
            s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
            ch = (e & f) ^ ((~e & _M32) & g)
            tmp1 = h + s1 + ch + ROUND_CONSTANTS[r]
            tmp1w = tmp1 + w[b, r]
            te = tmp1w + d
            s0 = _ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22)
            maj = (a & bb) ^ (a & c) ^ (bb & c)
            ta = s0 + maj + tmp1w
            for k, v in zip(names, (s1, ch, s0, maj, tmp1, tmp1w, te, ta)):
                per_round[k].append(v)
            h, g, f, e = g, f, e, te & _M32
            d, c, bb, a = c, bb, a, ta & _M32
        fin.append(state_in[-1] + torch.stack([a, bb, c, d, e, f, g, h]))
        cur = [fin[-1][i] & _M32 for i in range(8)]

    out = blocks.new_zeros((ROWS, nb, 64))
    out[ROW["W"]] = w
    out[ROW["sch_lo"], :, :48] = sch_t & _M32
    out[ROW["sch_hi"], :, :48] = sch_t >> 32
    for k in names:
        v = torch.stack(per_round[k]).reshape(nb, 64)
        if k in ("s1", "ch", "s0", "maj"):
            out[ROW[k]] = v
        else:
            out[ROW[k + "_lo"]] = v & _M32
            out[ROW[k + "_hi"]] = v >> 32
    out[ROW["new_e"]] = out[ROW["te_lo"]]
    out[ROW["new_a"]] = out[ROW["ta_lo"]]
    out[ROW["state_in"], :, :8] = torch.stack(state_in)
    fin_t = torch.stack(fin)
    out[ROW["fin_lo"], :, :8] = fin_t & _M32
    out[ROW["fin_hi"], :, :8] = fin_t >> 32
    return out


def _check(blocks: torch.Tensor, init: torch.Tensor):
    if blocks.dtype != torch.int64 or blocks.dim() != 2 or \
            blocks.shape[1] != 64 or blocks.shape[0] < 1:
        raise TypeError("sha256_witness wants (nb >= 1, 64) int64 message "
                        "bytes, got %s %s" % (blocks.dtype, tuple(blocks.shape)))
    if init.dtype != torch.int64 or tuple(init.shape) != (8,):
        raise TypeError("sha256_witness wants an (8,) int64 initial state, "
                        "got %s %s" % (init.dtype, tuple(init.shape)))
    if init.device != blocks.device:
        raise ValueError("blocks and initial state lie on %s and %s"
                         % (blocks.device, init.device))
    if blocks.device.type not in ("cpu", "cuda"):
        raise RuntimeError("sha256_witness has no kernel for device %s"
                           % blocks.device)


def compress_chain(blocks: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """(nb, 64) message bytes and the (8,) initial state -> the
    (ROWS, nb, 64) schedule and round values of the chained compression."""
    global LAUNCHES
    _check(blocks, init)
    if blocks.device.type == "cpu":
        return compress_chain_plain(blocks, init)
    from ..utils import cuda_build

    lib = cuda_build.load("sha256_witness")
    blocks = blocks.contiguous()
    init = init.contiguous()
    nb = blocks.shape[0]
    out = blocks.new_empty((ROWS, nb, 64))
    rc = lib.sha256_witness(blocks.data_ptr(), init.data_ptr(),
                            out.data_ptr(), nb,
                            cuda_build.stream_handle(blocks))
    cuda_build.check(rc, "sha256_witness")
    LAUNCHES += 1
    return out
