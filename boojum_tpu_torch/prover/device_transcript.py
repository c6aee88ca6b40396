# Port of boojum_tpu/prover/device_transcript.py to torch tensors.
"""Device-resident Fiat-Shamir transcript (algebraic sponge over Goldilocks).

Reference behavior: src/cs/implementations/transcript.rs
``AlgebraicSpongeBasedTranscript`` (:48), exactly the semantics of
`transcript.AlgebraicTranscript`, but the sponge state, the absorbed
elements and the drawn challenges are tensors on the prover's device, so a
challenge never waits for a value to cross to the host. The host syncs once,
at `handoff_to_host`, which fetches the state and the pending pieces and
continues in the host transcript (query-index derivation is host work).

Absorbed data waits in a list of tagged pieces; a challenge after new data
flushes them: the pieces are linearized into one element tensor (torch
views and copies on the device) and absorbed by ONE launch of the Poseidon
sponge kernel (`hash.poseidon.sponge_absorb`), which pads and permutes every
rate block. A squeeze past the rate is one `sponge_permute` launch. The
Poseidon2 transcript kind runs its permutation through
`hash.pallas_poseidon2.permutation_stacked_fast` instead, one launch per
block.

Ext challenges are (2,) int64 tensors [c0, c1] on the device (the JAX
(2, 2) u32 limb layout, as u64 bit patterns). The prover prepares each one
as it is drawn (`prepare_ext`), and each power table at once
(`ext2.prepare`), so the stages multiply by them at the op count of host
ints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import extension as ext2
from ..field import goldilocks as gl
from ..field.goldilocks import ORDER
from ..hash import poseidon
from ..hash.sponge import RATE, STATE_WIDTH
from .device import upload

# buffer piece tags: how a piece linearizes into absorbed field elements
#   flat: (k,) elements, in order
#   capT: (4, c) cap layer, node-major (the transpose, flattened)
#   ilv:  two (k,) component tensors interleaved v0.c0, v0.c1, v1.c0, ...
FLAT, CAPT, ILV = "flat", "capT", "ilv"


def _linearize(pieces) -> torch.Tensor:
    """Tagged pieces -> the (k,) element stream they absorb as."""
    parts = []
    for piece in pieces:
        tag = piece[0]
        if tag == FLAT:
            parts.append(piece[1].reshape(-1))
        elif tag == CAPT:
            parts.append(piece[1].T.reshape(-1))
        else:  # ILV
            parts.append(torch.stack([piece[1], piece[2]], dim=1).reshape(-1))
    return torch.cat(parts)


def _p2_absorb(state, elements):
    from ..hash import pallas_poseidon2 as pp
    st = state[:, None]
    for blk in poseidon.pad_blocks(elements):
        st = pp.permutation_stacked_fast(torch.cat([blk[:, None], st[RATE:]]))
    return st[:, 0]


def _p2_permute(state):
    from ..hash import pallas_poseidon2 as pp
    return pp.permutation_stacked_fast(state[:, None])[:, 0]


_SPONGES = {"poseidon": (poseidon.sponge_absorb, poseidon.sponge_permute),
            "poseidon2": (_p2_absorb, _p2_permute)}


class DeviceTranscript:
    """Mirror of transcript.AlgebraicTranscript with its state on
    ``device``: the GPU unless the caller passes another."""

    IS_ALGEBRAIC = True
    IS_DEVICE = True

    def __init__(self, kind: str = "poseidon", device="cuda"):
        if kind not in _SPONGES:
            raise ValueError("no device transcript of kind %r" % kind)
        self.kind = kind
        self.device = torch.device(device)
        self._absorb, self._permute = _SPONGES[kind]
        self.state = torch.zeros(STATE_WIDTH, dtype=torch.int64,
                                 device=self.device)
        self.buffer: list = []  # tagged pieces
        self.buflen = 0
        self.avail_pos = RATE  # RATE = none available

    # -- absorb paths ------------------------------------------------------

    def witness_field_elements_dev(self, els: torch.Tensor):
        """Absorb a (k,) tensor of CANONICAL elements on the device."""
        assert els.dim() == 1
        self.buffer.append((FLAT, els))
        self.buflen += int(els.shape[0])

    def witness_field_elements(self, els):
        """Host-int absorb (public inputs, the setup cap): uploaded without
        a sync."""
        els = [int(e) % ORDER for e in els]
        if els:
            self.witness_field_elements_dev(
                upload(np.asarray(els, np.uint64), self.device))

    def witness_merkle_tree_cap_dev(self, cap: torch.Tensor):
        """Absorb a device (4, cap_size) cap layer in the host order
        (node-major)."""
        self.buffer.append((CAPT, cap))
        self.buflen += int(cap.numel())

    def witness_merkle_tree_cap(self, cap):
        """Absorb a host cap (a list of 4-tuples of ints), node-major."""
        self.witness_field_elements([v for el in cap for v in el])

    def absorb_interleaved_dev(self, c0: torch.Tensor, c1: torch.Tensor):
        """Absorb ext values as v0.c0, v0.c1, v1.c0, ... (the evals-at-z
        absorb order) from their two component tensors."""
        self.buffer.append((ILV, c0, c1))
        self.buflen += 2 * int(c0.shape[0])

    # -- challenge paths -----------------------------------------------------

    def _flush(self):
        self.state = self._absorb(self.state, _linearize(self.buffer))
        self.buffer = []
        self.buflen = 0
        self.avail_pos = 0

    def get_ext_challenge(self) -> torch.Tensor:
        """Two consecutive base challenges -> (2,) int64 device tensor."""
        if self.buflen:
            self._flush()
        if self.avail_pos >= RATE:
            self.state = self._permute(self.state)
            self.avail_pos = 0
        if self.avail_pos <= RATE - 2:
            out = self.state[self.avail_pos:self.avail_pos + 2]
            self.avail_pos += 2
            return out
        # one challenge left in this squeeze: cross the permutation
        c0 = self.state[RATE - 1:RATE]
        self.state = self._permute(self.state)
        self.avail_pos = 1
        return torch.cat([c0, self.state[:1]])

    # -- handoff -------------------------------------------------------------

    def handoff_to_host(self, extra=()):
        """ONE device fetch -> an exact host AlgebraicTranscript continuing
        from this point, and the host u64 copies of the ``extra`` tensors,
        fetched in the same transfer."""
        from ..transcript import AlgebraicTranscript

        pending = _linearize(self.buffer) if self.buflen else \
            self.state.new_zeros(0)
        parts = [self.state, pending] + [t.reshape(-1) for t in extra]
        host = gl.to_u64(torch.cat(parts))
        st, host = host[:STATE_WIDTH], host[STATE_WIDTH:]
        buf, host = host[:pending.shape[0]], host[pending.shape[0]:]
        out = AlgebraicTranscript(self.kind)
        out.state = [int(x) for x in st]
        out.buffer = [int(x) for x in buf]
        out.available = [int(x) for x in st[self.avail_pos:RATE]]
        fetched = []
        for t in extra:
            fetched.append(host[:t.numel()].reshape(tuple(t.shape)))
            host = host[t.numel():]
        return out, fetched


# ---------------------------------------------------------------------------
# Ext-scalar helpers on (2,) device tensors
# ---------------------------------------------------------------------------


def _pair(a):
    return (a[..., 0], a[..., 1])


def prepare_ext(ch: torch.Tensor) -> ext2.PreparedExt:
    """A (2,) ext challenge, split once for the stages' multiplies (a
    table of them: `ext2.prepare`, one pass for all rows)."""
    return ext2.prepare(ch)[0]


def ext_mul_dev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Ext product of (..., 2) tensors."""
    return torch.stack(ext2.mul(_pair(a), _pair(b)), dim=-1)


def ext_pow_table_dev(ch, count: int) -> torch.Tensor:
    """Ext challenge ((2,) tensor or `PreparedExt`) -> (count, 2) powers
    [1, c, c^2, ...], by doubling (`ext2.powers`: one vectorized ext
    multiply per doubling)."""
    return torch.stack(ext2.powers(ch, count, ch.device), dim=1)


def ext_pow_list(ch, count: int) -> list:
    """[1, c, .., c^(count-1)] of an ext challenge: for a device one
    ((2,) tensor or `PreparedExt`) the prepared rows of one device table
    (`ext_pow_table_dev`), for a host pair host pairs."""
    if isinstance(ch, (ext2.PreparedExt, torch.Tensor)):
        return ext2.prepare(ext_pow_table_dev(ch, count))
    pows = [(1, 0)]
    for _ in range(count - 1):
        pows.append(ext2.s2_mul(pows[-1], ch))
    return pows


def sq_chain_dev(ch: torch.Tensor, k: int) -> torch.Tensor:
    """(2,) ext challenge -> (k, 2) squaring chain [c, c^2, c^4, ...] (the
    per-FRI-round fold-challenge table), written row by row into one
    table."""
    out = ch.new_empty((k, 2))
    out[0] = ch
    for i in range(1, k):
        out[i] = ext_mul_dev(out[i - 1], out[i - 1])
    return out
