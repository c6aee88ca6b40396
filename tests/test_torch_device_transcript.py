"""The port's device transcript and its Poseidon sponge against the JAX
package: the tensor Poseidon permutation against its `s_permutation`, the
sponge entries (kernel K6's plain versions) against the scalar sponge, a
scripted absorb / squeeze sequence through `DeviceTranscript` against the
JAX host `AlgebraicTranscript` (all three piece tags, odd and even challenge
counts, the cross case, a handoff mid-stream), and the ext power tables
against sequential host products."""

import numpy as np
import pytest
import torch

from boojum_tpu.hash import poseidon as ref_poseidon
from boojum_tpu.transcript import AlgebraicTranscript as RefTranscript
from boojum_tpu_torch.field import extension as ext2
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.hash import poseidon
from boojum_tpu_torch.prover.device_transcript import (DeviceTranscript,
                                                       ext_mul_dev,
                                                       ext_pow_table_dev,
                                                       sq_chain_dev)

P = gl.ORDER


def _rand(rng, shape):
    return rng.integers(0, P, shape, dtype=np.uint64)


def test_permutation_matches_jax():
    """Against the JAX package's scalar permutation, which its own
    tests/test_hash.py holds equal to its device `permutation_gl` (run
    eagerly here, that one took about 26 s)."""
    rng = np.random.default_rng(1)
    st = _rand(rng, (12, 6))
    st[:, 0] = P - 1
    st[:, 1] = 0
    st[:, 2] = (1 << 32) - 1
    got = gl.to_u64(poseidon.permutation_stacked(gl.from_u64(st)))
    want = np.asarray([ref_poseidon.s_permutation([int(v) for v in st[:, j]])
                       for j in range(st.shape[1])], np.uint64).T
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [0, 1, 7, 8, 9, 16, 23])
def test_sponge_entries_match_scalar_sponge(k):
    """Absorb pads with a one then zeros to whole rate blocks (k + 1
    counted: k = 7 and 15 fill their last block with the one)."""
    rng = np.random.default_rng(20 + k)
    st, el = _rand(rng, 12), _rand(rng, k)
    s = [int(x) for x in st]
    blk = [int(x) for x in el] + [1]
    blk += [0] * (-len(blk) % 8)
    for i in range(0, len(blk), 8):
        s[:8] = blk[i:i + 8]
        s = ref_poseidon.s_permutation(s)
    got = poseidon.sponge_absorb(gl.from_u64(st), gl.from_u64(el))
    assert [int(x) for x in gl.to_u64(got)] == s
    assert [int(x) for x in gl.to_u64(poseidon.sponge_permute(
        gl.from_u64(st)))] == ref_poseidon.s_permutation(
            [int(x) for x in st])
    many = poseidon.sponge_absorb_plain_many(
        gl.from_u64(np.stack([st, st], 1)), [gl.from_u64(el),
                                            gl.from_u64(el[:k // 2])])
    assert torch.equal(many[:, 0], got)
    assert torch.equal(many[:, 1], poseidon.sponge_absorb(
        gl.from_u64(st), gl.from_u64(el[:k // 2])))


def test_sponge_input_checks():
    st = torch.zeros(12, dtype=torch.int64)
    with pytest.raises(TypeError):
        poseidon.sponge_absorb(st[:8], st)
    with pytest.raises(TypeError):
        poseidon.sponge_absorb(st, st.int())
    with pytest.raises(TypeError):
        poseidon.sponge_permute(st.reshape(3, 4))


def _ext(dt_challenge):
    return tuple(int(x) for x in gl.to_u64(dt_challenge))


@pytest.mark.parametrize("kind", ["poseidon", "poseidon2"])
def test_scripted_transcript_matches_jax(kind):
    rng = np.random.default_rng(5)
    dt, ref = DeviceTranscript(kind, "cpu"), RefTranscript(kind)
    got, want = [], []

    def draw(count):
        for _ in range(count):
            got.append(_ext(dt.get_ext_challenge()))
            want.append((ref.get_challenge(), ref.get_challenge()))

    # host ints (the setup cap, node-major tuples) and an empty absorb
    cap_host = [tuple(int(x) for x in _rand(rng, 4)) for _ in range(4)]
    dt.witness_merkle_tree_cap(cap_host)
    ref.witness_merkle_tree_cap(cap_host)
    dt.witness_field_elements([])
    ref.witness_field_elements([])
    draw(2)  # even
    # a device cap layer (4, c): CAPT pieces absorb node-major
    cap = _rand(rng, (4, 8))
    dt.witness_merkle_tree_cap_dev(gl.from_u64(cap))
    ref.witness_merkle_tree_cap([tuple(int(v) for v in cap[:, j])
                                 for j in range(8)])
    draw(3)  # odd
    # FLAT and ILV pieces in one flush: v0.c0, v0.c1, v1.c0, ...
    flat, c0, c1 = _rand(rng, 5), _rand(rng, 9), _rand(rng, 9)
    dt.witness_field_elements_dev(gl.from_u64(flat))
    dt.absorb_interleaved_dev(gl.from_u64(c0), gl.from_u64(c1))
    ref.witness_field_elements([int(x) for x in flat])
    for a, b in zip(c0, c1):
        ref.witness_field_elements([int(a), int(b)])
    draw(5)  # past the rate: a squeeze permutes
    # the cross case: one position left in the squeeze (the host drew seven
    # single challenges), c0 = state[7], then c1 from the next permutation
    dt.witness_field_elements([7])
    ref.witness_field_elements([7])
    draw(1)
    for _ in range(5):
        ref.get_challenge()
    dt.avail_pos = 7
    draw(2)
    assert dt.avail_pos == 3
    # a handoff mid-stream, pending pieces and all; the host transcript
    # continues exactly
    tail = _rand(rng, 11)
    dt.witness_field_elements_dev(gl.from_u64(tail))
    ref.witness_field_elements([int(x) for x in tail])
    extra = gl.from_u64(_rand(rng, (2, 3)))
    host, fetched = dt.handoff_to_host([extra])
    assert np.array_equal(fetched[0], gl.to_u64(extra))
    host.witness_field_elements([1, 2, 3])
    ref.witness_field_elements([1, 2, 3])
    for _ in range(9):
        got.append(host.get_challenge())
        want.append(ref.get_challenge())
    assert got == want


def test_handoff_keeps_the_squeeze():
    """A handoff right after a draw hands over the rest of the squeeze."""
    dt, ref = DeviceTranscript("poseidon", "cpu"), RefTranscript("poseidon")
    dt.witness_field_elements([3, 4])
    ref.witness_field_elements([3, 4])
    assert _ext(dt.get_ext_challenge()) == (ref.get_challenge(),
                                            ref.get_challenge())
    host, _ = dt.handoff_to_host()
    assert [host.get_challenge() for _ in range(10)] == \
        [ref.get_challenge() for _ in range(10)]


@pytest.mark.parametrize("count", [1, 2, 5, 8, 37])
def test_ext_pow_table_matches_host(count):
    c = (0xDEADBEEF12345678 % P, 0x0123456789ABCDEF)
    want, p = [], (1, 0)
    for _ in range(count):
        want.append(p)
        p = ext2.s2_mul(p, c)
    table = ext_pow_table_dev(gl.from_u64(np.asarray(c, np.uint64)), count)
    assert [tuple(int(x) for x in row) for row in gl.to_u64(table)] == want


@pytest.mark.parametrize("k", [1, 3, 6])
def test_sq_chain_and_ext_mul_match_host(k):
    c = (P - 2, 0xFFFFFFFF)
    cd = gl.from_u64(np.asarray(c, np.uint64))
    want, p = [], c
    for _ in range(k):
        want.append(p)
        p = ext2.s2_mul(p, p)
    chain = sq_chain_dev(cd, k)
    assert [tuple(int(x) for x in row) for row in gl.to_u64(chain)] == want
    assert _ext(ext_mul_dev(cd, chain[-1])) == ext2.s2_mul(c, want[-1])
