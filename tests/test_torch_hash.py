"""The port's Poseidon2 permutation (the plain version of the
`poseidon2_permute` kernel, K2), Merkle trees and transcripts against the JAX
package: the jnp stacked permutation, the exact scalar twin, the Pallas slab
kernel in interpret mode, the host Merkle tree (caps and paths) and the
challenge streams. Exact equality throughout."""

import jax
import numpy as np
import pytest
import torch

from boojum_tpu import transcript as ref_transcript
from boojum_tpu.field import goldilocks as ref_gl
from boojum_tpu.hash import poseidon as ref_poseidon
from boojum_tpu.hash import poseidon2 as ref_p2
from boojum_tpu.hash import sponge as ref_sponge
from boojum_tpu.hash.merkle import AlgebraicMerkleTree
from boojum_tpu.hash.pallas_poseidon2 import _perm_pallas_jit
from boojum_tpu_torch import transcript
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.hash import pallas_poseidon2, poseidon, poseidon2, sponge
from boojum_tpu_torch.prover.device_merkle import build_device_tree

P = gl.ORDER


def _states(seed, b):
    return np.random.default_rng(seed).integers(0, P, (12, b), dtype=np.uint64)


def test_permutation_matches_reference_stacked_and_scalar():
    st = _states(1, 64)
    st[:, 0] = 0
    st[:, 1] = P - 1
    got = gl.to_u64(pallas_poseidon2.permutation_stacked_fast(gl.from_u64(st)))
    want = ref_gl.to_u64(jax.jit(ref_p2._permutation_stacked)(
        ref_gl.from_u64(st.reshape(-1)).reshape(12, 64)))
    assert np.array_equal(got, want)
    for j in (0, 1, 63):
        assert [int(v) for v in got[:, j]] == \
            ref_p2.s_permutation([int(v) for v in st[:, j]])
    assert poseidon2.s_permutation(list(range(12))) == \
        ref_p2.s_permutation(list(range(12)))
    assert poseidon.s_permutation(list(range(12))) == \
        ref_poseidon.s_permutation(list(range(12)))


def test_permutation_matches_pallas_kernel_interpret():
    """One (96, 1024) slab of the TPU kernel: 8192 states, one grid step."""
    st = _states(2, 8192)
    r = ref_gl.from_u64(st.reshape(-1)).reshape(12, 8192)
    lo, hi = _perm_pallas_jit(1024, True)(r.lo.reshape(96, 1024),
                                          r.hi.reshape(96, 1024))
    want = ref_gl.to_u64(ref_gl.GL(lo.reshape(12, 8192), hi.reshape(12, 8192)))
    got = gl.to_u64(pallas_poseidon2.permutation_stacked_fast(gl.from_u64(st)))
    assert np.array_equal(got, want)


def test_permutation_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        pallas_poseidon2.permutation_stacked_fast(gl.from_u64(_states(3, 4)[:8]))
    with pytest.raises(TypeError):
        pallas_poseidon2.permutation_stacked_fast(
            torch.zeros((12, 4), dtype=torch.int32))


@pytest.mark.parametrize("k,cap", [(5, 4), (11, 16)])
def test_merkle_caps_and_paths_match_reference(k, cap):
    """2^10 leaves; k is padded to the rate (8) before hashing."""
    cols = np.random.default_rng(k).integers(0, P, (k, 1 << 10), dtype=np.uint64)
    ref_tree = AlgebraicMerkleTree.from_leaf_columns(ref_gl.from_u64(cols), cap,
                                                     "poseidon2")
    tree = build_device_tree(gl.from_u64(cols), cap)
    assert tree.get_cap() == ref_tree.get_cap()
    idxs = [0, 1, 517, 1023]
    tree.prefetch_proofs(idxs)
    for i in idxs:
        leaf, path = tree.get_proof(i)
        ref_leaf, ref_path = ref_tree.get_proof(i)
        assert leaf == ref_leaf and path == ref_path
        assert AlgebraicMerkleTree.verify_proof_over_cap(path, tree.get_cap(),
                                                         leaf, i)


@pytest.mark.parametrize("kind", ["poseidon", "poseidon2"])
def test_transcript_challenge_stream_matches_reference(kind):
    ours, ref = transcript.make_transcript(kind), \
        ref_transcript.make_transcript(kind)
    for t in (ours, ref):
        t.witness_field_elements([1, 2, P - 1])
        t.witness_merkle_tree_cap([(5, 6, 7, 8), (9, 10, 11, 12)])
    assert ours.get_multiple_challenges(11) == ref.get_multiple_challenges(11)
    for t in (ours, ref):
        t.witness_field_elements(list(range(17)))
    assert ours.get_multiple_challenges(3) == ref.get_multiple_challenges(3)
    # the byte transcripts are ported too (their challenge streams are held
    # in tests/test_torch_bytes_hash.py); an unknown kind raises
    assert not transcript.make_transcript("blake2s").IS_ALGEBRAIC
    with pytest.raises(ValueError):
        transcript.make_transcript("sha3")


def test_scalar_sponge_matches_reference():
    vals = list(range(1, 14))
    assert sponge.scalar_hash_into_leaf(vals) == \
        ref_sponge.scalar_hash_into_leaf(vals)
    assert sponge.scalar_hash_into_node((1, 2, 3, 4), (5, 6, 7, 8)) == \
        ref_sponge.scalar_hash_into_node((1, 2, 3, 4), (5, 6, 7, 8))

