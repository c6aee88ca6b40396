"""The port's device witness program and its SHA-256 twin against the JAX
package: `DeviceWitnessProgram` (exact u64 columns, before and after
`replay_witness`), `_sha256_witness_dev` (and its chain, kernel K5's plain
version) against the JAX host witness, and `supported()` on the port's
circuits (the prove with the program is tests/test_torch_device_prove.py)."""

import hashlib

import numpy as np
import pytest
import torch

from boojum_tpu.cs import gates as ref_gates
from boojum_tpu.gadgets import sha256 as ref_sha
from boojum_tpu.prover.device_witness import \
    DeviceWitnessProgram as RefDeviceWitnessProgram
from boojum_tpu_torch.cs import gates
from boojum_tpu_torch.gadgets import sha256 as sha
from boojum_tpu_torch.gadgets import sha256_witness as sw
from boojum_tpu_torch.prover.device_witness import DeviceWitnessProgram
from tests.test_sha256 import build_sha256_circuit as ref_build
from tests.test_torch_prover import build_small_circuit


def _ref_columns(prog, overrides=None) -> np.ndarray:
    lag = prog(overrides)
    return np.asarray(lag.lo, np.uint64) | \
        (np.asarray(lag.hi, np.uint64) << np.uint64(32))


def _columns(prog, overrides=None) -> np.ndarray:
    return prog(overrides).numpy().view(np.uint64)


@pytest.fixture(scope="module")
def sha40():
    """The 40-byte SHA-256 circuit of tests/test_device_witness.py, built by
    both packages, and both device witness programs."""
    data = bytes(np.random.default_rng(3).integers(0, 256, 40, dtype=np.uint8))
    ref_cs, _ = ref_build(data)
    cs, out = sha.build_sha256_circuit(data)
    for c in (ref_cs, cs):
        c.pad_and_shrink()
    n = cs.final_trace_len
    assert n == ref_cs.final_trace_len
    return dict(ref_cs=ref_cs, cs=cs, out=out, n=n,
                ref_prog=RefDeviceWitnessProgram(ref_cs, n),
                prog=DeviceWitnessProgram(cs, n, "cpu"))


def test_device_witness_columns_match_jax(sha40):
    got = _columns(sha40["prog"])
    want = _ref_columns(sha40["ref_prog"])
    assert got.shape == want.shape == (sha40["n"], got.shape[1])
    assert np.array_equal(got, want)


def test_device_witness_replay_matches_jax(sha40):
    data2 = bytes(np.random.default_rng(4).integers(0, 256, 40,
                                                    dtype=np.uint8))
    for c in (sha40["ref_cs"], sha40["cs"]):
        c.replay_witness({int(v): int(b)
                          for v, b in zip(c.input_variables, data2)})
    cs = sha40["cs"]
    assert bytes(int(cs.get_value(int(v))) for v in sha40["out"]) == \
        hashlib.sha256(data2).digest()
    got = _columns(sha40["prog"], cs.witness_overrides)
    want = _ref_columns(sha40["ref_prog"], sha40["ref_cs"].witness_overrides)
    assert np.array_equal(got, want)
    with pytest.raises(AssertionError):  # a byte input takes no wide value
        sha40["prog"]({int(cs.input_variables[0]): 1 << 20})


@pytest.mark.parametrize("nb", [1, 2, 3])
def test_sha256_witness_dev_matches_jax_host(nb):
    """Random blocks, the first words all-ones so that every sum
    overflows 32 bits; nb >= 2 chains blocks."""
    rng = np.random.default_rng(10 + nb)
    blocks = rng.integers(0, 256, (nb, 64), dtype=np.uint64)
    blocks[0, :16] = 0xFF
    init = np.asarray(ref_sha.INITIAL_STATE, np.uint64)
    want = ref_sha._flatten_witness(ref_sha._sha256_witness(blocks, init))
    got = sha._sha256_witness_dev(
        torch.as_tensor(blocks.astype(np.int64)).reshape(-1), nb,
        ref_sha.INITIAL_STATE)
    assert np.array_equal(got.numpy().view(np.uint64), want)


def test_compress_chain_input_checks():
    blocks = torch.zeros((2, 64), dtype=torch.int64)
    init = torch.tensor(sha.INITIAL_STATE, dtype=torch.int64)
    assert sw.compress_chain(blocks, init).shape == (sw.ROWS, 2, 64)
    with pytest.raises(TypeError):
        sw.compress_chain(blocks.int(), init)
    with pytest.raises(TypeError):
        sw.compress_chain(blocks[:, :32], init)
    with pytest.raises(TypeError):
        sw.compress_chain(blocks, init[:4])


def _sha_with_untwinned_node(build, gates, data):
    """The SHA-256 circuit and one more node with no device twin (the
    reduction gate's witness)."""
    cs, out = build(data)
    gates.ReductionGate.reduce_terms_batch(
        cs, [1, 2, 3, 4], np.stack([np.asarray(out[:2], np.uint64)] * 4))
    return cs


@pytest.mark.parametrize("circuit", ["sha256", "small_lookup",
                                     "sha256_untwinned"])
def test_supported_agrees_with_jax(circuit):
    data = bytes(range(20))
    if circuit == "sha256":
        ref_cs, cs = ref_build(data)[0], sha.build_sha256_circuit(data)[0]
    elif circuit == "small_lookup":  # public inputs
        ref_cs = build_small_circuit("boojum_tpu", np.random.default_rng(11))
        cs = build_small_circuit("boojum_tpu_torch", np.random.default_rng(11))
    else:
        ref_cs = _sha_with_untwinned_node(ref_build, ref_gates, data)
        cs = _sha_with_untwinned_node(sha.build_sha256_circuit, gates, data)
    want = RefDeviceWitnessProgram.supported(ref_cs)
    assert DeviceWitnessProgram.supported(cs) == want
    assert want == (circuit == "sha256")
