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
from tests.torch_small_circuit import build_small_circuit


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


def _ror(v, r):
    return ((v >> r) | (v << (32 - r))) & 0xFFFFFFFF


def emulate_k5(blocks: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """csrc/sha256_witness.cu's phases in torch: the schedules; the chain on
    Python ints in 32 bits, recording only new_e and new_a (and each block's
    start state); then the expansion of every (block, round) pair at once
    from that history, W and K, with the exact 64-bit sums."""
    nb = blocks.shape[0]
    be = blocks.reshape(nb, 16, 4)
    w = [((be[:, i, 0] << 24) | (be[:, i, 1] << 16) | (be[:, i, 2] << 8)
          | be[:, i, 3]) for i in range(16)]
    sch = []
    for i in range(16, 64):
        x0, x1 = w[i - 15], w[i - 2]
        t = (_ror(x0, 7) ^ _ror(x0, 18) ^ (x0 >> 3)) + \
            (_ror(x1, 17) ^ _ror(x1, 19) ^ (x1 >> 10)) + w[i - 7] + w[i - 16]
        sch.append(t)
        w.append(t & 0xFFFFFFFF)
    w = torch.stack(w, dim=1)  # (nb, 64)
    k = torch.tensor(sha.ROUND_CONSTANTS, dtype=torch.int64)

    # the chain thread: 32-bit new_e / new_a only
    m32 = 0xFFFFFFFF
    st = [int(v) for v in init]
    start, new_a, new_e = [], [], []
    for b in range(nb):
        start.append(list(st))
        a, bb, c, d, e, f, g, h = st
        ra, re_ = [], []
        for r in range(64):
            x = (h + int(k[r]) + int(w[b, r])) & m32
            s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
            ch = (e & f) ^ (~e & g & m32)
            ne = (x + d + s1 + ch) & m32
            na = (x + (_ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22))
                  + ((a & bb) ^ (a & c) ^ (bb & c)) + s1 + ch) & m32
            ra.append(na)
            re_.append(ne)
            h, g, f, e, d, c, bb, a = g, f, e, ne, c, bb, a, na
        new_a.append(ra)
        new_e.append(re_)
        st = [(u + v) & m32 for u, v in zip(st, (a, bb, c, d, e, f, g, h))]

    # the expansion: history padded with the start states, A(-1..-4) =
    # a, b, c, d and E(-1..-4) = e, f, g, h
    st_t = torch.tensor(start, dtype=torch.int64)  # (nb, 8)
    hist_a = torch.cat([st_t[:, :4].flip(1), torch.tensor(new_a)], dim=1)
    hist_e = torch.cat([st_t[:, 4:].flip(1), torch.tensor(new_e)], dim=1)

    def back(hist, j):  # value j rounds before round r, for all r
        return hist[:, 4 - j:68 - j]

    a, b, c, d = (back(hist_a, j) for j in (1, 2, 3, 4))
    e, f, g, h = (back(hist_e, j) for j in (1, 2, 3, 4))
    s1 = _ror(e, 6) ^ _ror(e, 11) ^ _ror(e, 25)
    ch = (e & f) ^ ((~e & m32) & g)
    s0 = _ror(a, 2) ^ _ror(a, 13) ^ _ror(a, 22)
    maj = (a & b) ^ (a & c) ^ (b & c)
    tmp1 = h + s1 + ch + k
    tmp1w = tmp1 + w
    te, ta = tmp1w + d, s0 + maj + tmp1w
    fin = st_t + torch.cat([hist_a[:, 64:].flip(1), hist_e[:, 64:].flip(1)],
                          dim=1)
    out = blocks.new_zeros((sw.ROWS, nb, 64))
    sch_t = torch.stack(sch, dim=1)
    rows = dict(W=w, s1=s1, ch=ch, s0=s0, maj=maj, new_e=te & m32,
                new_a=ta & m32)
    for name, v in dict(tmp1=tmp1, tmp1w=tmp1w, te=te, ta=ta).items():
        rows[name + "_lo"], rows[name + "_hi"] = v & m32, v >> 32
    for name, v in rows.items():
        out[sw.ROW[name]] = v
    out[sw.ROW["sch_lo"], :, :48] = sch_t & m32
    out[sw.ROW["sch_hi"], :, :48] = sch_t >> 32
    out[sw.ROW["state_in"], :, :8] = st_t
    out[sw.ROW["fin_lo"], :, :8] = fin & m32
    out[sw.ROW["fin_hi"], :, :8] = fin >> 32
    return out


@pytest.mark.parametrize("nb", [1, 3])
def test_k5_expansion_matches_plain_and_jax(nb, monkeypatch):
    """K5's record-and-expand order equals `compress_chain_plain` row for
    row, and, put in its place, gives `_sha256_witness_dev` the JAX host
    witness. The first words are all ones, so every wide sum carries."""
    rng = np.random.default_rng(20 + nb)
    blocks = rng.integers(0, 256, (nb, 64), dtype=np.uint64)
    blocks[0, :16] = 0xFF
    bt = torch.as_tensor(blocks.astype(np.int64))
    init = torch.tensor(ref_sha.INITIAL_STATE, dtype=torch.int64)
    got = emulate_k5(bt, init)
    assert torch.equal(got, sw.compress_chain_plain(bt, init))
    monkeypatch.setattr(sw, "compress_chain", emulate_k5)
    want = ref_sha._flatten_witness(ref_sha._sha256_witness(
        blocks, np.asarray(ref_sha.INITIAL_STATE, np.uint64)))
    dev = sha._sha256_witness_dev(bt.reshape(-1), nb, ref_sha.INITIAL_STATE)
    assert np.array_equal(dev.numpy().view(np.uint64), want)


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
