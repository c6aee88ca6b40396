"""The port's Keccak-256 circuit gadget against the host Keccak-256 and the
JAX package's gadget: the same digest, the same variable values, the same
setup arrays and a satisfied circuit at 50 and 200 bytes; the port's device
witness program on the 50-byte circuit against the JAX host witness columns;
every torch twin of the gadget against its numpy closure on all its inputs."""

import itertools

import numpy as np
import pytest
import torch

from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.hash.keccak import keccak256 as ref_keccak256
from boojum_tpu.prover.prover import \
    materialize_witness_columns as ref_materialize
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.gadgets.keccak256 import build_keccak256_circuit
from boojum_tpu_torch.hash.keccak import keccak256
from boojum_tpu_torch.prover.device_witness import DeviceWitnessProgram
from tests.test_keccak_gadget import build as ref_build

SIZES = (50, 200)
_CIRCUITS = {}


def circuits(size):
    """Both packages' circuits over ``size`` bytes from ``default_rng(13)``,
    padded; built once a size."""
    if size not in _CIRCUITS:
        data = bytes(np.random.default_rng(13).integers(0, 256, size,
                                                        dtype=np.uint8))
        cs, out = build_keccak256_circuit(data)
        ref_cs, _ = ref_build(data)
        digest = bytes(int(cs.get_value(int(v))) for v in out)
        cs.pad_and_shrink()
        ref_cs.pad_and_shrink()
        _CIRCUITS[size] = dict(data=data, cs=cs, ref_cs=ref_cs, digest=digest)
    return _CIRCUITS[size]


@pytest.mark.parametrize("size", SIZES)
def test_digest_matches_host_keccak_and_is_satisfied(size):
    c = circuits(size)
    assert c["digest"] == keccak256(c["data"]) == ref_keccak256(c["data"])
    assert c["cs"].final_trace_len == c["ref_cs"].final_trace_len
    assert c["cs"].check_if_satisfied()


@pytest.mark.parametrize("size", SIZES)
def test_values_and_setup_match_jax(size):
    c = circuits(size)
    cs, ref_cs = c["cs"], c["ref_cs"]
    k = cs.next_place_idx
    assert k == ref_cs.next_place_idx
    assert cs.resolver.resolved[:k].all() and ref_cs.resolver.resolved[:k].all()
    assert np.array_equal(cs.resolver.values[:k], ref_cs.resolver.values[:k])
    sb, ref_sb = create_base_setup(cs), ref_create_base_setup(ref_cs)
    for name in ("copy_permutation_polys", "constant_columns",
                 "lookup_tables_columns"):
        assert np.array_equal(getattr(sb, name), getattr(ref_sb, name)), name
    for name in ("selector_paths", "quotient_degree", "domain_size",
                 "table_ids_column_idxes"):
        assert getattr(sb, name) == getattr(ref_sb, name), name


def test_device_witness_program_matches_jax_columns():
    c = circuits(50)
    cs, n = c["cs"], c["cs"].final_trace_len
    assert DeviceWitnessProgram.supported(cs)
    got = DeviceWitnessProgram(cs, n, "cpu")().numpy().view(np.uint64)
    want = np.concatenate(ref_materialize(c["ref_cs"], n), axis=0).T
    assert got.shape == want.shape == (n, want.shape[1])
    assert np.array_equal(got, want)


def test_twins_match_numpy_closures():
    """Every twin the gadget and its SHA-256 helpers record, on every input
    combination: bytes for a one-input node (the byte split), 4-bit chunks
    for two- and three-input nodes."""
    cs = circuits(50)["cs"]
    seen = {}
    for fn, ins, _ in cs.resolver.record:
        twin = getattr(fn, "device_twin", None) if fn is not None else None
        if twin is None or not twin.__code__.co_filename.endswith(
                ("keccak256.py", "sha256.py", "uints.py")):
            continue
        key = (twin.__code__, getattr(twin, "__defaults__", None),
               np.asarray(ins).shape[0])
        seen.setdefault(key, (fn, twin, np.asarray(ins).shape[0]))
    # the input bytes' split and xor check, the message bytes' split, the
    # tri-xor, the (~a) & c table, the split-at-3 pair and the split-at-1
    # and split-at-2 pairs (the byte ranges' split and each pair's merge)
    assert len(seen) == 11, sorted(t.__qualname__ for _, t, _ in seen.values())
    for fn, twin, rows in seen.values():
        top = 256 if rows == 1 else 16
        combos = np.asarray(list(itertools.product(range(top), repeat=rows)),
                            np.uint64).T
        want = np.asarray(fn(combos), np.uint64).reshape(-1)
        got = twin(torch.as_tensor(combos.astype(np.int64)))
        assert np.array_equal(got.numpy().view(np.uint64).reshape(-1), want), \
            twin.__qualname__
