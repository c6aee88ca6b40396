"""The small lookup circuit of tests/test_prove_verify.py in either
package, and its setups and proofs (the JAX host `prove`'s and the port's
CPU `DeviceProver`'s), each made once a process at its first use: the
port's prover and verifier tests (tests/test_torch_prover.py,
tests/test_torch_verifier.py) share them. A module of its own, imported by
one name from both files, so that both read one cache."""

import importlib

import numpy as np

from boojum_tpu.cs.setup import create_base_setup as ref_create_base_setup
from boojum_tpu.prover import ProofConfig as RefProofConfig
from boojum_tpu.prover import create_setup_and_vk, prove
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover import device_merkle

P = 0xFFFFFFFF00000001


def build_small_circuit(pkg: str, rng, n_fma=30):
    """tests/test_prove_verify.py:build_small_circuit(with_lookup=True),
    written against either package's circuit modules."""
    csm = importlib.import_module(pkg + ".cs")
    g = importlib.import_module(pkg + ".cs.gates")
    geom = csm.CSGeometry(num_columns_under_copy_permutation=16,
                          num_witness_columns=0, num_constant_columns=4,
                          max_allowed_constraint_degree=4)
    cs = csm.ConstraintSystem(geom, 1 << 10, csm.CSConfig.dev())
    cs.allow_lookup(csm.LookupParameters.specialized_with_table_id_as_constant(
        width=3, num_repetitions=2, share_table_id=True))
    cs.allow_gate(g.ConstantsAllocatorGate)
    cs.allow_gate(g.FmaGate)
    cs.allow_gate(g.ReductionGate, params=4)
    cs.allow_gate(g.BooleanConstraintGate)
    cs.allow_gate(g.SelectionGate)
    cs.allow_gate(g.PublicInputGate)
    cs.allow_gate(g.NopGate)
    rows = [(a, b, a ^ b) for a in range(8) for b in range(8)]
    tid = cs.add_lookup_table(csm.LookupTable("xor3", np.asarray(rows, np.uint64),
                                              num_keys=2))
    a = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    b = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    c = cs.alloc_variables_with_values(rng.integers(0, P, n_fma, dtype=np.uint64))
    d = g.FmaGate.compute_fma_batch(cs, 3, (a, b), 5, c)
    e = g.ReductionGate.reduce_terms_batch(
        cs, [1, 2, 3, 4], np.stack([a[:8], b[:8], c[:8], d[:8]]))
    g.ConstantsAllocatorGate.allocate_constant(cs, 1234)
    bits = g.BooleanConstraintGate.allocate_batch(cs, [1, 0, 1, 1])
    g.SelectionGate.select_batch(cs, a[:4], b[:4], bits)
    la = cs.alloc_variables_with_values([1, 2, 3, 7, 5])
    lb = cs.alloc_variables_with_values([6, 2, 1, 7, 0])
    lo = cs.alloc_variables_with_values([1 ^ 6, 0, 3 ^ 1, 0, 5])
    cs.enforce_lookup_batch(tid, np.stack([la, lb, lo]))
    g.PublicInputGate.place(cs, int(d[0]))
    g.PublicInputGate.place(cs, int(e[0]))
    cs.pad_and_shrink()
    return cs


# circuits, setups and proofs of the small circuit, each made once a
# process at its first use; tests/test_torch_verifier.py reads them too
_SHARED = {}


def _shared(key, make):
    if key not in _SHARED:
        _SHARED[key] = make()
    return _SHARED[key]


def small_circuits():
    """Both packages' small circuits from ``default_rng(11)`` and their
    base setups."""
    def make():
        ref_cs = build_small_circuit("boojum_tpu", np.random.default_rng(11))
        cs = build_small_circuit("boojum_tpu_torch", np.random.default_rng(11))
        return dict(ref_cs=ref_cs, cs=cs, ref_sb=ref_create_base_setup(ref_cs),
                    sb=create_base_setup(cs))
    return _shared("circuits", make)


def _cfg_key(cfg):
    return tuple(sorted(cfg.items()))


def setups(cfg, hasher):
    """The reference's and the port's artifacts of the small circuit under
    ``cfg`` with ``hasher``'s trees."""
    def make():
        c = small_circuits()
        return (create_setup_and_vk(c["ref_cs"], c["ref_sb"],
                                    RefProofConfig(**cfg), hasher),
                create_device_setup(c["cs"], c["sb"], ProofConfig(**cfg),
                                    hasher, device="cpu"))
    return _shared(("setups", _cfg_key(cfg), hasher), make)


def reference_proof(cfg, transcript, hasher):
    """The reference host proof of the small circuit."""
    def make():
        c = small_circuits()
        return prove(c["ref_cs"], setups(cfg, hasher)[0],
                     RefProofConfig(**cfg), transcript, hasher)
    return _shared(("reference", _cfg_key(cfg), transcript, hasher), make)


def port_prover(cfg, transcript, hasher):
    """A CPU prover of the small circuit after its first prove (host
    transcript), whose query phase came to the host in one flush, and that
    proof."""
    def make():
        prover = DeviceProver(small_circuits()["cs"], setups(cfg, hasher)[1],
                              ProofConfig(**cfg), device="cpu")
        fetches = device_merkle.FETCHES
        proof = prover.prove(transcript, hasher)
        assert device_merkle.FETCHES - fetches == 1  # the query phase's one
        return prover, proof
    return _shared(("port", _cfg_key(cfg), transcript, hasher), make)


def port_proof(cfg, transcript, hasher):
    """A fresh CPU prover's first proof of the small circuit (host
    transcript)."""
    return port_prover(cfg, transcript, hasher)[1]
