"""GPU-only check of the port: a whole small proof on the card against the
same proof on the CPU (`chip_smoke.py` holds each kernel against its plain
version at the flagship's shapes). It skips without a GPU. This file imports
no JAX, so on the GPU machine (which has none) it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from boojum_tpu_torch.cs import (ConstraintSystem, CSConfig, CSGeometry,
                                 LookupParameters, LookupTable)
from boojum_tpu_torch.cs.gates import (ConstantsAllocatorGate, FmaGate,
                                       NopGate, PublicInputGate, ReductionGate)
from boojum_tpu_torch.cs.setup import create_base_setup
from boojum_tpu_torch.field import goldilocks as gl
from boojum_tpu_torch.prover import (DeviceProver, ProofConfig,
                                     create_device_setup)
from boojum_tpu_torch.prover.proof import proof_to_json

P = gl.ORDER
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _small_circuit():
    geom = CSGeometry(num_columns_under_copy_permutation=16,
                      num_witness_columns=0, num_constant_columns=4,
                      max_allowed_constraint_degree=4)
    cs = ConstraintSystem(geom, 1 << 10, CSConfig.dev())
    cs.allow_lookup(LookupParameters.specialized_with_table_id_as_constant(
        width=3, num_repetitions=2, share_table_id=True))
    cs.allow_gate(ConstantsAllocatorGate)
    cs.allow_gate(FmaGate)
    cs.allow_gate(ReductionGate, params=4)
    cs.allow_gate(PublicInputGate)
    cs.allow_gate(NopGate)
    rows = [(a, b, a ^ b) for a in range(8) for b in range(8)]
    tid = cs.add_lookup_table(LookupTable("xor3", np.asarray(rows, np.uint64),
                                          num_keys=2))
    rng = np.random.default_rng(5)
    a, b, c = (cs.alloc_variables_with_values(rng.integers(0, P, 20, dtype=np.uint64))
               for _ in range(3))
    d = FmaGate.compute_fma_batch(cs, 3, (a, b), 5, c)
    ReductionGate.reduce_terms_batch(cs, [1, 2, 3, 4],
                                     np.stack([a[:8], b[:8], c[:8], d[:8]]))
    la = cs.alloc_variables_with_values([1, 2, 3, 7])
    lb = cs.alloc_variables_with_values([6, 2, 1, 7])
    lo = cs.alloc_variables_with_values([1 ^ 6, 0, 3 ^ 1, 0])
    cs.enforce_lookup_batch(tid, np.stack([la, lb, lo]))
    PublicInputGate.place(cs, int(d[0]))
    cs.pad_and_shrink()
    return cs


def test_small_proof_on_gpu_equals_cpu(cuda):
    cs = _small_circuit()
    sb = create_base_setup(cs)
    cfg = ProofConfig(fri_lde_factor=8, merkle_tree_cap_size=4)
    proofs = []
    for device in ("cpu", cuda):
        art = create_device_setup(cs, sb, cfg, "poseidon2", device=device)
        proofs.append(proof_to_json(DeviceProver(cs, art, cfg, device=device)
                                    .prove("poseidon", "poseidon2")))
    assert proofs[0] == proofs[1]
