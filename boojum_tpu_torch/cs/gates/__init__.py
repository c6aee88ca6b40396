# Copied from boojum_tpu/cs/gates/__init__.py.
"""Gate library (reference src/cs/gates/, 29 files — built out over rounds)."""

from .arith import (  # noqa: F401
    FmaGateInExtension,
    MatrixMultiplicationGate,
    SimpleNonlinearityGate,
    U32AddGate,
    U32SubGate,
    U32TriAddCarryAsChunkGate,
    U8x4FMAGate,
    UIntXAddGate,
)
from .base import Ext2Ops, GateEvaluator, NpOps, TorchOps, TraceView  # noqa: F401
from .poseidon2_gate import Poseidon2FlattenedGate  # noqa: F401
from .poseidon_gate import PoseidonFlattenedGate  # noqa: F401
from .simple import (  # noqa: F401
    BooleanConstraintGate,
    ConditionalSwapGate,
    ConstantsAllocationAsConstraintGate,
    ConstantsAllocatorGate,
    ConstantsAsConstraintEvaluator,
    DotProductGate,
    FmaGate,
    NopGate,
    ParallelSelectionGate,
    PublicInputGate,
    QuadraticCombinationGate,
    ReductionByPowersGate,
    ReductionGate,
    SelectionGate,
    ZeroCheckGate,
)
