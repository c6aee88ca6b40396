# Port of boojum_tpu/hash/pallas_poseidon2.py: the batched permutation, kernel K2.
"""Batched Poseidon2 permutation of B independent width-12 states.

`permutation_stacked_fast` takes the states stacked element-major as a
(12, B) int64 tensor. On a CUDA tensor it launches the hand-written Hopper
kernel ``csrc/poseidon2.cu`` for every batch size (it replaces the TPU kernel
`boojum_tpu/hash/pallas_poseidon2.py:_kernel`; the TPU's minimum-batch
threshold, which sent small batches to the plain path, is gone). On a CPU
tensor it runs the plain torch version `poseidon2._permutation_stacked`.
Both give the same canonical outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import poseidon2 as p2

# launches of the CUDA kernel, and calls of the plain version on a CUDA
# tensor (chip_smoke.py reads both around the flagship prove)
LAUNCHES = 0
PLAIN_CUDA_CALLS = 0

_CONSTANTS_SET = set()  # devices whose constant memory holds the tables


def permutation_plain(st: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel."""
    global PLAIN_CUDA_CALLS
    if st.is_cuda:
        PLAIN_CUDA_CALLS += 1
    return p2._permutation_stacked(st)


def _lib(device):
    from ..utils import cuda_build

    lib = cuda_build.load("poseidon2")
    key = torch.device(device).index or 0
    if key not in _CONSTANTS_SET:
        rc = np.asarray(p2._RC, np.uint64)
        diag = np.asarray([1 << s for s in p2._DIAG_SHIFTS], np.uint64)
        with torch.cuda.device(key):
            cuda_build.check(lib.poseidon2_set_constants(
                rc.ctypes.data, diag.ctypes.data), "poseidon2_set_constants")
        _CONSTANTS_SET.add(key)
    return lib


def permutation_stacked_fast(st: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on a canonical (12, B) int64 state -> canonical (12, B)."""
    global LAUNCHES
    if st.dtype != torch.int64 or st.dim() != 2 or st.shape[0] != 12:
        raise TypeError("poseidon2 wants a (12, B) int64 state tensor, got "
                        "%s %s" % (st.dtype, tuple(st.shape)))
    if st.device.type == "cpu":
        return permutation_plain(st)
    if st.device.type != "cuda":
        raise RuntimeError("poseidon2 has no kernel for device %s" % st.device)
    from ..utils import cuda_build

    lib = _lib(st.device)
    st = st.contiguous()
    out = torch.empty_like(st)
    rc = lib.poseidon2_permute(st.data_ptr(), out.data_ptr(), st.shape[1],
                               cuda_build.stream_handle(st))
    cuda_build.check(rc, "poseidon2_permute")
    LAUNCHES += 1
    return out
