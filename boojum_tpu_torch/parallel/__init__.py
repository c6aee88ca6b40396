# Port of boojum_tpu/parallel/__init__.py to torch.distributed.
"""Multi-GPU proving: one process a device, joined by a process group
(NCCL on CUDA devices, gloo on the CPU)."""

from .sharding import (distributed_commit_step,  # noqa: F401
                       distributed_sum_reduce, make_mesh)
