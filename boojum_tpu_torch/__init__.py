"""boojum_tpu_torch — the PyTorch/CUDA port of boojum_tpu.

The same prover as the JAX package beside it, on torch tensors, with the
TPU's Pallas kernels replaced by hand-written Hopper kernels (``csrc/``).
Entry points take an explicit ``device`` and run on the GPU by default:
`prover.device_prover.create_device_setup` and
`prover.device_prover.DeviceProver`; the verifier, `verifier.verify`, is
host code on Python ints. The package imports neither JAX nor the JAX
package; the host-side circuit code it needs is copied here.
"""
