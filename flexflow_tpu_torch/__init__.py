"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA Hopper.

The JAX package ``flexflow_tpu`` is the reference this package is held
against; nothing here imports it or JAX.  Slice 1 covers Llama serving on
one device: prefill and decode through hand-written CUDA attention kernels
(``ops/cuda``), with plain PyTorch versions of those kernels for tensors
that live on the CPU.
"""

__version__ = "0.1.0"
