"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA Hopper.

The JAX package ``flexflow_tpu`` is the reference this package is held
against; nothing here imports it or JAX.  It serves Llama, OPT, Falcon, MPT
and StarCoder (``serve``) on one device or tensor-parallel over several
(``parallel``): prefill, decode and tree speculation through hand-written
CUDA attention kernels (``ops/cuda``), with plain PyTorch versions of
those kernels for tensors that live on the CPU.
"""

__version__ = "0.1.0"
