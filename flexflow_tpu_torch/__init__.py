"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA Hopper.

The JAX package ``flexflow_tpu`` is the reference this package is held
against; nothing here imports it or JAX.  It trains (``FFModel``: the
graph builder, ``compile``, ``fit`` and ``evaluate`` on one device or a
data- and tensor-parallel mesh, with SGD and Adam, checkpoints
(``training/checkpoint.py``) and a prefetching ``data.DataLoader``) and
serves Llama, OPT, Falcon, MPT and StarCoder
(``serve``) on one device or tensor- and pipeline-parallel over several
(``parallel``): prefill, decode and tree speculation through
hand-written CUDA attention kernels (``ops/cuda``), with plain PyTorch
versions of those kernels for tensors that live on the CPU.
"""

from .config import FFConfig
from .model import FFModel
from .parallel.mesh import data_parallel_strategy, make_mesh
from .training import loss as losses
from .training import metrics as metrics
from .training.initializer import (GlorotUniform, NormInitializer,
                                   OneInitializer, UniformInitializer,
                                   ZeroInitializer)
from .training.optimizer import AdamOptimizer, SGDOptimizer

__version__ = "0.1.0"

__all__ = [
    "FFConfig",
    "FFModel",
    "make_mesh",
    "data_parallel_strategy",
    "SGDOptimizer",
    "AdamOptimizer",
    "losses",
    "metrics",
    "GlorotUniform",
    "ZeroInitializer",
    "OneInitializer",
    "UniformInitializer",
    "NormInitializer",
]
