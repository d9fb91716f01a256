"""flexflow_tpu_torch.parallel: tensor-parallel serving over several devices.

One controller drives every shard (reference: one jitted program over a
``jax.sharding.Mesh``): :mod:`.mesh` names the devices, :mod:`.comm` is
the collectives GSPMD inserts in the reference, and :mod:`.tp` the
Megatron placement (``tensor_parallel_strategy``) and the shard-local
models it makes.
"""

from .comm import Comm, run_local, run_shards
from .mesh import Mesh, make_mesh

__all__ = ["Comm", "Mesh", "make_mesh", "run_local", "run_shards"]
