"""flexflow_tpu_torch.parallel: tensor-parallel serving over several devices.

One controller drives every shard (reference: one jitted program over a
``jax.sharding.Mesh``): :mod:`.mesh` names the devices, :mod:`.comm` is
the collectives GSPMD inserts in the reference, :mod:`.parallel_ops` the
PCG's parallel ops (priced, and run on a shard's block), and :mod:`.tp`
the plan executor (the shard-local models a PCG plan gives, under any
strategy dict; ``tensor_parallel_strategy`` is the Megatron one).
"""

from .comm import Comm, run_local, run_shards
from .mesh import Mesh, make_mesh

__all__ = ["Comm", "Mesh", "make_mesh", "run_local", "run_shards"]
