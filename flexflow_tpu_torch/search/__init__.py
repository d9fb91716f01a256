"""flexflow_tpu_torch.search: the serve planner.

Port of the serve half of ``flexflow_tpu/search``: the machine model
(:mod:`.machine_model`, with the H100's constants), the serve half of the
simulator (:mod:`.simulator`), the joint ``tp x pp x n_micro`` serve
search and its pricing (:mod:`.serve_search`: ``search_serve_plan``,
``price_plan``, ``pp_serve_cost``), and the card's measured constants
(:mod:`.measure`, which runs on a CUDA device only).  The PCG planner and
the training search are not ported yet.
"""

from .machine_model import H100_SOURCES, TPU_SPECS, MachineModel, TPUSpec
from .serve_search import (
    pp_serve_cost,
    price_kv_swap,
    price_plan,
    search_serve_plan,
    store_component_scales,
)
from .simulator import (
    compose_stage_parts,
    plan_memory_parts,
    serve_component_of,
)

__all__ = [
    "H100_SOURCES",
    "MachineModel",
    "TPUSpec",
    "TPU_SPECS",
    "compose_stage_parts",
    "plan_memory_parts",
    "pp_serve_cost",
    "price_kv_swap",
    "price_plan",
    "search_serve_plan",
    "serve_component_of",
    "store_component_scales",
]
