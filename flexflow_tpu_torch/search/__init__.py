"""flexflow_tpu_torch.search: the serve planner and the Unity search.

Port of ``flexflow_tpu/search`` for inference: the machine model
(:mod:`.machine_model`, with the H100's constants), the simulator
(:mod:`.simulator`: ``simulate`` and the memory estimate of a planned
PCG, and the serve half's stage records), the Unity MCMC search over
per-op parallel configs (:mod:`.search`: ``enumerate_op_configs``,
``graph_optimize``), strategy files (:mod:`.strategy`), the joint ``tp x
pp x n_micro`` serve search and its pricing (:mod:`.serve_search`:
``search_serve_plan``, ``price_plan``, ``pp_serve_cost``), and the card's
measured constants (:mod:`.measure`, which runs on a CUDA device only).
Graph substitutions, the pipeline search, training-mode pricing and the
measured op-cost cache come with slice 10b-ii.
"""

from .machine_model import H100_SOURCES, TPU_SPECS, MachineModel, TPUSpec
from .search import enumerate_op_configs, graph_optimize
from .serve_search import (
    pp_serve_cost,
    price_kv_swap,
    price_plan,
    search_serve_plan,
    store_component_scales,
)
from .simulator import (
    CostBreakdown,
    compose_stage_parts,
    plan_memory_bytes,
    plan_memory_parts,
    serve_component_of,
    simulate,
)
from .strategy import load_strategy, save_strategy

__all__ = [
    "CostBreakdown",
    "H100_SOURCES",
    "MachineModel",
    "TPUSpec",
    "TPU_SPECS",
    "compose_stage_parts",
    "enumerate_op_configs",
    "graph_optimize",
    "load_strategy",
    "plan_memory_bytes",
    "plan_memory_parts",
    "pp_serve_cost",
    "price_kv_swap",
    "price_plan",
    "save_strategy",
    "search_serve_plan",
    "serve_component_of",
    "simulate",
    "store_component_scales",
]
