"""flexflow_tpu_torch.search: the planner and the Unity search.

Port of ``flexflow_tpu/search``: the machine model
(:mod:`.machine_model`, with the H100's constants), the simulator
(:mod:`.simulator`: ``simulate`` and the memory estimate of a planned
PCG, training steps by default, and the serve half's stage records), the
algebraic rewrites (:mod:`.substitution`: ``GraphXfer`` rules,
``apply_match``, ``remap_params``, ``check_equivalence``), the joint
Unity MCMC search over per-op parallel configs and rewrites
(:mod:`.search`: ``enumerate_op_configs``, ``graph_optimize``), strategy
files (:mod:`.strategy`), the joint ``tp x pp x n_micro`` serve search
and its pricing (:mod:`.serve_search`: ``search_serve_plan``,
``price_plan``, ``pp_serve_cost``), and the card's measurements
(:mod:`.measure`: the machine constants and the op-cost cache
``CostCache``; they run on a CUDA device only), and the pipeline
search (:mod:`.pipeline_search`: ``chain_partition``,
``simulate_pipeline``, ``propose_pipeline``, ``pipeline_or_gspmd``),
which ``FFModel.compile`` consults on a mesh with a ``pp`` axis.
"""

from .machine_model import H100_SOURCES, TPU_SPECS, MachineModel, TPUSpec
from .measure import CostCache
from .pipeline_search import (chain_partition, pipeline_or_gspmd,
                              propose_pipeline, simulate_pipeline)
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
from .substitution import (apply_match, check_equivalence, find_all_matches,
                           remap_params, standard_rules)

__all__ = [
    "CostBreakdown",
    "CostCache",
    "H100_SOURCES",
    "MachineModel",
    "TPUSpec",
    "TPU_SPECS",
    "apply_match",
    "chain_partition",
    "check_equivalence",
    "compose_stage_parts",
    "enumerate_op_configs",
    "find_all_matches",
    "graph_optimize",
    "load_strategy",
    "pipeline_or_gspmd",
    "plan_memory_bytes",
    "plan_memory_parts",
    "pp_serve_cost",
    "price_kv_swap",
    "price_plan",
    "propose_pipeline",
    "remap_params",
    "save_strategy",
    "search_serve_plan",
    "serve_component_of",
    "simulate",
    "simulate_pipeline",
    "standard_rules",
    "store_component_scales",
]
