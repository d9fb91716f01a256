"""flexflow_tpu_torch.serve: LLM serving on CUDA devices.

Port of ``flexflow_tpu/serve``: incremental decoding with continuous
batching, prefill and decode through hand-written CUDA attention kernels
(slice 1), and SpecInfer tree speculative decoding, on the host
(``SpecInferManager``) and on the device (``SpecDecodeScan``), through the
hand-written tree-attention kernel (slice 2); int8 weights
(``quantize_int8``), int8 KV caches (``kv_dtype="int8"``) and paged KV
caches with copy-on-write prefix sharing (``kv_page_size``), through the
int8 and paged variants of the kernels (slice 3); the OPT, Falcon, MPT
and StarCoder families (LayerNorm, biases, learned positions, ALiBi
through the decode kernel's slopes, multi-query attention with any number
of query heads per KV head) and their HF state-dict converters (slice 5);
the request lifecycle: arrivals (``serve_with_arrivals``), cancel and
deadlines, admission control, priority and page-pressure preemption with
recompute, a host page tier that spills and restores a preempted request's
pages, and dispatch retries under a seeded fault injector (slice 6); the
reference's default serve path (slice 7): LM-head gating, the chained
decode stretch with joins at segment boundaries, seeded speculative
sampling, and the user's entry point ``LLM(model).compile(...)`` and
``llm.generate(prompts)`` with ``SSM`` drafts (``load_hf_model`` reads a
local HF checkpoint); speculation per request (mixed spec and plain rows
in one verify step, ``set_spec_mode`` flips, the commit flush, the
``spec`` arrival option, ``SpecDecodeScan``'s ``spec_mask``) and the
speculative serving of every family, ALiBi through the reference's
gather path (slice 2, rest of 5); the control plane: telemetry, the step
profiler, SLO lanes and brownout, plan health (slice 8a), live plan
migration (``MigrationController``, ``LLM.attach_migration``), the
fault-tolerant fleet router over replicas (``FleetRouter``,
``LLM.fleet``) and traffic-trace replay (``obs.replay``; slice 8b);
tensor-parallel serving on every path above (``LLM.compile(tp=N)``,
``InferenceManager(mesh=...)``, ``flexflow_tpu_torch.parallel``; slice
9a); pipeline-parallel serving (``PipelinedInferenceManager`` over a
``{"pp": p, "tp": t}`` mesh, the serve graph split by
``serve_stage_split``, micro-batch interleave, ``pp x tp``; slice 9b);
the serve planner's inputs: ``register_serve_capacities``,
``mark_gated_lm_head``, ``annotate_int8`` and the per-stage cost records
of ``build_stage_plans`` (``flexflow_tpu_torch.search``; slice 10a);
serving under any parallel strategy, ``InferenceManager(strategy=<dict> |
"search")`` and ``PipelinedInferenceManager(strategy=<dict>)``, planned by
the PCG (``flexflow_tpu_torch.core.pcg``) and run by one plan executor
(``parallel/tp.py``), with ``searched_serve_strategy`` the Unity search
over the serve graph (slice 10b-i); graphs the ``FFModel`` builder
recorded, served by the same managers (``InferenceManager(ff)``,
``build_model(ff, config, max_tokens)``; slice 11c-iii).
"""

from . import models  # noqa: F401  (registers the model builders)
from .api import LLM, SSM
from .batch_config import (
    MAX_NUM_REQUESTS,
    MAX_NUM_TOKENS,
    BatchConfig,
    InferenceResult,
    PrefillBatchConfig,
    TreeSearchBatchConfig,
    TreeVerifyBatchConfig,
)
from .convert import params_from_jax
from .inference_manager import (
    EXIT_BUDGET,
    EXIT_EOS,
    EXIT_NOT_IN_BATCH,
    EXIT_RUNNING,
    InferenceManager,
    mark_gated_lm_head,
    pick_prefill_tile,
    register_serve_capacities,
    sample_tokens,
    searched_serve_strategy,
)
from .kv_allocator import KVAllocator
from .kv_paged import (
    HostPageTier,
    HostTierCorruption,
    PagedKVAllocator,
    PagePoolExhausted,
    PageTable,
    validate_page_tile,
)
from .fleet import FleetConfig, FleetRouter, ReplicaState
from .migration import (
    MigrationConfig,
    MigrationController,
    MigrationRollback,
    build_deployment,
)
from .models.base import MODEL_REGISTRY, ServeModelConfig, build_model
from .ops import (
    IncMultiHeadSelfAttention,
    SpecIncMultiHeadSelfAttention,
    TreeIncMultiHeadSelfAttention,
    alibi_slopes,
    apply_rope,
)
from .pp import (
    PipelinedInferenceManager,
    StageCost,
    build_stage_plans,
    serve_stage_split,
)
from .quant import annotate_int8, quantize_int8
from .request_manager import (
    OUTCOMES,
    TERMINAL_STATUSES,
    GenerationConfig,
    Request,
    RequestManager,
    RequestStatus,
)
from .resilience import (
    FaultInjector,
    InjectedFault,
    ResilienceConfig,
    RetryPolicy,
    TransientServeError,
)
from .slo import (
    BrownoutConfig,
    BrownoutController,
    BrownoutLevel,
    SLOClass,
    SLOPolicy,
)
from .spec_infer import SpecInferManager, SpecRequest, TokenTreeNode
from .spec_scan import SpecDecodeScan
from .weights import CONVERTERS, convert_state_dict, load_hf_model

__all__ = [
    "BatchConfig",
    "PrefillBatchConfig",
    "TreeSearchBatchConfig",
    "TreeVerifyBatchConfig",
    "InferenceResult",
    "MAX_NUM_REQUESTS",
    "MAX_NUM_TOKENS",
    "InferenceManager",
    "PipelinedInferenceManager",
    "serve_stage_split",
    "build_stage_plans",
    "StageCost",
    "register_serve_capacities",
    "searched_serve_strategy",
    "mark_gated_lm_head",
    "EXIT_NOT_IN_BATCH",
    "EXIT_RUNNING",
    "EXIT_EOS",
    "EXIT_BUDGET",
    "KVAllocator",
    "PagedKVAllocator",
    "PagePoolExhausted",
    "PageTable",
    "HostPageTier",
    "HostTierCorruption",
    "validate_page_tile",
    "quantize_int8",
    "annotate_int8",
    "pick_prefill_tile",
    "sample_tokens",
    "RequestManager",
    "Request",
    "RequestStatus",
    "GenerationConfig",
    "TERMINAL_STATUSES",
    "OUTCOMES",
    "ResilienceConfig",
    "RetryPolicy",
    "FaultInjector",
    "InjectedFault",
    "TransientServeError",
    "SLOClass",
    "SLOPolicy",
    "BrownoutLevel",
    "BrownoutConfig",
    "BrownoutController",
    "SpecInferManager",
    "SpecRequest",
    "TokenTreeNode",
    "SpecDecodeScan",
    "ServeModelConfig",
    "build_model",
    "MODEL_REGISTRY",
    "IncMultiHeadSelfAttention",
    "SpecIncMultiHeadSelfAttention",
    "TreeIncMultiHeadSelfAttention",
    "alibi_slopes",
    "apply_rope",
    "params_from_jax",
    "CONVERTERS",
    "convert_state_dict",
    "load_hf_model",
    "LLM",
    "SSM",
    "MigrationController",
    "MigrationConfig",
    "MigrationRollback",
    "build_deployment",
    "FleetRouter",
    "FleetConfig",
    "ReplicaState",
]
