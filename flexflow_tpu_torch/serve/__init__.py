"""flexflow_tpu_torch.serve: Llama serving on one CUDA device.

Port of ``flexflow_tpu/serve``: incremental decoding with continuous
batching, prefill and decode through hand-written CUDA attention kernels
(slice 1), and SpecInfer tree speculative decoding, on the host
(``SpecInferManager``) and on the device (``SpecDecodeScan``), through the
hand-written tree-attention kernel (slice 2).
"""

from . import models  # noqa: F401  (registers the model builders)
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
    InferenceManager,
    pick_prefill_tile,
    sample_tokens,
)
from .kv_allocator import KVAllocator
from .models.base import MODEL_REGISTRY, ServeModelConfig, build_model
from .ops import IncMultiHeadSelfAttention, apply_rope
from .request_manager import (
    GenerationConfig,
    Request,
    RequestManager,
    RequestStatus,
)
from .spec_infer import SpecInferManager, SpecRequest, TokenTreeNode
from .spec_scan import SpecDecodeScan

__all__ = [
    "BatchConfig",
    "PrefillBatchConfig",
    "TreeSearchBatchConfig",
    "TreeVerifyBatchConfig",
    "InferenceResult",
    "MAX_NUM_REQUESTS",
    "MAX_NUM_TOKENS",
    "InferenceManager",
    "KVAllocator",
    "pick_prefill_tile",
    "sample_tokens",
    "RequestManager",
    "Request",
    "RequestStatus",
    "GenerationConfig",
    "SpecInferManager",
    "SpecRequest",
    "TokenTreeNode",
    "SpecDecodeScan",
    "ServeModelConfig",
    "build_model",
    "MODEL_REGISTRY",
    "IncMultiHeadSelfAttention",
    "apply_rope",
    "params_from_jax",
]
