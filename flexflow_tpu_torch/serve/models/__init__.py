from . import falcon, llama, mpt, opt, starcoder  # noqa: F401  (registers)
from .base import (
    MODEL_REGISTRY,
    ServeModelConfig,
    build_model,
    name_attention_layers,
    register_model,
)

__all__ = ["MODEL_REGISTRY", "ServeModelConfig", "build_model",
           "name_attention_layers", "register_model"]
