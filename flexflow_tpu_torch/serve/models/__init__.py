from . import llama  # noqa: F401  (registers the llama builder)
from .base import MODEL_REGISTRY, ServeModelConfig, build_model, register_model

__all__ = ["MODEL_REGISTRY", "ServeModelConfig", "build_model",
           "register_model"]
