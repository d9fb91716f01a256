"""Import frontends: foreign model definitions -> FFModel graphs.

Port of ``flexflow_tpu/frontends`` (the reference's
``python/flexflow/torch`` fx tracing and ``python/flexflow/keras``):
``from_torch`` traces an ``nn.Module`` with torch.fx into the builder's
calls, and ``keras`` is the Keras-style ``Sequential`` and functional
``Model`` over ``FFModel``.  ONNX stays out of scope, as in the
reference.
"""

from . import keras
from .torch_fx import from_torch

__all__ = ["from_torch", "keras"]
