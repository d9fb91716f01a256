"""Parameters of the JAX reference -> the port's state dict.

The reference keeps serve params as ``params[node name][param name]``
(``im.params`` after ``init_operators_inference``); the port's modules
follow the same node names, so each entry becomes the state-dict key
``"<node name>.<param name>"`` with its layout unchanged.  Arrays arrive as
numpy (``np.asarray`` of each JAX array); bfloat16 goes through float32,
which represents every bfloat16 value exactly.  The int8 weights of a
reference model after ``quantize_int8`` stay int8 and their ``*_scale``
arrays float32, whatever the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.platform import resolve_device, torch_dtype
from .models.base import ServeModelConfig


def params_from_jax(params_np: Dict[str, Dict[str, np.ndarray]],
                    cfg: ServeModelConfig, device=None,
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, torch.Tensor]:
    """``{node: {name: array}}`` -> ``{"node.name": tensor}`` on
    ``device`` (None = the CUDA card) in ``dtype`` (None = the config's);
    int8 arrays stay int8 and ``*_scale`` arrays float32."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype if dtype is not None else cfg.dtype)
    out: Dict[str, torch.Tensor] = {}
    for node, group in params_np.items():
        for name, arr in group.items():
            if np.asarray(arr).dtype == np.int8:
                t = torch.from_numpy(np.array(arr, dtype=np.int8))
            elif name.endswith("_scale"):
                t = torch.from_numpy(np.array(arr, dtype=np.float32))
            else:   # a writable float32 copy, then the compute dtype
                t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dt)
            out[f"{node}.{name}"] = t.to(dev)
    return out
