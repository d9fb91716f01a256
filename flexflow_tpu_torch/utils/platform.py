"""Device and dtype helpers.

Every entry point of the port takes ``device=None``, which means the CUDA
card.  Without one it raises: there is no silent fall-back to the CPU.  The
CPU is used only when a caller asks for it explicitly (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flexflow_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev


def host_to_device(a, device: torch.device) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) on ``device``.  To a CUDA
    device it goes through pinned memory without blocking the host: a
    plain copy from pageable memory waits for everything queued on the
    stream, so a batch built while the card still runs would sync."""
    t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                        else a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """A dtype name as the JAX package spells it (``"bfloat16"``) ->
    ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None
