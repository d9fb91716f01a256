"""Data loading (port of ``flexflow_tpu/data``): the batching, shuffling,
prefetching :class:`DataLoader` and its native staging engine."""

from .loader import DataLoader

__all__ = ["DataLoader"]
