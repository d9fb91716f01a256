"""KVAllocator: the single owner of the serving KV-cache buffers.

Port of ``flexflow_tpu/serve/kv_allocator.py`` for the slot-contiguous
cache of one device: one ``[R+1, KV, S_pad, D]`` K and V buffer per
attention layer (row ``R`` is the pad tokens' scratch row), with the seq
dim rounded up to a multiple of 128 as the reference pads it
(kv_allocator.py:84,107), with ``max_spec_tokens > 0`` a
``[R+1, KV, max_spec_tokens, D]`` speculation-tree buffer ``sk``/``sv``
per layer in the compute dtype (reference ``serve/ops.py:271-279``), plus
the per-request attribution the
RequestManager drives (``bind`` when a request takes a slot, ``release``
on every path it leaves one).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import torch

from .ops import IncMultiHeadSelfAttention

SEQ_PAD = 128


def padded_seq_len(max_seq_len: int) -> int:
    return -(-max_seq_len // SEQ_PAD) * SEQ_PAD


class KVAllocator:
    def __init__(self, model: torch.nn.Module, max_requests: int,
                 max_seq_len: int, device: torch.device,
                 max_spec_tokens: int = 0):
        self.max_requests = max_requests
        self.max_seq_len = max_seq_len
        self.max_spec_tokens = max_spec_tokens
        self.device = device
        # (cache key, kv heads, head dim, dtype) per attention layer
        self.layers: List[Tuple[str, int, int, torch.dtype]] = [
            (m.name, m.num_kv_heads, m.head_dim, m.qkv.dtype)
            for m in model.modules()
            if isinstance(m, IncMultiHeadSelfAttention)]
        self.state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._bound: Set[int] = set()   # rids holding a slot

    def allocate(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """(Re)allocate zeroed caches; returns the state dict."""
        self.state = None   # free the old buffers before the new ones land
        s_pad = padded_seq_len(self.max_seq_len)
        lens = {"k": s_pad, "v": s_pad}    # buffer -> its seq length
        if self.max_spec_tokens:
            lens["sk"] = lens["sv"] = self.max_spec_tokens
        self.state = {
            name: {buf: torch.zeros(self.max_requests + 1, kv, n, d,
                                    dtype=dt, device=self.device)
                   for buf, n in lens.items()}
            for name, kv, d, dt in self.layers}
        self._bound.clear()
        return self.state

    def allocated_bytes(self) -> int:
        """Bytes held by the cache buffers (scratch row, seq pad and spec
        buffers included); 0 before :meth:`allocate`."""
        if not self.state:
            return 0
        return sum(t.numel() * t.element_size()
                   for bufs in self.state.values() for t in bufs.values())

    def bytes_per_token(self) -> float:
        """Committed-KV bytes one request-position costs across layers."""
        return float(sum(2 * kv * d * torch.empty((), dtype=dt).element_size()
                         for _, kv, d, dt in self.layers))

    def bind(self, rid: int) -> None:
        """A request took a slot."""
        self._bound.add(int(rid))

    def release(self, rid: int, tokens: int = 0) -> float:
        """The request left its slot; returns the bytes it held at its
        deepest (``tokens`` is its final cache depth: a slot-contiguous
        request only grows)."""
        self._bound.discard(int(rid))
        return int(tokens) * self.bytes_per_token()

    def attributed_rids(self) -> List[int]:
        return sorted(self._bound)
