"""KVAllocator: the single owner of the serving KV-cache buffers.

Port of ``flexflow_tpu/serve/kv_allocator.py`` for the slot-contiguous
cache of one device: one ``[R+1, KV, S_pad, D]`` K and V buffer per
attention layer (row ``R`` is the pad tokens' scratch row), with the seq
dim rounded up to a multiple of 128 as the reference pads it
(kv_allocator.py:84,107), with ``kv_dtype="int8"`` int8 K/V plus
zero-initialised f32 ``k_scale``/``v_scale`` planes ``[R+1, KV, S_pad]``
(reference ``serve/ops.py:259-270``: an untouched position dequantizes to
0 * 0 = 0, as an fp cache's zeros), with ``max_spec_tokens > 0`` a
``[R+1, KV, max_spec_tokens, D]`` speculation-tree buffer ``sk``/``sv``
per layer in the compute dtype (reference ``serve/ops.py:271-279``), plus
the per-request attribution the RequestManager drives (``bind`` when a
request takes a slot, ``release`` on every path it leaves one) and the
no-op page and host-tier hooks the paged subclass (:mod:`.kv_paged`)
overrides.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import torch

from .ops import IncMultiHeadSelfAttention

SEQ_PAD = 128
# the committed-KV buffers (and, int8, their scale planes): what a page
# copy moves and what bytes_per_token prices
KV_BUFFER_NAMES = ("k", "v", "k_scale", "v_scale")


def padded_seq_len(max_seq_len: int) -> int:
    return -(-max_seq_len // SEQ_PAD) * SEQ_PAD


class KVAllocator:
    # slot-contiguous: one reserved max_seq_len span per slot; the paged
    # subclass flips this and overrides the page hooks below
    paged = False
    # the host page tier (paged subclass only); the manager gates every
    # swap path on ``host_tier is not None``
    host_tier = None

    def __init__(self, model: torch.nn.Module, max_requests: int,
                 max_seq_len: int, device: torch.device,
                 max_spec_tokens: int = 0, kv_dtype: Optional[str] = None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (expected "
                             "None or 'int8'; fp caches always use the "
                             "model's compute dtype)")
        self.max_requests = max_requests
        self.max_seq_len = max_seq_len
        self.max_spec_tokens = max_spec_tokens
        self.kv_dtype = kv_dtype
        self.device = device
        # (cache key, kv heads, head dim, compute dtype) per attention layer
        self.layers: List[Tuple[str, int, int, torch.dtype]] = [
            (m.name, m.num_kv_heads, m.head_dim, m.compute_dtype)
            for m in model.modules()
            if isinstance(m, IncMultiHeadSelfAttention)]
        self.state: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._bound: Set[int] = set()   # rids holding a slot

    def _buffers(self, kv: int, d: int, dt: torch.dtype):
        """{name: (shape, dtype)} of one layer's buffers."""
        r1, s_pad = self.max_requests + 1, padded_seq_len(self.max_seq_len)
        kv_dt = torch.int8 if self.kv_dtype == "int8" else dt
        out = {"k": ((r1, kv, s_pad, d), kv_dt),
               "v": ((r1, kv, s_pad, d), kv_dt)}
        if self.kv_dtype == "int8":
            out["k_scale"] = out["v_scale"] = ((r1, kv, s_pad),
                                               torch.float32)
        if self.max_spec_tokens:
            out["sk"] = out["sv"] = ((r1, kv, self.max_spec_tokens, d), dt)
        return out

    def allocate(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """(Re)allocate zeroed caches; returns the state dict."""
        self.state = None   # free the old buffers before the new ones land
        self.state = {
            name: {buf: torch.zeros(shape, dtype=dt, device=self.device)
                   for buf, (shape, dt) in self._buffers(kv, d, cdt).items()}
            for name, kv, d, cdt in self.layers}
        self._bound.clear()
        return self.state

    def allocated_bytes(self) -> int:
        """Bytes held by the cache buffers (scratch row, seq pad, scale
        planes and spec buffers included); 0 before :meth:`allocate`."""
        if not self.state:
            return 0
        return sum(t.numel() * t.element_size()
                   for bufs in self.state.values() for t in bufs.values())

    def bytes_per_token(self) -> float:
        """Committed-KV bytes one request-position costs across layers
        (int8: 1-byte values plus the two 4-byte scales), with the scratch
        row's share spread over the request rows, as the reference prices
        it (reference :164): ``bytes_per_token() * max_requests *
        max_seq_len`` is the cache without its seq padding."""
        int8 = self.kv_dtype == "int8"
        per_row = sum(
            2 * kv * (d * (1 if int8 else dt.itemsize) + (4 if int8 else 0))
            for _, kv, d, dt in self.layers)
        return float(per_row * (self.max_requests + 1) / self.max_requests)

    @property
    def capacity_tokens(self) -> int:
        """Position capacity of the slot-contiguous cache."""
        return self.max_requests * self.max_seq_len

    def round_need(self, tokens: int) -> int:
        """Admission granularity of a cache need: exact positions here;
        the paged subclass rounds up to whole pages."""
        return int(tokens)

    def page_view(self):
        """The device page table of a paged cache (None: slot-contiguous
        addressing)."""
        return None

    def bind(self, rid: int, slot: Optional[int] = None, tokens=None,
             need: Optional[int] = None, align: int = 1) -> Optional[Dict]:
        """A request took a slot.  The paged subclass also maps its pages
        and returns ``{"cached_tokens", "hit_pages"}`` for a prefix it
        already holds; nothing is ever cached here (None)."""
        self._bound.add(int(rid))
        return None

    def prepare_write(self, rid: int, lo: int, hi: int) -> None:
        """Authorise cache writes at positions ``[lo, hi)`` of ``rid``
        before the dispatch that makes them (a no-op: every slot's span
        is reserved; the paged subclass maps and copy-on-writes pages)."""
        return None

    def release(self, rid: int, tokens: int = 0) -> float:
        """The request left its slot; returns the bytes it held at its
        deepest (``tokens`` is its final cache depth: a slot-contiguous
        request only grows)."""
        self._bound.discard(int(rid))
        return int(tokens) * self.bytes_per_token()

    def attributed_rids(self) -> List[int]:
        return sorted(self._bound)

    def snapshot(self) -> Dict:
        """The cache's size and the requests bound to it (reference
        :1032, without the live-token gauges the port does not track);
        the paged subclass adds its pool and tier counters."""
        return {"capacity_tokens": self.capacity_tokens,
                "allocated_bytes": self.allocated_bytes(),
                "bound_requests": len(self._bound)}

    # ---- host-tier hooks: a slot-contiguous cache has no pages to spill,
    # so recovery from preemption stays recompute (reference :319-337)
    def attach_host_tier(self, capacity_bytes: int):
        return None

    def has_spill(self, rid: int) -> bool:
        return False

    def drop_spill(self, rid: int) -> None:
        return None
