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
per layer in the compute dtype (reference ``serve/ops.py:271-279``) and,
for an ALiBi layer, the spec slots' absolute positions ``spec_pos``
int32 ``[R+1, max_spec_tokens]`` (reference :280-287).

The per-request attribution the RequestManager drives (reference
:342-402): ``bind`` when a request takes a slot, ``observe`` once a serve
tick with every live request's cache depth (per-request peaks, the live
high-water marks and the occupancy, headroom and fragmentation gauges of
``snapshot``), ``release`` on every path it leaves one, and ``teardown``
when a live migration or the fleet router retires the deployment (the
buffers drop, so the card's memory is freed); plus the no-op page and
host-tier hooks the paged subclass (:mod:`.kv_paged`) overrides.

Tensor parallelism (``parallel/tp.py``): given one model per shard and
their devices, the allocator keeps ONE host-side bookkeeping and one set
of buffers per shard (``states``), each holding that shard's KV heads of
a head-sharded layer and every head of a replicated one.  The byte
arithmetic is the reference's over its global arrays: ``bytes_per_token``
prices the global heads, and ``allocated_bytes`` counts global bytes or,
with ``per_device``, one shard's (reference :48, :146-161).

Pipeline parallelism (``serve/pp.py``): the models are the stages' shard
models, stage-major, and ``states`` holds every stage's buffers under the
one bookkeeping (the reference's per-stage ``StageKV`` under one
``KVAllocator``, :117, :186-225): ``layers`` is the union of the stages'
layers, and the paged subclass's copy-on-write, spill and restore run
over every stage's buffers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

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

    def __init__(self, models: Sequence[torch.nn.Module],
                 max_requests: int, max_seq_len: int,
                 devices: Sequence[torch.device],
                 max_spec_tokens: int = 0, kv_dtype: Optional[str] = None,
                 stages: int = 1):
        """``models`` and ``devices``: one shard model per device of the
        manager's mesh (one of each on a single device); a pipelined
        manager passes ``stages`` groups of equal size, stage-major, each
        stage's models holding only its own layers."""
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"unsupported kv_dtype {kv_dtype!r} (expected "
                             "None or 'int8'; fp caches always use the "
                             "model's compute dtype)")
        if stages < 1 or len(models) % stages:
            raise ValueError(f"{len(models)} models do not split into "
                             f"{stages} equal stages")
        self.max_requests = max_requests
        self.max_seq_len = max_seq_len
        self.max_spec_tokens = max_spec_tokens
        self.kv_dtype = kv_dtype
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.n_stages = int(stages)
        self.stage_size = len(models) // self.n_stages
        attns = [[m for m in mod.modules()
                  if isinstance(m, IncMultiHeadSelfAttention)]
                 for mod in models]
        # (cache key, kv heads, head dim, compute dtype, ALiBi) per
        # attention layer, per shard model; ``layers`` counts the global
        # heads of every layer, over the stages' first shards (reference
        # ``KVAllocator(stages)`` :186-225)
        self.shard_layers: List[List[Tuple[str, int, int, torch.dtype,
                                           bool]]] = [
            [(m.name, m.num_kv_heads, m.head_dim, m.compute_dtype,
              m.use_alibi) for m in ms] for ms in attns]
        firsts = attns[::self.stage_size]
        self.stage_layers = [
            [(m.name, m.num_kv_heads * m.head_shards, m.head_dim,
              m.compute_dtype, m.use_alibi) for m in ms] for ms in firsts]
        self.layers = [spec for ls in self.stage_layers for spec in ls]
        # how many shards hold a slice of each layer's heads
        self._head_shards = {m.name: m.head_shards
                             for ms in firsts for m in ms}
        # one state dict per shard model (None before allocate / after
        # teardown)
        self.states: Optional[List[Dict[str, Dict[str, torch.Tensor]]]] = \
            None
        self._live: Dict[int, int] = {}   # rid -> last observed cache depth
        self._peak: Dict[int, int] = {}   # rid -> deepest this binding
        self.hwm_tokens = 0
        self.hwm_bytes = 0.0

    def _buffers(self, kv: int, d: int, dt: torch.dtype, alibi: bool):
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
            if alibi:
                out["spec_pos"] = ((r1, self.max_spec_tokens), torch.int32)
        return out

    @property
    def state(self) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
        """Shard 0's state dict (the only one on a single device)."""
        return self.states[0] if self.states else None

    def allocate(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """(Re)allocate zeroed caches on every shard and forget every
        attribution; returns shard 0's state dict."""
        self.states = None   # free the old buffers before the new ones land
        self.states = [
            {name: {buf: torch.zeros(shape, dtype=dt, device=dev)
                    for buf, (shape, dt) in self._buffers(*spec).items()}
             for name, *spec in layers}
            for layers, dev in zip(self.shard_layers, self.devices)]
        self.reset_attribution()
        return self.state

    def reset_attribution(self) -> None:
        """Forget the per-request attribution and the watermarks (a new
        serving session; reference :237)."""
        self._live.clear()
        self._peak.clear()
        self.hwm_tokens = 0
        self.hwm_bytes = 0.0

    def stage_bytes(self, per_device: bool = False) -> List[int]:
        """Bytes held by each stage's cache buffers (scratch row, seq
        pad, scale planes and spec buffers included); zeros before
        :meth:`allocate`.  Global bytes, as the reference's arrays count
        (a head-sharded buffer's shards summed, a replicated one once),
        or with ``per_device`` one shard's (reference :146-161)."""
        out = []
        for s in range(self.n_stages):
            total = 0
            for name, bufs in (self.states[s * self.stage_size].items()
                               if self.states else ()):
                for buf, t in bufs.items():
                    n = t.numel() * t.element_size()
                    if not per_device and buf != "spec_pos":  # head-major
                        n *= self._head_shards[name]
                    total += n
            out.append(total)
        return out

    def allocated_bytes(self, per_device: bool = False) -> int:
        """Bytes held by the cache buffers, 0 before :meth:`allocate`:
        every stage's global bytes, or with ``per_device`` the busiest
        device's (one stage's one shard: the memory ledger's basis, the
        maximum over stages as the pipelined manager composes it,
        reference ``serve/pp.py:521-552``)."""
        parts = self.stage_bytes(per_device)
        return max(parts) if per_device else sum(parts)

    def bytes_per_token(self) -> float:
        """Committed-KV bytes one request-position costs across layers
        (int8: 1-byte values plus the two 4-byte scales), with the scratch
        row's share spread over the request rows: each buffer's bytes over
        its request rows and padded positions, summed in the reference's
        order (reference :164, per stage, then the stages' sums), so the
        float is the reference's to the bit."""
        parts = []
        for layers in self.stage_layers:
            total = 0.0
            for _, *spec in layers:
                for name, (shape, dt) in self._buffers(*spec).items():
                    if name in KV_BUFFER_NAMES:
                        total += (math.prod(shape) * dt.itemsize
                                  / (max(shape[0] - 1, 1) * shape[2]))
            parts.append(total)
        return parts[0] if len(parts) == 1 else sum(parts)

    @property
    def capacity_tokens(self) -> int:
        """Position capacity of the slot-contiguous cache."""
        return self.max_requests * self.max_seq_len

    def capacity_bytes(self) -> float:
        """Byte capacity priced at :meth:`bytes_per_token` (reference
        :271-275; token-slot units, 1.0 a token, where no price is
        known)."""
        return self.capacity_tokens * (self.bytes_per_token() or 1.0)

    def round_need(self, tokens: int) -> int:
        """Admission granularity of a cache need: exact positions here;
        the paged subclass rounds up to whole pages."""
        return int(tokens)

    def page_view(self, device: Optional[torch.device] = None):
        """The page table of a paged cache on ``device`` (None: shard
        0's); None: slot-contiguous addressing."""
        return None

    def bind(self, rid: int, slot: Optional[int] = None, tokens=None,
             need: Optional[int] = None, align: int = 1) -> Optional[Dict]:
        """A request took a slot: its attribution starts.  The paged
        subclass also maps its pages and returns ``{"cached_tokens",
        "hit_pages"}`` for a prefix it already holds; nothing is ever
        cached here (None)."""
        self._live.setdefault(int(rid), 0)
        self._peak.setdefault(int(rid), 0)
        return None

    def prepare_write(self, rid: int, lo: int, hi: int) -> None:
        """Authorise cache writes at positions ``[lo, hi)`` of ``rid``
        before the dispatch that makes them (a no-op: every slot's span
        is reserved; the paged subclass maps and copy-on-writes pages)."""
        return None

    def observe(self, usage: Dict[int, int], telemetry=None) -> Dict:
        """One serve tick's live cache depths (``rid -> tokens`` of every
        slotted prefilling or decoding request; reference :342): updates
        the per-request peaks and the watermarks, publishes the gauge set
        to a live ``telemetry`` handle (``kv_usage``), and returns the
        snapshot."""
        self._live = {int(r): int(t) for r, t in usage.items()}
        for rid, t in self._live.items():
            if t > self._peak.get(rid, 0):
                self._peak[rid] = t
        per_tok = self.bytes_per_token()
        live = sum(self._live.values())
        live_bytes = live * per_tok if per_tok else 0.0
        self.hwm_tokens = max(self.hwm_tokens, live)
        self.hwm_bytes = max(self.hwm_bytes, live_bytes)
        snap = self.snapshot(_per_tok=per_tok, _live=live)
        if telemetry is not None and getattr(telemetry, "enabled", False):
            telemetry.kv_usage(snap)
        return snap

    def snapshot(self, _per_tok: Optional[float] = None,
                 _live: Optional[int] = None) -> Dict:
        """The occupancy, headroom and fragmentation view over the last
        observed depths (reference :363-393), a pure read; the paged
        subclass adds its pool and tier counters."""
        per_tok = self.bytes_per_token() if _per_tok is None else _per_tok
        live = sum(self._live.values()) if _live is None else _live
        live_bytes = live * per_tok if per_tok else 0.0
        cap_b = self.capacity_bytes()
        bound = len(self._live)
        return {
            "live_tokens": live,
            "live_bytes": live_bytes,
            "capacity_tokens": self.capacity_tokens,
            "capacity_bytes": cap_b,
            "headroom_bytes": cap_b - (live_bytes if per_tok else live),
            "occupancy_frac": (live / self.capacity_tokens
                               if self.capacity_tokens else 0.0),
            # each bound slot reserves max_seq_len positions, of which only
            # the live prefix is occupied
            "fragmentation_frac": (
                1.0 - live / (bound * self.max_seq_len)
                if bound and self.max_seq_len else 0.0),
            "bound_slots": bound,
            "hwm_tokens": self.hwm_tokens,
            "hwm_bytes": self.hwm_bytes,
        }

    def live_tokens(self) -> int:
        return sum(self._live.values())

    def live_requests(self) -> int:
        """Slotted requests holding cache at the last observation."""
        return len(self._live)

    def release(self, rid: int, tokens: Optional[int] = None) -> float:
        """The request left its slot; returns the bytes it held at its
        deepest: the larger of its observed peak and ``tokens``, its final
        cache depth (a request can bind and finish between two
        observations).  0 for a rid that never bound."""
        rid = int(rid)
        peak = max(self._peak.pop(rid, 0), self._live.pop(rid, 0))
        if tokens is not None:
            peak = max(peak, int(tokens))
        return peak * (self.bytes_per_token() or 0.0)

    def attributed_rids(self) -> List[int]:
        return sorted(set(self._live) | set(self._peak))

    def teardown(self) -> List[int]:
        """Give up the deployment's cache (reference :423): every
        attribution left releases, the watermarks reset and the buffers
        drop (``state = None``; on the card their memory returns to the
        caching allocator at once).  Returns the rids that still held
        attribution: after a full drain every request released on its
        slot-leaving path, so a non-empty list is a leak."""
        leaked = self.attributed_rids()
        for rid in leaked:
            self.release(rid)
        self.reset_attribution()
        self.states = None
        return leaked

    # ---- host-tier hooks: a slot-contiguous cache has no pages to spill,
    # so recovery from preemption stays recompute (reference :319-337)
    def attach_host_tier(self, capacity_bytes: int):
        return None

    def has_spill(self, rid: int) -> bool:
        return False

    def drop_spill(self, rid: int) -> None:
        return None

    def adopt_spills(self, other, rids) -> int:
        return 0
