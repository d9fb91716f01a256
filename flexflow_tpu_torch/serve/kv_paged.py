"""Paged KV cache with copy-on-write prefix sharing.

Port of ``flexflow_tpu/serve/kv_paged.py`` without its host-DRAM tier
(``HostPageTier``, spill/restore), which waits for request preemption.

* **Physical layout is unchanged.**  The caches stay the
  ``[max_requests+1, KV, S_pad, D]`` buffers (and int8 scale planes
  ``[.., S_pad]``) of :class:`~.kv_allocator.KVAllocator`; each row's seq
  axis is ``S_pad / page_size`` fixed pages, so the pool holds
  ``(R+1) * S_pad / page_size`` pages and page id ``pid`` addresses
  ``(row, slot) = divmod(pid, pages_per_row)`` in every buffer of every
  layer at once.
* **Block-table indirection.**  A host table ``int32[R+1, pages_per_row]``
  maps a row's logical page to a physical one.  The attention kernels read
  a device copy of it (:meth:`PagedKVAllocator.page_view`, uploaded once
  per dispatch after ``prepare_write``, never inside a stretch); the KV
  write paths translate (row, position) through it (``serve/ops.py``).
  Masks and positions stay logical, so the paged path gives the
  slot-contiguous path's bits.
* **On-demand pages.**  ``prepare_write(rid, lo, hi)``, called before
  every dispatch that writes, maps missing pages from the free pool;
  exhaustion raises :class:`PagePoolExhausted`.
* **Refcounted copy-on-write prefix sharing.**  Pages are keyed by a
  chained hash of the page-aligned token prefix that produced them (KV at
  a position is a function of the token prefix), plus a partial-tail entry
  for a prompt's last, unaligned page.  ``bind`` maps the longest
  registered chain into a new request's row, so requests sharing a system
  prompt prefill it once.  A write into a page another request maps, or
  into the extent an index entry vouches for, copies the page first.
  Index-only pages are evicted least recently used when the pool runs out.

Everything here is host bookkeeping (numpy) plus host-ordered device copies
(the COW page copy, the table upload).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .kv_allocator import KV_BUFFER_NAMES, KVAllocator, padded_seq_len


class PagePoolExhausted(RuntimeError):
    """No free page and nothing evictable: every page is held by a live
    request (an admission gate sized with ``round_need`` prevents it)."""


@dataclasses.dataclass(frozen=True)
class PageTable:
    """The device view of the block table a step's attention reads:
    ``table[row, logical_page] = pid``; ``divmod(pid, pages_per_row)`` is
    the physical (row, page slot) in every cache buffer."""

    table: torch.Tensor            # int32 [R+1, pages_per_row]
    page_size: int
    pages_per_row: int


class _Entry:
    """One prefix-index record: a physical page whose content is keyed by
    the token prefix that produced it; ``tokens`` is the page's token
    content, which lookups verify (the chained hash only routes them)."""

    __slots__ = ("pid", "lru", "tokens")

    def __init__(self, pid: int, lru: int, tokens: Tuple[int, ...]):
        self.pid = pid
        self.lru = lru
        self.tokens = tokens


def validate_page_tile(page_size: int, prefill_tile: int) -> None:
    """The tiled prefill path writes each tile into one page: a tile
    straddling a page boundary would split across two physical pages."""
    if page_size and page_size % prefill_tile:
        raise ValueError(
            f"kv_page_size {page_size} must be a multiple of the "
            f"prefill tile {prefill_tile} (tile-aligned block KV "
            "writes must not straddle a page boundary)")


def _common_prefix_len(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PagedKVAllocator(KVAllocator):
    """Block-table KV allocation with refcounted COW prefix sharing,
    behind :class:`~.kv_allocator.KVAllocator`'s interface."""

    paged = True

    def __init__(self, model: torch.nn.Module, max_requests: int,
                 max_seq_len: int, device: torch.device,
                 max_spec_tokens: int = 0, kv_dtype: Optional[str] = None,
                 page_size: int = 512):
        super().__init__(model, max_requests, max_seq_len, device,
                         max_spec_tokens, kv_dtype)
        # the page must tile both the logical span (max_seq_len) and the
        # 128-padded physical seq axis the buffers allocate
        s_pad = padded_seq_len(max_seq_len)
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        if max_seq_len % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_seq_len "
                f"{max_seq_len} (a request's logical span is whole pages)")
        if s_pad % page_size:
            raise ValueError(
                f"page_size {page_size} must divide the 128-lane-padded "
                f"cache seq axis {s_pad} (the physical pool is carved from "
                "the padded buffers)")
        self.page_size = int(page_size)
        self.pages_per_row = s_pad // page_size
        self.n_pages = (max_requests + 1) * self.pages_per_row
        # one page of the scratch row stays reserved: every unmapped table
        # entry points at it (reads are masked, writes are pad garbage);
        # the scratch row's other pages join the pool
        self.scratch_pid = max_requests * self.pages_per_row
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0
        self.cow_copies = 0
        self.pages_evicted = 0
        self.pages_mapped = 0
        self._init_pool()

    # ------------------------------------------------------------------
    def _init_pool(self) -> None:
        self._table = np.full((self.max_requests + 1, self.pages_per_row),
                              self.scratch_pid, np.int32)
        self._req_refs = np.zeros(self.n_pages, np.int32)
        self._idx_refs = np.zeros(self.n_pages, np.int32)
        # LIFO free pool, low pids first out (deterministic)
        self._free: List[int] = [p for p in range(self.n_pages - 1, -1, -1)
                                 if p != self.scratch_pid]
        self._slot_of: Dict[int, int] = {}
        self._chain: Dict[int, Dict] = {}
        # ("f", chain hash) -> full-page entry; ("p", chain hash, tail)
        # -> partial-tail entry, bucketed per chain hash
        self._entries: Dict[Tuple, _Entry] = {}
        self._partial_by_base: Dict[int, List[Tuple]] = {}
        self._key_of_pid: Dict[int, Tuple] = {}
        # pid -> page offsets [0, n) whose content the index vouches for:
        # a write below it by anyone copies the page first
        self._protected: Dict[int, int] = {}
        self._lru_tick = 0
        self._device_table: Optional[PageTable] = None

    def allocate(self):
        """(Re)allocate zeroed buffers and reset the pool: zeroed caches
        invalidate every indexed page's content."""
        out = super().allocate()
        self._init_pool()
        return out

    def _touch(self, key: Tuple) -> None:
        self._lru_tick += 1
        self._entries[key].lru = self._lru_tick

    def page_view(self) -> PageTable:
        """The table on the device, uploaded after a mutation (the first
        step of a dispatch) and reused until the next one."""
        if self._device_table is None:
            self._device_table = PageTable(
                torch.tensor(self._table, device=self.device),
                self.page_size, self.pages_per_row)
        return self._device_table

    # ---- pool primitives ----------------------------------------------
    def _alloc_page(self) -> int:
        if self._free:
            return self._free.pop()
        # evict the least recently used index-only page
        victims = sorted((e.lru, key) for key, e in self._entries.items()
                         if self._req_refs[e.pid] == 0)
        if not victims:
            raise PagePoolExhausted(
                f"page pool exhausted: {self.n_pages - 1} pages all held by "
                "live requests (admission should gate on round_need)")
        self._drop_entry(victims[0][1])
        self.pages_evicted += 1
        return self._free.pop()

    def _drop_entry(self, key: Tuple) -> None:
        e = self._entries.pop(key)
        if key[0] == "p":
            bucket = self._partial_by_base.get(key[1], [])
            if key in bucket:
                bucket.remove(key)
            if not bucket:
                self._partial_by_base.pop(key[1], None)
        self._key_of_pid.pop(e.pid, None)
        self._protected.pop(e.pid, None)
        self._idx_refs[e.pid] = 0
        if self._req_refs[e.pid] == 0:
            self._free.append(e.pid)

    def _map(self, slot: int, k: int, pid: int) -> None:
        self._table[slot, k] = pid
        self._req_refs[pid] += 1
        self.pages_mapped += 1
        self._device_table = None

    def _unmap(self, slot: int, k: int) -> None:
        pid = int(self._table[slot, k])
        if pid == self.scratch_pid:
            return
        self._table[slot, k] = self.scratch_pid
        self._req_refs[pid] -= 1
        if self._req_refs[pid] == 0 and self._idx_refs[pid] == 0:
            self._free.append(pid)
        self._device_table = None

    @torch.no_grad()
    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page's content (k/v and int8 scale planes) across
        every layer's buffers, in place: the COW data move."""
        ps = self.page_size
        sr, ss = divmod(src, self.pages_per_row)
        dr, ds = divmod(dst, self.pages_per_row)
        for bufs in (self.state or {}).values():
            for name in KV_BUFFER_NAMES:
                if name in bufs:
                    arr = bufs[name]
                    arr[dr, :, ds * ps:(ds + 1) * ps] = \
                        arr[sr, :, ss * ps:(ss + 1) * ps]

    # ---- the allocator interface, page-granular -----------------------
    def bind(self, rid: int, slot: Optional[int] = None, tokens=None,
             need: Optional[int] = None, align: int = 1) -> Optional[Dict]:
        """Map a request into the table, reusing every registered prefix
        page its token sequence matches (reference :539).

        ``slot``: the cache row (a bare ``bind(rid)`` only attributes);
        ``tokens``: the sequence its prefill will feed; ``align``: the
        prefill tile, to which the returned ``cached_tokens`` rounds down
        so the tiled prefill resumes tile-aligned.  Returns
        ``{"cached_tokens", "hit_pages"}``; ``cached_tokens`` is capped at
        ``len(tokens) - 1`` so the last fed position (the first token's
        sample point) is always recomputed.
        """
        super().bind(rid)
        if slot is None:
            return None
        rid, slot = int(rid), int(slot)
        self._slot_of[rid] = slot
        toks = [int(t) for t in (tokens or [])]
        ps = self.page_size
        hashes: List[int] = []
        h = 0
        for k in range(len(toks) // ps):
            h = hash((h, tuple(toks[k * ps:(k + 1) * ps])))
            hashes.append(h)
        info = {"tokens": toks, "hashes": hashes, "written_hi": 0,
                "registered": 0, "tail_done": False}
        self._chain[rid] = info

        # longest registered full-page chain, each hit verified against
        # the entry's stored tokens
        hit_pids: List[int] = []
        for k, h_k in enumerate(hashes):
            e = self._entries.get(("f", h_k))
            if e is None or e.tokens != tuple(toks[k * ps:(k + 1) * ps]):
                break
            hit_pids.append(e.pid)
        cached_pages = len(hit_pids)
        cached = cached_pages * ps
        # partial-tail extension under the last matched chain hash: the
        # entry sharing the longest token prefix with the rest of the feed
        h_base = hashes[cached_pages - 1] if cached_pages else 0
        part_pid, best_c, part_key = None, 0, None
        for key in self._partial_by_base.get(h_base, ()):
            c = _common_prefix_len(key[2], toks[cached:])
            if c > best_c:
                best_c, part_pid, part_key = c, self._entries[key].pid, key
        usable = cached + best_c
        if toks:
            usable = min(usable, len(toks) - 1)
        if align > 1:
            usable -= usable % align
        if usable <= 0:
            if toks:   # a tokenless bind (the draft cache) is not a miss
                self.prefix_misses += 1
            return {"cached_tokens": 0, "hit_pages": 0}
        # map only the pages the resumed feed reads (overlapping
        # [0, usable)); the page holding the resume point is partly re-fed
        # with equal values, copied first if contended
        n_full = min(cached_pages, -(-usable // ps))
        for k in range(n_full):
            self._map(slot, k, hit_pids[k])
            self._touch(("f", hashes[k]))
        mapped = n_full
        if part_pid is not None and usable > cached:
            self._map(slot, cached_pages, part_pid)
            self._touch(part_key)
            mapped += 1
        info["written_hi"] = usable
        self.prefix_hits += 1
        self.prefix_tokens_reused += usable
        return {"cached_tokens": usable, "hit_pages": mapped}

    def _register(self, rid: int, info: Optional[Dict]) -> None:
        """Publish ``rid``'s finished pages into the prefix index: full
        pages once their span is written, the partial tail once the whole
        fed sequence is (reference :629)."""
        if info is None:
            return
        slot = self._slot_of.get(rid)
        if slot is None:
            return
        ps = self.page_size
        wh = info["written_hi"]
        hashes = info["hashes"]
        while (info["registered"] < len(hashes)
               and (info["registered"] + 1) * ps <= wh):
            k = info["registered"]
            self._register_entry(
                ("f", hashes[k]), int(self._table[slot, k]),
                tuple(info["tokens"][k * ps:(k + 1) * ps]), ps)
            info["registered"] += 1
        n_full = len(hashes)
        tail = tuple(info["tokens"][n_full * ps:])
        if (not info["tail_done"] and tail and wh >= len(info["tokens"])
                and info["registered"] == n_full
                and n_full < self.pages_per_row):
            h_base = hashes[-1] if hashes else 0
            self._register_entry(("p", h_base, tail),
                                 int(self._table[slot, n_full]), tail,
                                 len(tail))
            info["tail_done"] = True

    def _register_entry(self, key: Tuple, pid: int,
                        tokens: Tuple[int, ...], protected: int) -> None:
        if pid == self.scratch_pid:
            return
        if key in self._entries or pid in self._key_of_pid:
            return  # same content already indexed, or page already keyed
        self._lru_tick += 1
        self._entries[key] = _Entry(pid, self._lru_tick, tokens)
        if key[0] == "p":
            self._partial_by_base.setdefault(key[1], []).append(key)
        self._key_of_pid[pid] = key
        self._idx_refs[pid] = 1
        self._protected[pid] = int(protected)

    def prepare_write(self, rid: int, lo: int, hi: int) -> None:
        """Make positions ``[lo, hi)`` of ``rid``'s row writable: map
        missing pages, copy-on-write pages another request maps or an
        index entry vouches for.  Also the registration hook: content
        below the request's write frontier is final here, before the next
        dispatch writes (reference :678)."""
        rid = int(rid)
        slot = self._slot_of.get(rid)
        info = self._chain.get(rid)
        if slot is None or hi <= lo:
            return
        self._register(rid, info)
        self.prepare_slot_span(slot, lo, hi)
        if info is not None and hi > info["written_hi"]:
            info["written_hi"] = int(hi)

    def prepare_slot_span(self, slot: int, lo: int, hi: int) -> None:
        """The slot-addressed half of :meth:`prepare_write` (no
        registration), which ``SpecDecodeScan`` calls up front for each
        slot's worst-case growth (reference :697).  A page is copied when
        another request maps it, or when the write starts inside an index
        entry's protected extent: a sole holder that matched a shorter
        prefix than the entry's must not overwrite what the index vouches
        for."""
        if hi <= lo:
            return
        ps = self.page_size
        for k in range(int(lo) // ps,
                       min((int(hi) - 1) // ps, self.pages_per_row - 1) + 1):
            pid = int(self._table[slot, k])
            if pid == self.scratch_pid:
                self._map(slot, k, self._alloc_page())
                continue
            off_lo = max(int(lo) - k * ps, 0)   # first written page offset
            protected = (self._protected.get(pid, 0)
                         if self._idx_refs[pid] else 0)
            if self._req_refs[pid] > 1 or off_lo < protected:
                dst = self._alloc_page()
                self._copy_page(pid, dst)
                self._unmap(slot, k)
                self._map(slot, k, dst)
                self.cow_copies += 1

    def release(self, rid: int, tokens: int = 0) -> float:
        """Unmap every page of the request's row after a last registration
        pass, so a finished request's shareable prefix outlives it."""
        rid = int(rid)
        info = self._chain.pop(rid, None)
        if info is not None:
            self._register(rid, info)   # before the slot mapping drops
        slot = self._slot_of.pop(rid, None)
        if slot is not None:
            for k in range(self.pages_per_row):
                self._unmap(slot, k)
        return super().release(rid, tokens)

    # ---- capacity, page-granular --------------------------------------
    @property
    def capacity_tokens(self) -> int:
        """Token capacity of the pool: every non-scratch page."""
        return (self.n_pages - 1) * self.page_size

    def round_need(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size) * self.page_size

    def pages_held(self) -> int:
        """Pages currently mapped by live requests."""
        return int((self._req_refs > 0).sum())

    def pages_shared(self) -> int:
        """Pages with more than one holder (requests and the index)."""
        return int(((self._req_refs + self._idx_refs) >= 2).sum())

    def snapshot(self) -> Dict:
        """The pool's occupancy and the prefix/COW counters (reference
        :1032, without the live-token gauges the port does not track)."""
        return {
            "page_size": self.page_size,
            "pages_total": self.n_pages - 1,
            "pages_live": self.pages_held(),
            "pages_shared": self.pages_shared(),
            "pages_free": len(self._free),
            "pages_indexed": len(self._entries),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "cow_copies": self.cow_copies,
            "pages_evicted": self.pages_evicted,
            "pages_mapped_total": self.pages_mapped,
        }
