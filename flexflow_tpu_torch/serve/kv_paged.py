"""Paged KV cache with copy-on-write prefix sharing and a host page tier.

Port of ``flexflow_tpu/serve/kv_paged.py``.

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
  exhaustion raises :class:`PagePoolExhausted`, which the manager turns
  into page-pressure preemption when its policy allows.
* **Refcounted copy-on-write prefix sharing.**  Pages are keyed by a
  chained hash of the page-aligned token prefix that produced them (KV at
  a position is a function of the token prefix), plus a partial-tail entry
  for a prompt's last, unaligned page.  ``bind`` maps the longest
  registered chain into a new request's row, so requests sharing a system
  prompt prefill it once.  A write into a page another request maps, or
  into the extent an index entry vouches for, copies the page first.
  Index-only pages are evicted least recently used when the pool runs out.
* **The host page tier** (:class:`HostPageTier`, attached by
  ``attach_host_tier``): a preempted request's written pages ``spill`` to
  host memory and ``restore`` onto its new row at readmission, and an
  evicted full-page index entry is demoted there and promoted back by a
  later ``bind``.  Each host page carries a CRC32 chained over its blocks'
  bytes, verified before any upload; a corrupt or missing copy falls back
  to recompute.  Host blocks are CPU tensors (pinned when the cache lives
  on a CUDA device, so the copies run at the host link's rate): numpy has
  no bfloat16.
* **Tensor parallelism.**  The table, the pool and the prefix index are
  one host bookkeeping for every shard; a page id addresses the same
  (row, slot) in each shard's buffers.  Each shard's device gets its copy
  of the table; a COW copy, a spill and a restore move every shard's
  blocks of the page, and a host page carries one checksum per shard,
  every one verified before an upload.
* **Pipeline stages** (``serve/pp.py``, reference ``serve/pp.py:352-364``,
  ``kv_paged.py:522``, :775, :1082): every stage's shards are shards of
  this one bookkeeping, so one logical block table addresses every
  stage's page pool, a COW copy, a spill and a restore run over every
  stage's K/V and scale planes, and one spill page carries every stage's
  blocks (a stage's shards hold only its layers, so the checksums take
  each shard's own block count).

Everything here is host bookkeeping (numpy) plus host-ordered device copies
(the COW page copy, the table upload, the tier's page copies).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.platform import host_to_device
from .kv_allocator import KV_BUFFER_NAMES, KVAllocator, padded_seq_len


class PagePoolExhausted(RuntimeError):
    """No free page and nothing evictable: every page is held by a live
    request.  ``RequestManager._kv_prepare`` preempts a strictly
    lower-priority victim when ``ResilienceConfig.preemption`` is on;
    otherwise it propagates."""


class HostTierCorruption(RuntimeError):
    """A host-tier page failed its checksum on restore.  Not retryable
    (the host copy itself is damaged): the caller drops the entry and
    recomputes, which gives the same tokens."""


# the integer view a block's checksum reads, by element size (bf16 as
# int16, f32 as int32, int8 as itself)
_INT_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _crc(blocks: Sequence[torch.Tensor],
         shards: Union[int, Sequence[int]] = 1) -> Tuple[int, ...]:
    """One CRC32 per shard model, each chained over the bytes of that
    shard's CPU blocks in order.  The blocks are shard-major: ``shards``
    is the number of shards holding an equal count each, or each shard's
    count (a pipeline stage's shards hold only its layers)."""
    counts = ([len(blocks) // shards] * shards if isinstance(shards, int)
              else list(shards))
    out, lo = [], 0
    for n in counts:
        crc = 0
        for blk in blocks[lo:lo + n]:
            crc = zlib.crc32(blk.view(_INT_VIEW[blk.element_size()]).numpy(),
                             crc)
        out.append(crc)
        lo += n
    return tuple(out)


class _HostPage:
    """One page's content in host memory: a CPU block per KV buffer in
    :meth:`PagedKVAllocator._kv_buffers` order (shard-major), and a CRC32
    per shard chained over its blocks (``counts``: each shard's block
    count, None for equal counts), all verified on every restore."""

    __slots__ = ("blocks", "crc", "nbytes", "counts")

    def __init__(self, blocks: List[torch.Tensor], crc: Tuple[int, ...],
                 nbytes: int, counts: Optional[Sequence[int]] = None):
        self.blocks = blocks
        self.crc = crc
        self.nbytes = nbytes
        self.counts = None if counts is None else tuple(counts)

    def verify(self) -> bool:
        return _crc(self.blocks, self.counts or len(self.crc)) == self.crc

    def corrupt_for_test(self) -> None:
        """Flip one byte of the first block without updating the checksum
        (chaos-test hook: a restore must detect it and recompute)."""
        self.blocks[0].view(torch.uint8).view(-1)[0] ^= 0xFF


class _Spill:
    """A preempted request's spilled pages: logical pages ``[0,
    ceil(hi / page_size))`` of its row, the fed-token prefix that produced
    them (restore checks it against the new feed), and the write frontier
    ``hi`` the restore resumes at."""

    __slots__ = ("pages", "tokens", "hi", "nbytes", "lru")

    def __init__(self, pages: List[_HostPage], tokens: List[int], hi: int):
        self.pages = pages
        self.tokens = tokens
        self.hi = hi
        self.nbytes = sum(p.nbytes for p in pages)
        self.lru = 0


class _Demoted:
    """A prefix-index page demoted to the host tier at LRU eviction: its
    content, token identity and protected extent, so a later bind can
    promote it back as if the index had never evicted it."""

    __slots__ = ("page", "tokens", "protected", "lru")

    def __init__(self, page: _HostPage, tokens: Tuple[int, ...],
                 protected: int):
        self.page = page
        self.tokens = tokens
        self.protected = protected
        self.lru = 0


class HostPageTier:
    """Bounded host-memory pool under :class:`PagedKVAllocator`: spilled
    request pages (one ``_Spill`` per rid) and demoted index pages (one
    ``_Demoted`` per index key) under one LRU (reference :188-298).

    Storing a unit evicts least recently used units until it fits; a unit
    larger than the whole tier is refused (the caller recomputes).
    ``signature`` is the owning allocator's
    :meth:`PagedKVAllocator.swap_signature`."""

    def __init__(self, capacity_bytes: int, signature: Tuple = ()):
        self.capacity_bytes = int(capacity_bytes)
        self.signature = signature
        self.bytes_used = 0
        self.evictions = 0
        self._spills: Dict[int, _Spill] = {}
        self._demoted: Dict[Tuple, _Demoted] = {}
        self._lru_tick = 0

    def _stamp(self, unit) -> None:
        self._lru_tick += 1
        unit.lru = self._lru_tick

    def _make_room(self, need: int) -> bool:
        if need > self.capacity_bytes:
            return False
        while self.bytes_used + need > self.capacity_bytes:
            units = [(s.lru, 0, rid) for rid, s in self._spills.items()]
            units += [(d.lru, 1, key) for key, d in self._demoted.items()]
            if not units:
                return False
            _, kind, key = min(units)
            if kind == 0:
                self.drop_spill(key)
            else:
                self.drop_demoted(key)
            self.evictions += 1
        return True

    # ---- spilled requests --------------------------------------------
    def put_spill(self, rid: int, spill: _Spill) -> bool:
        self.drop_spill(rid)
        if not self._make_room(spill.nbytes):
            return False
        self._spills[int(rid)] = spill
        self.bytes_used += spill.nbytes
        self._stamp(spill)
        return True

    def get_spill(self, rid: int) -> Optional[_Spill]:
        s = self._spills.get(int(rid))
        if s is not None:
            self._stamp(s)
        return s

    def pop_spill(self, rid: int) -> Optional[_Spill]:
        s = self._spills.pop(int(rid), None)
        if s is not None:
            self.bytes_used -= s.nbytes
        return s

    def drop_spill(self, rid: int) -> None:
        self.pop_spill(rid)

    # ---- demoted index pages -----------------------------------------
    def put_demoted(self, key: Tuple, rec: _Demoted) -> bool:
        self.drop_demoted(key)
        if not self._make_room(rec.page.nbytes):
            return False
        self._demoted[key] = rec
        self.bytes_used += rec.page.nbytes
        self._stamp(rec)
        return True

    def get_demoted(self, key: Tuple) -> Optional[_Demoted]:
        d = self._demoted.get(key)
        if d is not None:
            self._stamp(d)
        return d

    def drop_demoted(self, key: Tuple) -> None:
        d = self._demoted.pop(key, None)
        if d is not None:
            self.bytes_used -= d.page.nbytes

    # ---- occupancy ----------------------------------------------------
    def pages_held(self) -> int:
        return (sum(len(s.pages) for s in self._spills.values())
                + len(self._demoted))

    def snapshot(self) -> Dict:
        return {
            "host_pages": self.pages_held(),
            "host_bytes": self.bytes_used,
            "host_capacity_bytes": self.capacity_bytes,
            "host_spilled_requests": len(self._spills),
            "host_evictions": self.evictions,
        }


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

    def __init__(self, models: Sequence[torch.nn.Module],
                 max_requests: int, max_seq_len: int,
                 devices: Sequence[torch.device],
                 max_spec_tokens: int = 0, kv_dtype: Optional[str] = None,
                 page_size: int = 512, stages: int = 1):
        super().__init__(models, max_requests, max_seq_len, devices,
                         max_spec_tokens, kv_dtype, stages)
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
        # the host tier's traffic: pages copied out and back, their bytes,
        # prefill positions a restore or promotion saved, and checksum
        # misses (each one recomputed instead)
        self.pages_spilled = 0
        self.pages_restored = 0
        self.swap_bytes = 0
        self.recompute_tokens_saved = 0
        self.restore_failures = 0
        self.host_tier: Optional[HostPageTier] = None
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
        self._device_tables: Dict[torch.device, PageTable] = {}

    def allocate(self):
        """(Re)allocate zeroed buffers and reset the pool: zeroed caches
        invalidate every indexed page's content."""
        out = super().allocate()
        self._init_pool()
        return out

    def _touch(self, key: Tuple) -> None:
        self._lru_tick += 1
        self._entries[key].lru = self._lru_tick

    def page_view(self, device: Optional[torch.device] = None) -> PageTable:
        """The table on ``device`` (None: shard 0's), uploaded after a
        mutation (the first step of a dispatch) and reused until the next
        one."""
        dev = self.device if device is None else device
        table = self._device_tables.get(dev)
        if table is None:
            table = self._device_tables[dev] = PageTable(
                host_to_device(self._table.copy(), dev),
                self.page_size, self.pages_per_row)
        return table

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
                "live requests (enable ResilienceConfig.preemption for "
                "page-pressure eviction)")
        key = victims[0][1]
        # a full-page entry is demoted to the host tier first, so a later
        # bind matching its chain promotes it back (a partial tail is one
        # sub-page of recompute, not worth a tier slot; reference :455)
        if self.host_tier is not None and key[0] == "f":
            e = self._entries[key]
            rec = _Demoted(self._read_page(e.pid), e.tokens,
                           int(self._protected.get(e.pid, self.page_size)))
            if self.host_tier.put_demoted(key, rec):
                self.pages_spilled += 1
                self.swap_bytes += rec.page.nbytes
        self._drop_entry(key)
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
        self._device_tables.clear()

    def _unmap(self, slot: int, k: int) -> None:
        pid = int(self._table[slot, k])
        if pid == self.scratch_pid:
            return
        self._table[slot, k] = self.scratch_pid
        self._req_refs[pid] -= 1
        if self._req_refs[pid] == 0 and self._idx_refs[pid] == 0:
            self._free.append(pid)
        self._device_tables.clear()

    @torch.no_grad()
    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page's content (k/v and int8 scale planes) across
        every layer's buffers, in place: the COW data move."""
        ps = self.page_size
        sr, ss = divmod(src, self.pages_per_row)
        dr, ds = divmod(dst, self.pages_per_row)
        for bufs in (b for st in self.states or () for b in st.values()):
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
            if e is None and self.host_tier is not None:
                # the index may have demoted this page to the host tier
                e = self._promote_full(
                    ("f", h_k), tuple(toks[k * ps:(k + 1) * ps]))
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

    def release(self, rid: int, tokens: Optional[int] = None) -> float:
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

    def teardown(self) -> List[int]:
        """The base teardown, then a fresh page pool and prefix index
        (reference :747): the buffers are gone, so no index entry may
        vouch for their pages, and the device page table goes too."""
        leaked = super().teardown()
        self._init_pool()
        return leaked

    # ---- host-tier spill / restore (reference :759-1012) ---------------
    def attach_host_tier(self, capacity_bytes: int) -> Optional[HostPageTier]:
        """Attach a bounded host tier of ``capacity_bytes`` (idempotent;
        0 or less detaches)."""
        if capacity_bytes and int(capacity_bytes) > 0:
            if (self.host_tier is None
                    or self.host_tier.capacity_bytes != int(capacity_bytes)):
                self.host_tier = HostPageTier(int(capacity_bytes))
        else:
            self.host_tier = None
        return self.host_tier

    def _kv_buffers(self):
        """Every committed-KV buffer, in one fixed (shard, layer, name)
        order shared by the spill copy, the restore upload and
        ``swap_signature``."""
        for state in self.states or ():
            for layer in sorted(state):
                bufs = state[layer]
                for name in sorted(n for n in bufs if n in KV_BUFFER_NAMES):
                    yield bufs, name

    def swap_signature(self) -> Tuple:
        """Page geometry plus every KV buffer's per-page block shape and
        dtype, in walk order: two allocators with equal signatures could
        exchange host pages."""
        return (self.page_size, tuple(
            (name, (int(bufs[name].shape[1]),)
             + tuple(int(d) for d in bufs[name].shape[3:]),
             str(bufs[name].dtype))
            for bufs, name in self._kv_buffers()))

    def _page_blocks(self, pid: int):
        """(buffer, its slice of physical page ``pid``) in walk order."""
        ps = self.page_size
        r, s = divmod(int(pid), self.pages_per_row)
        for bufs, name in self._kv_buffers():
            yield bufs[name][r, :, s * ps:(s + 1) * ps]

    @torch.no_grad()
    def _read_page(self, pid: int) -> _HostPage:
        """Device -> host copy of one physical page across every KV
        buffer, with its chained CRC32.  The blocks are carved from one
        host buffer (pinned for a CUDA cache); the copies are waited for
        before the checksum reads them."""
        views = list(self._page_blocks(pid))
        nbytes = sum(v.numel() * v.element_size() for v in views)
        pin = self.device.type == "cuda"
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
        blocks, off = [], 0
        for v in views:
            n = v.numel() * v.element_size()
            blk = host[off:off + n].view(v.dtype).view(v.shape)
            blk.copy_(v, non_blocking=pin)
            blocks.append(blk)
            off += n
        if pin:
            for dev in set(self.devices):
                torch.cuda.synchronize(dev)
        counts = [sum(n in KV_BUFFER_NAMES for bufs in st.values()
                      for n in bufs) for st in self.states]
        return _HostPage(blocks, _crc(blocks, counts), nbytes, counts)

    @torch.no_grad()
    def _write_page(self, pid: int, page: _HostPage) -> None:
        """Host -> device upload of one page (the inverse of
        :meth:`_read_page`), into physical page ``pid`` of every buffer."""
        for dst, blk in zip(self._page_blocks(pid), page.blocks):
            dst.copy_(blk)

    def spill(self, rid: int, tokens: Sequence[int]) -> Optional[Dict]:
        """Copy ``rid``'s written pages to the host tier, before its pages
        are released (preemption).  ``tokens`` is the fed sequence that
        produced them (prompt + generated), which restore checks against
        the readmission's feed.  Returns ``{"pages", "nbytes", "tokens"}``,
        or None when nothing spilled (no tier, nothing written, or the
        tier refused it: recompute covers the readmission)."""
        tier = self.host_tier
        rid = int(rid)
        slot = self._slot_of.get(rid)
        info = self._chain.get(rid)
        if tier is None or slot is None or info is None:
            return None
        toks = [int(t) for t in tokens]
        hi = min(int(info["written_hi"]), len(toks))
        ps = self.page_size
        pages: List[_HostPage] = []
        for k in range(-(-hi // ps)):
            pid = int(self._table[slot, k])
            if pid == self.scratch_pid:
                hi = k * ps   # an unwritten hole: recompute from here
                break
            pages.append(self._read_page(pid))
        if hi <= 0:
            return None
        rec = _Spill(pages, toks, hi)
        tier.signature = self.swap_signature()
        if not tier.put_spill(rid, rec):
            return None
        self.pages_spilled += len(pages)
        self.swap_bytes += rec.nbytes
        return {"pages": len(pages), "nbytes": rec.nbytes, "tokens": hi}

    def restore(self, rid: int, align: int = 1) -> Optional[Dict]:
        """Upload ``rid``'s spilled pages onto its rebound row, right after
        ``bind`` at readmission, above what bind's prefix hits mapped, and
        advance the write frontier.  The spill entry is consumed.

        The spilled token prefix must equal the new feed's (else the entry
        is stale and drops); every page needed is checksum-verified before
        the table changes, and a corrupt one raises
        :class:`HostTierCorruption` with the bind untouched.  Pool
        exhaustion mid-upload restores a shorter span.  Returns
        ``{"restored_tokens", "pages", "nbytes", "tokens_saved"}`` or
        None."""
        tier = self.host_tier
        rid = int(rid)
        slot = self._slot_of.get(rid)
        info = self._chain.get(rid)
        if tier is None or slot is None or info is None:
            return None
        ent = tier.get_spill(rid)
        if ent is None:
            return None
        try:
            toks = info["tokens"]
            ps = self.page_size
            # the last fed position is always recomputed: its logits are
            # the next token's sample point
            n = min(int(ent.hi), len(toks) - 1 if toks else 0)
            if align > 1:
                n -= n % align
            cur = int(info["written_hi"])
            if n <= cur or ent.tokens[:n] != toks[:n]:
                return None   # stale, or prefix hits already cover it
            k_lo, k_hi = cur // ps, (n - 1) // ps
            for k in range(k_lo, k_hi + 1):
                if not ent.pages[k].verify():
                    self.restore_failures += 1
                    raise HostTierCorruption(
                        f"rid {rid}: host page {k} failed its checksum on "
                        "restore")
            restored, pages_up, nbytes = n, 0, 0
            try:
                for k in range(k_lo, k_hi + 1):
                    pid = int(self._table[slot, k])
                    if (pid == self.scratch_pid or self._req_refs[pid] != 1
                            or self._idx_refs[pid]):
                        # unmapped, shared or indexed: upload onto a fresh
                        # private page
                        dst = self._alloc_page()
                        self._unmap(slot, k)
                        self._map(slot, k, dst)
                        pid = dst
                    self._write_page(pid, ent.pages[k])
                    pages_up += 1
                    nbytes += ent.pages[k].nbytes
            except PagePoolExhausted:
                restored = k * ps
                if align > 1:
                    restored -= restored % align
                if restored <= cur:
                    return None
            info["written_hi"] = restored
            gained = restored - cur
            self.pages_restored += pages_up
            self.swap_bytes += nbytes
            self.recompute_tokens_saved += gained
            return {"restored_tokens": restored, "pages": pages_up,
                    "nbytes": nbytes, "tokens_saved": gained}
        finally:
            tier.drop_spill(rid)

    def has_spill(self, rid: int) -> bool:
        return (self.host_tier is not None
                and int(rid) in self.host_tier._spills)

    def drop_spill(self, rid: int) -> None:
        if self.host_tier is not None:
            self.host_tier.drop_spill(rid)

    def adopt_spills(self, other, rids: Sequence[int]) -> int:
        """Move ``rids``' spills from another allocator's host tier onto
        this one (a migration's readmission, a fleet failover; reference
        :961), only when the swap signatures are equal: a reshaped
        successor recomputes instead.  A tier is attached here if there is
        none, with the source's capacity.  Returns the spills moved."""
        src = getattr(other, "host_tier", None)
        if src is None or other is self:
            return 0
        sig = self.swap_signature()
        if src.signature != sig:
            return 0
        if self.host_tier is None:
            self.host_tier = HostPageTier(src.capacity_bytes)
        self.host_tier.signature = sig
        moved = 0
        for rid in rids:
            s = src.pop_spill(int(rid))
            if s is not None and self.host_tier.put_spill(int(rid), s):
                moved += 1
        return moved

    def _promote_full(self, key: Tuple,
                      want: Tuple[int, ...]) -> Optional[_Entry]:
        """Re-register a demoted index page from the host tier (bind's
        hit scan).  Takes a free page only: evicting to make room would
        demote in turn."""
        tier = self.host_tier
        rec = tier.get_demoted(key)
        if rec is None or rec.tokens != want or not self._free:
            return None
        if not rec.page.verify():
            tier.drop_demoted(key)
            self.restore_failures += 1
            return None
        pid = self._free.pop()
        self._write_page(pid, rec.page)
        self._register_entry(key, pid, rec.tokens, rec.protected)
        e = self._entries.get(key)
        if e is None or e.pid != pid:   # registration refused
            self._free.append(pid)
            return None
        tier.drop_demoted(key)
        self.pages_restored += 1
        self.swap_bytes += rec.page.nbytes
        self.recompute_tokens_saved += self.page_size
        return e

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

    def snapshot(self, _per_tok: Optional[float] = None,
                 _live: Optional[int] = None) -> Dict:
        """The slot-contiguous snapshot with paged fragmentation and
        headroom, the pool's occupancy, the prefix/COW counters and the
        host tier's (reference :1032): fragmentation is the tail waste of
        each request's last page, and headroom the free and evictable
        pages."""
        snap = super().snapshot(_per_tok, _live)
        per_tok = snap["capacity_bytes"] / max(self.capacity_tokens, 1)
        held = self.pages_held()
        free = len(self._free)
        evictable = sum(1 for e in self._entries.values()
                        if self._req_refs[e.pid] == 0)
        snap.update({
            "fragmentation_frac": (1.0 - snap["live_tokens"]
                                   / (held * self.page_size)
                                   if held else 0.0),
            "headroom_bytes": (free + evictable) * self.page_size * per_tok,
            "page_size": self.page_size,
            "pages_total": self.n_pages - 1,
            "pages_live": held,
            "pages_shared": self.pages_shared(),
            "pages_free": free,
            "pages_indexed": len(self._entries),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "cow_copies": self.cow_copies,
            "pages_evicted": self.pages_evicted,
            "pages_mapped_total": self.pages_mapped,
            "pages_spilled": self.pages_spilled,
            "pages_restored": self.pages_restored,
            "swap_bytes": self.swap_bytes,
            "recompute_tokens_saved": self.recompute_tokens_saved,
            "restore_failures": self.restore_failures,
        })
        if self.host_tier is not None:
            snap.update(self.host_tier.snapshot())
        return snap
