"""RequestManager: request queue, continuous batching, decode stretches.

Port of ``flexflow_tpu/serve/request_manager.py`` for the incremental
path: ``Request``, ``RequestStatus``, ``GenerationConfig``,
``register_new_request``, slot admission, ``_build_next_batch`` (:1063)
with its tiled pure-prefill branch (:1086-1138) and tile-aligned prefill
chunking (:1140-), the prefill stretch (:1414), ``serve_incr_decoding``
(:2574) and ``generate`` (:2610).  A prefill stretch feeds whole prompts
as tiled steps; a pure-decode stretch is one
``InferenceManager.decode_scan``; each reads back once at its end.  The
hooks the speculative manager builds on (``request_cls``,
``_seq_len_needed``, ``_kv_bind``, ``_tick``) leave this path as it is.
Under a paged KV cache, ``_kv_bind`` is the prefix-reuse hook (a request
whose prompt prefix the page index holds starts its prefill there) and
``_kv_prepare`` maps and copy-on-writes the pages of every span a dispatch
writes before it runs (reference :1982-2011, :2120-2147); admission counts
each request's need in whole pages (``round_need``, reference :425-442),
and an exhausted pool raises ``PagePoolExhausted``.

Left out of this slice: telemetry and profiling, fault injection and
retries, SLO lanes, migration, KV spill and the host page tier,
preemption (and so page-pressure preemption), deadlines and
``serve_with_arrivals``, and the chained decode stretch with mid-stretch
joins.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .batch_config import BatchConfig, PrefillBatchConfig


class RequestStatus(enum.Enum):
    PENDING = 0
    PREFILLING = 1
    DECODING = 2
    COMPLETED = 3


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 64
    status: RequestStatus = RequestStatus.PENDING
    generated: List[int] = dataclasses.field(default_factory=list)
    prefill_offset: int = 0     # prompt tokens already fed to the model
    slot: int = -1
    # consecutive mixed steps whose tiled budget rounded this request's
    # prefill take to zero (the starvation fallback below)
    starved_steps: int = 0
    # prompt tokens a paged cache's prefix index held at admission (the
    # prefill started there)
    prefix_cached: int = 0

    @property
    def seq_len(self) -> int:
        """Tokens currently in the KV cache (after the last step)."""
        return self.prefill_offset + len(self.generated)


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    stop_on_eos: bool = True
    temperature: float = 0.0    # <= 0: exact greedy argmax
    top_p: float = 1.0
    seed: int = 0


class RequestManager:
    request_cls = Request  # subclasses (SpecInferManager) extend the record
    scan_chunk = 32        # most decode steps per stretch (one read-back)
    # mixed steps whose tiled budget rounds a prefill take to 0 before
    # the starved request takes an unaligned flat chunk
    starvation_limit = 4

    def __init__(self, im, gen_config: Optional[GenerationConfig] = None):
        self.im = im
        self.gen = gen_config or GenerationConfig()
        self.requests: Dict[int, Request] = {}
        self.pending: List[int] = []
        self.slots: List[Optional[int]] = [None] * im.max_requests
        self._next_rid = 0
        self.steps = 0
        self.tokens_decoded = 0
        self.scan_runs = 0

    # ------------------------------------------------------------------
    def _sample_for(self, points, n_rows: int):
        """The sampling argument of a step: ``(seed, temperature, top_p,
        folds)`` with ``folds[row] = (rid, index of the token to draw)``
        for each sample point ``(row, rid)``; None for greedy."""
        if self.gen.temperature <= 0.0:
            return None
        folds = np.zeros((n_rows, 2), np.int32)
        for row, rid in points:
            req = self.requests[rid]
            folds[row] = (req.rid & 0x7FFFFFFF, len(req.generated))
        return (self.gen.seed, float(self.gen.temperature),
                float(self.gen.top_p),
                torch.from_numpy(folds).to(self.im.device))

    def _seq_len_needed(self, req: Request) -> int:
        """Cache depth a request may reach (speculation adds headroom)."""
        return len(req.prompt) + req.max_new_tokens

    def _validate_request(self, req: Request) -> Optional[str]:
        if not req.prompt:
            return "empty prompt"
        if req.max_new_tokens < 0:
            return f"max_new_tokens {req.max_new_tokens} < 0"
        need = self._seq_len_needed(req)
        if need > self.im.max_seq_len:
            return (f"request needs {need} cache slots (prompt "
                    f"{len(req.prompt)} + max_new_tokens "
                    f"{req.max_new_tokens}), exceeds max_seq_len "
                    f"{self.im.max_seq_len}")
        return None

    def register_new_request(self, prompt_tokens: Sequence[int],
                             max_new_tokens: Optional[int] = None) -> int:
        """Queue a request; returns its rid.  A prompt that cannot fit the
        cache raises ``ValueError``; ``max_new_tokens=0`` completes at
        once."""
        req = self.request_cls(-1, [int(t) for t in prompt_tokens],
                               self.gen.max_new_tokens
                               if max_new_tokens is None
                               else int(max_new_tokens))
        err = self._validate_request(req)
        if err is not None:
            raise ValueError(err)
        req.rid = self._next_rid
        self._next_rid += 1
        self.requests[req.rid] = req
        if req.max_new_tokens == 0:
            req.status = RequestStatus.COMPLETED
        else:
            self.pending.append(req.rid)
        return req.rid

    # ------------------------------------------------------------------
    def _admit(self) -> None:
        """Fill free slots from the queue, first come first served, while
        the cache holds every admitted request's worst-case need counted
        in the allocator's granularity (reference :425-442)."""
        kv = self.im.kv
        committed = sum(kv.round_need(self._seq_len_needed(r))
                        for r in self._active())
        for i, occupant in enumerate(self.slots):
            if occupant is None and self.pending:
                req = self.requests[self.pending[0]]
                need = kv.round_need(self._seq_len_needed(req))
                if committed + need > kv.capacity_tokens:
                    return
                committed += need
                self.pending.pop(0)
                req.slot = i
                req.status = RequestStatus.PREFILLING
                self.slots[i] = req.rid
                self._kv_bind(req.rid)

    def _kv_bind(self, rid: int) -> None:
        """A request took a slot.  Under a paged cache this is the
        prefix-reuse hook (reference :1982): ``bind`` maps the registered
        pages the prompt matches and returns the tile-aligned cached
        offset, where the prefill starts."""
        req = self.requests[rid]
        info = self.im.kv.bind(rid, slot=req.slot, tokens=req.prompt,
                               need=self._seq_len_needed(req),
                               align=self.im.prefill_tile)
        if info and info["cached_tokens"]:
            req.prefill_offset = req.prefix_cached = info["cached_tokens"]

    def _kv_prepare(self, spans, kv=None) -> None:
        """Make the cache writable at every ``(rid, lo, hi)`` span the
        next dispatch writes, before it runs (reference :2120): a paged
        allocator maps missing pages and copy-on-writes shared ones here,
        so the table is constant while the device works; a no-op for the
        slot-contiguous allocator."""
        kv = kv if kv is not None else self.im.kv
        if kv.paged:
            for rid, lo, hi in spans:
                kv.prepare_write(rid, lo, hi)

    def _release_slot(self, req: Request) -> None:
        self.im.kv.release(req.rid, req.seq_len)
        self.slots[req.slot] = None
        req.slot = -1

    def _active(self) -> List[Request]:
        return [self.requests[rid] for rid in self.slots if rid is not None]

    def has_work(self) -> bool:
        return bool(self.pending) or any(
            r.status in (RequestStatus.PREFILLING, RequestStatus.DECODING)
            for r in self._active())

    def _seq_lens(self) -> np.ndarray:
        seq_lens = np.zeros(self.im.max_requests, np.int32)
        for req in self._active():
            seq_lens[req.slot] = req.seq_len
        return seq_lens

    # ------------------------------------------------------------------
    def prepare_next_batch(self) -> Tuple[object, List[Tuple[int, int]]]:
        """Admit, then build the next step's batch.  Returns ``(bc,
        sample_points)`` with ``sample_points = [(flat index, rid)]`` the
        slots whose output is that request's next token."""
        self._admit()
        return self._build_next_batch()

    def _build_next_batch(self):
        im = self.im
        tokens: List[int] = []
        req_idx: List[int] = []
        positions: List[int] = []
        sample_points: List[Tuple[int, int]] = []
        budget = im.max_tokens

        # decode tokens first: one per DECODING request
        for req in self._active():
            if req.status is RequestStatus.DECODING and budget > 0:
                tokens.append(req.generated[-1])
                req_idx.append(req.slot)
                positions.append(req.seq_len - 1)
                sample_points.append((len(tokens) - 1, req.rid))
                budget -= 1

        # a pure-prefill step ships tile-aligned chunks to the tiled
        # prefill kernel; mixed decode+prefill steps keep the flat layout
        tile = im.prefill_tile
        prefilling = [r for r in self._active()
                      if r.status is RequestStatus.PREFILLING]
        if (not tokens and tile > 1 and prefilling
                and all(r.prefill_offset % tile == 0 for r in prefilling)):
            segments, spans = [], []
            for req in prefilling:
                if budget < tile:
                    continue
                take = min((budget // tile) * tile,
                           len(req.prompt) - req.prefill_offset)
                start = req.prefill_offset
                segments.append(
                    (req.slot, req.prompt[start: start + take], start))
                spans.append((req.rid, start, start + take))
                req.prefill_offset += take
                req.starved_steps = 0
                budget -= -(-take // tile) * tile
                if req.prefill_offset == len(req.prompt):
                    sample_points.append((req.slot, req.rid))
            self._kv_prepare(spans)
            pbc, last_flat = PrefillBatchConfig.build(
                segments, self._seq_lens(), tile,
                max_tokens=im.max_tokens, max_requests=im.max_requests,
                device=im.device)
            return pbc, [(last_flat[slot], rid)
                         for slot, rid in sample_points]

        # then prefill chunks fill the remaining budget; mid-prompt cuts
        # keep prefill_offset tile-aligned so later pure-prefill steps can
        # take the tiled path (completing takes need no rounding)
        for req in prefilling:
            if budget <= 0:
                continue
            remaining = len(req.prompt) - req.prefill_offset
            if remaining <= budget:
                take = remaining
            elif tile > 1 and req.prefill_offset % tile == 0:
                take = (budget // tile) * tile
                if take == 0:
                    # less than a tile of budget: wait to keep alignment,
                    # unless decode tokens leave less than a tile every
                    # step — then take an unaligned flat chunk after
                    # starvation_limit dry steps so the prompt progresses
                    req.starved_steps += 1
                    if req.starved_steps < self.starvation_limit:
                        continue
                    take = budget
            else:
                take = budget
                if tile > 1 and budget >= tile:
                    # an off-tile offset blocks the tiled path for every
                    # prefilling request: round this take so the offset
                    # lands back on a tile boundary
                    over = (req.prefill_offset + take) % tile
                    if 0 < over < take:
                        take -= over
            start = req.prefill_offset
            tokens.extend(req.prompt[start: start + take])
            req_idx.extend([req.slot] * take)
            positions.extend(range(start, start + take))
            req.prefill_offset += take
            req.starved_steps = 0
            budget -= take
            if req.prefill_offset == len(req.prompt):
                sample_points.append((len(tokens) - 1, req.rid))

        written: Dict[int, Tuple[int, int]] = {}   # slot -> [lo, hi)
        for slot, p in zip(req_idx, positions):
            lo, hi = written.get(slot, (p, p + 1))
            written[slot] = (min(lo, p), max(hi, p + 1))
        self._kv_prepare([(self.slots[slot], lo, hi)
                          for slot, (lo, hi) in written.items()])
        bc = BatchConfig.build(tokens, req_idx, positions, self._seq_lens(),
                               max_tokens=im.max_tokens,
                               max_requests=im.max_requests, device=im.device)
        return bc, sample_points

    # ------------------------------------------------------------------
    def _append_token(self, req: Request, tok: int) -> None:
        req.generated.append(tok)
        self.tokens_decoded += 1

    def process_result(self, result, sample_points) -> None:
        if not sample_points:
            return   # mid-prompt step: nothing to read back
        token_ids = result.token_ids.cpu().numpy()
        for flat_idx, rid in sample_points:
            req = self.requests[rid]
            if req.status is RequestStatus.PREFILLING:
                req.status = RequestStatus.DECODING
            self._append_token(req, int(token_ids[flat_idx]))
            self._maybe_finish(req)

    def _maybe_finish(self, req: Request) -> None:
        eos = self.gen.eos_token_id
        if (len(req.generated) >= req.max_new_tokens
                or (self.gen.stop_on_eos and eos is not None
                    and req.generated[-1] == eos)):
            req.status = RequestStatus.COMPLETED
            self._release_slot(req)

    # ------------------------------------------------------------------
    def _scan_steps_possible(self) -> int:
        """Decode steps the next stretch may run on the device: > 1 only
        when nothing waits for a slot and every active request decodes;
        bounded by the largest remaining budget (each row freezes on the
        device when its own budget runs out) and the cache's room."""
        active = self._active()
        if (not active or self.pending
                or any(r.status is not RequestStatus.DECODING
                       for r in active)):
            return 0
        n = max(r.max_new_tokens - len(r.generated) for r in active)
        return min(n, self.scan_chunk,
                   self.im.max_seq_len - max(r.seq_len for r in active) + 1)

    def _prefill_stretch_possible(self) -> bool:
        """Can the whole prefill wave run as tiled steps?  True when every
        active request is prefilling at a tile-aligned offset (no decode
        latency to protect)."""
        self._admit()
        active = self._active()
        tile = self.im.prefill_tile
        return (tile > 1 and bool(active)
                and all(r.status is RequestStatus.PREFILLING
                        and r.prefill_offset % tile == 0 for r in active))

    def _prefill_stretch(self) -> None:
        """Feed every active request's remaining prompt as single-request
        tiled chunks (reference ``_prefill_stretch`` :1414, a step per
        chunk instead of one scan), then read the first tokens back once."""
        im = self.im
        tile = im.prefill_tile
        self._kv_prepare([(r.rid, r.prefill_offset, len(r.prompt))
                          for r in self._active()])
        seq = self._seq_lens()
        firsts = []   # (req, token ids of its last chunk, flat index)
        for req in self._active():
            while req.prefill_offset < len(req.prompt):
                start = req.prefill_offset
                take = min((im.max_tokens // tile) * tile,
                           len(req.prompt) - start)
                seq[req.slot] = start + take
                pbc, last_flat = PrefillBatchConfig.build(
                    [(req.slot, req.prompt[start: start + take], start)],
                    seq, tile, max_tokens=im.max_tokens,
                    max_requests=im.max_requests, device=im.device)
                req.prefill_offset += take
                done = req.prefill_offset == len(req.prompt)
                flat = last_flat[req.slot]
                res = im.step(pbc, sample=self._sample_for(
                    [(flat, req.rid)] if done else [], im.max_tokens))
                if done:
                    firsts.append((req, res.token_ids[flat]))
                self.steps += 1
        toks = torch.stack([t for _, t in firsts]).cpu().tolist()
        for (req, _), tok in zip(firsts, toks):
            req.status = RequestStatus.DECODING
            self._append_token(req, tok)
            self._maybe_finish(req)

    def _decode_stretch(self, n: int) -> None:
        """``n`` decode steps as one ``decode_scan``, one read-back."""
        im = self.im
        active = self._active()
        rids = [r.rid for r in active]
        # the stretch writes n positions per request with no host boundary
        # in between: its whole span is prepared up front
        self._kv_prepare([(r.rid, r.seq_len - 1, r.seq_len - 1 + n)
                          for r in active])
        bc = BatchConfig.build(
            [r.generated[-1] for r in active], [r.slot for r in active],
            [r.seq_len - 1 for r in active], self._seq_lens(),
            max_tokens=im.max_tokens, max_requests=im.max_requests,
            device=im.device)
        eos = self.gen.eos_token_id if self.gen.stop_on_eos else None
        allowed = np.zeros(im.max_tokens, np.int32)
        allowed[:len(active)] = [r.max_new_tokens - len(r.generated)
                                 for r in active]
        toks, live, _ = im.decode_scan(
            bc, n, eos=eos, sample=self._sample_for(enumerate(rids),
                                                    im.max_tokens),
            max_position=max(r.seq_len - 1 for r in active),
            allowed=torch.from_numpy(allowed).to(im.device))
        toks, live = toks.cpu().numpy(), live.cpu().numpy()
        for s in range(n):
            for flat, rid in enumerate(rids):
                req = self.requests[rid]
                if req.status is RequestStatus.DECODING and live[s, flat]:
                    self._append_token(req, int(toks[s, flat]))
                    self._maybe_finish(req)
        self.steps += n
        self.scan_runs += 1

    def _serve_tick(self) -> None:
        """One scheduling decision: a prefill stretch, a decode stretch,
        or one mixed step."""
        if self._prefill_stretch_possible():
            self._prefill_stretch()
            return
        n = self._scan_steps_possible()
        if n > 1:
            self._decode_stretch(n)
            return
        bc, sample_points = self.prepare_next_batch()
        rows = self.im.max_tokens
        result = self.im.step(bc, sample=self._sample_for(sample_points,
                                                          rows))
        self.process_result(result, sample_points)
        self.steps += 1

    def _tick(self) -> None:
        """One serving tick (the speculative manager overrides it)."""
        self._serve_tick()

    def serve_incr_decoding(self) -> Dict[int, List[int]]:
        """Serve until every request completes; ``{rid: tokens}``."""
        while self.has_work():
            self._tick()
        return {rid: r.generated for rid, r in self.requests.items()}

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: Optional[int] = None) -> List[List[int]]:
        rids = [self.register_new_request(p, max_new_tokens)
                for p in prompts]
        out = self.serve_incr_decoding()
        return [out[rid] for rid in rids]
