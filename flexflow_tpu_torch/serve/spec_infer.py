"""SpecInfer: tree-based speculative decoding (SSM draft + LLM verify).

Port of ``flexflow_tpu/serve/spec_infer.py`` (the SpecInfer ASPLOS'24
design), greedy or seeded sampling.  Per macro-step, per request in
speculation mode:

1. *catch-up*: feed the tokens accepted last round into the draft model's
   (SSM's) committed cache as a plain ``BatchConfig``; the LLM's copies
   are committed by the verify step's commit descriptor instead, reusing
   the K/V computed while verifying.
2. *draft*: root = the latest token; ``depth`` beam levels of width
   ``width`` through the SSM (``TreeSearchBatchConfig``), ranked by
   cumulative draft log-probability; the nodes live in the spec buffer.
3. *verify*: the whole tree in ONE ``TreeVerifyBatchConfig`` step of the
   LLM under the tree mask, then the walk from the root: the longest
   path of drafted tokens equal to the LLM's own choice (its argmax, or
   with ``temperature > 0`` its seeded sample at each node) is accepted,
   plus one bonus token from the LLM.

Invariant: the output equals plain incremental decoding with the LLM,
token for token, whatever the draft model: greedy, and sampled, since a
node at tree depth d of request rid draws with the key (seed, rid,
``len(generated) + d``) the incremental loop uses for that token
(``_verify_sample``, reference :714-737), as does the prefill's first
token.  Int8 and paged caches
ride along: both allocators bind every request (the LLM's with prefix
reuse) and prepare every span a dispatch writes before it runs, the
verify step's commit destinations and the tree's span included
(reference :218, :359, :428, :610).  While no request holds a
slot, a tick is the incremental manager's (admission and prompt prefill),
as in the reference; the speculative phases then sync the SSM's cache.

The lifecycle is the incremental manager's, reaped at macro-step
boundaries: cancel, deadlines, priority and page-pressure preemption, and
dispatch retries (each phase's LLM and SSM steps run under ``_guarded``
at the reference's site names).  ``preempt`` releases both caches and
resets the speculation state; readmission re-prefills ``prompt +
generated`` into both models (reference :238, :333).

Mixed rows (reference :28-39): speculation is per request
(``register_new_request(spec=...)``, default True here, the ``spec``
arrival option, ``set_spec_mode`` at runtime).  A plain row joins the
same verify step as a root-only tree and decodes one token a macro step;
it skips the draft model, whose cache catches up from scratch when the
row flips on (``_on_spec_flip``).  While no slotted request is in spec
mode, a tick is the incremental manager's (prefill and chained decode
stretches), after ``_flush_commits`` has fed every accepted but
uncommitted position back as one plain batch (``spec_commit_flush``).
The recomputed entries are the ones the verify step's commit would have
copied, up to summation order: from the second layer on, a position's
K/V depends on which attention kernel produced the layer's input.

The KV gauges (reference :272-323) sum the target's and the draft's
allocators, with one combined watermark, published as one ``kv_usage``.

The control plane (reference :173-191): the draft shares the manager's
profiler (its dispatches count, its work is priced with its own cost card)
and records its memory under ``<plan_key>_draft``; each macro step is a
``spec_macro_step`` span, each verify a ``spec_verify_round`` span with
the batch's spec and plain rows (``spec_batch_mix``) and each spec row's
``spec_acceptance``; every phase's read-back is a ``host_sync``.  SLO
lanes and brownout come with the base manager (DEGRADE turns a row's
speculation off through ``set_spec_mode``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.platform import host_to_device
from .batch_config import (
    BatchConfig,
    TreeSearchBatchConfig,
    TreeVerifyBatchConfig,
)
from .request_manager import (
    GenerationConfig,
    Request,
    RequestManager,
    RequestStatus,
)


@dataclasses.dataclass
class TokenTreeNode:
    token: int
    parent: int          # index into the tree's node list (-1 for the root)
    depth: int
    logprob: float = 0.0  # cumulative draft log-probability along the path


@dataclasses.dataclass
class SpecRequest(Request):
    """Request + speculation bookkeeping."""

    # accepted-but-not-yet-committed (spec_index, position) pairs, copied
    # into the LLM cache by the NEXT verify step's commit descriptor
    pending_commit: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    llm_committed: int = 0   # LLM cache depth
    ssm_committed: int = 0   # SSM cache depth
    # accepted (token, position) pairs the SSM's cache has yet to take
    ssm_backlog: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    tree: List[TokenTreeNode] = dataclasses.field(default_factory=list)


class SpecInferManager(RequestManager):
    """Drives speculative serving over two InferenceManagers (SSM + LLM).

    Queue, admission and stopping come from :class:`RequestManager`; this
    class replaces the per-step tick with the three-phase macro step.
    ``width``/``depth`` bound each request's tree to ``1 + width*depth``
    nodes; the capacities are checked up front (reference :144-162).
    """

    request_cls = SpecRequest
    # requests registered with spec=None speculate (reference :111)
    default_spec_mode = True

    def __init__(self, llm, ssm, gen_config: Optional[GenerationConfig] = None,
                 width: int = 2, depth: int = 3, telemetry=None,
                 resilience=None, fault_injector=None, clock=None,
                 plan_health=None, profiler=None, slo=None, brownout=None):
        super().__init__(llm, gen_config, telemetry=telemetry,
                         resilience=resilience,
                         fault_injector=fault_injector, clock=clock,
                         plan_health=plan_health, profiler=profiler,
                         slo=slo, brownout=brownout)
        self.llm = llm
        self.ssm = ssm
        self.width = int(width)
        self.depth = int(depth)
        self.max_tree = 1 + self.width * self.depth
        if (llm.max_spec_tokens < self.max_tree
                or ssm.max_spec_tokens < self.max_tree):
            raise ValueError(
                f"spec buffers too small: need {self.max_tree} slots, have "
                f"llm={llm.max_spec_tokens} ssm={ssm.max_spec_tokens}")
        if llm.max_requests != ssm.max_requests:
            raise ValueError("LLM and SSM must agree on max_requests")
        if llm.max_tokens < llm.max_requests * self.max_tree:
            raise ValueError(
                "LLM max_tokens_per_batch must fit max_requests full trees "
                f"({llm.max_requests}x{self.max_tree})")
        if ssm.max_tokens < ssm.max_requests * self.width:
            raise ValueError(
                "SSM max_tokens_per_batch must fit one frontier per request "
                f"({ssm.max_requests}x{self.width})")
        if ssm.topk < self.width:
            raise ValueError(
                f"SSM InferenceManager needs topk >= width ({self.width})")
        self.macro_steps = 0
        self.llm_steps = 0
        # spec_commit_flush dispatches (each one plain LLM batch)
        self.flushes = 0
        # the combined (target + draft) live-token and byte watermarks
        self._kv_hwm_tokens = 0
        self._kv_hwm_bytes = 0.0
        # the draft is a co-resident deployment: it shares the profiler,
        # restarts its attribution, widens the plan-health KV view, and
        # records its memory under its own key
        ssm.profiler = self.profiler
        if self.profiler.enabled:
            self.profiler.install(ssm)
        ssm.kv.reset_attribution()
        if (self.plan_health is not None
                and self.plan_health.kv_allocator is llm.kv):
            self.plan_health.kv_allocator = [llm.kv, ssm.kv]
        if self.telemetry.enabled:
            ssm.publish_memory(self.telemetry, key=ssm.plan_key + "_draft")

    def trace_run_meta(self) -> Dict:
        """The base header plus the draft tree's shape and the draft
        deployment's engine shape (reference :194): a replay rebuilds the
        same speculation."""
        from ..obs.replay import engine_shape_of

        meta = super().trace_run_meta()
        meta["spec"] = {"width": self.width, "depth": self.depth,
                        "draft_plan": engine_shape_of(self.ssm)}
        return meta

    # ------------------------------------------------------------------
    def _kv_bind(self, rid: int) -> None:
        # the LLM's allocator reuses a cached prompt prefix; the draft's
        # binds the slot only (its catch-up feed follows its committed
        # depth, not an offset), its pages mapped by the SSM-side spans
        super()._kv_bind(rid)
        self.ssm.kv.bind(rid, slot=self.requests[rid].slot)

    def _release_slot(self, req: SpecRequest) -> None:
        """Both caches release on every slot-leaving path (reference
        :220); the request's bytes are the two bindings' sum."""
        if req.slot < 0:
            return
        draft = self.ssm.kv.release(req.rid, req.ssm_committed)
        target = self.llm.kv.release(req.rid, req.seq_len)
        self.slots[req.slot] = None
        req.slot = -1
        req.kv_bytes = max(req.kv_bytes, target + draft)

    def _combine_snaps(self, snap: Dict, snap_s: Dict) -> Dict:
        """The draft's snapshot folded into the target's (reference
        :272): summed tokens, bytes and capacity, the fractions
        recomputed, and the watermark of the summed live stream, which
        any true observation may raise."""
        for k in ("live_tokens", "live_bytes", "capacity_tokens",
                  "capacity_bytes", "headroom_bytes"):
            snap[k] += snap_s[k]
        self._kv_hwm_tokens = max(self._kv_hwm_tokens, snap["live_tokens"])
        self._kv_hwm_bytes = max(self._kv_hwm_bytes, snap["live_bytes"])
        snap["hwm_tokens"] = self._kv_hwm_tokens
        snap["hwm_bytes"] = self._kv_hwm_bytes
        snap["occupancy_frac"] = (
            snap["live_tokens"] / snap["capacity_tokens"]
            if snap["capacity_tokens"] else 0.0)
        kv_l, kv_s = self.llm.kv, self.ssm.kv
        reserved = (kv_l.live_requests() * kv_l.max_seq_len
                    + kv_s.live_requests() * kv_s.max_seq_len)
        snap["fragmentation_frac"] = (
            1.0 - snap["live_tokens"] / reserved if reserved else 0.0)
        return snap

    def kv_snapshot(self) -> Dict:
        """Both deployments' caches as one view (reference :297)."""
        return self._combine_snaps(self.llm.kv.snapshot(),
                                   self.ssm.kv.snapshot())

    def _sync_kv(self) -> None:
        """Observe both allocators (reference :305): the target at each
        live request's depth, the draft at its SSM depth."""
        live = [r for r in self._active()
                if r.status in (RequestStatus.PREFILLING,
                                RequestStatus.DECODING)]
        snap = self._combine_snaps(
            self.llm.kv.observe({r.rid: r.seq_len for r in live}),
            self.ssm.kv.observe({r.rid: r.ssm_committed for r in live}))
        if self.telemetry.enabled:
            self.telemetry.kv_usage(snap)

    def preempt(self, rid: int) -> None:
        """Preempt and recompute (reference :238): both caches release,
        the speculation state resets, and readmission re-prefills prompt +
        generated into the LLM and the SSM."""
        super().preempt(rid)
        req = self.requests[rid]
        req.pending_commit = []
        req.tree = []
        req.llm_committed = 0
        req.ssm_committed = 0
        req.ssm_backlog = []

    def _on_spec_flip(self, req: Request) -> None:
        """A runtime flip (reference :255): enabling rebuilds the draft
        cache's catch-up feed when it lags; disabling needs nothing (the
        row stops drafting next macro step, and its pending commit flows
        through the next verify step or the flush)."""
        if req.spec:
            self._ssm_sync(req)

    def _seq_len_needed(self, req: Request) -> int:
        # verification scores up to `depth` positions past the last
        # committed token, so the cache needs headroom beyond max_new
        return len(req.prompt) + req.max_new_tokens + self.depth + 1

    def _token_at(self, req: Request, p: int) -> int:
        """The token at sequence position ``p`` (prompt, then generated)."""
        return (req.prompt[p] if p < len(req.prompt)
                else req.generated[p - len(req.prompt)])

    def _ssm_sync(self, req: SpecRequest) -> None:
        """Make the SSM's catch-up feed cover every position before the
        next draft root (``seq_len - 1``).  A request that reaches the
        macro path lagging (its LLM prefill or decode ran on the
        incremental path, or it served plain rounds) has its feed rebuilt
        from scratch, a value-deterministic overwrite (reference :750)."""
        if req.status is not RequestStatus.DECODING:
            return
        want = req.seq_len - 1
        if req.ssm_committed + len(req.ssm_backlog) >= want:
            return
        req.ssm_committed = 0
        req.ssm_backlog = [(self._token_at(req, p), p)
                           for p in range(len(req.prefill_tokens), want)]

    def _host(self, *tensors: torch.Tensor):
        """A speculative phase's read-back: the tensors as numpy arrays
        in one wait, timed under the profiler's ``readback`` phase and
        counted as one ``host_sync`` (reference :375-377, :507-510,
        :649-651)."""
        with self.profiler.phase("readback"):
            out = [t.cpu().numpy() for t in tensors]
        self.profiler.host_sync()
        return out[0] if len(out) == 1 else out

    def _plain_bc(self, im, toks, reqi, pos) -> BatchConfig:
        return BatchConfig.build(toks, reqi, pos, self._seq_lens(),
                                 max_tokens=im.max_tokens,
                                 max_requests=im.max_requests,
                                 device=im.device)

    # ------------------------------------------------------------------
    # phase A: prompt prefill (both models) + SSM catch-up
    # ------------------------------------------------------------------
    def _prefill_phase(self) -> None:
        """Reference :333-433.  The feed is ``prefill_tokens``: the
        prompt, or prompt + generated after a preemption.  A dispatch that
        exhausts its retries ends the phase (its requests requeued or
        failed)."""
        self._admit()
        while True:   # LLM prefill, chunked by its token budget
            toks, reqi, pos, points, spans = [], [], [], [], []
            budget = self.llm.max_tokens
            for req in self._active():
                if req.status is not RequestStatus.PREFILLING or budget <= 0:
                    continue
                feed = req.prefill_tokens
                st = req.prefill_offset
                take = min(budget, len(feed) - st)
                toks += feed[st: st + take]
                reqi += [req.slot] * take
                pos += range(st, st + take)
                spans.append((req.rid, st, st + take))
                req.prefill_offset += take
                budget -= take
                if req.prefill_offset == len(feed):
                    points.append((len(toks) - 1, req))
            if not toks:
                break
            self._kv_prepare(spans)
            self._prof_account(spans)
            bc = self._plain_bc(self.llm, toks, reqi, pos)
            # the first token draws with the incremental loop's key
            smp = self._sample_for([(flat, req.rid) for flat, req in points],
                                   self.llm.max_tokens)
            res = self._guarded("spec_prefill",
                                lambda: self.llm.step(bc, sample=smp))
            if res is None:
                return
            self.llm_steps += 1
            ids = self._host(res.token_ids)
            for flat, req in points:
                if req.status is not RequestStatus.PREFILLING:
                    continue   # left its slot between build and read-back
                req.status = RequestStatus.DECODING
                req.llm_committed = len(req.prefill_tokens)
                self._append_token(req, int(ids[flat]))
                self._maybe_finish(req)

        # plain rows skip the draft model; a spec row may reach the macro
        # path with its draft cache behind
        for req in self._active():
            if req.spec:
                self._ssm_sync(req)
        while True:   # SSM prefill + catch-up of accepted tokens
            toks, reqi, pos, spans = [], [], [], []
            budget = self.ssm.max_tokens
            for req in self._active():
                if budget <= 0:
                    break
                if not req.spec:
                    continue
                lo = len(pos)
                feed = req.prefill_tokens
                if req.ssm_committed < len(feed):
                    st = req.ssm_committed
                    take = min(budget, len(feed) - st)
                    toks += feed[st: st + take]
                    reqi += [req.slot] * take
                    pos += range(st, st + take)
                    req.ssm_committed += take
                    budget -= take
                if req.ssm_backlog and budget > 0:
                    take = min(budget, len(req.ssm_backlog))
                    for t, p in req.ssm_backlog[:take]:
                        toks.append(t)
                        reqi.append(req.slot)
                        pos.append(p)
                    req.ssm_backlog = req.ssm_backlog[take:]
                    req.ssm_committed += take
                    budget -= take
                if len(pos) > lo:
                    spans.append((req.rid, min(pos[lo:]), max(pos[lo:]) + 1))
            if not toks:
                break
            self._kv_prepare(spans, kv=self.ssm.kv)
            self._prof_account(spans, im=self.ssm)
            bc = self._plain_bc(self.ssm, toks, reqi, pos)
            if self._guarded("spec_ssm_prefill",
                             lambda: self.ssm.step(bc)) is None:
                return

    # ------------------------------------------------------------------
    # phase B: draft-tree expansion through the SSM
    # ------------------------------------------------------------------
    def _draft_phase(self) -> List[SpecRequest]:
        """Build every decoding request's tree for this round (reference
        :447): spec rows expand ``depth`` beam levels through the SSM,
        plain rows keep a root-only tree; returns the requests to
        verify."""
        decoding = [r for r in self._active()
                    if r.status is RequestStatus.DECODING]
        if not decoding:
            return []
        p = self.ssm.max_spec_tokens
        masks = np.zeros((self.ssm.max_requests, p, p), bool)
        for req in decoding:
            # the LLM's committed depth is the prefix before the root (a
            # row that served incremental ticks resyncs here)
            req.llm_committed = req.seq_len - 1
            req.tree = [TokenTreeNode(req.generated[-1], -1, 0, 0.0)]
            masks[req.slot, 0, 0] = True
        drafting = [r for r in decoding if r.spec]
        frontier = {req.rid: [0] for req in drafting}
        # feeding depth-d nodes yields depth-(d+1) children; the last
        # level is never fed (only the LLM's verify needs its K/V)
        for _ in range(self.depth if drafting else 0):
            toks, reqi, pos, spec, points = [], [], [], [], []
            for req in drafting:
                for ni in frontier[req.rid]:
                    node = req.tree[ni]
                    toks.append(node.token)
                    reqi.append(req.slot)
                    pos.append(req.llm_committed + node.depth)
                    spec.append(ni)
                    points.append((len(toks) - 1, req, ni))
            bc = self._tree_bc(TreeSearchBatchConfig, self.ssm, toks, reqi,
                               pos, spec, masks, "ssm_committed")
            prof = self.profiler
            if prof.enabled and toks:
                per: Dict[int, int] = {}
                for _, req, _ni in points:
                    per[req.rid] = per.get(req.rid, 0) + 1
                prof.account(prof.card_for(self.ssm),
                             [(rid, c, self.requests[rid].seq_len)
                              for rid, c in per.items()])
            res = self._guarded("spec_draft", lambda: self.ssm.step(bc))
            if res is None:
                return []
            topk_ids, topk_lp = self._host(res.topk_ids, res.topk_logprobs)
            cands = {req.rid: [] for req in drafting}
            for flat, req, ni in points:
                base_lp = req.tree[ni].logprob
                cands[req.rid] += [(base_lp + float(topk_lp[flat, j]),
                                    int(topk_ids[flat, j]), ni)
                                   for j in range(self.width)]
            for req in drafting:
                nxt = []
                for lp, tok, parent in sorted(cands[req.rid],
                                              reverse=True)[: self.width]:
                    idx = len(req.tree)
                    req.tree.append(TokenTreeNode(
                        tok, parent, req.tree[parent].depth + 1, lp))
                    # ancestor mask row = the parent's row + itself
                    masks[req.slot, idx] = masks[req.slot, parent]
                    masks[req.slot, idx, idx] = True
                    nxt.append(idx)
                frontier[req.rid] = nxt
        return decoding

    def _tree_bc(self, cls, im, toks, reqi, pos, spec, masks, committed_attr,
                 commit=()):
        """A tree step's batch (reference :539): the flat tokens, their
        spec-buffer slots, the ancestor masks, each slot's committed depth
        and, for a verify step, the commit descriptor
        ``[(slot, src spec index, dst position)]``."""
        n, p = im.max_tokens, im.max_spec_tokens
        committed = np.zeros(im.max_requests, np.int32)
        for req in self._active():
            committed[req.slot] = getattr(req, committed_attr)
        si = np.zeros(n, np.int32)
        si[: len(spec)] = spec
        fields = [si, masks[:, :p, :p].copy(), committed]
        if cls is TreeVerifyBatchConfig:
            cri = np.full(n, -1, np.int32)
            csi = np.zeros(n, np.int32)
            cdp = np.zeros(n, np.int32)
            for i, (slot, src, dst) in enumerate(commit):
                cri[i], csi[i], cdp[i] = slot, src, dst
            fields += [cri, csi, cdp]
        return cls(self._plain_bc(im, toks, reqi, pos),
                   *(host_to_device(f, im.device) for f in fields))

    # ------------------------------------------------------------------
    # phase C: LLM tree verification + accept walk
    # ------------------------------------------------------------------
    def _verify_phase(self, verifying: List[SpecRequest]) -> None:
        """ONE LLM step over every request's tree, then the accept walk,
        the bonus token and next round's commit (reference :579).  A plain
        row's root-only tree accepts no child: it emits the bonus token, a
        one-token decode in the same batch."""
        if not verifying:
            return
        r, p = self.llm.max_requests, self.llm.max_spec_tokens
        masks = np.zeros((r, p, p), bool)
        toks, reqi, pos, spec, index_of, commit = [], [], [], [], {}, []
        spans = []
        for req in verifying:
            for ni, node in enumerate(req.tree):
                if node.parent >= 0:
                    masks[req.slot, ni] = masks[req.slot, node.parent]
                masks[req.slot, ni, ni] = True
                index_of[(req.rid, ni)] = len(toks)
                toks.append(node.token)
                reqi.append(req.slot)
                pos.append(req.llm_committed + node.depth)
                spec.append(ni)
            commit += [(req.slot, src, dst) for src, dst in req.pending_commit]
            if req.pending_commit:
                # the cache positions this step's commit writes (the last
                # round's accepted nodes; the spec buffer is never paged)
                dsts = [d for _, d in req.pending_commit]
                spans.append((req.rid, min(dsts), max(dsts) + 1))
            req.pending_commit = []
        self._kv_prepare(spans)
        bc = self._tree_bc(TreeVerifyBatchConfig, self.llm, toks, reqi, pos,
                           spec, masks, "llm_committed", commit)
        smp = self._verify_sample(verifying, index_of)
        prof, tel = self.profiler, self.telemetry
        if prof.enabled:
            # each row ships its whole tree (a plain row its root) and
            # reads its live prefix
            prof.account(prof.card_for(self.llm),
                         [(r.rid, len(r.tree), r.seq_len)
                          for r in verifying])
        n_spec = sum(1 for r in verifying if len(r.tree) > 1)
        n_plain = len(verifying) - n_spec
        if tel.enabled:
            tel.spec_batch_mix(n_spec, n_plain)
        with tel.span("spec_verify_round", cat="spec", track="spec",
                      n_spec=n_spec, n_plain=n_plain, tree_tokens=len(toks)):
            res = self._guarded("spec_verify",
                                lambda: self.llm.step(bc, sample=smp))
        if res is None:
            return
        self.llm_steps += 1
        ids = self._host(res.token_ids)

        for req in verifying:
            if req.status is not RequestStatus.DECODING:
                # page pressure in the prepare above preempted it (its
                # tree was reset): the readmission recomputes it
                continue
            ni, accepted = 0, [0]
            while True:
                want = int(ids[index_of[(req.rid, ni)]])
                child = next((j for j, n in enumerate(req.tree)
                              if n.parent == ni and n.token == want), None)
                if child is None:
                    bonus = want
                    break
                accepted.append(child)
                ni = child
            # the root and the accepted nodes are committed next round;
            # their tokens (the root's is already generated) are emitted
            new_tokens = [req.tree[i].token for i in accepted[1:]] + [bonus]
            for i in accepted:
                req.pending_commit.append(
                    (i, req.llm_committed + req.tree[i].depth))
            req.llm_committed += len(accepted)
            if tel.enabled and len(req.tree) > 1:
                # the drafted tokens that survived the walk this round
                tel.spec_acceptance(len(accepted) - 1, len(req.tree) - 1)
            # the SSM takes the same accepted tokens into its cache; a
            # plain row's feed is rebuilt when it flips on instead
            if req.spec:
                base_pos = req.ssm_committed + len(req.ssm_backlog)
                req.ssm_backlog += [(req.tree[i].token, base_pos + k)
                                    for k, i in enumerate(accepted)]
            for t in new_tokens:
                self._append_token(req, t)
                self._maybe_finish(req)
                if req.status is RequestStatus.COMPLETED:
                    break

    def _verify_sample(self, verifying: List[SpecRequest], index_of):
        """The verify step's sampling argument (reference :714-737): row
        ``index_of[(rid, ni)]`` draws with the fold ``(rid,
        len(generated) + depth(ni))``, the incremental loop's key for that
        token; the walk then accepts a child whose draft token equals the
        draw.  None for greedy.  A request that left ``DECODING`` since
        the batch was built (page pressure reset its tree) is skipped, as
        the walk skips it."""
        if self.gen.temperature <= 0.0:
            return None
        return self._sample_for(
            [(row, rid, self.requests[rid].tree[ni].depth)
             for (rid, ni), row in index_of.items()
             if self.requests[rid].status is RequestStatus.DECODING],
            self.llm.max_tokens)

    # ------------------------------------------------------------------
    # the spec-aware tick: the mixed macro step, or the incremental path
    # ------------------------------------------------------------------
    def _spec_live(self) -> bool:
        """Any slotted request in spec mode (reference :738).  The pending
        queue is ignored on purpose: a spec arrival waiting behind plain
        decoders must not move them onto the macro path (one token a row
        a pass) while it waits; it admits through the incremental path,
        and the next tick sees it."""
        return any(r.spec for r in self._active())

    def _flush_commits(self) -> bool:
        """Commit every accepted but uncommitted position (reference
        :770) before the tick leaves speculation: with no next verify
        step, the pending positions are fed again as plain batches under
        ``spec_commit_flush``, so the incremental step that follows sees
        the whole prefix.  Returns whether the flush completed: a fault
        past the retry budget requeues or fails only the rows of the
        failed batch, and rows a token budget deferred to a later batch
        keep their commits (the next tick retries)."""
        flush = [r for r in self._active()
                 if r.status is RequestStatus.DECODING and r.pending_commit]
        while flush:
            toks, reqi, pos, spans = [], [], [], []
            budget = self.llm.max_tokens
            for req in flush:
                if not req.pending_commit or budget <= 0:
                    continue
                take = min(budget, len(req.pending_commit))
                part = req.pending_commit[:take]
                req.pending_commit = req.pending_commit[take:]
                for _, dst in part:
                    toks.append(self._token_at(req, dst))
                    reqi.append(req.slot)
                    pos.append(dst)
                spans.append((req.rid, min(d for _, d in part),
                              max(d for _, d in part) + 1))
                budget -= take
            if not toks:
                break
            self._kv_prepare(spans)
            self._prof_account(spans)
            bc = self._plain_bc(self.llm, toks, reqi, pos)
            if self._guarded("spec_commit_flush",
                             lambda: self.llm.step(bc),
                             affected_fn=lambda: self._rids_in_batch(bc)
                             ) is None:
                return False
            self.llm_steps += 1
            self.flushes += 1
        return True

    def flush_pending_commits(self) -> bool:
        """Commit every accepted but uncommitted token now (reference
        :822), as the tick does when it leaves speculation: a migration's
        drain calls it, so a row that completes in the grace window
        finishes on a whole cache prefix."""
        return self._flush_commits()

    def _tick(self) -> None:
        """The mixed macro step while a slotted request is in spec mode
        (plain rows ride the verify batch as root-only trees); otherwise
        the pending commits flush, then the incremental tick (admission,
        prefill and chained decode stretches), so an all-plain population
        never pays for the macro path (reference :833)."""
        if self._spec_live():
            with self.telemetry.span("spec_macro_step", cat="spec",
                                     track="spec"):
                self._prefill_phase()
                self._verify_phase(self._draft_phase())
            self.macro_steps += 1
        elif self._flush_commits():
            self._serve_tick()

    def serve_spec_infer(self):
        """Serve until every request completes (reference :856): the
        inherited loop with the speculative tick."""
        return self.serve_incr_decoding()
