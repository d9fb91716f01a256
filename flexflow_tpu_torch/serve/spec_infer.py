"""SpecInfer: tree-based speculative decoding (SSM draft + LLM verify).

Port of ``flexflow_tpu/serve/spec_infer.py`` (the SpecInfer ASPLOS'24
design) for greedy serving with every request in speculation mode.  Per
macro-step, per request:

1. *catch-up*: feed the tokens accepted last round into the draft model's
   (SSM's) committed cache as a plain ``BatchConfig``; the LLM's copies
   are committed by the verify step's commit descriptor instead, reusing
   the K/V computed while verifying.
2. *draft*: root = the latest token; ``depth`` beam levels of width
   ``width`` through the SSM (``TreeSearchBatchConfig``), ranked by
   cumulative draft log-probability; the nodes live in the spec buffer.
3. *verify*: the whole tree in ONE ``TreeVerifyBatchConfig`` step of the
   LLM under the tree mask, then the greedy walk from the root: the
   longest path of drafted tokens equal to the LLM's own argmax is
   accepted, plus one bonus token from the LLM.

Greedy invariant: the output equals plain incremental decoding with the
LLM, token for token, whatever the draft model.  While no request holds a
slot, a tick is the incremental manager's (admission and prompt prefill),
as in the reference; the speculative phases then sync the SSM's cache.

Left out of this slice (see ROADMAP.md): seeded-sampling verification
(a ``temperature > 0`` config raises ``NotImplementedError``), mixed
spec/non-spec rows with ``set_spec_mode`` flips and their commit flush,
preemption and recompute, ``serve_with_arrivals``, telemetry, profiling,
SLO and brownout hooks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

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

    def __init__(self, llm, ssm, gen_config: Optional[GenerationConfig] = None,
                 width: int = 2, depth: int = 3):
        super().__init__(llm, gen_config)
        if self.gen.temperature > 0.0:
            raise NotImplementedError(
                "speculative serving is greedy in this port: seeded-sampling "
                "verification is not ported yet (temperature must be <= 0)")
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

    # ------------------------------------------------------------------
    def _kv_bind(self, rid: int) -> None:
        super()._kv_bind(rid)
        self.ssm.kv.bind(rid)

    def _release_slot(self, req: SpecRequest) -> None:
        self.ssm.kv.release(req.rid, req.ssm_committed)
        super()._release_slot(req)

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
        next draft root (``seq_len - 1``).  A request whose LLM prefill ran
        on the incremental path has none of it yet: its feed is rebuilt
        from the prompt on (reference :750)."""
        if req.status is not RequestStatus.DECODING:
            return
        want = req.seq_len - 1
        if req.ssm_committed + len(req.ssm_backlog) >= want:
            return
        req.ssm_committed = 0
        req.ssm_backlog = [(self._token_at(req, p), p)
                           for p in range(len(req.prompt), want)]

    def _plain_bc(self, im, toks, reqi, pos) -> BatchConfig:
        return BatchConfig.build(toks, reqi, pos, self._seq_lens(),
                                 max_tokens=im.max_tokens,
                                 max_requests=im.max_requests,
                                 device=im.device)

    # ------------------------------------------------------------------
    # phase A: prompt prefill (both models) + SSM catch-up
    # ------------------------------------------------------------------
    def _prefill_phase(self) -> None:
        """Reference :333-433."""
        self._admit()
        while True:   # LLM prompt prefill, chunked by its token budget
            toks, reqi, pos, points = [], [], [], []
            budget = self.llm.max_tokens
            for req in self._active():
                if req.status is not RequestStatus.PREFILLING or budget <= 0:
                    continue
                st = req.prefill_offset
                take = min(budget, len(req.prompt) - st)
                toks += req.prompt[st: st + take]
                reqi += [req.slot] * take
                pos += range(st, st + take)
                req.prefill_offset += take
                budget -= take
                if req.prefill_offset == len(req.prompt):
                    points.append((len(toks) - 1, req))
            if not toks:
                break
            ids = self.llm.step(self._plain_bc(self.llm, toks, reqi, pos)
                                ).token_ids.cpu().numpy()
            self.llm_steps += 1
            for flat, req in points:
                req.status = RequestStatus.DECODING
                req.llm_committed = len(req.prompt)
                self._append_token(req, int(ids[flat]))
                self._maybe_finish(req)

        for req in self._active():
            self._ssm_sync(req)
        while True:   # SSM prompt prefill + catch-up of accepted tokens
            toks, reqi, pos = [], [], []
            budget = self.ssm.max_tokens
            for req in self._active():
                if budget <= 0:
                    break
                if req.ssm_committed < len(req.prompt):
                    st = req.ssm_committed
                    take = min(budget, len(req.prompt) - st)
                    toks += req.prompt[st: st + take]
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
            if not toks:
                break
            self.ssm.step(self._plain_bc(self.ssm, toks, reqi, pos))

    # ------------------------------------------------------------------
    # phase B: draft-tree expansion through the SSM
    # ------------------------------------------------------------------
    def _draft_phase(self) -> List[SpecRequest]:
        """Build every decoding request's tree for this round (reference
        :447); returns the requests to verify."""
        decoding = [r for r in self._active()
                    if r.status is RequestStatus.DECODING]
        if not decoding:
            return []
        p = self.ssm.max_spec_tokens
        masks = np.zeros((self.ssm.max_requests, p, p), bool)
        frontier = {}   # rid -> node indices at the current depth
        for req in decoding:
            # the LLM's committed depth is the prefix before the root
            req.llm_committed = req.seq_len - 1
            req.tree = [TokenTreeNode(req.generated[-1], -1, 0, 0.0)]
            masks[req.slot, 0, 0] = True
            frontier[req.rid] = [0]
        # feeding depth-d nodes yields depth-(d+1) children; the last
        # level is never fed (only the LLM's verify needs its K/V)
        for _ in range(self.depth):
            toks, reqi, pos, spec, points = [], [], [], [], []
            for req in decoding:
                for ni in frontier[req.rid]:
                    node = req.tree[ni]
                    toks.append(node.token)
                    reqi.append(req.slot)
                    pos.append(req.llm_committed + node.depth)
                    spec.append(ni)
                    points.append((len(toks) - 1, req, ni))
            res = self.ssm.step(self._tree_bc(
                TreeSearchBatchConfig, self.ssm, toks, reqi, pos, spec, masks,
                "ssm_committed"))
            topk_ids = res.topk_ids.cpu().numpy()
            topk_lp = res.topk_logprobs.cpu().numpy()
            cands = {req.rid: [] for req in decoding}
            for flat, req, ni in points:
                base_lp = req.tree[ni].logprob
                cands[req.rid] += [(base_lp + float(topk_lp[flat, j]),
                                    int(topk_ids[flat, j]), ni)
                                   for j in range(self.width)]
            for req in decoding:
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
                   *(torch.from_numpy(f).to(im.device) for f in fields))

    # ------------------------------------------------------------------
    # phase C: LLM tree verification + accept walk
    # ------------------------------------------------------------------
    def _verify_phase(self, verifying: List[SpecRequest]) -> None:
        """ONE LLM step over every request's tree, then the greedy walk,
        the bonus token and next round's commit (reference :579)."""
        if not verifying:
            return
        r, p = self.llm.max_requests, self.llm.max_spec_tokens
        masks = np.zeros((r, p, p), bool)
        toks, reqi, pos, spec, index_of, commit = [], [], [], [], {}, []
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
            req.pending_commit = []
        bc = self._tree_bc(TreeVerifyBatchConfig, self.llm, toks, reqi, pos,
                           spec, masks, "llm_committed", commit)
        ids = self.llm.step(bc).token_ids.cpu().numpy()
        self.llm_steps += 1

        for req in verifying:
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
            # the SSM takes the same accepted tokens into its cache
            base_pos = req.ssm_committed + len(req.ssm_backlog)
            req.ssm_backlog += [(req.tree[i].token, base_pos + k)
                                for k, i in enumerate(accepted)]
            for t in new_tokens:
                self._append_token(req, t)
                self._maybe_finish(req)
                if req.status is RequestStatus.COMPLETED:
                    break

    # ------------------------------------------------------------------
    def _tick(self) -> None:
        """A speculative macro step while any request holds a slot, else
        the incremental tick, which admits and prefills (reference
        :833)."""
        if self._active():
            self._prefill_phase()
            self._verify_phase(self._draft_phase())
            self.macro_steps += 1
        else:
            self._serve_tick()

    def serve_spec_infer(self):
        """Serve until every request completes (reference :856): the
        inherited loop with the speculative tick."""
        return self.serve_incr_decoding()
