"""Speculative-decoding macro steps whose state stays on the device.

Port of ``flexflow_tpu/serve/spec_scan.py`` (``SpecDecodeScan``), greedy or
with seeded sampling.  ``run(carry, n_macro)`` is a Python loop of ``n_macro``
macro steps over device tensors with no read-back to the host inside it,
as slice 1's ``InferenceManager.decode_scan``; each macro step is

1. *SSM catch-up*: the previous step's accepted tokens go into the draft
   model's committed cache (one plain ``BatchConfig`` of R*(depth+1)
   slots);
2. *draft*: ``depth`` beam levels through the SSM (``TreeSearchBatchConfig``
   of R*width slots, the root level R); per level the global top-``width``
   candidates by cumulative log-probability become the next frontier, so
   node indices are the same every step (root 0, then ``width`` per level);
3. *verify*: one LLM ``TreeVerifyBatchConfig`` step of exactly R*P tokens
   in the fixed ``[R, P]`` layout (the batched tree kernel: each request's
   committed cache streams once), whose commit descriptor first copies the
   previous step's accepted nodes from the spec buffer into the cache.
   The layout rides on the batch (``tree_layout``): the port runs eagerly,
   so nothing binds a manager to one tree shape as the reference's jitted
   step does (its ``tree_token_layout``, inference_manager.py:422);
4. *accept walk*: the root-down walk (against the LLM's argmax, or its
   seeded draws), the per-slot budget cut, the EOS cut, and the next
   step's commit and catch-up bookkeeping.

``run(..., sample=(seed, temperature, top_p))`` samples the verify step:
node j of slot r draws with the fold ``(r, macro step * n_tree + j)``
through ``fold_uniform``, the macro-step counter riding in the carry
(``macro_ctr``), as the reference folds its key per macro step (:184),
so windows of ``run`` never replay a key.  The streams are seeded and
deterministic; like the reference's, they are not the incremental path's
sampled streams, whose keys follow (rid, token index).  ``temperature <=
0`` is the greedy path.

Emissions are ``-1`` where a slot emits nothing.  A slot whose budget runs
out, or that emits the EOS token, freezes (``finished``), and its
``exit_code`` says why.  Int8 and paged caches work as on the host path;
with a paged cache, ``run`` maps (and copy-on-writes) up front every page
each live slot's worst-case growth can reach, since committed depths
advance on the device (reference spec_scan.py:224-242), and the caller
keeps each slot's prompt pages mapped (the request stays bound to its
slot while the scan runs).

Mixed slots (reference :147-195): ``init_carry(spec_mask=...)`` marks
each slot's speculation mode.  A plain slot drafts nothing (its frontier
ships as pads), verifies a root-only tree (its nodes past the root are
pads of its kernel row, with an empty mask) and accepts no child, so it
decodes one token a macro step in the same verify batch.  It still rides
the SSM catch-up feed, so a flip on the host between ``run`` windows
needs no rebuild.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .batch_config import (
    BatchConfig,
    TreeSearchBatchConfig,
    TreeVerifyBatchConfig,
)
# why a slot froze (EXIT_NOT_IN_BATCH: finished before this window began)
from .inference_manager import (
    EXIT_BUDGET,
    EXIT_EOS,
    EXIT_NOT_IN_BATCH,
    EXIT_RUNNING,
)

# "no budget" sentinel: far above any reachable emission count
_NO_BUDGET = 2 ** 30


def _i32(values, device) -> torch.Tensor:
    return torch.tensor(list(values), dtype=torch.int32, device=device)


class SpecDecodeScan:
    """Runs speculative macro steps on the device for up to
    ``max_requests`` slots over an LLM and an SSM InferenceManager (their
    caches hold each slot's prompt and agree in depth)."""

    def __init__(self, llm, ssm, width: int = 2, depth: int = 3,
                 eos_token_id: Optional[int] = None):
        self.llm = llm
        self.ssm = ssm
        self.width = int(width)
        self.depth = int(depth)
        self.eos = eos_token_id
        self.n_tree = 1 + self.width * self.depth
        if getattr(llm, "pp", 1) > 1 or getattr(ssm, "pp", 1) > 1:
            raise ValueError(
                "SpecDecodeScan runs one program per macro step; a "
                "pipelined (pp > 1) manager speculates through the host "
                "SpecInferManager (reference serve/pp.py:221-224)")
        r = llm.max_requests
        if ssm.max_requests != r:
            raise ValueError("LLM and SSM must agree on max_requests")
        if (llm.max_spec_tokens < self.n_tree
                or ssm.max_spec_tokens < self.n_tree):
            raise ValueError(
                f"spec buffers too small: need {self.n_tree}, have "
                f"llm={llm.max_spec_tokens} ssm={ssm.max_spec_tokens}")
        if ssm.topk < self.width:
            raise ValueError(f"SSM needs topk >= width ({self.width})")
        self.dev = llm.device
        # constant index tensors, made once: a host-to-device copy inside
        # the loop would wait for the work queued before it
        w, d, p = self.width, self.depth, self.n_tree
        # node slots of each level's frontier: the root, then `width`
        # nodes per level
        self._frontier = [slice(0, 1)] + [
            slice(1 + lvl * w, 1 + (lvl + 1) * w) for lvl in range(d - 1)]
        self._frontier_spec = [_i32(list(range(f.start, f.stop)) * r,
                                    self.dev) for f in self._frontier]
        self._node_depth = _i32([0] + [lvl for lvl in range(1, d + 1)
                                       for _ in range(w)], self.dev)
        self._verify_spec = _i32(list(range(p)) * r, self.dev)
        # a verify row's fold before the macro-step term: (slot, node)
        self._verify_fold = torch.stack(
            [torch.arange(r, device=self.dev).repeat_interleave(p),
             torch.arange(p, device=self.dev).repeat(r)], 1).to(torch.int32)

    # ------------------------------------------------------------------
    def init_carry(self, root_tokens: Sequence[int],
                   llm_committed: Sequence[int],
                   ssm_committed: Sequence[int], finished: Sequence[bool],
                   spec_mask: Optional[Sequence[bool]] = None,
                   budget: Optional[Sequence[int]] = None
                   ) -> Dict[str, torch.Tensor]:
        """The loop state from host bookkeeping after prefill (reference
        :147).  ``root_tokens[r]``: slot r's last generated token;
        ``llm_committed``/``ssm_committed``: its committed cache depths;
        ``finished``: slots that emit and write nothing; ``spec_mask[r]``:
        slot r speculates (None: every slot), else it decodes one token a
        macro step; ``budget[r]``: tokens slot r may still emit (None: no
        limit)."""
        r, d = self.llm.max_requests, self.depth
        if spec_mask is None:
            spec_mask = [True] * r
        if budget is None:
            budget = [_NO_BUDGET] * r
        fin = torch.tensor(list(finished), dtype=torch.bool, device=self.dev)
        zeros = torch.zeros((r, d + 1), dtype=torch.int32, device=self.dev)
        return dict(
            root=_i32(root_tokens, self.dev),
            llm_comm=_i32(llm_committed, self.dev),
            ssm_comm=_i32(ssm_committed, self.dev),
            commit_src=zeros.clone(), commit_dst=zeros.clone(),
            commit_n=zeros[:, 0].clone(), backlog_tok=zeros.clone(),
            backlog_n=zeros[:, 0].clone(), finished=fin,
            spec=torch.tensor(list(spec_mask), dtype=torch.bool,
                              device=self.dev),
            budget=_i32(budget, self.dev),
            macro_ctr=torch.zeros((), dtype=torch.int32, device=self.dev),
            exit_code=torch.where(fin, EXIT_NOT_IN_BATCH,
                                  EXIT_RUNNING).to(torch.int32))

    @torch.no_grad()
    def run(self, carry: Dict[str, torch.Tensor], n_macro: int,
            sample=None):
        """``n_macro`` macro steps.  Returns ``(emitted i32[n_macro, R,
        depth+1], carry)``.  One read-back before the loop checks that no
        live slot can pass ``max_seq_len`` (each slot grows at most
        ``depth+1`` per step and ``budget + depth`` in all) and, for a
        paged cache, prepares the pages of that growth.  ``sample``:
        ``(seed, temperature, top_p)``, seeded sampling of the verify
        step (None, or ``temperature <= 0``: greedy)."""
        if sample is not None and sample[1] <= 0.0:
            sample = None
        d = self.depth
        grow = torch.clamp(carry["budget"].long() + d,
                           max=n_macro * (d + 1))
        live = ~carry["finished"]
        for im, key in ((self.llm, "llm_comm"), (self.ssm, "ssm_comm")):
            reach = torch.where(live, carry[key].long() + grow + d, 0)
            worst = int(reach.max()) if reach.numel() else 0
            if worst > im.max_seq_len:
                raise ValueError(
                    f"n_macro={n_macro} could reach position {worst} > "
                    f"max_seq_len {im.max_seq_len}")
            if im.kv.paged:
                # the table stays constant inside the loop
                for slot, (lo, hi) in enumerate(zip(
                        carry[key].tolist(), reach.tolist())):
                    if hi:
                        im.kv.prepare_slot_span(slot, lo, hi)
        emitted = []
        for _ in range(n_macro):
            carry, e = self._macro_body(carry, sample)
            emitted.append(e)
        return torch.stack(emitted), carry

    # ------------------------------------------------------------------
    def _macro_body(self, c, sample=None):
        """One macro step on device tensors (reference :264)."""
        r, w, d, p = (self.llm.max_requests, self.width, self.depth,
                      self.n_tree)
        dev = self.dev
        fin = c["finished"]
        smask = c["spec"]
        slot = torch.arange(r, dtype=torch.int32, device=dev)
        kk = torch.arange(d + 1, dtype=torch.int32, device=dev)[None, :]

        # ---- 1. SSM catch-up: the previous step's accepted tokens ----
        nb = torch.where(fin, 0, c["backlog_n"])
        valid = kk < nb[:, None]                                 # [R, D+1]
        self.ssm.run_step(BatchConfig(
            tokens=torch.where(valid, c["backlog_tok"], 0).reshape(-1),
            request_index=torch.where(valid, slot[:, None], -1).reshape(-1),
            token_position=(c["ssm_comm"][:, None] + kk).reshape(-1),
            num_tokens=valid.sum().to(torch.int32),
            seq_lens=c["ssm_comm"] + nb))
        ssm_comm = c["ssm_comm"] + nb

        # ---- 2. draft: beam levels with fixed node indices ----
        tok = torch.zeros((r, p), dtype=torch.int32, device=dev)
        tok[:, 0] = c["root"]
        par = torch.full((r, p), -1, dtype=torch.int32, device=dev)
        cumlp = torch.zeros((r, p), dtype=torch.float32, device=dev)
        amask = torch.zeros((r, p, p), dtype=torch.bool, device=dev)
        amask[:, 0, 0] = True
        # a plain slot's frontier ships as pads: no writes, no candidates
        reqi_d = torch.where(fin | ~smask, -1, slot)
        for lvl in range(d):
            fs = self._frontier[lvl]
            f = fs.stop - fs.start
            res = self.ssm.run_step(TreeSearchBatchConfig(
                base=BatchConfig(
                    tokens=tok[:, fs].reshape(-1),
                    request_index=reqi_d[:, None].expand(r, f).reshape(-1),
                    token_position=(ssm_comm + lvl)[:, None].expand(
                        r, f).reshape(-1),
                    num_tokens=(reqi_d >= 0).sum().to(torch.int32) * f,
                    seq_lens=ssm_comm),
                spec_index=self._frontier_spec[lvl],
                ancestor_mask=self._pad_mask(amask,
                                             self.ssm.max_spec_tokens),
                committed_lens=ssm_comm))
            k_ids = res.topk_ids.reshape(r, f, -1)[:, :, :w]
            k_lp = res.topk_logprobs.reshape(r, f, -1)[:, :, :w]
            cand_lp = (cumlp[:, fs][:, :, None] + k_lp).reshape(r, f * w)
            sel_lp, sel = cand_lp.topk(w, dim=1)                 # [R, W]
            sel_par = (sel // w + fs.start).to(torch.int32)
            n0 = 1 + lvl * w
            tok[:, n0: n0 + w] = k_ids.reshape(r, f * w).gather(1, sel)
            par[:, n0: n0 + w] = sel_par
            cumlp[:, n0: n0 + w] = sel_lp
            # child mask row = the parent's row + its own bit
            rows = amask[torch.arange(r, device=dev)[:, None],
                         sel_par.long()]                          # [R, W, P]
            rows[:, torch.arange(w, device=dev),
                 torch.arange(n0, n0 + w, device=dev)] = True
            amask[:, n0: n0 + w] = rows

        # ---- 3. LLM verify, after the previous step's commit ----
        # a plain slot ships its root only: its other nodes are pads
        node_ok = smask[:, None] | (torch.arange(p, device=dev) == 0)[None]
        reqi_v = torch.where(fin[:, None] | ~node_ok, -1, slot[:, None])
        commit_valid = kk < torch.where(fin, 0, c["commit_n"])[:, None]
        smp = None
        if sample is not None:
            folds = self._verify_fold.clone()
            folds[:, 1] += c["macro_ctr"] * p
            smp = (*sample, folds)
        res_v = self.llm.run_step(TreeVerifyBatchConfig(
            base=BatchConfig(
                tokens=tok.reshape(-1),
                request_index=reqi_v.reshape(-1),
                token_position=(c["llm_comm"][:, None]
                                + self._node_depth[None, :]).reshape(-1),
                num_tokens=(reqi_v >= 0).sum().to(torch.int32),
                seq_lens=c["llm_comm"]),
            spec_index=self._verify_spec,
            ancestor_mask=self._pad_mask(amask, self.llm.max_spec_tokens),
            committed_lens=c["llm_comm"],
            commit_request_index=torch.where(
                commit_valid, slot[:, None], -1).reshape(-1),
            commit_src_spec_index=torch.where(
                commit_valid, c["commit_src"], 0).reshape(-1),
            commit_dst_position=torch.where(
                commit_valid, c["commit_dst"], 0).reshape(-1),
            tree_layout=(r, p)), smp)
        ids2 = res_v.token_ids.reshape(r, p)

        # ---- 4. accept walk ----
        ni = torch.zeros(r, dtype=torch.int64, device=dev)
        alive = ~fin
        emits, srcs = [], []
        for _ in range(d):
            want = ids2.gather(1, ni[:, None])[:, 0]
            match = (par == ni[:, None]) & (tok == want[:, None])  # [R, P]
            # a plain slot accepts no child (its nodes past the root hold
            # unexpanded values): it emits the bonus token only
            found = match.any(1) & alive & smask
            child = match.to(torch.int8).argmax(1)
            emits.append(torch.where(alive, want, -1))
            srcs.append(torch.where(found, child, -1).to(torch.int32))
            ni = torch.where(found, child, ni)
            alive = found
        emits = torch.stack(emits, 1)                             # [R, D]
        srcs = torch.stack(srcs, 1)
        bonus = torch.where(alive, ids2.gather(1, ni[:, None])[:, 0], -1)
        e = torch.cat([emits, bonus[:, None]], 1)                 # [R, D+1]
        f_cnt = (srcs >= 0).sum(1).to(torch.int32)               # children
        cnt = torch.where(fin, 0, f_cnt + 1)    # accepted nodes incl. root

        # budget cut first, then EOS among the survivors: the first
        # terminator along the token stream wins, as per token on the host
        bud = c["budget"]
        ok = e >= 0
        eidx = ok.to(torch.int32).cumsum(1) - ok.to(torch.int32)
        e_b = torch.where(ok & (eidx < bud[:, None]), e, -1)
        if self.eos is not None:
            iseos = (e_b == self.eos) & (e_b >= 0)
            after = (iseos.to(torch.int32).cumsum(1)
                     - iseos.to(torch.int32)) > 0
            e_out = torch.where(after, -1, e_b)
            finishing = iseos.any(1)
        else:
            e_out = e_b
            finishing = torch.zeros_like(fin)
        n_emit = (e_out >= 0).sum(1).to(torch.int32)
        bud_new = torch.where(fin, bud, bud - n_emit)
        hit_budget = ~fin & ~finishing & (bud_new <= 0)
        fin_new = fin | finishing | hit_budget
        cont = ~fin_new
        ecode = torch.where(
            ~fin & finishing, EXIT_EOS,
            torch.where(hit_budget, EXIT_BUDGET, c["exit_code"])
        ).to(torch.int32)

        # ---- bookkeeping for the next macro step ----
        root_new = e.gather(1, f_cnt[:, None].long())[:, 0]      # last emit
        c2 = dict(
            root=torch.where(fin_new, c["root"], root_new),
            llm_comm=c["llm_comm"] + cnt,
            ssm_comm=ssm_comm,
            commit_src=torch.cat([torch.zeros_like(srcs[:, :1]), srcs], 1),
            commit_dst=c["llm_comm"][:, None] + kk,
            commit_n=torch.where(cont, cnt, 0),
            backlog_tok=torch.cat([tok[:, :1], emits], 1),
            backlog_n=torch.where(cont, cnt, 0),
            finished=fin_new,
            spec=smask,
            budget=bud_new,
            macro_ctr=c["macro_ctr"] + 1,
            exit_code=ecode,
        )
        return c2, e_out

    @staticmethod
    def _pad_mask(amask: torch.Tensor, pb: int) -> torch.Tensor:
        """[R, P, P] tree mask -> [R, pb, pb] spec-buffer-shaped mask."""
        r, p, _ = amask.shape
        if pb == p:
            return amask
        out = amask.new_zeros((r, pb, pb))
        out[:, :p, :p] = amask
        return out
