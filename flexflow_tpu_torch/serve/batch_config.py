"""Fixed-capacity batch descriptors shipped to the device each serving step.

Port of ``flexflow_tpu/serve/batch_config.py``: the same fields and the
same contracts, as dataclasses of int32 tensors.  A step processes up to
``max_tokens`` flat tokens of up to ``max_requests`` request slots; pad
tokens carry ``request_index == -1`` and write to the scratch cache row.
LM-head gating (``logit_slots``) is not ported: every step computes the
logits of all its flat tokens, which is the reference's ``gate_lm_head=
False`` behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..utils.platform import resolve_device

MAX_NUM_REQUESTS = 8
MAX_NUM_TOKENS = 64


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """One incremental-decoding step.  All tensors are capacity-padded;
    ``num_tokens`` marks the valid prefix."""

    tokens: torch.Tensor          # i32[max_tokens] input token ids
    request_index: torch.Tensor   # i32[max_tokens] slot per token (-1 = pad)
    token_position: torch.Tensor  # i32[max_tokens] absolute seq position
    num_tokens: torch.Tensor      # i32[] valid token count
    seq_lens: torch.Tensor        # i32[max_requests] cache depth after step

    @property
    def max_tokens(self) -> int:
        return self.tokens.shape[0]

    @property
    def max_requests(self) -> int:
        return self.seq_lens.shape[0]

    def advance(self, token_ids: torch.Tensor) -> "BatchConfig":
        """The next pure-decode step's config, computed on the device: each
        valid slot is fed the token just produced for it, one position
        further (reference ``BatchConfig.advance`` :62)."""
        active = self.request_index >= 0
        req = self.request_index.clamp(0, self.max_requests - 1).long()
        seq_lens = self.seq_lens.index_add(0, req,
                                           active.to(self.seq_lens.dtype))
        return BatchConfig(
            tokens=torch.where(active, token_ids.to(self.tokens.dtype),
                               self.tokens),
            request_index=self.request_index,
            token_position=self.token_position + active.to(torch.int32),
            num_tokens=self.num_tokens,
            seq_lens=seq_lens,
        )

    @staticmethod
    def build(token_ids, request_indices, positions, seq_lens,
              max_tokens: int = MAX_NUM_TOKENS,
              max_requests: int = MAX_NUM_REQUESTS,
              device=None) -> "BatchConfig":
        """Host-side constructor from variable-length lists (pads to
        capacity)."""
        n = len(token_ids)
        if n > max_tokens:
            raise ValueError(f"{n} tokens > capacity {max_tokens}")
        tokens = np.zeros(max_tokens, np.int32)
        req = np.full(max_tokens, -1, np.int32)
        pos = np.zeros(max_tokens, np.int32)
        tokens[:n] = token_ids
        req[:n] = request_indices
        pos[:n] = positions
        sl = np.zeros(max_requests, np.int32)
        sl[: len(seq_lens)] = seq_lens
        return BatchConfig.from_numpy(
            (tokens, req, pos, np.asarray(n, np.int32), sl), device)

    @staticmethod
    def from_numpy(fields, device=None) -> "BatchConfig":
        dev = resolve_device(device)
        return BatchConfig(*(torch.from_numpy(np.ascontiguousarray(f))
                             .to(dev) for f in fields))


@dataclasses.dataclass(frozen=True)
class PrefillBatchConfig:
    """A prompt-prefill step whose flat tokens are grouped into
    request-homogeneous tiles (reference :178), routed to the tiled prefill
    kernel.

    Contract (enforced by :meth:`np_fields`): with ``Bq = tile_size``, flat
    slot ``g*Bq + b`` belongs to tile ``g``; each tile's real tokens (a)
    belong to one request, (b) sit at the tile's head with pads only at the
    tail, (c) have contiguous ascending positions and (d) start at a
    tile-aligned position, so each tile's KV is one whole block write.
    """

    base: BatchConfig
    tile_size: int

    @property
    def num_tiles(self) -> int:
        return self.base.max_tokens // self.tile_size

    @staticmethod
    def build(segments, seq_lens, tile_size: int,
              max_tokens: int = MAX_NUM_TOKENS,
              max_requests: int = MAX_NUM_REQUESTS, device=None
              ) -> Tuple["PrefillBatchConfig", Dict[int, int]]:
        """``segments``: iterable of ``(slot, token_ids, start_pos)``.
        Returns ``(pbc, last_flat)`` with ``last_flat[slot]`` the flat
        index of that segment's final token."""
        fields, last_flat = PrefillBatchConfig.np_fields(
            segments, seq_lens, tile_size, max_tokens, max_requests)
        return (PrefillBatchConfig(BatchConfig.from_numpy(fields, device),
                                   tile_size),
                last_flat)

    @staticmethod
    def np_fields(segments: Iterable, seq_lens, tile_size: int,
                  max_tokens: int, max_requests: int):
        """The five BatchConfig fields as numpy arrays (reference :268)."""
        if max_tokens % tile_size:
            raise ValueError(
                f"tile_size {tile_size} must divide max_tokens {max_tokens}")
        tokens = np.zeros(max_tokens, np.int32)
        req = np.full(max_tokens, -1, np.int32)
        pos = np.zeros(max_tokens, np.int32)
        last_flat: Dict[int, int] = {}
        at = 0
        n = 0
        for slot, toks, start in segments:
            if start % tile_size:
                raise ValueError(
                    f"segment start {start} not aligned to tile_size "
                    f"{tile_size} (contract (d): the block KV write needs "
                    "tile-aligned positions)")
            need = -(-len(toks) // tile_size) * tile_size
            if at + need > max_tokens:
                raise ValueError(f"segments need {at + need} padded slots > "
                                 f"capacity {max_tokens}")
            tokens[at: at + len(toks)] = toks
            req[at: at + len(toks)] = slot
            pos[at: at + len(toks)] = np.arange(start, start + len(toks))
            last_flat[slot] = at + len(toks) - 1
            n = at + len(toks)
            at += need
        sl = np.zeros(max_requests, np.int32)
        sl[: len(seq_lens)] = seq_lens
        return (tokens, req, pos, np.asarray(n, np.int32), sl), last_flat


@dataclasses.dataclass(frozen=True)
class TreeSearchBatchConfig:
    """Draft-model (SSM) tree-expansion step (reference :308).

    The step's tokens are nodes added to each request's speculation tree:
    ``spec_index`` is a token's node slot in its request's spec buffer and
    ``ancestor_mask[r, i, j]`` says node i of request r may attend node j
    (its root-path ancestors and itself).  Committed-cache attention sees
    positions below ``committed_lens``.
    """

    base: BatchConfig
    spec_index: torch.Tensor      # i32[max_tokens] tree-node slot per token
    ancestor_mask: torch.Tensor   # bool[max_requests, max_spec, max_spec]
    committed_lens: torch.Tensor  # i32[max_requests] committed cache depth

    @property
    def max_spec_tokens(self) -> int:
        return self.ancestor_mask.shape[-1]


@dataclasses.dataclass(frozen=True)
class TreeVerifyBatchConfig:
    """LLM verification step over flattened speculation trees (reference
    :331): the tree-attention fields of :class:`TreeSearchBatchConfig` plus
    the commit descriptor, the tokens accepted in the previous macro-step
    whose K/V (kept in the spec buffer) is copied into the committed cache
    before the step attends (``commit_request_index == -1``: pad).

    ``tree_layout = (R, P)`` says flat token ``r*P + j`` is node j of slot
    r's tree for every r < R (the on-device scan's fixed layout): the
    attention then runs the batched tree kernel, one kernel row per
    request.  None: any flat layout (the host-built batches).
    """

    base: BatchConfig
    spec_index: torch.Tensor      # i32[max_tokens]
    ancestor_mask: torch.Tensor   # bool[max_requests, max_spec, max_spec]
    committed_lens: torch.Tensor  # i32[max_requests]
    commit_request_index: torch.Tensor   # i32[max_commit]
    commit_src_spec_index: torch.Tensor  # i32[max_commit] spec-buffer slot
    commit_dst_position: torch.Tensor    # i32[max_commit] cache position
    tree_layout: Optional[Tuple[int, int]] = None

    @property
    def max_spec_tokens(self) -> int:
        return self.ancestor_mask.shape[-1]


@dataclasses.dataclass(frozen=True)
class InferenceResult:
    """Per-step device output: the next token per flat slot and its logit;
    with ``topk > 0`` on the manager, the top-k token ids and their
    log-probabilities (the draft model's beam candidates)."""

    token_ids: torch.Tensor            # i32[max_tokens]
    logits_max: torch.Tensor           # f32[max_tokens]
    logits: Optional[torch.Tensor] = None  # f32[max_tokens, vocab]
    topk_ids: Optional[torch.Tensor] = None        # i32[max_tokens, k]
    topk_logprobs: Optional[torch.Tensor] = None   # f32[max_tokens, k]
