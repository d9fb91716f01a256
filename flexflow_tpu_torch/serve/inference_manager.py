"""InferenceManager: place a serve model on its device and run steps.

Port of ``flexflow_tpu/serve/inference_manager.py`` for one device:
``pick_prefill_tile`` (:184), ``sample_tokens`` (:197), ``__init__``,
``init_operators_inference``, ``step`` (:612) with the draft model's
top-k (:596), and ``decode_scan`` (:757).
PyTorch runs eagerly, so the reference's jitted step is a plain call and
its donated caches are caches updated in place.  ``decode_scan`` is a loop
of steps whose batch advances on the device: nothing inside it reads a
value back to the host, and the EOS freeze is a tensor op.

Sampling: greedy is exact argmax.  Temperature/top-p draws are keyed, as
in the reference, by (seed, request id, token index), so a request's draw
does not depend on what else is in the batch; the random numbers come
from a counter-based hash of that key computed on the device, not from
JAX's threefry, so seeded draws match the reference in distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..utils.platform import resolve_device
from .batch_config import BatchConfig, InferenceResult
from .kv_allocator import KVAllocator

# sample = (seed, temperature, top_p, folds i32[rows, 2] of (rid, index))
Sample = Tuple[int, float, float, torch.Tensor]

_M32 = 0xFFFFFFFF


def pick_prefill_tile(max_tokens_per_batch: int, max_seq_len: int) -> int:
    """Query-tile width for the prefill kernel: the largest power-of-two
    divisor of ``max_tokens_per_batch`` capped at 128 that also divides
    ``max_seq_len`` (contract (d) of PrefillBatchConfig)."""
    tile = 1
    while tile < 128 and max_tokens_per_batch % (tile * 2) == 0:
        tile *= 2
    while tile > 1 and max_seq_len % tile:
        tile //= 2
    return tile


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 tensors holding 32-bit values,
    split so no intermediate leaves int64."""
    return (h * (c & 0xFFFF) + ((h * (c >> 16)) & 0xFFFF) * 65536) & _M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 32-bit finaliser."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fold_uniform(seed: int, folds: torch.Tensor, n: int) -> torch.Tensor:
    """``[rows, n]`` uniforms in (0, 1), a pure function of (seed, rid,
    index, column) for each row's fold (rid, index)."""
    f = folds.long() & _M32
    h = _mix32(_mix32(torch.full_like(f[:, 0], seed & _M32)) ^ f[:, 0])
    h = _mix32(h ^ f[:, 1])                                      # [rows]
    col = torch.arange(n, device=folds.device, dtype=torch.int64)
    bits = _mix32(h[:, None] ^ _mix32((col + 0x9E3779B9) & _M32))
    return ((bits >> 8).float() + 0.5) / float(1 << 24)


def sample_tokens(logits: torch.Tensor,
                  sample: Optional[Sample] = None) -> torch.Tensor:
    """Temperature + nucleus (top-p) sampling; exact argmax when
    ``sample`` is None or its temperature is <= 0 (reference :197)."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if sample is None or sample[1] <= 0.0:
        return greedy
    seed, temperature, top_p, folds = sample
    lg = logits / max(float(temperature), 1e-6)
    sorted_lg = lg.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_lg, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(
        max=lg.shape[-1] - 1)
    cutoff = sorted_lg.gather(-1, cutoff_idx)
    lg = lg.masked_fill(lg < cutoff, float("-inf"))
    # Gumbel-max: argmax(lg + Gumbel noise) draws from softmax(lg)
    u = fold_uniform(int(seed), folds, lg.shape[-1])
    return (lg - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


class InferenceManager:
    def __init__(self, model: torch.nn.Module, max_requests: int = 8,
                 max_tokens_per_batch: int = 64, max_seq_len: int = 512,
                 device=None, max_spec_tokens: int = 0, topk: int = 0):
        """``model``: a serve model from ``build_model`` (parameters on
        ``meta`` until :meth:`init_operators_inference` fills them; a
        model whose parameters already lie on ``device`` keeps them, so
        two managers can share modules).  ``device=None`` is the CUDA
        card; pass ``"cpu"`` to run the plain versions of the kernels on
        the CPU.  ``max_spec_tokens > 0`` allocates the speculation-tree
        buffers; ``topk > 0`` makes every step return the top-k token ids
        and log-probabilities (a draft model's beam candidates)."""
        self.device = resolve_device(device)
        self.max_requests = max_requests
        self.max_tokens = max_tokens_per_batch
        self.max_seq_len = max_seq_len
        self.max_spec_tokens = max_spec_tokens
        self.topk = topk
        if any(p.is_meta for p in model.parameters()):
            model = model.to_empty(device=self.device)
        elif any(p.device.type != self.device.type
                 for p in model.parameters()):
            raise ValueError(f"model parameters are not on {self.device}")
        self.model = model.eval()
        self.kv = KVAllocator(self.model, max_requests, max_seq_len,
                              self.device, max_spec_tokens)
        self.prefill_tile = pick_prefill_tile(max_tokens_per_batch,
                                              max_seq_len)
        self.ready = False

    @property
    def state(self):
        return self.kv.state

    @torch.no_grad()
    def init_operators_inference(self, params: Optional[Dict] = None,
                                 seed: int = 0):
        """Fill the parameters (``params``: a state dict, e.g. from
        :func:`~flexflow_tpu_torch.serve.convert.params_from_jax`; None =
        random from ``seed``) and allocate zeroed KV caches."""
        if params is None:
            init_random_params(self.model, seed)
        else:
            own = dict(self.model.named_parameters())
            if set(params) != set(own):
                raise ValueError(
                    "params do not match the model: missing "
                    f"{sorted(set(own) - set(params))[:4]}, unexpected "
                    f"{sorted(set(params) - set(own))[:4]}")
            for name, p in own.items():
                p.copy_(params[name])
        self.allocate_kv_cache()
        self.ready = True
        return self

    def allocate_kv_cache(self):
        return self.kv.allocate()

    def reset(self):
        """Clear every cache (a new serving session)."""
        self.allocate_kv_cache()

    @torch.no_grad()
    def forward(self, bc) -> torch.Tensor:
        """One step's float32 logits ``[max_tokens, vocab]``; the caches
        take this step's K/V in place."""
        if not self.ready:
            raise RuntimeError("call init_operators_inference() first")
        return self.model(bc, self.state)

    @torch.no_grad()
    def step(self, bc, sample: Optional[Sample] = None) -> InferenceResult:
        """Run one serving step (argmax when ``sample`` is None); with
        ``topk``, also the top-k of the log-softmax of the float32 logits
        (reference :596-600)."""
        logits = self.forward(bc)
        topk_ids = topk_lp = None
        if self.topk:
            topk_lp, topk_ids = torch.log_softmax(logits, dim=-1).topk(
                self.topk, dim=-1)
            topk_ids = topk_ids.to(torch.int32)
        return InferenceResult(sample_tokens(logits, sample),
                               logits.amax(dim=-1), logits, topk_ids,
                               topk_lp)

    @torch.no_grad()
    def decode_scan(self, bc: BatchConfig, n_steps: int,
                    eos: Optional[int] = None,
                    sample: Optional[Sample] = None,
                    max_position: Optional[int] = None,
                    allowed: Optional[torch.Tensor] = None):
        """``n_steps`` pure-decode steps whose batch advances on the device.

        Slots that emit ``eos``, or whose ``allowed`` budget (i32[T], the
        tokens each flat row may still emit; None = no limit) runs out,
        are frozen: request index -1, so their later writes go to the
        scratch row and their emissions are masked out of ``live``
        (reference ``decode_scan_async`` :783).  With ``sample``, each
        row's token index advances one per step.  ``max_position``: the
        batch's highest position as the caller's host bookkeeping (read
        from ``bc`` if None, one sync before the loop).  Returns
        ``(tokens i32[n, T], live bool[n, T], bc)``.
        """
        if max_position is None:
            max_position = int(bc.token_position.max())
        if max_position + n_steps > self.max_seq_len:
            raise ValueError(
                f"decode_scan would reach position {max_position + n_steps}"
                f" > max_seq_len {self.max_seq_len}")
        alive = bc.request_index >= 0
        if allowed is not None:
            alive = alive & (allowed > 0)
        tokens, lives = [], []
        for i in range(n_steps):
            stp = None
            if sample is not None:
                step_folds = sample[3].clone()
                step_folds[:, 1] += i
                stp = (sample[0], sample[1], sample[2], step_folds)
            toks = self.step(bc, stp).token_ids
            tokens.append(toks)
            lives.append(alive)
            if allowed is not None:
                allowed = allowed - alive.to(allowed.dtype)
                alive = alive & (allowed > 0)
            if eos is not None:
                alive = alive & (toks != eos)
            bc = bc.advance(toks)
            bc = dataclasses.replace(
                bc, request_index=torch.where(alive, bc.request_index, -1))
        return torch.stack(tokens), torch.stack(lives), bc


@torch.no_grad()
def init_random_params(model: torch.nn.Module, seed: int) -> None:
    """Seeded random weights on the model's device: norm gains 1, every
    other parameter normal with std 1/sqrt(fan-in) (the embedding std 1),
    drawn in float32 from a ``torch.Generator`` and cast."""
    params = list(model.named_parameters())
    dev = params[0][1].device if params else torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for name, p in params:
        if name.endswith("gamma"):
            p.fill_(1.0)
            continue
        fan_in = 1 if name.endswith("embed_tokens.weight") else p.shape[0]
        w = torch.randn(p.shape, generator=gen, device=dev,
                        dtype=torch.float32)
        p.copy_(w.mul_(fan_in ** -0.5))
        del w

