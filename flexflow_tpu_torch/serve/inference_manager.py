"""InferenceManager: place a serve model on its devices and run steps.

Port of ``flexflow_tpu/serve/inference_manager.py`` over a
``parallel.Mesh`` of one device or several (below):
``pick_prefill_tile`` (:184), ``sample_tokens`` (:197), ``__init__``,
``init_operators_inference``, ``step`` (:612) with the draft model's
top-k (:596), ``decode_scan`` (:757) and ``prefill_scan`` (:958), over an
int8 (``kv_dtype``) and/or paged (``kv_page_size``) KV cache, with
LM-head gating (``gate_lm_head``, :265) and the chained stretch's
``decode_scan_async`` (:783) and ``join_slot`` (:827).
PyTorch runs eagerly, so the reference's jitted step is a plain call and
its donated caches are caches updated in place.  ``decode_scan_async`` is
a loop of steps whose batch advances on the device: nothing inside it
reads a value back to the host, and the EOS and budget freezes and the
per-row exit codes (``EXIT_*``) are tensor ops; its launches queue on the
stream, so segments issued back to back with joins between them run with
no host wait.  ``prefill_scan`` is a loop of prefill chunks, one dispatch
to the caller.  Each of the three consults the manager's
``fault_injector`` once, at its site name, before any device work
(reference :618, :767, :973).

Observability (reference :235-250): the ``telemetry`` and ``profiler``
handles a RequestManager sets (no-ops by default).  Each ``step``,
``decode_scan_async`` segment, ``join_slot`` and ``prefill_scan`` call
counts one dispatch and times its host side under the ``dispatch`` phase;
all but the join record a span on the ``dispatch`` track (reference
:624-628, :769-781, :806-817, :839-842, :975-981).  No hook reads a
device value.  ``publish_memory`` records the deployment's predicted and
allocated bytes into the telemetry's memory ledger (reference :523).

Tensor parallelism (``mesh=``; reference: one SPMD program over a
``{"tp": n}`` mesh, :363-369): the manager plans the serve graph under a
``strategy`` (reference :259): None is ``tensor_parallel_strategy`` (the
Megatron rule, :42-80) on a mesh of several devices and ``{}`` on one, a
dict is any strategy (``{node name: {parallel dim: ("tp",)}}``, searched
or written by hand), and ``"search"`` is :func:`searched_serve_strategy`'s
Unity search (:118-150).  ``im.strategy``, ``im.pcg`` and ``im.plan`` are
the dict, the PCG and its plan (``core/pcg.py``).  ONE manager holds one
shard-local model per mesh device (``shards``, ``parallel/tp.py``: the
plan executor; on a mesh of one device, the model itself) and one
allocator whose buffers are per shard (a ``head`` attention's caches hold
its shard's KV heads), and advances the shards in lockstep: each step
runs every shard's forward generator through ``parallel.comm.
run_shards``, which answers the plan's collectives.  The logits are
gathered on shard 0 and sampled there; the batch, built on shard 0's
device, reaches another shard's device with its tokens before each of its
steps, so the chained stretch and the joins feed every shard.  Global
parameters (a state dict, or random ones drawn at their global shapes
from the seed, identical at every ``tp`` and strategy) are sliced per
shard.  ``self.model`` is shard 0's model.

Sampling: greedy is exact argmax.  Temperature/top-p draws are keyed, as
in the reference, by (seed, request id, token index), so a request's draw
does not depend on what else is in the batch; the random numbers come
from a counter-based hash of that key computed on the device, not from
JAX's threefry, so seeded draws match the reference in distribution only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..obs.profiler import NULL_PROFILER
from ..obs.telemetry import NULL_TELEMETRY
from ..ops.cuda.attention import check_page_size
from ..parallel.comm import run_shards
from ..parallel.mesh import make_mesh
from ..parallel.tp import TPPlan, shard_model
from ..search.machine_model import MachineModel
from ..utils.platform import resolve_device, torch_dtype
from .batch_config import BatchConfig, InferenceResult, batch_to
from .kv_allocator import KVAllocator, padded_seq_len
from .kv_paged import PagedKVAllocator, validate_page_tile
from .models.builder import serve_model
from .quant import int8_layout

# sample = (seed, temperature, top_p, folds i32[rows, 2] of (rid, index))
Sample = Tuple[int, float, float, torch.Tensor]

_M32 = 0xFFFFFFFF

# why a decode-scan row stopped, read back with the stretch (reference
# :36-39; SpecDecodeScan reports the same codes)
EXIT_NOT_IN_BATCH = -1  # padding, or frozen before this scan began
EXIT_RUNNING = 0        # budget left and no EOS: resumes next segment
EXIT_EOS = 1            # emitted the stop token (frozen since)
EXIT_BUDGET = 2         # emitted its whole remaining budget


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


def register_serve_capacities(model, max_requests: int, max_seq_len: int,
                              max_spec_tokens: int = 0,
                              kv_dtype: Optional[str] = None,
                              max_tokens_per_batch: Optional[int] = None
                              ) -> None:
    """Record the serving capacities and the KV dtype on the attention
    modules of ``model`` (a model, or a list of shard models) so that the
    planner (``search/serve_search.py``, ``serve/cost.py``) prices the
    deployment's real buffers before any manager exists (reference
    :152-164): ``cost_seq_len``, ``cost_max_requests``, ``cost_max_spec``
    and ``kv_dtype``, and ``cost_max_tokens``, the flat token batch the
    reference reads from its graph's shapes.  :class:`InferenceManager`
    and the pipelined manager call it in ``__init__``."""
    from .ops import IncMultiHeadSelfAttention

    for m in model if isinstance(model, (list, tuple)) else [model]:
        for mod in m.modules():
            if isinstance(mod, IncMultiHeadSelfAttention):
                mod.cost_seq_len = max_seq_len
                mod.cost_max_requests = max_requests
                mod.cost_max_spec = max_spec_tokens
                mod.kv_dtype = kv_dtype
                mod.cost_max_tokens = max_tokens_per_batch


def mark_gated_lm_head(model, max_requests: int) -> bool:
    """Mark the Linear that produces the logits (the node producing the
    serve graph's output) for LM-head gating (reference :167-181):
    ``lm_head_gated`` and ``cost_logit_rows = max_requests``, which the
    cost model prices the head at.  ``model``: a model or a list of shard
    models.  Returns whether a Linear was marked: the guard
    ``gate_lm_head`` ANDs in."""
    from ..ops.linear import Linear
    from .cost import lm_head_of

    marked = False
    for m in model if isinstance(model, (list, tuple)) else [model]:
        mod = lm_head_of(m)
        if isinstance(mod, Linear):
            mod.lm_head_gated = True
            mod.cost_logit_rows = max_requests
            marked = True
    return marked


def default_machine(mesh) -> MachineModel:
    """The machine a searched serve strategy is priced on (reference
    ``_default_calibration`` :83-115): ``MachineModel.for_mesh`` (the
    ``h100`` spec for CUDA devices, ``cpu`` for the CPU), the ``h100``
    spec calibrated by ``artifacts/h100_calib.json``, the constants
    ``scripts/calibrate_h100.py`` measured on the card."""
    import os

    mm = MachineModel.for_mesh(mesh)
    if mm.spec.name == "h100":
        here = os.path.dirname(os.path.abspath(__file__))
        mm = mm.with_calibration(os.path.join(
            here, "..", "..", "artifacts", "h100_calib.json"))
    return mm


def searched_serve_strategy(model, budget: int = 300, seed: int = 0,
                            measured=None, memory_limit=None, machine=None,
                            mesh=None) -> Dict[str, Dict]:
    """The Unity search over a serve graph (reference :118-150):
    ``search.graph_optimize`` with ``training=False`` (no backward factor,
    no gradient all-reduce, inference activations), whose memory model
    counts the KV and spec buffers the attention modules registered
    (``register_serve_capacities``; call it first, as the managers do),
    sharded by each candidate's own ``head`` config, and whose token axis
    is the flat batch recorded there.  ``mesh``: the ``{"tp": n}`` mesh
    (the port's model carries none); ``machine`` defaults to
    :func:`default_machine`, ``memory_limit`` to its spec's
    ``hbm_capacity``; ``measured`` an op-cost cache
    (``search/measure.py:CostCache``) or None (the roofline)."""
    from ..core.pcg import serve_graph
    from ..search.search import graph_optimize
    from .cost import recorded_capacities

    if mesh is None:
        raise ValueError("searched_serve_strategy needs the mesh to plan "
                         "over (mesh=parallel.make_mesh({'tp': n}, ...))")
    caps = recorded_capacities(model)
    if caps is None or not caps.max_tokens:
        raise ValueError("the model carries no serve capacities: call "
                         "register_serve_capacities(model, ..., "
                         "max_tokens_per_batch=...) first")
    if machine is None:
        machine = default_machine(mesh)
    if memory_limit is None:
        memory_limit = machine.spec.hbm_capacity
    graph = serve_graph(model, caps.max_tokens)
    return graph_optimize(graph, mesh, budget=budget, seed=seed,
                          training=False, measured=measured,
                          memory_limit=memory_limit, machine=machine)


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


def step_result(logits: torch.Tensor, sample: Optional[Sample] = None,
                topk: int = 0) -> InferenceResult:
    """A step's result from its float32 logits: the sampled (argmax when
    ``sample`` is None) token ids, the largest logits, and with ``topk``
    the top-k of the log-softmax (reference :596-600)."""
    topk_ids = topk_lp = None
    if topk:
        topk_lp, topk_ids = torch.log_softmax(logits, dim=-1).topk(
            topk, dim=-1)
        topk_ids = topk_ids.to(torch.int32)
    return InferenceResult(sample_tokens(logits, sample),
                           logits.amax(dim=-1), logits, topk_ids, topk_lp)


class InferenceManager:
    # the seeded chaos hook a RequestManager sets (resilience.py); None:
    # no dispatch ever faults
    fault_injector = None
    # the observability handles a RequestManager syncs (always: a shared
    # manager never keeps an earlier RequestManager's live handle)
    telemetry = NULL_TELEMETRY
    profiler = NULL_PROFILER

    def __init__(self, model: torch.nn.Module, max_requests: int = 8,
                 max_tokens_per_batch: int = 64, max_seq_len: int = 512,
                 device=None, max_spec_tokens: int = 0, topk: int = 0,
                 kv_dtype: Optional[str] = None,
                 kv_page_size: Optional[int] = None,
                 gate_lm_head: bool = True, prefill_overlap: bool = True,
                 mesh=None, strategy=None, outputs=None):
        """``model``: a serve model from ``build_model``, or an ``FFModel``
        whose graph a serve builder recorded (reference :252-290; served
        as ``models/builder.py:BuilderModel``, ``outputs`` its logits
        Tensor(s), by default the last node's last output) (parameters on
        ``meta`` until :meth:`init_operators_inference` fills them; a
        model whose parameters already lie on ``device`` keeps them, so
        two managers can share modules: ``allocate_kv_cache`` then
        readies the second).  ``device=None`` is the CUDA
        card; pass ``"cpu"`` to run the plain versions of the kernels on
        the CPU.  ``max_spec_tokens > 0`` allocates the speculation-tree
        buffers; ``topk > 0`` makes every step return the top-k token ids
        and log-probabilities (a draft model's beam candidates).

        ``kv_dtype="int8"`` stores the committed K/V caches int8 with one
        f32 scale per (row, head, position), quantized on write and
        dequantized inside the attention kernels (None: the model's
        compute dtype; anything else raises, reference :325).
        ``kv_page_size`` carves the same buffers into pages of that many
        positions behind a block table with copy-on-write prefix sharing
        (:mod:`.kv_paged`): it must divide ``max_seq_len`` and its
        128-padded length, be a multiple of the prefill tile (reference
        :418-421) and be a page the kernels take (a multiple of 64).
        Writes need mapped pages: the RequestManager prepares them before
        every dispatch; a caller driving ``step`` itself calls
        ``kv.bind(rid, slot=...)`` and ``kv.prepare_write(rid, lo, hi)``
        first (an unprepared write lands in the scratch page).

        ``gate_lm_head`` (reference :265): prefill chunks a RequestManager
        builds carry ``logit_slots``, so their LM head computes logits
        only at the completing prompts' last tokens; it is read when a
        batch is built, so it can be switched between calls.
        ``prefill_overlap`` is taken for the reference's signature and
        does nothing: there it lets XLA schedule the next chunk's layer-0
        QKV projection inside the prefill scan (:426-442,
        ``_project_chunk0`` :849), a compiler device with no counterpart
        in eager PyTorch, whose launches already queue back to back.

        ``mesh`` (a ``parallel.Mesh``, in place of ``device``) serves the
        model tensor-parallel over the mesh's devices: ``model`` is
        sharded here (on ``meta`` when the mesh has several devices), or
        is another manager's ``shards`` on the same mesh (shared weights).
        ``device`` builds the mesh of one device, whose one shard is
        ``model`` itself.

        ``strategy`` (reference :259, :363-369): None (the Megatron rule
        when the mesh has several devices, ``{}`` on one), a dict
        ``{node name: {parallel dim: mesh axes}}`` (a searched or a hand
        strategy, ``search.load_strategy``), or ``"search"``
        (:func:`searched_serve_strategy` at its defaults, after the
        capacities are registered).  A config the executor cannot run
        raises ``NotImplementedError``.  Shard models passed as ``model``
        keep their own plan (give no strategy)."""
        model = serve_model(model, outputs)
        if mesh is None:
            mesh = make_mesh({"tp": 1}, [resolve_device(device)])
        elif device is not None:
            raise ValueError("pass a device or a mesh, not both")
        elif "pp" in mesh.shape:
            raise ValueError(f"{mesh} has a 'pp' axis: serve it with "
                             "serve.PipelinedInferenceManager")
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.max_requests = max_requests
        self.max_tokens = max_tokens_per_batch
        self.max_seq_len = max_seq_len
        self.max_spec_tokens = max_spec_tokens
        self.topk = topk
        # a model whose parameters already lie on the device (another
        # manager's) needs only its caches: ``allocate_kv_cache``
        self._params_ready = True
        # the capacities and the LM-head mark, on the modules the shards
        # copy (reference :340-362), so the planner prices the deployment
        register_serve_capacities(model, max_requests, max_seq_len,
                                  max_spec_tokens, kv_dtype,
                                  max_tokens_per_batch)
        marked = gate_lm_head and mark_gated_lm_head(model, max_requests)
        if isinstance(model, (list, tuple)):
            shards = list(model)
            if (len(shards) != mesh.size or strategy is not None
                    or any(getattr(m, "tp_plan", None) is None
                           or m.tp_plan.degree != mesh.size for m in shards)):
                raise ValueError(f"{len(shards)} shard models do not fit "
                                 f"{mesh} (they keep their own strategy)")
            plan = shards[0].tp_plan
        else:
            if isinstance(strategy, str):
                if strategy != "search":
                    raise ValueError(f"strategy {strategy!r}: None, a dict "
                                     "or 'search'")
                strategy = searched_serve_strategy(model, mesh=mesh)
            plan = TPPlan(model, mesh, strategy, max_tokens_per_batch)
            shards = [shard_model(model, plan, r) for r in range(mesh.size)]
        self.strategy = plan.strategy
        self.pcg = plan.pcg
        self.plan = plan.plan
        for i, (m, dev) in enumerate(zip(shards, mesh.devices)):
            if any(p.is_meta for p in m.parameters()):
                shards[i] = m.to_empty(device=dev)
                self._params_ready = False
            elif any(p.device.type != dev.type for p in m.parameters()):
                raise ValueError(f"model parameters are not on {dev}")
        self.shards = [m.eval() for m in shards]
        self.model = self.shards[0]
        self.kv_dtype = kv_dtype
        self.kv_page_size = kv_page_size
        self.prefill_tile = pick_prefill_tile(max_tokens_per_batch,
                                              max_seq_len)
        if kv_page_size:
            self.kv = PagedKVAllocator(self.shards, max_requests, max_seq_len,
                                       mesh.devices, max_spec_tokens,
                                       kv_dtype, page_size=kv_page_size)
            validate_page_tile(kv_page_size, self.prefill_tile)
            check_page_size(kv_page_size, padded_seq_len(max_seq_len))
        else:
            self.kv = KVAllocator(self.shards, max_requests, max_seq_len,
                                  mesh.devices, max_spec_tokens, kv_dtype)
        self._gate_lm_head = bool(gate_lm_head)
        # the LM head is marked for gating at construction only (reference
        # :358-361): the cost card prices a marked head per logit row
        self.lm_head_marked = bool(marked)

    @property
    def gate_lm_head(self) -> bool:
        """Whether prefill chunks gate the LM head: the flag, and a model
        whose LM head takes ``logit_slots`` (reference :467-476)."""
        return self._gate_lm_head and getattr(self.model, "gates_lm_head",
                                              False)

    @gate_lm_head.setter
    def gate_lm_head(self, value) -> None:
        self._gate_lm_head = bool(value)

    @property
    def state(self):
        return self.kv.state

    @property
    def ready(self) -> bool:
        """Parameters filled and caches allocated (a torn-down allocator
        leaves the manager unready)."""
        return self._params_ready and self.kv.state is not None

    @property
    def tp(self) -> int:
        """The tensor-parallel degree (1 on one device)."""
        return self.mesh.size

    @property
    def shard_groups(self):
        """The shard models, one list per pipeline stage (one here)."""
        return [self.shards]

    @property
    def plan_key(self) -> str:
        """The deployment in the serve search's ``tp{t}_pp{p}_m{m}``
        convention (reference :491)."""
        return f"tp{self.tp}_pp1_m1"

    def publish_memory(self, telemetry, key: Optional[str] = None) -> None:
        """Record this deployment's predicted and allocated HBM in the
        telemetry's memory ledger (reference :523): predicted = the
        memory parts of :mod:`.cost` (the reference's
        ``plan_memory_parts``), allocated = the parameters' and the cache
        buffers' real bytes (int8 values and scales, padding and spec
        buffers included), both per device (one shard's).  ``key``
        overrides the plan key (the spec draft's ``_draft`` record).  A
        no-op for a disabled handle; the allocated side waits for the
        caches."""
        if telemetry is None or not getattr(telemetry, "enabled", False):
            return
        from ..obs.memory import publish_predicted_parts
        from .cost import compose_stage_parts, plan_memory_parts

        key = key or self.plan_key
        publish_predicted_parts(
            telemetry, key, compose_stage_parts([plan_memory_parts(self)]))
        if not self.kv.state:
            return
        w = float(sum(p.numel() * p.element_size()
                      for p in self.model.parameters()))
        kv = float(self.kv.allocated_bytes(per_device=True))
        telemetry.memory_plan_allocated(
            key, weights_gb=w / 1e9, kv_gb=kv / 1e9,
            static_gb=(w + kv) / 1e9)

    @torch.no_grad()
    def init_operators_inference(self, params: Optional[Dict] = None,
                                 seed: int = 0, dtype=None):
        """Fill the parameters (``params``: a state dict, e.g. from
        :func:`~flexflow_tpu_torch.serve.convert.params_from_jax`, whose
        int8 weights beside their ``_scale`` load as int8 and whose other
        tensors keep their dtype; None = random from ``seed``, in ``dtype``
        when given, else the model's) and allocate zeroed KV caches.  The
        compute and KV dtype stay the model's: a weight in another dtype
        is cast at use (reference :503-516).  The parameters are global and
        each shard takes its slice."""
        if params is None:
            if dtype is not None:
                for m in self.shards:
                    param_layout(m, torch_dtype(dtype))
            init_random_params(self.shards, seed)
        else:
            load_params(self.shards, params)
        self._params_ready = True
        self.allocate_kv_cache()
        return self

    def allocate_kv_cache(self):
        """(Re)allocate zeroed caches; for a manager built on a model
        whose parameters another manager filled, this alone readies it
        (the two share the weights, each has its own KV)."""
        return self.kv.allocate()

    def reset(self):
        """Clear every cache (a new serving session)."""
        self.allocate_kv_cache()

    @torch.no_grad()
    def forward(self, bc) -> torch.Tensor:
        """One step's float32 logits ``[max_tokens, vocab]`` (``[max_requests,
        vocab]`` for a gated prefill chunk); the caches
        take this step's K/V in place, through the page table of a paged
        cache (uploaded here after the allocator changed it, reused by
        the steps of a stretch)."""
        if not self.ready:
            raise RuntimeError("call init_operators_inference() first")
        gens = [m.forward_gen(batch_to(bc, dev), state,
                              self.kv.page_view(dev))
                for m, dev, state in zip(self.shards, self.mesh.devices,
                                         self.kv.states)]
        return run_shards(gens, self.mesh.comm)[0]

    def _fault_site(self, site: str) -> None:
        if self.fault_injector is not None:
            self.fault_injector.maybe_fail(site)

    @torch.no_grad()
    def step(self, bc, sample: Optional[Sample] = None) -> InferenceResult:
        """Run one serving step (argmax when ``sample`` is None); with
        ``topk``, also the top-k of the log-softmax of the float32 logits
        (reference :596-600).  The ``step`` fault site."""
        self._fault_site("step")
        prof = self.profiler
        if prof.enabled:
            prof.count("dispatches")
        with self.telemetry.span("step_dispatch", cat="dispatch",
                                 track="dispatch"), prof.phase("dispatch"):
            return self.run_step(bc, sample)

    @torch.no_grad()
    def run_step(self, bc, sample: Optional[Sample] = None
                 ) -> InferenceResult:
        """The body of :meth:`step` with no fault site: the steps inside
        one dispatch (``decode_scan``, ``prefill_scan``, a
        ``SpecDecodeScan`` macro step)."""
        return step_result(self.forward(bc), sample, self.topk)

    @torch.no_grad()
    def decode_scan(self, bc: BatchConfig, n_steps: int,
                    eos: Optional[int] = None,
                    sample: Optional[Sample] = None,
                    max_position: Optional[int] = None,
                    allowed: Optional[torch.Tensor] = None):
        """``n_steps`` pure-decode steps (reference :757): the synchronous
        form of :meth:`decode_scan_async`, which reads ``max_position``
        from ``bc`` when the caller has none (one sync before the loop).
        Returns ``(tokens i32[n, T], live bool[n, T], bc)``."""
        if max_position is None:
            max_position = int(bc.token_position.max())
        tokens, live, _, bc = self.decode_scan_async(
            bc, n_steps, eos=eos, sample=sample, allowed=allowed,
            max_position=max_position)
        return tokens, live, bc

    @torch.no_grad()
    def decode_scan_async(self, bc: BatchConfig, n_steps: int,
                          eos: Optional[int] = None,
                          sample: Optional[Sample] = None,
                          allowed: Optional[torch.Tensor] = None,
                          max_position: Optional[int] = None):
        """One chained-stretch segment (reference :783, its scan body
        :700-720): ``n_steps`` pure-decode steps whose batch advances on
        the device, with no read-back and no host read of ``bc``.

        Rows that emit ``eos``, or whose ``allowed`` budget (i32[T], the
        tokens each flat row may still emit; None = no limit) runs out,
        are frozen: request index -1, so their later writes go to the
        scratch row and their emissions are masked out of ``live``; a row
        that enters with no budget is frozen before the first step.  With
        ``sample``, each row's token index advances one per step.
        ``max_position``: the batch's highest position as the caller's
        host bookkeeping (required: this path must not sync to check
        it).  Returns device values ``(tokens i32[n, T], live bool[n, T],
        exit_codes i32[T], bc)``, the codes ``EXIT_*``.
        """
        if max_position is None:
            raise ValueError("decode_scan_async needs the host's "
                             "max_position")
        if max_position + n_steps > self.max_seq_len:
            raise ValueError(
                f"decode_scan would reach position {max_position + n_steps}"
                f" > max_seq_len {self.max_seq_len}")
        self._fault_site("decode_scan")
        prof = self.profiler
        if prof.enabled:
            prof.count("dispatches")
        with self.telemetry.span("decode_scan_dispatch", cat="dispatch",
                                 track="dispatch",
                                 n_steps=n_steps), prof.phase("dispatch"):
            out = self._decode_steps(bc, n_steps, eos, sample, allowed)
        if self.telemetry.enabled:
            self.telemetry.metrics.counter("decode_scan_steps").inc(n_steps)
        return out

    def _decode_steps(self, bc, n_steps, eos, sample, allowed):
        """The body of :meth:`decode_scan_async`."""
        present = bc.request_index >= 0
        alive = present
        if allowed is not None:
            alive = alive & (allowed > 0)
            bc = dataclasses.replace(
                bc, request_index=torch.where(alive, bc.request_index, -1))
        eos_hit = torch.zeros_like(present)
        tokens, lives = [], []
        for i in range(n_steps):
            stp = None
            if sample is not None:
                step_folds = sample[3].clone()
                step_folds[:, 1] += i
                stp = (sample[0], sample[1], sample[2], step_folds)
            toks = self.run_step(bc, stp).token_ids
            tokens.append(toks)
            lives.append(alive)
            if allowed is not None:
                allowed = allowed - alive.to(allowed.dtype)
                alive = alive & (allowed > 0)
            if eos is not None:
                hit = lives[-1] & (toks == eos)
                eos_hit = eos_hit | hit
                alive = alive & ~hit
            bc = bc.advance(toks)
            bc = dataclasses.replace(
                bc, request_index=torch.where(alive, bc.request_index, -1))
        codes = torch.where(
            ~present, EXIT_NOT_IN_BATCH,
            torch.where(eos_hit, EXIT_EOS,
                        torch.where(alive, EXIT_RUNNING, EXIT_BUDGET)))
        return (torch.stack(tokens), torch.stack(lives),
                codes.to(torch.int32), bc)

    @torch.no_grad()
    def join_slot(self, bc: BatchConfig, tok_src: torch.Tensor, src_idx: int,
                  dst: int, slot: int, pos: int, seq_len: int,
                  num_tokens: int, eos: Optional[int] = None) -> BatchConfig:
        """Splice one staged arrival into a running stretch's batch
        (reference :827): its token is ``tok_src[src_idx]``, the device
        result of its last prefill chunk (never read here), and the row
        is installed frozen when that token is ``eos``."""
        prof = self.profiler
        if prof.enabled:
            prof.count("dispatches")
        with prof.phase("dispatch"):
            tok = tok_src[src_idx]
            active = None if eos is None else tok != eos
            return bc.join_row(dst, tok, slot, pos, seq_len, num_tokens,
                               active=active)

    @torch.no_grad()
    def prefill_scan(self, chunks: Sequence,
                     samples: Optional[Sequence[Optional[Sample]]] = None
                     ) -> torch.Tensor:
        """The prefill stretch's dispatch (reference :958): run the
        prefill batches ``chunks`` in order (each with its ``samples``
        entry, None = greedy) and return their token ids stacked,
        ``i32[len(chunks), max_tokens]`` (``max_requests``, indexed by
        slot, when the chunks are gated), read back by the caller once.
        The ``prefill_scan`` fault site is consulted once, before the
        first chunk, so a retry replays the whole stretch."""
        self._fault_site("prefill_scan")
        samples = samples or [None] * len(chunks)
        prof = self.profiler
        if prof.enabled:
            prof.count("dispatches")
        with self.telemetry.span("prefill_scan_dispatch", cat="dispatch",
                                 track="dispatch", n_chunks=len(chunks)), \
                prof.phase("dispatch"):
            return torch.stack([self.run_step(bc, s).token_ids
                                for bc, s in zip(chunks, samples)])


def param_layout(model: torch.nn.Module, dtypes) -> None:
    """Re-slot the model's floating parameters (empty) in another dtype:
    ``dtypes`` is one dtype for all, or a state dict whose floating
    tensors give each parameter's; int8 weights and their scales stay."""
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            if not p.is_floating_point():
                continue
            if isinstance(dtypes, torch.dtype):
                dt = dtypes
            else:
                t = dtypes.get(f"{mod_name}.{pname}" if mod_name else pname)
                if t is None or not t.is_floating_point():
                    continue
                dt = t.dtype
            if dt != p.dtype:
                setattr(mod, pname, torch.nn.Parameter(
                    torch.empty(p.shape, dtype=dt, device=p.device),
                    requires_grad=False))


@torch.no_grad()
def load_params(shards: Sequence[torch.nn.Module], params: Dict) -> None:
    """Fill shard models from a global state dict: each takes its slice
    of the parameters it holds (a pipeline stage's models hold only their
    own), int8 weights beside their ``_scale`` load as int8, the other
    tensors keep their dtype; together the shards must hold exactly the
    state dict's names."""
    held = set()
    for m in shards:
        int8_layout(m, params)
        param_layout(m, params)
        held |= {n for n, _ in m.named_parameters()}
    if set(params) != held:
        raise ValueError(
            "params do not match the model: missing "
            f"{sorted(held - set(params))[:4]}, unexpected "
            f"{sorted(set(params) - held)[:4]}")
    for m in shards:
        for name, p in m.named_parameters():
            p.copy_(m.tp_plan.local(name, params[name], m.tp_rank))


@torch.no_grad()
def init_random_params(shards: Sequence[torch.nn.Module], seed: int,
                       order: Optional[Sequence[str]] = None) -> None:
    """Seeded random weights on the model's device, chosen by the module
    that owns each parameter: norm gains 1, norm shifts and every bias 0,
    token and position embeddings normal with std 1, every other weight
    normal with std 1/sqrt(fan-in) (its first dim), drawn in float32 from a
    ``torch.Generator`` in parameter order and cast.  Only the normal
    weights draw, so a model without biases (Llama) draws what it always
    drew.  ``shards``: shard models (``shard_model``), of one mesh or of
    every stage of a pipeline: each weight is drawn at its global shape on
    the first shard's device, in the global model's parameter ``order``
    (default: the first shard's), and every shard holding it copies its
    slice, so the global weights are the same at any degree and any
    stage split (reference ``serve/pp.py:476-503``)."""
    from ..ops.embedding import Embedding, PositionEmbedding

    own = [dict(m.named_parameters()) for m in shards]
    mods = [dict(m.named_modules()) for m in shards]
    order = list(order) if order is not None else list(own[0])
    first = next((p for o in own for p in o.values()), None)
    dev = first.device if first is not None else torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for name in order:
        holders = [i for i, o in enumerate(own) if name in o]
        mod_name, _, pname = name.rpartition(".")
        if pname == "gamma":
            for i in holders:
                own[i][name].fill_(1.0)
            continue
        if pname in ("beta", "bias", "qkv_bias", "o_bias"):
            for i in holders:
                own[i][name].zero_()
            continue
        m0 = shards[holders[0]]
        shape = m0.tp_plan.global_shape(name, own[holders[0]][name].shape)
        mod = mods[holders[0]][mod_name]
        fan_in = (1 if isinstance(mod, (Embedding, PositionEmbedding))
                  else shape[0])
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).mul_(fan_in ** -0.5)
        for i in holders:
            own[i][name].copy_(shards[i].tp_plan.local(
                name, w, shards[i].tp_rank))
        del w
