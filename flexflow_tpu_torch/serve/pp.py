"""Pipeline-parallel serving: stage-split decode with micro-batch interleave.

Port of ``flexflow_tpu/serve/pp.py``.  The serve graph (``model.graph``,
``core/graph.py``) is split into ``pp`` contiguous stages at narrow
live-set boundaries (:func:`serve_stage_split`, ``core.graph.live_cuts``);
each stage is a copy of the model holding only its own modules
(:func:`stage_model`), tensor-parallel over its own ``{"tp": t}`` slice of
the mesh as a plain manager is (``parallel/tp.py``), with its own layers'
KV caches; activations hop from stage to stage.  Decode batches split into
``n_micro`` contiguous micro-batches (``BatchConfig.split_microbatches``)
that cycle through the stage chain (Orca-style interleave): while stage
``s`` runs micro-batch ``j``, stage ``s-1`` can run ``j+1``.  Prefill
chunks and tree batches ride the chain whole.

Execution: the reference dispatches one jitted program per stage,
asynchronously; here each stage's shard models run their node range
(``core/interpreter.py``) eagerly and their kernels queue on the stage
device's stream, so the host issues micro-batch ``j+1``'s stage 0 while
the card still runs ``j``'s stage 1 and never waits inside a macro step.
The hop is ``Tensor.to(next_device, non_blocking=True)``: PyTorch runs a
device-to-device copy on the source device's current stream and makes
the destination's current stream wait for it, so it is ordered after
the producing stage's kernels and before the consuming stage's.

Bit-identity: each micro-batch runs the same nodes in the same order on
the same values as the single-stage manager; a stage boundary only says
where activations change devices.  Where a kernel's result depends on
its row count (a GEMM algorithm chosen by ``M``), a micro-batch may round
differently from the whole batch: ``tests/test_torch_pp.py`` holds the
logits within ``atol=rtol=1e-5`` and the greedy streams equal.

What the reference leaves out is left out here too: there is no
``prefill_scan`` (the request manager then prefills chunk by chunk through
:meth:`PipelinedInferenceManager.step`), and ``SpecDecodeScan`` refuses a
pipelined target (speculation runs through the host ``SpecInferManager``,
its tree batches riding the chain whole).

:func:`build_stage_plans` gives the serve planner (``search/
serve_search.py``) one :class:`StageCost` record a stage, in place of the
reference's per-stage PCG plans: the stage's shard-0 model under the
Megatron dict priced at the capacities recorded on the model, and the
collectives of its stage plan (``parallel/tp.py:TPPlan``, a PCG plan of
the stage's nodes).  A pipelined manager takes any strategy dict
(``strategy=``, reference :255, :324-330): each stage plans and runs its
part through the same plan executor as a plain manager.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.graph import live_cuts
from ..obs.profiler import NULL_PROFILER
from ..obs.telemetry import NULL_TELEMETRY
from ..ops.cuda.attention import check_page_size
from ..parallel.comm import run_shards
from ..parallel.tp import (
    Collective,
    TPPlan,
    shard_model,
    tensor_parallel_strategy,
    tp_collectives,
)
from .batch_config import BatchConfig, InferenceResult, batch_to
from .inference_manager import (
    EXIT_BUDGET,
    EXIT_EOS,
    EXIT_NOT_IN_BATCH,
    EXIT_RUNNING,
    init_random_params,
    load_params,
    mark_gated_lm_head,
    param_layout,
    pick_prefill_tile,
    register_serve_capacities,
    step_result,
)
from .kv_allocator import KVAllocator, padded_seq_len
from .kv_paged import PagedKVAllocator, validate_page_tile
from .models.base import StageSpan
from .models.builder import serve_model
from ..utils.platform import torch_dtype


def serve_stage_split(graph, pp: int, out_tid: Optional[int] = None,
                      max_live: int = 2):
    """Split a serve graph's node chain into ``pp`` contiguous stages
    (reference :67-126).

    Cuts are placed at boundaries whose live tensor set is at most
    ``max_live`` wide (Llama-family graphs carry ``{residual, hidden}``
    between decoder layers), balanced so each stage owns an equal share of
    the attention layers.  Ties prefer the narrowest cut, then the latest
    boundary (so norms feeding a layer stay with the upstream stage and
    the next stage starts at its attention).

    Returns ``[(nodes, entry_tids, exit_tids)]`` with ``exit_tids[s] ==
    entry_tids[s+1]`` (sorted), ``entry_tids[0] == graph.input_tids`` and
    ``exit_tids[-1] == [out_tid]``.  A ``pp`` above the attention layer
    count raises.
    """
    nodes = graph.nodes
    if not nodes:
        raise ValueError("empty graph")
    if out_tid is None:
        out_tid = nodes[-1].outputs[-1]
    if pp <= 1:
        return [(list(nodes), list(graph.input_tids), [out_tid])]
    lives = live_cuts(graph, [out_tid])
    is_attn = [n.kind == "attention" for n in nodes]
    total = sum(is_attn)
    if pp > total:
        raise ValueError(f"pp={pp} stages need at least that many attention "
                         f"layers (graph has {total})")
    cum = np.cumsum(is_attn)
    candidates = [i for i in range(len(nodes) - 1)
                  if len(lives[i]) <= max_live]
    cuts: List[int] = []
    lo_attn = 0
    for s in range(1, pp):
        target = total * s / pp
        pool = [i for i in candidates
                if lo_attn < cum[i] < total and (not cuts or i > cuts[-1])]
        if not pool:
            raise ValueError(f"no admissible cut for stage boundary {s} "
                             f"(live sets wider than {max_live}?)")
        best = min(pool, key=lambda i: (abs(cum[i] - target),
                                        len(lives[i]), -i))
        cuts.append(best)
        lo_attn = cum[best]
    bounds = [-1] + cuts + [len(nodes) - 1]
    stages = []
    for s in range(pp):
        seg = nodes[bounds[s] + 1: bounds[s + 1] + 1]
        entry = (list(graph.input_tids) if s == 0
                 else sorted(lives[bounds[s]]))
        exit_ = [out_tid] if s == pp - 1 else sorted(lives[bounds[s + 1]])
        stages.append((seg, entry, exit_))
    return stages


def _prune(mod: torch.nn.Module, keep: set) -> bool:
    """Drop every submodule of ``mod`` that holds no module of ``keep``
    (ids); True when ``mod`` is or holds one."""
    if id(mod) in keep:
        return True
    held = False
    for name, child in list(mod._modules.items()):
        if child is not None and _prune(child, keep):
            held = True
        else:
            del mod._modules[name]
    return held


def stage_model(model: torch.nn.Module, nodes, entry_tids, exit_tids,
                last: bool) -> torch.nn.Module:
    """A copy of ``model`` (on ``meta``) that runs one stage: it holds
    only the modules its ``nodes`` call, under their global paths (so
    state-dict names and cache keys are the global ones), and its forward
    runs that node range (``GatedLMHead.forward_gen`` with ``xs``)."""
    if any(not p.is_meta for p in model.parameters()):
        raise ValueError("a pipelined manager takes a model on the meta "
                         "device (from build_model)")
    sm = copy.deepcopy(model)
    by_name = {n.name: n for n in sm.graph.nodes}
    sm.set_span(StageSpan([by_name[n.name] for n in nodes], entry_tids,
                          exit_tids, last))
    _prune(sm, {id(op) for op in sm.modules_of(sm.span.nodes)
                if op is not None})
    return sm


@dataclasses.dataclass
class StageCost:
    """What one stage of a deployment costs one of its devices, for the
    serve planner (the reference's stage plan, ``serve/pp.py:153-166``):
    its mesh; the weight bytes it streams a pass and its flops at the
    flat token batch, by family (``attention``, ``mlp``, ``lm_head``);
    the committed KV bytes it reads a macro step (``KV_BUFFER_NAMES``);
    its predicted memory parts (``serve/cost.py:memory_parts``); and its
    tensor-parallel collectives with their bytes per device."""

    mesh: object
    weights: Dict[str, float]
    flops: Dict[str, float]
    kv_bytes: float
    memory: Dict[str, float]
    collectives: List[Collective]


def build_stage_plans(model: torch.nn.Module, split, meshes,
                      caps=None) -> List[StageCost]:
    """One :class:`StageCost` a stage of ``split``
    (:func:`serve_stage_split` of ``model.graph``), stage ``s`` over
    ``meshes[s]`` (its ``{"tp": t}`` mesh; only its size matters): the
    stage's model (:func:`stage_model`), sharded by the reference's
    placement at ``t`` (``parallel/tp.py``), is priced through its
    shard-0 model.  ``model`` lies on ``meta`` (``build_model``; nothing
    is allocated, so a 70B shape prices on the CPU) and carries its
    capacities (``register_serve_capacities``, and ``mark_gated_lm_head``
    for a gated LM head); ``caps`` (``serve.cost.Capacities``) overrides
    them."""
    from .cost import (
        family_weight_bytes,
        heavy_flops,
        kv_state_bytes,
        memory_parts,
        recorded_capacities,
    )
    from .kv_allocator import KV_BUFFER_NAMES

    caps = caps or recorded_capacities(model)
    if caps is None or not caps.max_tokens:
        raise ValueError("the model carries no serve capacities: call "
                         "register_serve_capacities(model, ..., "
                         "max_tokens_per_batch=...) first")
    out = []
    for s, ((nodes, entry, exit_), mesh) in enumerate(zip(split, meshes)):
        sm = (model if len(split) == 1
              else stage_model(model, nodes, entry, exit_,
                               s == len(split) - 1))
        plan = TPPlan(sm, mesh, None, caps.max_tokens)
        # one device's model: a sliced copy at a degree above 1, the
        # stage's model itself at 1 (left unmarked)
        shard = shard_model(sm, plan, 0) if plan.degree > 1 else sm
        fl = heavy_flops(shard, caps)
        out.append(StageCost(
            mesh=mesh,
            weights=family_weight_bytes(shard, caps),
            flops={f: fl[f] for f in ("attention", "mlp", "lm_head")},
            kv_bytes=kv_state_bytes(shard, caps, names=KV_BUFFER_NAMES),
            memory=memory_parts(shard, caps),
            collectives=tp_collectives(plan)))
    return out


class _Stage:
    """One pipeline stage: its shard models over its own mesh, its nodes
    and the tensors entering and leaving them, its TP placement
    (``plan``), and its slice of the deployment allocator's per-shard
    buffers."""

    def __init__(self, shards, mesh, kv, lo: int):
        span = shards[0].span
        self.shards = shards
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.nodes = span.nodes
        self.entry_tids = span.entry_tids
        self.exit_tids = span.exit_tids
        self.plan = shards[0].tp_plan
        self._kv = kv
        self._lo = lo

    @property
    def states(self):
        st = self._kv.states
        return None if st is None else st[self._lo:self._lo + len(self.shards)]

    @property
    def state(self):
        """Shard 0's caches of this stage's layers (None unallocated)."""
        st = self.states
        return st[0] if st else None

    def run(self, bc, xs):
        """One pass of ``bc`` over this stage's nodes on every shard (the
        tensors ``xs`` entering it, None for the first stage): shard 0's
        exit tensors, or the logits after the last stage."""
        gens = [m.forward_gen(batch_to(bc, dev), state,
                              self._kv.page_view(dev),
                              None if xs is None else [x.to(dev) for x in xs])
                for m, dev, state in zip(self.shards, self.mesh.devices,
                                         self.states)]
        return run_shards(gens, self.mesh.comm)[0]


class PipelinedInferenceManager:
    """Stage-split serving over a ``{"pp": p, "tp": t}`` mesh (reference
    :198-229): API-compatible with :class:`InferenceManager` for the
    RequestManager (``step``, ``decode_scan``, ``decode_scan_async``,
    ``join_slot``, ``reset``, the capacities), so continuous batching,
    chunked prefill (tiled and LM-head gated), the chained stretch, the
    lifecycle and the host ``SpecInferManager`` run unchanged.

    ``model``: a model from ``build_model`` (on ``meta``), or an
    ``FFModel`` whose graph a serve builder recorded, with ``outputs`` as
    :class:`InferenceManager` takes them (reference :248); ``mesh``: from
    ``parallel.make_mesh({"pp": p, "tp": t}, devices)``, stage ``s`` on
    its ``s``-th slice of ``t`` devices (``["cpu"] * p * t`` in the tests,
    ``["cuda:0"] * p * t`` for every stage and shard on one card).
    ``n_micro``: decode micro-batches per macro step (default ``pp``); a
    count that does not divide ``max_tokens_per_batch`` warns and takes
    the largest divisor below it.  The other arguments are
    :class:`InferenceManager`'s.  ``im.device`` is stage 0's first
    device, where a request manager builds the batches; results and the
    chained stretch's batch live on the last stage's.
    """

    # the handles a RequestManager syncs, as InferenceManager's: stage
    # dispatches land on per-stage trace tracks ("stage0", ...), the fault
    # injector is consulted before every stage dispatch and every hop
    # (retrying a macro step rewrites the same positional KV values), the
    # profiler times the phases ``stage{s}`` and ``hop`` and counts one
    # dispatch per stage launch
    telemetry = NULL_TELEMETRY
    fault_injector = None
    profiler = NULL_PROFILER

    def __init__(self, model: torch.nn.Module, max_requests: int = 8,
                 max_tokens_per_batch: int = 64, max_seq_len: int = 512,
                 mesh=None, n_micro: Optional[int] = None,
                 max_spec_tokens: int = 0, topk: int = 0,
                 kv_dtype: Optional[str] = None,
                 kv_page_size: Optional[int] = None,
                 gate_lm_head: bool = True,
                 strategy: Optional[Dict[str, Dict]] = None, outputs=None):
        model = serve_model(model, outputs)
        if mesh is None or "pp" not in mesh.shape:
            raise ValueError("PipelinedInferenceManager needs a mesh with a "
                             "'pp' axis (use InferenceManager for pure TP)")
        self.mesh = mesh
        self.pp = mesh.shape["pp"]
        self.tp = mesh.shape["tp"]
        self.max_requests = max_requests
        self.max_tokens = max_tokens_per_batch
        self.max_seq_len = max_seq_len
        self.max_spec_tokens = max_spec_tokens
        self.topk = topk
        self.kv_dtype = kv_dtype
        self.kv_page_size = kv_page_size
        self.n_micro = int(n_micro) if n_micro else self.pp
        if self.max_tokens % self.n_micro:
            fixed = max(d for d in range(1, self.n_micro + 1)
                        if self.max_tokens % d == 0)
            warnings.warn(
                f"n_micro={self.n_micro} does not divide "
                f"max_tokens_per_batch={self.max_tokens}; using "
                f"n_micro={fixed}", stacklevel=2)
            self.n_micro = fixed
        # the global model (on meta): its config, graph and parameter
        # order; the stages hold the weights
        self.model = model
        register_serve_capacities(model, max_requests, max_seq_len,
                                  max_spec_tokens, kv_dtype,
                                  max_tokens_per_batch)
        marked = gate_lm_head and mark_gated_lm_head(model, max_requests)
        if len(model.span.exit_tids) != 1:
            raise ValueError("a pipelined manager serves one output")
        split = serve_stage_split(model.graph, self.pp,
                                  model.span.exit_tids[0])
        self.stage_meshes = mesh.stage_meshes()
        if strategy is None:
            strategy = (tensor_parallel_strategy(model, self.tp)
                        if self.tp > 1 else {})
        self.strategy = dict(strategy)
        groups = []
        for s, ((nodes, entry, exit_), smesh) in enumerate(
                zip(split, self.stage_meshes)):
            sm = stage_model(model, nodes, entry, exit_, s == self.pp - 1)
            plan = TPPlan(sm, smesh, self.strategy, max_tokens_per_batch)
            groups.append([shard_model(sm, plan, r).to_empty(device=dev)
                           .eval() for r, dev in enumerate(smesh.devices)])
        shards = [m for g in groups for m in g]
        devices = [d for m in self.stage_meshes for d in m.devices]
        self.device = devices[0]
        self.prefill_tile = pick_prefill_tile(max_tokens_per_batch,
                                              max_seq_len)
        kw = dict(max_spec_tokens=max_spec_tokens, kv_dtype=kv_dtype,
                  stages=self.pp)
        if kv_page_size:
            # one logical block table addresses every stage's page pool
            # (reference :352-364): every stage's buffers share the row x
            # seq geometry, so a page id names the same span in each
            self.kv = PagedKVAllocator(shards, max_requests, max_seq_len,
                                       devices, page_size=kv_page_size, **kw)
            validate_page_tile(kv_page_size, self.prefill_tile)
            check_page_size(kv_page_size, padded_seq_len(max_seq_len))
        else:
            self.kv = KVAllocator(shards, max_requests, max_seq_len, devices,
                                  **kw)
        self.stages = [_Stage(g, m, self.kv, s * self.tp)
                       for s, (g, m) in enumerate(zip(groups,
                                                      self.stage_meshes))]
        # one record per stage, as the reference's per-stage plans (read
        # by obs.replay.plan_key_of)
        self.stage_plans = self.stages
        self._gate_lm_head = bool(gate_lm_head)
        self.lm_head_marked = bool(marked)
        self._params_ready = False

    # ------------------------------------------------------------------
    @property
    def gate_lm_head(self) -> bool:
        return self._gate_lm_head and getattr(self.model, "gates_lm_head",
                                              False)

    @gate_lm_head.setter
    def gate_lm_head(self, value) -> None:
        self._gate_lm_head = bool(value)

    @property
    def shard_groups(self):
        """The shard models, one list per stage."""
        return [st.shards for st in self.stages]

    @property
    def shards(self):
        """Every stage's shard models, stage-major."""
        return [m for st in self.stages for m in st.shards]

    @property
    def state(self):
        """Every stage's shard-0 caches in one dict (a read-only view;
        the live buffers are per stage)."""
        if self.kv.states is None:
            return None
        merged: Dict[str, Dict[str, torch.Tensor]] = {}
        for st in self.stages:
            merged.update(st.state)
        return merged

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The global state dict, gathered from the stages' shards."""
        out = {}
        for st in self.stages:
            own = [dict(m.named_parameters()) for m in st.shards]
            for name in own[0]:
                out[name] = st.plan.whole(name, [o[name] for o in own])
        return out

    @property
    def ready(self) -> bool:
        return self._params_ready and self.kv.states is not None

    @property
    def plan_key(self) -> str:
        """The deployment in the serve search's convention (reference
        :517-519)."""
        return f"tp{self.tp}_pp{self.pp}_m{self.n_micro}"

    @torch.no_grad()
    def init_operators_inference(self, params: Optional[Dict] = None,
                                 seed: int = 0, dtype=None):
        """Fill every stage's parameters and allocate zeroed caches, as
        :meth:`InferenceManager.init_operators_inference`: a global state
        dict goes to the stages by name, each shard taking its slice;
        random weights are drawn in the global model's parameter order
        from one generator, so they equal ``pp = 1``'s for the seed
        (reference :476-503)."""
        shards = self.shards
        if params is None:
            if dtype is not None:
                for m in shards:
                    param_layout(m, torch_dtype(dtype))
            init_random_params(shards, seed, order=[
                n for n, _ in self.model.named_parameters()])
        else:
            load_params(shards, params)
        self._params_ready = True
        self.allocate_kv_cache()
        return self

    def allocate_kv_cache(self):
        """(Re)allocate every stage's zeroed caches."""
        return self.kv.allocate()

    def reset(self):
        self.allocate_kv_cache()

    def publish_memory(self, telemetry, key: Optional[str] = None) -> None:
        """Predicted and allocated HBM per component into the memory
        ledger (reference :521-552), per device with one composition on
        both sides: each component's maximum over stages, ``static``
        (weights + KV) composed per stage first."""
        if telemetry is None or not getattr(telemetry, "enabled", False):
            return
        from ..obs.memory import publish_predicted_parts
        from .cost import compose_stage_parts, plan_memory_parts

        key = key or self.plan_key
        publish_predicted_parts(telemetry, key, compose_stage_parts(
            [plan_memory_parts(self, g[0]) for g in self.shard_groups]))
        if not self.kv.states:
            return
        per_stage = [
            (float(sum(p.numel() * p.element_size()
                       for p in g[0].parameters())), float(kv))
            for g, kv in zip(self.shard_groups,
                             self.kv.stage_bytes(per_device=True))]
        telemetry.memory_plan_allocated(
            key, weights_gb=max(w for w, _ in per_stage) / 1e9,
            kv_gb=max(kv for _, kv in per_stage) / 1e9,
            static_gb=max(w + kv for w, kv in per_stage) / 1e9)

    def stage_memory_bytes(self, training: bool = False) -> List[float]:
        """Each stage's predicted bytes per device (reference :892-899):
        weights + KV + the largest transient; with ``training``, each
        stage's PCG plan priced as a training step's
        (``search/simulator.py:plan_memory_bytes``: four copies of each
        trainable weight, every activation)."""
        if training:
            from ..search.simulator import plan_memory_bytes

            return [plan_memory_bytes(st.plan.plan, training=True)
                    for st in self.stages]
        from .cost import plan_memory_parts

        return [plan_memory_parts(self, g[0])["total"]
                for g in self.shard_groups]

    # ------------------------------------------------------------------
    def _microbatches(self, bc) -> list:
        if isinstance(bc, BatchConfig):
            return bc.split_microbatches(self.n_micro)
        return [bc]   # prefill chunks and tree batches ride whole

    def _dispatch(self, bc, sample, mb: int) -> InferenceResult:
        """One micro-batch through the stage chain (reference :565-613);
        returns the last stage's result (device values, never read)."""
        tel = self.telemetry
        prof = self.profiler
        fi = self.fault_injector
        xs = None
        last = len(self.stages) - 1
        for s, stage in enumerate(self.stages):
            with tel.span("stage_dispatch", cat="pp", track=f"stage{s}",
                          stage=s, mb=mb), prof.phase(f"stage{s}"):
                if fi is not None:
                    fi.maybe_fail(f"stage{s}_dispatch")
                if s > 0:
                    if fi is not None:
                        fi.maybe_fail(f"stage{s}_hop")
                    tel.instant("stage_hop", cat="pp", track=f"stage{s}",
                                stage=s, mb=mb)
                    if tel.enabled:
                        tel.metrics.counter("pp_hops").inc()
                    with prof.phase("hop"):
                        xs = [x.to(stage.device, non_blocking=True)
                              for x in xs]
                if prof.enabled:
                    prof.count("dispatches")
                out = stage.run(bc, xs)
                if s < last:
                    xs = out
                    continue
                if sample is not None:
                    sample = sample[:3] + (sample[3].to(stage.device),)
                return step_result(out, sample, self.topk)

    @staticmethod
    def _merge_results(results: Sequence[InferenceResult]
                       ) -> InferenceResult:
        if len(results) == 1:
            return results[0]
        return InferenceResult(**{
            f.name: (None if getattr(results[0], f.name) is None
                     else torch.cat([getattr(r, f.name) for r in results]))
            for f in dataclasses.fields(InferenceResult)})

    @torch.no_grad()
    def step(self, bc, sample=None) -> InferenceResult:
        """One macro step (reference :628-663): ``n_micro`` micro-batches
        of a decode batch (a prefill chunk or tree batch whole) through
        the stage chain; each micro-batch samples with its rows' folds,
        so the streams are the single-program step's."""
        if not self.ready:
            raise RuntimeError("call init_operators_inference() first")
        mbs = self._microbatches(bc)
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.gauge("pp_bubble_frac").set(
                max(0, self.pp - len(mbs)) / self.pp)
        with tel.span("pp_macro_step", cat="pp", track="pp",
                      n_micro=len(mbs)):
            k = self.max_tokens // len(mbs)
            results = []
            for j, mbc in enumerate(mbs):
                smp = sample
                if sample is not None and len(mbs) > 1:
                    smp = sample[:3] + (sample[3][j * k:(j + 1) * k],)
                results.append(self._dispatch(mbc, smp, j))
        return self._merge_results(results)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def decode_scan(self, bc: BatchConfig, n_steps: int,
                    eos: Optional[int] = None, sample=None,
                    max_position: Optional[int] = None,
                    allowed: Optional[torch.Tensor] = None):
        """``n_steps`` pure-decode macro steps (reference :722-780), each
        micro-batch's next batch derived on the last stage's device, with
        ``allowed`` and ``max_position`` as
        :meth:`InferenceManager.decode_scan` takes them (``max_position``
        None: read from ``bc``).  Returns ``(tokens, live, bc)``."""
        if max_position is None:
            max_position = int(bc.token_position.max())
        self._check_span(max_position, n_steps)
        tokens, live, _, bc = self._scan(bc, n_steps, eos, sample, allowed)
        return tokens, live, bc

    @torch.no_grad()
    def decode_scan_async(self, bc: BatchConfig, n_steps: int,
                          eos: Optional[int] = None, sample=None,
                          allowed: Optional[torch.Tensor] = None,
                          max_position: Optional[int] = None):
        """One chained-stretch segment (reference :782-872): as
        :meth:`InferenceManager.decode_scan_async` (the ``decode_scan``
        fault site, the entry freeze, the budget and EOS freezes and the
        exit codes), nothing read back; returns ``(tokens, live,
        exit_codes, bc)`` on the last stage's device."""
        if max_position is None:
            raise ValueError("decode_scan_async needs the host's "
                             "max_position")
        self._check_span(max_position, n_steps)
        if self.fault_injector is not None:
            self.fault_injector.maybe_fail("decode_scan")
        return self._scan(bc, n_steps, eos, sample, allowed)

    def _check_span(self, max_position: int, n_steps: int) -> None:
        if not self.ready:
            raise RuntimeError("call init_operators_inference() first")
        if max_position + n_steps > self.max_seq_len:
            raise ValueError(
                f"decode_scan would reach position {max_position + n_steps}"
                f" > max_seq_len {self.max_seq_len}")

    def _scan(self, bc, n_steps, eos, sample, allowed):
        """The decode scan, i-major over the micro-batches: step ``i``
        of micro-batch ``j`` goes through the chain, then ``j`` advances
        on the last stage's device (InferenceManager's scan body, row
        for row)."""
        dev = self.stages[-1].device
        mbs = [batch_to(mb, dev) for mb in self._microbatches(bc)]
        m = len(mbs)
        k = self.max_tokens // m
        if allowed is not None:
            allowed = allowed.to(dev)
        folds = None if sample is None else sample[3].to(dev)
        alw = [None if allowed is None else allowed[j * k:(j + 1) * k]
               for j in range(m)]
        present = [mb.request_index >= 0 for mb in mbs]
        alive = [p if a is None else p & (a > 0)
                 for p, a in zip(present, alw)]
        mbs = [mb if a is None else dataclasses.replace(
            mb, request_index=torch.where(al, mb.request_index, -1))
            for mb, a, al in zip(mbs, alw, alive)]
        eos_hit = [torch.zeros_like(p) for p in present]
        toks = [[None] * m for _ in range(n_steps)]
        lives = [[None] * m for _ in range(n_steps)]
        tel = self.telemetry
        if tel.enabled:
            tel.metrics.gauge("pp_bubble_frac").set(
                max(0, self.pp - m) / self.pp)
        for i in range(n_steps):
            with tel.span("pp_decode_macro_step", cat="pp", track="pp",
                          step=i, n_micro=m):
                for j in range(m):
                    smp = None
                    if sample is not None:
                        f = folds[j * k:(j + 1) * k].clone()
                        f[:, 1] += i
                        smp = sample[:3] + (f,)
                    t = self._dispatch(mbs[j], smp, j).token_ids
                    toks[i][j] = t
                    lives[i][j] = alive[j]
                    if alw[j] is not None:
                        alw[j] = alw[j] - alive[j].to(alw[j].dtype)
                        alive[j] = alive[j] & (alw[j] > 0)
                    if eos is not None:
                        hit = lives[i][j] & (t == eos)
                        eos_hit[j] = eos_hit[j] | hit
                        alive[j] = alive[j] & ~hit
                    nxt = mbs[j].advance(t)
                    mbs[j] = dataclasses.replace(
                        nxt, request_index=torch.where(
                            alive[j], nxt.request_index, -1))
        codes = torch.cat([
            torch.where(~p, EXIT_NOT_IN_BATCH,
                        torch.where(e, EXIT_EOS,
                                    torch.where(a, EXIT_RUNNING,
                                                EXIT_BUDGET)))
            for p, e, a in zip(present, eos_hit, alive)]).to(torch.int32)
        return (torch.stack([torch.cat(row) for row in toks]),
                torch.stack([torch.cat(row) for row in lives]), codes,
                BatchConfig.merge_microbatches(mbs))

    @torch.no_grad()
    def join_slot(self, bc: BatchConfig, tok_src: torch.Tensor, src_idx: int,
                  dst: int, slot: int, pos: int, seq_len: int,
                  num_tokens: int, eos: Optional[int] = None) -> BatchConfig:
        """Splice one staged arrival into a running stretch's batch, as
        :meth:`InferenceManager.join_slot`, on the last stage's device,
        where the chained stretch's batch lives (reference :707-720)."""
        prof = self.profiler
        if prof.enabled:
            prof.count("dispatches")
        with prof.phase("dispatch"):
            dev = self.stages[-1].device
            tok = tok_src[src_idx].to(dev)
            active = None if eos is None else tok != eos
            return batch_to(bc, dev).join_row(dst, tok, slot, pos, seq_len,
                                              num_tokens, active=active)
