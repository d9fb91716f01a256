"""Joint TP x PP serve search: price stage-split decode under the HBM cap.

Port of ``flexflow_tpu/search/serve_search.py``: the same pricing, field
for field (``tests/test_torch_serve_search.py`` holds the candidate
tables equal at ``rel=1e-9``), over the port's inputs: a serve model
from ``build_model`` on ``meta`` carrying its capacities
(``register_serve_capacities``, ``mark_gated_lm_head``,
``annotate_int8``), its serve graph (``core/graph.py``) and one
:class:`~flexflow_tpu_torch.serve.pp.StageCost` record a stage in place
of the reference's per-stage PCG plans.  Devices are ``torch`` devices:
``devices=None`` means the CUDA cards (it raises without one), a CUDA
mesh prices with the ``h100`` spec and the CPU with the ``cpu`` test
spec (``MachineModel.for_mesh``); a calibration store is consulted by
``calibration="auto"`` only for a CUDA mesh.

Unity (OSDI'22) searches joint parallelization including pipeline
stages.  This module extends the calibrated serve search to that axis:
every (tp, pp)
factorization of the chip budget is stage-split with the same machinery the
executor uses (``serve.pp.serve_stage_split`` / ``build_stage_plans``), gated
by PER-STAGE ``plan_memory_bytes`` against the per-chip HBM capacity, and
priced with a decode cost model that accounts for what the generic
``simulate`` cannot see:

* **weight re-streaming per micro-batch** — decode is weight-bandwidth-bound
  and every micro-batch through a stage re-reads that stage's weights, so
  micro-batching trades bubble fraction against weight traffic;
* **KV-prefix streaming** — each request's causally-live cache rows move once
  per macro-step regardless of micro-batch count;
* **inter-stage activation transfer** — one boundary hop per micro-batch per
  adjacent stage pair (``MachineModel.transfer_time``);
* **the pipeline bubble** — steady-state decode re-services a micro-batch
  every ``max(m, pp)`` ticks: below ``m = pp`` stages idle ``(pp-m)/pp``
  of the time, at ``m = pp`` the pipeline is full, and ``m > pp`` buys no
  bubble win while re-streaming stage weights (see :func:`pp_serve_cost`).

The returned plan is what ``PipelinedInferenceManager`` executes; the search
and the executor share the stage split, so "fits per stage" means the same
thing in both places.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .machine_model import MachineModel
from .simulator import compose_stage_parts, plan_memory_parts


def _stage_kv_bytes(plan) -> float:
    """Local committed-KV bytes (k/v + int8 scales) of a stage record —
    the per-macro-step cache read bound (err-high: counts the full
    registered capacity, not the instantaneous live prefix, consistent
    with the memory parts' reject-safe contract), over the allocator's
    ``KV_BUFFER_NAMES`` (``serve/pp.py:build_stage_plans``)."""
    return plan.kv_bytes


def pp_serve_cost(stage_plans, machine: MachineModel, n_micro: int = 1,
                  boundary_bytes: float = 0.0, pp_axes=(),
                  kv_fill_frac: float = 1.0,
                  prefill_tok_per_s: float = 0.0,
                  prompt_len: float = 0.0,
                  batch_rows: int = 0,
                  component_scales: Optional[Dict[str, float]] = None
                  ) -> Dict:
    """Simulated STEADY-STATE decode cost for a stage-split serve plan.

    The graph's flat batch (``R_tot`` concurrent decode slots) splits into
    ``m = n_micro`` micro-batches that cycle through the ``S`` stages
    continuously — the multi-step decode scan never drains between tokens,
    so a micro-batch is re-serviced every ``max(m, S)`` ticks:

    * tick (one micro-batch through the bottleneck stage):
      ``W_stage/bw + (flops/mxu + KV/bw + tp_comm)/m + step_overhead + hop``
      — the stage's WEIGHTS re-stream for every micro-batch, while the
      macro-batch's flops / causally-live KV / TP collectives split 1/m
      per micro-batch; ``hop`` is the inter-stage boundary transfer
      (``MachineModel.transfer_time``, one handoff per tick on the
      critical path).
    * per-request TPOT = ``max(m, S) * tick``: with ``m >= S`` the pipeline
      is full and PP is latency-neutral capacity scaling (TPOT ~= the
      single-chip step at the same total concurrency, with 1/S of the
      weights+KV per chip); with ``m < S`` stages idle
      ``(S - m)/S`` of the time — the decode bubble.  Fill/drain costs
      ``(S-1)`` extra ticks once per scan, amortized over its length
      (not counted here).

    Workload-aware terms (price the plan for the TRAFFIC MIX,
    not just the graph) — all default-off, so a workload-less call prices
    exactly as before:

    * ``kv_fill_frac`` scales the committed-KV streaming term: the cache
      read bound is the CAUSALLY LIVE prefix, which the live traffic's
      mean sequence length and occupancy determine (1.0 keeps the
      err-high full-capacity bound).
    * ``prefill_tok_per_s`` (with ``batch_rows``, the flat token batch the
      stage flops were priced at) models prefill INTERFERENCE on steady-
      state decode: arriving prompts eat ``rho`` of the bottleneck
      stage's compute time, inflating effective TPOT by ``1/(1-rho)``.
      Sharding the model (tp or pp) shrinks each chip's share of that
      prefill work through the per-stage flops themselves.
    * ``prompt_len`` adds a TTFT estimate: one request's prefill crosses
      the stages SEQUENTIALLY (pipelining overlaps chunks of different
      requests, not one request's first token), so pp buys TTFT nothing —
      while tp divides the prefill compute per chip.  The classic
      TTFT-vs-TPOT asymmetry that makes the best plan workload-dependent.

    ``component_scales`` (step-level cost attribution, obs/profiler.py):
    per-component multiplicative corrections keyed by the shared
    ``*_ms`` field names (``attention_ms`` / ``mlp_ms`` / ``lm_head_ms``
    / ``kv_stream_ms`` / ``comms_ms`` / ``hop_ms`` /
    ``host_overhead_ms``) — the CalibrationStore's component-level
    ``suggested_scale`` entries, applied to each stage's term BEFORE the
    bottleneck max, so a mispriced hop corrects only the hop.  The tick
    is decomposed exactly: per stage, each op family contributes its own
    weight stream + compute share (attention ops / the LM-head-marked
    Linear / everything else as "mlp"), plus the 1/m-amortized KV stream
    and TP collectives, the per-tick dispatch overhead, and the
    inter-stage hop — the terms SUM to the tick, so the returned
    ``components`` (ms, TPOT basis) sum to ``tpot_s``.

    Returns ``{tpot_s, tick_s, bubble_frac, transfer_s, stage_ticks,
    prefill_util, ttft_s, components}`` (``ttft_s`` None unless
    ``prompt_len`` given).
    """
    spec = machine.spec
    peak = spec.peak_flops_bf16 * spec.mxu_efficiency
    cs = component_scales or {}

    def _sc(name: str) -> float:
        return float(cs.get(f"{name}_ms", 1.0))

    ticks: List[float] = []
    stage_comps: List[Dict[str, float]] = []
    stage_fl: List[float] = []
    stage_w: List[float] = []
    for plan in stage_plans:
        mesh = plan.mesh
        # per-family weight bytes + flops: the component decomposition
        # the calibration ledger reconciles (attention / mlp / lm_head),
        # from the stage record (serve/cost.py's arithmetic)
        fam_w = plan.weights
        fam_fl = plan.flops
        comm = 0.0
        for c in plan.collectives:
            comm += machine.collective_time(c.nbytes, c.axes, mesh)
        kv = _stage_kv_bytes(plan) * kv_fill_frac
        raw = {
            fam: (fam_w[fam] / spec.hbm_bandwidth
                  + fam_fl[fam] / peak / n_micro)
            for fam in ("attention", "mlp", "lm_head")
        }
        raw["kv_stream"] = kv / spec.hbm_bandwidth / n_micro
        raw["comms"] = comm / n_micro
        raw["host_overhead"] = spec.step_overhead
        comps = {name: v * _sc(name) for name, v in raw.items()}
        ticks.append(sum(comps.values()))
        stage_comps.append((comps, raw))
        stage_fl.append(sum(fam_fl.values()))
        stage_w.append(sum(fam_w.values()))
    s = len(stage_plans)
    hop_raw = machine.transfer_time(boundary_bytes / max(n_micro, 1),
                                    pp_axes) if s > 1 else 0.0
    hop = hop_raw * _sc("hop")
    bottleneck = max(range(s), key=lambda i: ticks[i])
    tick = ticks[bottleneck] + hop
    tpot = max(n_micro, s) * tick
    comps, comps_raw = (dict(stage_comps[bottleneck][0]),
                        dict(stage_comps[bottleneck][1]))
    comps["hop"] = hop
    comps_raw["hop"] = hop_raw

    rho = 0.0
    if prefill_tok_per_s > 0 and batch_rows > 0:
        # bottleneck stage's prefill duty cycle; capped so an offered load
        # past saturation prices as "very bad", not divide-by-zero
        tok_s = max(stage_fl) / batch_rows / peak
        rho = min(prefill_tok_per_s * tok_s, 0.95)
        tpot = tpot / (1.0 - rho)

    ttft = None
    if prompt_len > 0 and batch_rows > 0:
        # serial pass over the stages: per stage, compute overlaps that
        # stage's one-time weight stream (max of the two), plus the
        # boundary hops and per-stage dispatch overhead
        ttft = sum(
            max(prompt_len * fl_i / batch_rows / peak,
                w_i / spec.hbm_bandwidth)
            for fl_i, w_i in zip(stage_fl, stage_w)
        ) + (s - 1) * hop + s * spec.step_overhead

    # per-component times on the TPOT basis (x max(m,S), x the same
    # 1/(1-rho) inflation), so components sum to tpot_s — the predicted
    # side of the component-level calibration pairs (the `*_ms` ledger
    # fields shared with obs/profiler.TIME_COMPONENT_FIELDS).
    # ``components_raw`` is the UNSCALED decomposition: the calibration
    # ledger must record the raw model (pre-correcting what the loop is
    # trying to estimate would make the stored scale converge to
    # sqrt(truth) instead of truth — the same principle the memory
    # ledger documents); the scaled ``components`` are what the ranking
    # actually used.
    basis = max(n_micro, s) / (1.0 - rho)
    components = {f"{name}_ms": round(v * basis * 1e3, 6)
                  for name, v in comps.items()}
    components_raw = {f"{name}_ms": round(v * basis * 1e3, 6)
                      for name, v in comps_raw.items()}
    return {
        "tpot_s": tpot,
        "tick_s": tick,
        "bubble_frac": max(0, s - n_micro) / s,
        "transfer_s": hop,
        "stage_ticks": ticks,
        "prefill_util": round(rho, 4),
        "ttft_s": ttft,
        "components": components,
        "components_raw": components_raw,
    }


def _boundary_bytes(graph, split, rows: int) -> float:
    """Worst-case bytes crossing a stage boundary (full macro-batch of
    ``rows`` tokens): the widest exit live set's tensor bytes."""
    worst = 0.0
    for _, _, exit_tids in split[:-1]:
        b = sum(graph.spec(t).nbytes(rows) for t in exit_tids)
        worst = max(worst, b)
    return worst


# default speculation shape for ``spec="auto"`` — SpecInferManager's
# defaults, so "price what the spec manager would run" needs no extra args
DEFAULT_SPEC_SHAPE = {"width": 2, "depth": 3}


def _spec_options(spec) -> List[Dict]:
    """Normalize the ``spec`` search dimension: None/False = off,
    ``"auto"``/True = the default draft shape, a dict = one shape, an
    iterable of dicts = several shapes (each ``{"width", "depth"}``,
    optional ``"acceptance"`` override)."""
    if spec is None or spec is False:
        return []
    if spec is True or spec == "auto":
        return [dict(DEFAULT_SPEC_SHAPE)]
    if isinstance(spec, dict):
        return [dict(spec)]
    return [dict(s) for s in spec]


def _spec_factor(machine: MachineModel, feats: Optional[Dict], opt: Dict):
    """Speculative TPOT multiplier for one draft shape under one machine
    and workload: ``(1 + break_even*depth) / (1 + acceptance*depth)``.

    The break-even acceptance (the machine's
    ``spec_break_even_acceptance``: the acceptance at which one
    macro-step — ``depth`` draft levels + one tree-verify pass
    — costs the same per token as incremental decoding) parametrizes the
    ENTIRE macro-step overhead as ``macro = tpot * (1 + be*depth)``;
    expected committed tokens per macro-step are ``1 + acceptance*depth``
    (the accepted chain + bonus), so the ratio is the spec plan's
    steady-state TPOT relative to the same tp×pp×m plan decoding
    incrementally.  ``acceptance`` comes from the workload profile's
    ``mean_spec_acceptance`` (the live ``spec_acceptance`` histogram the
    verify rounds feed) unless the option overrides it; a cold profile
    (0.0) prices spec strictly WORSE than incremental, so the planner
    never speculates without evidence.  ``break_even`` is the
    calibratable :class:`TPUSpec` constant — ``with_calibration`` files
    and CalibrationStore components named ``spec_break_even_acceptance``
    scale it like any machine constant.

    NOT priced here: the draft model's weights/KV and the spec-tree
    buffers (co-resident HBM — gate them via ``hbm_cap`` or the spec
    manager's dual-allocator accounting); a draft much larger than the
    bench's would also shift the measured break-even.

    Returns ``(factor, acceptance, break_even, depth)``.
    """
    depth = int(opt.get("depth", DEFAULT_SPEC_SHAPE["depth"]))
    acc = opt.get("acceptance")
    if acc is None:
        acc = (feats or {}).get("mean_spec_acceptance", 0.0) or 0.0
    acc = min(max(float(acc), 0.0), 1.0)
    be = machine.spec.spec_break_even_acceptance
    factor = (1.0 + be * depth) / (1.0 + acc * depth)
    return factor, acc, be, depth


def _workload_features(workload) -> Optional[Dict[str, float]]:
    """Normalize a workload argument to the plan-facing feature scalars:
    a :class:`~flexflow_tpu_torch.obs.drift.WorkloadProfile`, a features dict,
    or None."""
    if workload is None:
        return None
    if hasattr(workload, "features"):
        return dict(workload.features())
    if isinstance(workload, dict):
        return dict(workload)
    raise TypeError(f"workload must be a WorkloadProfile or features dict, "
                    f"got {type(workload).__name__}")


def store_component_scales(store) -> Optional[Dict[str, float]]:
    """The CalibrationStore's component-level time scales (step-level
    cost attribution, obs/profiler.py): entries named after the shared
    ``*_ms`` component fields (``attention_ms`` ... ``host_overhead_ms``)
    that clear the store's min-sample gate.  Returns None when the store
    is absent or no component entry applies — the pricing then runs
    exactly as before.  Consulted by :func:`search_serve_plan` (and
    available to :func:`price_plan` callers) at the component-pricing
    layer; constant-level entries (``step_overhead``, ``hbm_bandwidth``,
    ...) keep going through ``MachineModel.with_store`` — the two
    vocabularies are disjoint, so a correction is never applied twice."""
    if store is None:
        return None
    from ..obs.profiler import TIME_COMPONENT_FIELDS

    scales = {f: store.scale_for(f) for f in TIME_COMPONENT_FIELDS}
    scales = {f: s for f, s in scales.items() if s != 1.0}
    return scales or None


def _resolve_store(calibration, devices=()):
    """Resolve the ``calibration`` argument to a CalibrationStore or None.

    ``"auto"`` (the default) loads the port's persisted store artifact
    (``obs.calibration.default_store_path``) when one exists and the
    searched ``devices`` are CUDA devices: the store holds H100
    measurements, which would mis-scale the ``cpu`` test spec (as the
    reference applies measured constants only on its TPU backend).
    ``None``/``False`` disables; a path string or store instance is used
    as given, on any device.  An empty store is returned as None (no
    scales to apply).
    """
    from ..obs.calibration import CalibrationStore, default_store_path

    if calibration is None or calibration is False:
        return None
    if isinstance(calibration, CalibrationStore):
        return calibration if calibration else None
    if calibration == "auto":
        import os

        if not devices or any(torch.device(d).type != "cuda"
                              for d in devices):
            return None
        calibration = default_store_path()
        if calibration is None or not os.path.exists(calibration):
            return None
    store = CalibrationStore.load(str(calibration))
    return store if store else None


def _workload_knobs(feats: Optional[Dict], max_seq,
                    kv_page_size: Optional[int] = None) -> Dict[str, float]:
    """Feature scalars -> the :func:`pp_serve_cost` pricing knobs — ONE
    derivation shared by :func:`search_serve_plan` and :func:`price_plan`,
    so the chooser and the replay/measured side price a workload
    identically (a modeling gap between them would launder into the
    calibration store as fake machine skew).

    Paged-KV awareness (``kv_page_size``, serve/kv_paged.py):

    * the KV stream rounds the mean live depth UP to whole pages — the
      block-granular read bound (a request's cache moves page by page; the
      tail page streams full whatever its fill), slightly err-high like
      every capacity term here;
    * the workload's ``shared_prefix_frac`` (fraction of binds that hit
      the prefix cache) DISCOUNTS the prefill-side terms: shared prefixes
      are prefilled once, so both the prefill-interference rate and the
      TTFT prompt length shrink to the unshared share.  The decode-side
      KV stream is NOT discounted — every request still reads the shared
      pages for itself each step.
    """
    knobs = {"kv_fill_frac": 1.0, "prefill_tok_per_s": 0.0,
             "prompt_len": 0.0, "out_len": 0.0}
    if not feats:
        return knobs
    prompt_len = float(feats.get("mean_prompt_len", 0.0) or 0.0)
    out_len = float(feats.get("mean_output_len", 0.0) or 0.0)
    rate = float(feats.get("arrival_rate_per_s", 0.0) or 0.0)
    occ = float(feats.get("mean_occupancy", 1.0) or 1.0)
    shared = min(max(float(feats.get("shared_prefix_frac", 0.0) or 0.0),
                     0.0), 1.0) if kv_page_size else 0.0
    knobs["prompt_len"] = prompt_len * (1.0 - shared)
    knobs["out_len"] = out_len
    knobs["prefill_tok_per_s"] = rate * prompt_len * (1.0 - shared)
    if max_seq:
        # mean causally-live depth per slot: the whole prompt plus half
        # the output (tokens accrue linearly over a decode); a cold
        # profile (0 fill) keeps the err-high full-capacity bound
        depth = prompt_len + 0.5 * out_len
        if kv_page_size and depth > 0:
            depth = -(-depth // kv_page_size) * kv_page_size
        knobs["kv_fill_frac"] = min(
            1.0, max(occ * depth / max_seq, 0.0)
        ) or 1.0
    return knobs


# committed-cache storage bytes per element (serve/ops.py kv_dtype); int8
# carries float32 scale planes priced separately in _kv_token_bytes
_KV_DTYPE_BYTES = {"int8": 1, "bfloat16": 2, "float16": 2, "float32": 4}


def _kv_token_bytes(model) -> int:
    """Committed-KV bytes ONE token occupies across every attention layer
    of ``model`` (the global one) — the unit the host-tier swap pricing
    (:func:`price_kv_swap`) scales by.  Analytic per layer: K + V vectors
    (``2 * num_kv_heads * head_dim``) at the committed-cache dtype, plus
    the float32 scale planes an int8 cache pages alongside its values
    (``2 * num_kv_heads * 4`` — the [rows, KV, S] k_scale/v_scale
    buffers of serve/kv_paged.py)."""
    from ..serve.ops import IncMultiHeadSelfAttention

    dtype = getattr(getattr(model, "config", None), "dtype", None)
    total = 0
    for op in model.modules():
        if not isinstance(op, IncMultiHeadSelfAttention):
            continue
        dt = str(getattr(op, "kv_dtype", None) or dtype or "float32")
        total += 2 * op.num_kv_heads * op.head_dim * _KV_DTYPE_BYTES.get(dt, 4)
        if dt == "int8":
            total += 2 * op.num_kv_heads * 4
    return total


def price_kv_swap(machine: MachineModel, kv_bytes_per_token: float,
                  tokens: float, prefill_s_per_token: float) -> Dict:
    """Price restoring ``tokens`` of spilled KV from the host tier
    (serve/kv_paged.py ``HostPageTier``) against recomputing them through
    prefill — the planner's spill-vs-recompute decision, made with the
    same :class:`MachineModel` constants everything else prices with.

    * restore: one device<->host transfer of the request's committed
      pages (:meth:`MachineModel.swap_time` — ``host_bandwidth`` /
      ``host_latency``);
    * recompute: re-feeding the same tokens through prefill at the
      plan's achieved prefill rate (``prefill_s_per_token`` — derived
      from the priced TTFT, so it embeds the plan's tp/pp shape).

    ``break_even_tokens``: the resume depth above which restoring wins —
    ``host_latency / (prefill_s_per_token - per_token_swap_s)``; None
    when recompute is cheaper per token at ANY depth (swap link slower
    than prefill), in which case ``prefer_restore`` is False and the
    deployment should skip attaching a host tier for this workload.
    """
    tokens = max(float(tokens), 0.0)
    nbytes = float(kv_bytes_per_token) * tokens
    restore_s = machine.swap_time(nbytes)
    recompute_s = float(prefill_s_per_token) * tokens
    per_tok_swap = float(kv_bytes_per_token) / machine.spec.host_bandwidth
    margin = float(prefill_s_per_token) - per_tok_swap
    break_even = machine.spec.host_latency / margin if margin > 0 else None
    return {
        "tokens": int(round(tokens)),
        "swap_bytes": int(round(nbytes)),
        "restore_ms": round(restore_s * 1e3, 4),
        "recompute_ms": round(recompute_s * 1e3, 4),
        "break_even_tokens": (round(break_even, 1)
                              if break_even is not None else None),
        "prefer_restore": bool(restore_s < recompute_s),
    }


def _resolve_devices(devices) -> List[torch.device]:
    """The devices a search prices over: ``devices`` as given, or every
    CUDA card (None; raises without one, as ``parallel.make_mesh``)."""
    if devices is None:
        from ..utils.platform import resolve_device

        resolve_device("cuda")   # raises without CUDA
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _serve_shape(model):
    """(capacities, KV heads, attention layers) of a serve model; raises
    when it has no attention layer or carries no capacities."""
    from ..serve.cost import recorded_capacities
    from ..serve.ops import IncMultiHeadSelfAttention

    attn = [m for m in model.modules()
            if isinstance(m, IncMultiHeadSelfAttention)]
    if not attn:
        raise ValueError("graph has no serve attention ops")
    caps = recorded_capacities(model)
    if caps is None or not caps.max_tokens:
        raise ValueError("the model carries no serve capacities: call "
                         "register_serve_capacities(model, ..., "
                         "max_tokens_per_batch=...) first")
    return caps, attn[-1].num_kv_heads, len(attn)


def search_serve_plan(
    model,
    n_chips: int,
    machine: Optional[MachineModel] = None,
    hbm_cap: Optional[float] = None,
    n_micro: Sequence[int] = (1, 2, 4),
    devices=None,
    spec_name: Optional[str] = None,
    telemetry=None,
    workload=None,
    calibration="auto",
    kv_page_size=None,
    spec=None,
) -> Dict:
    """Pick the best (tp, pp, n_micro[, spec shape]) for serving
    ``model``'s graph on ``n_chips`` chips.

    ``spec``: add speculative decoding as a search dimension —
    ``"auto"`` prices the default draft shape (width 2 / depth 3), a dict
    or list of dicts prices explicit ``{"width", "depth"}`` shapes.  Each
    fitting tp×pp×m candidate gains spec variants priced by
    :func:`_spec_factor`: TPOT scales by ``(1 + break_even*depth) /
    (1 + acceptance*depth)`` with acceptance read from the workload
    profile's ``mean_spec_acceptance`` (the live histogram the verify
    rounds feed) and the break-even acceptance a calibratable machine
    constant (``TPUSpec.spec_break_even_acceptance``).
    Above break-even the spec variant wins and the plan key gains a
    ``_spec_w{w}d{d}`` suffix (+ a ``spec`` sub-dict with the pricing
    inputs); at or below it the incremental plan is returned — so the
    planner chooses spec vs tp vs pp PER WORKLOAD, and a
    PlanHealthMonitor re-searching on a drifted profile recommends
    flipping spec off when live acceptance degrades.  None (default)
    prices exactly as before.

    ``kv_page_size``: the deployment serves with the paged KV cache
    (serve/kv_paged.py) — the KV stream prices block-granularly (live
    depth rounds up to whole pages) and the workload's
    ``shared_prefix_frac`` discounts the prefill-interference and TTFT
    terms (shared prefixes are prefilled once).  None prices the
    slot-contiguous layout exactly as before.

    ``telemetry``: optional :class:`~flexflow_tpu_torch.obs.Telemetry` — the
    winning plan's predicted TPOT/bubble/transfer/memory are recorded in
    its calibration ledger under ``tp{t}_pp{p}_m{m}``, so the executing
    side only has to add measured values for the predicted-vs-measured
    report (the MachineModel tuning loop).

    ``workload``: optional traffic-mix features (a
    :class:`~flexflow_tpu_torch.obs.drift.WorkloadProfile` or its
    ``features()`` dict).  When given, candidates are priced for THAT
    traffic: the committed-KV stream scales to the live fill fraction,
    arriving prompts charge prefill interference on decode, and the
    ranking objective becomes per-token cost
    ``tpot + ttft / mean_output_len`` (amortized first-token latency) —
    so a prompt-heavy mix can flip the winner toward tp (which
    parallelizes a single prefill) where a decode-heavy mix prefers the
    lower-TPOT plan.  Without it the ranking is pure steady-state TPOT,
    exactly as before.

    ``calibration``: the continuous-calibration read path — ``"auto"``
    (default) consults the persisted
    :class:`~flexflow_tpu_torch.obs.CalibrationStore` artifact when one exists
    (CUDA devices only);
    a store instance / path / None override.  Store components named
    after MachineModel constants correct the machine
    (:meth:`MachineModel.with_store`); field-level components
    (``tpot_ms``/``ttft_ms``/``transfer_ms``/``memory_gb``) scale the
    recorded predictions, so the next predicted-vs-measured pair starts
    from the corrected estimate.  The HBM fits-gate always uses the RAW
    ``plan_memory_bytes`` — calibration must never un-reject a plan the
    err-high capacity contract rejected.

    ``model``: a serve model on ``meta`` (``build_model``) carrying its
    serve capacities (``register_serve_capacities`` with
    ``max_tokens_per_batch`` — InferenceManager/PipelinedInferenceManager
    do this in ``__init__``; callers searching BEFORE building a manager
    call it directly), its LM-head mark (``mark_gated_lm_head``) and any
    int8 annotations (``annotate_int8``), so per-stage memory prices the
    deployment's real buffers.  ``devices``: torch devices (``["cpu"] *
    n`` in the tests; ``["cuda:0"] * n`` prices ``n`` cards on one);
    None is every CUDA card.

    Every tp x pp = n_chips factorization whose tp divides the attention
    kv-heads is stage-split, memory-gated PER STAGE against ``hbm_cap``
    (default: the machine spec's per-chip HBM), and priced by
    :func:`pp_serve_cost` at each micro-batch count.  Returns the best
    admissible plan plus the full candidate table::

        {"tp", "pp", "n_micro", "tpot_ms", "bubble_frac", "transfer_ms",
         "per_stage_gb", "candidates": {"tp{t}_pp{p}": {...}}}

    Raises ValueError when nothing fits — the caller must shard further or
    shrink capacities, never silently over-subscribe HBM.
    """
    from ..parallel.mesh import make_mesh
    from ..serve.pp import build_stage_plans, serve_stage_split

    graph = model.graph
    devices = _resolve_devices(devices)
    caps, kv_heads, n_layers = _serve_shape(model)
    max_seq = caps.max_seq_len

    feats = _workload_features(workload)
    store = _resolve_store(calibration, devices)
    spec_opts = _spec_options(spec)
    rows = caps.max_tokens
    knobs = _workload_knobs(feats, max_seq, kv_page_size)
    kv_fill = knobs["kv_fill_frac"]
    prefill_rate = knobs["prefill_tok_per_s"]
    prompt_len = knobs["prompt_len"]
    out_len = knobs["out_len"]
    # field-level calibration scales (1.0 without a store)
    s_tpot = store.scale_for("tpot_ms") if store else 1.0
    s_ttft = store.scale_for("ttft_ms") if store else 1.0
    s_xfer = store.scale_for("transfer_ms") if store else 1.0
    s_mem = store.scale_for("memory_gb") if store else 1.0
    # component-level scales (attention_ms ... host_overhead_ms): applied
    # inside pp_serve_cost's decomposition, so a store entry learned from
    # per-component reconciliation corrects ONLY that component's term.
    # When they apply, the whole-plan tpot_ms scale is SUPERSEDED — the
    # component layer already corrects the tick it is composed of, and
    # stacking the coarse scale on top would double-correct (the
    # component pairs and the tpot pair were measured on the same runs)
    comp_scales = store_component_scales(store)
    if comp_scales:
        # the coarse whole-field time scales are SUPERSEDED: the
        # component layer already corrects the tick (tpot) and the hop
        # (transfer) it is composed of — stacking them would
        # double-correct, since the component and field pairs were
        # measured on the same runs.  (ttft keeps its field scale: its
        # compute share is not component-corrected; the hop share's
        # residual overlap is second-order.)
        s_tpot = 1.0
        s_xfer = 1.0

    candidates: Dict[str, Dict] = {}
    raw_parts_by_plan: Dict[str, Dict] = {}
    best = None
    spec_be = None  # break-even the spec variants were priced against
    for tp in range(1, n_chips + 1):
        if n_chips % tp or kv_heads % tp:
            continue
        pp = n_chips // tp
        if pp > n_layers or tp > len(devices):
            continue
        # costing mesh: the stage records depend on its size only, so
        # every stage prices over the same tp-wide device slice
        mesh = make_mesh({"tp": tp}, devices[:tp])
        mm = machine or MachineModel.for_mesh(mesh, spec_name=spec_name)
        if store is not None:
            mm = mm.with_store(store)
        cap = hbm_cap if hbm_cap is not None else mm.spec.hbm_capacity
        try:
            split = serve_stage_split(graph, pp)
        except ValueError as e:
            candidates[f"tp{tp}_pp{pp}"] = {"error": str(e)[:80]}
            continue
        plans = build_stage_plans(model, split, [mesh] * pp, caps)
        parts = [plan_memory_parts(p, training=False) for p in plans]
        mem = [pt["total"] for pt in parts]
        # per-component composition across stages (compose_stage_parts —
        # the SAME composition publish_memory records on the deployment
        # side, so the memory ledger reconciles like against like and
        # weights-model and KV-model errors calibrate independently)
        raw_parts = compose_stage_parts(parts)  # bytes
        raw_parts_by_plan[f"tp{tp}_pp{pp}"] = raw_parts
        entry = {
            "tp": tp, "pp": pp,
            "per_stage_gb": [round(b / 1e9, 3) for b in mem],
            "fits": max(mem) <= cap,
            "memory_parts_gb": {k: round(v / 1e9, 4)
                                for k, v in raw_parts.items()},
        }
        bbytes = _boundary_bytes(graph, split, rows)
        by_m = {}
        for m in sorted(set(int(x) for x in n_micro)):
            if m < 1:
                continue
            cost = pp_serve_cost(plans, mm, n_micro=m,
                                 boundary_bytes=bbytes,
                                 kv_fill_frac=kv_fill,
                                 prefill_tok_per_s=prefill_rate,
                                 prompt_len=prompt_len,
                                 batch_rows=rows,
                                 component_scales=comp_scales)
            tpot_s = cost["tpot_s"] * s_tpot
            ttft_s = (cost["ttft_s"] * s_ttft
                      if cost["ttft_s"] is not None else None)
            by_m[str(m)] = {
                "tpot_ms": round(tpot_s * 1e3, 4),
                "bubble_frac": round(cost["bubble_frac"], 4),
                "transfer_ms": round(cost["transfer_s"] * s_xfer * 1e3, 5),
            }
            # variants: the incremental plan plus one spec variant per
            # draft shape (acceptance-aware pricing; the incremental plan
            # is evaluated FIRST, so at exactly break-even — factor 1.0 —
            # the strict < keeps the non-spec plan: speculation must EARN
            # its extra machinery)
            for sopt in [None] + spec_opts:
                sinfo = None
                v_tpot = tpot_s
                if sopt is not None:
                    factor, acc, be, depth = _spec_factor(mm, feats, sopt)
                    spec_be = be
                    v_tpot = tpot_s * factor
                    sinfo = {
                        "width": int(sopt.get("width",
                                              DEFAULT_SPEC_SHAPE["width"])),
                        "depth": depth,
                        "acceptance": round(acc, 4),
                        "break_even": round(be, 4),
                        "factor": round(factor, 4),
                        "tokens_per_step": round(1.0 + acc * depth, 4),
                    }
                # ranking objective: per-generated-token cost — amortize
                # the first token's latency over the expected output
                # length (speculation never changes TTFT: prefill is not
                # speculated)
                obj = v_tpot
                if ttft_s is not None and out_len > 0:
                    obj = v_tpot + ttft_s / out_len
                if sopt is not None:
                    by_m[str(m)].setdefault("spec", {})[
                        f"w{sinfo['width']}d{sinfo['depth']}"] = {
                        "tpot_ms": round(v_tpot * 1e3, 4),
                        "factor": sinfo["factor"],
                        "acceptance": sinfo["acceptance"],
                    }
                elif ttft_s is not None:
                    by_m[str(m)]["ttft_ms"] = round(ttft_s * 1e3, 4)
                    by_m[str(m)]["objective_ms"] = round(obj * 1e3, 4)
                if entry["fits"] and (best is None
                                      or obj < best["objective_s"]):
                    best = {
                        "tp": tp, "pp": pp, "n_micro": m,
                        "tpot_s": v_tpot,
                        "objective_s": obj,
                        "tpot_ms": round(v_tpot * 1e3, 4),
                        "bubble_frac": round(cost["bubble_frac"], 4),
                        "transfer_ms": round(cost["transfer_s"] * s_xfer
                                             * 1e3, 5),
                        "prefill_util": cost["prefill_util"],
                        "per_stage_gb": entry["per_stage_gb"],
                        "spec": sinfo,
                        # the winning plan's per-component decomposition
                        # (the incremental tick's, spec-factor excluded —
                        # the same basis price_plan replays, so component
                        # pairs compare like against like); _raw is the
                        # uncorrected model the ledger records
                        "components_ms": dict(cost["components"]),
                        "components_raw_ms": dict(cost["components_raw"]),
                    }
                    if ttft_s is not None:
                        best["ttft_ms"] = round(ttft_s * 1e3, 4)
                        best["objective_ms"] = round(obj * 1e3, 4)
        entry["by_micro"] = by_m
        candidates[f"tp{tp}_pp{pp}"] = entry

    if best is None:
        raise ValueError(
            f"no tp x pp = {n_chips} plan fits the per-chip HBM cap; "
            f"candidates: { {k: v.get('per_stage_gb') for k, v in candidates.items()} }"
        )
    best["candidates"] = candidates
    best["plan_key"] = f"tp{best['tp']}_pp{best['pp']}_m{best['n_micro']}"
    if best.get("spec"):
        best["plan_key"] += (f"_spec_w{best['spec']['width']}"
                             f"d{best['spec']['depth']}")
    if spec_opts and spec_be is not None:
        # the flip threshold the decision was priced against — visible in
        # the spec_serving dry-run bench section even when the non-spec
        # plan wins
        best["spec_break_even"] = round(spec_be, 4)
    best["memory_parts_gb"] = \
        candidates[f"tp{best['tp']}_pp{best['pp']}"]["memory_parts_gb"]
    if feats:
        best["workload"] = feats
    if kv_page_size:
        best["kv_page_size"] = int(kv_page_size)
        # host-tier spill/restore vs recompute, priced at the winning
        # plan's achieved prefill rate (TTFT / unshared prompt — the same
        # discounted prompt the TTFT was priced over) for the mean live
        # depth a readmitted request resumes at (prompt + half the
        # output, _workload_knobs' depth).  Needs workload features AND a
        # priced TTFT; without either the deployment has no rate to
        # compare the swap link against.
        tok_bytes = _kv_token_bytes(model)
        if (feats and tok_bytes and prompt_len > 0
                and best.get("ttft_ms") is not None):
            mesh = make_mesh({"tp": best["tp"]}, devices[:best["tp"]])
            mm = machine or MachineModel.for_mesh(mesh, spec_name=spec_name)
            if store is not None:
                mm = mm.with_store(store)
            best["kv_swap"] = price_kv_swap(
                mm, tok_bytes, prompt_len + 0.5 * out_len,
                (best["ttft_ms"] / 1e3) / prompt_len)
    if store is not None:
        best["applied_scales"] = store.scales()
    if telemetry is not None and getattr(telemetry, "enabled", False):
        telemetry.record_plan_prediction(
            best["plan_key"],
            tpot_ms=best["tpot_ms"],
            bubble_frac=best["bubble_frac"],
            transfer_ms=best["transfer_ms"],
            memory_gb=round(max(best["per_stage_gb"]) * s_mem, 4),
            ttft_ms=best.get("ttft_ms"),
            # per-component predictions (attention_ms ... hop_ms ...):
            # the decomposed side the StepProfiler/price_plan "executed"
            # components reconcile against, so a prediction error is
            # attributable to ONE mispriced component.  RAW (un-scaled)
            # values — the ledger estimates model-vs-reality, so the
            # store's own corrections must not pre-correct the record
            # (a corrected prediction would EWMA the stored scale toward
            # sqrt(truth) instead of truth)
            **best["components_raw_ms"],
        )
        # byte-side ledger: RAW per-component parts, unscaled AND
        # unrounded (the memory ledger measures model-vs-reality, so
        # calibration must not pre-correct what it is trying to estimate,
        # and the display rounding in memory_parts_gb would zero out
        # sub-0.1MB components or disagree with the unrounded values
        # publish_memory records under the same plan key; the time ledger
        # above records the SCALED memory_gb the ranking actually used)
        from ..obs.memory import publish_predicted_parts

        publish_predicted_parts(
            telemetry, best["plan_key"],
            raw_parts_by_plan[f"tp{best['tp']}_pp{best['pp']}"])
    return best


def price_plan(
    model,
    tp: int,
    pp: int,
    n_micro: int = 1,
    machine: Optional[MachineModel] = None,
    devices=None,
    spec_name: Optional[str] = None,
    workload=None,
    kv_page_size=None,
    spec=None,
    component_scales: Optional[Dict[str, float]] = None,
) -> Dict:
    """Price ONE tp x pp x m factorization with the same stage-split and
    cost machinery :func:`search_serve_plan` ranks with.

    The result carries the per-component ``components`` decomposition
    (``attention_ms`` ... ``host_overhead_ms`` — obs/profiler.py's
    shared vocabulary), so pricing the executing plan on the TRUE
    machine constants yields the "executed" side of a component-level
    calibration pair.  ``component_scales`` replays a store's component
    corrections (see :func:`store_component_scales`).

    The replay/ground-truth half of the calibration loop: given the
    executing plan's coordinates and a DIFFERENT machine model (e.g. the
    true constants in a simulation, or re-calibrated ones after a store
    update), what would the cost model have said?  No memory gate, no
    calibration store — this prices, it does not choose.

    ``spec``: a single draft shape dict (``{"width", "depth"}``, optional
    ``"acceptance"``) — the replayed TPOT scales by the SAME
    :func:`_spec_factor` the chooser used, so a spec-plan calibration
    pair compares like against like (a chooser-vs-replay modeling gap
    would launder into the store as fake machine skew).
    """
    from ..parallel.mesh import make_mesh
    from ..serve.pp import build_stage_plans, serve_stage_split

    graph = model.graph
    devices = _resolve_devices(devices)
    caps, _, _ = _serve_shape(model)
    mesh = make_mesh({"tp": tp}, devices[:tp])
    mm = machine or MachineModel.for_mesh(mesh, spec_name=spec_name)
    split = serve_stage_split(graph, pp)
    plans = build_stage_plans(model, split, [mesh] * pp, caps)
    feats = _workload_features(workload)
    knobs = _workload_knobs(feats, caps.max_seq_len, kv_page_size)
    out_len = knobs.pop("out_len")  # ranking/swap knob, not a cost input
    cost = pp_serve_cost(
        plans, mm, n_micro=n_micro,
        boundary_bytes=_boundary_bytes(graph, split, caps.max_tokens),
        batch_rows=caps.max_tokens,
        component_scales=component_scales,
        **knobs,
    )
    cost["plan_key"] = f"tp{tp}_pp{pp}_m{n_micro}"
    if spec:
        sopt = dict(spec)
        factor, acc, be, depth = _spec_factor(mm, feats, sopt)
        width = int(sopt.get("width", DEFAULT_SPEC_SHAPE["width"]))
        cost["tpot_s"] = cost["tpot_s"] * factor
        cost["spec"] = {"width": width, "depth": depth,
                        "acceptance": round(acc, 4),
                        "break_even": round(be, 4),
                        "factor": round(factor, 4)}
        cost["plan_key"] += f"_spec_w{width}d{depth}"
    cost["tpot_ms"] = round(cost["tpot_s"] * 1e3, 4)
    cost["transfer_ms"] = round(cost["transfer_s"] * 1e3, 5)
    if cost["ttft_s"] is not None:
        cost["ttft_ms"] = round(cost["ttft_s"] * 1e3, 4)
    # host-tier swap pricing on the TRUE machine — same derivation as the
    # chooser's best["kv_swap"], so replayed restore-vs-recompute pairs
    # compare like against like
    if kv_page_size:
        tok_bytes = _kv_token_bytes(model)
        if (feats and tok_bytes and knobs["prompt_len"] > 0
                and cost["ttft_s"] is not None):
            cost["kv_swap"] = price_kv_swap(
                mm, tok_bytes, knobs["prompt_len"] + 0.5 * out_len,
                cost["ttft_s"] / knobs["prompt_len"])
    return cost
