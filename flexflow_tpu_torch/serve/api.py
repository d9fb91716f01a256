"""The user's entry point: ``LLM`` and ``SSM``.

Port of ``flexflow_tpu/serve/api.py:26-273``, FlexFlow Serve's flow:
``LLM(model).compile(...)``, then ``llm.generate(prompts)``, with
``ssms=[SSM(...)]`` for SpecInfer.  ``model`` is a local HF checkpoint
directory, a transformers model, a raw HF state dict with its ``config``,
or a ``ServeModelConfig`` for seeded random weights.  ``compile`` builds
the model, its :class:`~.inference_manager.InferenceManager` (on the CUDA
card unless ``device`` says otherwise) and a
:class:`~.request_manager.RequestManager`, or a
:class:`~.spec_infer.SpecInferManager` over the first SSM, with the
reference's defaults: LM-head gating and the chained decode stretch on.

``compile``'s ``telemetry``, ``plan_health``, ``profiler``, ``slo`` and
``brownout`` reach either manager as in the reference (:150-160);
``health`` runs one plan-health check; ``attach_migration`` attaches a
live-migration controller and ``LLM.fleet`` builds the fleet router over
compiled ``LLM``s (reference :178-218).  ``tp > 1`` serves the model
tensor-parallel over ``devices`` (reference :107-109; ``parallel/``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

from ..parallel.mesh import make_mesh
from .convert import params_from_jax
from .inference_manager import InferenceManager
from .models.base import ServeModelConfig, build_model
from .request_manager import GenerationConfig, RequestManager
from .spec_infer import SpecInferManager
from .weights import convert_state_dict, load_hf_model


class LLM:
    def __init__(self, model: Any, tokenizer: Any = None,
                 config: Optional[ServeModelConfig] = None):
        """``model``: a local HF checkpoint path, a transformers model, a
        raw HF state dict (with ``config``), or a ``ServeModelConfig``
        (random weights)."""
        self.tokenizer = tokenizer
        self._sd = None
        if isinstance(model, str):
            self._sd, self.config, tok = load_hf_model(model)
            self.tokenizer = tokenizer or tok
        elif isinstance(model, ServeModelConfig):
            self.config = model
        elif isinstance(model, dict):
            if config is None:
                raise ValueError("a raw state dict needs its config")
            self._sd, self.config = model, config
        else:   # a transformers PreTrainedModel
            self._sd = model.state_dict()
            self.config = config or ServeModelConfig.from_hf_config(
                model.config)
        self.im: Optional[InferenceManager] = None
        self.rm = None

    def compile(self, max_requests: int = 8, max_tokens_per_batch: int = 64,
                max_seq_len: int = 512, tp: int = 1,
                max_spec_tokens: int = 0, topk: int = 0,
                generation_config: Optional[GenerationConfig] = None,
                ssms: Sequence["LLM"] = (), spec_width: int = 2,
                spec_depth: int = 3, dtype=None, kv_dtype=None,
                kv_page_size=None, telemetry=None, resilience=None,
                fault_injector=None, plan_health=None, profiler=None,
                slo=None, brownout=None, device=None,
                share_weights_with: Optional["LLM"] = None,
                devices: Optional[Sequence] = None) -> "LLM":
        """Build the deployment (reference :53-152).  ``dtype`` is the
        parameters' dtype, as in the reference (:124-129): a state dict
        loads in ``dtype``, or float32 when it is None, whatever the
        config's dtype; random weights are drawn in ``dtype`` (None: the
        config's).  The compute and KV dtype stay ``config.dtype``: every
        product casts a weight of another dtype at use, so a bf16
        checkpoint loaded with ``dtype=None`` holds f32 weights, twice
        its bytes, as the reference's does.  ``kv_dtype="int8"`` and
        ``kv_page_size`` choose the KV cache (see ``InferenceManager``);
        ``resilience`` and ``fault_injector`` are the lifecycle policy,
        ``telemetry``, ``plan_health``, ``profiler``, ``slo`` and
        ``brownout`` the control plane (see ``RequestManager``).  The
        first of ``ssms`` is compiled with this model's capacities and
        ``topk = max(spec_width, 1)``.  The
        EOS id comes from the config when ``generation_config`` has
        none.  ``device=None`` is the CUDA card.
        ``tp > 1`` shards the model over ``devices`` (None: ``cuda:0`` ...
        ``cuda:tp-1``, raising on a machine with fewer cards; list one
        device twice, ``["cuda:0", "cuda:0"]``, to place two shards on
        one card, or ``["cpu", "cpu"]``); the SSM is then compiled at
        ``tp=1`` on the first of them, as the reference compiles it.
        ``share_weights_with``: a compiled ``LLM`` of the same config and
        mesh whose model (its parameter tensors, not a copy) this
        deployment serves with its own KV cache: replicas of one model on
        one card for :meth:`fleet` (the port's; the reference builds each
        replica's weights anew)."""
        cfg = self.config
        if ssms and not max_spec_tokens:
            max_spec_tokens = 1 + spec_width * spec_depth
        shared = share_weights_with
        if device is not None:
            if tp != 1:
                raise ValueError(f"tp={tp} places its shards on devices=, "
                                 f"not on one device={device!r}")
            devices = [device]
        mesh = make_mesh({"tp": tp}, devices)
        if shared is not None:
            if shared.im is None or shared.config != cfg:
                raise ValueError("share_weights_with needs a compiled LLM "
                                 "of the same config")
            if mesh.devices != shared.im.mesh.devices:
                raise ValueError("share_weights_with needs a deployment on "
                                 "the same mesh")
            mesh = shared.im.mesh
        self.im = InferenceManager(
            build_model(cfg) if shared is None else shared.im.shards,
            max_requests=max_requests,
            max_tokens_per_batch=max_tokens_per_batch,
            max_seq_len=max_seq_len, max_spec_tokens=max_spec_tokens,
            topk=topk, kv_dtype=kv_dtype, kv_page_size=kv_page_size,
            mesh=mesh)
        if shared is not None:
            self.im.allocate_kv_cache()
        else:
            self._load(self.im, dtype)
        gen = generation_config or GenerationConfig()
        if gen.eos_token_id is None and cfg.eos_token_id is not None:
            gen = dataclass_replace(gen, eos_token_id=cfg.eos_token_id)
        if ssms:
            ssm = ssms[0]
            if ssm.im is None:
                ssm.compile(max_requests=max_requests,
                            max_tokens_per_batch=max_tokens_per_batch,
                            max_seq_len=max_seq_len,
                            max_spec_tokens=max_spec_tokens,
                            topk=max(spec_width, 1), kv_dtype=kv_dtype,
                            kv_page_size=kv_page_size,
                            device=self.im.device)
            self.rm = SpecInferManager(
                self.im, ssm.im, gen, width=spec_width, depth=spec_depth,
                telemetry=telemetry, resilience=resilience,
                fault_injector=fault_injector, plan_health=plan_health,
                profiler=profiler, slo=slo, brownout=brownout)
        else:
            self.rm = RequestManager(self.im, gen, telemetry=telemetry,
                                     resilience=resilience,
                                     fault_injector=fault_injector,
                                     plan_health=plan_health,
                                     profiler=profiler, slo=slo,
                                     brownout=brownout)
        return self

    def health(self):
        """Run and return one plan-health check now (reference :163):
        live TTFT and TPOT against the plan's predictions and the SLO
        targets, workload drift, KV pressure.  None when no monitor was
        attached at :meth:`compile`.  An unhealthy check re-searches
        through the monitor's ``search_fn`` (for example ``lambda:
        search.search_serve_plan(model, n, workload=tel.workload, ...)``
        on a ``meta`` model) and recommends its candidate; a monitor
        without one reports and recommends nothing."""
        if self.rm is None or self.rm.plan_health is None:
            return None
        return self.rm.plan_health.check()

    def attach_migration(self, build_manager, config=None, plan=None):
        """Attach a live-migration controller (``serve/migration.py``,
        reference :178) and return it: it acts on the plan-health
        monitor's ``replan_recommended`` and on ``request_migration``,
        switching plans at a serve tick boundary (drain, rebuild through
        ``build_manager(candidate)``, readmit under the same rids, with
        rollback).  ``self.rm`` and ``self.im`` follow the active
        deployment.  A recommendation carries the searched candidate
        (``search_serve_plan``'s plan dict, whose ``plan_key`` names its
        ``tp{t}_pp{p}_m{m}`` shape, ``migration.plan_shape``); a
        migration may also be requested by hand."""
        if self.rm is None:
            raise RuntimeError("call compile() first")
        from .migration import MigrationController

        def on_switch(new_rm):
            self.rm = new_rm
            self.im = new_rm.im

        return MigrationController(self.rm, build_manager, plan=plan,
                                   config=config, on_switch=on_switch)

    def plan_builder(self, devices: Optional[Sequence] = None, **compile_kw):
        """A ``build_manager`` for :meth:`attach_migration` and the fleet's
        rolling migration: a candidate's plan key ``tp{t}_pp{p}_m{m}...``
        builds this model (the same weights: the same state dict, or the
        same seed) and returns its ready manager: at ``pp = 1`` through
        :meth:`compile` at ``tp=t``, on ``devices`` (tp > 1) or on their
        first (tp = 1); at ``pp > 1`` a
        :class:`~.pp.PipelinedInferenceManager` with ``m`` micro-batches
        over a ``{"pp": p, "tp": t}`` mesh of ``devices`` (None: ``cuda:0``
        ... ``cuda:p*t-1``).  ``compile_kw`` holds the other
        :meth:`compile` arguments (the capacities, ``dtype``, the KV
        options)."""
        from .migration import plan_shape

        def build(candidate):
            shape = plan_shape(candidate.get("plan_key", ""))
            tp, pp = shape["tp"], shape["pp"]
            kw = dict(compile_kw)
            if pp > 1:
                kw.pop("device", None)
                return self._pipelined(make_mesh({"pp": pp, "tp": tp},
                                                 devices), shape["m"], **kw)
            if tp > 1:
                kw.pop("device", None)
            src = self.config if self._sd is None else self._sd
            llm = LLM(src, self.tokenizer, config=self.config)
            llm.compile(tp=tp, devices=devices, **kw)
            return llm.im

        return build

    # compile's arguments that go to the request manager alone
    _RM_ONLY = ("generation_config", "telemetry", "resilience",
                "fault_injector", "plan_health", "profiler", "slo",
                "brownout")

    def _pipelined(self, mesh, n_micro: int, max_requests: int = 8,
                   max_tokens_per_batch: int = 64, max_seq_len: int = 512,
                   max_spec_tokens: int = 0, topk: int = 0,
                   ssms: Sequence["LLM"] = (), spec_width: int = 2,
                   spec_depth: int = 3, dtype=None, kv_dtype=None,
                   kv_page_size=None, **rm_kw):
        """A ready pipelined manager of this model over ``mesh``, sized
        and loaded as :meth:`compile` sizes and loads its manager (``ssms``
        set ``max_spec_tokens``); ``rm_kw`` may hold only compile's
        request-manager arguments, which a manager does not take."""
        from .pp import PipelinedInferenceManager

        unknown = sorted(set(rm_kw) - set(self._RM_ONLY))
        if unknown:
            raise TypeError(f"a pipelined plan takes no {unknown}")
        if ssms and not max_spec_tokens:
            max_spec_tokens = 1 + spec_width * spec_depth
        im = PipelinedInferenceManager(
            build_model(self.config), max_requests=max_requests,
            max_tokens_per_batch=max_tokens_per_batch,
            max_seq_len=max_seq_len, mesh=mesh, n_micro=n_micro,
            max_spec_tokens=max_spec_tokens, topk=topk, kv_dtype=kv_dtype,
            kv_page_size=kv_page_size)
        return self._load(im, dtype)

    def _load(self, im, dtype):
        """``im`` made ready with this model's weights: the state dict in
        ``dtype`` (None: float32), or random ones drawn in ``dtype``
        (None: the config's)."""
        if self._sd is None:
            return im.init_operators_inference(dtype=dtype)
        cfg = self.config
        return im.init_operators_inference(params_from_jax(
            convert_state_dict(self._sd, cfg), cfg, im.device,
            dtype or "float32"))

    @staticmethod
    def fleet(llms, **kwargs):
        """A :class:`~.fleet.FleetRouter` over compiled ``LLM``s, one
        replica each (reference :202); for the streams of one replica
        they share weights and generation config.  Keyword arguments go
        to the router (``gen``, ``telemetry``, ``resilience``,
        ``fault_injector``, ``clock``, ``profiler``, ``config``, ...)."""
        from .fleet import FleetRouter

        rms = []
        for llm in llms:
            if llm.rm is None:
                raise RuntimeError("compile() every fleet member first")
            rms.append(llm.rm)
        return FleetRouter(rms, **kwargs)

    def memory_report(self):
        """``{"kv": the manager's KV snapshot}``, with ``"ledger"``, the
        telemetry's predicted-against-allocated memory report, when a
        handle was attached (reference :223); None before
        :meth:`compile`."""
        if self.rm is None:
            return None
        report = {"kv": self.rm.kv_snapshot()}
        if self.rm.telemetry.enabled:
            report["ledger"] = self.rm.telemetry.memory.report()
        return report

    def generate(self, prompts: Union[str, Sequence],
                 max_new_tokens: Optional[int] = None):
        """Strings in, strings out (with a tokenizer); id lists in, id
        lists out; one prompt, one result (reference :240-263)."""
        if self.rm is None:
            raise RuntimeError("call compile() first")
        if not isinstance(prompts, str) and not len(prompts):
            return []
        single = isinstance(prompts, str) or isinstance(prompts[0], int)
        if single:
            prompts = [prompts]
        texty = isinstance(prompts[0], str)
        if texty:
            if self.tokenizer is None:
                raise ValueError("string prompts need a tokenizer")
            ids = [self.tokenizer.encode(p) for p in prompts]
        else:
            ids = [list(p) for p in prompts]
        outs = self.rm.generate(ids, max_new_tokens)
        if texty:
            outs = [self.tokenizer.decode(o) for o in outs]
        return outs[0] if single else outs


class SSM(LLM):
    """The draft model of SpecInfer: an ``LLM`` passed in ``ssms``."""


def dataclass_replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
