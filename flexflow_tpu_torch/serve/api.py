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
``health`` runs one plan-health check.  Left out: ``attach_migration`` and
``fleet`` (live migration and the fleet router, ROADMAP slice 8b) raise
``NotImplementedError``; ``tp > 1`` waits for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

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
                slo=None, brownout=None, device=None) -> "LLM":
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
        none.  ``device=None`` is the CUDA card."""
        if tp != 1:
            raise NotImplementedError(
                f"tp={tp}: tensor-parallel serving is the multi-GPU slice "
                "of the port (ROADMAP), not ported yet")
        cfg = self.config
        if ssms and not max_spec_tokens:
            max_spec_tokens = 1 + spec_width * spec_depth
        self.im = InferenceManager(
            build_model(cfg), max_requests=max_requests,
            max_tokens_per_batch=max_tokens_per_batch,
            max_seq_len=max_seq_len, device=device,
            max_spec_tokens=max_spec_tokens, topk=topk, kv_dtype=kv_dtype,
            kv_page_size=kv_page_size)
        if self._sd is not None:
            self.im.init_operators_inference(params_from_jax(
                convert_state_dict(self._sd, cfg), cfg, self.im.device,
                dtype or "float32"))
        else:
            self.im.init_operators_inference(dtype=dtype)
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
                            kv_page_size=kv_page_size, device=device)
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
        attached at :meth:`compile`.  With no re-search function (the
        port has no planner yet) an unhealthy check reports and
        recommends nothing."""
        if self.rm is None or self.rm.plan_health is None:
            return None
        return self.rm.plan_health.check()

    def attach_migration(self, build_manager, config=None, plan=None):
        """Live plan migration (reference :178) is ROADMAP slice 8b,
        not ported yet."""
        raise NotImplementedError(
            "attach_migration: live plan migration is slice 8b of the "
            "port (ROADMAP), not ported yet")

    @staticmethod
    def fleet(llms, **kwargs):
        """The fault-tolerant fleet router (reference :202) is ROADMAP
        slice 8b, not ported yet."""
        raise NotImplementedError(
            "LLM.fleet: the fleet router is slice 8b of the port "
            "(ROADMAP), not ported yet")

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
