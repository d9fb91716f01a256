"""The serve half of the simulator: cost families and per-stage memory.

Port of the serve use of ``flexflow_tpu/search/simulator.py``:
``serve_component_of`` (:76), ``step_state_bytes``'s KV stream (:177,
here a stage record's ``kv_bytes``), ``plan_memory_parts`` (:228) and
``compose_stage_parts`` (:290).  The port has no PCG: a "plan" here is a
stage's :class:`~flexflow_tpu_torch.serve.pp.StageCost`, whose numbers
``serve/cost.py`` computes, the one arithmetic the managers' memory
ledger and the profiler's cost card use too.  ``simulate`` and the
training half wait for the PCG planner.
"""

from __future__ import annotations

from typing import Dict

from ..serve.cost import compose_stage_parts, family_of

__all__ = ["compose_stage_parts", "plan_memory_parts", "serve_component_of"]


def serve_component_of(mod) -> str:
    """The cost family of one serve module by its own marks: the
    ``lm_head`` when ``mark_gated_lm_head`` marked it
    (``cost_logit_rows``), else ``serve/cost.py:family_of``'s."""
    marked = getattr(mod, "cost_logit_rows", None) is not None
    return family_of(mod, mod if marked else None)


def plan_memory_parts(plan, training: bool = False) -> Dict[str, float]:
    """The predicted HBM of one device of a stage, in bytes, by component
    (``weights``, ``kv_state``, ``transient``, ``total``; reference
    :228 with ``training=False``)."""
    if training:
        raise NotImplementedError("training memory waits for the PCG "
                                  "planner; the serve planner prices "
                                  "inference")
    return dict(plan.memory)
