"""The Unity search over per-op parallel configs.

Port of ``flexflow_tpu/search/search.py`` (``enumerate_op_configs`` :36,
``graph_optimize`` :74; the reference's ``graph_optimize`` / ``FFModel::
optimize`` MCMC): per op, the candidates are the assignments of mesh axes
to the op's parallel dims (the MachineView analogue), enumerated up
front; a Metropolis walk proposes single-op config changes and the
simulator (``search/simulator.py:simulate``) prices whole plans, the
parallel ops the PCG inserts priced as the communication they become.
Memory-aware (reference ``memory_optimization.cc``): a plan whose
per-device bytes (``plan_memory_bytes``) exceed the limit never becomes
the best, but the walk may cross it under a cost penalty; when nothing
fits, the least-infeasible strategy comes back with a ``UserWarning``.
The walk draws from ``random.Random(seed)`` in the reference's order, so
a seed and a budget give the reference's strategy.

Algebraic substitutions (``substitution=True``, the reference's
``substitution.py``) come with slice 10b-ii and raise here.
"""

from __future__ import annotations

import itertools
import math
import random
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.pcg import PCG
from ..parallel.mesh import data_parallel_strategy
from .machine_model import MachineModel
from .simulator import plan_memory_bytes, simulate

Config = Dict[str, Tuple[str, ...]]


def enumerate_op_configs(node, in_specs, mesh) -> List[Config]:
    """Every valid assignment of mesh axes to one op's parallel dims."""
    pdims = node.op.parallel_dims(in_specs)
    axes = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    if not axes or not pdims:
        return [{}]
    names = list(pdims.keys())
    configs: List[Config] = []
    seen = set()
    for assign in itertools.product([None] + names, repeat=len(axes)):
        cfg: Dict[str, Tuple[str, ...]] = {}
        for axis, pd in zip(axes, assign):
            if pd is not None:
                cfg.setdefault(pd, ())
                cfg[pd] = cfg[pd] + (axis,)
        ok = True
        for pd, ax in cfg.items():
            deg = int(np.prod([mesh.shape[a] for a in ax]))
            if pdims[pd] % deg != 0:
                ok = False
                break
        if not ok:
            continue
        try:
            node.op.apply_config(cfg, list(in_specs), mesh)
        except (ValueError, KeyError):
            continue
        key = tuple(sorted((k, v) for k, v in cfg.items()))
        if key not in seen:
            seen.add(key)
            configs.append(cfg)
    return configs or [{}]


def graph_optimize(graph, mesh, budget: int = 500, alpha: float = 0.05,
                   machine: Optional[MachineModel] = None,
                   measured: Optional[Dict] = None, seed: int = 0,
                   init: Optional[Dict[str, Config]] = None,
                   training: bool = False, verbose: bool = False,
                   substitution: bool = False,
                   output_tids: Optional[List[int]] = None,
                   p_sub: float = 0.15,
                   memory_limit: Optional[float] = None,
                   on_infeasible: str = "fallback"):
    """MCMC search over per-op parallel configs; returns the best
    strategy.  ``graph``: a bound graph (``core/pcg.py:serve_graph``).
    ``memory_limit`` defaults to the machine's HBM for a real spec and
    no limit for the ``cpu`` spec (virtual test devices share the host's
    memory); ``on_infeasible="raise"`` raises where nothing fits."""
    if substitution:
        raise NotImplementedError(
            "graph substitutions (search/substitution.py) come with slice "
            "10b-ii; run graph_optimize with substitution=False")
    if on_infeasible not in ("fallback", "raise"):
        raise ValueError(f"on_infeasible must be 'fallback' or 'raise', got "
                         f"{on_infeasible!r}")
    rng = random.Random(seed)
    mm = machine or MachineModel.for_mesh(mesh)

    searchable, candidates = [], {}
    for node in graph.nodes:
        in_specs = [graph.spec(t) for t in node.inputs]
        cands = enumerate_op_configs(node, in_specs, mesh)
        candidates[node.name] = cands
        if len(cands) > 1:
            searchable.append(node.name)

    mem_cap = (memory_limit if memory_limit is not None
               else (mm.spec.hbm_capacity if mm.spec.name != "cpu" else 0))

    def cost_of(strategy) -> Tuple[float, bool]:
        plan = PCG(graph, mesh, strategy, output_tids=None).plan()
        t = simulate(plan, mm, training=training, measured=measured).total
        if mem_cap:
            need = plan_memory_bytes(plan, training=training)
            if need > mem_cap:
                return t * (2.0 + need / mem_cap), False
        return t, True

    state = dict(init if init is not None
                 else data_parallel_strategy(graph, mesh))
    try:
        cur_cost, cur_feas = cost_of(state)
    except (ValueError, AssertionError):
        state = {}
        cur_cost, cur_feas = cost_of(state)
    best, best_cost = dict(state), cur_cost if cur_feas else float("inf")
    # the least-infeasible strategy seen, returned with a warning when
    # nothing fits (the memory estimate errs high)
    best_any, best_any_cost = dict(state), cur_cost
    if verbose:
        print(f"search: start cost {cur_cost * 1e3:.3f}ms, "
              f"{len(searchable)} searchable ops, budget {budget}")

    accepted = 0
    for it in range(budget):
        if not searchable:
            break
        name = rng.choice(searchable)
        cand = rng.choice(candidates[name])
        if cand == state.get(name, {}):
            continue
        proposal = dict(state)
        if cand:
            proposal[name] = cand
        else:
            proposal.pop(name, None)
        try:
            new_cost, new_feas = cost_of(proposal)
        except (ValueError, AssertionError):
            continue
        # the Metropolis criterion (reference FFModel::optimize)
        if new_cost < cur_cost or rng.random() < math.exp(
                (cur_cost - new_cost) / max(alpha * cur_cost, 1e-12)):
            state, cur_cost = proposal, new_cost
            accepted += 1
            if cur_cost < best_any_cost:
                best_any, best_any_cost = dict(state), cur_cost
            if new_feas and cur_cost < best_cost:
                best, best_cost = dict(state), cur_cost
                if verbose:
                    print(f"  it {it}: best {best_cost * 1e3:.3f}ms "
                          f"({name} -> {cand})")

    if verbose:
        print(f"search: done, best {best_cost * 1e3:.3f}ms "
              f"({accepted}/{budget} accepted)")
    if math.isinf(best_cost):
        if on_infeasible == "raise":
            raise ValueError(
                "graph_optimize found no strategy within the device memory "
                f"limit ({mem_cap / 1e9:.2f}GB) in {budget} iterations")
        warnings.warn(
            "graph_optimize found no strategy within the device memory "
            f"limit ({mem_cap / 1e9:.2f}GB) in {budget} iterations; "
            "returning the least-infeasible strategy (the memory estimate "
            "errs high, so the plan may still run; set memory_limit=0 to "
            "disable the check)", stacklevel=2)
        best = best_any
    return best
