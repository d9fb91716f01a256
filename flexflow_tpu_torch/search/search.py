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

Algebraic substitutions (``substitution=True``, ``search/substitution.py``'s
rules) are proposed inside the same walk, as in Unity: with probability
``p_sub`` (always, when no op has a choice) one match of the current graph
is rewritten, the strategy migrated onto the new nodes, and the new graph
priced whole; the walk's draws (``rng.random() < p_sub``, the match) are
the reference's, in its order, so a seed and a budget give the
reference's graph, dict and ``tid_map``.
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
                   training: bool = True, verbose: bool = False,
                   substitution: bool = False,
                   output_tids: Optional[List[int]] = None,
                   p_sub: float = 0.15,
                   memory_limit: Optional[float] = None,
                   on_infeasible: str = "fallback"):
    """Joint MCMC search over per-op parallel configs and, with
    ``substitution=True``, graph rewrites; returns the best strategy, or
    with ``substitution`` ``(graph, strategy, tid_map)``, ``tid_map``
    taking the original tensor ids to the rewritten graph's (the
    identity when no rewrite was accepted).  ``graph``: a bound serve
    graph (``core/pcg.py:serve_graph``) or a builder graph
    (``FFModel.graph``); rewrites need the latter.  ``output_tids``: the
    tensors no rewrite may remove.  ``memory_limit`` defaults to the
    machine's HBM for a real spec and no limit for the ``cpu`` spec
    (virtual test devices share the host's memory);
    ``on_infeasible="raise"`` raises where nothing fits."""
    if on_infeasible not in ("fallback", "raise"):
        raise ValueError(f"on_infeasible must be 'fallback' or 'raise', got "
                         f"{on_infeasible!r}")
    rng = random.Random(seed)
    mm = machine or MachineModel.for_mesh(mesh)

    def build_candidates(g):
        searchable, candidates = [], {}
        for node in g.nodes:
            in_specs = [g.spec(t) for t in node.inputs]
            cands = enumerate_op_configs(node, in_specs, mesh)
            candidates[node.name] = cands
            if len(cands) > 1:
                searchable.append(node.name)
        return searchable, candidates

    mem_cap = (memory_limit if memory_limit is not None
               else (mm.spec.hbm_capacity if mm.spec.name != "cpu" else 0))

    def cost_of(g, strategy) -> Tuple[float, bool]:
        plan = PCG(g, mesh, strategy, output_tids=None).plan()
        t = simulate(plan, mm, training=training, measured=measured).total
        if mem_cap:
            need = plan_memory_bytes(plan, training=training)
            if need > mem_cap:
                return t * (2.0 + need / mem_cap), False
        return t, True

    if substitution:
        from .substitution import (apply_match, find_all_matches,
                                   standard_rules)

        rules = standard_rules()
        protected = frozenset(output_tids or ())
    cur_graph = graph
    tid_map = {t: t for t in range(len(graph.tensor_specs))}
    searchable, candidates = build_candidates(cur_graph)

    state = dict(init if init is not None
                 else data_parallel_strategy(cur_graph, mesh))
    try:
        cur_cost, cur_feas = cost_of(cur_graph, state)
    except (ValueError, AssertionError):
        state = {}
        cur_cost, cur_feas = cost_of(cur_graph, state)
    best = (cur_graph, dict(state), dict(tid_map))
    best_cost = cur_cost if cur_feas else float("inf")
    # the least-infeasible point seen, returned with a warning when
    # nothing fits (the memory estimate errs high)
    best_any, best_any_cost = (cur_graph, dict(state), dict(tid_map)), cur_cost
    if verbose:
        print(f"search: start cost {cur_cost * 1e3:.3f}ms, "
              f"{len(searchable)} searchable ops, budget {budget}")

    def keep(cost, feasible, what):
        nonlocal best, best_cost, best_any, best_any_cost
        point = (cur_graph, dict(state), dict(tid_map))
        if cost < best_any_cost:
            best_any, best_any_cost = point, cost
        if feasible and cost < best_cost:
            best, best_cost = point, cost
            if verbose:
                print(f"  it {it}: best {best_cost * 1e3:.3f}ms ({what})")

    def metropolis(new_cost) -> bool:
        # the Metropolis criterion (reference FFModel::optimize)
        return new_cost < cur_cost or rng.random() < math.exp(
            (cur_cost - new_cost) / max(alpha * cur_cost, 1e-12))

    accepted = 0
    # matches depend on the graph alone: found when a rewrite is drawn,
    # kept until one is accepted
    cached_matches = None
    for it in range(budget):
        matches = []
        if substitution and (not searchable or rng.random() < p_sub):
            if cached_matches is None:
                cached_matches = find_all_matches(
                    cur_graph, rules,
                    frozenset(tid_map.get(t, -1) for t in protected))
            matches = cached_matches
        if matches:
            # the graph-rewrite proposal (the GraphXfer move)
            m = rng.choice(matches)
            try:
                res = apply_match(cur_graph, m)
            except (ValueError, AssertionError):
                continue
            prop_state = _migrate(state, cur_graph, m, res, mesh)
            try:
                new_cost, new_feas = cost_of(res.graph, prop_state)
            except (ValueError, AssertionError):
                continue
            if metropolis(new_cost):
                cur_graph, state, cur_cost = res.graph, prop_state, new_cost
                tid_map = {t: res.tid_map[n] for t, n in tid_map.items()
                           if n in res.tid_map}
                searchable, candidates = build_candidates(cur_graph)
                cached_matches = None
                accepted += 1
                keep(cur_cost, new_feas, f"rewrite {m.rule.name}")
            continue

        if not searchable:
            break
        # the parallel-config proposal
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
            new_cost, new_feas = cost_of(cur_graph, proposal)
        except (ValueError, AssertionError):
            continue
        if metropolis(new_cost):
            state, cur_cost = proposal, new_cost
            accepted += 1
            keep(cur_cost, new_feas, f"{name} -> {cand}")

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
    return best if substitution else best[1]


def _migrate(state: Dict[str, Config], graph, match, res, mesh
             ) -> Dict[str, Config]:
    """The strategy carried across a rewrite (reference :187-205): an
    untouched node keeps its config; a consumed node's goes to the node
    that replaces it (``res.name_map``), the first one only, and only if
    the new op takes it (its dims survive the fusion)."""
    consumed = {graph.nodes[i].name for i in match.nids}
    out: Dict[str, Config] = {}
    for name, cfg in state.items():
        if name not in consumed:
            out[name] = cfg
            continue
        new_name = res.name_map.get(name)
        if new_name is None or new_name in out:
            continue
        node = next((n for n in res.graph.nodes if n.name == new_name), None)
        if node is None:
            continue
        in_specs = [res.graph.spec(t) for t in node.inputs]
        try:
            node.op.apply_config(cfg, in_specs, mesh)
            out[new_name] = cfg
        except (ValueError, KeyError):
            pass
    return out
