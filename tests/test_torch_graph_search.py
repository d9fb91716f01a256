"""The port's simulator, Unity search and strategy files vs the JAX
package's, on the CPU.

``flexflow_tpu_torch.search.{simulator,search,strategy}`` against
``flexflow_tpu.search.{simulator,search,strategy}`` over the same serve
graphs (the reference's through ``FFModel``, the port's model on
``meta`` bound by ``core/pcg.py:serve_graph``), with the same serve
capacities and the LM head marked on both sides, priced under the same
``cpu`` machine spec:

* ``simulate(plan, training=False)`` (total, compute, comm) and
  ``plan_memory_bytes`` / ``plan_memory_parts`` at ``rel=1e-9`` for the
  plans of ``tests/test_torch_pcg.py`` (five families, ``tp`` 2 and 4,
  ``{}``, Megatron and all-``sample``), fp and int8 (``annotate_int8``,
  an int8 KV cache);
* ``enumerate_op_configs`` equal node by node;
* ``graph_optimize(budget=150, seed=0, training=False)`` returning the
  reference's dict and cost (the same ``random.Random`` walk);
* ``searched_serve_strategy`` at its defaults, under a memory limit the
  replicated plan exceeds (``tests/test_serve_search.py:107-131``), and
  warning where nothing fits;
* ``save_strategy``/``load_strategy`` round-trip, across the packages
  too.
"""

import dataclasses
import math

import pytest

from flexflow_tpu import FFConfig, FFModel
from flexflow_tpu.core.pcg import PCG as JPCG
from flexflow_tpu.search import search as JSEARCH
from flexflow_tpu.search import simulator as JSIM
from flexflow_tpu.search import strategy as JSTRAT
from flexflow_tpu.search.machine_model import TPU_SPECS as JAX_SPECS
from flexflow_tpu.search.machine_model import MachineModel as JaxMachine
from flexflow_tpu.serve import ServeModelConfig as JaxConfig
from flexflow_tpu.serve import build_model as jax_build_model
from flexflow_tpu.serve import searched_serve_strategy as jax_searched
from flexflow_tpu.serve.inference_manager import (
    mark_gated_lm_head as jax_mark,
    register_serve_capacities as jax_register,
    tensor_parallel_strategy as jax_strategy,
)
from flexflow_tpu.serve.quant import annotate_int8 as jax_annotate_int8
import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.core.pcg import PCG, serve_graph
from flexflow_tpu_torch.search import TPU_SPECS, MachineModel
from flexflow_tpu_torch.search import search as PSEARCH
from flexflow_tpu_torch.search import simulator as PSIM
from flexflow_tpu_torch.search import strategy as PSTRAT
from flexflow_tpu_torch.parallel.tp import tensor_parallel_strategy

from test_serve import TINY
from test_torch_pcg import BASE, FAMILIES, ROWS, meshes

CAPS = dict(max_requests=8, max_seq_len=64, max_spec=4)


def machines():
    return JaxMachine(JAX_SPECS["cpu"]), MachineModel(TPU_SPECS["cpu"])


def both(fields, degree, caps=CAPS, kv_dtype=None, int8=False):
    """The reference's graph and the port's model of one configuration,
    capacities registered and the LM head marked on both, over
    ``{"tp": degree}``."""
    jm, pm = meshes({"tp": degree})
    ff = FFModel(FFConfig(), mesh=jm)
    jax_build_model(ff, JaxConfig(**fields), ROWS)
    model = PS.build_model(PS.ServeModelConfig(**fields))
    if int8:
        jax_annotate_int8(ff.graph)
        PS.annotate_int8(model)
    jax_register(ff.graph, caps["max_requests"], caps["max_seq_len"],
                 caps["max_spec"], kv_dtype)
    jax_mark(ff.graph, [ff.graph.nodes[-1].outputs[-1]],
             caps["max_requests"])
    PS.register_serve_capacities(model, caps["max_requests"],
                                 caps["max_seq_len"], caps["max_spec"],
                                 kv_dtype, max_tokens_per_batch=ROWS)
    PS.mark_gated_lm_head(model, caps["max_requests"])
    return ff, jm, model, pm


def strategies(ff, jm, model, degree):
    mega = tensor_parallel_strategy(model, degree)
    assert mega == jax_strategy(ff.graph, ("tp",), jm)
    return {"none": {}, "megatron": mega,
            "sample": {n.name: {"sample": ("tp",)} for n in ff.graph.nodes}}


def close(a, b):
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-18)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_simulate_and_memory_equal_reference(family):
    jmm, pmm = machines()
    fields = {**BASE, **FAMILIES[family]}
    for degree, int8 in ((2, False), (4, False), (2, True)):
        ff, jm, model, pm = both(fields, degree, int8=int8,
                                 kv_dtype="int8" if int8 else None)
        for name, strat in strategies(ff, jm, model, degree).items():
            jp = JPCG(ff.graph, jm, strat).plan()
            pp = PCG(serve_graph(model, ROWS), pm, strat).plan()
            jc = JSIM.simulate(jp, jmm, training=False)
            pc = PSIM.simulate(pp, pmm, training=False)
            for f in ("total", "compute", "comm"):
                assert close(getattr(pc, f), getattr(jc, f)), (name, f)
            jparts = JSIM.plan_memory_parts(jp, training=False)
            pparts = PSIM.plan_memory_parts(pp, training=False)
            assert pparts.keys() == jparts.keys()
            for k in jparts:
                assert close(pparts[k], jparts[k]), (name, k)
            assert close(PSIM.plan_memory_bytes(pp, training=False),
                         JSIM.plan_memory_bytes(jp, training=False))
            assert pparts["kv_state"] > 0


def test_enumerate_op_configs_equal_reference():
    for family in FAMILIES:
        for degree in (2, 4):
            ff, jm, model, pm = both({**BASE, **FAMILIES[family]}, degree)
            g = serve_graph(model, ROWS)
            for jn, pn in zip(ff.graph.nodes, g.nodes):
                assert pn.name == jn.name
                want = JSEARCH.enumerate_op_configs(
                    jn, [ff.graph.spec(t) for t in jn.inputs], jm)
                got = PSEARCH.enumerate_op_configs(
                    pn, [g.spec(t) for t in pn.inputs], pm)
                assert got == want, (family, degree, jn.name)


@pytest.mark.parametrize("family,degree", [
    ("llama", 2), ("llama", 4), ("opt", 2), ("falcon_7b", 2),
    ("starcoder", 4)])
def test_graph_optimize_returns_reference_strategy(family, degree):
    """The same seed and budget walk to the same dict, at the same
    simulated cost, no worse than the Megatron dict's."""
    jmm, pmm = machines()
    ff, jm, model, pm = both({**BASE, **FAMILIES[family]}, degree)
    want = JSEARCH.graph_optimize(ff.graph, jm, budget=150, seed=0,
                                  training=False, machine=jmm)
    g = serve_graph(model, ROWS)
    got = PSEARCH.graph_optimize(g, pm, budget=150, seed=0,
                                 training=False, machine=pmm)
    assert got == want
    cost = PSIM.simulate(PCG(g, pm, got).plan(), pmm, training=False).total
    assert close(cost, JSIM.simulate(JPCG(ff.graph, jm, want).plan(), jmm,
                                     training=False).total)
    mega = tensor_parallel_strategy(model, degree)
    assert cost <= PSIM.simulate(PCG(g, pm, mega).plan(), pmm,
                                 training=False).total * 1.001


def test_searched_serve_strategy_defaults_equal_reference():
    """At its defaults (the ``cpu`` machine of a CPU mesh, its HBM as the
    memory limit) the port's searched dict is the reference's, and the
    defaults are the ones the reference wires in."""
    fields = dataclasses.asdict(TINY)
    ff, jm, model, pm = both(fields, 2, caps=dict(max_requests=2,
                                                  max_seq_len=32,
                                                  max_spec=0))
    ff.mesh = jm
    seen = {}
    orig = PSEARCH.graph_optimize

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)

    PSEARCH.graph_optimize, real = spy, PSEARCH.graph_optimize
    try:
        got = PS.searched_serve_strategy(model, budget=150, seed=0, mesh=pm)
    finally:
        PSEARCH.graph_optimize = real
    assert seen["machine"].spec.name == "cpu"
    assert seen["memory_limit"] == seen["machine"].spec.hbm_capacity
    assert seen["training"] is False
    assert got == jax_searched(ff, budget=150, seed=0)
    assert got, "the search chose nothing"


def test_memory_limit_respected_and_warned_as_reference():
    """``tests/test_serve_search.py:107-131``: under a limit between the
    replicated and the head-sharded plans' bytes the searched plan fits,
    as the reference's does (the same dict); a limit nothing meets warns
    and returns the least-infeasible strategy."""
    fields = dataclasses.asdict(TINY)
    caps = dict(max_requests=8, max_seq_len=2048, max_spec=8)
    ff, jm, model, pm = both(fields, 2, caps=caps)
    ff.mesh = jm
    g = serve_graph(model, ROWS)
    m_repl = PSIM.plan_memory_bytes(PCG(g, pm, {}).plan(), training=False)
    m_tp = PSIM.plan_memory_bytes(PCG(g, pm, tensor_parallel_strategy(
        model, 2)).plan(), training=False)
    assert m_tp < m_repl
    limit = (m_repl + m_tp) / 2
    got = PS.searched_serve_strategy(model, budget=150, seed=0,
                                     memory_limit=limit, mesh=pm)
    assert PSIM.plan_memory_bytes(PCG(g, pm, got).plan(),
                                  training=False) <= limit
    assert got == jax_searched(ff, budget=150, seed=0, memory_limit=limit)
    with pytest.warns(UserWarning, match="memory"):
        low = PS.searched_serve_strategy(model, budget=60, seed=0,
                                         memory_limit=1024.0, mesh=pm)
    with pytest.warns(UserWarning, match="memory"):
        assert low == jax_searched(ff, budget=60, seed=0,
                                   memory_limit=1024.0)
    with pytest.raises(ValueError, match="memory"):
        PSEARCH.graph_optimize(g, pm, budget=20, training=False,
                               machine=machines()[1], memory_limit=1024.0,
                               on_infeasible="raise")


def test_strategy_files_round_trip_across_packages(tmp_path):
    strat = {"lm_head": {"sample": ("tp",)},
             "model.layers.0.self_attn": {"head": ("tp",)},
             "model.layers.0.mlp.down_proj": {"channel_in": ("tp",)}}
    _, pm = meshes({"tp": 2})
    p, j = tmp_path / "port.json", tmp_path / "jax.json"
    PSTRAT.save_strategy(str(p), strat, pm)
    assert PSTRAT.load_strategy(str(p)) == strat
    assert JSTRAT.load_strategy(str(p)) == strat
    JSTRAT.save_strategy(str(j), strat)
    assert PSTRAT.load_strategy(str(j)) == strat
    assert p.read_text().replace('{\n  "tp": 2\n }', "null") == \
        j.read_text()
