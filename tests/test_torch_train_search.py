"""The port's training-mode pricing, memory estimate and measured op-cost
cache against the JAX package's, on the CPU (modelled on
``tests/test_search.py`` and ``tests/test_memory_search.py``).

* ``simulate(training=True)`` (total, compute, comm, ``grad_comm``) and
  ``plan_memory_parts`` / ``plan_memory_bytes`` with training at
  ``rel=1e-9`` under the ``cpu``, ``v5e`` and ``h100`` specs (the
  reference given the port's ``h100`` constants), for the Transformer
  classifier and an MLP on ``{"dp": 2, "tp": 2}`` under several dicts;
* F5: the four functions' ``training`` defaults and
  ``PipelinedInferenceManager.stage_memory_bytes(training=)`` equal the
  reference's;
* F6: the measured-cost key (``repr``) of every standard probe op and of
  every op step of the Transformer classifier's plans equals the
  reference's, and the port's probe list yields every key of
  ``artifacts/tpu_costs_v5e.json``;
* priced with that cache under ``v5e``, plans cost the reference's (with
  cache hits), the searched strategy equals the reference's and beats
  data parallelism, and the serve search takes the cache too;
* the memory-aware search under a limit, and the cost cache's file.
"""

import dataclasses
import inspect
import json
import math
import os

import jax
import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.pcg import PCG as JPCG
from flexflow_tpu.models.transformer import \
    build_transformer_classifier as jax_transformer
from flexflow_tpu.parallel.mesh import data_parallel_strategy as jax_dp
from flexflow_tpu.search import measure as JMEASURE
from flexflow_tpu.search import search as JSEARCH
from flexflow_tpu.search import simulator as JSIM
from flexflow_tpu.search.machine_model import TPU_SPECS as JAX_SPECS
from flexflow_tpu.search.machine_model import MachineModel as JaxMachine
from flexflow_tpu.search.machine_model import TPUSpec as JaxSpec
from flexflow_tpu.serve.pp import PipelinedInferenceManager as JaxPIM
import flexflow_tpu_torch.serve as PS
from flexflow_tpu_torch.core.pcg import PCG
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as port_transformer
from flexflow_tpu_torch.parallel.mesh import data_parallel_strategy
from flexflow_tpu_torch.search import measure as PMEASURE
from flexflow_tpu_torch.search import search as PSEARCH
from flexflow_tpu_torch.search import simulator as PSIM
from flexflow_tpu_torch.search.machine_model import H100_SOURCES, TPU_SPECS
from flexflow_tpu_torch.search.machine_model import MachineModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E_COSTS = os.path.join(ROOT, "artifacts", "tpu_costs_v5e.json")
MESH = {"dp": 2, "tp": 2}


def close(a, b):
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-18)


def meshes(shape):
    n = math.prod(shape.values())
    return (J.make_mesh(shape, jax.devices()[:n]),
            T.make_mesh(shape, ["cpu"] * n))


def machines(spec, jmesh, pmesh):
    pmm = MachineModel.for_mesh(pmesh, spec_name=spec)
    if spec == "h100":   # the reference priced with the port's constants
        return JaxMachine(JaxSpec(**dataclasses.asdict(pmm.spec))), pmm
    return JaxMachine.for_mesh(jmesh, spec_name=spec), pmm


def transformer(shape=MESH, **kw):
    """The classifier on both sides (``kw``: sizes over the TINY ones)."""
    sizes = dict(batch=8, seq=8, num_layers=2, hidden_dim=32, num_heads=4,
                 ff_dim=64, num_classes=8)
    sizes.update(kw)
    jmesh, pmesh = meshes(shape)
    return (jax_transformer(J.FFConfig(batch_size=sizes["batch"]),
                            mesh=jmesh, **sizes),
            port_transformer(T.FFConfig(batch_size=sizes["batch"]),
                             mesh=pmesh, **sizes))


def mlp(shape=MESH, batch=16, width=64, act="relu"):
    """``tests/test_memory_search.py:big_mlp`` (at ``width``)."""
    out = []
    for pkg, mesh in zip((J, T), meshes(shape)):
        m = pkg.FFModel(pkg.FFConfig(batch_size=batch), mesh=mesh)
        x = m.create_tensor((batch, width))
        h = m.dense(x, width, activation=act)
        h = m.dense(h, width, activation=act)
        m.softmax(m.dense(h, 16))
        out.append(m)
    return out


def megatron(graph):
    out = {}
    for node in graph.nodes:
        c = {"sample": ("dp",)}
        if node.name.endswith("_attn"):
            c["head"] = ("tp",)
        elif node.name.endswith("_ff1"):
            c["channel_out"] = ("tp",)
        elif node.name.endswith("_ff2"):
            c["channel_in"] = ("tp",)
        out[node.name] = c
    return out


def strategies(jm, pm):
    g = pm.graph
    dp = data_parallel_strategy(g, pm.mesh)
    assert dp == jax_dp(jm.graph, jm.mesh)
    return {"none": {}, "dp": dp,
            "dp_all": data_parallel_strategy(g, pm.mesh, axes=("dp", "tp")),
            "megatron": megatron(g)}


def assert_prices_equal(jm, pm, jmm, pmm, strategy, measured=None):
    jp = JPCG(jm.graph, jm.mesh, strategy).plan()
    pp = PCG(pm.graph, pm.mesh, strategy).plan()
    for training in (True, False):
        jc = JSIM.simulate(jp, jmm, training=training, measured=measured[0]
                           if measured else None)
        pc = PSIM.simulate(pp, pmm, training=training, measured=measured[1]
                           if measured else None)
        for f in ("total", "compute", "comm", "grad_comm"):
            assert close(getattr(pc, f), getattr(jc, f)), (training, f)
        jparts = JSIM.plan_memory_parts(jp, training=training)
        pparts = PSIM.plan_memory_parts(pp, training=training)
        assert pparts.keys() == jparts.keys()
        for k in jparts:
            assert close(pparts[k], jparts[k]), (training, k)
    assert close(PSIM.simulate(pp, pmm).total,
                 JSIM.simulate(jp, jmm).total)
    assert close(PSIM.plan_memory_bytes(pp), JSIM.plan_memory_bytes(jp))
    return pp


@pytest.mark.parametrize("spec", ["cpu", "v5e", "h100"])
def test_training_prices_and_memory_equal_reference(spec):
    for jm, pm in (transformer(), mlp()):
        jmm, pmm = machines(spec, jm.mesh, pm.mesh)
        for name, strat in strategies(jm, pm).items():
            pp = assert_prices_equal(jm, pm, jmm, pmm, strat)
            cost = PSIM.simulate(pp, pmm)
            # a batch-split op's weights left whole over a batch axis
            # sum their gradients (every dict but {} splits the batch)
            assert (cost.grad_comm > 0) == (name != "none"), name
            assert PSIM.simulate(pp, pmm, training=False).grad_comm == 0
            assert (PSIM.plan_memory_bytes(pp)
                    > PSIM.plan_memory_bytes(pp, training=False))


def test_f5_training_defaults_equal_reference():
    from test_torch_pp import jax_pim, port_pim

    pairs = [(PSIM.simulate, JSIM.simulate),
             (PSIM.plan_memory_bytes, JSIM.plan_memory_bytes),
             (PSIM.plan_memory_parts, JSIM.plan_memory_parts),
             (PSEARCH.graph_optimize, JSEARCH.graph_optimize),
             (PS.PipelinedInferenceManager.stage_memory_bytes,
              JaxPIM.stage_memory_bytes)]
    for port_fn, jax_fn in pairs:
        want = inspect.signature(jax_fn).parameters["training"].default
        got = inspect.signature(port_fn).parameters["training"].default
        assert got is want, port_fn.__qualname__
    jpim = jax_pim(max_seq=64)
    pim = port_pim(jpim)
    assert pim.stage_memory_bytes() == jpim.stage_memory_bytes()
    got, want = (pim.stage_memory_bytes(training=True),
                 jpim.stage_memory_bytes(training=True))
    assert all(close(a, b) for a, b in zip(got, want)) and got > \
        pim.stage_memory_bytes()


def jax_probe_keys():
    """The reference's probe list (its ``calibrate_standard_probes``
    :186-239) as measured-cost keys."""
    import jax.numpy as jnp
    from flexflow_tpu.core.graph import TensorSpec
    from flexflow_tpu.ops.attention import MultiHeadAttention
    from flexflow_tpu.ops.embedding import Embedding
    from flexflow_tpu.ops.linear import Linear
    from flexflow_tpu.ops.norm import LayerNorm, RMSNorm
    from flexflow_tpu.ops.reduction import Softmax

    probes = []
    for b, i, o in [(64, 512, 512), (64, 512, 2048), (256, 1024, 1024),
                    (512, 4096, 4096), (1024, 4096, 11008)]:
        for dt in ("float32", "bfloat16"):
            op = Linear(o, use_bias=True, in_dim=i, dtype=dt)
            probes.append((op, [TensorSpec((b, i), jnp.dtype(dt))]))
    for b, d in [(64, 512), (256, 4096), (1024, 4096)]:
        for op in (LayerNorm(d), RMSNorm(d)):
            probes.append((op, [TensorSpec((b, d))]))
    for b, s, d, h in [(8, 64, 256, 8), (8, 256, 1024, 16),
                       (1, 1024, 4096, 32)]:
        probes.append((MultiHeadAttention(d, h), [TensorSpec((b, s, d))] * 3))
    for b, v in [(64, 512), (256, 16), (64, 32000)]:
        probes.append((Softmax(), [TensorSpec((b, v))]))
    for b, v, d in [(64, 1024, 512), (512, 32000, 4096)]:
        probes.append((Embedding(v, d), [TensorSpec((b,), jnp.int32)]))
    keys = []
    for op, specs in probes:
        op.infer_shapes(specs)
        keys.append(repr((op.attr_signature(),
                          tuple(s.shape for s in specs))))
    return keys


def test_f6_measured_keys_equal_reference():
    port = [repr((op.attr_signature(), tuple(tuple(s.shape) for s in specs)))
            for _, op, specs in PMEASURE.standard_probes()]
    assert port == jax_probe_keys()
    with open(V5E_COSTS) as f:
        assert set(json.load(f)) == set(port)
    jm, pm = transformer()
    for strat in strategies(jm, pm).values():
        jp = JPCG(jm.graph, jm.mesh, strat).plan()
        pp = PCG(pm.graph, pm.mesh, strat).plan()
        jkeys = [repr(JSIM._measure_key(s, jm.mesh)) for s in jp.steps
                 if not s.is_parallel]
        pkeys = [repr(PSIM._measure_key(s, pm.mesh)) for s in pp.steps
                 if not s.is_parallel]
        assert pkeys == jkeys and len(pkeys) == len(pm.graph.nodes)


def test_measured_v5e_prices_and_search_equal_reference_and_beat_dp():
    """``tests/test_search.py:114`` at its sizes (``{"dp": 4, "tp": 2}``),
    and a model whose linears hit the cache: the measured prices are the
    reference's, the hits change the price, and the searched strategy is
    the reference's and beats data parallelism over every axis."""
    jcosts, pcosts = JMEASURE.CostCache(V5E_COSTS), PMEASURE.CostCache(
        V5E_COSTS)
    assert pcosts.data == jcosts.data and pcosts.data
    shape = {"dp": 4, "tp": 2}
    jm, pm = transformer(shape, seq=32, hidden_dim=128, num_heads=8,
                         ff_dim=512, num_classes=16)
    jmm, pmm = machines("v5e", jm.mesh, pm.mesh)
    dp = data_parallel_strategy(pm.graph, pm.mesh, axes=("dp", "tp"))
    best = PSEARCH.graph_optimize(pm.graph, pm.mesh, budget=200,
                                  machine=pmm, measured=pcosts, seed=0,
                                  init=dp)
    assert best == JSEARCH.graph_optimize(
        jm.graph, jm.mesh, budget=200, machine=jmm, measured=jcosts,
        seed=0, init=jax_dp(jm.graph, jm.mesh, axes=("dp", "tp")))
    c_dp = PSIM.simulate(PCG(pm.graph, pm.mesh, dp).plan(), pmm,
                         measured=pcosts).total
    c_best = PSIM.simulate(PCG(pm.graph, pm.mesh, best).plan(), pmm,
                           measured=pcosts).total
    assert c_best < c_dp
    for strat in (dp, best):
        assert_prices_equal(jm, pm, jmm, pmm, strat, (jcosts, pcosts))
    # dense 512 -> 512 at 64 local rows: the cache's first probe
    jm, pm = mlp({"dp": 2}, batch=128, width=512, act=None)
    jmm, pmm = machines("v5e", jm.mesh, pm.mesh)
    dp = data_parallel_strategy(pm.graph, pm.mesh)
    pp = assert_prices_equal(jm, pm, jmm, pmm, dp, (jcosts, pcosts))
    hits = [s.node.name for s in pp.steps if not s.is_parallel
            and PSIM._measure_key(s, pm.mesh) in pcosts]
    assert hits == ["dense", "dense_1"]
    assert PSIM.simulate(pp, pmm, measured=pcosts).total != \
        PSIM.simulate(pp, pmm).total


def test_searched_serve_strategy_takes_a_measured_cache():
    from test_torch_graph_search import both
    from flexflow_tpu.serve import searched_serve_strategy as jax_searched
    from test_serve import TINY

    ff, jm, model, pm = both(dataclasses.asdict(TINY), 2)
    ff.mesh = jm
    got = PS.searched_serve_strategy(
        model, budget=100, seed=0, mesh=pm,
        measured=PMEASURE.CostCache(V5E_COSTS))
    assert got == jax_searched(ff, budget=100, seed=0,
                               measured=JMEASURE.CostCache(V5E_COSTS))


def test_memory_aware_search_equals_reference():
    """``tests/test_memory_search.py``: under a limit just below the free
    walk's winner the searched dict fits and is the reference's; with
    nothing fitting it warns and returns the reference's fallback."""
    jm, pm = mlp(batch=64, width=2048)
    jmm, pmm = machines("v5e", jm.mesh, pm.mesh)
    dp = data_parallel_strategy(pm.graph, pm.mesh)
    kw = dict(seed=0, init=dp)
    free = PSEARCH.graph_optimize(pm.graph, pm.mesh, budget=150,
                                  machine=pmm, memory_limit=0, **kw)
    assert free == JSEARCH.graph_optimize(jm.graph, jm.mesh, budget=150,
                                          machine=jmm, memory_limit=0, **kw)
    limit = PSIM.plan_memory_bytes(PCG(pm.graph, pm.mesh, free).plan()) * 0.95
    capped = PSEARCH.graph_optimize(pm.graph, pm.mesh, budget=300,
                                    machine=pmm, memory_limit=limit, **kw)
    assert capped == JSEARCH.graph_optimize(
        jm.graph, jm.mesh, budget=300, machine=jmm, memory_limit=limit, **kw)
    assert PSIM.plan_memory_bytes(PCG(pm.graph, pm.mesh,
                                      capped).plan()) <= limit
    assert capped != free
    with pytest.warns(UserWarning, match="least-infeasible"):
        low = PSEARCH.graph_optimize(pm.graph, pm.mesh, budget=30,
                                     machine=pmm, seed=0, memory_limit=1024)
    with pytest.warns(UserWarning, match="least-infeasible"):
        assert low == JSEARCH.graph_optimize(jm.graph, jm.mesh, budget=30,
                                             machine=jmm, seed=0,
                                             memory_limit=1024)


def test_cost_cache_file_and_card_only_measurement(tmp_path):
    """The cache round-trips through its JSON (a file either package
    reads), defaults to the port's own file (never the reference's
    ``~/.flexflow_tpu_costs.json``), and measuring needs a CUDA device."""
    path = str(tmp_path / "costs.json")
    cache = PMEASURE.CostCache(path)
    key = (("linear", (("in_dim", 8),)), ((4, 8),))
    cache.put(key, 1.5e-6)
    cache.save()
    again = PMEASURE.CostCache(path)
    assert key in again and again[key] == 1.5e-6 and again.get("x") is None
    assert JMEASURE.CostCache(path)[key] == 1.5e-6
    default = PMEASURE.CostCache().path
    assert default == os.path.join(ROOT, "artifacts", "h100_costs.json")
    assert default != JMEASURE.DEFAULT_CACHE
    _, op, specs = PMEASURE.standard_probes()[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        PMEASURE.measure_operator_cost(op, specs, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PMEASURE.probe_train_step_factor("cpu")


def test_operator_probe_leaves_the_models_weights_alone():
    """Pricing a node of a compiled model (the call
    ``measure_operator_cost`` times) runs its op on seeded weights of
    its own: the op keeps its parameters, the model its trained ones,
    and the model still trains."""
    _, pm = mlp(shape={"dp": 1}, batch=8, width=16)
    pm.compile(optimizer=T.AdamOptimizer(alpha=1e-2))
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    y = np.arange(8, dtype=np.int32)
    pm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    node = pm.graph.nodes[0]
    own = dict(node.op.named_parameters())
    before = {n: {k: v.detach().clone() for k, v in g.items()}
              for n, g in pm.params.items()}
    out_before = pm.forward(x)
    fn, args = PMEASURE._probe(node.op, [pm.graph.spec(node.inputs[0])],
                               "cpu")
    rng = np.random.RandomState(0)
    xs = rng.randn(8, 16).astype(np.float32)
    w = rng.randn(16, 16).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    np.testing.assert_allclose(fn(*args).detach().numpy(),
                               np.maximum(xs @ w + b, 0), rtol=1e-5,
                               atol=1e-5)
    assert all(p is own[k] for k, p in node.op.named_parameters())
    for n, g in pm.params.items():
        for k, v in g.items():
            assert np.array_equal(v.detach().numpy(), before[n][k].numpy())
    np.testing.assert_array_equal(pm.forward(x).numpy(),
                                  out_before.numpy())
    pm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    assert any(not np.array_equal(v.detach().numpy(), before[n][k].numpy())
               for n, g in pm.params.items() for k, v in g.items())


def test_h100_calibration_carries_a_measured_train_step_factor():
    """``artifacts/h100_calib.json`` (``scripts/calibrate_h100.py`` on
    the card) holds ``train_step_factor`` with its probe's times, and
    ``with_calibration`` replaces the spec's placeholder with it."""
    path = os.path.join(ROOT, "artifacts", "h100_calib.json")
    with open(path) as f:
        doc = json.load(f)
    factor = doc["train_step_factor"]
    probe = doc["probes"]["train_step"]
    assert factor == pytest.approx(probe["train_step_s"] / probe["forward_s"])
    assert "train_step_factor" not in doc.get("not_measured", {})
    assert H100_SOURCES["train_step_factor"].startswith("measured")
    spec = MachineModel(TPU_SPECS["h100"]).with_calibration(path).spec
    assert spec.train_step_factor == factor
    assert JAX_SPECS["v5e"].train_step_factor == TPU_SPECS["v5e"]\
        .train_step_factor


def test_sequence_split_attention_trains_as_reference():
    """A ``sequence`` config (which the search may choose) runs: each
    shard attends its block of queries over keys and values gathered
    whole, so the classifier under ``{"sample": dp, "sequence": tp}``
    attention trains to the reference's history, and a causal attention
    split over 4 shards gives the reference's forward."""
    from test_torch_train import _jax_params, _same_history

    jm, pm = transformer()
    strat = {n.name: ({"sample": ("dp",), "sequence": ("tp",)}
                      if n.name.endswith("_attn") else {"sample": ("dp",)})
             for n in pm.graph.nodes}
    jm.compile(optimizer=J.AdamOptimizer(alpha=1e-3), strategy=strat)
    pm.compile(optimizer=T.AdamOptimizer(alpha=1e-3), strategy=strat)
    pm.load_params(_jax_params(jm))
    rng = np.random.RandomState(4)
    x = rng.randn(16, 8, 32).astype(np.float32)
    y = rng.randint(0, 8, 16).astype(np.int32)
    _same_history(pm.fit(x, y, epochs=2, shuffle=False, verbose=False),
                  jm.fit(x, y, epochs=2, shuffle=False, verbose=False))
    outs = []
    for pkg, mesh in zip((J, T), meshes({"dp": 4})):
        m = pkg.FFModel(pkg.FFConfig(batch_size=2), mesh=mesh)
        t = m.create_tensor((2, 8, 16))
        m.multihead_attention(t, t, t, 16, 2, causal=True, name="att")
        m.compile(strategy={"att": {"sequence": ("dp",)}})
        outs.append(m)
    outs[1].load_params(_jax_params(outs[0]))
    x = rng.randn(2, 8, 16).astype(np.float32)
    np.testing.assert_allclose(outs[1].forward(x).numpy(),
                               np.asarray(outs[0].forward(x)),
                               rtol=2e-5, atol=1e-6)
