"""The port's substitution rules, fused ops and joint search against the
JAX package's, on the CPU (modelled on ``tests/test_substitution.py``).

* each rule's matches and rewrites (node names and types, tensor ids,
  ``tid_map``, ``name_map``, ``param_map``) equal the reference's on its
  target graph, and ``check_equivalence`` holds every rewrite;
* chained rewrites stay equal and equivalent; weights trained before a
  rewrite carry across it (``remap_params``);
* ``ResidualLayerNorm``, ``ResidualRMSNorm`` and ``SigmoidSiluMulti``:
  both outputs and the gradients of every input and weight against
  ``jax.grad`` of the reference op (``rtol 1e-5``); the builder methods
  make the reference's nodes and train to its history;
* ``graph_optimize(substitution=True)`` on a ``{"dp": 2, "tp": 2}`` mesh
  (the reference on 4 of its virtual CPU devices, the port on
  ``["cpu"] * 4``) returns the reference's graph, dict and ``tid_map``
  for the same seed and budget, priced no worse than the walk without
  rewrites;
* ``FFModel.compile`` with ``search_budget`` adopts the reference's
  graph and dict, holds exactly that graph's modules in ``layers``,
  trains 2 epochs to the reference's history (``tests/
  test_torch_train.py``'s tolerances) and ``recompile`` re-plans it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.graph import Tensor as JTensor
from flexflow_tpu.core.graph import TensorSpec as JSpec
from flexflow_tpu.models.transformer import \
    build_transformer_classifier as jax_transformer
from flexflow_tpu.ops import norm as JN
from flexflow_tpu.parallel.mesh import data_parallel_strategy as jax_dp
from flexflow_tpu.search import search as JSEARCH
from flexflow_tpu.search import substitution as JSUB
from flexflow_tpu.search.machine_model import MachineModel as JaxMachine
from flexflow_tpu_torch.core.graph import Tensor as PTensor
from flexflow_tpu_torch.core.pcg import PCG
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as port_transformer
from flexflow_tpu_torch.ops import norm as PN
from flexflow_tpu_torch.parallel.mesh import data_parallel_strategy
from flexflow_tpu_torch.search import search as PSEARCH
from flexflow_tpu_torch.search import substitution as PSUB
from flexflow_tpu_torch.search.machine_model import MachineModel
from flexflow_tpu_torch.search.simulator import simulate

from test_torch_train import _jax_params, _port_params, _same_history


def _jax_mesh(shape=None):
    shape = shape or {"dp": 1}
    n = int(np.prod(list(shape.values())))
    return J.make_mesh(shape, jax.devices()[:n])


def _port_mesh(shape=None):
    shape = shape or {"dp": 1}
    n = int(np.prod(list(shape.values())))
    return T.make_mesh(shape, ["cpu"] * n)


def _model(pkg, shape=None, **cfg):
    mesh = _jax_mesh(shape) if pkg is J else _port_mesh(shape)
    return pkg.FFModel(pkg.FFConfig(**cfg), mesh=mesh)


def mlp(pkg, shape=None, **cfg):
    """dense -> relu -> identity -> scalar_multiply(1.0) -> dense ->
    softmax: the linear fusion and both identity forms."""
    m = _model(pkg, shape, **cfg)
    x = m.create_tensor((4, 16))
    h = m.dense(x, 32)
    h = m.relu(h)
    h = m.identity(h)
    h = m.scalar_multiply(h, 1.0)
    h = m.dense(h, 8)
    m.softmax(h)
    return m


def swiglu(pkg, shape=None, **cfg):
    """silu(gate) * up, and an add into an RMSNorm."""
    m = _model(pkg, shape, **cfg)
    x = m.create_tensor((4, 16))
    gate = m.dense(x, 32, name="gate_proj")
    up = m.dense(x, 32, name="up_proj")
    h = m.multiply(up, m.silu(gate))
    h = m.dense(h, 16, name="down_proj")
    h = m.rms_norm(m.add(h, x), name="post_norm")
    m.softmax(m.dense(h, 8, name="head"))
    return m


def transformer(pkg, shape=None, layers=1, wide=False, **cfg):
    """The classifier at the TINY width, or ``wide``: the one of
    ``tests/test_substitution.py:144``."""
    kw = dict(batch=4, seq=8, num_layers=layers, hidden_dim=32,
              num_heads=4, ff_dim=64, num_classes=8)
    if wide:
        kw.update(batch=8, seq=16, hidden_dim=64, ff_dim=128)
    mesh = _jax_mesh(shape) if pkg is J else _port_mesh(shape)
    if pkg is J:
        return jax_transformer(J.FFConfig(batch_size=kw["batch"], **cfg),
                               mesh=mesh, **kw)
    return port_transformer(T.FFConfig(batch_size=kw["batch"], **cfg),
                            mesh=mesh, **kw)


def out_tids(graph):
    return [graph.nodes[-1].outputs[-1]]


def same_graph(pg, jg):
    assert [n.name for n in pg.nodes] == [n.name for n in jg.nodes]
    assert [n.op.type_name for n in pg.nodes] == \
        [n.op.type_name for n in jg.nodes]
    assert [(n.inputs, n.outputs) for n in pg.nodes] == \
        [(n.inputs, n.outputs) for n in jg.nodes]
    assert [n.op.attr_signature() for n in pg.nodes] == \
        [n.op.attr_signature() for n in jg.nodes]
    assert [tuple(s.shape) for s in pg.tensor_specs] == \
        [tuple(s.shape) for s in jg.tensor_specs]
    assert pg.input_tids == jg.input_tids


def same_result(pres, jres):
    same_graph(pres.graph, jres.graph)
    assert pres.tid_map == jres.tid_map
    assert pres.name_map == jres.name_map
    assert pres.param_map == jres.param_map


def rule(pkg, name):
    mod = JSUB if pkg is J else PSUB
    return [r for r in mod.standard_rules() if r.name == name]


@pytest.mark.parametrize("rule_name,builder", [
    ("fuse_linear_activation", mlp), ("eliminate_identity", mlp),
    ("fuse_add_norm", transformer), ("fuse_silu_mul", swiglu)])
def test_rule_matches_and_rewrites_equal_reference(rule_name, builder):
    jm, pm = builder(J), builder(T)
    jmatches = JSUB.find_all_matches(jm.graph, rule(J, rule_name))
    pmatches = PSUB.find_all_matches(pm.graph, rule(T, rule_name))
    assert pmatches and [m.nids for m in pmatches] == \
        [m.nids for m in jmatches]
    for jmatch, pmatch in zip(jmatches, pmatches):
        pres = PSUB.apply_match(pm.graph, pmatch)
        same_result(pres, JSUB.apply_match(jm.graph, jmatch))
        assert len(pres.graph.nodes) < len(pm.graph.nodes)
        PSUB.check_equivalence(pm.graph, pres, out_tids(pm.graph),
                               _port_mesh())


def test_chained_rewrites_equal_reference_and_stay_equivalent():
    jg, pg = transformer(J, layers=2).graph, transformer(T, layers=2).graph
    ptids, jtids = out_tids(pg), out_tids(jg)
    n0, applied = len(pg.nodes), 0
    while True:
        jm = JSUB.find_all_matches(jg, JSUB.standard_rules())
        pm = PSUB.find_all_matches(pg, PSUB.standard_rules())
        assert [(m.rule.name, m.nids) for m in pm] == \
            [(m.rule.name, m.nids) for m in jm]
        if not pm:
            break
        jres, pres = JSUB.apply_match(jg, jm[0]), PSUB.apply_match(pg, pm[0])
        same_result(pres, jres)
        PSUB.check_equivalence(pg, pres, ptids, _port_mesh())
        ptids = [pres.tid_map[t] for t in ptids]
        jtids = [jres.tid_map[t] for t in jtids]
        assert ptids == jtids
        pg, jg = pres.graph, jres.graph
        applied += 1
    assert applied == 4          # two add+norm pairs a layer
    assert len(pg.nodes) == n0 - applied


def test_params_survive_rewrite_in_training():
    """Train a step, rewrite, carry the weights: the forward is the same,
    and ``remap_params`` maps the reference's names."""
    m = mlp(T, batch_size=4)
    m.compile(optimizer=T.SGDOptimizer(lr=0.05))
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16).astype(np.float32)
    y = rng.randint(0, 8, size=4).astype(np.int32)
    m.fit(x, y, epochs=1, shuffle=False, verbose=False)
    before = m.forward(x)
    g = m.graph
    (match,) = PSUB.find_all_matches(g, rule(T, "fuse_linear_activation"))
    res = PSUB.apply_match(g, match)
    params = PSUB.remap_params(_port_params(m), res, res.graph)
    jm = mlp(J)
    jres = JSUB.apply_match(jm.graph, JSUB.find_all_matches(
        jm.graph, rule(J, "fuse_linear_activation"))[0])
    assert {n: sorted(g) for n, g in params.items()} == \
        {n: sorted(g) for n, g in JSUB.remap_params(
            _jax_params(jm.compile()), jres, jres.graph).items()}
    m2 = T.FFModel(T.FFConfig(batch_size=4), device="cpu")
    m2.graph = res.graph
    m2.compile(outputs=[PTensor(res.graph, res.tid_map[t])
                        for t in out_tids(g)])
    m2.load_params(params)
    torch.testing.assert_close(m2.forward(x), before, rtol=1e-5, atol=1e-5)


FUSED = {
    "residual_layer_norm": (lambda pkg, dt: (JN if pkg is J else PN)
                            .ResidualLayerNorm(8, dtype=dt), 2),
    "residual_layer_norm_two": (lambda pkg, dt: (JN if pkg is J else PN)
                                .ResidualLayerNorm(8, True, dtype=dt), 3),
    "residual_layer_norm_no_bias": (
        lambda pkg, dt: (JN if pkg is J else PN).ResidualLayerNorm(
            8, use_bias=False, eps=1e-3, dtype=dt), 2),
    "residual_rms_norm": (lambda pkg, dt: (JN if pkg is J else PN)
                          .ResidualRMSNorm(8, dtype=dt), 2),
    "sigmoid_silu_multi": (lambda pkg, dt: (JN if pkg is J else PN)
                           .SigmoidSiluMulti(), 2),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_op_forward_and_gradients_equal_jax(case):
    """Both outputs and, through a seeded weighting of both, every input's
    and weight's gradient against ``jax.grad`` of the reference op."""
    make, n_in = FUSED[case]
    jop, pop = make(J, jnp.float32), make(T, torch.float32)
    assert pop.attr_signature() == jop.attr_signature()
    rng = np.random.RandomState(3)
    xs = [rng.randn(3, 5, 8).astype(np.float32) for _ in range(n_in)]
    params = {p.name: rng.randn(*p.spec.shape).astype(np.float32)
              for p in jop.params()}
    assert [p.name for p in pop.params()] == list(params)
    n_out = len(jop.infer_shapes([JSpec((3, 5, 8))] * n_in))
    weights = [rng.randn(3, 5, 8).astype(np.float32) for _ in range(n_out)]

    def jax_loss(xs, params):
        outs = jop.lower(None, list(xs), params)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights)), outs

    (jl, jouts), (jgx, jgp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(x) for x in xs],
        {k: jnp.asarray(v) for k, v in params.items()})
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    for k, v in params.items():
        setattr(pop, k, torch.nn.Parameter(torch.tensor(v)))
    outs = pop(*txs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.tensor(w)).sum() for o, w in zip(outs, weights))
    loss.backward()
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                   rtol=1e-5, atol=1e-6)
    for t, g in zip(txs, jgx):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)
    for k in params:
        np.testing.assert_allclose(getattr(pop, k).grad.numpy(),
                                   np.asarray(jgp[k]), rtol=1e-5, atol=1e-5)


def fused_builder(pkg):
    """The builder methods of the fused ops in one trainable graph."""
    m = _model(pkg, batch_size=4)
    x = m.create_tensor((4, 16))
    a = m.dense(x, 16, name="a")
    b = m.dense(x, 16, name="b")
    s, h = m.residual_layer_norm(a, b, x)
    s2, h = m.residual_rms_norm(h, s)
    h = m.sigmoid_silu_multi(h, s2)
    m.softmax(m.dense(h, 8, name="head"))
    return m


def test_builder_methods_make_reference_nodes_and_train_to_its_history():
    jm, pm = fused_builder(J), fused_builder(T)
    same_graph(pm.graph, jm.graph)
    assert sorted(pm.layers) == sorted(n.name for n in pm.graph.nodes)
    opt = dict(alpha=1e-3)
    jm.compile(optimizer=J.AdamOptimizer(**opt))
    pm.compile(optimizer=T.AdamOptimizer(**opt))
    pm.load_params(_jax_params(jm))
    rng = np.random.RandomState(1)
    x = rng.randn(16, 16).astype(np.float32)
    y = rng.randint(0, 8, 16).astype(np.int32)
    _same_history(pm.fit(x, y, epochs=2, shuffle=False, verbose=False),
                  jm.fit(x, y, epochs=2, shuffle=False, verbose=False))


MESH = {"dp": 2, "tp": 2}


@pytest.mark.parametrize("spec", ["v5e", "cpu"])
def test_joint_search_equals_reference(spec):
    """``tests/test_substitution.py:142``: the same graph, dict and
    ``tid_map`` for the same seed and budget, priced no worse than the
    walk over parallel configs alone."""
    jm = transformer(J, MESH, wide=True)
    pm = transformer(T, MESH, wide=True)
    jmesh, pmesh = jm.mesh, pm.mesh
    jmm = JaxMachine.for_mesh(jmesh, spec_name=spec)
    pmm = MachineModel.for_mesh(pmesh, spec_name=spec)
    jdp, pdp = jax_dp(jm.graph, jmesh), data_parallel_strategy(pm.graph,
                                                              pmesh)
    assert pdp == jdp
    kw = dict(budget=120, seed=0, substitution=True)
    jg, js, jmap = JSEARCH.graph_optimize(
        jm.graph, jmesh, machine=jmm, init=jdp,
        output_tids=out_tids(jm.graph), **kw)
    pg, ps, pmap = PSEARCH.graph_optimize(
        pm.graph, pmesh, machine=pmm, init=pdp,
        output_tids=out_tids(pm.graph), **kw)
    same_graph(pg, jg)
    assert ps == js and pmap == jmap
    assert len(pg.nodes) < len(pm.graph.nodes)
    for t in out_tids(pm.graph):
        assert t in pmap
    par = PSEARCH.graph_optimize(pm.graph, pmesh, budget=120, seed=0,
                                 machine=pmm, init=pdp)
    assert par == JSEARCH.graph_optimize(jm.graph, jmesh, budget=120,
                                         seed=0, machine=jmm, init=jdp)
    joint = simulate(PCG(pg, pmesh, ps).plan(), pmm).total
    assert joint <= simulate(PCG(pm.graph, pmesh, par).plan(),
                             pmm).total * 1.0001


def test_compile_with_search_budget_adopts_reference_graph_and_trains():
    """The model adopts the searched graph and dict (outputs given, as
    the reference needs them once its last norm fuses), its ``layers``
    are that graph's modules, 2 epochs of Adam give the reference's
    history, ``recompile`` re-plans the adopted graph under a new dict
    keeping the weights, and without ``outputs`` the port keeps the
    softmax as its output."""
    jm = transformer(J, MESH, layers=2, search_budget=120)
    pm = transformer(T, MESH, layers=2, search_budget=120)
    n0 = len(pm.graph.nodes)
    opt = dict(alpha=1e-3)
    jm.compile(optimizer=J.AdamOptimizer(**opt), metrics=["accuracy"],
               outputs=[JTensor(jm.graph, t) for t in out_tids(jm.graph)])
    pm.compile(optimizer=T.AdamOptimizer(**opt), metrics=["accuracy"],
               outputs=[PTensor(pm.graph, t) for t in out_tids(pm.graph)])
    same_graph(pm.graph, jm.graph)
    assert pm.strategy == jm.strategy and len(pm.graph.nodes) < n0
    assert sorted(pm.layers) == sorted(n.name for n in pm.graph.nodes)
    assert all(pm.layers[n.name] is n.op for n in pm.graph.nodes)
    pm.load_params(_jax_params(jm))
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8, 32).astype(np.float32)
    y = rng.randint(0, 8, 16).astype(np.int32)
    _same_history(pm.fit(x, y, epochs=2, shuffle=False, verbose=False),
                  jm.fit(x, y, epochs=2, shuffle=False, verbose=False))
    before = pm.forward(x[:4])
    graph = pm.graph
    pm.recompile(strategy=data_parallel_strategy(pm.graph, pm.mesh))
    assert pm.graph is graph
    torch.testing.assert_close(pm.forward(x[:4]), before, rtol=1e-5,
                               atol=1e-6)
    default = transformer(T, MESH, layers=2, search_budget=120)
    default.compile()
    assert tuple(default.forward(x[:4]).shape) == (4, 8)
