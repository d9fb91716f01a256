"""The port's Mixture-of-Experts ops, builder and expert parallelism
against the JAX package's, on the CPU.

At the TINY size of the reference's own tests (``tests/test_models.py``:
``in_dim`` 8, 4 experts, hidden 16, batch 16), every input from a numpy
seed:

* each op (``GroupBy`` with random and with planted equal gates,
  ``Experts`` with and without a hidden layer, ``Aggregate``,
  ``AggregateSpec``): the port's forward equals the reference's
  ``lower``, and autograd's gradients ``jax.vjp``'s, at ``rtol 1e-5``
  (``atol 1e-6``), its ``attr_signature()`` the reference's; equal gates
  pick the lower expert first, as ``jax.lax.top_k`` does;
* a choice past its expert's capacity is dropped; one expert with room
  for every token is the dense MLP; the ``[E, out]`` biases broadcast
  over the capacity dim with E > 1; ``AggregateSpec`` gives each choice's
  row unweighted, ``Aggregate``'s output is those rows weighted;
* ``build_moe_classifier``: the reference's nodes, parameters and
  strategy, and from the reference's weights its forward and ``fit``
  history;
* ``{"ep": 4}`` and ``{"dp": 2, "ep": 2}`` over ``["cpu"] * 4``: the
  classifier and a graph that ends in ``AggregateSpec`` equal one device
  and the reference on its 4-device CPU mesh (forward, two SGD epochs,
  the parameters after);
* ``simulate``, ``plan_memory_parts`` and ``plan_memory_bytes``, the
  joint search (graph, dict and ``tid_map``) and the measured-cost keys
  of the MoE plans equal the reference's;
* ``mode="local"`` equals ``"spmd"`` on ``{"ep": 4}`` (the reference's
  does not: a reference fault, not copied).
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.op import OpContext as JCtx
from flexflow_tpu.core.pcg import PCG as JPCG
from flexflow_tpu.models import moe as jmoe
from flexflow_tpu.search import search as JSEARCH
from flexflow_tpu.search import simulator as JSIM
from flexflow_tpu_torch.core.op import OpContext
from flexflow_tpu_torch.core.pcg import PCG
from flexflow_tpu_torch.models import moe as tmoe
from flexflow_tpu_torch.search import search as PSEARCH
from flexflow_tpu_torch.search import simulator as PSIM

from test_torch_train_search import close, machines

TOL = dict(rtol=1e-5, atol=1e-6)
TINY = dict(batch=16, in_dim=8, num_experts=4, expert_hidden=16,
            num_classes=6, k=2, capacity_factor=2.0)


def _weights(m):
    return {n: {p: np.asarray(v) for p, v in g.items()}
            for n, g in m.params.items()}


def _gates(rng, n, e, ties=False):
    g = rng.rand(n, e).astype(np.float32)
    if ties:   # equal gates on every row: the lower experts win
        g[:, :] = 0.25
        g[::3, 2:] = 0.5
    return g / g.sum(-1, keepdims=True)


def _parity(xs, build, seed, grads=True):
    """Build one op on both sides over inputs ``xs`` (numpy), run the
    reference's ``lower`` under ``jax.vjp`` and the port's forward under
    autograd with the same parameters and cotangents; returns the two
    ops and the port's outputs."""
    rng = np.random.RandomState(seed)
    ops = []
    for pkg in (J, T):
        m = (J.FFModel(J.FFConfig(num_devices=1)) if pkg is J
             else T.FFModel(T.FFConfig(), device="cpu"))
        build(m, [m.create_tensor(x.shape) for x in xs])
        ops.append(m.graph.nodes[-1].op)
    jop, top = ops
    params = {p.name: (rng.randn(*p.spec.shape) * 0.5).astype(np.float32)
              for p in jop.params()}
    assert [(p.name, tuple(p.spec.shape)) for p in top.params()] == \
        [(p.name, tuple(p.spec.shape)) for p in jop.params()]
    assert top.attr_signature() == jop.attr_signature()

    def f(ins, ps):
        return jop.lower(JCtx(), list(ins), ps)

    cts = [rng.randn(*o.shape).astype(np.float32)
           for o in jax.eval_shape(f, tuple(xs), params)]
    jout, vjp = jax.vjp(f, tuple(xs), params)
    jg_in, jg_p = vjp(cts)
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    for k, v in params.items():
        setattr(top, k, nn.Parameter(torch.tensor(v)))
    out = top(*txs, ctx=OpContext()) if top.uses_context else top(*txs)
    outs = list(out) if isinstance(out, tuple) else [out]
    for o, j in zip(outs, jout):
        assert o.dtype == torch.float32 and tuple(o.shape) == j.shape
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j), **TOL)
    if grads:
        torch.autograd.backward(outs, [torch.tensor(c) for c in cts])
        for x, g in zip(txs, jg_in):
            got = np.zeros(x.shape) if x.grad is None else x.grad.numpy()
            np.testing.assert_allclose(got, np.asarray(g), **TOL)
        for k in params:
            np.testing.assert_allclose(getattr(top, k).grad.numpy(),
                                       np.asarray(jg_p[k]), **TOL,
                                       err_msg=k)
    return jop, top, outs


def _group_by_inputs(rng, ties=False, n=16, d=8, e=4):
    return [rng.randn(n, d).astype(np.float32), _gates(rng, n, e, ties)]


# id -> (inputs(rng), build(model, tensors))
CASES = {
    "group_by": (lambda r: _group_by_inputs(r), lambda m, t:
                 m.group_by(t[0], t[1], 4, k=2, capacity_factor=1.0)),
    "group_by_ties": (lambda r: _group_by_inputs(r, ties=True), lambda m, t:
                      m.group_by(t[0], t[1], 4, k=2, capacity_factor=1.0)),
    "experts_hidden": (lambda r: [r.randn(3, 5, 8).astype(np.float32)],
                       lambda m, t: m.experts(t[0], 6, hidden_dim=16)),
    "experts_single": (lambda r: [r.randn(4, 6, 8).astype(np.float32)],
                       lambda m, t: m.experts(t[0], 8, activation="gelu")),
    "aggregate": (lambda r: [r.randn(4, 8, 8).astype(np.float32),
                             r.rand(16, 4, 8).astype(np.float32)],
                  lambda m, t: m.aggregate(t[0], t[1])),
    "aggregate_spec": (lambda r: [r.randn(4, 8, 8).astype(np.float32),
                                  r.rand(16, 4, 8).astype(np.float32)
                                  * (r.rand(16, 4, 8) > 0.6),
                                  _gates(r, 16, 4, ties=True)],
                       lambda m, t: m.aggregate_spec(t[0], t[1], t[2],
                                                     k=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_gradient_equal_reference(case):
    inputs, build = CASES[case]
    seed = sum(map(ord, case))
    _, _, outs = _parity(inputs(np.random.RandomState(seed)), build, seed)
    if case == "group_by_ties":
        # a row of equal gates sends its tokens to experts 0 and 1
        comb = outs[1].detach().numpy()
        routed = comb.sum(-1) > 0
        assert routed[1, :2].all() and not routed[1, 2:].any()


def test_capacity_overflow_is_dropped():
    """Every token to expert 0 with room for one: only token 0 lands,
    the others' combine rows are zero (``tests/test_models.py:84``)."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    gates = np.tile(np.asarray([[0.9, 0.1]], np.float32), (8, 1))
    _, top, (disp, comb) = _parity(
        [x, gates], lambda m, t: m.group_by(t[0], t[1], 2, k=1,
                                            capacity_factor=0.25), 0)
    assert tuple(disp.shape) == (2, 1, 4)
    np.testing.assert_array_equal(disp[0, 0].detach().numpy(), x[0])
    assert float(comb[1:].detach().sum()) == 0.0


def test_single_expert_is_the_dense_mlp_and_biases_broadcast():
    """One expert with room for every token is its MLP; with E > 1 and C
    != E the ``[E, out]`` biases add expert e's bias to every row of its
    slot (``tests/test_models.py:27-81``)."""
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    m = T.FFModel(T.FFConfig(batch_size=8), device="cpu")
    out = m.moe_layer(m.create_tensor((8, 16)), num_experts=1, out_dim=16,
                      hidden_dim=32, capacity_factor=8.0, name="moe")
    m.compile(outputs=[out], loss_type="identity")
    p = {k: v.detach().numpy() for k, v in m.params["moe.experts"].items()}
    h = np.maximum(x @ p["w1"][0] + p["b1"][0], 0)
    np.testing.assert_allclose(m.forward(x).numpy(),
                               h @ p["w2"][0] + p["b2"][0],
                               atol=1e-5, rtol=1e-4)
    e, c, d, hd, o = 3, 5, 4, 8, 6
    rng = np.random.RandomState(0)
    xs = rng.randn(e, c, d).astype(np.float32)
    ex = T.FFModel(T.FFConfig(), device="cpu")
    ex.experts(ex.create_tensor((e, c, d)), o, hidden_dim=hd)
    op = ex.graph.nodes[-1].op
    ws = {"w1": rng.randn(e, d, hd), "b1": rng.randn(e, hd),
          "w2": rng.randn(e, hd, o), "b2": rng.randn(e, o)}
    for k, v in ws.items():
        setattr(op, k, nn.Parameter(torch.tensor(v, dtype=torch.float32)))
    got = op(torch.tensor(xs)).detach().numpy()
    for i in range(e):
        hh = np.maximum(xs[i] @ ws["w1"][i] + ws["b1"][i], 0)
        np.testing.assert_allclose(got[i], hh @ ws["w2"][i] + ws["b2"][i],
                                   atol=1e-4, rtol=1e-4)


def test_aggregate_spec_rows_are_unweighted_and_consistent():
    """The expert doubling its input gives each token's chosen rows as
    ``2 x`` (``tests/test_models.py:236-250``); Aggregate's output is
    those rows weighted by the token's gates, and a dropped choice's row
    is zero."""
    from flexflow_tpu_torch.ops.moe import Aggregate, AggregateSpec, GroupBy

    rng = np.random.RandomState(1)
    n, d, e = 6, 3, 3
    x = torch.tensor(rng.randn(n, d), dtype=torch.float32)
    gates = torch.softmax(torch.tensor(rng.randn(n, e),
                                       dtype=torch.float32), -1)
    for cap, k in ((float(n), 1), (float(n), 2), (0.5, 2)):
        disp, comb = GroupBy(e, k=k, capacity_factor=cap)(x, gates)
        eo = disp * 2.0
        rows = AggregateSpec(k)(eo, comb, gates)
        agg = Aggregate()(eo, comb)
        top = torch.sort(gates, dim=-1, descending=True, stable=True)
        kept = (comb.sum(-1) > 0).gather(1, top.indices[:, :k])
        want = 2.0 * x[:, None, :] * kept[..., None]
        torch.testing.assert_close(rows, want, rtol=1e-6, atol=1e-6)
        weighted = (rows * top.values[:, :k, None]).sum(1)
        torch.testing.assert_close(agg, weighted, rtol=1e-6, atol=1e-6)
        if cap < 1:
            assert not kept.all()


def _classifier(pkg, shape, **kw):
    n = int(np.prod(list(shape.values())))
    mesh = (J.make_mesh(shape, jax.devices()[:n]) if pkg is J
            else T.make_mesh(shape, ["cpu"] * n))
    axes = dict(ep_axes=("ep",) if shape.get("ep", 1) > 1 else (),
                dp_axes=("dp",) if shape.get("dp", 1) > 1 else ())
    mod = jmoe if pkg is J else tmoe
    return mod.build_moe_classifier(mesh=mesh, **axes, **{**TINY, **kw})


def _spec_net(pkg, shape):
    """A graph that ends in AggregateSpec: the classifier's layers, the
    per-choice rows flattened into the head."""
    n = int(np.prod(list(shape.values())))
    mesh = (J.make_mesh(shape, jax.devices()[:n]) if pkg is J
            else T.make_mesh(shape, ["cpu"] * n))
    b, d, e = TINY["batch"], TINY["in_dim"], TINY["num_experts"]
    m = pkg.FFModel(pkg.FFConfig(batch_size=b), mesh=mesh)
    x = m.create_tensor((b, d))
    h = m.dense(x, d, activation="relu", name="pre")
    gates = m.softmax(m.dense(h, e, use_bias=False, name="router"))
    disp, comb = m.group_by(h, gates, e, k=2, capacity_factor=1.0,
                            name="gb")
    eo = m.experts(disp, d, hidden_dim=16, name="ex")
    rows = m.aggregate_spec(eo, comb, gates, k=2, name="spec")
    out = m.softmax(m.dense(m.flat(rows), TINY["num_classes"], name="head"))
    strategy = ({k: {"expert": ("ep",)} for k in ("gb", "ex", "spec")}
                if shape.get("ep", 1) > 1 else {})
    if shape.get("dp", 1) > 1:
        strategy.update({k: {"sample": ("dp",)} for k in ("pre", "head")})
    return m, x, out, strategy


def _train(m, out, strategy, x, y, init=None):
    """Compile (SGD), load ``init`` (None: keep the drawn weights),
    forward and two epochs; returns the weights it started from, the
    forward and the epochs' losses."""
    m.compile(optimizer=(J if isinstance(m, J.FFModel) else T)
              .SGDOptimizer(lr=0.1), outputs=[out], strategy=strategy)
    if init is None:
        init = _weights(m)
    else:
        m.load_params(init)
    fwd = np.asarray(m.forward(x))
    hist = m.fit(x, y, epochs=2, batch_size=TINY["batch"], shuffle=False,
                 verbose=False)
    return init, fwd, [h["loss"] for h in hist]


def _same_params(tm, jm):
    jp = _weights(jm)
    assert sorted(tm.params) == sorted(jp)
    for n, g in jp.items():
        for p, v in g.items():
            np.testing.assert_allclose(tm.params[n][p].detach().numpy(), v,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{n}.{p}")


def _data():
    rng = np.random.RandomState(2)
    x = rng.randn(48, TINY["in_dim"]).astype(np.float32)
    y = rng.randint(0, TINY["num_classes"], 48).astype(np.int32)
    return x, y


def test_classifier_is_the_reference_graph_and_trains_as_it():
    jm, _, jout, jstrat = _classifier(J, {"dp": 2, "ep": 2})
    tm, _, tout, tstrat = _classifier(T, {"dp": 2, "ep": 2})
    assert tstrat == jstrat
    assert [n.name for n in tm.graph.nodes] == [n.name for n in
                                                jm.graph.nodes]
    for jn, tn in zip(jm.graph.nodes, tm.graph.nodes):
        assert tn.op.attr_signature() == jn.op.attr_signature(), tn.name
        assert ([tuple(tm.graph.spec(t).shape) for t in tn.outputs]
                == [tuple(jm.graph.spec(t).shape) for t in jn.outputs])
    jspecs, tspecs = jm.graph.param_specs(), tm.graph.param_specs()
    assert {n: {p: tuple(s.spec.shape) for p, s in g.items()}
            for n, g in tspecs.items()} == \
        {n: {p: tuple(s.spec.shape) for p, s in g.items()}
         for n, g in jspecs.items()}
    x, y = _data()
    jm, _, jout, _ = _classifier(J, {"dp": 1})
    tm, _, tout, _ = _classifier(T, {"dp": 1})
    init, jf, jh = _train(jm, jout, {}, x, y)
    _, tf, th = _train(tm, tout, {}, x, y, init=init)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6)
    np.testing.assert_allclose(th, jh, rtol=1e-5)
    _same_params(tm, jm)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's classifier and AggregateSpec graph on its 4-device
    CPU meshes, from one set of weights a graph: forward, two epochs'
    losses, the trained model."""
    x, y = _data()
    out = {}
    for net, build in (("classifier", _classifier), ("spec", _spec_net)):
        init = None
        for key, shape in (("ep4", {"ep": 4}),
                           ("dp2_ep2", {"dp": 2, "ep": 2})):
            m, _, o, strat = build(J, shape)
            m.compile(optimizer=J.SGDOptimizer(lr=0.1), outputs=[o],
                      strategy=strat)
            if init is None:
                init = _weights(m)
            else:
                m.load_params(init)
            fwd = np.asarray(m.forward(x))
            hist = m.fit(x, y, epochs=2, batch_size=TINY["batch"],
                         shuffle=False, verbose=False)
            out[(net, key)] = dict(init=init, fwd=fwd, model=m,
                                   losses=[h["loss"] for h in hist])
    return x, y, out


@pytest.mark.parametrize("key", ["ep4", "dp2_ep2"])
def test_ep_mesh_equals_one_device_and_reference(reference_runs, key):
    x, y, ref = reference_runs
    shape = {"ep4": {"ep": 4}, "dp2_ep2": {"dp": 2, "ep": 2}}[key]
    for net, build in (("classifier", _classifier), ("spec", _spec_net)):
        r = ref[(net, key)]
        one, _, o1, _ = build(T, {"dp": 1})
        _, f1, h1 = _train(one, o1, {}, x, y, init=r["init"])
        tm, _, o, strat = build(T, shape)
        _, f, h = _train(tm, o, strat, x, y, init=r["init"])
        assert tm.mesh.comm.kind == "local"
        np.testing.assert_allclose(f, f1, rtol=0, atol=1e-6)
        np.testing.assert_allclose(f, r["fwd"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(h, h1, rtol=1e-5)
        np.testing.assert_allclose(h, r["losses"], rtol=1e-5)
        _same_params(tm, r["model"])
        for n, g in one.params.items():
            for p, v in g.items():
                np.testing.assert_allclose(tm.params[n][p].detach().numpy(),
                                           v.detach().numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{n}.{p}")


@pytest.mark.parametrize("spec", ["cpu", "h100"])
def test_prices_memory_and_search_equal_reference(spec):
    """Training- and inference-mode ``simulate``, ``plan_memory_parts``
    and the joint search of the MoE classifier's graph over ``{"ep": 4}``
    and ``{"dp": 2, "ep": 2}`` equal the reference's, and every plan
    step's measured-cost key too."""
    for shape in ({"ep": 4}, {"dp": 2, "ep": 2}):
        jm, *_, jstrat = _classifier(J, shape)
        tm, *_, tstrat = _classifier(T, shape)
        jmm, pmm = machines(spec, jm.mesh, tm.mesh)
        for strat in ({}, tstrat):
            jp = JPCG(jm.graph, jm.mesh, strat).plan()
            pp = PCG(tm.graph, tm.mesh, strat).plan()
            assert [s.name for s in pp.steps] == [s.name for s in jp.steps]
            for training in (True, False):
                jc = JSIM.simulate(jp, jmm, training=training)
                pc = PSIM.simulate(pp, pmm, training=training)
                for f in ("total", "compute", "comm", "grad_comm"):
                    assert close(getattr(pc, f), getattr(jc, f)), \
                        (shape, training, f)
                jparts = JSIM.plan_memory_parts(jp, training=training)
                pparts = PSIM.plan_memory_parts(pp, training=training)
                assert pparts.keys() == jparts.keys()
                assert all(close(pparts[k], jparts[k]) for k in jparts)
                assert close(PSIM.plan_memory_bytes(pp, training=training),
                             JSIM.plan_memory_bytes(jp, training=training))
            assert [repr(PSIM._measure_key(s, tm.mesh)) for s in pp.steps
                    if not s.is_parallel] == \
                [repr(JSIM._measure_key(s, jm.mesh)) for s in jp.steps
                 if not s.is_parallel]
        # the joint search behind compile(search_budget=...)
        out = [n.outputs[-1] for n in tm.graph.nodes][-1:]
        tg, got, tmap = PSEARCH.graph_optimize(
            tm.graph, tm.mesh, budget=60, machine=pmm, seed=0,
            substitution=True, output_tids=out)
        jg, want, jmap = JSEARCH.graph_optimize(
            jm.graph, jm.mesh, budget=60, machine=jmm, seed=0,
            substitution=True, output_tids=out)
        assert got == want and tmap == jmap
        assert [n.name for n in tg.nodes] == [n.name for n in jg.nodes]


def test_local_mode_routes_over_every_expert():
    """``mode="local"`` runs the one shard-local executor, so on ``{"ep":
    4}`` it equals ``"spmd"``, AggregateSpec included.  The reference's
    ``"local"`` mode does not (a reference fault, not copied): its
    GroupBy returns every expert on every shard
    (``flexflow_tpu/ops/moe.py:73-96``), so the classifier's output moves,
    and its AggregateSpec takes the top-k over its block of ``gates``
    (:273), which raises for k above the block's experts."""
    x, _ = _data()
    for build in (_classifier, _spec_net):
        outs = {}
        for mode in ("spmd", "local"):
            m, _, o, strat = build(T, {"ep": 4})
            m.compile(outputs=[o], strategy=strat, mode=mode,
                      loss_type="identity")
            if mode == "spmd":
                init = _weights(m)
            m.load_params(init)
            outs[mode] = m.forward(x)
        torch.testing.assert_close(outs["local"], outs["spmd"], rtol=0,
                                   atol=0)
    ref = {}
    for mode in ("spmd", "local"):
        m, _, o, strat = _classifier(J, {"ep": 4})
        m.compile(outputs=[o], strategy=strat, mode=mode,
                  loss_type="identity")
        if mode == "spmd":
            init = _weights(m)
        m.load_params(init)
        ref[mode] = np.asarray(m.forward(x))
    assert np.abs(ref["local"] - ref["spmd"]).max() > 1e-2
    m, _, o, strat = _spec_net(J, {"ep": 4})
    with pytest.raises(ValueError, match="top_k"):
        m.compile(outputs=[o], strategy=strat, mode="local",
                  loss_type="identity")
        m.forward(x)
