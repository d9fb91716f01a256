"""The port's shape ops and embedding aggregation against the JAX
package's, on the CPU; and node names that hold dots (F7).

Each op is built through both ``FFModel`` builders on the same inputs,
parameters and cotangents (numpy, from a seed): the port's ``forward``
equals the reference's ``lower`` at ``atol 1e-5`` and its autograd
gradients equal ``jax.vjp``'s at ``rtol 1e-4``, ``atol 1e-5`` (float32).
Every op's ``attr_signature()`` is the reference's (the cost-cache key,
F6's rule).  On a ``{"dp": 2}`` mesh a graph of every shape op trains as
the reference's on its 2-device CPU mesh: the shape ops keep dim 0's
split where the reference does and want whole every axis they join,
cut or reverse.  :func:`run_case` is the harness ``test_torch_conv_norm``
shares.
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
from flexflow_tpu_torch.core.graph import TensorSpec
from flexflow_tpu_torch.core.interpreter import plan_shards
from flexflow_tpu_torch.core.op import OpContext
from flexflow_tpu_torch.training.checkpoint import _flatten, save_checkpoint

FWD = dict(rtol=0, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _inputs(shapes, rng):
    """Float inputs for ``(shape)`` entries, int32 ids in ``[low, high)``
    for ``(shape, low, high)`` entries."""
    out = []
    for s in shapes:
        if isinstance(s[0], tuple):
            shape, low, high = s
            out.append(rng.randint(low, high, size=shape).astype(np.int32))
        else:
            out.append(rng.randn(*s).astype(np.float32))
    return out


def _built(pkg, shapes, build):
    if pkg is J:
        m = J.FFModel(J.FFConfig(num_devices=1))
    else:
        m = T.FFModel(T.FFConfig(), device="cpu")
    ts = []
    for s in shapes:
        if isinstance(s[0], tuple):
            ts.append(m.create_tensor(s[0], dtype="int32"))
        else:
            ts.append(m.create_tensor(s))
    build(m, ts)
    node = m.graph.nodes[-1]
    return node.op, [m.graph.spec(t) for t in node.inputs]


def run_case(shapes, build, training=False, seed=0):
    """Build one op on both sides (``build(model, tensors)``), run the
    reference's ``lower`` under ``jax.vjp`` and the port's ``forward``
    under autograd on the same inputs, parameters and cotangents, and
    hold outputs and gradients to ``FWD`` and ``GRAD``.  Returns the two
    ops."""
    rng = np.random.RandomState(seed)
    xs = _inputs(shapes, rng)
    jop, jspecs = _built(J, shapes, build)
    top, _ = _built(T, shapes, build)
    assert [(p.name, tuple(p.spec.shape)) for p in jop.params()] == \
        [(p.name, tuple(p.spec.shape)) for p in top.params()]
    params = {p.name: (rng.randn(*p.spec.shape) * 0.5).astype(np.float32)
              for p in jop.params()}
    if "running_var" in params:
        params["running_var"] = np.abs(params["running_var"]) + 0.5
    floats = [i for i, x in enumerate(xs) if x.dtype == np.float32]

    def f(fins, ps):
        ins = list(xs)
        for i, v in zip(floats, fins):
            ins[i] = v
        ctx = JCtx(training=training, extras={"in_specs": jspecs})
        return jop.lower(ctx, ins, ps)

    fins = tuple(xs[i] for i in floats)
    cts = [rng.randn(*o.shape).astype(np.float32)
           for o in jax.eval_shape(f, fins, params)]
    jout, vjp = jax.vjp(f, fins, params)
    jg_in, jg_p = vjp(cts)

    txs = [torch.tensor(x, requires_grad=x.dtype == np.float32) for x in xs]
    for k, v in params.items():
        setattr(top, k, nn.Parameter(torch.tensor(v)))
    out = (top(*txs, ctx=OpContext(training=training)) if top.uses_context
           else top(*txs))
    outs = list(out) if isinstance(out, tuple) else [out]
    assert len(outs) == len(jout)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cts])
    for o, j in zip(outs, jout):
        assert tuple(o.shape) == tuple(j.shape)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(j), **FWD)
    for i, g in zip(floats, jg_in):
        np.testing.assert_allclose(txs[i].grad.numpy(), np.asarray(g),
                                   **GRAD)
    for k in params:
        grad = getattr(top, k).grad
        got = np.zeros_like(params[k]) if grad is None else grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jg_p[k]), **GRAD,
                                   err_msg=k)
    return jop, top


# id -> (input shapes, build(model, tensors))
CASES = {
    "reshape": ([(4, 6, 2)], lambda m, t: m.reshape(t[0], (4, 3, 4))),
    "reshape_infer": ([(4, 6, 2)], lambda m, t: m.reshape(t[0], (-1, 6))),
    "transpose": ([(2, 3, 4)], lambda m, t: m.transpose(t[0], (2, 0, 1))),
    "concat": ([(2, 3, 4), (2, 5, 4), (2, 1, 4)], lambda m, t:
               m.concat(t, axis=1)),
    "split_sizes": ([(3, 7)], lambda m, t: m.split(t[0], [2, 4, 1], -1)),
    "split_equal": ([(6, 4)], lambda m, t: m.split(t[0], 3, 0)),
    "gather_negative": ([(3, 5), ((3, 4), -5, 5)], lambda m, t:
                        m.gather(t[0], t[1], axis=1)),
    "reverse_flat": ([(2, 3, 4)], lambda m, t: m.flat(m.reverse(t[0], 1))),
    "embedding_none": ([((3, 4), 0, 11)], lambda m, t:
                       m.embedding(t[0], 11, 6)),
    "embedding_sum": ([((4, 3), 0, 11)], lambda m, t:
                      m.embedding(t[0], 11, 6, aggr="sum")),
    "embedding_avg": ([((2, 3, 5), 0, 11)], lambda m, t:
                      m.embedding(t[0], 11, 6, aggr="avg")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_gradient_equal_reference(case):
    shapes, build = CASES[case]
    jop, top = run_case(shapes, build, seed=sum(map(ord, case)))
    assert top.attr_signature() == jop.attr_signature()


def test_every_new_builder_op_has_the_reference_signature():
    """``attr_signature()`` of every op of the slice, built with other
    than default arguments, equals the reference's."""
    def build(m):
        x = m.create_tensor((2, 3, 8, 8))
        v = m.create_tensor((2, 8))
        ids = m.create_tensor((2, 3), dtype="int32")
        m.conv2d(x, 4, kernel=(5, 3), stride=(2, 1), padding=1,
                 activation="relu", use_bias=False, groups=1)
        m.conv2d(x, 6, padding=((0, 1), (2, 0)), groups=3)
        m.pool2d(x, kernel=(3, 3), stride=(1, 1), padding="SAME",
                 pool_type="avg")
        m.batch_norm(x, relu=True, eps=1e-3, momentum=0.5)
        m.add_bias_residual_layer_norm(v, v, elementwise_affine=False,
                                       eps=1e-6)
        m.embedding(ids, 7, 5, aggr="avg")
        m.reshape(x, (2, -1))
        m.transpose(x, (0, 2, 3, 1))
        m.concat([x, x], axis=1)
        m.split(x, [1, 2], axis=1)
        m.gather(x, m.create_tensor((2, 3, 8, 2), dtype="int32"), 3)
        m.reverse(x, 2)
        m.flat(x)
        return m

    jm = build(J.FFModel(J.FFConfig(num_devices=1)))
    tm = build(T.FFModel(T.FFConfig(), device="cpu"))
    assert [n.name for n in tm.graph.nodes] == [n.name for n in jm.graph.nodes]
    for jn, tn in zip(jm.graph.nodes, tm.graph.nodes):
        assert tn.op.attr_signature() == jn.op.attr_signature(), tn.name
        assert (tn.op.flops([tm.graph.spec(t) for t in tn.inputs])
                == jn.op.flops([jm.graph.spec(t) for t in jn.inputs]))
        assert ([tuple(tm.graph.spec(t).shape) for t in tn.outputs]
                == [tuple(jm.graph.spec(t).shape) for t in jn.outputs])


def _shape_graph(pkg, mesh):
    """Every shape op between two dense layers, batch 8 (dim 0 kept
    through reshape and flat; concat, split and reverse on axis 1; the
    reshape's last dim inferred)."""
    m = pkg.FFModel(pkg.FFConfig(batch_size=8), mesh=mesh)
    x = m.create_tensor((8, 12))
    idx = m.create_tensor((8, 3), dtype="int32")
    h = m.dense(x, 12, activation="tanh", name="fc1")
    r = m.reshape(h, (8, 3, -1), name="to3d")
    t = m.transpose(r, (0, 2, 1), name="swap")
    a, b = m.split(t, [1, 3], axis=1, name="cut")
    c = m.concat([m.reverse(b, 1, name="rev"), a], axis=1, name="join")
    f = m.flat(c, name="flatten")
    g = m.gather(f, idx, axis=1, name="pick")
    m.softmax(m.dense(m.concat([f, g], axis=1, name="cat2"), 5,
                      name="head"))
    return m


def test_shape_ops_train_on_a_mesh_as_the_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(16, 12).astype(np.float32)
    idx = rng.randint(-12, 12, size=(16, 3)).astype(np.int32)
    y = rng.randint(0, 5, 16).astype(np.int32)
    jm = _shape_graph(J, J.make_mesh({"dp": 2}, jax.devices()[:2]))
    jm.compile(optimizer=J.SGDOptimizer(lr=0.1))
    weights = {n: {p: np.asarray(v) for p, v in g.items()}
               for n, g in jm.params.items()}
    ports = []
    for shape in ({"dp": 1}, {"dp": 2}):
        tm = _shape_graph(T, T.make_mesh(shape, ["cpu"] * shape["dp"]))
        tm.compile(optimizer=T.SGDOptimizer(lr=0.1))
        tm.load_params(weights)
        # a probe at a shard's local shape (as the cost model prices an
        # op) leaves the reshape's forward as it was
        node = next(n for n in tm.graph.nodes if n.name == "to3d")
        for op in [node.op] + [ops["to3d"] for ops in plan_shards(
                tm.plan).ops]:
            op.infer_shapes([TensorSpec((4, 12), torch.float32)])
        ports.append(tm)
    assert [s.node.op.type_name for s in ports[1].plan.steps] == \
        [s.node.op.type_name for s in JPCG(
            jm.graph, jm.mesh, ports[1].strategy).plan().steps]
    want = np.asarray(jm.forward([x[:8], idx[:8]]))
    for tm in ports:
        np.testing.assert_allclose(tm.forward([x[:8], idx[:8]]).numpy(),
                                   want, **FWD)
    jh = jm.fit([x, idx], y, epochs=2, batch_size=8, shuffle=False,
                verbose=False)
    for tm in ports:
        th = tm.fit([x, idx], y, epochs=2, batch_size=8, shuffle=False,
                    verbose=False)
        for a, b in zip(th, jh):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        for n, g in jm.params.items():
            for p, v in g.items():
                np.testing.assert_allclose(
                    tm.params[n][p].detach().numpy(), np.asarray(v),
                    rtol=1e-4, atol=1e-6, err_msg=f"{n}.{p}")


def _dotted(pkg, mesh=None):
    if pkg is J:
        m = J.FFModel(J.FFConfig(batch_size=4, num_devices=1))
    else:
        m = T.FFModel(T.FFConfig(batch_size=4), mesh=mesh, device="cpu")
    x = m.create_tensor((4, 6))
    h = m.dense(x, 8, activation="relu", name="block.0.fc")
    h = m.dense(h, 8, activation="relu", name="block.0.fc")   # block.0.fc_1
    m.softmax(m.dense(h, 3, name="head%.out"))
    return m


def test_f7_dotted_node_names_equal_reference(tmp_path):
    """F7: a node name may hold '.', as the reference's builders name
    theirs: node names, ``params()`` keys, the strategy dict's keys and
    the checkpoint's keys are the reference's; ``layers`` answers by node
    name; outputs and a trained step are the reference's."""
    jm = _dotted(J)
    jm.compile(optimizer=J.SGDOptimizer(lr=0.1))
    names = [n.name for n in jm.graph.nodes]
    assert names == ["block.0.fc", "block.0.fc_1", "head%.out", "softmax"]
    weights = {n: {p: np.asarray(v) for p, v in g.items()}
               for n, g in jm.params.items()}
    rng = np.random.RandomState(4)
    x = rng.randn(4, 6).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.int32)
    for mesh in (None, T.make_mesh({"dp": 2}, ["cpu", "cpu"])):
        tm = _dotted(T, mesh)
        assert [n.name for n in tm.graph.nodes] == names
        assert list(tm.layers) == names
        assert tm.layers["block.0.fc_1"] is tm.graph.nodes[1].op
        assert "head%.out" in tm.layers and "head%2Eout" not in tm.layers
        tm.compile(optimizer=T.SGDOptimizer(lr=0.1))
        assert sorted(tm.params) == sorted(jm.params)
        if mesh is not None:
            assert sorted(tm.strategy) == sorted(names)
        tm.load_params(weights)
        np.testing.assert_allclose(tm.forward(x).numpy(),
                                   np.asarray(jm.forward(x)), **FWD)
        assert sorted(_flatten(tm.params)) == sorted(
            _flatten({n: dict(g) for n, g in weights.items()}))
        th = tm.fit(x, y, epochs=1, batch_size=4, shuffle=False,
                    verbose=False)
    jh = jm.fit(x, y, epochs=1, batch_size=4, shuffle=False, verbose=False)
    assert th[0]["loss"] == pytest.approx(jh[0]["loss"], rel=1e-5)
    save_checkpoint(str(tmp_path / "ck"), tm)
    with np.load(tmp_path / "ck" / "params.npz") as z:
        assert "['block.0.fc']['kernel']" in z.files
