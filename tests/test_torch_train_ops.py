"""The port's training ops, losses, metrics, optimizers and initializers
against the JAX package's, on the CPU.

Each op is built through both ``FFModel`` builders on the same inputs,
parameters and cotangent (numpy, from a seed): the port's ``forward`` and
its autograd gradients must equal the reference's ``lower`` under
``jax.vjp`` at ``rtol 1e-5``, with an ``atol`` of ``1e-5`` times the
tensor's largest magnitude (a float32 sum that cancels down to a small
element keeps the rounding of its large terms), float32 throughout.  The
JAX side runs on one CPU device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.op import OpContext as JCtx
from flexflow_tpu.ops import elementwise as jel
from flexflow_tpu.ops import reduction as jred
from flexflow_tpu.training import initializer as jinit
from flexflow_tpu.training import loss as jloss
from flexflow_tpu.training import metrics as jmet
from flexflow_tpu_torch.core.op import OpContext
from flexflow_tpu_torch.ops import elementwise as tel
from flexflow_tpu_torch.ops import reduction as tred
from flexflow_tpu_torch.training import initializer as tinit
from flexflow_tpu_torch.training import loss as tloss
from flexflow_tpu_torch.training import metrics as tmet

TOL = dict(rtol=1e-5, atol=1e-6)


def close(actual, desired):
    desired = np.asarray(desired, np.float32)
    scale = float(np.abs(desired).max()) if desired.size else 0.0
    np.testing.assert_allclose(actual, desired, rtol=1e-5,
                               atol=max(1e-6, 1e-5 * scale))


def _unary(fn, scalar=None):
    return lambda m, t, el, red: m._add(el.ElementUnary(fn, scalar), t,
                                        fn)[0]


def _reduce(fn, axes, keepdims):
    return lambda m, t, el, red: m._add(red.Reduce(fn, axes, keepdims), t,
                                        "reduce")[0]


# id -> (input shapes, positive inputs, build(model, tensors, elementwise
# module, reduction module) -> output tensor)
OPS = {
    "dense": ([(4, 8)], False, lambda m, t, el, red: m.dense(t[0], 6)),
    "dense_relu_nobias": ([(2, 3, 8)], False, lambda m, t, el, red:
                          m.dense(t[0], 5, activation="relu",
                                  use_bias=False)),
    "dense_gelu": ([(4, 8)], False, lambda m, t, el, red:
                   m.dense(t[0], 6, activation="gelu")),
    "dense_sigmoid": ([(4, 8)], False, lambda m, t, el, red:
                      m.dense(t[0], 6, activation="sigmoid")),
    "batch_matmul": ([(2, 3, 4), (2, 4, 5)], False, lambda m, t, el, red:
                     m.batch_matmul(t[0], t[1])),
    "batch_matmul_transposed": ([(2, 4, 3), (2, 5, 4)], False,
                                lambda m, t, el, red: m.batch_matmul(
                                    t[0], t[1], True, True)),
    **{f"unary_{fn}": ([(3, 7)], fn in ("log", "sqrt", "rsqrt"),
                       _unary(fn)) for fn in sorted(jel.UNARY_FNS)},
    "scalar_multiply": ([(3, 7)], False, _unary("scalar_multiply", 1.7)),
    "scalar_add": ([(3, 7)], False, _unary("scalar_add", -0.3)),
    "scalar_sub": ([(3, 7)], False, _unary("scalar_sub", 0.4)),
    "scalar_truediv": ([(3, 7)], False, _unary("scalar_truediv", 3.0)),
    "pow": ([(3, 7)], True, _unary("pow", 1.5)),
    "add": ([(3, 4), (4,)], False, lambda m, t, el, red: m.add(t[0], t[1])),
    "subtract": ([(3, 4), (3, 4)], False, lambda m, t, el, red:
                 m.subtract(t[0], t[1])),
    "multiply": ([(3, 4), (1, 4)], False, lambda m, t, el, red:
                 m.multiply(t[0], t[1])),
    "divide": ([(3, 4), (3, 4)], True, lambda m, t, el, red:
               m.divide(t[0], t[1])),
    "max": ([(3, 4), (3, 4)], False, lambda m, t, el, red: m.max(t[0], t[1])),
    "min": ([(3, 4), (4,)], False, lambda m, t, el, red: m.min(t[0], t[1])),
    "cast_bf16": ([(3, 4)], False, lambda m, t, el, red:
                  m.cast(t[0], "bfloat16")),
    "dropout_eval": ([(3, 4)], False, lambda m, t, el, red:
                     m.dropout(t[0], 0.5)),
    "layer_norm": ([(2, 3, 8)], False, lambda m, t, el, red:
                   m.layer_norm(t[0])),
    "layer_norm_nobias": ([(4, 8)], False, lambda m, t, el, red:
                          m.layer_norm(t[0], use_bias=False)),
    "layer_norm_noaffine": ([(4, 8)], False, lambda m, t, el, red:
                            m.layer_norm(t[0], elementwise_affine=False)),
    "rms_norm": ([(2, 3, 8)], False, lambda m, t, el, red: m.rms_norm(t[0])),
    "softmax": ([(3, 7)], False, lambda m, t, el, red: m.softmax(t[0])),
    "softmax_axis0": ([(3, 7)], False, lambda m, t, el, red:
                      m.softmax(t[0], axis=0)),
    "reduce_sum_keepdims": ([(2, 3, 4)], False, lambda m, t, el, red:
                            m.reduce_sum(t[0], (1,), keepdims=True)),
    "reduce_mean": ([(2, 3, 4)], False, lambda m, t, el, red:
                    m.reduce_mean(t[0], (0, 2))),
    "reduce_max": ([(2, 3, 4)], False, _reduce("max", (2,), False)),
    "reduce_min_keepdims": ([(2, 3, 4)], False, _reduce("min", (0, 1),
                                                         True)),
    "attention": ([(2, 5, 8)] * 3, False, lambda m, t, el, red:
                  m.multihead_attention(t[0], t[1], t[2], 8, 2)),
    "attention_causal_nobias": ([(2, 5, 8)] * 3, False, lambda m, t, el, red:
                                m.multihead_attention(t[0], t[1], t[2], 8,
                                                      2, use_bias=False,
                                                      causal=True)),
    "attention_kdim_vdim": ([(2, 5, 8), (2, 6, 4), (2, 6, 12)], False,
                            lambda m, t, el, red: m.multihead_attention(
                                t[0], t[1], t[2], 8, 4, kdim=4, vdim=12)),
}


def _inputs(shapes, positive, rng):
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    return [np.abs(x) + 0.5 for x in xs] if positive else xs


def _build(pkg, shapes, build, el, red):
    if pkg is J:
        m = J.FFModel(J.FFConfig(num_devices=1))
    else:
        m = T.FFModel(T.FFConfig(), device="cpu")
    ts = [m.create_tensor(s) for s in shapes]
    build(m, ts, el, red)
    return m.graph.nodes[-1].op


def _port_forward(op, xs):
    return op(*xs, ctx=OpContext()) if op.uses_context else op(*xs)


@pytest.mark.parametrize("case", sorted(OPS))
def test_op_forward_and_gradient_equal_reference(case):
    shapes, positive, build = OPS[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    xs = _inputs(shapes, positive, rng)
    jop = _build(J, shapes, build, jel, jred)
    top = _build(T, shapes, build, tel, tred)
    assert [(p.name, tuple(p.spec.shape)) for p in jop.params()] == \
        [(p.name, tuple(p.spec.shape)) for p in top.params()]
    params = {p.name: (rng.randn(*p.spec.shape) * 0.5).astype(np.float32)
              for p in jop.params()}

    def f(ins, ps):
        return jop.lower(JCtx(), list(ins), ps)[0]

    out_spec = jax.eval_shape(f, tuple(xs), params)
    ct = rng.randn(*out_spec.shape).astype(np.float32)

    @jax.jit
    def value_and_vjp(ins, ps, ct):
        out, vjp = jax.vjp(f, ins, ps)
        return out, vjp(ct.astype(out.dtype))

    jout, (jgi, jgp) = value_and_vjp(tuple(xs), params, ct)

    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    for k, v in params.items():
        setattr(top, k, nn.Parameter(torch.tensor(v)))
    tout = _port_forward(top, txs)
    tout.backward(torch.tensor(ct).to(tout.dtype))
    close(tout.detach().float().numpy(), jout)
    for tx, g in zip(txs, jgi):
        close(tx.grad.numpy(), g)
    for k in params:
        if k == "bk":
            # a key bias adds one constant to each score row, which the
            # softmax cancels: its gradient is rounding on both sides,
            # held to the scale of the query bias's gradient
            np.testing.assert_allclose(
                getattr(top, k).grad.numpy(), jgp[k], rtol=0,
                atol=1e-5 * float(np.abs(np.asarray(jgp["bq"])).max()))
            continue
        close(getattr(top, k).grad.numpy(), jgp[k])


def _jax_grad(fn, x, *rest):
    return np.asarray(jax.grad(lambda v: fn(v, *rest))(jnp.asarray(x)))


def _port_grad(fn, x, *rest):
    t = torch.tensor(x, requires_grad=True)
    fn(t, *rest).backward()
    return t.grad.numpy()


def test_ties_split_the_gradient_as_the_reference_does():
    """A saturated softmax row (p = 1.0 in float32, the clip's upper
    bound) through each crossentropy, and a pre-activation of exactly 0
    through relu and max/min: jnp.clip and jnp.maximum split the gradient
    at the tie; torch.clamp and F.relu would not."""
    probs = np.array([[1.0, 0.0, 0.0], [0.2, 0.5, 0.3]], np.float32)
    sparse = np.array([0, 1], np.int32)
    onehot = np.eye(3, dtype=np.float32)[sparse]
    for lt, lab in (("sparse_categorical_crossentropy", sparse),
                    ("categorical_crossentropy", onehot)):
        jg = _jax_grad(lambda p, l: jloss.compute_loss(lt, p, l), probs,
                       jnp.asarray(lab))
        tg = _port_grad(lambda p, l: tloss.compute_loss(lt, p, l), probs,
                        torch.tensor(lab))
        assert jg[0, 0] == pytest.approx(-0.25)     # half of -1/(1 * 2)
        np.testing.assert_allclose(tg, jg, **TOL)
    x = np.array([-1.0, 0.0, 2.0], np.float32)
    jg = _jax_grad(lambda v: jel.UNARY_FNS["relu"](v).sum(), x)
    tg = _port_grad(lambda v: tel.UNARY_FNS["relu"](v).sum(), x)
    np.testing.assert_array_equal(tg, jg)
    assert tg[1] == 0.5
    z = np.zeros(3, np.float32)
    for fn in ("max", "min"):
        jg = _jax_grad(lambda a, b: jel.ElementBinary.FNS[fn](a, b).sum(),
                       x, jnp.asarray(z))
        tg = _port_grad(lambda a, b: tel.ElementBinary.FNS[fn](a, b).sum(),
                        x, torch.tensor(z))
        np.testing.assert_array_equal(tg, jg)


LOSS_CASES = {
    "sparse_categorical_crossentropy": "sparse",
    "categorical_crossentropy": "onehot",
    "mean_squared_error": "dense",
    "binary_crossentropy": "binary",
    "identity": "dense",
}


def _loss_inputs(kind, rng):
    logits = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    ids = rng.randint(0, 5, size=6)
    labels = {"sparse": ids.astype(np.int32).reshape(6, 1),
              "onehot": np.eye(5, dtype=np.float32)[ids],
              "dense": rng.randn(6, 5).astype(np.float32),
              "binary": (rng.rand(6, 5) > 0.5).astype(np.float32)}[kind]
    return logits, labels


@pytest.mark.parametrize("loss_type", sorted(LOSS_CASES))
def test_loss_value_and_gradient_equal_reference(loss_type):
    rng = np.random.RandomState(3)
    logits, labels = _loss_inputs(LOSS_CASES[loss_type], rng)
    jv, jg = jax.value_and_grad(lambda p: jloss.compute_loss(
        loss_type, p, jnp.asarray(labels)))(jnp.asarray(logits))
    t = torch.tensor(logits, requires_grad=True)
    tv = tloss.compute_loss(loss_type, t, torch.tensor(labels))
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), **TOL)
    with pytest.raises(ValueError, match="unknown loss"):
        tloss.compute_loss("hinge", t, torch.tensor(labels))


@pytest.mark.parametrize("kind", ["sparse", "onehot", "dense"])
def test_metrics_equal_reference(kind):
    rng = np.random.RandomState(4)
    logits, labels = _loss_inputs(kind, rng)
    names = {"sparse": ["accuracy", "sparse_categorical_crossentropy"],
             "onehot": ["accuracy", "categorical_crossentropy"],
             "dense": ["mean_squared_error"]}[kind]
    jm = jmet.compute_metrics(names, jnp.asarray(logits),
                              jnp.asarray(labels))
    tm = tmet.compute_metrics(names, torch.tensor(logits),
                              torch.tensor(labels))
    assert sorted(tm) == sorted(jm)
    for k in names:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    with pytest.raises(ValueError, match="unknown metric"):
        tmet.compute_metrics(["f1"], torch.tensor(logits),
                             torch.tensor(labels))


OPTIMIZERS = {
    "sgd": dict(cls="SGDOptimizer", lr=0.1),
    "sgd_wd": dict(cls="SGDOptimizer", lr=0.1, weight_decay=0.01),
    "sgd_momentum": dict(cls="SGDOptimizer", lr=0.1, momentum=0.9),
    "sgd_nesterov_wd": dict(cls="SGDOptimizer", lr=0.1, momentum=0.9,
                            nesterov=True, weight_decay=0.01),
    "adam": dict(cls="AdamOptimizer", alpha=0.01),
    "adam_wd": dict(cls="AdamOptimizer", alpha=0.01, weight_decay=0.1),
    "adamw": dict(cls="AdamOptimizer", alpha=0.01, weight_decay=0.1,
                  adamw=True, beta1=0.8, beta2=0.99, epsilon=1e-6),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_equal_reference(name):
    """Three updates of each configuration (the state carries between
    them), one of them on a gradient that is small against eps."""
    kw = dict(OPTIMIZERS[name])
    cls = kw.pop("cls")
    jopt, topt = getattr(J, cls)(**kw), getattr(T, cls)(**kw)
    rng = np.random.RandomState(5)
    params = {"a": {"kernel": rng.randn(4, 3).astype(np.float32),
                    "bias": rng.randn(3).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, params)
    tp = {n: {k: torch.tensor(v) for k, v in g.items()}
          for n, g in params.items()}
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for step in range(3):
        scale = 1e-9 if step == 1 else 1.0
        grads = {"a": {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                       for k, v in params["a"].items()}}
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts = topt.update({"a": {k: torch.tensor(v) for k, v in
                                    grads["a"].items()}}, ts, tp)
        for k in params["a"]:
            np.testing.assert_allclose(tp["a"][k].numpy(),
                                       np.asarray(jp["a"][k]), **TOL)
    if cls == "AdamOptimizer":
        assert ts["t"] == int(js["t"]) == 3
        np.testing.assert_allclose(ts["v"]["a"]["kernel"].numpy(),
                                   np.asarray(js["v"]["a"]["kernel"]),
                                   **TOL)


def test_initializers_bounds_and_moments():
    """The reference's fans (shape[0], shape[-1]; OIHW's receptive
    field), the bounds and moments of each initializer, and the defaults
    by parameter name: equal in distribution, not draw for draw."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for shape in [(64, 4, 16), (120, 80), (8, 4, 3, 3), (500,)]:
        t = tinit.GlorotUniform()(g, shape, torch.float32)
        j = np.asarray(jinit.GlorotUniform()(key, shape, jnp.float32))
        assert t.shape == j.shape and t.dtype == torch.float32
        lim_j = np.abs(j).max()
        assert t.abs().max().item() <= lim_j * 1.02 + 1e-6
        assert t.abs().max().item() >= lim_j * 0.9
        # uniform on [-l, l]: variance l^2 / 3
        assert t.var().item() == pytest.approx(j.var(), rel=0.15)
    u = tinit.UniformInitializer(-0.2, 0.6)(g, (20000,), torch.float32)
    assert -0.2 <= u.min().item() and u.max().item() <= 0.6
    assert u.mean().item() == pytest.approx(0.2, abs=0.01)
    n = tinit.NormInitializer(1.5, 0.5)(g, (20000,), torch.float32)
    assert n.mean().item() == pytest.approx(1.5, abs=0.02)
    assert n.std().item() == pytest.approx(0.5, rel=0.03)
    assert tinit.ZeroInitializer()(g, (3,), torch.float32).eq(0).all()
    assert tinit.OneInitializer()(g, (3,), torch.float32).eq(1).all()
    for pname in ("bias", "beta", "gamma", "kernel", "wq", "bq"):
        spec = T.core.graph.ParamSpec(pname, None)
        assert (type(jinit.default_initializer_for(None, spec)).__name__
                == type(tinit.default_initializer_for(None, spec)).__name__)


def test_dropout_keep_rate_scaling_and_eval_identity():
    x = torch.ones(200, 500)
    op = tel.Dropout(0.3, seed=7)
    g = torch.Generator().manual_seed(1)
    y = op(x, ctx=OpContext(training=True, generator=g))
    kept = y != 0
    assert kept.float().mean().item() == pytest.approx(0.7, abs=0.01)
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    # the step's generator decides the mask; without one, the op's seed
    y2 = op(x, ctx=OpContext(training=True,
                             generator=torch.Generator().manual_seed(1)))
    assert torch.equal(y, y2)
    assert torch.equal(op(x, ctx=OpContext(training=True)),
                       op(x, ctx=OpContext(training=True)))
    assert op(x, ctx=OpContext(training=False)) is x
    assert tel.Dropout(0.0)(x, ctx=OpContext(training=True)) is x
    # the reference's keep rate and scaling, in distribution
    jy = np.asarray(jel.Dropout(0.3).lower(
        JCtx(training=True, rng=jax.random.PRNGKey(0)),
        [jnp.ones((200, 500))], {})[0])
    assert (jy != 0).mean() == pytest.approx(kept.float().mean().item(),
                                             abs=0.01)
    # attention dropout on the probabilities, only with a step generator
    att = T.FFModel(T.FFConfig(), device="cpu")
    q = att.create_tensor((2, 4, 8))
    att.multihead_attention(q, q, q, 8, 2, dropout=0.5)
    mha = att.graph.nodes[-1].op
    for p in mha.params():
        setattr(mha, p.name, nn.Parameter(torch.randn(p.spec.shape)))
    xq = torch.randn(2, 4, 8)
    base = mha(xq, xq, xq, ctx=OpContext(training=False))
    assert torch.equal(mha(xq, xq, xq, ctx=OpContext(training=True)), base)
    dropped = mha(xq, xq, xq, ctx=OpContext(
        training=True, generator=torch.Generator().manual_seed(0)))
    assert not torch.allclose(dropped, base)


def test_attention_sequence_config_raises():
    m = T.FFModel(T.FFConfig(), device="cpu")
    q = m.create_tensor((2, 4, 8))
    m.multihead_attention(q, q, q, 8, 2)
    mha = m.graph.nodes[-1].op
    for p in mha.params():
        setattr(mha, p.name, nn.Parameter(torch.randn(p.spec.shape)))
    x = torch.randn(2, 4, 8)
    # one device holds the whole sequence: the plain attention
    assert torch.equal(
        mha(x, x, x, ctx=OpContext(config={"sequence": ("dp",)})),
        mha(x, x, x, ctx=OpContext()))
    # its op IR is the reference's, which refuses a split over two axes
    specs = [m.graph.spec(q.tid)] * 3
    with pytest.raises(ValueError, match="exactly one mesh axis"):
        mha.apply_config({"sequence": ("dp", "tp")}, specs,
                         T.make_mesh({"dp": 2, "tp": 2}, ["cpu"] * 4))
    jm = J.FFModel(J.FFConfig(num_devices=1))
    jq = jm.create_tensor((2, 4, 8))
    jm.multihead_attention(jq, jq, jq, 8, 2)
    jop = jm.graph.nodes[-1].op
    jspecs = [jm.graph.spec(jq.tid)] * 3
    assert mha.flops(specs) == jop.flops(jspecs)
    assert mha.parallel_dims(specs) == jop.parallel_dims(jspecs)
