"""Training on a mesh through the port's ``FFModel`` against the JAX
package's, on the CPU (modelled on ``tests/test_execution.py``).

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``),
the port on a mesh over ``["cpu"] * n``: every shard on the CPU, joined by
the local collectives (``parallel/comm.py``), with the shard-local
executor, the collectives' gradients and the gradient sum over replicas
that run across cards.  Both sides start from the reference's weights
(``load_params``).  Forward outputs and gradients are held at the
reference's own ``rtol 2e-5, atol 1e-6``; 3-epoch ``fit`` histories and
parameters at ``tests/test_torch_train.py``'s tolerances (``rtol 1e-5``;
Adam's parameters at an ``atol`` tied to ``alpha``, for the reason that
file gives).  Dropout is off in the parity tests, as the two packages
draw masks from different generators; one test holds the port's masks
to their two properties (replicas of a block draw one mask, blocks
different ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.interpreter import build_forward as jax_forward
from flexflow_tpu.core.interpreter import init_params as jax_init
from flexflow_tpu.core.pcg import PCG as JPCG
from flexflow_tpu.models.transformer import \
    build_transformer_classifier as jax_transformer
from flexflow_tpu.training import loss as jax_loss
from flexflow_tpu_torch.core.interpreter import place_inputs
from flexflow_tpu_torch.core.op import OpContext, bias_once
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as port_transformer
from flexflow_tpu_torch.parallel.comm import Comm, run_shards

from test_torch_train import (TF, _jax_params, _port_params, _same_history,
                              _same_params)

RTOL, ATOL = 2e-5, 1e-6
DP = {"sample": ("dp",)}


def _cpus(n):
    return ["cpu"] * n


def _mlp(pkg, mesh):
    """``tests/test_execution.py:build_mlp``."""
    m = pkg.FFModel(pkg.FFConfig(batch_size=16), mesh=mesh)
    x = m.create_tensor((16, 32))
    h = m.dense(x, 64, activation="relu", name="fc1")
    h = m.dense(h, 48, activation="relu", name="fc2")
    m.softmax(m.dense(h, 8, name="fc3"))
    return m


def _pair(pkg, mesh):
    """The Megatron pair of ``tests/test_execution.py``."""
    m = pkg.FFModel(pkg.FFConfig(batch_size=16), mesh=mesh)
    x = m.create_tensor((16, 32))
    h = m.dense(x, 64, activation="relu", name="col")
    m.dense(h, 32, name="row", use_bias=True)
    return m


LAYOUTS = {
    "dp4": (_mlp, {"dp": 4}, {"fc1": DP, "fc2": DP, "fc3": DP,
                              "softmax": DP}),
    "tp8": (_mlp, {"tp": 8}, {"fc1": {"channel_out": ("tp",)},
                              "fc2": {"channel_out": ("tp",)}, "fc3": {}}),
    "pair_tp8": (_pair, {"tp": 8}, {"col": {"channel_out": ("tp",)},
                                    "row": {"channel_in": ("tp",)}}),
    "dp4_tp2": (_mlp, {"dp": 4, "tp": 2},
                {"fc1": dict(DP, channel_out=("tp",)),
                 "fc2": dict(DP, channel_out=("tp",)),
                 "fc3": DP, "softmax": DP}),
}


def _n(shape):
    return int(np.prod(list(shape.values())))


@pytest.fixture(scope="module")
def x_np():
    return np.random.RandomState(3).randn(16, 32).astype(np.float32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forward_equals_reference_in_both_modes(layout, x_np):
    build, shape, strategy = LAYOUTS[layout]
    jmesh = J.make_mesh(shape, jax.devices()[:_n(shape)])
    jm = build(J, jmesh)
    jplan = JPCG(jm.graph, jmesh, strategy).plan()
    params = jax_init(jm.graph, jplan, jax.random.PRNGKey(7))
    tid = jm.graph.input_tids[0]
    weights = {n: {p: np.asarray(v) for p, v in g.items()}
               for n, g in params.items()}
    for mode in ("spmd", "local"):
        want = np.asarray(jax_forward(jplan, mode)(
            params, {tid: jnp.asarray(x_np)})[0])
        tm = build(T, T.make_mesh(shape, _cpus(_n(shape))))
        tm.compile(strategy=strategy, mode=mode)
        tm.load_params(weights)
        got = tm.forward(x_np).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5
                                   if layout == "pair_tp8" else ATOL)
        kinds = [s.node.op.type_name for s in tm.plan.steps]
        assert kinds == [s.node.op.type_name for s in jplan.steps]
        if layout == "pair_tp8":   # the normaliser's all-reduce
            assert "allreduce" in kinds


def _megatron(graph, dp=True):
    """The transformer's Megatron dict: attention ``head``, ``ff1``
    ``channel_out``, ``ff2`` ``channel_in`` over ``tp``; ``sample`` over
    ``dp`` everywhere."""
    out = {}
    for node in graph.nodes:
        c = dict(DP) if dp else {}
        if node.name.endswith("_attn"):
            c["head"] = ("tp",)
        elif node.name.endswith("_ff1"):
            c["channel_out"] = ("tp",)
        elif node.name.endswith("_ff2"):
            c["channel_in"] = ("tp",)
        out[node.name] = c
    return out


def _port(shape, strategy=None, dropout=0.0, seed=0):
    mesh = T.make_mesh(shape, _cpus(_n(shape)))
    m = port_transformer(T.FFConfig(batch_size=TF["batch"], seed=seed),
                         mesh=mesh, dropout=dropout, **TF)
    if strategy == "megatron":
        strategy = _megatron(m.graph, "dp" in shape)
    return m, strategy


def _data(n=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, TF["seq"], TF["hidden_dim"]).astype(np.float32),
            rng.randint(0, TF["num_classes"], n).astype(np.int32))


def _port_grads(m, x, y):
    """Every parameter's gradient after the gradient sum, global, and
    whether every replica of each block holds the same bits."""
    batch = place_inputs(m.plan, m._standardize_inputs(x))
    outs = m._forward(batch, training=True, seed=0)
    m._total_loss(outs, torch.as_tensor(y)).backward()
    params = [m._trainable(r) for r in range(m.mesh.size)]
    m._sum_grads(params)
    grads, same = {}, True
    sp = m.plan.shards.plan
    for n, g in params[0].items():
        for p in g:
            parts = [params[r][n][p].grad for r in range(m.mesh.size)]
            grads.setdefault(n, {})[p] = m._whole(n, p, parts).numpy()
            for r, part in enumerate(parts):
                twin = sp.local(f"{n}.{p}", torch.as_tensor(
                    grads[n][p]), r)
                same &= torch.equal(part, twin)
    return grads, same


@pytest.mark.parametrize("shape,strategy", [
    ({"dp": 2}, None), ({"tp": 2}, "megatron"),
    ({"tp": 2}, {"enc0_ff1": {"channel_out": ("tp",)},
                 "enc0_ff2": {"channel_in": ("tp",)}}),
    ({"dp": 2, "tp": 2}, "megatron")],
    ids=["dp2", "tp2", "pair_tp2", "dp2_tp2"])
def test_summed_gradients_equal_the_reference(shape, strategy):
    jm = jax_transformer(J.FFConfig(batch_size=TF["batch"], num_devices=1),
                         **TF)
    jm.compile()
    weights = _jax_params(jm)
    x, y = _data(n=TF["batch"])
    tid = jm.graph.input_tids[0]

    def loss_fn(p):
        out = jm._forward(p, {tid: jnp.asarray(x)})[0]
        return jax_loss.compute_loss(jm.loss_type, out, jnp.asarray(y))

    want = jax.grad(loss_fn)(jm.params)
    tm, strategy = _port(shape, strategy)
    tm.compile(strategy=strategy)
    tm.load_params(weights)
    got, same = _port_grads(tm, x, y)
    assert same, "replicas of a block hold different gradients"
    for n, g in got.items():
        for p, v in g.items():
            # a key bias's gradient is rounding on both sides (the softmax
            # cancels it), so it is held at the atol alone
            np.testing.assert_allclose(
                v, np.asarray(want[n][p]), rtol=RTOL,
                atol=1e-5 if p == "bk" else ATOL, err_msg=f"{n}.{p}")


def test_init_params_is_mesh_independent():
    """A ``dp2 x tp2`` model and a one-device model from one seed hold the
    same weights bit for bit; each shard's block is its own parameter."""
    one, _ = _port({"dp": 1})
    one.compile()
    four, strategy = _port({"dp": 2, "tp": 2}, "megatron")
    four.compile(strategy=strategy)
    for n, g in one.params.items():
        for p, v in g.items():
            assert torch.equal(four.params[n][p], v), f"{n}.{p}"
    blocks = [s["enc0_ff1"]["kernel"] for s in four.shard_params]
    assert [tuple(b.shape) for b in blocks] == [(16, 16)] * 4
    assert len({b.data_ptr() for b in blocks}) == 4
    assert four.layers["enc0_attn"].wq.is_meta   # the planner's view


@pytest.mark.parametrize("opt", [("SGDOptimizer", dict(lr=0.05,
                                                       momentum=0.9)),
                                 ("AdamOptimizer", dict(alpha=0.01))],
                         ids=["sgd_momentum", "adam"])
@pytest.mark.parametrize("shape", [{"dp": 2}, {"dp": 2, "tp": 2}],
                         ids=["dp2", "dp2_tp2"])
def test_fit_equals_reference(shape, opt):
    cls, kw = opt
    jmesh = J.make_mesh(shape, jax.devices()[:_n(shape)])
    jm = jax_transformer(J.FFConfig(batch_size=TF["batch"]), mesh=jmesh,
                         **TF)
    tm, strategy = _port(shape, "megatron" if "tp" in shape else None)
    if strategy is not None:
        strategy = _megatron(jm.graph)
    jm.compile(optimizer=getattr(J, cls)(**kw), strategy=strategy,
               metrics=["accuracy"])
    tm.compile(optimizer=getattr(T, cls)(**kw), strategy=strategy,
               metrics=["accuracy"])
    tm.load_params(_jax_params(jm))
    x, y = _data(n=16)
    _same_history(tm.fit(x, y, epochs=3, shuffle=False, verbose=False),
                  jm.fit(x, y, epochs=3, shuffle=False, verbose=False))
    _same_params(tm, jm, kw.get("alpha"))
    if cls == "AdamOptimizer":   # the step counter, once per shard
        assert [s["t"] for s in tm.shard_opt_states] == [12] * _n(shape)
    assert tm.grad_allreduces == 12 * (1 if "tp" not in shape else 3)


def test_bias_once_at_rank_2_of_dp2_tp2():
    """Rank 2 of ``dp=2 x tp=2`` is ``dp=1, tp=0``: it adds a partial
    output's bias; ranks 1 and 3 (``tp=1``) add zeros."""
    mesh = T.make_mesh({"dp": 2, "tp": 2}, _cpus(4))
    b = torch.arange(3.0)
    got = [bias_once(b, ("tp",), OpContext(rank=r, mesh=mesh))
           for r in range(4)]
    assert [bool(g.any()) for g in got] == [True, False, True, False]
    assert torch.equal(bias_once(b, (), OpContext(rank=3, mesh=mesh)), b)
    # and in the model: a row-parallel Linear skips its bias on tp=1 only
    m, strategy = _port({"dp": 2, "tp": 2}, "megatron")
    m.compile(strategy=strategy)
    ops = m.plan.shards.ops
    assert [ops[r]["enc0_ff2"].skip_bias for r in range(4)] == \
        [False, True, False, True]


def test_dropout_masks_follow_the_blocks():
    """Shards holding the same block of a tensor (``tp`` replicas) draw
    the same mask; shards holding different blocks (``dp`` rows) draw
    different ones."""
    m, _ = _port({"dp": 2, "tp": 2}, dropout=0.5)
    # data-parallel, the attention head-split: the feed-forward's dropout
    # sees rows split over dp and whole over tp
    strategy = {n.name: dict(DP, head=("tp",)) if n.name.endswith("_attn")
                else DP for n in m.graph.nodes}
    m.compile(strategy=strategy)
    node = "enc0_ffdrop"
    seen, live = {}, {}
    for r in range(4):
        op = m.plan.shards.ops[r][node]
        orig = op.forward

        def spy(x, ctx, r=r, orig=orig):
            out = orig(x, ctx)
            seen[r] = (out == 0) & (x != 0)   # dropped (relu makes zeros)
            live[r] = int((x != 0).sum())
            return out

        op.forward = spy
    x, _ = _data(n=TF["batch"])
    m._forward(place_inputs(m.plan, m._standardize_inputs(x)),
               training=True, seed=123)
    # ranks (dp, tp): 0=(0,0), 1=(0,1), 2=(1,0), 3=(1,1); the dropout's
    # input is split over dp (rows) and whole over tp
    assert torch.equal(seen[0], seen[1]) and torch.equal(seen[2], seen[3])
    assert not torch.equal(seen[0], seen[2])
    assert 0.4 < int(seen[0].sum()) / live[0] < 0.6


def test_sub_axis_all_gather_backward():
    """An all-gather over ``tp`` within each ``dp`` row of ``dp2 x tp2``:
    each group concatenates its own blocks, and the backward gives each
    shard its slice of its group's summed gradient."""
    comm = Comm(_cpus(4), {"dp": 2, "tp": 2})
    assert comm.groups(("tp",)) == [[0, 1], [2, 3]]
    assert comm.groups(("dp",)) == [[0, 2], [1, 3]]
    xs = [torch.full((2, 3), float(r), requires_grad=True) for r in range(4)]

    def shard(x):
        y = yield ("all_gather", x, 0, ("tp",))
        return y

    outs = run_shards([shard(x) for x in xs], comm)
    assert torch.equal(outs[0], torch.cat([xs[0], xs[1]]).detach())
    assert torch.equal(outs[3], torch.cat([xs[2], xs[3]]).detach())
    weights = [torch.arange(12.0).view(4, 3) * (r + 1) for r in range(4)]
    sum((o * w).sum() for o, w in zip(outs, weights)).backward()
    for r, x in enumerate(xs):
        group = (0, 1) if r < 2 else (2, 3)
        total = weights[group[0]] + weights[group[1]]
        assert torch.equal(x.grad, total[2 * (r % 2): 2 * (r % 2) + 2])
    assert comm.calls == {"nccl": 0, "local": 4}   # 2 forward, 2 backward
