"""``FFModel.recompile`` on a mesh: the reference's ``tests/test_recompile.py``
on ``dp2 x tp2`` over ``["cpu"] * 4``, and the parameters and optimizer
state moving between layouts (whole, then re-sliced) with training going
on as the JAX package's does."""

import jax
import numpy as np
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu_torch.parallel.mesh import data_parallel_strategy

from test_torch_train import _jax_params, _same_history, _same_params

TP = {"l1": {"sample": ("dp",), "channel_out": ("tp",)},
      "l2": {"sample": ("dp",), "channel_in": ("tp",)}}


def _build(pkg, mesh, optimizer):
    model = pkg.FFModel(pkg.FFConfig(batch_size=8, learning_rate=0.1),
                        mesh=mesh)
    x = model.create_tensor((8, 16))
    h = model.dense(x, 32, activation="relu", name="l1")
    model.softmax(model.dense(h, 4, name="l2"))
    model.compile(optimizer=optimizer,
                  strategy=data_parallel_strategy(model.graph, mesh))
    return model


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(32, 16).astype(np.float32),
            rng.randint(0, 4, size=32).astype(np.int32))


def test_recompile_keeps_params_and_outputs():
    mesh = T.make_mesh({"dp": 2, "tp": 2}, ["cpu"] * 4)
    model = _build(T, mesh, T.SGDOptimizer(lr=0.1))
    X, y = _data()
    model.fit(X, y, epochs=2, batch_size=8, verbose=0)
    before = model.forward(X[:8])

    # adopt a tensor-parallel strategy: the same graph, new shardings
    model.recompile(strategy=TP)
    assert [tuple(s["l1"]["kernel"].shape) for s in model.shard_params] \
        == [(16, 16)] * 4
    after = model.forward(X[:8])
    np.testing.assert_allclose(before.numpy(), after.numpy(), atol=1e-5,
                               rtol=1e-5)
    # training goes on from the same state under the new plan
    hist = model.fit(X, y, epochs=2, batch_size=8, verbose=0)
    assert np.isfinite(hist[-1]["loss"])


def test_recompile_moves_adam_state_and_trains_as_the_reference():
    """Adam's slots and step move whole from the data-parallel layout to
    the tensor-parallel one; fit before and after equals the JAX
    package's over the same recompile."""
    X, y = _data()
    jm = _build(J, J.make_mesh({"dp": 2, "tp": 2}, jax.devices()[:4]),
                J.AdamOptimizer(alpha=0.01))
    tm = _build(T, T.make_mesh({"dp": 2, "tp": 2}, ["cpu"] * 4),
                T.AdamOptimizer(alpha=0.01))
    tm.load_params(_jax_params(jm))
    _same_history(tm.fit(X, y, epochs=1, shuffle=False, verbose=False),
                  jm.fit(X, y, epochs=1, shuffle=False, verbose=False))
    params = {n: {p: v.clone() for p, v in g.items()}
              for n, g in tm.params.items()}
    slots = {k: {n: {p: v.clone() for p, v in g.items()}
                 for n, g in tm.opt_state[k].items()} for k in ("m", "v")}
    for m in (jm, tm):
        m.recompile(strategy=TP)
    assert [s["t"] for s in tm.shard_opt_states] == [4] * 4
    for n, g in params.items():
        for p, v in g.items():
            assert torch.equal(tm.params[n][p], v)
            for k in ("m", "v"):
                assert torch.equal(tm.opt_state[k][n][p], slots[k][n][p])
    _same_history(tm.fit(X, y, epochs=2, shuffle=False, verbose=False),
                  jm.fit(X, y, epochs=2, shuffle=False, verbose=False))
    _same_params(tm, jm, 0.01)
    # a new optimizer resets the state on every shard
    tm.recompile(optimizer=T.AdamOptimizer(alpha=0.02))
    assert [s["t"] for s in tm.shard_opt_states] == [0] * 4


def test_the_default_mesh_is_dp_over_every_device(monkeypatch):
    """With no mesh and no ``mesh_shape``, ``FFModel`` trains on ``{"dp":
    n}`` over ``FFConfig.devices()`` (here four stand-in devices), as the
    reference's ``make_mesh(None, devices)``; ``--mesh`` picks another
    shape over them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(T.FFConfig, "devices", lambda self: ["cpu"] * 4)
    X, y = _data()
    for argv, shape in (([], {"dp": 4}), (["--mesh", "dp=2,tp=2"],
                                          {"dp": 2, "tp": 2})):
        cfg = T.FFConfig.parse_args(["-b", "8"] + argv)
        model = T.FFModel(cfg)
        x = model.create_tensor((8, 16))
        model.softmax(model.dense(x, 4))
        model.compile(optimizer=T.SGDOptimizer(lr=0.1))
        assert model.mesh.shape == shape and model.mesh.size == 4
        assert np.isfinite(model.fit(X, y, epochs=1, verbose=False)[0]
                           ["loss"])
