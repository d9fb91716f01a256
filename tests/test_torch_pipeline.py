"""The GPipe executor and the compile path's pipeline of the port against
the JAX package's, on the CPU.

* ``parallel/pipeline.py:pipeline_apply`` on ``pp=4``, 8 microbatches,
  against the reference's under ``shard_map`` at ``1e-5``;
* ``pipeline_train_step`` on ``pp=2 x dp=4``: the loss at ``rtol
  1e-5``, the gradients at ``atol 1e-5, rtol 1e-4``, and its shift
  count; ``graph_pipeline_train_step`` with a prefix and a suffix: loss,
  logits and every gradient at the same tolerances;
* ``FFModel.compile`` with ``pipeline="force"`` on ``{"pp": 2, "dp":
  4}`` for the chain MLP and the residual Transformer classifier (hidden
  32, 2 layers): the carve (``_pp_meta``), the ``_pp_core`` arrays, two
  epochs' losses and ``evaluate`` against the reference's pipelined
  model (losses ``rtol 1e-5``, parameters ``rtol 1e-5, atol 1e-6``,
  tighter than the reference's own pp-against-dp ``rtol 1e-3``: the two
  run one schedule); a seed draws the unpipelined model's weights;
* ``pipeline="auto"`` chooses the reference's kind; a graph the executor
  cannot drive warns and falls back; a list of losses raises;
* the pipeline layout round-trips ``load_params``, ``opt_state`` and
  ``training/checkpoint.py``; a stage's shards hold only its core.

Inputs come from numpy seeds; weights cross by ``load_params``.  Mesh
devices are ``["cpu"] * 8`` (the JAX side: its 8 virtual devices).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.compat import shard_map
from flexflow_tpu.models.transformer import \
    build_transformer_classifier as jax_transformer
from flexflow_tpu.parallel import pipeline as JP
from flexflow_tpu.utils.platform import collective_safe_compiler_options
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as port_transformer
from flexflow_tpu_torch.parallel import pipeline as TP
from flexflow_tpu_torch.parallel.comm import run_shards
from flexflow_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)

from test_torch_train import _jax_params, _port_params


def _mesh(pkg, shape):
    n = int(np.prod(list(shape.values())))
    if pkg is J:
        return J.make_mesh(shape, jax.devices()[:n])
    return T.make_mesh(shape, ["cpu"] * n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def port_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def test_pipeline_apply_matches_reference():
    rng = np.random.default_rng(2)
    k, n_micro, mb, dim = 4, 8, 4, 16
    w = (rng.normal(size=(k, dim, dim)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(k, dim)) * 0.1).astype(np.float32)
    x = rng.normal(size=(n_micro, mb, dim)).astype(np.float32)
    jmesh = _mesh(J, {"pp": k})
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want = jax.jit(shard_map(
        lambda p, x: JP.pipeline_apply(jax_stage, p, x, "pp", k),
        mesh=jmesh, in_specs=(jax.tree.map(lambda _: P("pp"), params), P()),
        out_specs=P()),
        compiler_options=collective_safe_compiler_options(jmesh))(params, x)
    mesh = _mesh(T, {"pp": k})
    gens = [TP.pipeline_apply(port_stage,
                              {"w": _t(w[s:s + 1]), "b": _t(b[s:s + 1])},
                              _t(x), "pp", k) for s in range(k)]
    calls = mesh.comm.calls["local"]
    outs = run_shards(gens, mesh.comm)
    for o in outs:   # broadcast: every stage holds the last stage's
        np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    # n_micro + k - 2 shifts, then the broadcast's all-reduce
    assert mesh.comm.calls["local"] - calls == n_micro + k - 2 + 1


def _mse(y, lab):
    return ((y - lab) ** 2).mean()


def test_pipeline_train_step_matches_reference():
    rng = np.random.default_rng(3)
    k, n_micro, mb, dim = 2, 4, 8, 8
    w = (rng.normal(size=(k, dim, dim)) * 0.3).astype(np.float32)
    b = np.zeros((k, dim), np.float32)
    x = rng.normal(size=(n_micro, mb, dim)).astype(np.float32)
    lab = rng.normal(size=(n_micro, mb, dim)).astype(np.float32)
    jmesh = _mesh(J, {"pp": k, "dp": 4})
    jstep = JP.pipeline_train_step(jax_stage, lambda y, l: jnp.mean(
        (y - l) ** 2), jmesh, "pp", dp_axis="dp")
    jloss, jgrads = jax.jit(jstep, compiler_options=(
        collective_safe_compiler_options(jmesh)))(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, x, lab)
    mesh = _mesh(T, {"pp": k, "dp": 4})
    applied = []

    def counted_stage(p, x):
        applied.append(1)
        return port_stage(p, x)

    step = TP.pipeline_train_step(counted_stage, _mse, mesh, "pp",
                                  dp_axis="dp")
    calls = mesh.comm.calls["local"]
    loss, grads = step({"w": _t(w), "b": _t(b)}, _t(x), _t(lab))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for p in ("w", "b"):
        np.testing.assert_allclose(grads[p].numpy(), np.asarray(jgrads[p]),
                                   atol=1e-5, rtol=1e-4, err_msg=p)
    # 4 pp rings: (n_micro + k - 2) shifts forward and backward each, and
    # the core's gradient mean over dp in each of the 2 stage rows
    assert mesh.comm.calls["local"] - calls == \
        2 * (n_micro + k - 2) * 4 + 2
    # a stage applies stage_fn once a microbatch: no bubble work
    assert len(applied) == n_micro * mesh.size


def test_graph_pipeline_train_step_with_prefix_and_suffix():
    rng = np.random.default_rng(4)
    k, n_micro, mb, raw, dim, out = 2, 4, 8, 6, 8, 3
    arrs = dict(
        w=(rng.normal(size=(k, dim, dim)) * 0.3).astype(np.float32),
        b=(rng.normal(size=(k, dim)) * 0.1).astype(np.float32),
        wp=(rng.normal(size=(raw, dim)) * 0.4).astype(np.float32),
        ws=(rng.normal(size=(dim, out)) * 0.4).astype(np.float32))
    x = rng.normal(size=(n_micro, mb, raw)).astype(np.float32)
    lab = rng.normal(size=(n_micro, mb, out)).astype(np.float32)

    def params3(conv):
        return ({"w": conv(arrs["w"]), "b": conv(arrs["b"])},
                [{"wp": conv(arrs["wp"])}], [{"ws": conv(arrs["ws"])}])

    jmesh = _mesh(J, {"pp": k, "dp": 2})
    jstep = JP.graph_pipeline_train_step(
        jax_stage, lambda y, l: jnp.mean((y - l) ** 2), jmesh, "pp",
        dp_axis="dp", prefix_fn=lambda p, r: jnp.tanh(r @ p[0]["wp"]),
        suffix_fn=lambda p, y: y @ p[0]["ws"], act_shape=(mb // 2, dim),
        act_dtype=jnp.float32)
    jloss, jlogits, jg = jax.jit(jstep, compiler_options=(
        collective_safe_compiler_options(jmesh)))(params3(jnp.asarray), x,
                                                  lab)
    mesh = _mesh(T, {"pp": k, "dp": 2})
    step = TP.graph_pipeline_train_step(
        port_stage, _mse, mesh, "pp", dp_axis="dp",
        prefix_fn=lambda p, r: torch.tanh(r @ p[0]["wp"]),
        suffix_fn=lambda p, y: y @ p[0]["ws"], act_shape=(mb // 2, dim),
        act_dtype=torch.float32)
    loss, logits, g = step(params3(_t), _t(x), _t(lab))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    for got, want in ((g[0]["w"], jg[0]["w"]), (g[0]["b"], jg[0]["b"]),
                      (g[1][0]["wp"], jg[1][0]["wp"]),
                      (g[2][0]["ws"], jg[2][0]["ws"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-4)


def chain_mlp(pkg, mesh, cfg, n_layers=4, width=32, batch=16):
    """``tests/test_pipeline_compile.py:chain_mlp``."""
    model = pkg.FFModel(cfg, mesh=mesh)
    x = model.create_tensor((batch, width))
    h = x
    for i in range(n_layers):
        h = model.dense(h, width, activation="relu", name=f"blk{i}")
    model.softmax(model.dense(h, 8, name="head"))
    return model


ARCH = dict(batch=16, seq=8, num_layers=2, hidden_dim=32, num_heads=4,
            ff_dim=64, num_classes=4)


def _classifier(pkg, mesh, cfg):
    build = jax_transformer if pkg is J else port_transformer
    return build(config=cfg, mesh=mesh, **ARCH)


def _data(kind, seed=0, n=32):
    rng = np.random.RandomState(seed)
    if kind == "mlp":
        return (rng.randn(n, 32).astype(np.float32),
                rng.randint(0, 8, size=n).astype(np.int32))
    return (rng.randn(n, ARCH["seq"], ARCH["hidden_dim"]).astype(np.float32),
            rng.randint(0, ARCH["num_classes"], size=n).astype(np.int32))


def _build(pkg, kind, shape=None, **cfg_kw):
    shape = shape or {"pp": 2, "dp": 4}
    cfg = pkg.FFConfig(batch_size=16, seed=3, **cfg_kw)
    if kind == "mlp":
        return chain_mlp(pkg, _mesh(pkg, shape), cfg)
    return _classifier(pkg, _mesh(pkg, shape), cfg)


def _pipelined(pkg, kind, **kw):
    m = _build(pkg, kind, pipeline="force", pipeline_microbatches=4, **kw)
    m.compile(optimizer=pkg.SGDOptimizer(lr=0.05, momentum=0.9),
              metrics=["accuracy"])
    return m


@pytest.mark.parametrize("kind,carve", [
    ("mlp", (0, 2, 2)), ("classifier", (0, 7, 3))])
def test_compile_pipeline_matches_reference(kind, carve):
    jm, tm = _pipelined(J, kind), _pipelined(T, kind)
    assert tm._pipeline_ctx is not None and jm._pipeline_ctx is not None
    assert tm._pp_meta == jm._pp_meta
    assert (len(tm._pp_meta["prefix"]), len(tm._pp_meta["core_names"][0]),
            len(tm._pp_meta["suffix"])) == carve
    assert {k: tuple(v.shape) for k, v in tm.params["_pp_core"].items()} \
        == {k: v.shape for k, v in jm.params["_pp_core"].items()}
    tm.load_params(_jax_params(jm))
    x, y = _data(kind)
    jh = jm.fit(x, y, epochs=2, batch_size=16, verbose=False,
                shuffle=False)
    th = tm.fit(x, y, epochs=2, batch_size=16, verbose=False,
                shuffle=False)
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=1e-7)
    # the reference's step leaves an empty group for each parameter-free
    # prefix and suffix node (its from3); the port keeps none
    jp = {n: g for n, g in _jax_params(jm).items() if g}
    tp = _port_params(tm)
    assert sorted(jp) == sorted(tp)
    for n in jp:
        for p in jp[n]:
            np.testing.assert_allclose(tp[n][p], jp[n][p], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{n}.{p}")
    je, te = jm.evaluate(x, y, batch_size=16), tm.evaluate(x, y,
                                                           batch_size=16)
    assert te["loss"] == pytest.approx(je["loss"], rel=1e-5)
    np.testing.assert_allclose(tm.forward(x[:16]).numpy(),
                               np.asarray(jm.forward(x[:16])), rtol=1e-5,
                               atol=1e-6)


def test_seeded_pipeline_draw_is_the_unpipelined_one():
    one = _build(T, "classifier", {"dp": 1})
    one.compile()
    pm = _pipelined(T, "classifier", shape={"pp": 2, "dp": 2})
    pos = pm._pipeline.core_pos
    for n, g in one.params.items():
        for p, v in g.items():
            got = (pm.params["_pp_core"][f"{pos[n][1]}.{p}"][pos[n][0]]
                   if n in pos else pm.params[n][p])
            assert torch.equal(got, v), f"{n}.{p}"
    # a stage's shards hold only their stage's core, and every shard the
    # suffix
    for r, shard in enumerate(pm.shard_params):
        assert {k: tuple(v.shape)[0] for k, v in shard["_pp_core"].items()
                } == dict.fromkeys(pm.params["_pp_core"], 1)
        assert {"head"} <= set(shard)
        assert not set(shard) & set(pos)
    # a core node's own name loads into its stage
    pm.load_params({"enc1_ff2": {"kernel": np.ones((64, 32), np.float32)}})
    assert torch.equal(pm.params["_pp_core"]["4.kernel"][1],
                       torch.ones(64, 32))


def test_pipeline_layout_round_trips_the_checkpoint(tmp_path):
    x, y = _data("classifier")
    a = _pipelined(T, "classifier")
    a.fit(x, y, epochs=1, batch_size=16, verbose=False, shuffle=False)
    save_checkpoint(str(tmp_path), a, step=2)
    b = _pipelined(T, "classifier", shape={"pp": 2, "dp": 4})
    assert restore_checkpoint(str(tmp_path), b) == 2
    for n, g in a.params.items():
        for p, v in g.items():
            assert torch.equal(b.params[n][p], v), f"{n}.{p}"
    for n, g in a.opt_state.items():
        for p, v in g.items():
            assert torch.equal(b.opt_state[n][p], v), f"{n}.{p}"
    ha = a.fit(x, y, epochs=1, batch_size=16, verbose=False, shuffle=False)
    hb = b.fit(x, y, epochs=1, batch_size=16, verbose=False, shuffle=False)
    assert ha == hb


def test_pipeline_auto_chooses_the_reference_kind():
    jm = _build(J, "mlp", pipeline="auto", pipeline_microbatches=4)
    tm = _build(T, "mlp", pipeline="auto", pipeline_microbatches=4)
    jm.compile(optimizer=J.SGDOptimizer(lr=0.05))
    tm.compile(optimizer=T.SGDOptimizer(lr=0.05))
    assert (tm._pipeline_ctx is None) == (jm._pipeline_ctx is None)
    assert tm.strategy == jm.strategy
    kind = tm.pipeline_choice["kind"]
    costs = tm.pipeline_choice["costs"]
    assert kind == min(costs, key=costs.get)
    x, y = _data("mlp", n=16)
    assert np.isfinite(tm.fit(x, y, epochs=1, verbose=False)[-1]["loss"])


def test_nonchain_graph_warns_and_falls_back():
    m = T.FFModel(T.FFConfig(batch_size=16, pipeline="force", seed=1),
                  mesh=_mesh(T, {"pp": 2, "dp": 4}))
    a = m.create_tensor((16, 16))
    b = m.create_tensor((16, 16))
    h = m.dense(m.add(a, b), 16, activation="relu", name="d0")
    m.softmax(m.dense(h, 4, name="head"))
    with pytest.warns(UserWarning, match="falling back to GSPMD"):
        m.compile(optimizer=T.SGDOptimizer(lr=0.05))
    assert m._pipeline_ctx is None
    rng = np.random.RandomState(2)
    x = [rng.randn(16, 16).astype(np.float32) for _ in range(2)]
    y = rng.randint(0, 4, size=16).astype(np.int32)
    assert np.isfinite(m.fit(x, y, epochs=1, verbose=False)[-1]["loss"])


def test_list_of_losses_raises_under_a_pipeline():
    m = _build(T, "mlp", pipeline="force", pipeline_microbatches=4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="multi-output"):
            m.compile(loss_type=["sparse_categorical_crossentropy"])
