"""Training through the port's ``FFModel`` against the JAX package's, on
the CPU.

Both builders make the same graph (node names, parameter shapes); after
``load_params`` of the reference's weights, ``forward``, ``fit``
(``shuffle=False``, 3 epochs, SGD with momentum and Adam), ``evaluate``,
multi-output losses, frozen parameters and ``recompile`` give the
reference's numbers: histories at ``rtol 1e-5``, parameters at ``rtol
1e-5`` with an ``atol`` of ``1e-6``.  Adam divides each step by the
gradient's running scale, so it carries a gradient's rounding into the
parameter at up to ``alpha`` a step; its parameters are held at an
``atol`` of ``1e-3 * alpha``, and a key bias ``bk`` (whose gradient is
rounding on both sides: the softmax cancels it) at ``alpha``.  Initial weights,
shuffles and dropout masks come from other generators than the
reference's, so parity starts from the reference's weights, unshuffled,
without dropout.  The JAX side runs on one CPU device.
"""

import json

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.models.transformer import \
    build_transformer_classifier as jax_transformer
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as port_transformer

TF = dict(batch=4, seq=6, hidden_dim=16, num_heads=2, ff_dim=32,
          num_layers=2, num_classes=5)
METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _mlp(pkg, batch=4, **kw):
    cfg = pkg.FFConfig(batch_size=batch, **kw)
    m = (pkg.FFModel(cfg) if pkg is J else pkg.FFModel(cfg, device="cpu"))
    x = m.create_tensor((batch, 8))
    h = m.dense(x, 16, activation="relu")
    h = m.dense(h, 16, activation="relu")
    m.softmax(m.dense(h, 4))
    return m


def _transformer(pkg, dropout=0.0, **kw):
    cfg = pkg.FFConfig(batch_size=TF["batch"], **kw)
    if pkg is J:
        return jax_transformer(cfg, dropout=dropout, **TF)
    return port_transformer(cfg, dropout=dropout, device="cpu", **TF)


def _pair(build, **kw):
    return build(J, num_devices=1, **kw), build(T, **kw)


def _data(build, n=16, seed=0):
    rng = np.random.RandomState(seed)
    if build is _mlp:
        return (rng.randn(n, 8).astype(np.float32),
                rng.randint(0, 4, n).astype(np.int32))
    return (rng.randn(n, TF["seq"], TF["hidden_dim"]).astype(np.float32),
            rng.randint(0, TF["num_classes"], n).astype(np.int32))


def _jax_params(m):
    return {n: {p: np.asarray(v) for p, v in g.items()}
            for n, g in m.params.items()}


def _port_params(m):
    return {n: {p: v.detach().cpu().numpy() for p, v in g.items()}
            for n, g in m.params.items()}


def _same_params(tm, jm, adam_alpha=None):
    jp, tp = _jax_params(jm), _port_params(tm)
    assert sorted(jp) == sorted(tp)
    for n in jp:
        assert sorted(jp[n]) == sorted(tp[n])
        for p in jp[n]:
            atol = 1e-6
            if adam_alpha:
                atol = adam_alpha if p == "bk" else 1e-3 * adam_alpha
            np.testing.assert_allclose(tp[n][p], jp[n][p], rtol=1e-5,
                                       atol=atol, err_msg=f"{n}.{p}")


def _same_history(th, jh):
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k] == pytest.approx(j[k], rel=1e-5, abs=1e-7), k


def _compiled(build, opt=("SGDOptimizer", dict(lr=0.05, momentum=0.9)),
              **compile_kw):
    jm, tm = _pair(build)
    cls, kw = opt
    jm.compile(optimizer=getattr(J, cls)(**kw), metrics=METRICS,
               **compile_kw)
    tm.compile(optimizer=getattr(T, cls)(**kw), metrics=METRICS,
               **compile_kw)
    tm.load_params(_jax_params(jm))
    return jm, tm


@pytest.mark.parametrize("build", [_mlp, _transformer],
                         ids=["mlp", "transformer"])
def test_builders_make_the_reference_graph(build):
    jm, tm = _pair(build)
    assert [n.name for n in tm.graph.nodes] == [n.name for n in jm.graph.nodes]
    assert [n.inputs for n in tm.graph.nodes] == \
        [n.inputs for n in jm.graph.nodes]
    jspecs, tspecs = jm.graph.param_specs(), tm.graph.param_specs()
    assert {n: {p: tuple(s.spec.shape) for p, s in g.items()}
            for n, g in tspecs.items()} == \
        {n: {p: tuple(s.spec.shape) for p, s in g.items()}
         for n, g in jspecs.items()}
    assert [tuple(s.shape) for s in tm.graph.tensor_specs] == \
        [tuple(s.shape) for s in jm.graph.tensor_specs]


@pytest.mark.parametrize("build", [_mlp, _transformer],
                         ids=["mlp", "transformer"])
def test_forward_equals_reference_from_its_weights(build):
    jm, tm = _compiled(build)
    x, _ = _data(build, n=TF["batch"])
    tid = jm.graph.input_tids[0]
    jout = jax.jit(jm._forward)(jm.params, {tid: x})[0]   # jm.forward, jitted
    np.testing.assert_allclose(tm.forward(x).numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("opt", [
    ("SGDOptimizer", dict(lr=0.05, momentum=0.9)),
    ("AdamOptimizer", dict(alpha=0.01))], ids=["sgd_momentum", "adam"])
@pytest.mark.parametrize("build", [_mlp, _transformer],
                         ids=["mlp", "transformer"])
def test_fit_histories_and_params_equal_reference(build, opt):
    jm, tm = _compiled(build, opt)
    x, y = _data(build)
    jh = jm.fit(x, y, epochs=3, shuffle=False, verbose=False)
    th = tm.fit(x, y, epochs=3, shuffle=False, verbose=False)
    _same_history(th, jh)
    _same_params(tm, jm, adam_alpha=opt[1].get("alpha"))
    # the loss fell, so the steps did something
    assert th[-1]["loss"] < th[0]["loss"]


def test_multi_output_losses_with_loss_weights():
    ms = []
    for pkg in (J, T):
        m = (pkg.FFModel(pkg.FFConfig(batch_size=4, num_devices=1))
             if pkg is J else pkg.FFModel(pkg.FFConfig(batch_size=4),
                                          device="cpu"))
        x = m.create_tensor((4, 8))
        h = m.dense(x, 12, activation="tanh", name="trunk")
        a = m.softmax(m.dense(h, 3, name="head_a"))
        b = m.dense(h, 2, name="head_b")
        m.compile(optimizer=pkg.SGDOptimizer(lr=0.1), metrics=["accuracy"],
                  outputs=[a, b],
                  loss_type=["sparse_categorical_crossentropy",
                             "mean_squared_error"], loss_weights=[1.0, 0.5])
        ms.append(m)
    jm, tm = ms
    tm.load_params(_jax_params(jm))
    rng = np.random.RandomState(1)
    x = rng.randn(16, 8).astype(np.float32)
    ys = [rng.randint(0, 3, 16).astype(np.int32),
          rng.randn(16, 2).astype(np.float32)]
    _same_history(tm.fit(x, ys, epochs=2, shuffle=False, verbose=False),
                  jm.fit(x, ys, epochs=2, shuffle=False, verbose=False))
    _same_params(tm, jm)
    assert tm.evaluate(x, ys) == pytest.approx(jm.evaluate(x, ys), rel=1e-5)
    with pytest.raises(ValueError, match="loss_weights"):
        T.FFModel(T.FFConfig(), device="cpu").compile(loss_weights=[1.0])


def test_a_frozen_parameter_stays_fixed():
    """A ``ParamSpec(trainable=False)`` takes no update and no optimizer
    state, on both sides (the reference's only frozen parameters are
    BatchNorm's running statistics; here a dense bias is marked so)."""
    jm, tm = _pair(_mlp)
    for pkg, m in ((J, jm), (T, tm)):
        op = m.graph.nodes[1].op
        specs = op.params()
        op.params = lambda specs=specs: [
            type(p)(p.name, p.spec, p.initializer, p.name != "bias")
            for p in specs]
        m.compile(optimizer=pkg.AdamOptimizer(alpha=0.01))
    tm.load_params(_jax_params(jm))
    name = tm.graph.nodes[1].name
    before = tm.params[name]["bias"].detach().clone()
    assert not tm.params[name]["bias"].requires_grad
    assert name not in tm.opt_state["m"] or "bias" not in \
        tm.opt_state["m"][name]
    x, y = _data(_mlp)
    _same_history(tm.fit(x, y, epochs=2, shuffle=False, verbose=False),
                  jm.fit(x, y, epochs=2, shuffle=False, verbose=False))
    assert torch.equal(tm.params[name]["bias"], before)
    _same_params(tm, jm)


def test_evaluate_equals_reference():
    jm, tm = _compiled(_transformer)
    x, y = _data(_transformer, n=12)    # the last partial batch is dropped
    assert tm.evaluate(x, y) == pytest.approx(jm.evaluate(x, y), rel=1e-5)
    assert tm.evaluate(x, y, batch_size=2) == pytest.approx(
        jm.evaluate(x, y, batch_size=2), rel=1e-5)


def test_recompile_keeps_params_and_optimizer_state():
    jm, tm = _compiled(_mlp, ("AdamOptimizer", dict(alpha=0.01)))
    x, y = _data(_mlp)
    _same_history(tm.fit(x, y, epochs=1, shuffle=False, verbose=False),
                  jm.fit(x, y, epochs=1, shuffle=False, verbose=False))
    params = {n: {p: v.detach().clone() for p, v in g.items()}
              for n, g in tm.params.items()}
    m0 = {n: {p: v.clone() for p, v in g.items()}
          for n, g in tm.opt_state["m"].items()}
    for m in (jm, tm):
        m.recompile()
    assert tm.opt_state["t"] == 4
    for n, g in params.items():
        for p, v in g.items():
            assert torch.equal(tm.params[n][p], v)
            assert torch.equal(tm.opt_state["m"][n][p], m0[n][p])
    # training goes on from the same state as the reference's
    _same_history(tm.fit(x, y, epochs=1, shuffle=False, verbose=False),
                  jm.fit(x, y, epochs=1, shuffle=False, verbose=False))
    _same_params(tm, jm)
    # a new optimizer resets the state
    tm.recompile(optimizer=T.AdamOptimizer(alpha=0.02))
    assert tm.opt_state["t"] == 0


def test_strategy_import_and_export(tmp_path):
    """``--export`` writes the resolved strategy as the reference writes
    it; ``--import`` reads it back; an explicit dict comes first; a
    ``sample`` split of the one-device mesh plans and runs as the
    whole."""
    out = tmp_path / "s.json"
    jout = tmp_path / "j.json"
    strategy = {"dense": {"sample": ("dp",)}, "dense_1": {}}
    tm = _mlp(T, export_strategy_file=str(out))
    tm.compile(strategy=strategy)
    jm = _mlp(J, num_devices=1, export_strategy_file=str(jout))
    jm.compile(strategy=strategy)
    assert json.loads(out.read_text()) == json.loads(jout.read_text())
    imp = _mlp(T, import_strategy_file=str(out))
    imp.compile()
    assert imp.strategy == strategy
    assert imp.compile(strategy={}).strategy == {}
    default = _mlp(T, export_strategy_file=str(out))
    default.compile()
    assert json.loads(out.read_text())["ops"] == {}
    imp.load_params(_port_params(default))
    x, _ = _data(_mlp, n=4)
    assert torch.equal(imp.forward(x), default.forward(x))


def test_compile_and_construction_raise_instead_of_falling_back(
        monkeypatch):
    # pipeline and ring meshes compile (tests/test_torch_pipeline.py,
    # tests/test_torch_ring_attention.py); what the reference refuses on
    # them still raises: the sequence split with attention dropout, and a
    # list of losses under a pipeline
    sp = T.FFModel(T.FFConfig(batch_size=2),
                   mesh=T.make_mesh({"sp": 2}, ["cpu", "cpu"]))
    x = sp.create_tensor((2, 4, 8))
    sp.multihead_attention(x, x, x, 8, 2, dropout=0.1, name="mha")
    with pytest.raises(ValueError, match="attention dropout"):
        sp.compile(strategy={"mha": {"sequence": ("sp",)}},
                   loss_type="mean_squared_error")
    pp = T.FFModel(T.FFConfig(batch_size=16, pipeline="force"),
                   mesh=T.make_mesh({"pp": 2}, ["cpu", "cpu"]))
    h = pp.create_tensor((16, 32))
    for i in range(4):
        h = pp.dense(h, 32, activation="relu", name=f"blk{i}")
    pp.softmax(pp.dense(h, 4, name="head"))
    with pytest.raises(ValueError, match="multi-output"):
        pp.compile(loss_type=["sparse_categorical_crossentropy"])
    # a data-parallel-only config skips the search, as the reference does
    _mlp(T, search_budget=10, only_data_parallel=True).compile()
    # a config the executor cannot run raises, naming its node
    two = T.make_mesh({"tp": 2}, ["cpu", "cpu"])
    m = T.FFModel(T.FFConfig(), mesh=two)
    m.softmax(m.create_tensor((2, 3)))
    with pytest.raises(NotImplementedError, match="'softmax'"):
        m.compile(strategy={"softmax": {"channel_out": ("tp",)}})
    # an axis outside the port's meshes raises
    with pytest.raises(ValueError, match="training"):
        T.make_mesh({"xp": 2}, ["cpu", "cpu"])
    # the serve builder methods record their nodes; outside a serve
    # manager their ops raise, as the reference's lowering does
    m = T.FFModel(T.FFConfig(batch_size=4), device="cpu")
    x = m.position_embedding(m.create_tensor((4, 8)), 8, 2)
    m.inc_multihead_self_attention(x, 8, 2)
    assert [n.op.type_name for n in m.graph.nodes] == [
        "position_embedding", "inc_multihead_self_attention"]
    m.compile(loss_type="identity")
    with pytest.raises(ValueError, match="position_embedding requires"):
        m.forward(np.zeros((4, 8), np.float32))
    with pytest.raises(RuntimeError, match="compile"):
        _mlp(T).load_params({})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.FFModel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.FFConfig().devices()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_mesh({"dp": 1})


def test_two_fits_from_one_seed_are_identical():
    """Initial weights, shuffles and dropout masks come from the model's
    generator, seeded by ``FFConfig.seed``."""
    x, y = _data(_transformer)

    def run(seed):
        m = _transformer(T, dropout=0.2, seed=seed)
        m.compile(optimizer=T.AdamOptimizer(alpha=0.01))
        init = _port_params(m)
        m.fit(x, y, epochs=2, verbose=False)
        return init, _port_params(m)

    (i1, p1), (i2, p2), (i3, _) = run(3), run(3), run(4)
    for n in p1:
        for p in p1[n]:
            np.testing.assert_array_equal(i1[n][p], i2[n][p])
            np.testing.assert_array_equal(p1[n][p], p2[n][p])
    assert any(not np.array_equal(i1[n][p], i3[n][p])
               for n in i1 for p in i1[n])


def test_profiling_and_the_run_log(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FLEXFLOW_TPU_RUN_LOG", str(tmp_path / "runs.jsonl"))
    m = _mlp(T, profiling=True)
    m.compile()
    x, y = _data(_mlp)
    m.fit(x, y, epochs=1, verbose=False)
    traces = list((tmp_path / "artifacts" / "profile").glob("*/trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    rec = json.loads((tmp_path / "runs.jsonl").read_text())
    assert rec["kind"] == "fit" and rec["mesh"] == {"dp": 1}
    assert rec["epochs"] == 1 and rec["ops"] == 4


def test_mnist_example_trains_on_cpu(capsys):
    from flexflow_tpu_torch.examples import mnist_mlp

    final = mnist_mlp.main(["--device", "cpu", "-e", "1"])
    assert final["accuracy"] >= 0.99
    out = capsys.readouterr().out
    assert "dataset: synthetic, 8192 samples" in out
    assert "epoch 1/1: loss=" in out
