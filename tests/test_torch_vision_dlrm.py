"""The port's vision zoo and DLRM against the JAX package's, on the CPU.

The builders of ``models/vision.py`` and ``models/dlrm.py`` make the
reference's graphs: node names (dots included), parameter names and
shapes, op signatures, and the DLRM strategy dict.  From the reference's
weights (``load_params``) and the same batches (``shuffle=False``):

* ResNet-18 at the builders' default image ``(3, 64, 64)``, batch 4, 5
  classes, on one device and on ``{"dp": 2}`` (two CPU shards,
  BatchNorm's statistics all-reduced): ``forward`` and two SGD steps
  against the reference on its 2-device CPU mesh (as
  ``tests/test_models.py:192-209``), then ``evaluate``.  Not at ``(3, 32,
  32)``: there layer4's norms see 4 values a channel (batch 4 at 1x1),
  each multiplies float32 rounding about tenfold, and the reference's own
  one-device and 2-device runs part by 7.5e-5 in the second step's loss;
  at 64 (2x2) they part by 4.7e-6;
* AlexNet and the compact Inception at ``(3, 32, 32)`` on one device:
  ``forward`` and one step;
* DLRM at ``tests/test_models.py:146-186``'s shapes on ``{"dp": 2, "mp":
  2}`` and ``{"mp": 4}`` (``entry``-sharded tables, their partial
  lookups all-reduced): ``forward`` and three epochs of
  ``binary_crossentropy`` under SGD;
* training-mode ``simulate`` and ``plan_memory_parts`` of the ResNet-18
  and DLRM plans equal the reference's at ``rel=1e-9`` under the port's
  ``h100`` spec.

Outputs at ``atol 1e-5``, losses at ``rtol 1e-5``, parameters at ``rtol
1e-4`` (``atol 1e-6``), float32.
"""

import jax
import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.pcg import PCG as JPCG
from flexflow_tpu.models import dlrm as jdlrm
from flexflow_tpu.models import vision as jvision
from flexflow_tpu.search import simulator as JSIM
from flexflow_tpu_torch.core.pcg import PCG
from flexflow_tpu_torch.models import dlrm as tdlrm
from flexflow_tpu_torch.models import vision as tvision
from flexflow_tpu_torch.parallel.mesh import data_parallel_strategy
from flexflow_tpu_torch.search import simulator as PSIM

from test_torch_train_search import close, machines

VISION = dict(batch=4, num_classes=5, image=(3, 32, 32))
RESNET_IMAGE = (3, 64, 64)
DLRM = dict(batch=16, dense_dim=8, table_sizes=(64, 64), embed_dim=16,
            bottom_mlp=(32, 16), top_mlp=(32, 1))
BUILDERS = {"alexnet": "build_alexnet", "resnet18": "build_resnet18",
            "inception": "build_inception"}


def _weights(m):
    return {n: {p: np.asarray(v) for p, v in g.items()}
            for n, g in m.params.items()}


def _jmesh(shape):
    n = int(np.prod(list(shape.values())))
    return J.make_mesh(shape, jax.devices()[:n])


def _tmesh(shape):
    n = int(np.prod(list(shape.values())))
    return T.make_mesh(shape, ["cpu"] * n)


def _vision(pkg, name, shape):
    mod = jvision if pkg is J else tvision
    mesh = _jmesh(shape) if pkg is J else _tmesh(shape)
    kw = dict(VISION, image=RESNET_IMAGE) if name == "resnet18" else VISION
    return getattr(mod, BUILDERS[name])(mesh=mesh, **kw)


def _dlrm(pkg, shape):
    mod = jdlrm if pkg is J else tdlrm
    mesh = _jmesh(shape) if pkg is J else _tmesh(shape)
    return mod.build_dlrm(mesh=mesh, mp_axes=("mp",),
                          dp_axes=("dp",) if "dp" in shape else (), **DLRM)


def _same_params(tm, jm):
    jp = _weights(jm)
    assert sorted(tm.params) == sorted(jp)
    for n, g in jp.items():
        assert sorted(tm.params[n]) == sorted(g)
        for p, v in g.items():
            np.testing.assert_allclose(tm.params[n][p].detach().numpy(), v,
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{n}.{p}")


def _same_history(th, jh):
    assert len(th) == len(jh)
    for a, b in zip(th, jh):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)


@pytest.mark.parametrize("name", sorted(BUILDERS) + ["dlrm"])
def test_builders_make_the_reference_graphs(name):
    if name == "dlrm":
        jm, *_, jstrat = _dlrm(J, {"dp": 2, "mp": 2})
        tm, *_, tstrat = _dlrm(T, {"dp": 2, "mp": 2})
        assert tstrat == jstrat
    else:
        jm = _vision(J, name, {"dp": 1})[0]
        tm = _vision(T, name, {"dp": 1})[0]
    assert [n.name for n in tm.graph.nodes] == [n.name for n in jm.graph.nodes]
    assert name == "alexnet" or any("." in n.name for n in tm.graph.nodes)
    jspecs, tspecs = jm.graph.param_specs(), tm.graph.param_specs()
    assert sorted(tspecs) == sorted(jspecs)
    for n in jspecs:
        assert {p: (tuple(s.spec.shape), s.trainable)
                for p, s in tspecs[n].items()} == \
            {p: (tuple(s.spec.shape), s.trainable)
             for p, s in jspecs[n].items()}
    for jn, tn in zip(jm.graph.nodes, tm.graph.nodes):
        assert tn.op.attr_signature() == jn.op.attr_signature(), tn.name
        assert ([tuple(tm.graph.spec(t).shape) for t in tn.outputs]
                == [tuple(jm.graph.spec(t).shape) for t in jn.outputs])


@pytest.fixture(scope="module")
def resnet_reference():
    """The reference's ResNet-18 on its 2-device CPU mesh: its weights,
    a batch's forward, two SGD steps' history and parameters, and an
    evaluation afterwards."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, *RESNET_IMAGE).astype(np.float32)
    y = rng.randint(0, VISION["num_classes"], 4).astype(np.int32)
    jm, _, out = _vision(J, "resnet18", {"dp": 2})
    jm.compile(optimizer=J.SGDOptimizer(lr=0.001, momentum=0.9),
               outputs=[out])
    init = _weights(jm)
    logits = np.asarray(jm.forward(x))
    hist = jm.fit(x, y, epochs=2, batch_size=4, shuffle=False,
                  verbose=False)
    return dict(x=x, y=y, init=init, logits=logits, hist=hist, model=jm,
                evaluate=jm.evaluate(x, y, batch_size=4)["loss"])


@pytest.mark.parametrize("shape", [{"dp": 1}, {"dp": 2}],
                         ids=["one_device", "dp2"])
def test_resnet18_trains_as_the_reference(resnet_reference, shape):
    ref = resnet_reference
    tm, _, out = _vision(T, "resnet18", shape)
    tm.compile(optimizer=T.SGDOptimizer(lr=0.001, momentum=0.9),
               outputs=[out])
    tm.load_params(ref["init"])
    logits = tm.forward(ref["x"]).numpy()
    np.testing.assert_allclose(logits, ref["logits"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(logits.sum(-1), 1.0, atol=1e-5)
    hist = tm.fit(ref["x"], ref["y"], epochs=2, batch_size=4,
                  shuffle=False, verbose=False)
    _same_history(hist, ref["hist"])
    _same_params(tm, ref["model"])
    assert tm.evaluate(ref["x"], ref["y"], batch_size=4)["loss"] == \
        pytest.approx(ref["evaluate"], rel=1e-5)


@pytest.mark.parametrize("name", ["alexnet", "inception"])
def test_vision_model_trains_as_the_reference(name):
    rng = np.random.RandomState(8)
    x = rng.randn(4, *VISION["image"]).astype(np.float32)
    y = rng.randint(0, VISION["num_classes"], 4).astype(np.int32)
    jm, _, jout = _vision(J, name, {"dp": 1})
    tm, _, tout = _vision(T, name, {"dp": 1})
    jm.compile(optimizer=J.SGDOptimizer(lr=0.01), outputs=[jout])
    tm.compile(optimizer=T.SGDOptimizer(lr=0.01), outputs=[tout])
    tm.load_params(_weights(jm))
    np.testing.assert_allclose(tm.forward(x).numpy(),
                               np.asarray(jm.forward(x)), rtol=0, atol=1e-5)
    _same_history(tm.fit(x, y, epochs=1, batch_size=4, verbose=False),
                  jm.fit(x, y, epochs=1, batch_size=4, verbose=False))
    _same_params(tm, jm)


@pytest.mark.parametrize("shape", [{"dp": 2, "mp": 2}, {"mp": 4}],
                         ids=["dp2_mp2", "mp4"])
def test_dlrm_trains_as_the_reference(shape):
    rng = np.random.RandomState(3)
    n = 64
    xd = rng.randn(n, DLRM["dense_dim"]).astype(np.float32)
    xs = [rng.randint(0, 64, size=(n, 1)).astype(np.int32)
          for _ in DLRM["table_sizes"]]
    y = rng.randint(0, 2, size=(n, 1)).astype(np.float32)
    runs, init = [], None
    for pkg in (J, T):
        m, dense, sparse, out, strategy = _dlrm(pkg, shape)
        m.compile(optimizer=pkg.SGDOptimizer(lr=0.05), outputs=[out],
                  strategy=strategy, loss_type="binary_crossentropy")
        if init is None:
            init = _weights(m)
        else:
            m.load_params(init)
        inputs = {dense: xd, **dict(zip(sparse, xs))}
        first = {t: v[:DLRM["batch"]] for t, v in inputs.items()}
        runs.append((m, np.asarray(m.forward(first)),
                     m.fit(inputs, y, epochs=3, batch_size=DLRM["batch"],
                           shuffle=False, verbose=False)))
    (jm, jf, jh), (tm, tf, th) = runs
    kinds = [s.node.op.type_name for s in tm.plan.steps]
    assert kinds == [s.node.op.type_name for s in jm.plan.steps]
    assert "allreduce" in kinds
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-5)
    _same_history(th, jh)
    _same_params(tm, jm)


def _priced(name):
    """Both packages' models of ``name`` on a ``{"dp": 2}`` (ResNet-18,
    data parallel) or ``{"dp": 2, "mp": 2}`` (DLRM, its own dict)
    mesh, and the strategy."""
    if name == "resnet18":
        jm, pm = (_vision(pkg, name, {"dp": 2})[0] for pkg in (J, T))
        return jm, pm, data_parallel_strategy(pm.graph, pm.mesh)
    (jm, *_), (pm, *_, strategy) = (_dlrm(pkg, {"dp": 2, "mp": 2})
                                    for pkg in (J, T))
    return jm, pm, strategy


@pytest.mark.parametrize("name", ["resnet18", "dlrm"])
def test_training_prices_equal_reference(name):
    jm, pm, strategy = _priced(name)
    jmm, pmm = machines("h100", jm.mesh, pm.mesh)
    jp = JPCG(jm.graph, jm.mesh, strategy).plan()
    pp = PCG(pm.graph, pm.mesh, strategy).plan()
    for training in (True, False):
        jc = JSIM.simulate(jp, jmm, training=training)
        pc = PSIM.simulate(pp, pmm, training=training)
        for f in ("total", "compute", "comm", "grad_comm"):
            assert close(getattr(pc, f), getattr(jc, f)), (training, f)
        jparts = JSIM.plan_memory_parts(jp, training=training)
        pparts = PSIM.plan_memory_parts(pp, training=training)
        assert pparts.keys() == jparts.keys()
        for k in jparts:
            assert close(pparts[k], jparts[k]), (training, k)
    assert PSIM.simulate(pp, pmm).grad_comm > 0
