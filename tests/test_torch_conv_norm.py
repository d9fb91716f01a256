"""The port's Conv2D, Pool2D, BatchNorm and AddBiasResidualLayerNorm
against the JAX package's, on the CPU.

Each op through both builders on the same inputs, parameters and
cotangents (``test_torch_shape_ops.run_case``: forward at ``atol 1e-5``,
gradients at ``rtol 1e-4``, ``atol 1e-5``, float32), with its
``attr_signature()`` the reference's.  The cases cover every padding
form: XLA's asymmetric ``"SAME"`` (a 3x3 stride-2 window on an even
input pads (0, 1), ResNet's 7x7 stride-2 stem (2, 3), AlexNet's 11x11
stride-4 conv (3, 4)), ``"VALID"``, an int and explicit pairs; grouped
convs; max pools padded with ``-inf`` and average pools that divide by
the window; BatchNorm in training (the batch's statistics, the
population variance) and outside it (the running statistics).  On a
``{"dp": 2}`` mesh BatchNorm normalises with the global batch's
statistics, as the reference's GSPMD program does, in both of the
port's modes.
"""

import jax
import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu_torch.ops.conv import spatial_pads

from test_torch_shape_ops import run_case

# id -> (input shapes, build(model, tensors), training)
CASES = {
    "conv_same_s1": ([(2, 3, 7, 7)], lambda m, t:
                     m.conv2d(t[0], 4), False),
    "conv_same_s2_even": ([(2, 3, 8, 8)], lambda m, t:
                          m.conv2d(t[0], 4, stride=(2, 2)), False),
    "conv_stem_7x7_s2": ([(1, 3, 10, 10)], lambda m, t:
                         m.conv2d(t[0], 4, kernel=(7, 7), stride=(2, 2),
                                  use_bias=False), False),
    "conv_11x11_s4": ([(1, 3, 16, 16)], lambda m, t:
                      m.conv2d(t[0], 4, kernel=(11, 11), stride=(4, 4),
                               activation="relu"), False),
    "conv_valid": ([(2, 3, 7, 6)], lambda m, t:
                   m.conv2d(t[0], 5, kernel=(3, 2), padding="VALID",
                            activation="relu"), False),
    "conv_int_padding": ([(2, 3, 7, 7)], lambda m, t:
                         m.conv2d(t[0], 4, stride=(2, 2), padding=1,
                                  use_bias=False), False),
    "conv_pairs_groups": ([(2, 4, 6, 5)], lambda m, t:
                          m.conv2d(t[0], 6, padding=((0, 1), (2, 0)),
                                   groups=2, activation="sigmoid"), False),
    "pool_max_same": ([(2, 3, 7, 8)], lambda m, t:
                      m.pool2d(t[0], (3, 3), (2, 2), padding="SAME"), False),
    "pool_max_pairs": ([(2, 3, 5, 5)], lambda m, t:
                       m.pool2d(t[0], (3, 2), (1, 2),
                                padding=((1, 0), (0, 1))), False),
    "pool_avg_same": ([(2, 3, 6, 7)], lambda m, t:
                      m.pool2d(t[0], (3, 3), (2, 2), padding="SAME",
                               pool_type="avg"), False),
    "pool_avg_global": ([(2, 3, 4, 4)], lambda m, t:
                        m.pool2d(t[0], (4, 4), (1, 1), pool_type="avg"),
                        False),
    "batch_norm_train_relu": ([(4, 3, 5, 5)], lambda m, t:
                              m.batch_norm(t[0], relu=True), True),
    "batch_norm_eval": ([(4, 3, 5, 5)], lambda m, t:
                        m.batch_norm(t[0], eps=1e-3), False),
    "add_bias_residual_layer_norm": ([(2, 3, 8), (2, 3, 8)], lambda m, t:
                                     m.add_bias_residual_layer_norm(
                                         t[0], t[1]), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_gradient_equal_reference(case):
    shapes, build, training = CASES[case]
    jop, top = run_case(shapes, build, training=training,
                        seed=sum(map(ord, case)))
    assert top.attr_signature() == jop.attr_signature()


def _bn_net(pkg, mesh):
    """conv -> batch norm (relu) -> conv -> batch norm -> global average
    pool -> dense -> softmax, batch 8."""
    m = pkg.FFModel(pkg.FFConfig(batch_size=8), mesh=mesh)
    x = m.create_tensor((8, 3, 6, 6))
    h = m.conv2d(x, 4, use_bias=False, name="c1")
    h = m.batch_norm(h, relu=True, name="c1.bn")
    h = m.conv2d(h, 4, stride=(2, 2), use_bias=False, name="c2")
    h = m.batch_norm(h, name="c2.bn")
    h = m.flat(m.pool2d(h, (3, 3), (1, 1), pool_type="avg", name="gap"))
    m.softmax(m.dense(h, 3, name="fc"))
    return m


def test_batch_norm_statistics_are_the_global_batchs_on_a_mesh():
    """``{"dp": 2}``: each shard's BatchNorm all-reduces its sums (two
    collectives a norm), so the losses and the parameters after four SGD
    steps equal the JAX package's on its 2-device mesh (GSPMD, global
    statistics) and the port's on one device, in both modes; the running
    statistics are not trained."""
    assert spatial_pads("SAME", (8, 224), (3, 7), (2, 2)) == ((0, 1), (2, 3))
    rng = np.random.RandomState(6)
    x = (rng.randn(16, 3, 6, 6) * 2 + 1).astype(np.float32)
    y = rng.randint(0, 3, 16).astype(np.int32)
    jm = _bn_net(J, J.make_mesh({"dp": 2}, jax.devices()[:2]))
    jm.compile(optimizer=J.SGDOptimizer(lr=0.1, momentum=0.9))
    weights = {n: {p: np.asarray(v) for p, v in g.items()}
               for n, g in jm.params.items()}
    jh = jm.fit(x, y, epochs=2, batch_size=8, shuffle=False, verbose=False)
    for shape, mode in (({"dp": 1}, "spmd"), ({"dp": 2}, "spmd"),
                        ({"dp": 2}, "local")):
        mesh = T.make_mesh(shape, ["cpu"] * shape["dp"])
        tm = _bn_net(T, mesh)
        tm.compile(optimizer=T.SGDOptimizer(lr=0.1, momentum=0.9),
                   mode=mode)
        tm.load_params(weights)
        calls = dict(mesh.comm.calls)
        th = tm.fit(x, y, epochs=2, batch_size=8, shuffle=False,
                    verbose=False)
        if shape["dp"] == 2:
            # 4 steps, each: 2 norms x 2 sums, forward and backward, the
            # gradient sum and the exit gather
            assert mesh.comm.calls["local"] - calls["local"] == 4 * (
                4 + 4 + 1 + 1)
        for a, b in zip(th, jh):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        for n, g in jm.params.items():
            for p, v in g.items():
                np.testing.assert_allclose(
                    tm.params[n][p].detach().numpy(), np.asarray(v),
                    rtol=1e-4, atol=1e-6, err_msg=f"{n}.{p}")
        assert sorted(tm._trainable()["c1.bn"]) == ["beta", "gamma"]
        np.testing.assert_array_equal(
            tm.params["c2.bn"]["running_var"].numpy(), np.ones(4))
        np.testing.assert_allclose(
            tm.evaluate(x, y, batch_size=8)["loss"],
            jm.evaluate(x, y, batch_size=8)["loss"], rtol=1e-5)
