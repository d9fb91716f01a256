"""The port's Keras-style frontend vs the JAX package's, on the CPU.

The cases of ``tests/test_keras_frontend.py``: a Sequential MLP and CNN,
an embedding input, a functional model with a skip connection, the
callbacks (EarlyStopping, History, a ModelCheckpoint written and read
back), multi-output losses, and the unknown optimizer and loss.  Both
packages build the same graph; the port's model takes the reference's
initial weights (``load_params``) and trains unshuffled, so its histories
are the reference's (``rel 1e-5``), and so are ``evaluate`` and
``predict`` (``atol=rtol=1e-5``).
"""

import numpy as np
import pytest
import torch

import flexflow_tpu.frontends.keras as JK
import flexflow_tpu_torch as T
import flexflow_tpu_torch.frontends.keras as TK
from flexflow_tpu_torch.training.checkpoint import restore_checkpoint

TOL = dict(atol=1e-5, rtol=1e-5)


def _where(K):
    return {} if K is JK else dict(device="cpu")


def _pair(build, compile_kw):
    """Both packages' model from ``build(K)``, compiled; the port's takes
    the reference's initial weights."""
    jm, tm = build(JK), build(TK)
    jm.compile(**compile_kw)
    tm.compile(**compile_kw)
    tm.model.load_params({n: {p: np.asarray(v) for p, v in g.items()}
                          for n, g in jm.model.params.items()})
    return jm, tm


def _same_history(th, jh):
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert sorted(t) == sorted(j)
        for k in j:
            assert t[k] == pytest.approx(j[k], rel=1e-5, abs=1e-7), k


def _fit_both(jm, tm, x, y, **kw):
    kw.update(shuffle=False, verbose=False)
    jh, th = jm.fit(x, y, **kw), tm.fit(x, y, **kw)
    _same_history(th, jh)
    return th


def _mlp(K):
    return K.Sequential([K.Dense(64, activation="relu", input_shape=(16,)),
                         K.Dropout(0.0), K.Dense(4, activation="softmax")],
                        **_where(K))


def _classes(seed, n, d, k=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    return x, np.argmax(x @ rng.randn(d, k), axis=1).astype(np.int32)


def test_sequential_mlp_matches_reference():
    x, y = _classes(0, 128, 16)
    jm, tm = _pair(_mlp, dict(optimizer="sgd", metrics=["accuracy"],
                              loss="sparse_categorical_crossentropy",
                              batch_size=16))
    assert isinstance(tm.model.optimizer, T.SGDOptimizer)
    hist = _fit_both(jm, tm, x, y, epochs=5, batch_size=16)
    assert hist[-1]["loss"] < hist[0]["loss"]
    ev, jev = tm.evaluate(x, y, batch_size=16), jm.evaluate(x, y,
                                                            batch_size=16)
    _same_history([ev], [jev])
    probs = tm.predict(x[:16])
    np.testing.assert_allclose(probs, jm.predict(x[:16]), **TOL)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


def test_sequential_embedding_input_matches_reference():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 50, size=(64,)).astype(np.int32)
    y = (x % 3).astype(np.int32)

    def build(K):
        return K.Sequential([K.Input(shape=(), dtype="int32"),
                             K.Embedding(50, 16),
                             K.Dense(3, activation="softmax")], **_where(K))

    jm, tm = _pair(build, dict(optimizer="adam", batch_size=16))
    assert isinstance(tm.model.optimizer, T.AdamOptimizer)
    hist = _fit_both(jm, tm, x, y, epochs=5, batch_size=16)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_sequential_cnn_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(32, 3, 16, 16).astype(np.float32)
    y = rng.randint(0, 4, size=32).astype(np.int32)

    def build(K):
        return K.Sequential([
            K.Conv2D(8, 3, padding="same", activation="relu",
                     input_shape=(3, 16, 16)),
            K.MaxPooling2D(2),
            K.Conv2D(16, 3, strides=2, padding="same", activation="relu"),
            K.AveragePooling2D(2), K.Flatten(),
            K.Dense(4, activation="softmax")], **_where(K))

    jm, tm = _pair(build, dict(optimizer="adam", metrics=["accuracy"],
                               batch_size=16))
    _fit_both(jm, tm, x, y, epochs=3, batch_size=16)
    np.testing.assert_allclose(tm.predict(x[:16]), jm.predict(x[:16]), **TOL)


def _skip(K):
    inp = K.Input((16,))
    h = K.Dense(16, activation="relu")(inp)
    h2 = K.Dense(16, activation="relu")(h)
    out = K.Dense(4, activation="softmax")(K.Add()([h, h2]))
    return K.Model(inp, out, **_where(K))


def test_functional_skip_connection_matches_reference():
    x, y = _classes(0, 64, 16)
    jm, tm = _pair(_skip, dict(optimizer="adam", metrics=["accuracy"],
                               batch_size=32))
    assert [n.op.type_name for n in tm.model.graph.nodes] == [
        n.op.type_name for n in jm.model.graph.nodes]
    hist = _fit_both(jm, tm, x, y, epochs=6, batch_size=32)
    assert hist[-1]["loss"] < hist[0]["loss"]
    np.testing.assert_allclose(tm.predict(x[:32]), jm.predict(x[:32]), **TOL)


def test_callbacks_early_stopping_history_and_checkpoint(tmp_path):
    """EarlyStopping stops both runs at the same epoch; the History is the
    reference's; ModelCheckpoint's epoch-0 files restore into a fresh
    model as the weights after epoch 0."""
    rng = np.random.RandomState(1)
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 3, size=64).astype(np.int32)

    def build(K):
        return K.Sequential([K.Dense(16, activation="relu", input_shape=(8,)),
                             K.Dense(3, activation="softmax")], **_where(K))

    class Snapshot(TK.Callback):
        def __init__(self, model):
            self.model, self.params = model, []

        def on_epoch_end(self, epoch, logs=None):
            self.params.append({n: {p: v.detach().clone()
                                    for p, v in g.items()}
                                for n, g in self.model.params.items()})

    jm, tm = _pair(build, dict(optimizer="sgd", batch_size=32))
    snap = Snapshot(tm.model)
    hists = []
    for K, m, extra in ((JK, jm, []), (TK, tm, [snap])):
        cbs = [K.EarlyStopping(monitor="loss", patience=0, min_delta=10.0),
               K.ModelCheckpoint(str(tmp_path / f"{K.__name__}_{{epoch}}"))]
        hists.append(m.fit(x, y, epochs=10, batch_size=32, verbose=False,
                           shuffle=False, callbacks=cbs + extra))
    _same_history(hists[1], hists[0])
    assert len(hists[1]) == 2        # min_delta 10: epoch 2 never improves
    fresh = build(TK).compile(optimizer="sgd", batch_size=32)
    restore_checkpoint(str(tmp_path / f"{TK.__name__}_0"), fresh.model)
    for n, g in snap.params[0].items():
        for p, v in g.items():
            assert torch.equal(fresh.model.params[n][p], v), f"{n}.{p}"


def test_functional_multi_output_losses_match_reference():
    x, y_cls = _classes(0, 64, 16)
    y_reg = (x[:, :2] * 0.5).astype(np.float32)

    def build(K):
        inp = K.Input((16,))
        trunk = K.Dense(32, activation="relu")(inp)
        return K.Model(inp, [K.Dense(4, activation="softmax")(trunk),
                             K.Dense(2)(trunk)], **_where(K))

    jm, tm = _pair(build, dict(
        optimizer="adam", loss=["sparse_categorical_crossentropy", "mse"],
        loss_weights=[1.0, 0.5], metrics=["accuracy"], batch_size=32))
    hist = _fit_both(jm, tm, x, [y_cls, y_reg], epochs=8, batch_size=32)
    assert hist[-1]["loss"] < hist[0]["loss"]
    _same_history([tm.evaluate(x, [y_cls, y_reg], batch_size=32)],
                  [jm.evaluate(x, [y_cls, y_reg], batch_size=32)])
    with pytest.raises(ValueError, match="one loss per"):
        build(TK).compile(loss="mse", batch_size=32)


def test_unknown_optimizer_and_loss_raise():
    for K in (JK, TK):
        m = K.Sequential([K.Dense(4, input_shape=(8,))], **_where(K))
        with pytest.raises(ValueError, match="optimizer"):
            m.compile(optimizer="adagrad")
        with pytest.raises(ValueError, match="unknown loss"):
            m.compile(loss="hinge")
        with pytest.raises(ValueError, match="input_shape"):
            K.Sequential([K.Dense(4)], **_where(K)).compile()
    with pytest.raises(RuntimeError, match="compile"):
        TK.Sequential([TK.Dense(4, input_shape=(8,))],
                      device="cpu").predict(np.zeros((2, 8)))
