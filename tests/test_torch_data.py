"""The port's DataLoader (``data/loader.py``, ``data/native.py``) against
the JAX package's: the reference's four tests (``tests/test_dataloader.py``)
on meshes over ``["cpu"] * n``, batch for batch equality with the
reference's Python path and its native engine's order, and the native
engine's build failing loudly instead of falling back.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as T
from flexflow_tpu.data import DataLoader as JDataLoader
from flexflow_tpu.data import native as jax_native
from flexflow_tpu_torch.data import DataLoader
from flexflow_tpu_torch.data import native


def _labels(loader):
    return [t for _, labs in loader for t in np.asarray(labs).tolist()]


def test_loader_batches_and_shuffles():
    X = np.arange(50, dtype=np.float32).reshape(50, 1)
    y = np.arange(50, dtype=np.int32)
    dl = DataLoader(X, y, batch_size=8, shuffle=True, seed=0, prefetch=3,
                    native=False)
    assert len(dl) == 6
    seen = []
    for arrs, labels in dl:
        assert arrs[0].shape == (8, 1)
        assert labels.shape == (8,)
        np.testing.assert_array_equal(
            arrs[0].numpy()[:, 0].astype(np.int32), labels.numpy())
        seen += labels.tolist()
    assert dl.engine == "python"
    assert len(seen) == 48 and len(set(seen)) == 48
    assert seen != sorted(seen), "shuffle had no effect"
    # the same seed reproduces the epoch order
    assert _labels(DataLoader(X, y, batch_size=8, seed=0,
                              native=False)) == seen


def test_python_path_batches_equal_the_reference():
    """``np.random.RandomState(seed).permutation`` on both sides: every
    batch of every epoch equal bit for bit, several inputs included."""
    rng = np.random.RandomState(1)
    X1 = rng.randn(37, 3, 2).astype(np.float32)
    X2 = rng.randint(0, 9, (37, 4)).astype(np.int32)
    y = rng.randint(0, 5, 37).astype(np.int32)
    for shuffle in (True, False):
        ours = DataLoader([X1, X2], y, batch_size=5, shuffle=shuffle,
                          seed=7)
        ref = JDataLoader([X1, X2], y, batch_size=5, shuffle=shuffle,
                          seed=7)
        for _ in range(2):   # two epochs: the stream advances alike
            got, want = list(ours), list(ref)
            assert len(got) == len(want) == 7
            for (ga, gl), (wa, wl) in zip(got, want):
                for k in (0, 1):
                    np.testing.assert_array_equal(ga[k].numpy(),
                                                  np.asarray(wa[k]))
                np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        assert ours.engine == "python"   # several inputs: no engine


def test_native_engine_order_equals_the_reference_engine():
    if not jax_native.available():
        pytest.skip("the reference engine cannot build here")
    X = np.arange(200, dtype=np.float32).reshape(50, 4)
    y = np.arange(50, dtype=np.int32)
    dl = DataLoader(X, y, batch_size=8, shuffle=True, seed=3, native=True)
    ref = JDataLoader(X, y, batch_size=8, shuffle=True, seed=3, native=True)
    seen = []
    for arrs, labels in dl:
        xb, yb = arrs[0].numpy(), labels.numpy()
        np.testing.assert_array_equal(xb[:, 0].astype(np.int32), yb * 4)
        seen += yb.tolist()
    assert dl.engine == "native"
    assert len(seen) == 48 and len(set(seen)) == 48
    assert seen != sorted(seen), "native shuffle had no effect"
    assert seen == _labels(ref)
    # the second epoch: the engine's next permutation, as the reference's
    assert _labels(dl) == _labels(ref)
    dl._nb.close()
    ref._nb.close()


def test_loader_plan_placement_maps_keys_to_tids():
    """Loader keys (0, 1, ...) map onto the plan's input tids even when
    the graph's input tids are not 0..n-1; each shard gets its block."""
    mesh = T.make_mesh({"dp": 4}, ["cpu"] * 4)
    model = T.FFModel(T.FFConfig(batch_size=16), mesh=mesh)
    x1 = model.create_tensor((16, 8))
    h1 = model.dense(x1, 8, activation="relu")  # makes non-input tensors
    x2 = model.create_tensor((16, 8))           # input tid is not 1
    h = model.add(h1, x2)
    model.softmax(model.dense(h, 4))
    model.compile(optimizer=T.SGDOptimizer(lr=0.1))
    tids = model.graph.input_tids
    assert tids != list(range(len(tids))), "test premise: tids not 0..n-1"

    X1 = np.random.RandomState(0).randn(32, 8).astype(np.float32)
    X2 = np.random.RandomState(1).randn(32, 8).astype(np.float32)
    y = np.zeros(32, np.int32)
    dl = DataLoader([X1, X2], y, batch_size=16, shuffle=False,
                    plan=model.plan)
    for i, (arrs, labels) in enumerate(dl):
        assert set(arrs) == set(tids)
        for t, X in zip(tids, (X1, X2)):
            blocks = arrs[t]
            assert [tuple(b.shape) for b in blocks] == [(4, 8)] * 4
            np.testing.assert_array_equal(
                torch.cat(blocks).numpy(), X[16 * i: 16 * (i + 1)])
        assert labels.device == mesh.devices[0]


def test_fit_with_loader_trains():
    mesh = T.make_mesh({"dp": 4}, ["cpu"] * 4)
    model = T.FFModel(T.FFConfig(batch_size=16, learning_rate=0.1),
                      mesh=mesh)
    x = model.create_tensor((16, 8))
    h = model.dense(x, 32, activation="relu")
    model.softmax(model.dense(h, 4))
    model.compile(optimizer=T.SGDOptimizer(lr=0.1), metrics=["accuracy"])

    rng = np.random.RandomState(0)
    X = rng.randn(128, 8).astype(np.float32)
    w = rng.randn(8, 4)
    y = np.argmax(X @ w, axis=1).astype(np.int32)  # a learnable mapping
    dl = DataLoader(X, y, batch_size=16, seed=1, plan=model.plan)
    hist = model.fit(dl, None, epochs=6, verbose=0)
    assert dl.engine == "native"
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["accuracy"] > 0.5
    # a loader without a plan: fit places its batches
    free = DataLoader(X, y, batch_size=16, seed=1, native=False)
    assert np.isfinite(model.fit(free, epochs=1, verbose=0)[0]["loss"])


def test_native_auto_raises_when_the_build_fails(tmp_path, monkeypatch):
    """No silent fallback: with the compiler missing, ``native="auto"``
    raises where the engine applies (one input array); ``native=False``
    and several inputs take the Python path."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    X = np.zeros((16, 3), np.float32)
    y = np.zeros(16, np.int32)
    with pytest.raises(RuntimeError, match="no-such-g"):
        iter(DataLoader(X, y, batch_size=4))
    with pytest.raises(RuntimeError, match="no-such-g"):
        iter(DataLoader(X, y, batch_size=4, native=True))
    assert len(list(DataLoader(X, y, batch_size=4, native=False))) == 4
    assert len(list(DataLoader([X, X], y, batch_size=4))) == 4
    with pytest.raises(RuntimeError, match="single input"):
        iter(DataLoader([X, X], y, batch_size=4, native=True))
    assert not (tmp_path / "native").exists() or not list(
        (tmp_path / "native").glob("*.so"))
