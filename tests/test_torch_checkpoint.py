"""Checkpoint and resume through the port (``training/checkpoint.py``),
the reference's three tests (``tests/test_checkpoint.py``) on meshes over
``["cpu"] * n``, and the reference's key strings.

Arrays are saved whole, so a checkpoint written on one layout restores
onto any other bit for bit; a resumed ``dp2 x tp2`` run trains exactly as
the uninterrupted one (same parameters, optimizer state and generator).
"""

import json

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.training.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from flexflow_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)

TP = {"channel_out": ("tp",)}


def build(pkg, mesh, width=32, devices=None):
    """``tests/test_checkpoint.py:build``; on a mesh with a ``tp`` axis
    the first layer is column-split and the second row-split."""
    model = pkg.FFModel(pkg.FFConfig(batch_size=16, learning_rate=0.05),
                        mesh=mesh)
    x = model.create_tensor((16, 12))
    h = model.dense(x, width, activation="relu")
    model.softmax(model.dense(h, 6))
    strategy = None
    if "tp" in mesh.shape:
        dp = {"sample": ("dp",)} if "dp" in mesh.shape else {}
        strategy = {"dense": dict(dp, **TP),
                    "dense_1": dict(dp, channel_in=("tp",)),
                    "softmax": dp}
    model.compile(optimizer=pkg.AdamOptimizer(alpha=0.01),
                  strategy=strategy)
    return model


def data():
    rng = np.random.RandomState(3)
    return (rng.randn(64, 12).astype(np.float32),
            rng.randint(0, 6, size=64).astype(np.int32))


def state(model):
    out = {f"p{n}.{p}": v.detach().clone()
           for n, g in model.params.items() for p, v in g.items()}
    opt = model.opt_state
    out.update({f"{k}{n}.{p}": v.clone() for k in ("m", "v")
                for n, g in opt[k].items() for p, v in g.items()})
    out["t"] = torch.tensor(opt["t"])
    return out


def mesh(shape):
    return T.make_mesh(shape, ["cpu"] * int(np.prod(list(shape.values()))))


def test_resume_is_bit_exact(tmp_path):
    four = mesh({"dp": 2, "tp": 2})
    X, y = data()
    model = build(T, four)
    model.fit(X, y, epochs=2, batch_size=16, verbose=0)
    save_checkpoint(str(tmp_path / "ck"), model, step=2)
    model.fit(X, y, epochs=2, batch_size=16, verbose=0)
    want = state(model)

    model2 = build(T, four)   # a fresh init until the restore
    step = restore_checkpoint(str(tmp_path / "ck"), model2)
    assert step == 2
    model2.fit(X, y, epochs=2, batch_size=16, verbose=0)
    got = state(model2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert [s["t"] for s in model2.shard_opt_states] == [16] * 4


def test_restore_across_mesh_layouts(tmp_path):
    """Written on ``dp2 x tp2``, restored on one device and on ``dp=2``:
    the same values, and the same outputs."""
    X, y = data()
    m1 = build(T, mesh({"dp": 2, "tp": 2}))
    m1.fit(X, y, epochs=1, batch_size=16, verbose=0)
    save_checkpoint(str(tmp_path / "ck"), m1, step=1)
    want = state(m1)
    for shape in ({"dp": 1}, {"dp": 2}):
        m2 = build(T, mesh(shape))
        restore_checkpoint(str(tmp_path / "ck"), m2)
        got = state(m2)
        for k in want:
            assert torch.equal(got[k], want[k]), (shape, k)
        torch.testing.assert_close(m2.forward(X[:16]), m1.forward(X[:16]),
                                   rtol=1e-6, atol=1e-7)


def test_restore_shape_mismatch_raises(tmp_path):
    two = mesh({"dp": 2})
    save_checkpoint(str(tmp_path / "ck"), build(T, two))
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore_checkpoint(str(tmp_path / "ck"), build(T, two, width=64))
    # a leaf the checkpoint lacks
    z = dict(np.load(tmp_path / "ck" / "params.npz"))
    z.pop("['dense']['bias']")
    np.savez(tmp_path / "ck" / "params.npz", **z)
    with pytest.raises(KeyError, match="dense"):
        restore_checkpoint(str(tmp_path / "ck"), build(T, two))


def test_keys_and_layout_equal_the_reference(tmp_path):
    """The files, ``params.npz``'s and ``opt_state.npz``'s keys and shapes
    and ``meta.json`` equal what the JAX package writes for the same
    model."""
    jm = build(J, J.make_mesh({"dp": 2}, jax.devices()[:2]))
    tm = build(T, mesh({"dp": 2}))
    jax_save_checkpoint(str(tmp_path / "j"), jm, step=3)
    save_checkpoint(str(tmp_path / "t"), tm, step=3)
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == \
        sorted(p.name for p in (tmp_path / "t").iterdir())
    for fname in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "j" / fname) as jz, \
                np.load(tmp_path / "t" / fname) as tz:
            assert sorted(jz.files) == sorted(tz.files)
            assert "['dense']['kernel']" in jz.files or fname != "params.npz"
            for k in jz.files:
                assert jz[k].shape == tz[k].shape, (fname, k)
    for d in ("j", "t"):
        assert json.loads((tmp_path / d / "meta.json").read_text()) == \
            {"format": 1, "step": 3}
    assert not list(tmp_path.glob("t/*.tmp"))
