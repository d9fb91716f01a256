"""Training on the card: ``FFModel`` on CUDA against the same model on the
CPU, at TINY widths (``chip_smoke.py`` phase 21(a) in small).

These tests need an NVIDIA GPU; without one each skips.  This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py

* the Transformer classifier from the same weights (``load_params``) and
  batches: 3 steps of SGD with momentum and of Adam through ``fit``, the
  losses within ``rtol 1e-5`` and the parameters within ``1e-5`` (SGD)
  or ``2 * alpha * steps`` (Adam: its step on a near-zero gradient is
  about ``alpha`` whatever the gradient's rounding); float32, TF32 off;
* ``FFModel()`` with no device trains on the card: the mesh, the
  parameters, the optimizer state and the outputs live there;
* dropout on the card draws from the model's generator: two fits from
  one seed give the same parameters.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ff
from flexflow_tpu_torch.models.transformer import \
    build_transformer_classifier as build

pytestmark = pytest.mark.cuda

TINY = dict(batch=4, seq=16, hidden_dim=32, num_heads=4, ff_dim=64,
            num_layers=2, num_classes=5)
STEPS = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _batch(seed=0, n=TINY["batch"]):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, TINY["seq"], TINY["hidden_dim"]).astype(np.float32),
            rng.randint(0, TINY["num_classes"], n).astype(np.int32))


@pytest.mark.parametrize("opt", [("SGDOptimizer", dict(lr=0.05,
                                                       momentum=0.9)),
                                 ("AdamOptimizer", dict(alpha=1e-3))],
                         ids=["sgd_momentum", "adam"])
def test_fit_on_the_card_equals_the_cpu(dev, opt):
    cls, kw = opt
    x, y = _batch()
    runs = []
    for device in ("cpu", dev):
        m = build(ff.FFConfig(batch_size=TINY["batch"]), device=device,
                  **TINY)
        m.compile(optimizer=getattr(ff, cls)(**kw), metrics=["accuracy"])
        if runs:
            m.load_params(runs[0][2])     # the CPU model's initial weights
        init = {n: {p: v.detach().clone() for p, v in g.items()}
                for n, g in m.params.items()}
        hist = m.fit(x, y, epochs=STEPS, shuffle=False, verbose=False)
        runs.append(([h["loss"] for h in hist], m, init))
    (lc, cpu, _), (lg, card, _) = runs
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    atol = 2 * kw["alpha"] * STEPS if cls == "AdamOptimizer" else 1e-5
    for n, g in cpu.params.items():
        for p, v in g.items():
            assert card.params[n][p].device == dev
            np.testing.assert_allclose(
                card.params[n][p].detach().cpu().numpy(),
                v.detach().numpy(), rtol=1e-5, atol=atol,
                err_msg=f"{n}.{p}")
    np.testing.assert_allclose(card.forward(x).cpu().numpy(),
                               cpu.forward(x).numpy(), rtol=1e-4,
                               atol=1e-5)


def test_the_default_device_is_the_card(dev):
    m = build(ff.FFConfig(batch_size=TINY["batch"], num_devices=1), **TINY)
    m.compile(optimizer=ff.AdamOptimizer(alpha=1e-3), metrics=["accuracy"])
    assert m.mesh.devices == [dev]
    assert all(v.device == dev for g in m.params.values()
               for v in g.values())
    assert all(v.device == dev for g in m.opt_state["m"].values()
               for v in g.values())
    x, y = _batch(n=2 * TINY["batch"])
    hist = m.fit(x, y, epochs=2, verbose=False)
    assert np.isfinite(hist[-1]["loss"])
    assert m.forward(x[:TINY["batch"]]).device == dev
    assert set(m.evaluate(x, y)) == {"loss", "accuracy"}


def test_dropout_on_the_card_follows_the_seed(dev):
    x, y = _batch(n=2 * TINY["batch"])

    def run(seed):
        m = build(ff.FFConfig(batch_size=TINY["batch"], seed=seed),
                  device=dev, dropout=0.3, **TINY)
        m.compile(optimizer=ff.SGDOptimizer(lr=0.05))
        m.fit(x, y, epochs=2, verbose=False)
        return {f"{n}.{p}": v.detach().cpu() for n, g in m.params.items()
                for p, v in g.items()}

    a, b = run(1), run(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
