"""The port's torch.fx frontend vs the JAX package's, on the CPU.

The cases of ``tests/test_torch_fx.py`` (an MLP, a pre-norm transformer
block with ``nn.MultiheadAttention``, a CNN with BatchNorm and both pools,
an unsupported module): ``flexflow_tpu_torch.frontends.from_torch``
records the reference's ``from_torch`` graph (node names, op types,
``attr_signature()``, wiring, parameter shapes) and returns the same
weights; its forward equals the torch module's (the reference tests'
tolerances) and the reference's forward (``atol=rtol=1e-5``, float32); and
training the imported model with the module's weights gives the
reference's histories (``rel 1e-5``; unshuffled) and, for the MLP,
``torch.optim.SGD``'s losses.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.frontends import from_torch as jax_from_torch
from flexflow_tpu_torch.frontends import from_torch

from test_torch_fx import MLP, Block, SmallCNN

TOL = dict(atol=1e-5, rtol=1e-5)
CASES = {"mlp": (MLP, (4, 16), 1e-5), "block": (Block, (2, 6, 32), 1e-4),
         "cnn": (SmallCNN, (4, 3, 16, 16), 2e-4)}


def _imported(case, seed=0, train=False):
    """The case's module (seeded), and both packages' imports of it."""
    cls, shape, _ = CASES[case]
    torch.manual_seed(seed)
    mod = cls() if train else cls().eval()
    return (mod, jax_from_torch(mod, [shape]),
            from_torch(mod, [shape], device="cpu"))


def _record(model, outs):
    g = model.graph
    specs = g.param_specs()
    return ([(n.name, n.op.type_name, n.op.attr_signature(), list(n.inputs),
              list(n.outputs),
              {p: tuple(s.spec.shape) for p, s in specs.get(n.name,
                                                            {}).items()})
             for n in g.nodes], [t.tid for t in outs], list(g.input_tids))


@pytest.mark.parametrize("case", list(CASES))
def test_imported_graph_and_weights_equal_reference(case):
    _, (jm, jouts, jw), (tm, touts, tw) = _imported(case)
    assert _record(tm, touts) == _record(jm, jouts)
    assert sorted(tw) == sorted(jw)
    for n in jw:
        assert sorted(tw[n]) == sorted(jw[n])
        for p in jw[n]:
            assert np.array_equal(tw[n][p], jw[n][p]), f"{n}.{p}"


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_torch_and_reference(case):
    mod, (jm, jouts, jw), (tm, touts, tw) = _imported(case, seed=1)
    x = np.random.RandomState(1).randn(*CASES[case][1]).astype(np.float32)
    with torch.no_grad():
        want = mod(torch.from_numpy(x)).numpy()
    jm.compile(outputs=jouts, loss_type="identity")
    jm.load_params(jw)
    tm.compile(outputs=touts, loss_type="identity")
    tm.load_params(tw)
    got = tm.forward(x).numpy()
    tol = CASES[case][2]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, np.asarray(jm.forward(x)), **TOL)


@pytest.mark.parametrize("case", ["mlp", "cnn"])
def test_training_histories_equal_reference(case):
    """SGD on the module's weights, a softmax head on the import (the
    loss takes probabilities), unshuffled: the reference's histories; the
    MLP's first losses are ``torch.optim.SGD``'s on the module."""
    mod, (jm, jouts, jw), (tm, touts, tw) = _imported(case, seed=2,
                                                      train=True)
    shape = CASES[case][1]
    rng = np.random.RandomState(2)
    n = 2 * shape[0]
    x = rng.randn(n, *shape[1:]).astype(np.float32)
    y = rng.randint(0, 5 if case == "cnn" else 8, size=n).astype(np.int32)
    lr = 0.1 if case == "mlp" else 0.01
    for pkg, m, outs, w in ((J, jm, jouts, jw), (T, tm, touts, tw)):
        m.softmax(outs[0])
        m.compile(optimizer=pkg.SGDOptimizer(lr=lr))
        m.load_params(w)
    kw = dict(epochs=3, batch_size=shape[0], shuffle=False, verbose=False)
    want = jm.fit(x, y, **kw)
    got = tm.fit(x, y, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
    if case == "mlp":
        # one full-batch SGD step on the module and on the import
        opt = torch.optim.SGD(mod.parameters(), lr=lr)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
        loss0 = nn.functional.cross_entropy(mod(xt), yt)
        opt.zero_grad()
        loss0.backward()
        opt.step()
        loss1 = nn.functional.cross_entropy(mod(xt), yt).item()
        m2 = from_torch(MLP(), [(n, 16)], device="cpu")
        m2[0].softmax(m2[1][0])
        m2[0].compile(optimizer=T.SGDOptimizer(lr=lr))
        m2[0].load_params(tw)
        h = m2[0].fit(x, y, epochs=2, batch_size=n, shuffle=False,
                      verbose=False)
        assert h[0]["loss"] == pytest.approx(loss0.item(), abs=1e-4)
        assert h[1]["loss"] == pytest.approx(loss1, abs=1e-3)


def test_unsupported_nodes_raise_with_their_names():
    class Weird(nn.Module):
        def __init__(self):
            super().__init__()
            self.c = nn.ConvTranspose2d(1, 1, 2)

        def forward(self, x):
            return self.c(x)

    class Dilated(nn.Module):
        def __init__(self):
            super().__init__()
            self.c = nn.Conv2d(1, 1, 3, dilation=2)

        def forward(self, x):
            return self.c(x)

    class SeqFirst(nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = nn.MultiheadAttention(8, 2)

        def forward(self, x):
            return self.attn(x, x, x)[0]

    for imp, kw in ((jax_from_torch, {}), (from_torch, dict(device="cpu"))):
        with pytest.raises(NotImplementedError, match="ConvTranspose2d"):
            imp(Weird(), [(1, 1, 4, 4)], **kw)
        with pytest.raises(NotImplementedError, match="dilation"):
            imp(Dilated(), [(1, 1, 8, 8)], **kw)
        with pytest.raises(NotImplementedError, match="batch_first"):
            imp(SeqFirst(), [(3, 1, 8)], **kw)
    with pytest.raises(NotImplementedError, match=r"\.cumsum\(\)"):
        from_torch(_Cumsum(), [(2, 3)], device="cpu")


class _Cumsum(nn.Module):
    def forward(self, x):
        return x.cumsum(1)
