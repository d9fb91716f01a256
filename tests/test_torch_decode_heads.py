"""The port's decode heads and its Cache op against the JAX package's, on
the CPU.

* ``ArgMax``, ``TopK``, ``ArgTopK`` (with ``speculative_decoding``'s
  probabilities) and ``BeamTopK`` on seeded logits, and on logits with
  planted ties (equal values across the vocabulary, and across beams):
  indices equal the reference's element for element (``int32``, the
  lower index first among ties), values and ``TopK``'s gradient at
  ``rtol 1e-5``; each op's ``attr_signature()`` is the reference's;
* a graph ``dense -> head`` on ``{"tp": 2}`` (the vocabulary split over
  two CPU shards, gathered before the head) equals one device and the
  reference;
* ``Sampling``'s nucleus mask equals the reference's element for element
  (the reference's own, captured at its draw), every sampled token lies
  inside it, a seed gives the same tokens twice, and over 20000 draws of
  one row each token's frequency lies within five binomial standard
  deviations of the reference's probability (the draws match in
  distribution only);
* ``Cache``: refresh then use mode replays the stored value, use mode
  without one raises ``ValueError``, and ``build_forward``'s stateful
  step threads the state as the reference's does
  (``tests/test_models.py:253-299``), per shard on ``{"dp": 2}``.
"""

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu.core.op import OpContext as JCtx
from flexflow_tpu_torch.core.interpreter import build_forward, place_inputs
from flexflow_tpu_torch.core.op import OpContext
from flexflow_tpu_torch.ops.reduction import nucleus_keep

TOL = dict(rtol=1e-5, atol=1e-6)


def _logits(rng, shape, ties=False):
    x = rng.randn(*shape).astype(np.float32)
    if ties:   # equal largest logits across the vocabulary (and beams)
        x[..., 1::2] = 5.0
        x[..., :3] = 5.0
    return x


def _op(pkg, shape, build):
    m = (J.FFModel(J.FFConfig(num_devices=1)) if pkg is J
         else T.FFModel(T.FFConfig(), device="cpu"))
    build(m, m.create_tensor(shape))
    return m.graph.nodes[-1].op


# id -> (logits shape, ties, build(model, tensor))
CASES = {
    "argmax": ((4, 3, 50), False, lambda m, t: m.argmax(t)),
    "argmax_ties": ((4, 50), True, lambda m, t: m.argmax(t)),
    "top_k": ((6, 50), False, lambda m, t: m.top_k(t, 5)),
    "top_k_ties": ((6, 50), True, lambda m, t: m.top_k(t, 7)),
    "arg_top_k": ((6, 50), True, lambda m, t: m.arg_top_k(t, 4)),
    "arg_top_k_spec": ((2, 3, 50), True, lambda m, t:
                       m.arg_top_k(t, 4, speculative_decoding=True)),
    "beam_top_k": ((3, 4, 20), False, lambda m, t: m.beam_top_k(t, 5)),
    "beam_top_k_ties": ((3, 4, 20), True, lambda m, t: m.beam_top_k(t, 9)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_head_equals_reference(case):
    shape, ties, build = CASES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    x = _logits(rng, shape, ties)
    jop, top = _op(J, shape, build), _op(T, shape, build)
    assert top.attr_signature() == jop.attr_signature()

    def f(v):
        return jop.lower(JCtx(), [v], {})

    jout, vjp = jax.vjp(f, x)
    tx = torch.tensor(x, requires_grad=True)
    out = top(tx)
    outs = list(out) if isinstance(out, tuple) else [out]
    assert len(outs) == len(jout)
    cts = []
    for o, j in zip(outs, jout):
        assert tuple(o.shape) == j.shape
        assert str(o.dtype).replace("torch.", "") == str(j.dtype)
        if o.dtype == torch.int32:
            np.testing.assert_array_equal(o.numpy(), np.asarray(j))
            cts.append(np.zeros(j.shape, jax.dtypes.float0))
        else:
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(j),
                                       **TOL)
            cts.append(rng.randn(*j.shape).astype(np.float32))
    if case.startswith("top_k"):   # the values' gradient
        (jg,) = vjp(cts)
        torch.autograd.backward([outs[0]], [torch.tensor(cts[0])])
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), **TOL)
    if ties and case != "beam_top_k_ties":   # the lower index first
        idx = outs[-1 if case == "top_k_ties" else 0]
        if case == "argmax_ties":
            assert (idx == 0).all()
        else:
            assert (idx[..., :3] == torch.tensor([0, 1, 2])).all()


def _head_net(pkg, shape, head):
    n = int(np.prod(list(shape.values())))
    mesh = (J.make_mesh(shape, jax.devices()[:n]) if pkg is J
            else T.make_mesh(shape, ["cpu"] * n))
    m = pkg.FFModel(pkg.FFConfig(batch_size=8), mesh=mesh)
    x = m.create_tensor((8, 16))
    logits = m.dense(x, 68, name="lm_head")
    outs = head(m, logits)
    outs = outs if isinstance(outs, list) else [outs]
    strategy = ({"lm_head": {"channel_out": ("tp",)}}
                if shape.get("tp", 1) > 1 else {})
    m.compile(outputs=outs, strategy=strategy, loss_type="identity")
    return m


HEADS = {
    "argmax": lambda m, t: m.argmax(t),
    "top_k": lambda m, t: m.top_k(t, 4),
    "arg_top_k": lambda m, t: m.arg_top_k(t, 3, speculative_decoding=True),
    "sampling": lambda m, t: m.sampling(t, top_p=0.9, temperature=0.8),
}


def test_vocab_split_equals_one_device_and_reference():
    x = np.random.RandomState(3).randn(8, 16).astype(np.float32)
    for name, head in HEADS.items():
        jm = _head_net(J, {"dp": 1}, head)
        w = {n: {p: np.asarray(v) for p, v in g.items()}
             for n, g in jm.params.items()}
        one = _head_net(T, {"dp": 1}, head).load_params(w)
        tp2 = _head_net(T, {"tp": 2}, head).load_params(w)
        assert any(st.is_parallel for st in tp2.plan.steps)
        a, b = one.forward(x), tp2.forward(x)
        a, b = (a, b) if isinstance(a, list) else ([a], [b])
        j = jm.forward(x)
        j = j if isinstance(j, list) else [j]
        for u, v, r in zip(a, b, j):
            assert torch.equal(u, v), name
            if name != "sampling":
                np.testing.assert_allclose(u.numpy(), np.asarray(r), **TOL)


def _reference_mask(monkeypatch, logits, top_p, temperature):
    """The reference's nucleus mask of ``logits``: the logits its
    ``Sampling`` hands to ``jax.random.categorical``, finite where
    kept."""
    from flexflow_tpu.ops.reduction import Sampling as JSampling

    seen = {}
    real = jax.random.categorical

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return real(key, lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    JSampling(top_p, temperature).lower(JCtx(), [logits], {})
    monkeypatch.setattr(jax.random, "categorical", real)
    return np.isfinite(seen["logits"])


def test_nucleus_mask_and_tokens_equal_reference(monkeypatch):
    from flexflow_tpu_torch.ops.reduction import Sampling

    rng = np.random.RandomState(5)
    for top_p, temp in ((0.9, 1.0), (0.5, 0.7), (0.95, 1.3)):
        logits = (rng.randn(32, 100) * 2).astype(np.float32)
        logits[:4, :10] = 3.0        # ties at the cut
        want = _reference_mask(monkeypatch, logits, top_p, temp)
        scaled = torch.tensor(logits) / temp if temp != 1.0 \
            else torch.tensor(logits)
        keep = nucleus_keep(scaled, top_p).numpy()
        np.testing.assert_array_equal(keep, want)
        op = Sampling(top_p, temp)
        g = torch.Generator().manual_seed(11)
        tok = op(torch.tensor(logits), ctx=OpContext(generator=g))
        again = op(torch.tensor(logits), ctx=OpContext(
            generator=torch.Generator().manual_seed(11)))
        assert tok.dtype == torch.int32 and torch.equal(tok, again)
        assert want[np.arange(32), tok.numpy()].all()


def test_sampling_frequencies_within_binomial_bound():
    """20000 draws of one row: each token's frequency within five
    standard deviations of the reference's probability (its softmax of
    the masked, tempered logits), and the reference's own draws too."""
    from flexflow_tpu.ops.reduction import Sampling as JSampling
    from flexflow_tpu_torch.ops.reduction import Sampling

    n, top_p, temp = 20000, 0.8, 0.9
    row = np.random.RandomState(6).randn(12).astype(np.float32)
    logits = np.tile(row, (n, 1))
    scaled = torch.tensor(row / temp)
    keep = nucleus_keep(scaled, top_p)
    probs = torch.softmax(scaled.masked_fill(~keep, float("-inf")),
                          -1).numpy().astype(np.float64)
    tok = Sampling(top_p, temp)(torch.tensor(logits), ctx=OpContext(
        generator=torch.Generator().manual_seed(0))).numpy()
    jtok = np.asarray(JSampling(top_p, temp).lower(
        JCtx(rng=jax.random.PRNGKey(0)), [logits], {})[0])
    bound = 5 * np.sqrt(n * probs * (1 - probs)) + 1
    for draws in (tok, jtok):
        counts = np.bincount(draws, minlength=12)
        assert (np.abs(counts - n * probs) <= bound).all(), counts
        assert counts[~keep.numpy()].sum() == 0


def test_cache_op_replays_stored_value():
    from flexflow_tpu.ops.misc import Cache as JCache
    from flexflow_tpu_torch.ops.misc import Cache

    x1 = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    x2 = x1 + 1.0
    jctx = JCtx()
    jop = JCache()
    (j1,) = jop.lower(jctx, [x1], {})
    op = Cache()
    assert op.attr_signature() == jop.attr_signature()
    ctx = OpContext()
    out1 = op(torch.tensor(x1), ctx=ctx)
    np.testing.assert_array_equal(out1.numpy(), np.asarray(j1))
    use = OpContext(extras={"cache_use": True}, state=ctx.state_out)
    out2 = op(torch.tensor(x2), ctx=use)
    np.testing.assert_array_equal(out2.numpy(), x1)
    assert use.state_out is ctx.state_out
    with pytest.raises(ValueError, match="refresh"):
        Cache()(torch.tensor(x2), ctx=OpContext(extras={"cache_use": True}))
    with pytest.raises(ValueError):
        JCache().lower(JCtx(extras={"cache_use": True}), [x2], {})
    # outside a stateful step the op is the identity
    np.testing.assert_array_equal(Cache()(torch.tensor(x2)).numpy(), x2)


@pytest.mark.parametrize("shape", [{"dp": 1}, {"dp": 2}],
                         ids=["one_device", "dp2"])
def test_cache_through_stateful_forward(shape):
    n = shape["dp"]
    x1 = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    x2 = x1 * -3.0
    models = []
    for pkg in (J, T):
        mesh = (J.make_mesh(shape, jax.devices()[:n]) if pkg is J
                else T.make_mesh(shape, ["cpu"] * n))
        m = pkg.FFModel(pkg.FFConfig(batch_size=4), mesh=mesh)
        c = m.cache(m.create_tensor((4, 8)), name="feat_cache")
        out = m.dense(c, 8, use_bias=False, name="head")
        strategy = ({"feat_cache": {"sample": ("dp",)},
                     "head": {"sample": ("dp",)}} if n > 1 else {})
        m.compile(outputs=[out], loss_type="identity", strategy=strategy)
        models.append(m)
    jm, tm = models
    tm.load_params({k: {p: np.asarray(v) for p, v in g.items()}
                    for k, g in jm.params.items()})
    from flexflow_tpu.core.interpreter import build_forward as jbuild

    jf = jbuild(jm.plan, mode="spmd")
    tid = jm.graph.input_tids[0]
    (j1,), jst = jf(jm.params, {tid: x1}, state={}, extras={})
    (j2,), _ = jf(jm.params, {tid: x2}, state=jst,
                  extras={"cache_use": True})
    fwd = build_forward(tm.plan)
    with torch.no_grad():
        (o1,), st = fwd(place_inputs(tm.plan, {tid: x1}), state={},
                        extras={})
        (o2,), st2 = fwd(place_inputs(tm.plan, {tid: x2}), state=st,
                         extras={"cache_use": True})
        (o3,), _ = fwd(place_inputs(tm.plan, {tid: x2}), state=st2,
                       extras={})
    np.testing.assert_allclose(o1.numpy(), np.asarray(j1), **TOL)
    np.testing.assert_allclose(o2.numpy(), np.asarray(j2), **TOL)
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), rtol=0, atol=0)
    assert not np.allclose(o3.numpy(), o1.numpy())   # refreshed again
    cached = st["feat_cache"]
    if n == 1:
        np.testing.assert_array_equal(cached["cached"].numpy(), x1)
    else:   # each shard keeps its own block
        assert len(cached) == n
        np.testing.assert_array_equal(
            torch.cat([c["cached"] for c in cached]).numpy(), x1)
    # without state the step returns the outputs alone
    (o4,) = fwd(place_inputs(tm.plan, {tid: x2}))
    np.testing.assert_allclose(o4.detach().numpy(), o3.numpy(), rtol=0,
                               atol=0)
