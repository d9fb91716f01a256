"""The port's SpecInfer kernel and tree steps vs the JAX serve stack, on
the CPU (the serving loops: ``test_torch_spec_serve.py``).

* the tree-attention plain versions against the JAX Pallas tree kernel in
  interpret mode (every token) and the JAX gather formulation (tokens
  with a live key), float32 ``atol=rtol=1e-5``; bfloat16 ``1e-2`` (both
  sides round the output to bfloat16);
* a TreeSearch step and a TreeVerify step with a commit descriptor, port
  against JAX (its gather path and its Pallas kernel in interpret mode):
  logits at the real tokens and the caches and spec buffers after each
  step, ``atol=rtol=1e-5``.

The JAX side is ``test_serve.make_im`` (TINY Llama); its params reach the
port through ``params_from_jax``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.attention import (
    tree_attention as jax_tree_attention,
)
from flexflow_tpu.ops.pallas.attention import (
    tree_attention_batched as jax_tree_attention_batched,
)
from flexflow_tpu.serve import ServeModelConfig as JaxServeModelConfig
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.batch_config import (
    TreeSearchBatchConfig as JaxTreeSearchBatchConfig,
)
from flexflow_tpu.serve.batch_config import (
    TreeVerifyBatchConfig as JaxTreeVerifyBatchConfig,
)
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import (
    BatchConfig,
    InferenceManager,
    ServeModelConfig,
    TreeSearchBatchConfig,
    TreeVerifyBatchConfig,
    build_model,
    params_from_jax,
)

from test_pallas_attention import ref_tree_attention
from test_serve import TINY, make_im

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
CFG = ServeModelConfig(**dataclasses.asdict(TINY))
JAX_SSM = JaxServeModelConfig(
    model_type="llama", vocab_size=TINY.vocab_size, hidden_size=16,
    intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
    num_key_value_heads=2)
SSM = ServeModelConfig(**dataclasses.asdict(JAX_SSM))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch CPU tensor."""
    j = jnp.asarray(a, jnp.dtype(dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def port_im(jim, cfg=CFG, max_spec=0, topk=0):
    """A port InferenceManager (CPU) with the JAX manager's params and
    capacities."""
    params = {n: {k: np.asarray(v) for k, v in g.items()}
              for n, g in jim.params.items()}
    im = InferenceManager(build_model(cfg), max_requests=jim.max_requests,
                          max_tokens_per_batch=jim.max_tokens,
                          max_seq_len=jim.max_seq_len, device="cpu",
                          max_spec_tokens=max_spec, topk=topk)
    return im.init_operators_inference(params_from_jax(params, cfg, "cpu"))


# ---------------------------------------------------------------------------
# K3: the plain versions vs the Pallas kernel (interpret) and the gather path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kv,d,s,p,block", [
    (4, 2, 8, 32, 8, 16),    # GQA
    (4, 4, 8, 32, 8, 32),    # MHA, single block
    (8, 1, 16, 64, 16, 16),  # MQA, deeper tree buffer
    (4, 2, 8, 40, 8, 16),    # non-dividing seq len
])
def test_tree_attention_plain_matches_pallas(dtype, qh, kv, d, s, p, block):
    rng = np.random.default_rng(2)
    t, r = 8, 3
    q, q_t = _pair(rng.normal(size=(t, qh, d)), dtype)
    kc, kc_t = _pair(rng.normal(size=(r + 1, kv, s, d)), dtype)
    vc, vc_t = _pair(rng.normal(size=(r + 1, kv, s, d)), dtype)
    sk, sk_t = _pair(rng.normal(size=(r + 1, kv, p, d)), dtype)
    sv, sv_t = _pair(rng.normal(size=(r + 1, kv, p, d)), dtype)
    # row 3 is the scratch row; committed depths 0 (pure tree), mid, S;
    # the last token is a pad: scratch row, depth 0, empty mask
    rows = np.array([0, 0, 1, 2, 1, 0, 3, 3], np.int32)
    clens = np.array([5, 5, 0, s, 0, 17, 0, 0], np.int32)
    amask = rng.random((t, p)) < 0.4
    amask[:, 0] = True
    amask[-1] = False
    scale = 1.0 / np.sqrt(d)
    want = jax_tree_attention(q, kc, vc, sk, sv, jnp.asarray(rows),
                              jnp.asarray(clens), jnp.asarray(amask), scale,
                              block_s=block, interpret=True)
    got = att.tree_attention(q_t, kc_t, vc_t, sk_t, sv_t,
                             torch.from_numpy(rows), torch.from_numpy(clens),
                             torch.from_numpy(amask), scale)
    assert got.dtype == q_t.dtype and got.shape == (t, qh, d)
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
    assert not got[-1].any()       # no live key: zeros, not a uniform mean
    gather = ref_tree_attention(q, kc, vc, sk, sv, jnp.asarray(rows),
                                jnp.asarray(clens), jnp.asarray(amask), scale)
    np.testing.assert_allclose(got[:-1], np.asarray(
        gather.astype(jnp.float32))[:-1], **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kv,d,s,p,pb", [
    (4, 2, 8, 32, 4, 8),    # GQA, tree smaller than buffer
    (8, 1, 16, 64, 3, 8),   # MQA, odd tree size
])
def test_tree_attention_batched_plain_matches_pallas(dtype, qh, kv, d, s, p,
                                                     pb):
    rng = np.random.default_rng(5)
    r = 3
    q, q_t = _pair(rng.normal(size=(r, p, qh, d)), dtype)
    kc, kc_t = _pair(rng.normal(size=(r + 1, kv, s, d)), dtype)
    vc, vc_t = _pair(rng.normal(size=(r + 1, kv, s, d)), dtype)
    sk, sk_t = _pair(rng.normal(size=(r + 1, kv, pb, d)), dtype)
    sv, sv_t = _pair(rng.normal(size=(r + 1, kv, pb, d)), dtype)
    rows = np.array([0, 2, 3], np.int32)       # incl. the scratch row
    clens = np.array([7, 0, s], np.int32)
    amask = rng.random((r, p, pb)) < 0.4
    amask[:, :, 0] = True
    scale = 1.0 / np.sqrt(d)
    want = jax_tree_attention_batched(
        q, kc, vc, sk, sv, jnp.asarray(rows), jnp.asarray(clens),
        jnp.asarray(amask), scale, block_s=16, interpret=True)
    got = att.tree_attention_batched(
        q_t, kc_t, vc_t, sk_t, sv_t, torch.from_numpy(rows),
        torch.from_numpy(clens), torch.from_numpy(amask), scale)
    assert got.dtype == q_t.dtype and got.shape == (r, p, qh, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_plain_tree_attention_chunks_like_one_gather(monkeypatch):
    """The plain version bounds its gather by chunking tokens; the chunked
    result is the unchunked one."""
    rng = np.random.default_rng(3)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    q, kc, vc, sk, sv = (f(9, 4, 8), f(3, 2, 16, 8), f(3, 2, 16, 8),
                         f(3, 2, 4, 8), f(3, 2, 4, 8))
    rows = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1, 2], dtype=torch.int32)
    clens = torch.tensor([0, 3, 16, 7, 8, 0, 2, 9, 1], dtype=torch.int32)
    amask = torch.from_numpy(rng.random((9, 4)) < 0.5)
    whole = att.tree_attention_plain(q, kc, vc, sk, sv, rows, clens, amask,
                                     0.3)
    monkeypatch.setattr(att, "_GATHER_ELEMS", 2 * 20 * 8 * 2)  # 2 tokens
    torch.testing.assert_close(
        att.tree_attention_plain(q, kc, vc, sk, sv, rows, clens, amask, 0.3),
        whole, atol=0, rtol=0)


def test_cpu_tree_tensors_take_the_plain_version_without_launching():
    q = torch.randn(2, 4, 8)
    kc = torch.randn(2, 2, 16, 8)
    sk = torch.randn(2, 2, 4, 8)
    idx = torch.zeros(2, dtype=torch.int32)
    amask = torch.ones(2, 4, dtype=torch.bool)
    n0 = (att.tree_attention.launches, att.tree_attention_batched.launches)
    att.tree_attention(q, kc, kc, sk, sk, idx, idx, amask, 1.0)
    att.tree_attention_batched(q[:, None], kc, kc, sk, sk, idx, idx,
                               amask[:, None], 1.0)
    assert (att.tree_attention.launches,
            att.tree_attention_batched.launches) == n0
    with pytest.raises(ValueError, match="several devices"):
        att.tree_attention(q, kc, kc, sk.to("meta"), sk, idx, idx, amask,
                           1.0)


# ---------------------------------------------------------------------------
# tree steps: port vs JAX, logits and caches
# ---------------------------------------------------------------------------
def _jax_step(jim, bc, layout=None):
    """The JAX step's float32 logits (its caches advance too)."""
    base = bc if isinstance(bc, JaxBatchConfig) else bc.base
    outs, state = jim._fwd(
        jim.params, {jim._token_tid: base.tokens}, state=jim.state,
        extras={"batch_config": bc, "pallas_decode": jim.use_pallas,
                "pallas_interpret": jim.pallas_interpret,
                "tree_layout": layout, "qkv0": None, "pages": None})
    jim.state = state
    return np.asarray(outs[0].astype(jnp.float32))


def _both_tree_bcs(kind, toks, reqi, pos, seq_lens, spec, masks, committed,
                   commit=(), max_tokens=16, layout=None):
    """The same tree step as a JAX and a port batch config."""
    n = max_tokens
    si = np.zeros(n, np.int32)
    si[: len(spec)] = spec
    fields = [si, masks, np.asarray(committed, np.int32)]
    if kind == "verify":
        cri = np.full(n, -1, np.int32)
        csi = np.zeros(n, np.int32)
        cdp = np.zeros(n, np.int32)
        for i, (slot, src, dst) in enumerate(commit):
            cri[i], csi[i], cdp[i] = slot, src, dst
        fields += [cri, csi, cdp]
    args = (toks, reqi, pos, seq_lens)
    jcls, tcls = ((JaxTreeSearchBatchConfig, TreeSearchBatchConfig)
                  if kind == "search" else
                  (JaxTreeVerifyBatchConfig, TreeVerifyBatchConfig))
    jbc = jcls(JaxBatchConfig.build(*args, max_tokens=n, max_requests=2),
               *(jnp.asarray(f) for f in fields))
    kw = {"tree_layout": layout} if layout else {}
    tbc = tcls(BatchConfig.build(*args, max_tokens=n, max_requests=2,
                                 device="cpu"),
               *(torch.from_numpy(f.copy()) for f in fields), **kw)
    return jbc, tbc


def _assert_state_close(tim, jim):
    r = jim.max_requests   # row r is the scratch row: pads only
    for name, bufs in jim.state.items():
        for buf in ("k", "v", "sk", "sv"):
            np.testing.assert_allclose(
                tim.state[name][buf][:r].numpy(),
                np.asarray(bufs[buf])[:r], **TOL["float32"])


def _tree_masks(p, trees):
    """``trees``: {slot: parent list (root first)} -> bool[2, p, p]."""
    m = np.zeros((2, p, p), bool)
    for slot, parents in trees.items():
        for i, par in enumerate(parents):
            if par >= 0:
                m[slot, i] = m[slot, par]
            m[slot, i, i] = True
    return m


@pytest.mark.parametrize("use_pallas", [True, False])
def test_tree_search_and_verify_steps_match_reference(use_pallas):
    """Prefill, a TreeSearch step, then a TreeVerify step that commits two
    accepted nodes of slot 0 and one of slot 1: logits at the real tokens,
    caches and spec buffers after each step."""
    jim = make_im(max_tokens=16, max_requests=2, max_seq=32, max_spec=8,
                  use_pallas=use_pallas)
    tim = port_im(jim, max_spec=8)
    p0, p1 = [5, 9, 2, 11, 3], [4, 4, 8]
    args = (p0 + p1, [0] * 5 + [1] * 3, list(range(5)) + [0, 1, 2], [5, 3])
    tim.forward(BatchConfig.build(*args, max_tokens=16, max_requests=2,
                                  device="cpu"))
    _jax_step(jim, JaxBatchConfig.build(*args, max_tokens=16,
                                        max_requests=2))
    # search: slot 0 root + two children, slot 1 root
    jbc, tbc = _both_tree_bcs(
        "search", [7, 12, 30, 1], [0, 0, 0, 1], [5, 6, 6, 3], [6, 7],
        [0, 1, 2, 0], _tree_masks(8, {0: [-1, 0, 0], 1: [-1]}), [5, 3])
    np.testing.assert_allclose(tim.forward(tbc)[:4].numpy(),
                               _jax_step(jim, jbc)[:4], **TOL["float32"])
    _assert_state_close(tim, jim)
    # verify: commit slot 0's nodes 0, 1 at positions 5, 6 and slot 1's
    # root at 3, then a new tree of each
    jbc, tbc = _both_tree_bcs(
        "verify", [13, 2, 40, 9, 22], [0, 0, 0, 1, 1], [7, 8, 9, 4, 5],
        [8, 5], [0, 1, 2, 0, 1],
        _tree_masks(8, {0: [-1, 0, 1], 1: [-1, 0]}), [7, 4],
        commit=[(0, 0, 5), (0, 1, 6), (1, 0, 3)])
    got = tim.step(tbc)
    want = _jax_step(jim, jbc)
    np.testing.assert_allclose(got.logits[:5].numpy(), want[:5],
                               **TOL["float32"])
    np.testing.assert_array_equal(got.token_ids[:5].numpy(),
                                  want[:5].argmax(-1))
    _assert_state_close(tim, jim)


def test_tree_verify_batched_layout_matches_reference():
    """A verify step in the fixed [R, P] layout (the batched kernel's
    plain version) against JAX's batched Pallas kernel in interpret mode."""
    jim = make_im(max_tokens=8, max_requests=2, max_seq=32, max_spec=4,
                  use_pallas=True)
    tim = port_im(jim, max_spec=4)
    args = ([5, 9, 2, 11, 3, 4, 4, 8], [0] * 5 + [1] * 3,
            list(range(5)) + [0, 1, 2], [5, 3])
    tim.forward(BatchConfig.build(*args, max_tokens=8, max_requests=2,
                                  device="cpu"))
    _jax_step(jim, JaxBatchConfig.build(*args, max_tokens=8,
                                        max_requests=2))
    parents = [-1, 0, 0, 1]           # root, two children, a grandchild
    depth = [0, 1, 1, 2]
    jbc, tbc = _both_tree_bcs(
        "verify", [13, 2, 40, 9, 22, 6, 50, 31], [0] * 4 + [1] * 4,
        [5 + x for x in depth] + [3 + x for x in depth], [8, 6],
        [0, 1, 2, 3] * 2, _tree_masks(4, {0: parents, 1: parents}), [5, 3],
        commit=[(0, 0, 4)], max_tokens=8, layout=(2, 4))
    np.testing.assert_allclose(tim.forward(tbc).numpy(),
                               _jax_step(jim, jbc, layout=(2, 4)),
                               **TOL["float32"])
    _assert_state_close(tim, jim)
