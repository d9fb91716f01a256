"""The port's layers vs the JAX op lowers on the same params and inputs.

Inputs and params are made with numpy from a seed and handed to both
packages.  Tolerances: float32 ``atol=rtol=1e-5`` (same math, summed in
another order); bfloat16 ``atol=rtol=2e-2``: both sides round to bfloat16
at the same places, but a float32 sum that lands near a rounding boundary
can round to neighbouring bfloat16 values (2**-8 relative per step, and a
GEMM output can sit two steps apart after its own rounding).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.op import OpContext
from flexflow_tpu.ops.embedding import Embedding as JaxEmbedding
from flexflow_tpu.ops.linear import Linear as JaxLinear
from flexflow_tpu.ops.norm import ResidualRMSNorm as JaxResidualRMSNorm
from flexflow_tpu.ops.norm import SigmoidSiluMulti as JaxSigmoidSiluMulti
from flexflow_tpu.ops.norm import _rms_norm as jax_rms_norm
from flexflow_tpu.serve.batch_config import BatchConfig as JaxBatchConfig
from flexflow_tpu.serve.ops import IncMultiHeadSelfAttention as JaxIncMHA
from flexflow_tpu.serve.ops import apply_rope as jax_apply_rope
from flexflow_tpu_torch.ops import norm
from flexflow_tpu_torch.ops.embedding import Embedding
from flexflow_tpu_torch.ops.linear import Linear
from flexflow_tpu_torch.serve import BatchConfig, IncMultiHeadSelfAttention
from flexflow_tpu_torch.serve.ops import apply_rope

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


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


def _close(got_t, want_j, dtype):
    assert str(got_t.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x, x_t = _pair(rng.normal(size=(6, 32)) * 3, dtype)
    g, g_t = _pair(rng.normal(size=(32,)), dtype)
    _close(norm.rms_norm(x_t, g_t, 1e-6), jax_rms_norm(x, g, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x, x_t = _pair(rng.normal(size=(6, 32)), dtype)
    r, r_t = _pair(rng.normal(size=(6, 32)), dtype)
    g, g_t = _pair(rng.normal(size=(32,)), dtype)
    want_s, want_n = JaxResidualRMSNorm(32, eps=1e-5).lower(
        OpContext(), [x, r], {"gamma": g})
    got_s, got_n = norm.residual_rms_norm(x_t, r_t, g_t, 1e-5)
    _close(got_s, want_s, dtype)
    _close(got_n, want_n, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sigmoid_silu_multi(dtype):
    rng = np.random.default_rng(2)
    a, a_t = _pair(rng.normal(size=(6, 48)) * 2, dtype)
    b, b_t = _pair(rng.normal(size=(6, 48)), dtype)
    [want] = JaxSigmoidSiluMulti().lower(OpContext(), [a, b], {})
    _close(norm.sigmoid_silu_multi(a_t, b_t), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype):
    rng = np.random.default_rng(3)
    x, x_t = _pair(rng.normal(size=(5, 2, 3, 16)), dtype)
    pos = np.array([0, 1, 7, 100, 2047], np.int32)
    _close(apply_rope(x_t, torch.from_numpy(pos), 10000.0),
           jax_apply_rope(x, jnp.asarray(pos), 10000.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding(dtype):
    rng = np.random.default_rng(4)
    w, w_t = _pair(rng.normal(size=(67, 32)), dtype)
    ids = np.array([0, 66, 5, 5, 13], np.int32)
    [want] = JaxEmbedding(67, 32, dtype=jnp.dtype(dtype)).lower(
        OpContext(), [jnp.asarray(ids)], {"weight": w})
    emb = Embedding(67, 32, dtype=getattr(torch, dtype))
    with torch.no_grad():
        emb.weight.copy_(w_t)
    _close(emb(torch.from_numpy(ids)), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense(dtype):
    rng = np.random.default_rng(5)
    x, x_t = _pair(rng.normal(size=(6, 32)), dtype)
    k, k_t = _pair(rng.normal(size=(32, 48)) / 6, dtype)
    [want] = JaxLinear(48, use_bias=False, dtype=jnp.dtype(dtype)).lower(
        OpContext(), [x], {"kernel": k})
    lin = Linear(32, 48, dtype=getattr(torch, dtype))
    with torch.no_grad():
        lin.kernel.copy_(k_t)
    _close(lin(x_t), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qh,kv", [(4, 2), (4, 4), (4, 1)])
def test_fused_qkv_project(dtype, qh, kv):
    """One GEMM for Q, K and V from the [E, KV, gq+2, D] weight, then RoPE
    on Q and K at the batch's positions (reference ops.py:359-375)."""
    rng = np.random.default_rng(6)
    e, d, t = 32, 8, 5
    x, x_t = _pair(rng.normal(size=(t, e)), dtype)
    w, w_t = _pair(rng.normal(size=(e, kv, qh // kv + 2, d)) / 6, dtype)
    fields = dict(tokens=[1, 2, 3, 4, 5], request_indices=[0, 0, 1, 1, -1],
                  positions=[0, 1, 40, 41, 0], seq_lens=[2, 42])
    jbc = JaxBatchConfig.build(fields["tokens"], fields["request_indices"],
                               fields["positions"], fields["seq_lens"],
                               max_tokens=t, max_requests=2)
    tbc = BatchConfig.build(*fields.values(), max_tokens=t, max_requests=2,
                            device="cpu")
    want = JaxIncMHA(e, qh, kv, d, dtype=jnp.dtype(dtype))._project(
        x, w, None, jbc)
    mod = IncMultiHeadSelfAttention(e, qh, kv, d,
                                    dtype=getattr(torch, dtype))
    with torch.no_grad():
        mod.qkv.copy_(w_t)
    got = mod._project(x_t, tbc)
    for g_, w_ in zip(got, want):
        assert tuple(g_.shape) == tuple(w_.shape)
        _close(g_, w_, dtype)


def test_batch_config_advance_and_prefill_fields_match_reference():
    from flexflow_tpu.serve.batch_config import (
        PrefillBatchConfig as JaxPrefillBatchConfig,
    )
    from flexflow_tpu_torch.serve import PrefillBatchConfig

    args = ([7, 8, 9], [1, -1, 0], [4, 0, 9], [10, 5], 4, 2)
    jbc = JaxBatchConfig.build(*args[:4], max_tokens=4, max_requests=2)
    tbc = BatchConfig.build(*args[:4], max_tokens=4, max_requests=2,
                            device="cpu")
    nxt_t = tbc.advance(torch.tensor([11, 12, 13, 14], dtype=torch.int32))
    nxt_j = jbc.advance(jnp.asarray([11, 12, 13, 14], jnp.int32))
    for f in dataclasses.fields(JaxBatchConfig):
        np.testing.assert_array_equal(getattr(nxt_t, f.name).numpy(),
                                      np.asarray(getattr(nxt_j, f.name)))
    segs = [(0, [1, 2, 3], 0), (1, [4, 5, 6, 7, 8], 12)]
    got, last_t = PrefillBatchConfig.np_fields(segs, [3, 17], 4, 16, 4)
    want, last_j = JaxPrefillBatchConfig.np_fields(segs, [3, 17], 4, 16, 4)
    assert last_t == last_j
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="aligned"):
        PrefillBatchConfig.np_fields([(0, [1, 2], 10)], [12], 4, 16, 4)
