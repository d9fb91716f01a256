"""The port's attention kernels (plain versions, on the CPU) vs the JAX
Pallas kernels they replace, run in interpret mode as
tests/test_pallas_attention.py and tests/test_prefill.py run them.

The same inputs, made with numpy from a seed, go to both packages.
Tolerances: float32 ``atol=rtol=1e-5`` (the same math in another order);
bfloat16 ``atol=rtol=1e-2``: both sides compute in float32 and round the
output to bfloat16, so they may land one bfloat16 step (2**-8 relative)
apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas.attention import (
    decode_attention as jax_decode_attention,
)
from flexflow_tpu.ops.pallas.attention import (
    prefill_attention as jax_prefill_attention,
)
from flexflow_tpu_torch.ops.cuda import attention as att

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}


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


def _close(got_t, want_j):
    np.testing.assert_allclose(
        got_t.float().numpy(), np.asarray(want_j.astype(jnp.float32)),
        **TOL[str(want_j.dtype)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kv,d,s,block", [
    (4, 2, 8, 32, 16),    # GQA
    (4, 4, 8, 32, 32),    # MHA, single block
    (8, 1, 16, 64, 16),   # MQA
    (4, 2, 8, 40, 16),    # seq length no block divides evenly
])
def test_decode_attention_matches_pallas(dtype, qh, kv, d, s, block):
    rng = np.random.default_rng(0)
    t, r = 7, 3
    q, q_t = _pair(rng.normal(size=(t, qh, d)), dtype)
    kc, kc_t = _pair(rng.normal(size=(r + 1, kv, s, d)), dtype)
    vc, vc_t = _pair(rng.normal(size=(r + 1, kv, s, d)), dtype)
    # row 3 is the pad tokens' scratch row; positions 0 and S-1 included
    rows = np.array([0, 1, 2, 1, 0, 3, 2], np.int32)
    pos = np.array([5, s - 1, 0, s // 2, 1, 0, s - 2], np.int32)
    scale = 1.0 / np.sqrt(d)
    want = jax_decode_attention(q, kc, vc, jnp.asarray(rows),
                                jnp.asarray(pos), scale, block_s=block,
                                interpret=True)
    got = att.decode_attention(q_t, kc_t, vc_t, torch.from_numpy(rows),
                               torch.from_numpy(pos), scale)
    assert got.dtype == q_t.dtype and got.shape == (t, qh, d)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qh,kv,d,s,bq,block", [
    (4, 2, 8, 64, 8, 16),    # GQA, several tiles
    (4, 4, 8, 32, 4, 32),    # MHA, one seq block
    (8, 1, 16, 64, 16, 16),  # MQA, whole-chunk tile
])
def test_prefill_attention_matches_pallas(dtype, qh, kv, d, s, bq, block):
    rng = np.random.default_rng(1)
    g = 3
    q, q_t = _pair(rng.normal(size=(g, bq, qh, d)), dtype)
    kc, kc_t = _pair(rng.normal(size=(4, kv, s, d)), dtype)
    vc, vc_t = _pair(rng.normal(size=(4, kv, s, d)), dtype)
    rows = np.array([0, 3, 1], np.int32)          # 3 = the scratch row
    pstart = np.array([bq, 0, s - bq], np.int32)  # mid / start / ends at S-1
    scale = 1.0 / np.sqrt(d)
    want = jax_prefill_attention(q, kc, vc, jnp.asarray(rows),
                                 jnp.asarray(pstart), scale, block_s=block,
                                 interpret=True)
    got = att.prefill_attention(q_t, kc_t, vc_t, torch.from_numpy(rows),
                                torch.from_numpy(pstart), scale)
    assert got.dtype == q_t.dtype and got.shape == (g, bq, qh, d)
    _close(got, want)


def test_plain_decode_chunks_like_one_gather(monkeypatch):
    """The plain decode version bounds its gather by chunking tokens; the
    chunked result is the unchunked one."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(9, 4, 8)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(3, 2, 16, 8)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(3, 2, 16, 8)).astype(np.float32))
    rows = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1, 2], dtype=torch.int32)
    pos = torch.tensor([0, 3, 15, 7, 8, 0, 2, 9, 1], dtype=torch.int32)
    whole = att.decode_attention_plain(q, kc, vc, rows, pos, 0.3)
    monkeypatch.setattr(att, "_GATHER_ELEMS", 2 * 16 * 8 * 2)  # 2 tokens
    torch.testing.assert_close(
        att.decode_attention_plain(q, kc, vc, rows, pos, 0.3), whole,
        atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(2, 2, 16, 8)).astype(np.float32))
    idx = torch.zeros(2, dtype=torch.int32)
    n0 = att.decode_attention.launches
    att.decode_attention(q, kc, kc, idx, idx, 1.0)
    assert att.decode_attention.launches == n0
    with pytest.raises(ValueError, match="several devices"):
        att.decode_attention(q, kc.to("meta"), kc, idx, idx, 1.0)
