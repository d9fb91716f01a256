"""K1 with ALiBi slopes and any group size, plain version vs the Pallas
kernel, on the CPU.

``decode_attention_plain`` with slopes against the Pallas
``decode_attention(..., slopes, use_alibi=True, interpret=True)`` for fp
and int8 caches, contiguous and paged, at 1, 4 and 12 query heads per KV
head, float32 ``atol=rtol=1e-5`` (as ``tests/test_pallas_attention.py:60``);
``alibi_slopes`` for 1-16 heads and powers of two to 64 with counts between
them; the wrapper refuses slopes of the wrong shape or dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas import attention as jatt
from flexflow_tpu.serve.ops import alibi_slopes as jax_alibi_slopes
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import alibi_slopes

from test_torch_int8 import PAGE, _quantize, _to_pages
# _one_thread: the autouse fixture that runs these tests single-threaded
from test_torch_serve import _one_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def test_alibi_slopes_match_reference():
    # every count to 16, then powers of two and the counts between them
    for n in [*range(1, 17), 20, 24, 31, 32, 33, 48, 63, 64]:
        np.testing.assert_allclose(alibi_slopes(n).numpy(),
                                   np.asarray(jax_alibi_slopes(n)),
                                   rtol=1e-7, atol=0)


@pytest.mark.parametrize("variant", ["fp", "int8", "paged", "int8+paged"])
@pytest.mark.parametrize("gq", [1, 4, 12])
def test_decode_alibi_plain_matches_pallas(variant, gq):
    rng = np.random.default_rng(gq)
    kv, d, s, r = 2, 8, 2 * PAGE, 3
    qh = kv * gq
    caches = [rng.normal(size=(r + 1, kv, s, d)).astype(np.float32)
              for _ in range(2)]
    kw = {}
    if variant.startswith("int8"):
        (kq, ks), (vq, vs) = (_quantize(c) for c in caches)
        caches = [kq, vq]
        kw = dict(k_scale=ks, v_scale=vs)
    if variant.endswith("paged"):
        table = np.random.RandomState(3).permutation(
            (r + 1) * (s // PAGE)).astype(np.int32).reshape(r + 1, -1)
        caches = [_to_pages(c, table) for c in caches]
        kw = {k: _to_pages(v, table) for k, v in kw.items()}
        kw.update(page_table=table)
    q = rng.normal(size=(6, qh, d)).astype(np.float32)
    rows = np.array([0, 1, 2, 1, 0, 3], np.int32)
    pos = np.array([5, 70, 0, s - 1, PAGE, 0], np.int32)
    slopes = alibi_slopes(qh)
    scale = 1.0 / np.sqrt(d)
    page = PAGE if "page_table" in kw else 0
    want = jatt.decode_attention(
        *map(jnp.asarray, (q, *caches, rows, pos)), scale,
        slopes=jnp.asarray(slopes.numpy()), use_alibi=True, block_s=32,
        interpret=True, page_size=page,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = att.decode_attention(
        *map(torch.from_numpy, (q, *caches, rows, pos)), scale,
        page_size=page, slopes=slopes,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    no_alibi = att.decode_attention(
        *map(torch.from_numpy, (q, *caches, rows, pos)), scale,
        page_size=page, **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert not torch.allclose(got, no_alibi)


def test_decode_wrapper_refuses_bad_slopes():
    q = torch.zeros(2, 4, 8)
    kc = torch.zeros(2, 2, 16, 8)
    idx = torch.zeros(2, dtype=torch.int32)
    for bad in (torch.zeros(3), torch.zeros(4, dtype=torch.float64),
                torch.zeros(2, 2)):
        with pytest.raises(ValueError, match="slopes"):
            att.decode_attention(q, kc, kc, idx, idx, 1.0, slopes=bad)
