"""The arithmetic of the bf16 tensor-core kernels, on the CPU.

The bf16 K2 (``prefill_attention``) and K3 batched (``tree_attention_batched``)
kernels run on the card only; what they compute differently from the plain
versions is checked here, at the TINY size, from numpy inputs made from a
seed:

* the split-KV plan of the K3 batched kernel covers every committed key
  exactly once, in whole 64-key blocks;
* the plain split pass and merge (the two CUDA kernels' plain versions)
  equal the unsplit plain version in float32 (``atol=rtol=2e-5``: the same
  sums, split and rescaled), with zeros and no NaN on rows with no live key;
* an emulation of the kernels' bf16 order (64-key blocks, online softmax
  in base 2, P rounded to bfloat16 before P.V, splits merged) agrees with
  the Pallas kernels in interpret mode at ``atol=rtol=1e-2``, the bfloat16
  tolerance the card is held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas import attention as jatt
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve.ops import kv_quant

BLOCK = att.PAGE_BLOCK
LOG2E = 1.4426950408889634
NEG = att.NEG_INF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the split plan
# ---------------------------------------------------------------------------
S_PLAN = 640       # 10 blocks: three splits of 4, the last one short


@pytest.mark.parametrize("clen", [0, 1, 63, 64, 65, S_PLAN])
def test_split_plan_covers_each_committed_key_once(clen):
    n_split, per = att.tree_split_plan(S_PLAN)
    assert (n_split, per) == (3, att.SPLIT_BLOCKS)
    assert n_split * per * BLOCK >= S_PLAN > (n_split - 1) * per * BLOCK
    ranges = att.split_blocks(clen, S_PLAN)
    assert len(ranges) == n_split
    seen = []
    for lo, hi in ranges:
        assert 0 <= hi - lo <= per
        seen += list(range(lo * BLOCK, hi * BLOCK))      # whole blocks
    assert len(seen) == len(set(seen))                   # none twice
    assert set(range(clen)) <= set(seen)                 # every key
    assert all(k < clen + BLOCK - 1 for k in seen)       # the last block's tail
    assert seen == sorted(seen)                          # split order = key order


# ---------------------------------------------------------------------------
# (b) split, then merge == unsplit (plain versions, float32)
# ---------------------------------------------------------------------------
def _tree_inputs(rng, s, variant, dtype=torch.float32):
    """Batched tree inputs at committed depths on the block and split
    boundaries, with a pad request (scratch row, depth 0, empty mask)."""
    qh, kv, d, p, pb = 4, 2, 8, 3, 8
    clens = np.array([0, 1, 63, 64, 65, s, 0], np.int32)
    r = len(clens)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dtype)
    q, kc, vc, sk, sv = (f(r, p, qh, d), f(r + 1, kv, s, d),
                         f(r + 1, kv, s, d), f(r + 1, kv, pb, d),
                         f(r + 1, kv, pb, d))
    amask = torch.from_numpy(rng.random((r, p, pb)) < 0.4)
    amask[:, :, 0] = True
    amask[-1] = False
    rows = torch.tensor(list(range(r - 1)) + [r], dtype=torch.int32)
    kw = {}
    if variant.startswith("int8"):
        kc, ks = kv_quant(kc)
        vc, vs = kv_quant(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    if variant.endswith("paged"):
        table = torch.from_numpy(np.random.RandomState(4).permutation(
            (r + 1) * (s // BLOCK)).astype(np.int32).reshape(r + 1, -1))
        kc, vc = (att.page_layout(c, table, BLOCK) for c in (kc, vc))
        kw = {k: att.page_layout(v, table, BLOCK) for k, v in kw.items()}
        kw.update(page_table=table, page_size=BLOCK)
    args = (q, kc, vc, sk, sv, rows, torch.from_numpy(clens), amask,
            1.0 / np.sqrt(d))
    return args, kw


@pytest.mark.parametrize("variant", ["fp", "int8+paged"])
def test_split_then_merge_equals_unsplit(variant):
    args, kw = _tree_inputs(np.random.default_rng(0), S_PLAN, variant)
    want = att.tree_attention_batched_plain(*args, **kw)
    m, l, acc = att.tree_split_partials_plain(*args, **kw)
    assert m.shape[0] == att.tree_split_plan(S_PLAN)[0]
    got = att.merge_partials_plain(m, l, acc)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert not got[-1].abs().sum()                # no live key: zeros


def test_merge_skips_splits_without_a_live_key():
    """A split with m = NEG_INF weighs 0 whatever its l and acc hold, and
    a row whose splits all have none gives zeros, not NaN."""
    m = torch.tensor([[NEG, 0.5], [1.0, NEG], [NEG, NEG]]).T   # [2, 3]
    l = torch.tensor([[9.0, 2.0], [3.0, 9.0], [9.0, 9.0]]).T
    acc = torch.full((2, 3, 4), 7.0)
    acc[1, 0] = 4.0
    acc[0, 1] = 6.0
    got = att.merge_partials_plain(m, l, acc)
    torch.testing.assert_close(got, torch.tensor(
        [[2.0] * 4, [2.0] * 4, [0.0] * 4]))


# ---------------------------------------------------------------------------
# (c) the kernels' bf16 order vs Pallas (interpret)
# ---------------------------------------------------------------------------
def _bf16(x):
    return x.to(torch.bfloat16).float()


def _attend_blocks(qr, keys, vals, ksc, vsc, live, scale, state=None,
                   bias=None):
    """One CTA's walk over 64-key blocks as the bf16 kernels do it: f32
    online softmax in base 2, scores times scale * log2 e (then times the
    int8 key's scale, then plus ``bias`` [M, N] in base 2: K1's ALiBi), P
    (int8: P * vs) rounded to bf16 before P.V.  qr [M, D], keys/vals [N, D]
    (int8 values as float), ksc/vsc [N] or None, live [M, N]; ``state`` the
    (m, l, acc) to go on from.  Returns (m, l, acc) in base 2."""
    n_rows, d = qr.shape
    m, l, acc = state or (torch.full((n_rows,), NEG), torch.zeros(n_rows),
                          torch.zeros(n_rows, d))
    for n0 in range(0, keys.shape[0], BLOCK):
        b = slice(n0, n0 + BLOCK)
        s = qr @ keys[b].T * (scale * LOG2E)
        if ksc is not None:
            s = s * ksc[b]
        if bias is not None:
            s = s + bias[:, b]
        s = s.masked_fill(~live[:, b], NEG)
        m_new = torch.maximum(m, s.amax(1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(s == NEG, torch.zeros_like(s),
                        torch.exp2(s - m_new[:, None]))
        l = l * alpha + p.sum(1)
        pv = p if vsc is None else p * vsc[b]
        acc = acc * alpha[:, None] + _bf16(pv) @ vals[b]
        m = m_new
    return m, l, acc


def _pallas_pair(rng, shape, dtype="bfloat16"):
    j = jnp.asarray(rng.normal(size=shape), jnp.dtype(dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32)))


def _quant_pair(c_j):
    """The serve path's quantizer on a bf16 cache: (int8 values, scales) as
    JAX arrays and as float torch tensors."""
    q, s = kv_quant(torch.from_numpy(np.array(c_j.astype(jnp.float32))))
    return (jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
            q.float(), s)


@pytest.mark.parametrize("variant", ["fp", "int8"])
def test_prefill_bf16_order_matches_pallas(variant):
    rng = np.random.default_rng(1)
    qh, kv, d, s, bq = 6, 2, 16, 128, 8          # 3 query heads per KV head
    q_j, q_t = _pallas_pair(rng, (3, bq, qh, d))
    kc_j, kc_t = _pallas_pair(rng, (4, kv, s, d))
    vc_j, vc_t = _pallas_pair(rng, (4, kv, s, d))
    rows = np.array([0, 3, 1], np.int32)
    pstart = np.array([bq + 5, 0, s - bq], np.int32)
    scale = 1.0 / np.sqrt(d)
    kw, ksc, vsc = {}, None, None
    if variant == "int8":
        kc_j, ks_j, kc_t, ksc = _quant_pair(kc_j)
        vc_j, vs_j, vc_t, vsc = _quant_pair(vc_j)
        kw = dict(k_scale=ks_j, v_scale=vs_j)
    want = jatt.prefill_attention(q_j, kc_j, vc_j, jnp.asarray(rows),
                                  jnp.asarray(pstart), scale, block_s=32,
                                  interpret=True, **kw)
    gq = qh // kv
    got = torch.empty(3, bq, qh, d)
    key_pos = torch.arange(s)
    for t in range(3):
        qpos = pstart[t] + torch.arange(bq * gq) // gq       # folded rows
        live = key_pos[None, :] <= qpos[:, None]
        for h in range(kv):
            qr = q_t[t, :, h * gq:(h + 1) * gq].reshape(bq * gq, d)
            r = rows[t]
            m, l, acc = _attend_blocks(
                qr, kc_t[r, h], vc_t[r, h],
                None if ksc is None else ksc[r, h],
                None if vsc is None else vsc[r, h], live, scale)
            o = acc / l.clamp_min(1e-30)[:, None]
            got[t, :, h * gq:(h + 1) * gq] = o.reshape(bq, gq, d)
    np.testing.assert_allclose(_bf16(got).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("variant", ["fp", "int8"])
def test_batched_tree_bf16_order_matches_pallas(variant):
    """Splits of the plan (S 320: two), each a block walk over its
    committed blocks (the last split then the spec block under the mask),
    merged in base 2 with the no-live-key guard."""
    rng = np.random.default_rng(2)
    qh, kv, d, s, p, pb = 4, 2, 16, 5 * BLOCK, 3, 8
    clens = np.array([0, 1, 64, 65, s, 0], np.int32)
    r = len(clens)
    rows = np.array(list(range(r - 1)) + [r], np.int32)
    q_j, q_t = _pallas_pair(rng, (r, p, qh, d))
    kc_j, kc_t = _pallas_pair(rng, (r + 1, kv, s, d))
    vc_j, vc_t = _pallas_pair(rng, (r + 1, kv, s, d))
    sk_j, sk_t = _pallas_pair(rng, (r + 1, kv, pb, d))
    sv_j, sv_t = _pallas_pair(rng, (r + 1, kv, pb, d))
    amask = rng.random((r, p, pb)) < 0.4
    amask[:, :, 0] = True
    amask[-1] = False
    scale = 1.0 / np.sqrt(d)
    kw, ksc, vsc = {}, None, None
    if variant == "int8":
        kc_j, ks_j, kc_t, ksc = _quant_pair(kc_j)
        vc_j, vs_j, vc_t, vsc = _quant_pair(vc_j)
        kw = dict(k_scale=ks_j, v_scale=vs_j)
    want = jatt.tree_attention_batched(
        q_j, kc_j, vc_j, sk_j, sv_j, jnp.asarray(rows), jnp.asarray(clens),
        jnp.asarray(amask), scale, block_s=32, interpret=True, **kw)
    gq = qh // kv
    n_split, _ = att.tree_split_plan(s)
    assert n_split == 2
    got = torch.empty(r, p, qh, d)
    mask_t = torch.from_numpy(amask)
    for i in range(r):
        row, clen = rows[i], int(clens[i])
        spec_live = mask_t[i].repeat_interleave(gq, 0)      # [P*gq, Pb]
        for h in range(kv):
            qr = q_t[i, :, h * gq:(h + 1) * gq].reshape(p * gq, d)
            parts = []
            for j, (lo, hi) in enumerate(att.split_blocks(clen, s)):
                keys = slice(lo * BLOCK, hi * BLOCK)
                n = hi * BLOCK - lo * BLOCK
                live = (torch.arange(lo * BLOCK, hi * BLOCK) < clen)[
                    None].expand(p * gq, n)
                part = _attend_blocks(
                    qr, kc_t[row, h, keys], vc_t[row, h, keys],
                    None if ksc is None else ksc[row, h, keys],
                    None if vsc is None else vsc[row, h, keys], live, scale)
                if j == n_split - 1:     # then the spec block, in the walk
                    part = _attend_blocks(qr, sk_t[row, h], sv_t[row, h],
                                          None, None, spec_live, scale, part)
                parts.append(part)
            m, l, acc = (torch.stack(x) for x in zip(*parts))
            mx = m.amax(0)
            w = torch.where(m == NEG, torch.zeros_like(m),
                            torch.exp2(m - mx))
            o = (acc * w[..., None]).sum(0) / \
                (l * w).sum(0).clamp_min(1e-30)[:, None]
            got[i, :, h * gq:(h + 1) * gq] = o.reshape(p, gq, d)
    assert torch.isfinite(got).all() and not got[-1].abs().sum()
    np.testing.assert_allclose(_bf16(got).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
