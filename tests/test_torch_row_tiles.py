"""The row-grouped bf16 K1 and K3 per-token kernels' arithmetic, on the CPU.

The bf16 ``decode_attention`` and ``tree_attention`` kernels run on the card
only.  They group flat tokens by cache row (the row plan), walk each row's
keys in the splits of ``tree_split_plan`` and merge the splits.  What they
compute differently from the plain versions is checked here, at the TINY
size, from numpy inputs made from a seed:

* ``row_plan_plain`` places every (token, query head) in exactly one chunk
  of at most ``ROW_TILE`` rows (bf16; ``TF32_ROW_TILE`` in float32), each
  chunk on one cache row, within the chunk table's capacity;
* the plain split passes and the merge equal the unsplit plain versions in
  float32 (``atol=rtol=2e-5``: the same sums, split and rescaled), with
  zeros and no NaN on tree rows with no live key;
* an emulation of the kernels' bf16 order (the row plan's chunks, 64-key
  blocks, online softmax in base 2, the ALiBi bias in base 2, P rounded to
  bfloat16 before P.V, splits merged) agrees with the Pallas kernels in
  interpret mode at ``atol=rtol=1e-2``, the bfloat16 tolerance the card is
  held to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas import attention as jatt
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import alibi_slopes
from flexflow_tpu_torch.serve.ops import kv_quant
from test_torch_tiles import (  # noqa: F401  (the fixture is autouse)
    BLOCK, LOG2E, NEG, _attend_blocks, _bf16, _one_thread, _pallas_pair,
    _quant_pair)

TILE = att.ROW_TILE


# ---------------------------------------------------------------------------
# (a) the row plan
# ---------------------------------------------------------------------------
def _plan_case(case):
    """(rows, r1, gq, tile) of one grouping case; the last row is the
    scratch row that pads use."""
    rng = np.random.default_rng(len(case))
    if case == "scattered":       # one row's tokens spread through the batch
        rows = [2, 0, 2, 1, -1, 2, 3, 0, 2, 9, 1, 2]    # -1, 9: clamped
        return rows, 4, 3, TILE
    if case == "over_tile":       # 70 tokens of row 1: two chunks of 64 + 6
        rows = rng.permutation([1] * 70 + [0] * 5 + [2] * 3).tolist()
        return rows, 3, 1, TILE
    if case == "empty_rows":      # rows 0, 2, 3 and 5 hold no token
        return [4, 1, 4, 4, 1, 6, 6], 7, 6, TILE
    if case == "tf32_scattered":  # f32 chunks of 16: 5 tokens of row 2 at gq
        # 3 straddle a chunk boundary, and row 1's 18 tokens take two
        rows = rng.permutation([2] * 6 + [1] * 18 + [0, 3, 3]).tolist()
        return rows, 4, 3, att.TF32_ROW_TILE
    if case == "tf32_71_heads":   # Falcon-7B's group: 5 chunks a token
        return [0, 2, 1, 2, 2], 3, 71, att.TF32_ROW_TILE
    return [5] * 40, 6, 6, TILE   # all pads: 240 folded rows, 4 chunks


@pytest.mark.parametrize("case", ["scattered", "over_tile", "empty_rows",
                                  "all_pad", "tf32_scattered",
                                  "tf32_71_heads"])
def test_row_plan_covers_each_token_head_once(case):
    rows_l, r1, gq, tile = _plan_case(case)
    rows = torch.tensor(rows_l, dtype=torch.int32)
    t = len(rows_l)
    perm, chunks = att.row_plan_plain(rows, r1, gq, tile)
    clamped = rows.long().clamp(0, r1 - 1)
    assert sorted(perm.tolist()) == list(range(t))
    # sorted by row, stably: token index ascending within a row
    keys = [(int(clamped[p]), int(p)) for p in perm]
    assert keys == sorted(keys)
    cap = att.row_chunk_capacity(t, gq, r1, tile)
    assert chunks.shape == (cap, 2)
    used = [(f0, n) for f0, n in chunks.tolist() if n]
    assert len(used) <= cap
    # the unused entries are (0, 0), after the used ones
    assert chunks[len(used):].abs().sum() == 0
    seen = []
    for f0, n in used:
        assert 1 <= n <= tile
        f = torch.arange(f0, f0 + n)
        toks = perm[f // gq]
        assert len(set(clamped[toks].tolist())) == 1     # one cache row
        seen += [(int(a), int(b)) for a, b in zip(toks, f % gq)]
    assert sorted(seen) == [(a, b) for a in range(t) for b in range(gq)]


# ---------------------------------------------------------------------------
# (b) split, then merge == unsplit (plain versions, float32)
# ---------------------------------------------------------------------------
S_SPLIT = 640                # three splits of 4, 4 and 2 blocks
KV, D = 2, 8
# K1 tokens: rows scattered through the batch (row 4 the scratch row of the
# pads, at position 0); positions on the block and split boundaries
K1_ROWS = [1, 3, 1, 0, 4, 1, 2, 4, 3, 1, 4, 0]
K1_POS = [0, 63, 64, 255, 0, 256, 257, 0, S_SPLIT - 1, 511, 0, 512]
# K3 tokens: committed depths on the boundaries; pads (row 4, depth 0,
# empty mask) at 5 and 9
K3_ROWS = [0, 1, 0, 2, 3, 4, 1, 0, 3, 4]
K3_CLENS = [0, 1, 63, 64, 65, 0, 256, 257, S_SPLIT, 0]


def _variant(kc, vc, variant, page=BLOCK):
    """(k, v, cache kwargs) of a logical cache in ``variant``."""
    kw = {}
    if variant.startswith("int8"):
        kc, ks = kv_quant(kc)
        vc, vs = kv_quant(vc)
        kw = dict(k_scale=ks, v_scale=vs)
    if variant.endswith("paged"):
        r1, _, s = kc.shape[:3]
        table = torch.from_numpy(np.random.RandomState(4).permutation(
            r1 * (s // page)).astype(np.int32).reshape(r1, -1))
        kc, vc = (att.page_layout(c, table, page) for c in (kc, vc))
        kw = {k: att.page_layout(v, table, page) for k, v in kw.items()}
        kw.update(page_table=table, page_size=page)
    return kc, vc, kw


def _f32(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("variant,gq,alibi", [
    ("fp", 1, False), ("int8", 3, True), ("paged", 6, True),
    ("int8+paged", 1, True)])
def test_decode_split_then_merge_equals_unsplit(variant, gq, alibi):
    rng = np.random.default_rng(gq)
    t, qh = len(K1_ROWS), KV * gq
    q = _f32(rng, t, qh, D)
    kc, vc, kw = _variant(_f32(rng, 5, KV, S_SPLIT, D),
                          _f32(rng, 5, KV, S_SPLIT, D), variant)
    if alibi:
        kw["slopes"] = alibi_slopes(qh, "cpu")
    args = (q, kc, vc, torch.tensor(K1_ROWS, dtype=torch.int32),
            torch.tensor(K1_POS, dtype=torch.int32), D ** -0.5)
    want = att.decode_attention_plain(*args, **kw)
    m, l, acc = att.decode_split_partials_plain(*args, **kw)
    assert m.shape == (att.tree_split_plan(S_SPLIT)[0], t, qh)
    # a split past a token's position holds no live key of it
    pos = torch.tensor(K1_POS)
    assert (m[1:, pos < 256] == NEG).all() and (m[2, pos < 512] == NEG).all()
    got = att.merge_partials_plain(m, l, acc)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _tree_args(rng, variant, gq, s=S_SPLIT, pb=8):
    t, qh = len(K3_ROWS), KV * gq
    q = _f32(rng, t, qh, D)
    kc, vc, kw = _variant(_f32(rng, 5, KV, s, D), _f32(rng, 5, KV, s, D),
                          variant)
    amask = torch.from_numpy(rng.random((t, pb)) < 0.4)
    amask[:, 0] = True
    pads = torch.tensor(K3_ROWS) == 4
    amask[pads] = False
    args = (q, kc, vc, _f32(rng, 5, KV, pb, D), _f32(rng, 5, KV, pb, D),
            torch.tensor(K3_ROWS, dtype=torch.int32),
            torch.tensor(K3_CLENS, dtype=torch.int32), amask, D ** -0.5)
    return args, kw, pads


@pytest.mark.parametrize("variant,gq", [("fp", 1), ("int8", 3),
                                        ("paged", 6)])
def test_tree_token_split_then_merge_equals_unsplit(variant, gq):
    args, kw, pads = _tree_args(np.random.default_rng(10 + gq), variant, gq)
    want = att.tree_attention_plain(*args, **kw)
    m, l, acc = att.tree_token_split_partials_plain(*args, **kw)
    got = att.merge_partials_plain(m, l, acc)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert not got[pads].abs().sum()              # no live key: zeros


# ---------------------------------------------------------------------------
# (c) the kernels' bf16 order vs Pallas (interpret)
# ---------------------------------------------------------------------------
def _emulate(q, kc, vc, ksc, vsc, rows, lens, scale, slopes=None,
             spec=None):
    """The bf16 flat-token kernels' order: for each chunk of the row plan,
    KV head and split, a block walk over the split's blocks below the
    chunk's largest key limit (K3's last split then the spec block under
    the mask); each row keeps the partial of a split holding one of its
    live keys; the partials merged in base 2.  K1: ``lens`` positions,
    ``slopes`` ALiBi; K3: ``lens`` committed depths, ``spec`` (sk, sv,
    amask)."""
    t, qh, d = q.shape
    r1, kv, s, _ = kc.shape
    gq = qh // kv
    n_split, per = att.tree_split_plan(s)
    sbk = per * BLOCK
    tree = spec is not None
    lens = lens.long()
    lim = lens.clamp(0, s) if tree else lens.clamp(0, s - 1) + 1
    perm, chunks = att.row_plan_plain(rows, r1, gq)
    m = torch.full((n_split, t, qh), NEG)
    l = torch.zeros(n_split, t, qh)
    acc = torch.zeros(n_split, t, qh, d)
    for f0, n in chunks.tolist():
        if not n:
            continue
        f = torch.arange(f0, f0 + n)
        tok, g = perm[f // gq], f % gq
        row = int(rows[tok[0]].clamp(0, r1 - 1))
        lim_r = lim[tok]
        nb_c = -(-int(lim_r.max()) // BLOCK)
        nsc = ((lim_r + sbk - 1) // sbk).clamp(max=n_split)
        for h in range(kv):
            head = h * gq + g
            for j in range(n_split):
                lo = min(j * per, nb_c)
                hi = min(lo + per, nb_c)
                last = tree and j == n_split - 1
                if hi == lo and not last:
                    continue
                keys = torch.arange(lo * BLOCK, hi * BLOCK)
                bias = None
                if slopes is not None:
                    bias = (slopes[head] * LOG2E)[:, None] * (
                        keys[None, :].float() - lens[tok][:, None].float())
                st = _attend_blocks(
                    q[tok, head], kc[row, h, keys], vc[row, h, keys],
                    None if ksc is None else ksc[row, h, keys],
                    None if vsc is None else vsc[row, h, keys],
                    keys[None, :] < lim_r[:, None], scale, bias=bias)
                if last:
                    sk, sv, amask = spec
                    st = _attend_blocks(q[tok, head], sk[row, h], sv[row, h],
                                        None, None, amask[tok], scale, st)
                mine = (j < nsc) | last
                m[j, tok[mine], head[mine]] = st[0][mine]
                l[j, tok[mine], head[mine]] = st[1][mine]
                acc[j, tok[mine], head[mine]] = st[2][mine]
    mx = m.amax(0)
    w = torch.where(m == NEG, torch.zeros_like(m), torch.exp2(m - mx))
    return (acc * w[..., None]).sum(0) / \
        (l * w).sum(0).clamp_min(1e-30)[..., None]


S_BF = 576                    # three splits of 4, 4 and 1 blocks
PAGE = 64


def _bf16_caches(rng, variant, r1, kv, s, d):
    """(Pallas kwargs, caches for Pallas, torch f32 logical caches and
    scales) of a bf16 cache in ``variant``."""
    kc_j, kc_t = _pallas_pair(rng, (r1, kv, s, d))
    vc_j, vc_t = _pallas_pair(rng, (r1, kv, s, d))
    jkw, ksc, vsc = {}, None, None
    if variant.startswith("int8"):
        kc_j, ks_j, kc_t, ksc = _quant_pair(kc_j)
        vc_j, vs_j, vc_t, vsc = _quant_pair(vc_j)
        jkw = dict(k_scale=ks_j, v_scale=vs_j)
    if variant.endswith("paged"):
        table = torch.from_numpy(np.random.RandomState(7).permutation(
            r1 * (s // PAGE)).astype(np.int32).reshape(r1, -1))

        def phys(x_j):
            x = torch.from_numpy(np.array(x_j.astype(jnp.float32)))
            return jnp.asarray(att.page_layout(x, table, PAGE).numpy(),
                               x_j.dtype)

        kc_j, vc_j = phys(kc_j), phys(vc_j)
        jkw = {k: phys(v) for k, v in jkw.items()}
        jkw.update(page_table=jnp.asarray(table.numpy()), page_size=PAGE)
    return jkw, kc_j, vc_j, kc_t, vc_t, ksc, vsc


@pytest.mark.parametrize("variant,gq,alibi", [
    ("fp", 3, True), ("int8", 1, False), ("int8+paged", 2, True)])
def test_decode_bf16_order_matches_pallas(variant, gq, alibi):
    """A row of 30 prompt tokens at consecutive positions (an ALiBi
    prefill: with gq 3, 90 folded rows in two chunks), scattered tokens of
    other rows on block and split boundaries, pads on the scratch row."""
    rng = np.random.default_rng(20 + gq)
    kv, d, r1 = 2, 16, 4
    qh = kv * gq
    rows = [0] * 30 + [1, 3, 2, 1, 3, 2, 1]
    pos = list(range(200, 230)) + [63, 0, 64, 256, 0, S_BF - 1, 511]
    order = rng.permutation(len(rows))             # spread through the batch
    rows = np.array(rows, np.int32)[order]
    pos = np.array(pos, np.int32)[order]
    q_j, q_t = _pallas_pair(rng, (len(rows), qh, d))
    jkw, kc_j, vc_j, kc_t, vc_t, ksc, vsc = _bf16_caches(
        rng, variant, r1, kv, S_BF, d)
    scale = 1.0 / np.sqrt(d)
    slopes = alibi_slopes(qh, "cpu") if alibi else None
    if alibi:
        jkw.update(slopes=jnp.asarray(slopes.numpy()), use_alibi=True)
    want = jatt.decode_attention(q_j, kc_j, vc_j, jnp.asarray(rows),
                                 jnp.asarray(pos), scale, block_s=64,
                                 interpret=True, **jkw)
    got = _emulate(q_t, kc_t, vc_t, ksc, vsc, torch.from_numpy(rows),
                   torch.from_numpy(pos), scale, slopes=slopes)
    np.testing.assert_allclose(_bf16(got).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("variant,gq", [("fp", 1), ("int8+paged", 2)])
def test_tree_token_bf16_order_matches_pallas(variant, gq):
    """Requests of a 7-token tree scattered through the batch, committed
    depths on block and split boundaries, pads (scratch row, depth 0,
    empty mask) giving zeros."""
    rng = np.random.default_rng(30 + gq)
    kv, d, r1, pb = 2, 16, 4, 8
    qh = kv * gq
    clen_of = {0: 1, 1: 256, 2: S_BF}
    rows = np.array([i // 7 for i in range(21)] + [3] * 5, np.int32)
    rows = rows[rng.permutation(len(rows))]
    clens = np.array([clen_of.get(r, 0) for r in rows], np.int32)
    t = len(rows)
    q_j, q_t = _pallas_pair(rng, (t, qh, d))
    jkw, kc_j, vc_j, kc_t, vc_t, ksc, vsc = _bf16_caches(
        rng, variant, r1, kv, S_BF, d)
    sk_j, sk_t = _pallas_pair(rng, (r1, kv, pb, d))
    sv_j, sv_t = _pallas_pair(rng, (r1, kv, pb, d))
    amask = rng.random((t, pb)) < 0.4
    amask[:, 0] = True
    amask[rows == 3] = False
    scale = 1.0 / np.sqrt(d)
    want = jatt.tree_attention(
        q_j, kc_j, vc_j, sk_j, sv_j, jnp.asarray(rows), jnp.asarray(clens),
        jnp.asarray(amask), scale, block_s=64, interpret=True, **jkw)
    got = _emulate(q_t, kc_t, vc_t, ksc, vsc, torch.from_numpy(rows),
                   torch.from_numpy(clens), scale,
                   spec=(sk_t, sv_t, torch.from_numpy(amask)))
    assert torch.isfinite(got).all() and not got[rows == 3].abs().sum()
    np.testing.assert_allclose(_bf16(got).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
