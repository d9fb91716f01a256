"""The arithmetic of the float32 tensor-core kernels, on the CPU.

The float32 K2 (``prefill_attention``) and K3 batched
(``tree_attention_batched``) kernels run on the card only, as
error-compensated TF32 (``flexflow_tpu_torch/csrc/tc_attention_f32.cuh``):
each f32 operand x splits into ``hi = rna(x)`` and ``lo = rna(x - hi)``
(TF32, round to nearest with ties away from zero) and a product a . b is
taken as ``lo_a . hi_b + hi_a . lo_b + hi_a . hi_b``; int8 K/V values are
exact in TF32, so their products take ``lo . v + hi . v``.  What that
computes differently from the plain versions is checked here, at the TINY
size, from numpy inputs made from a seed:

* the rounding, emulated on the int32 view (add ``0x1000`` to the
  magnitude, clear the low 13 bits): hi is a TF32 value, x - hi - lo is
  within 2^-22 of |x|, ties round away from zero, int8 values split with
  lo = 0;
* an emulation of each kernel's order (32-key blocks, online softmax in
  base 2, the split products, P kept in f32 and split; K2: 1024-key
  splits of each tile's keys, merged; K3: four warps each on one 8-key
  column tile of every block, merged in warp order, then the splits
  merged) agrees with the Pallas kernels in interpret mode at
  ``atol=rtol=2e-5``, the float32 tolerance the card is held to, in the
  four cache variants (fp, int8, paged, int8 + paged).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas import attention as jatt
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve.ops import kv_quant

BN = 32            # keys per block of the f32 kernels
LOG2E = 1.4426950408889634
NEG = att.NEG_INF
PAGE = 64
TOL = dict(atol=2e-5, rtol=2e-5)
VARIANTS = ["fp", "int8", "paged", "int8+paged"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rna(x):
    """``cvt.rna.tf32.f32`` on float32 ``x``: the magnitude's bits plus
    0x1000, the low 13 bits cleared, the sign kept."""
    b = x.contiguous().view(torch.int32)
    mag = ((b & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((b & ~0x7FFFFFFF) | mag).view(torch.float32)


def split(x):
    hi = rna(x)
    return hi, rna(x - hi)


# ---------------------------------------------------------------------------
# (a) the rounding
# ---------------------------------------------------------------------------
def test_split_hi_is_tf32_and_remainder_is_small():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -20, 20, size=4096)).astype(np.float32))
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    # hi alone keeps 11 significant bits: its error is up to 2^-11
    assert ((x.double() - hi.double()).abs()
            <= 2.0 ** -11 * x.double().abs()).all()


def test_rounding_ties_go_away_from_zero():
    # 1 + 2^-11 sits half way between the TF32 values 1 and 1 + 2^-10
    for sign in (1.0, -1.0):
        x = torch.tensor([sign * (1 + 2.0 ** -11), sign * (1 + 2.0 ** -12),
                          sign * (1 + 3 * 2.0 ** -12)], dtype=torch.float32)
        want = torch.tensor([sign * (1 + 2.0 ** -10), sign * 1.0,
                             sign * (1 + 2.0 ** -10)], dtype=torch.float32)
        assert torch.equal(rna(x), want)


def test_int8_values_split_exactly():
    """-128..127 (a widened int8 K or V value) is its own hi: lo = 0, so
    the kernels drop the lo pass of an int8 operand."""
    x = torch.arange(-128, 128, dtype=torch.float32)
    hi, lo = split(x)
    assert torch.equal(hi, x) and not lo.any()


# ---------------------------------------------------------------------------
# (b) the kernels' order vs Pallas (interpret)
# ---------------------------------------------------------------------------
def prod3(a, b, b_exact=False):
    """a [M, K] . b [K, N] as the kernels take it: three TF32 passes, small
    terms first (two when b is exact in TF32: int8 values)."""
    ah, al = split(a)
    if b_exact:
        return al @ b + ah @ b
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def walk(qr, keys, vals, ksc, vsc, live, scale, step, int8, state=None,
         bias=None):
    """One warp's online softmax over ``keys`` in updates of ``step``
    keys, base 2: scores = prod3(q, k^T) * scale * log2 e (int8: times the
    key's scale; then plus ``bias [M, N]`` in base 2, K1's ALiBi term),
    masked to NEG; P (int8: P * vs) split into P.V.  qr [M, D]; keys/vals
    [N, D] (int8 values as float); ksc/vsc [N] or None; live [M, N].
    Returns (m, l, acc), m in base 2."""
    n_rows, d = qr.shape
    m, l, acc = state or (torch.full((n_rows,), NEG), torch.zeros(n_rows),
                          torch.zeros(n_rows, d))
    for n0 in range(0, keys.shape[0], step):
        b = slice(n0, n0 + step)
        s = prod3(qr, keys[b].T, int8) * (scale * LOG2E)
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
        acc = acc * alpha[:, None] + prod3(pv, vals[b], int8)
        m = m_new
    return m, l, acc


def _pair(rng, shape):
    j = jnp.asarray(rng.normal(size=shape), jnp.float32)
    return j, torch.from_numpy(np.array(j))


def _caches(rng, variant, r1, kv, s, d):
    """(Pallas kwargs and K/V arrays in the variant's layout; the logical
    torch caches the kernels' arithmetic reads: values as float, scales or
    None)."""
    kc_j, kc = _pair(rng, (r1, kv, s, d))
    vc_j, vc = _pair(rng, (r1, kv, s, d))
    ks = vs = None
    if variant.startswith("int8"):
        kc, ks = kv_quant(kc)
        vc, vs = kv_quant(vc)
    phys = [kc, vc] + ([ks, vs] if ks is not None else [])
    kw = {}
    if variant.endswith("paged"):
        table = torch.from_numpy(np.random.RandomState(5).permutation(
            r1 * (s // PAGE)).astype(np.int32).reshape(r1, -1))
        phys = [att.page_layout(t, table, PAGE) for t in phys]
        kw = dict(page_table=jnp.asarray(table.numpy()), page_size=PAGE)
    j = [jnp.asarray(t.numpy()) for t in phys]
    if ks is not None:
        kw.update(k_scale=j[2], v_scale=j[3])
    return (j[0], j[1], kw), (kc.float(), vc.float(), ks, vs)


def merge(parts):
    """Split partials (m, l, acc), m in base 2, merged in split order: a
    split with m = NEG (no live key) weighs 0; f32 out [M, D]."""
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    mx = m.amax(0)
    wt = torch.where(m == NEG, torch.zeros_like(m), torch.exp2(m - mx))
    return (acc * wt[..., None]).sum(0) / \
        (l * wt).sum(0).clamp_min(1e-30)[:, None]


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_tf32_order_matches_pallas(variant):
    """Each tile's keys in the plan's 1024-key splits (S 1152: two; the
    first tile's second split is past its frontier), each a walk over
    32-key blocks, merged in base 2."""
    rng = np.random.default_rng(1)
    qh, kv, d, s, bq = 6, 2, 16, 1152, 8         # 3 query heads per KV head
    q_j, q_t = _pair(rng, (3, bq, qh, d))
    (kc_j, vc_j, kw), (kc, vc, ks, vs) = _caches(rng, variant, 4, kv, s, d)
    rows = np.array([0, 3, 1], np.int32)
    pstart = np.array([bq + 5, 0, s - bq], np.int32)
    scale = 1.0 / np.sqrt(d)
    want = jatt.prefill_attention(q_j, kc_j, vc_j, jnp.asarray(rows),
                                  jnp.asarray(pstart), scale, block_s=32,
                                  interpret=True, **kw)
    n_split, split_keys = att.prefill_split_plan(s)
    assert (n_split, split_keys) == (2, 1024)
    gq = qh // kv
    got = torch.empty(3, bq, qh, d)
    key_pos = torch.arange(s)
    for t in range(3):
        qpos = pstart[t] + torch.arange(bq * gq) // gq       # folded rows
        live = key_pos[None, :] <= qpos[:, None]
        r = rows[t]
        for h in range(kv):
            qr = q_t[t, :, h * gq:(h + 1) * gq].reshape(bq * gq, d)
            parts = []
            for j in range(n_split):
                b = slice(j * split_keys, (j + 1) * split_keys)
                parts.append(walk(qr, kc[r, h, b], vc[r, h, b],
                                  None if ks is None else ks[r, h, b],
                                  None if vs is None else vs[r, h, b],
                                  live[:, b], scale, BN, ks is not None))
            o = merge(parts)
            got[t, :, h * gq:(h + 1) * gq] = o.reshape(bq, gq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _warp_keys(blocks, tile, n_keys):
    """Key indices of column tile ``tile`` of each 32-key block in
    ``blocks`` (block order), and whether each lies below ``n_keys``."""
    idx = torch.tensor([b * BN + tile * 8 + c for b in blocks
                        for c in range(8)], dtype=torch.long)
    return idx, idx < n_keys


def _gather(x, idx, ok):
    """x[idx] with the rows past ``ok`` zero (the kernel zero-fills keys
    past the end), x [N, ...]."""
    out = x[idx.clamp(max=x.shape[0] - 1)].clone()
    out[~ok] = 0
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_batched_tree_tf32_order_matches_pallas(variant):
    """Splits of the plan (S 320: two), each a CTA of four warps: warp w
    walks column tile w of the split's committed 32-key blocks, then (the
    last split) of the spec block under the mask, in updates of 8 keys;
    the CTA merges the warps in order, the merge the splits, in base 2
    with the no-live-key guard; a pad request gives zeros."""
    rng = np.random.default_rng(2)
    qh, kv, d, s, p, pb = 4, 2, 16, 5 * 64, 3, 8
    clens = np.array([0, 1, 31, 33, 64, 257, s, 0], np.int32)
    r = len(clens)
    rows = np.array(list(range(r - 1)) + [r], np.int32)
    q_j, q_t = _pair(rng, (r, p, qh, d))
    (kc_j, vc_j, kw), (kc, vc, ks, vs) = _caches(rng, variant, r + 1, kv, s,
                                                 d)
    sk_j, sk_t = _pair(rng, (r + 1, kv, pb, d))
    sv_j, sv_t = _pair(rng, (r + 1, kv, pb, d))
    amask = rng.random((r, p, pb)) < 0.4
    amask[:, :, 0] = True
    amask[-1] = False
    scale = 1.0 / np.sqrt(d)
    want = jatt.tree_attention_batched(
        q_j, kc_j, vc_j, sk_j, sv_j, jnp.asarray(rows), jnp.asarray(clens),
        jnp.asarray(amask), scale, block_s=32, interpret=True, **kw)
    gq = qh // kv
    n_split, per = att.tree_split_plan(s)
    assert n_split == 2
    got = torch.empty(r, p, qh, d)
    mask_t = torch.from_numpy(amask)
    int8 = ks is not None
    for i in range(r):
        row, clen = rows[i], int(clens[i])
        spec_live = mask_t[i].repeat_interleave(gq, 0)      # [P*gq, Pb]
        for h in range(kv):
            qr = q_t[i, :, h * gq:(h + 1) * gq].reshape(p * gq, d)
            parts = []
            for j, (lo, hi) in enumerate(att.split_blocks(clen, s)):
                # the split's keys in 32-key blocks: the plan's 64-key
                # blocks [lo, hi) cover the same keys
                blocks = range(lo * 64 // BN, min(hi * 64, -(-clen // BN)
                                                  * BN) // BN)
                warps = []
                for w in range(4):
                    idx, ok = _warp_keys(blocks, w, clen)
                    state = walk(
                        qr, _gather(kc[row, h], idx, ok),
                        _gather(vc[row, h], idx, ok),
                        None if ks is None else _gather(ks[row, h], idx, ok),
                        None if vs is None else _gather(vs[row, h], idx, ok),
                        ok[None].expand(p * gq, -1), scale, 8, int8)
                    if j == n_split - 1:     # then the spec block, in the walk
                        idx, ok = _warp_keys(range(1), w, pb)
                        live = ok[None] & _gather(spec_live.T, idx, ok).T
                        state = walk(qr, _gather(sk_t[row, h], idx, ok),
                                     _gather(sv_t[row, h], idx, ok), None,
                                     None, live, scale, 8, False, state)
                    warps.append(state)
                m, l, acc = (torch.stack(x) for x in zip(*warps))
                mx = m.amax(0)
                wt = torch.where(m == NEG, torch.zeros_like(m),
                                 torch.exp2(m - mx))
                lsum, o = torch.zeros_like(mx), torch.zeros_like(acc[0])
                for w in range(4):                 # in warp order
                    lsum = lsum + l[w] * wt[w]
                    o = o + acc[w] * wt[w][:, None]
                parts.append((mx, lsum, o))
            got[i, :, h * gq:(h + 1) * gq] = merge(parts).reshape(p, gq, d)
    assert torch.isfinite(got).all() and not got[-1].abs().sum()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
