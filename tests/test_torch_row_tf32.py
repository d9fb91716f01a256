"""The row-grouped float32 K1 and K3 per-token kernels' arithmetic, on the CPU.

The float32 ``decode_attention`` and ``tree_attention`` kernels run on the
card only.  They group flat tokens by cache row (the row plan, chunks of
``TF32_ROW_TILE`` = 16 folded rows), walk each row's keys in the splits of
``tree_split_plan`` as error-compensated TF32 products
(``flexflow_tpu_torch/csrc/row_tiles.cuh``, ``split_tf32_body``) and merge
the splits.  An emulation of that order is held here against the Pallas
kernels in interpret mode at ``atol=rtol=2e-5``, the float32 tolerance the
card is held to, at the TINY size, from numpy inputs made from a seed:
16-row chunks; in each split, 32-key blocks below the chunk's largest key
limit, four warps each on one 8-key column tile of every block (an update
of 8 keys, the split products, P kept in float32 and split), K1's ALiBi
bias in base 2, K3's spec block after the committed ones in the last
split; the warps merged in warp order, then each row's splits in split
order.  K1 in the four cache variants and ALiBi in two; K3 per-token in the
four variants and at 3 query heads per KV head, pads giving zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas import attention as jatt
from flexflow_tpu_torch.ops.cuda import attention as att
from flexflow_tpu_torch.serve import alibi_slopes
from test_torch_tf32x3 import (  # noqa: F401  (the fixture is autouse)
    BN, LOG2E, NEG, TOL, _caches, _gather, _one_thread, _pair, _warp_keys,
    merge, walk)

TILE = att.TF32_ROW_TILE
S = 640                       # three splits of 256, 256 and 128 keys
KV, D, R1 = 2, 16, 5          # cache rows 0-3, scratch row 4


def _emulate(q, kc, vc, ksc, vsc, rows, lens, scale, slopes=None,
             spec=None):
    """The f32 flat-token kernels' order: for each 16-row chunk of the row
    plan, KV head and split, four warps walk column tile w of the split's
    32-key blocks below the chunk's largest key limit (K3's last split then
    the spec block under the mask); the warps merge in order; each row
    keeps the partial of a split holding one of its live keys; the
    partials merge in split order.  K1: ``lens`` positions, ``slopes``
    ALiBi; K3: ``lens`` committed depths, ``spec`` (sk, sv, amask)."""
    t, qh, d = q.shape
    r1, kv, s, _ = kc.shape
    gq = qh // kv
    n_split, per = att.tree_split_plan(s)
    per *= att.PAGE_BLOCK // BN                     # 32-key blocks a split
    tree = spec is not None
    int8 = ksc is not None
    lens = lens.long()
    lim = lens.clamp(0, s) if tree else lens.clamp(0, s - 1) + 1
    perm, chunks = att.row_plan_plain(rows, r1, gq, TILE)
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
        lim_max = int(lim_r.max())
        nb_c = -(-lim_max // BN)
        nsc = (-(-lim_r // (per * BN))).clamp(max=n_split)
        for h in range(kv):
            head = h * gq + g
            qr = q[tok, head]
            for j in range(n_split):
                lo = min(j * per, nb_c)
                hi = min(lo + per, nb_c)
                last = tree and j == n_split - 1
                if hi == lo and not last:
                    continue
                warps = []
                for w in range(4):
                    idx, ok = _warp_keys(range(lo, hi), w, lim_max)
                    bias = None
                    if slopes is not None:
                        bias = (slopes[head] * LOG2E)[:, None] * (
                            idx[None, :].float() - lens[tok][:, None].float())
                    state = walk(
                        qr, _gather(kc[row, h], idx, ok),
                        _gather(vc[row, h], idx, ok),
                        None if ksc is None else _gather(ksc[row, h], idx, ok),
                        None if vsc is None else _gather(vsc[row, h], idx, ok),
                        idx[None, :] < lim_r[:, None], scale, 8, int8,
                        bias=bias)
                    if last:
                        sk, sv, amask = spec
                        p = sk.shape[2]
                        idx, ok = _warp_keys(range(-(-p // BN)), w, p)
                        live = ok[None] & amask[tok][:, idx.clamp(max=p - 1)]
                        state = walk(qr, _gather(sk[row, h], idx, ok),
                                     _gather(sv[row, h], idx, ok), None, None,
                                     live, scale, 8, False, state)
                    warps.append(state)
                wm, wl, wacc = (torch.stack(x) for x in zip(*warps))
                mx = wm.amax(0)
                wt = torch.where(wm == NEG, torch.zeros_like(wm),
                                 torch.exp2(wm - mx))
                lsum, o = torch.zeros_like(mx), torch.zeros_like(wacc[0])
                for w in range(4):                   # in warp order
                    lsum = lsum + wl[w] * wt[w]
                    o = o + wacc[w] * wt[w][:, None]
                mine = (j < nsc) | last
                m[j, tok[mine], head[mine]] = mx[mine]
                l[j, tok[mine], head[mine]] = lsum[mine]
                acc[j, tok[mine], head[mine]] = o[mine]
    out = merge([(m[j].reshape(-1), l[j].reshape(-1), acc[j].reshape(-1, d))
                 for j in range(n_split)])
    return out.reshape(t, qh, d)


def _scatter(rng, rows, lens):
    order = rng.permutation(len(rows))            # spread through the batch
    return (np.array(rows, np.int32)[order], np.array(lens, np.int32)[order])


@pytest.mark.parametrize("variant,gq,alibi", [
    ("fp", 1, False), ("int8", 2, False), ("paged", 3, False),
    ("int8+paged", 1, False), ("fp", 3, True), ("int8+paged", 2, True)])
def test_decode_tf32_order_matches_pallas(variant, gq, alibi):
    """A row of 20 prompt tokens at consecutive positions (an ALiBi
    prefill: 20 * gq folded rows over two or more chunks), tokens of other
    rows on block and split boundaries, pads on the scratch row."""
    rng = np.random.default_rng(40 + gq)
    qh = KV * gq
    rows, pos = _scatter(
        rng, [0] * 20 + [1, 3, 2, 1, 3, 2, 1, 2] + [R1 - 1] * 6,
        list(range(300, 320)) + [0, 31, 32, 63, 255, 256, 511, S - 1]
        + [0] * 6)
    q_j, q_t = _pair(rng, (len(rows), qh, D))
    (kc_j, vc_j, kw), (kc, vc, ks, vs) = _caches(rng, variant, R1, KV, S, D)
    scale = 1.0 / np.sqrt(D)
    slopes = alibi_slopes(qh, "cpu") if alibi else None
    if alibi:
        kw.update(slopes=jnp.asarray(slopes.numpy()), use_alibi=True)
    want = jatt.decode_attention(q_j, kc_j, vc_j, jnp.asarray(rows),
                                 jnp.asarray(pos), scale, block_s=64,
                                 interpret=True, **kw)
    got = _emulate(q_t, kc, vc, ks, vs, torch.from_numpy(rows),
                   torch.from_numpy(pos), scale, slopes=slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant,gq", [("fp", 1), ("int8", 1),
                                        ("paged", 2), ("int8+paged", 1),
                                        ("fp", 3)])
def test_tree_token_tf32_order_matches_pallas(variant, gq):
    """Requests of a 7-token tree scattered through the batch at committed
    depths on block and split boundaries, pads (scratch row, depth 0,
    empty mask) giving zeros; at gq 3 a token's rows straddle chunks."""
    rng = np.random.default_rng(50 + gq)
    qh, pb = KV * gq, 8
    depth = {0: 1, 1: 33, 2: 257, 3: S}
    rows, clens = _scatter(rng, [i // 7 for i in range(28)] + [R1 - 1] * 5,
                           [depth[i // 7] for i in range(28)] + [0] * 5)
    t = len(rows)
    q_j, q_t = _pair(rng, (t, qh, D))
    (kc_j, vc_j, kw), (kc, vc, ks, vs) = _caches(rng, variant, R1, KV, S, D)
    sk_j, sk_t = _pair(rng, (R1, KV, pb, D))
    sv_j, sv_t = _pair(rng, (R1, KV, pb, D))
    amask = rng.random((t, pb)) < 0.4
    amask[:, 0] = True
    pads = rows == R1 - 1
    amask[pads] = False
    scale = 1.0 / np.sqrt(D)
    want = jatt.tree_attention(
        q_j, kc_j, vc_j, sk_j, sv_j, jnp.asarray(rows), jnp.asarray(clens),
        jnp.asarray(amask), scale, block_s=64, interpret=True, **kw)
    got = _emulate(q_t, kc, vc, ks, vs, torch.from_numpy(rows),
                   torch.from_numpy(clens), scale,
                   spec=(sk_t, sv_t, torch.from_numpy(amask)))
    assert torch.isfinite(got).all() and not got[pads].abs().sum()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
