#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. build: compile every CUDA kernel of the serve path from
   ``flexflow_tpu_torch/csrc`` with nvcc (one process per source, started
   together), and print the card's name and power limit;
2. kernels: call each kernel at the Llama-2-7B attention shapes the serve
   path gives it and hold it against its plain PyTorch version, in float32
   (``atol=rtol=2e-5``) and bfloat16 (``atol=rtol=1e-2``: both sides round
   to bfloat16, one bfloat16 step apart at most); time the kernel, the
   plain version and one PyTorch library call computing the same function
   (``scaled_dot_product_attention``, a yardstick the port never calls);
3. tree kernels: the tree-attention kernel in both layouts at the
   speculative serve shapes (per-token: 512 flat rows, 56 real = 8
   requests x a 7-node tree, the rest scratch-row pads; batched: [8, 7]),
   held and timed as in phase 2, the library yardstick being one
   ``scaled_dot_product_attention`` over [committed; spec] keys under an
   explicit mask;
4. parity: a 2-layer model at full Llama-2-7B width in float32 (TF32 off)
   serves the same prompts on the card (kernels) and on the CPU (plain
   versions) from the same seeded weights: greedy tokens must be equal and
   a prefill step's and a decode step's logits within ``atol=rtol=1e-3``
   (float32 GEMMs summed in another order at width 4096 and 11008);
5. spec parity: 2 layers at full Llama-2-7B width in float32 (TF32 off)
   with a draft of llama-68m's published shape: ``SpecInferManager`` on
   the card == ``RequestManager`` on the card == ``SpecInferManager`` on
   the CPU, and ``SpecDecodeScan`` on the card == the same, token for
   token (greedy);
6. serve: the published Llama-2-7B shape (32 layers, bfloat16, seeded
   random weights) serves 8 prompts of 256-1800 tokens, 64 new tokens
   each, through ``RequestManager.generate``, then through
   ``SpecInferManager.generate`` (width 2, depth 3) and ``SpecDecodeScan``
   with the llama-68m-shaped draft, then both again with a perfect draft
   (width 1, depth 5: the LLM's embedding, first 2 layers, final norm and
   head, shared; the upper layers' o_proj/down_proj zeroed in the LLM).
   Every kernel count is set to 0 just before each path and read just
   after: K1 and K2 must launch on the incremental path,
   ``tree_attention`` on the host speculative path and
   ``tree_attention_batched`` on the device one.
   Speculative streams must finish with 64 in-range tokens; their share of
   tokens equal to the incremental run is printed, not required (bf16
   streams may part at a rounding tie).

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``.
Exits non-zero without a CUDA device.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM, data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # dense, data sheet


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def decode_work(rows, pos, s, kv, qh, d, itemsize):
    """(bytes, flops) decode attention must move/do for these inputs:
    q and out once, each row's K/V prefix up to its deepest token once."""
    deepest = {}
    for r, p in zip(rows, pos):
        deepest[r] = max(deepest.get(r, 0), min(p, s - 1) + 1)
    t = len(rows)
    kv_bytes = sum(deepest.values()) * kv * d * itemsize * 2
    nbytes = 2 * t * qh * d * itemsize + 8 * t + kv_bytes
    flops = sum(4 * (min(p, s - 1) + 1) * qh * d for p in pos)
    return nbytes, flops


def prefill_work(rows, pstart, bq, s, kv, qh, d, itemsize):
    deepest = {}
    for r, p in zip(rows, pstart):
        deepest[r] = max(deepest.get(r, 0), min(p + bq - 1, s - 1) + 1)
    g = len(rows)
    kv_bytes = sum(deepest.values()) * kv * d * itemsize * 2
    nbytes = 2 * g * bq * qh * d * itemsize + 8 * g + kv_bytes
    flops = sum(4 * (min(p + b, s - 1) + 1) * qh * d
                for p in pstart for b in range(bq))
    return nbytes, flops


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(att, torch, dev):
    """Each kernel at the 7B attention shapes vs its plain version."""
    import torch.nn.functional as F

    qh = kv = 32
    d, s, r = 128, 2048, 8
    rows_k1 = list(range(8)) + [r] * 504            # 8 real tokens, 504 pads
    pos_k1 = [0, 2047, 1023, 300, 1800, 64, 1500, 777] + [0] * 504
    rows_k2, pstart = [0, 3, 5, 7], [0, 640, 1280, 1920]
    bq = 128
    g = torch.Generator().manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
            else dict(atol=1e-2, rtol=1e-2)
        kc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
        vc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
        scale = d ** -0.5
        itemsize = kc.element_size()

        q1 = torch.randn(len(rows_k1), qh, d, generator=g).to(dev, dtype)
        rows1 = torch.tensor(rows_k1, dtype=torch.int32, device=dev)
        pos1 = torch.tensor(pos_k1, dtype=torch.int32, device=dev)
        got = att.decode_attention(q1, kc, vc, rows1, pos1, scale)
        want = att.decode_attention_plain(q1, kc, vc, rows1, pos1, scale)
        torch.cuda.synchronize()
        err1 = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        # library yardstick: SDPA over the 8 real tokens' gathered rows
        # (the pads' one-key work is negligible)
        ridx = torch.tensor(rows_k1[:8], device=dev)
        kg, vg = kc[ridx], vc[ridx]
        mask = (torch.arange(s, device=dev)[None, :]
                <= pos1[:8, None].long())[:, None, None, :]
        qs = q1[:8, :, None, :]
        lib1 = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale), 20)
        b1, f1 = decode_work(rows_k1, pos_k1, s, kv, qh, d, itemsize)
        bms1, by1 = bound(b1, f1, dn)
        results[("decode_attention", dn)] = dict(
            max_abs_err=err1,
            ms=time_ms(lambda: att.decode_attention(q1, kc, vc, rows1, pos1,
                                                    scale), 50),
            plain_ms=time_ms(lambda: att.decode_attention_plain(
                q1, kc, vc, rows1, pos1, scale), 3),
            bound_ms=bms1, bound_by=by1, library_ms=lib1)
        del kg, vg

        q2 = torch.randn(len(rows_k2), bq, qh, d, generator=g).to(dev, dtype)
        rows2 = torch.tensor(rows_k2, dtype=torch.int32, device=dev)
        ps2 = torch.tensor(pstart, dtype=torch.int32, device=dev)
        got = att.prefill_attention(q2, kc, vc, rows2, ps2, scale)
        want = att.prefill_attention_plain(q2, kc, vc, rows2, ps2, scale)
        torch.cuda.synchronize()
        err2 = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        ridx = rows2.long()
        kg, vg = kc[ridx], vc[ridx]
        qpos = ps2.long()[:, None] + torch.arange(bq, device=dev)
        mask = (torch.arange(s, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]
        qs = q2.transpose(1, 2)                     # [G, QH, Bq, D]
        lib2 = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=scale), 20)
        b2, f2 = prefill_work(rows_k2, pstart, bq, s, kv, qh, d, itemsize)
        bms2, by2 = bound(b2, f2, dn)
        results[("prefill_attention", dn)] = dict(
            max_abs_err=err2,
            ms=time_ms(lambda: att.prefill_attention(q2, kc, vc, rows2, ps2,
                                                     scale), 20),
            plain_ms=time_ms(lambda: att.prefill_attention_plain(
                q2, kc, vc, rows2, ps2, scale), 3),
            bound_ms=bms2, bound_by=by2, library_ms=lib2)
        del kc, vc, kg, vg, q1, q2
        torch.cuda.empty_cache()
    for (name, dn), res in results.items():
        log(f"kernel {name} {dn}: " + " ".join(
            f"{k}={v}" for k, v in res.items()))
    return results


def phase_parity(serve, torch, dev):
    """2 layers at full 7B width, f32: card (kernels) vs CPU (plain)."""
    import dataclasses

    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serve.ServeModelConfig(num_hidden_layers=2, dtype="float32")
    kw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=512)
    cpu = serve.InferenceManager(serve.build_model(cfg), device="cpu", **kw)
    cpu.init_operators_inference(seed=1)
    gpu = serve.InferenceManager(serve.build_model(cfg), device=dev, **kw)
    gpu.init_operators_inference(dict(cpu.model.named_parameters()))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in (300, 287)]
    gen = serve.GenerationConfig(max_new_tokens=9)   # prefill + 8 decodes
    t0 = time.perf_counter()
    want = serve.RequestManager(cpu, gen).generate(prompts)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = serve.RequestManager(gpu, gen).generate(prompts)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"card tokens {got} != CPU tokens {want}")

    def on(dev_, bc):
        base = bc.base if hasattr(bc, "base") else bc
        moved = dataclasses.replace(base, **{
            f.name: getattr(base, f.name).to(dev_)
            for f in dataclasses.fields(base)})
        return dataclasses.replace(bc, base=moved) if hasattr(bc, "base") \
            else moved

    cpu.reset()
    gpu.reset()
    pbc, _ = serve.PrefillBatchConfig.build(
        [(0, prompts[0][:128], 0)], [128], 128, max_tokens=128,
        max_requests=2, device="cpu")
    bc = serve.BatchConfig.build([prompts[0][128]], [0], [128], [129],
                                 max_tokens=128, max_requests=2,
                                 device="cpu")
    errs = []
    for step in (pbc, bc):
        lc = cpu.forward(step)
        lg = gpu.forward(on(dev, step)).cpu()
        errs.append((lg - lc).abs().max().item())
        torch.testing.assert_close(lg, lc, atol=1e-3, rtol=1e-3)
    log(f"parity: 2-layer 7B-width f32, tokens equal {got[0][:4]}..., "
        f"max |logit diff| prefill {errs[0]:.3e} decode {errs[1]:.3e}; "
        f"serve cpu {t_cpu:.1f}s card {t_gpu:.2f}s")


def tree_work(clens, trees, n_flat, pb, kv, qh, d, itemsize):
    """(bytes, flops) tree attention must move/do for these inputs: each
    request's committed K/V prefix and spec buffers once, q and out for
    every flat row, the index and mask arrays; 4*D flops per query head
    and live key of each real tree token."""
    nbytes = (sum(clens) * kv * d * itemsize * 2
              + len(clens) * kv * pb * d * itemsize * 2
              + 2 * n_flat * qh * d * itemsize + 8 * n_flat + n_flat * pb)
    flops = sum(4 * (c + int(m.sum())) * qh * d
                for c, mask in zip(clens, trees) for m in mask)
    return nbytes, flops


# a width-2, depth-3 draft tree: node -> parent (root first)
TREE_PARENTS = [-1, 0, 0, 1, 2, 3, 3]


def tree_mask(parents, pb):
    import numpy as np

    m = np.zeros((len(parents), pb), bool)
    for i, par in enumerate(parents):
        if par >= 0:
            m[i] = m[par]
        m[i, i] = True
    return m


def phase_tree_kernels(att, torch, dev):
    """K3 at the speculative serve shapes, both layouts, vs its plain
    version; timed beside one SDPA call over [committed; spec] keys."""
    import numpy as np
    import torch.nn.functional as F

    qh = kv = 32
    d, s, r, pb = 128, 2048, 8, 8
    lens = np.linspace(256, 1800, r).astype(int).tolist()
    p = len(TREE_PARENTS)
    n_flat = 512
    mask1 = tree_mask(TREE_PARENTS, pb)                  # [P, Pb]
    real = r * p
    rows_t = [i // p for i in range(real)] + [r] * (n_flat - real)
    clens_t = [lens[i // p] for i in range(real)] + [0] * (n_flat - real)
    amask_t = np.zeros((n_flat, pb), bool)
    amask_t[:real] = np.tile(mask1, (r, 1))
    g = torch.Generator().manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
            else dict(atol=1e-2, rtol=1e-2)
        kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        sk, sv = (torch.randn(r + 1, kv, pb, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        q = torch.randn(n_flat, qh, d, generator=g).to(dev, dtype)
        scale = d ** -0.5
        itemsize = kc.element_size()
        tok_args = (q, kc, vc, sk, sv,
                    torch.tensor(rows_t, dtype=torch.int32, device=dev),
                    torch.tensor(clens_t, dtype=torch.int32, device=dev),
                    torch.from_numpy(amask_t).to(dev), scale)
        bat_args = (q[:real].reshape(r, p, qh, d).contiguous(), kc, vc, sk,
                    sv, torch.arange(r, dtype=torch.int32, device=dev),
                    torch.tensor(lens, dtype=torch.int32, device=dev),
                    torch.from_numpy(np.tile(mask1, (r, 1, 1))).to(dev),
                    scale)
        # library yardstick: one SDPA over each request's [committed; spec]
        # keys with an explicit mask (the same function for the real rows)
        kg = torch.cat([kc[:r], sk[:r]], dim=2)
        vg = torch.cat([vc[:r], sv[:r]], dim=2)
        committed = (torch.arange(s, device=dev)[None, :]
                     < bat_args[6][:, None].long())           # [R, S]
        lib_mask = torch.cat([committed[:, None, :].expand(r, p, s),
                              bat_args[7]], dim=2)[:, None]   # [R,1,P,S+Pb]
        qs = bat_args[0].transpose(1, 2)                      # [R, QH, P, D]
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=lib_mask, scale=scale), 20)
        for name, args, flat in (("tree_attention", tok_args, n_flat),
                                 ("tree_attention_batched", bat_args, real)):
            fn = getattr(att, name)
            plain = getattr(att, name + "_plain")
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), **tol)
            nb, nf = tree_work(lens, [mask1] * r, flat, pb, kv, qh, d,
                               itemsize)
            bms, by = bound(nb, nf, dn)
            results[(name, dn)] = dict(
                max_abs_err=err, ms=time_ms(lambda: fn(*args), 20),
                plain_ms=time_ms(lambda: plain(*args), 2),
                bound_ms=bms, bound_by=by, library_ms=lib)
        del kc, vc, sk, sv, q, kg, vg, tok_args, bat_args
        torch.cuda.empty_cache()
    for (name, dn), res in results.items():
        log(f"kernel {name} {dn}: " + " ".join(
            f"{k}={v}" for k, v in res.items()))
    return results


def draft_config(serve, dtype):
    """The published shape of JackFram/llama-68m, the draft model the
    SpecInfer paper pairs with Llama-7B."""
    return serve.ServeModelConfig(
        hidden_size=768, intermediate_size=3072, num_hidden_layers=2,
        num_attention_heads=12, num_key_value_heads=12, dtype=dtype)


def prefill_firsts(serve, im, prompts):
    """Fill slots 0.. of ``im``'s caches with the prompts (a prefill
    stretch); the first generated token of each."""
    outs = serve.RequestManager(
        im, serve.GenerationConfig(max_new_tokens=1)).generate(prompts)
    return [o[0] for o in outs]


def phase_spec_parity(serve, torch, dev):
    """2 layers at full 7B width + the llama-68m-shaped draft, f32: the
    speculative paths on the card and the CPU equal incremental decoding."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_requests=2, max_tokens_per_batch=32, max_seq_len=256,
              max_spec_tokens=8)
    ims = {}
    llm_cfg = serve.ServeModelConfig(num_hidden_layers=2, dtype="float32")
    for key, cfg, topk, seed in (("llm", llm_cfg, 0, 1),
                                 ("ssm", draft_config(serve, "float32"), 2,
                                  2)):
        cpu = serve.InferenceManager(serve.build_model(cfg), device="cpu",
                                     topk=topk, **kw)
        cpu.init_operators_inference(seed=seed)
        gpu = serve.InferenceManager(serve.build_model(cfg), device=dev,
                                     topk=topk, **kw)
        gpu.init_operators_inference(dict(cpu.model.named_parameters()))
        ims[key] = (cpu, gpu)
    (llm_c, llm_g), (ssm_c, ssm_g) = ims["llm"], ims["ssm"]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, llm_cfg.vocab_size, size=n).tolist()
               for n in (130, 77)]
    gen = serve.GenerationConfig(max_new_tokens=8)
    want = serve.RequestManager(llm_g, gen).generate(prompts)
    llm_g.reset()
    got = serve.SpecInferManager(llm_g, ssm_g, gen, width=2,
                                 depth=3).generate(prompts)
    t0 = time.perf_counter()
    got_cpu = serve.SpecInferManager(llm_c, ssm_c, gen, width=2,
                                     depth=3).generate(prompts)
    t_cpu = time.perf_counter() - t0
    llm_g.reset()
    ssm_g.reset()
    firsts = prefill_firsts(serve, llm_g, prompts)
    prefill_firsts(serve, ssm_g, prompts)
    lens = [len(p) for p in prompts]
    sc = serve.SpecDecodeScan(llm_g, ssm_g, width=2, depth=3)
    em, _ = sc.run(sc.init_carry(firsts, lens, lens, [False, False],
                                 budget=[7, 7]), 7)
    em = em.cpu().numpy()
    scan = [[firsts[i]] + [int(t) for t in em[:, i].reshape(-1) if t >= 0]
            for i in range(2)]
    for name, out in (("card SpecInferManager", got),
                      ("CPU SpecInferManager", got_cpu),
                      ("card SpecDecodeScan", scan)):
        if out != want:
            raise AssertionError(f"{name} {out} != card incremental {want}")
    log(f"spec parity: 2-layer 7B-width f32 + llama-68m draft, tokens "
        f"equal {want[0][:4]}... on both speculative paths, card and CPU "
        f"(CPU spec serve {t_cpu:.1f}s)")


def stream_times(stamps, t0):
    """TTFT (s) and TPOT (ms) per request from token arrival stamps."""
    ttft = [stamps[r][0] - t0 for r in sorted(stamps)]
    tpot = [1e3 * (stamps[r][-1] - stamps[r][0]) / (len(stamps[r]) - 1)
            for r in sorted(stamps)]
    return ttft, tpot


def check_streams(outs, n_new, vocab, what):
    if any(len(o) != n_new for o in outs):
        raise AssertionError(f"{what}: a request did not finish with "
                             f"{n_new} tokens: {[len(o) for o in outs]}")
    if any(not 0 <= t < vocab for o in outs for t in o):
        raise AssertionError(f"{what}: token id out of range")


def equal_share(outs, ref):
    pairs = [(a, b) for o, w in zip(outs, ref) for a, b in zip(o, w)]
    return sum(a == b for a, b in pairs) / len(pairs)


COUNTED = ("decode_attention", "prefill_attention", "tree_attention",
           "tree_attention_batched")


def counted(att, fn):
    """Run ``fn`` with every kernel count set to 0 just before; returns
    (its result, the counts just after)."""
    for name in COUNTED:
        getattr(att, name).launches = 0
    out = fn()
    return out, {name: getattr(att, name).launches for name in COUNTED}


def phase_serve(serve, att, torch, dev):
    """The published Llama-2-7B shape, 8 requests: incremental, then
    speculative on the host and on the device with a llama-68m-shaped
    draft (width 2, depth 3), then both with a perfect draft (width 1,
    depth 5, as bench.py's ceiling row)."""
    import numpy as np

    cfg = serve.ServeModelConfig(dtype="bfloat16")   # Llama-2-7B defaults
    kw = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
              max_spec_tokens=8, device=dev)
    t0 = time.perf_counter()
    im = serve.InferenceManager(serve.build_model(cfg), **kw)
    im.init_operators_inference(seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size()
                  for p in im.model.parameters())
    log(f"serve: 7B bf16 init {t_init:.1f}s, weights "
        f"{w_bytes / 1e9:.2f} GB, KV cache + spec buffers "
        f"{im.kv.allocated_bytes() / 1e9:.2f} GB, prefill tile "
        f"{im.prefill_tile}")

    stamps = {}

    class Stamped:
        def _append_token(self, req, tok):
            super()._append_token(req, tok)
            stamps.setdefault(req.rid, []).append(time.perf_counter())

    class TimedRM(Stamped, serve.RequestManager):
        pass

    class TimedSpec(Stamped, serve.SpecInferManager):
        rows_verified = 0   # requests summed over the verify passes

        def _verify_phase(self, verifying):
            self.rows_verified += len(verifying)
            super()._verify_phase(verifying)

    rng = np.random.default_rng(0)
    lens = np.linspace(256, 1800, 8).astype(int).tolist()
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in lens]
    gen = serve.GenerationConfig(max_new_tokens=64)
    launches = {}

    def run_generate(label, manager, ref=None):
        stamps.clear()
        t0 = time.perf_counter()
        outs, n = counted(att, lambda: manager.generate(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_streams(outs, 64, cfg.vocab_size, label)
        ttft, tpot = stream_times(stamps, t0)
        extra = ""
        if ref is not None:
            extra = (f", tokens per LLM verify pass per request "
                     f"{63 * 8 / manager.rows_verified:.3f} "
                     f"({manager.llm_steps} passes), equal to incremental "
                     f"{equal_share(outs, ref):.4f}")
        log(f"serve {label}: wall {wall:.2f}s, "
            f"{sum(map(len, outs)) / wall:.1f} tok/s{extra}; launches {n}")
        log(f"serve {label}: TTFT s " + " ".join(f"{x:.3f}" for x in ttft)
            + " | TPOT ms " + " ".join(f"{x:.2f}" for x in tpot))
        return outs, n

    def run_scan(label, llm, ssm, width, depth, window, ref):
        """Prefill, then windows of ``window`` macro steps (one read-back
        each) until every request has its 64 tokens."""
        llm.reset()
        ssm.reset()
        t0 = time.perf_counter()
        firsts = prefill_firsts(serve, llm, prompts)
        prefill_firsts(serve, ssm, prompts)
        t_prefill = time.perf_counter() - t0
        sc = serve.SpecDecodeScan(llm, ssm, width=width, depth=depth)
        carry = sc.init_carry(firsts, lens, lens, [False] * 8,
                              budget=[63] * 8)
        ems = []

        def loop(carry):
            while not bool(carry["finished"].all()):
                em, carry = sc.run(carry, window)
                ems.append(em.cpu().numpy())

        t0 = time.perf_counter()
        _, n = counted(att, lambda: loop(carry))
        wall = time.perf_counter() - t0
        em = np.concatenate(ems)
        outs = [[firsts[i]] + [int(t) for t in em[:, i].reshape(-1)
                               if t >= 0] for i in range(8)]
        check_streams(outs, 64, cfg.vocab_size, label)
        # macro steps each request took part in: one LLM pass each
        took = [int(np.nonzero((em[:, i] >= 0).any(1))[0].max()) + 1
                for i in range(8)]
        log(f"serve {label}: prefill {t_prefill:.2f}s, {len(em)} macro "
            f"steps in {len(ems)} windows {wall:.2f}s, "
            f"{63 * 8 / wall:.1f} tok/s after the first token, TPOT "
            f"{1e3 * wall / 63:.2f} ms, tokens per LLM pass per request "
            f"{63 * 8 / sum(took):.3f}, equal to incremental "
            f"{equal_share(outs, ref):.4f}; launches {n}")
        return outs, n

    torch.cuda.reset_peak_memory_stats()
    incr, launches["incremental"] = run_generate("incremental",
                                                 TimedRM(im, gen))
    for name in ("decode_attention", "prefill_attention"):
        if launches["incremental"][name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # the step logits the last stretch was drawn from are finite
    logits = im.forward(serve.BatchConfig.build(
        [incr[0][-1]], [0], [lens[0] + 63], [lens[0] + 64],
        max_tokens=512, max_requests=8, device=dev))
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")

    draft = serve.InferenceManager(
        serve.build_model(draft_config(serve, "bfloat16")), topk=2, **kw)
    draft.init_operators_inference(seed=1)
    im.reset()
    _, launches["spec host"] = run_generate(
        "spec host (llama-68m draft)",
        TimedSpec(im, draft, gen, width=2, depth=3), incr)
    _, launches["spec device"] = run_scan(
        "spec device (llama-68m draft)", im, draft, 2, 3, 63, incr)
    if launches["spec host"]["tree_attention"] <= 0:
        raise AssertionError("tree_attention never launched on the host "
                             "speculative path")
    if launches["spec device"]["tree_attention_batched"] <= 0:
        raise AssertionError("tree_attention_batched never launched on the "
                             "device speculative path")
    del draft
    torch.cuda.empty_cache()

    # perfect draft: the LLM's upper layers add nothing to the residual
    # stream, so a 2-layer model sharing its embedding, first two layers,
    # final norm and head predicts its argmax
    lm = im.model
    with torch.no_grad():
        for layer in lm.model.layers[2:]:
            layer.self_attn.o_proj.zero_()
            layer.mlp.down_proj.kernel.zero_()
    pmodel = serve.build_model(dataclasses.replace(cfg, num_hidden_layers=2))
    pmodel.model.embed_tokens = lm.model.embed_tokens
    pmodel.model.layers = lm.model.layers[:2]
    pmodel.model.norm = lm.model.norm
    pmodel.lm_head = lm.lm_head
    perfect = serve.InferenceManager(pmodel, topk=1, **kw)
    perfect.init_operators_inference(dict(pmodel.named_parameters()))
    im.reset()
    incr_p, _ = run_generate("incremental (LLM of the perfect draft)",
                             TimedRM(im, gen))
    im.reset()
    run_generate("spec host (perfect draft)",
                 TimedSpec(im, perfect, gen, width=1, depth=5), incr_p)
    run_scan("spec device (perfect draft)", im, perfect, 1, 5, 11, incr_p)
    log(f"serve: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flexflow_tpu_torch import serve
    from flexflow_tpu_torch.ops.cuda import attention as att
    from flexflow_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _, logs = build.build()
    log(f"build: {sorted(logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        regs = [ln.split("info    :")[-1].strip() for ln in text.splitlines()
                if "Used" in ln]
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        log(f"build {name}: {len(regs)} kernels, registers "
            f"{sorted({r.split()[1] for r in regs})}, spills {spills}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    t0 = time.perf_counter()
    kres = phase_kernels(att, torch, dev)
    log(f"phase kernels done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    kres.update(phase_tree_kernels(att, torch, dev))
    log(f"phase tree kernels done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_parity(serve, torch, dev)
    log(f"phase parity done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_spec_parity(serve, torch, dev)
    log(f"phase spec parity done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches = phase_serve(serve, att, torch, dev)
    log(f"phase serve done in {time.perf_counter() - t0:.1f}s")

    # each kernel's launches on the path that runs it
    path_of = {"decode_attention": "incremental",
               "prefill_attention": "incremental",
               "tree_attention": "spec host",
               "tree_attention_batched": "spec device"}
    replaces = {
        "decode_attention": "flexflow_tpu/ops/pallas/attention.py:209",
        "prefill_attention": "flexflow_tpu/ops/pallas/attention.py:444",
        "tree_attention": "flexflow_tpu/ops/pallas/attention.py:790",
        "tree_attention_batched": "flexflow_tpu/ops/pallas/attention.py:836",
    }
    source = {"tree_attention_batched": "tree_attention"}
    kernels = []
    for name, path in path_of.items():
        res = kres[(name, "bfloat16")]   # the serve path's dtype
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"flexflow_tpu_torch/csrc/{source.get(name, name)}.cu",
            "replaces": replaces[name], "launches": launches[path][name],
            **res})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
