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
3. parity: a 2-layer model at full Llama-2-7B width in float32 (TF32 off)
   serves the same prompts on the card (kernels) and on the CPU (plain
   versions) from the same seeded weights: greedy tokens must be equal and
   a prefill step's and a decode step's logits within ``atol=rtol=1e-3``
   (float32 GEMMs summed in another order at width 4096 and 11008);
4. serve: the published Llama-2-7B shape (32 layers, bfloat16, seeded
   random weights) serves 8 prompts of 256-1800 tokens, 64 new tokens
   each, through ``RequestManager.generate``; both kernels' launch counts
   are set to 0 just before and read just after, and must be > 0.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device.
"""

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


def phase_serve(serve, att, torch, dev):
    """The published Llama-2-7B shape, 8 requests through generate."""
    import numpy as np

    cfg = serve.ServeModelConfig(dtype="bfloat16")   # Llama-2-7B defaults
    t0 = time.perf_counter()
    im = serve.InferenceManager(serve.build_model(cfg), max_requests=8,
                                max_tokens_per_batch=512, max_seq_len=2048,
                                device=dev)
    im.init_operators_inference(seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size()
                  for p in im.model.parameters())
    log(f"serve: 7B bf16 init {t_init:.1f}s, weights "
        f"{w_bytes / 1e9:.2f} GB, KV cache "
        f"{im.kv.allocated_bytes() / 1e9:.2f} GB, prefill tile "
        f"{im.prefill_tile}")

    stamps = {}

    class TimedRM(serve.RequestManager):
        def _append_token(self, req, tok):
            super()._append_token(req, tok)
            stamps.setdefault(req.rid, []).append(time.perf_counter())

    rng = np.random.default_rng(0)
    lens = np.linspace(256, 1800, 8).astype(int).tolist()
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in lens]
    rm = TimedRM(im, serve.GenerationConfig(max_new_tokens=64))
    torch.cuda.reset_peak_memory_stats()
    att.decode_attention.launches = 0
    att.prefill_attention.launches = 0
    t0 = time.perf_counter()
    outs = rm.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": att.decode_attention.launches,
                "prefill_attention": att.prefill_attention.launches}
    for rid, req in rm.requests.items():
        if req.status is not serve.RequestStatus.COMPLETED \
                or len(req.generated) != 64:
            raise AssertionError(f"request {rid} did not finish: "
                                 f"{req.status} {len(req.generated)}")
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("token id out of range")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # the step logits the last stretch was drawn from are finite
    logits = im.forward(serve.BatchConfig.build(
        [outs[0][-1]], [0], [lens[0] + 63], [lens[0] + 64],
        max_tokens=512, max_requests=8, device=dev))
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    ttft = [stamps[r][0] - t0 for r in sorted(stamps)]
    tpot = [(stamps[r][-1] - stamps[r][0]) / 63 for r in sorted(stamps)]
    total = sum(len(o) for o in outs)
    log(f"serve: prompts {lens}, 64 new tokens each, wall {wall:.2f}s, "
        f"{total / wall:.1f} tok/s, steps {rm.steps}, decode stretches "
        f"{rm.scan_runs}")
    log(f"serve: TTFT s " + " ".join(f"{x:.3f}" for x in ttft)
        + f" | TPOT ms " + " ".join(f"{1e3 * x:.2f}" for x in tpot))
    log(f"serve: launches {launches}, max_memory_allocated "
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
    phase_parity(serve, torch, dev)
    log(f"phase parity done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    launches = phase_serve(serve, att, torch, dev)
    log(f"phase serve done in {time.perf_counter() - t0:.1f}s")

    replaces = {
        "decode_attention": "flexflow_tpu/ops/pallas/attention.py:209",
        "prefill_attention": "flexflow_tpu/ops/pallas/attention.py:444",
    }
    kernels = []
    for name in ("decode_attention", "prefill_attention"):
        res = kres[(name, "bfloat16")]   # the serve path's dtype
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"flexflow_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            **res})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
