#!/usr/bin/env python3
"""Where a serving step's time goes on the card, for the PyTorch/CUDA port.

    python scripts/profile_torch_serve.py [--layers 32] [--new-tokens 16]
    python scripts/profile_torch_serve.py --quantize --kv-dtype int8 \
        --kv-page-size 512 --no-spec
    python scripts/profile_torch_serve.py --model-type mpt
    python scripts/profile_torch_serve.py --dtype float32

Builds the Llama-2-7B serve shape (bfloat16, or with ``--dtype float32``
float32 with TF32 off for the GEMMs, the reference's default serving
dtype; seeded random weights; depth
cut by ``--layers``), or with ``--model-type mpt`` MPT-7B's (ALiBi: its
prefill runs through the decode kernel, and ``--no-spec`` is implied),
admits 8 prompts of 256-1800 tokens, and times
windows, first bare and then under ``torch.profiler``: the prefill stretch
(every prompt, tiled steps), the first decode stretch, and, with a draft
of llama-68m's published shape (width 2, depth 3), one steady speculative
macro step of ``SpecInferManager`` (host loop) and ``--macro-steps`` of
``SpecDecodeScan`` (device loop).  For each traced window it prints the
wall time, the device time summed over kernels, the busy share (device
time / wall), the device time by kernel class, and the top kernels.
Needs a CUDA device; the numbers are the card's, with its name and power
limit printed first.  ``--quantize`` (int8 weights), ``--kv-dtype int8``
and ``--kv-page-size N`` profile those variants of the same windows;
``--no-spec`` stops after the decode stretch (the speculative windows
prefill through a RequestManager that releases each request's pages, so
they run on slot-contiguous caches only).
"""

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

CLASSES = (   # (class, substrings of the kernel name), first match wins
    ("attention K1 decode", ("decode_plan_kernel", "decode_split_kernel",
                             "decode_split_tf32_kernel")),
    ("attention K2 prefill", ("prefill_kernel", "prefill_tc_kernel",
                              "prefill_tf32_kernel")),
    ("attention K3 tree batched", ("tree_batched_kernel", "tree_split_kernel",
                                   "tree_split_tf32_kernel",
                                   "tree_merge_kernel")),
    ("attention K3 tree per-token", ("tree_token_plan_kernel",
                                     "tree_token_split_kernel",
                                     "tree_token_split_tf32_kernel")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                     "winograd", "im2col", "col2im")),
    ("matmul", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "sm90")),
    ("index / copy", ("index", "copy", "gather", "scatter", "cat")),
    ("elementwise / reduce", ("elementwise", "reduce", "softmax", "norm")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_window(torch, fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = defaultdict(lambda: [0.0, 0])   # name -> [device us, count]
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key][0] += us
        kernels[e.key][1] += e.count
    return wall, dict(kernels)


def report(label, wall, kernels):
    dev_s = sum(us for us, _ in kernels.values()) / 1e6
    print(f"{label}: wall {wall * 1e3:.3f} ms, device {dev_s * 1e3:.3f} ms, "
          f"busy share {dev_s / wall:.3f}, kernels "
          f"{sum(n for _, n in kernels.values())}")
    if not kernels:
        print(f"{label}: the profiler saw no device time")
        return
    by_cls = defaultdict(float)
    for name, (us, _) in kernels.items():
        by_cls[kernel_class(name)] += us
    for cls, us in sorted(by_cls.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:22s} {us / 1e3:10.3f} ms  {us / 1e6 / dev_s:6.3f}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, n) in top:
        print(f"    {us / 1e3:9.3f} ms x{n:<6d} {name[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-type", default="llama", choices=["llama", "mpt"])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--macro-steps", type=int, default=8)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weights (serve.quantize_int8)")
    ap.add_argument("--kv-dtype", default=None, choices=["int8"])
    ap.add_argument("--kv-page-size", type=int, default=0)
    ap.add_argument("--no-spec", action="store_true",
                    help="skip the speculative windows")
    args = ap.parse_args(argv)
    if args.model_type == "mpt":
        args.no_spec = True      # no speculative steps on ALiBi layers yet
    if args.kv_page_size and not args.no_spec:
        ap.error("the speculative windows need slot-contiguous caches: "
                 "add --no-spec")

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from flexflow_tpu_torch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.model_type == "mpt":   # mosaicml/mpt-7b's config.json
        cfg = serve.ServeModelConfig.from_hf_config(dict(
            model_type="mpt", d_model=4096, n_heads=32,
            n_layers=args.layers, expansion_ratio=4, vocab_size=50432,
            no_bias=True, torch_dtype=args.dtype))
    else:
        cfg = serve.ServeModelConfig(dtype=args.dtype,
                                     num_hidden_layers=args.layers)
    im = serve.InferenceManager(
        serve.build_model(cfg), max_requests=8, max_tokens_per_batch=512,
        max_seq_len=2048, max_spec_tokens=0 if args.no_spec else 8,
        kv_dtype=args.kv_dtype, kv_page_size=args.kv_page_size or None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    im.init_operators_inference(seed=0)
    if args.quantize:
        serve.quantize_int8(im)
    w_bytes = sum(p.numel() * p.element_size()
                  for p in im.model.parameters())
    print(f"{args.model_type} {args.dtype}: weights {w_bytes / 1e9:.2f} GB, "
          f"KV {im.kv.allocated_bytes() / 1e9:.2f} GB (kv_dtype "
          f"{args.kv_dtype}, page {args.kv_page_size or 'none'})")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in np.linspace(256, 1800, 8)]

    def fresh_rm():
        im.reset()
        rm = serve.RequestManager(im, serve.GenerationConfig(
            max_new_tokens=args.new_tokens))
        for p in prompts:
            rm.register_new_request(p)
        return rm

    fresh_rm().serve_incr_decoding()          # warm-up: builds the kernels
    # unprofiled first: the profiler adds host work to every op, and its
    # tracing may outlast the window
    rm = fresh_rm()
    t0 = time.perf_counter()
    rm._serve_tick()                                      # prefill stretch
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rm._serve_tick()                                      # decode stretch
    torch.cuda.synchronize()
    bare = time.perf_counter() - t1
    print(f"unprofiled: prefill stretch {(t1 - t0) * 1e3:.3f} ms")
    rm = fresh_rm()
    wall, kern = profile_window(torch, rm._serve_tick)   # prefill stretch
    report(f"prefill stretch ({sum(map(len, prompts))} prompt tokens, "
           f"{args.layers} layers)", wall, kern)
    n = rm._scan_steps_possible()
    wall, kern = profile_window(torch, rm._serve_tick)   # decode stretch
    report(f"decode stretch ({n} steps x 8 requests, {args.layers} layers)",
           wall, kern)
    print(f"decode step: {wall / n * 1e3:.3f} ms profiled, "
          f"{bare / n * 1e3:.3f} ms unprofiled")
    if not args.no_spec:
        profile_spec(args, torch, serve, im, prompts)
    return 0


def profile_spec(args, torch, serve, im, prompts):
    """One steady host macro step and a window of device macro steps."""
    draft = serve.InferenceManager(
        serve.build_model(serve.ServeModelConfig(
            hidden_size=768, intermediate_size=3072, num_hidden_layers=2,
            num_attention_heads=12, dtype=args.dtype)),
        max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
        max_spec_tokens=8, topk=2)
    draft.init_operators_inference(seed=1)
    gen = serve.GenerationConfig(max_new_tokens=64)

    def steady_sm():
        im.reset()
        draft.reset()
        sm = serve.SpecInferManager(im, draft, gen, width=2, depth=3)
        for p in prompts:
            sm.register_new_request(p)
        sm._tick()        # admission + prefill stretch
        sm._tick()        # first macro step: the draft's prompt prefill
        return sm

    sm = steady_sm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm._tick()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    print(f"unprofiled: spec host macro step {ms:.3f} ms")
    wall, kern = profile_window(torch, steady_sm()._tick)
    report(f"spec host macro step (8 trees of 7, {args.layers} layers)",
           wall, kern)

    def carry():
        im.reset()
        draft.reset()
        lens = [len(p) for p in prompts]
        firsts = [[o[0] for o in serve.RequestManager(
            m, serve.GenerationConfig(max_new_tokens=1)).generate(prompts)]
            for m in (im, draft)][0]
        sc = serve.SpecDecodeScan(im, draft, width=2, depth=3)
        return sc, sc.init_carry(firsts, lens, lens, [False] * len(prompts))

    n = args.macro_steps
    sc, c = carry()
    _, c = sc.run(c, 1)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc.run(c, n)
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    sc, c = carry()
    wall, kern = profile_window(torch, lambda: sc.run(c, n))
    report(f"spec device window ({n} macro steps, {args.layers} layers)",
           wall, kern)
    print(f"spec device macro step: {wall / n * 1e3:.3f} ms profiled, "
          f"{bare / n * 1e3:.3f} ms unprofiled")


if __name__ == "__main__":
    sys.exit(main())
