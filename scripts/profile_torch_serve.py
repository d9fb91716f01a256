#!/usr/bin/env python3
"""Where a serving step's time goes on the card, for the PyTorch/CUDA port.

    python scripts/profile_torch_serve.py [--layers 32] [--new-tokens 16]

Builds the Llama-2-7B serve shape (bfloat16, seeded random weights; depth
cut by ``--layers``), admits 8 prompts of 256-1800 tokens, and times two
windows, first bare and then under ``torch.profiler``: the prefill stretch
(every prompt, tiled steps) and the first decode stretch.  For each traced
window it prints the wall time, the device time summed over kernels, the
busy share (device time / wall), the device time by kernel class, and the
top kernels.  Needs a CUDA device; the numbers are the card's, with its
name and power limit printed first.
"""

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

CLASSES = (   # (class, substrings of the kernel name), first match wins
    ("attention K1 decode", ("decode_kernel",)),
    ("attention K2 prefill", ("prefill_kernel",)),
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
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from flexflow_tpu_torch import serve

    im = serve.InferenceManager(
        serve.build_model(serve.ServeModelConfig(
            dtype="bfloat16", num_hidden_layers=args.layers)),
        max_requests=8, max_tokens_per_batch=512, max_seq_len=2048)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    im.init_operators_inference(seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 32000, size=int(n)).tolist()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
