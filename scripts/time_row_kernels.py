#!/usr/bin/env python3
"""Device time of the row-grouped flat-token kernels (K1 ``decode_attention``
and K3 ``tree_attention`` per-token) at ``chip_smoke.py``'s 7B shapes, with
the flat batch split into its parts.

    python scripts/time_row_kernels.py [--dtype float32] [--iters 50]

Each case is timed as ``chip_smoke.time_ms`` does (calls queued behind a
sleep kernel: device time) and held against the plain version first
(``2e-5`` f32, ``1e-2`` bf16).  Cases: K1 with 8 real tokens (positions
0-2047 on rows 0-7) and 504 pads on the scratch row (``full``), the 8 real
tokens alone (``real``), the 504 pads alone (``pads``), the same at 48
query heads on one KV head (D 128) and 71 (D 64); K3 with 8 requests of a
7-token tree and 456 pads, and the 56 tree tokens alone.  fp and int8
caches.  Prints the card's name and power limit, then one JSON line per
case.  To compare two versions of the code on one card, run this script
from each checkout in turns within one call.
"""

import argparse
import json
import os
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_row_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from flexflow_tpu_torch.ops.cuda import attention as att
    from flexflow_tpu_torch.serve.ops import kv_quant

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    dtype = getattr(torch, args.dtype)
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
        else dict(atol=1e-2, rtol=1e-2)
    s, r, pb = 2048, 8, 8
    g = torch.Generator().manual_seed(0)
    pos_real = [0, 2047, 1023, 300, 1800, 64, 1500, 777]

    def run(kernel, case, variants, head, tail):
        fn = getattr(att, kernel)
        plain = getattr(att, kernel + "_plain")
        for var in ("fp", "int8"):
            k, v, kw = variants[var]
            a = (*head, k, v, *tail)
            got = fn(*a, **kw)
            torch.testing.assert_close(got.float(), plain(*a, **kw).float(),
                                       **tol)
            ms = cs.time_ms(lambda: fn(*a, **kw), args.iters)
            print(json.dumps({"kernel": kernel, "case": case, "variant": var,
                              "dtype": args.dtype, "tokens": head[0].shape[0],
                              "ms": ms}), flush=True)

    for label, qh, kv, d in (("", 32, 32, 128), ("gq48 ", 48, 1, 128),
                             ("gq71 ", 71, 1, 64)):
        kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        variants = cs.cache_variants(att, kv_quant, kc, vc, 1)
        for case, rows, pos in (
                ("full", list(range(8)) + [r] * 504, pos_real + [0] * 504),
                ("real", list(range(8)), pos_real),
                ("pads", [r] * 504, [0] * 504)):
            q = torch.randn(len(rows), qh, d, generator=g).to(dev, dtype)
            run("decode_attention", label + case, variants, (q,), (
                torch.tensor(rows, dtype=torch.int32, device=dev),
                torch.tensor(pos, dtype=torch.int32, device=dev), d ** -0.5))
        del kc, vc, variants
        torch.cuda.empty_cache()

    qh = kv = 32
    d = 128
    lens = np.linspace(256, 1800, r).astype(int).tolist()
    p = len(cs.TREE_PARENTS)
    mask1 = torch.from_numpy(cs.tree_mask(cs.TREE_PARENTS, pb))
    kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
              for _ in range(2))
    sk, sv = (torch.randn(r + 1, kv, pb, d, generator=g).to(dev, dtype)
              for _ in range(2))
    variants = cs.cache_variants(att, kv_quant, kc, vc, 2)
    for case, n_flat in (("full", 512), ("real", r * p)):
        real = r * p
        rows = [i // p for i in range(real)] + [r] * (n_flat - real)
        clens = [lens[i // p] for i in range(real)] + [0] * (n_flat - real)
        amask = torch.zeros(n_flat, pb, dtype=torch.bool)
        amask[:real] = mask1.repeat(r, 1)
        q = torch.randn(n_flat, qh, d, generator=g).to(dev, dtype)
        run("tree_attention", case, variants, (q,), (
            sk, sv, torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(clens, dtype=torch.int32, device=dev),
            amask.to(dev), d ** -0.5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
