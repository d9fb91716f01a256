"""Incremental-decoding serving demo on the PyTorch/CUDA port.

Port of the main flow of ``examples/serve_llama.py``: build a Llama serve
model with seeded random weights, place it with an InferenceManager and
serve four prompts through the RequestManager's continuous batching.

    python -m flexflow_tpu_torch.examples.serve_llama            # the card
    python -m flexflow_tpu_torch.examples.serve_llama --device cpu
    # int8 weights, int8 KV, paged KV; a second session of prompts that
    # share a system prefix with the first reuses its pages:
    python -m flexflow_tpu_torch.examples.serve_llama --quantize \\
        --kv-dtype int8 --kv-page-size 64 --shared-prefix 128
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-requests", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="KV-cache storage dtype (int8: quantize on write, "
                         "dequantize inside the attention kernels)")
    ap.add_argument("--kv-page-size", type=int, default=0,
                    help="paged KV cache with copy-on-write prefix sharing, "
                         "pages of this many positions (a multiple of 64 "
                         "dividing --max-seq; 0 = slot-contiguous)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 weights with per-out-channel scales")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="serve two sessions of prompts that share an "
                         "N-token system prefix (with --kv-page-size the "
                         "second session reuses the first one's pages)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from flexflow_tpu_torch.serve import (
        GenerationConfig,
        InferenceManager,
        RequestManager,
        ServeModelConfig,
        build_model,
        quantize_int8,
    )

    cfg = ServeModelConfig(
        model_type="llama", vocab_size=args.vocab,
        hidden_size=args.hidden, intermediate_size=args.hidden * 3,
        num_hidden_layers=args.layers, num_attention_heads=args.heads,
        num_key_value_heads=args.kv_heads, dtype=args.dtype)
    im = InferenceManager(build_model(cfg), max_requests=args.max_requests,
                          max_tokens_per_batch=args.max_tokens,
                          max_seq_len=args.max_seq, device=args.device,
                          kv_dtype=args.kv_dtype,
                          kv_page_size=args.kv_page_size or None)
    im.init_operators_inference(seed=args.seed)
    if args.quantize:
        print(f"quantized {quantize_int8(im)} weight matrices to int8")
    rng = np.random.default_rng(0)
    lens = (5, 11, 3, 17)
    if args.shared_prefix:
        system = rng.integers(1, args.vocab, size=args.shared_prefix)
        sessions = [[system.tolist() + rng.integers(1, args.vocab, size=n)
                     .tolist() for n in lens] for _ in range(2)]
    else:
        sessions = [[rng.integers(1, args.vocab, size=n).tolist()
                     for n in lens]]
    for i, prompts in enumerate(sessions):
        rm = RequestManager(im, GenerationConfig(
            max_new_tokens=args.max_new_tokens))
        t0 = time.perf_counter()
        outs = rm.generate(prompts)
        dt = time.perf_counter() - t0
        for p, o in zip(prompts, outs):
            print(f"prompt[{len(p)} toks] -> {o}")
        total = rm.tokens_decoded
        cached = sum(r.prefix_cached for r in rm.requests.values())
        print(f"session {i}: served {len(prompts)} requests, {total} tokens "
              f"in {rm.steps} steps on {im.device}, {dt:.2f}s "
              f"({total / dt:.1f} tok/s incl. kernel build on first use); "
              f"prefilled {sum(map(len, prompts)) - cached} prompt tokens, "
              f"{cached} from cached pages")
    return 0


if __name__ == "__main__":
    sys.exit(main())
