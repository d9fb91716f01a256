"""Incremental-decoding serving demo on the PyTorch/CUDA port.

Port of the main flow of ``examples/serve_llama.py``: build a Llama serve
model with seeded random weights, place it with an InferenceManager and
serve four prompts through the RequestManager's continuous batching.

    python -m flexflow_tpu_torch.examples.serve_llama            # the card
    python -m flexflow_tpu_torch.examples.serve_llama --device cpu
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from flexflow_tpu_torch.serve import (
        GenerationConfig,
        InferenceManager,
        RequestManager,
        ServeModelConfig,
        build_model,
    )

    cfg = ServeModelConfig(
        model_type="llama", vocab_size=args.vocab,
        hidden_size=args.hidden, intermediate_size=args.hidden * 3,
        num_hidden_layers=args.layers, num_attention_heads=args.heads,
        num_key_value_heads=args.kv_heads, dtype=args.dtype)
    im = InferenceManager(build_model(cfg), max_requests=args.max_requests,
                          max_tokens_per_batch=args.max_tokens,
                          max_seq_len=args.max_seq, device=args.device)
    im.init_operators_inference(seed=args.seed)
    rm = RequestManager(im, GenerationConfig(
        max_new_tokens=args.max_new_tokens))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, args.vocab, size=n).tolist()
               for n in (5, 11, 3, 17)]
    t0 = time.perf_counter()
    outs = rm.generate(prompts)
    dt = time.perf_counter() - t0
    for p, o in zip(prompts, outs):
        print(f"prompt[{len(p)} toks] -> {o}")
    total = rm.tokens_decoded
    print(f"served {len(prompts)} requests, {total} tokens in {rm.steps} "
          f"steps on {im.device}, {dt:.2f}s ({total / dt:.1f} tok/s incl. "
          "kernel build on first use)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
