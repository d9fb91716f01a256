"""Tree-based speculative decoding demo on the PyTorch/CUDA port.

Port of ``examples/spec_infer.py``: a small draft model (SSM) and a larger
verifier (LLM) with seeded random weights serve four prompts with
SpecInfer tree speculation, first on the host (``SpecInferManager``), then
with the macro steps on the device (``SpecDecodeScan``); both outputs are
checked against plain incremental decoding with the same LLM.

    python -m flexflow_tpu_torch.examples.spec_infer            # the card
    python -m flexflow_tpu_torch.examples.spec_infer --device cpu
"""

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--width", type=int, default=2)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from flexflow_tpu_torch.serve import (
        BatchConfig,
        GenerationConfig,
        InferenceManager,
        RequestManager,
        ServeModelConfig,
        SpecDecodeScan,
        SpecInferManager,
        build_model,
    )

    head_dim = args.hidden // args.heads
    ssm_heads = max(1, args.heads // 4)
    llm_cfg = ServeModelConfig(
        model_type="llama", vocab_size=args.vocab, hidden_size=args.hidden,
        intermediate_size=args.hidden * 3, num_hidden_layers=args.layers,
        num_attention_heads=args.heads, num_key_value_heads=args.kv_heads,
        dtype=args.dtype)
    ssm_cfg = ServeModelConfig(
        model_type="llama", vocab_size=args.vocab,
        hidden_size=ssm_heads * head_dim,
        intermediate_size=ssm_heads * head_dim * 3, num_hidden_layers=1,
        num_attention_heads=ssm_heads, dtype=args.dtype)
    tree = 1 + args.width * args.depth
    max_requests, max_seq = 4, 256
    max_tokens = max_requests * tree

    def build(cfg, topk, seed):
        im = InferenceManager(build_model(cfg), max_requests=max_requests,
                              max_tokens_per_batch=max_tokens,
                              max_seq_len=max_seq, device=args.device,
                              max_spec_tokens=tree, topk=topk)
        return im.init_operators_inference(seed=seed)

    llm = build(llm_cfg, 0, args.seed)
    ssm = build(ssm_cfg, args.width, args.seed + 1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, args.vocab, size=n).tolist()
               for n in (5, 11, 3, 17)]
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens)

    sm = SpecInferManager(llm, ssm, gen, width=args.width, depth=args.depth)
    t0 = time.perf_counter()
    spec_out = sm.generate(prompts)
    dt = time.perf_counter() - t0
    print(f"spec_infer: {sm.tokens_decoded} tokens, {sm.llm_steps} LLM "
          f"passes, {sm.macro_steps} macro steps, {dt:.2f}s on {llm.device} "
          "(incl. kernel build on first use)")

    llm.reset()
    rm = RequestManager(llm, gen)
    incr_out = rm.generate(prompts)
    print(f"incr baseline: {rm.tokens_decoded} tokens in {rm.steps} steps")
    for p, o in zip(prompts, incr_out):
        print(f"prompt[{len(p)} toks] -> {o}")
    if spec_out != incr_out:
        print("FAIL: speculative output != incremental output")
        return 1
    print("OK: speculative output == incremental output")

    # ---- macro steps on the device ------------------------------------
    llm.reset()
    ssm.reset()
    toks = [t for p in prompts for t in p]
    reqi = [r for r, p in enumerate(prompts) for _ in p]
    pos = [i for p in prompts for i in range(len(p))]
    lens = [len(p) for p in prompts]
    bc = BatchConfig.build(toks, reqi, pos, lens, max_tokens=len(toks),
                           max_requests=max_requests, device=llm.device)
    ssm.step(bc)
    ids = llm.step(bc).token_ids.cpu().tolist()
    firsts = [ids[e - 1] for e in np.cumsum(lens)]
    sc = SpecDecodeScan(llm, ssm, width=args.width, depth=args.depth)
    budget = [args.max_new_tokens - 1] * len(prompts)
    carry = sc.init_carry(firsts, lens, lens, [False] * len(prompts),
                          budget=budget)
    t0 = time.perf_counter()
    n_macro = args.max_new_tokens - 1   # worst case one token per step
    emitted, _ = sc.run(carry, n_macro)
    em = emitted.cpu().numpy()
    dt = time.perf_counter() - t0
    scan_out = [[firsts[r]] + [int(t) for t in em[:, r].reshape(-1)
                               if t >= 0] for r in range(len(prompts))]
    if scan_out != incr_out:
        print("FAIL: scan output != incremental output")
        return 1
    print(f"OK: on-device spec scan matches too ({n_macro} macro steps, one "
          f"read-back, {dt:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
