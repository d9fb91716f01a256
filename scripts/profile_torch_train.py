#!/usr/bin/env python3
"""Where a training step's time goes on the card, for the PyTorch/CUDA port.

    python scripts/profile_torch_train.py [--layers 12] [--seq 512]
    python scripts/profile_torch_train.py --optimizer sgd
    python scripts/profile_torch_train.py --model resnet18 [--batch 32]
    python scripts/profile_torch_train.py --optimizer sgd --mesh pp=2,dp=2
    python scripts/profile_torch_train.py --optimizer sgd --mesh sp=4 \
        --layers 2 --seq 4096 --batch 2

Builds the Transformer classifier (``models/transformer.py``) at
BERT-base width (hidden 768, 12 heads, ff 3072, 16 classes; depth and
sequence set by ``--layers`` and ``--seq``), or ResNet-18
(``models/vision.py``) at ImageNet width (``(3, 224, 224)``, 1000
classes), on the card in float32 with TF32 off, compiles it with Adam
(lr 1e-4) or SGD with momentum 0.9, and runs ``FFModel``'s train step on
a fixed batch (default 8; ``--batch``): the median step between two
``torch.cuda.synchronize`` after ``--warmup`` steps; the device time of
the forward with its loss, of the backward and of the optimizer's
update, each between CUDA events on the stream (a lower bound where the
host issues slower than the device runs); then ``--traced`` steps under
``torch.profiler``: the wall, the device time summed over kernels, the
busy share, the device time by kernel class and the top kernels.
``--mesh`` (the Transformer only) puts every shard of that mesh on the
card: a ``pp`` axis trains through the GPipe executor
(``pipeline="force"``, ``PP_MICRO`` microbatches as in ``chip_smoke.py``'s
phase 27), an ``sp`` axis runs ring attention (``{"sequence": ("sp",)}``
on every attention op, and ``sample`` over ``dp``); the step's three
parts are then not split.
Needs a CUDA device; the card's name and power limit are printed first.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

PP_MICRO = 4    # GPipe microbatches a step on a pp mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--model", default="transformer",
                    choices=["transformer", "resnet18"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--traced", type=int, default=3)
    ap.add_argument("--mesh", default=None,
                    help="e.g. pp=2,dp=2 or sp=4: shards on the one card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    sys.path.insert(0, here)
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.models.transformer import \
        build_transformer_classifier
    from flexflow_tpu_torch.models.vision import build_resnet18
    from flexflow_tpu_torch.parallel.mesh import data_parallel_strategy
    from flexflow_tpu_torch.utils.platform import host_to_device
    from profile_torch_serve import profile_window, report

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = (None if args.mesh is None else
             {k: int(v) for k, v in (a.split("=")
                                     for a in args.mesh.split(","))})
    mesh = None
    if shape is not None:
        mesh = ff.make_mesh(shape, ["cuda:0"] * int(np.prod(list(
            shape.values()))))
    pipeline = ({} if shape is None or "pp" not in shape else
                dict(pipeline="force", pipeline_microbatches=PP_MICRO))
    cfg = ff.FFConfig(batch_size=args.batch, **pipeline)
    rng = np.random.RandomState(0)
    if args.model == "resnet18":
        model, _, out = build_resnet18(cfg, batch=args.batch,
                                       num_classes=1000, image=(3, 224, 224))
        x = rng.randn(args.batch, 3, 224, 224).astype(np.float32)
        classes, what = 1000, "ResNet-18 at 224"
    else:
        model = build_transformer_classifier(
            cfg, mesh=mesh, batch=args.batch, seq=args.seq,
            num_layers=args.layers, hidden_dim=768, num_heads=12,
            ff_dim=3072, num_classes=16)
        out = None
        x = rng.randn(args.batch, args.seq, 768).astype(np.float32)
        classes, what = 16, f"{args.layers} layers, seq {args.seq}"
    opt = (ff.AdamOptimizer(alpha=1e-4) if args.optimizer == "adam"
           else ff.SGDOptimizer(lr=0.01, momentum=0.9))
    strategy = None
    if shape is not None and "sp" in shape:
        strategy = data_parallel_strategy(model.graph, mesh)
        for node in model.graph.nodes:
            if node.name.endswith("_attn"):
                strategy.setdefault(node.name, {})["sequence"] = ("sp",)
        what += f", ring attention on {shape}"
    model.compile(optimizer=opt, outputs=[out] if out is not None else None,
                  strategy=strategy)
    if model._pipeline is not None:
        what += (f", GPipe on {shape} ({PP_MICRO} microbatches, "
                 f"{[sum(n.endswith('_attn') for n in c) for c in model._pp_meta['core_names']]}"
                 " layers a stage)")
    batch = model._place({model.graph.input_tids[0]: x})
    labels = host_to_device(rng.randint(0, classes, args.batch),
                            model.device)
    seed = 0

    def step():
        return model._train_step(batch, labels, seed)

    walls = []
    for i in range(args.warmup + args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= args.warmup:
            walls.append(time.perf_counter() - t0)
    flops = 3 * sum(st.node.op.flops(st.in_specs)
                    for st in model.plan.steps if not st.is_parallel)
    med = statistics.median(walls)
    print(f"{what}, batch {args.batch}, "
          f"{args.optimizer}: median step {med * 1e3:.3f} ms over "
          f"{len(walls)} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}); 3 x forward flops "
          f"{flops / 1e12:.4f} TFLOP, {flops / med / 1e12:.2f} TFLOP/s")

    # the step's three parts, between events on the stream (one device)
    parts = {"forward + loss": [], "backward": [], "update": []}
    if mesh is not None:
        parts = {}
    params = model._trainable()
    for _ in range(args.steps if parts else 0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        outs = model._forward(batch, training=True, seed=seed)
        loss = model._total_loss(outs, labels)
        ev[1].record()
        loss.backward()
        ev[2].record()
        grads = {n: {p: w.grad for p, w in g.items()}
                 for n, g in params.items()}
        model.optimizer.update(grads, model.opt_state, params)
        ev[3].record()
        for g in params.values():
            for w in g.values():
                w.grad = None
        torch.cuda.synchronize()
        for i, k in enumerate(parts):
            parts[k].append(ev[i].elapsed_time(ev[i + 1]))
    if parts:
        print("parts (median device ms between events): " + ", ".join(
            f"{k} {statistics.median(v):.3f}" for k, v in parts.items()))

    def traced():
        for _ in range(args.traced):
            step()

    wall, kernels = profile_window(torch, traced)
    report(f"{args.traced} traced steps", wall, kernels)


if __name__ == "__main__":
    main()
