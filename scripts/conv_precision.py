#!/usr/bin/env python3
"""The conv kernel's gradient by the port's GEMM and by cuDNN: how far
each lands from float64, and what each costs on the card.

    python scripts/conv_precision.py [--batch 32] [--reps 20]

Part 1, precision: for every conv case of
``flexflow_tpu_torch/tools/op_parity.py`` (its input, padded as the op
pads it, and its output's cotangent taken as the product's gradient),
the kernel's gradient in float64 on the CPU, then in float32 by the
port's ``ops/conv.py:weight_grad`` on the CPU and on the card, and by
cuDNN on the card (``torch.nn.grad.conv2d_weight``), also with
``cudnn.deterministic`` set: each one's largest
absolute difference from float64 over float64's largest magnitude, and
whether each card result holds ``op_parity``'s tolerance (``rtol 1e-4``,
``atol 1e-5``) against the CPU's.

Part 2, cost: every distinct conv of ResNet-18 (``models/vision.py``)
at ``(3, 224, 224)``, batch ``--batch``: the device ms of each kernel
gradient (median over ``--reps`` between CUDA events), and the sums over
the network's convs, each counted as often as the network has it.

TF32 off throughout.  Needs a CUDA device; the card's name and power
limit are printed first.
"""

import argparse
import collections
import os
import statistics
import subprocess
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.models.vision import build_resnet18
    from flexflow_tpu_torch.ops.conv import _pad, spatial_pads, weight_grad
    from flexflow_tpu_torch.tools import op_parity

    if not torch.cuda.is_available():
        raise SystemExit("conv_precision: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def port(x, op, gy):
        return weight_grad(x, op.kernel.shape, gy, op.stride, op.groups)

    def cudnn(x, op, gy):
        return torch.nn.grad.conv2d_weight(x, op.kernel.shape, gy,
                                           stride=op.stride,
                                           groups=op.groups)

    for name in (n for n in op_parity.CASES if n.startswith("conv")):
        op, xs, cts = op_parity.build_case(name)
        x = _pad(xs[0], spatial_pads(op.padding, xs[0].shape[2:],
                                     op.kernel_size, op.stride))
        gy = cts[0]
        ref = port(x.double(), op, gy.double())
        cpu = port(x, op, gy)
        rows = {"cpu": cpu,
                "card, port": port(x.cuda(), op, gy.cuda()).cpu(),
                "card, cuDNN": cudnn(x.cuda(), op, gy.cuda()).cpu()}
        torch.backends.cudnn.deterministic = True
        rows["card, cuDNN deterministic"] = cudnn(x.cuda(), op,
                                                  gy.cuda()).cpu()
        torch.backends.cudnn.deterministic = False
        for label, got in rows.items():
            rel = (got.double() - ref).abs().max() / ref.abs().max()
            line = f"{name} {label}: {float(rel):.2e} of float64's scale"
            if label != "cpu":
                ok = torch.allclose(got, cpu, rtol=op_parity.RTOL,
                                    atol=op_parity.ATOL)
                line += (f", {float((got - cpu).abs().max()):.2e} from "
                         f"the CPU: {'holds' if ok else 'misses'} "
                         f"op_parity's tolerance")
            print(line)

    model, _, _ = build_resnet18(ff.FFConfig(batch_size=args.batch),
                                 batch=args.batch, num_classes=1000,
                                 image=(3, 224, 224))
    shapes = collections.Counter()
    ops = {}
    for node in model.graph.nodes:
        if node.op.type_name == "conv2d":
            spec = model.graph.spec(node.inputs[0])
            key = (tuple(spec.shape), tuple(node.op.kernel.shape),
                   node.op.stride, str(node.op.padding))
            shapes[key] += 1
            ops[key] = node.op
    total = {"port": 0.0, "cuDNN": 0.0}
    g = torch.Generator(device="cuda").manual_seed(0)
    for key, count in shapes.items():
        op = ops[key]
        shape = key[0]
        x = torch.randn(shape, device="cuda", generator=g)
        x = _pad(x, spatial_pads(op.padding, shape[2:], op.kernel_size,
                                 op.stride))
        oh = (x.shape[2] - op.kernel_size[0]) // op.stride[0] + 1
        ow = (x.shape[3] - op.kernel_size[1]) // op.stride[1] + 1
        gy = torch.randn((shape[0], op.out_channels, oh, ow), device="cuda",
                         generator=g)
        ms = {}
        for label, fn in (("port", port), ("cuDNN", cudnn)):
            times = []
            for i in range(args.reps + 2):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                fn(x, op, gy)
                ev[1].record()
                torch.cuda.synchronize()
                if i >= 2:
                    times.append(ev[0].elapsed_time(ev[1]))
            ms[label] = statistics.median(times)
            total[label] += count * ms[label]
        print(f"resnet18 conv x{count} input {shape} kernel {key[1]} "
              f"stride {key[2]}: port {ms['port']:.4f} ms, cuDNN "
              f"{ms['cuDNN']:.4f} ms")
    print(f"resnet18 batch {args.batch}, every conv's kernel gradient: "
          f"port {total['port']:.3f} ms, cuDNN {total['cuDNN']:.3f} ms")


if __name__ == "__main__":
    main()
