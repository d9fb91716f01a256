"""MNIST MLP on the PyTorch/CUDA port (BASELINE config #1).

Port of ``examples/mnist_mlp.py``: 784 -> 512 relu -> 512 relu -> 10
softmax, SGD with momentum 0.9, sparse categorical crossentropy, through
``FFModel``'s builder, ``compile``, ``fit`` and ``evaluate``.  It uses
the real MNIST arrays if an ``mnist.npz`` is found in the working
directory, else the reference's deterministic synthetic stand-in (10
Gaussian clusters in 784-d) with learnable structure.  FlexFlow's flags
(``-b``, ``-e``, ``-lr``, ``--seed``...) go to ``FFConfig.parse_args``.

    python -m flexflow_tpu_torch.examples.mnist_mlp             # the card
    python -m flexflow_tpu_torch.examples.mnist_mlp --device cpu -e 1
"""

import os
import sys

import numpy as np


def load_mnist():
    if os.path.exists("mnist.npz"):
        d = np.load("mnist.npz")
        x = d["x_train"].reshape(-1, 784).astype(np.float32) / 255.0
        y = d["y_train"].astype(np.int32)
        return x, y, "mnist"
    # synthetic fallback: 10 gaussian clusters in 784-d
    rng = np.random.RandomState(42)
    n = 8192
    centers = rng.randn(10, 784).astype(np.float32) * 2.0
    y = rng.randint(0, 10, size=n).astype(np.int32)
    x = centers[y] + rng.randn(n, 784).astype(np.float32)
    return x, y, "synthetic"


def main(argv=None):
    from flexflow_tpu_torch import FFConfig, FFModel, SGDOptimizer, losses

    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    cfg = FFConfig.parse_args(argv)
    x_train, y_train, source = load_mnist()
    print(f"dataset: {source}, {len(x_train)} samples")

    model = FFModel(cfg, device=device)
    x = model.create_tensor((cfg.batch_size, 784))
    h = model.dense(x, 512, activation="relu")
    h = model.dense(h, 512, activation="relu")
    model.softmax(model.dense(h, 10))

    model.compile(
        optimizer=SGDOptimizer(lr=cfg.learning_rate, momentum=0.9),
        loss_type=losses.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics=["accuracy", "sparse_categorical_crossentropy"],
    )
    model.fit(x_train, y_train, epochs=cfg.epochs)
    final = model.evaluate(x_train, y_train)
    print(f"final: {final}")
    return final


if __name__ == "__main__":
    main()
