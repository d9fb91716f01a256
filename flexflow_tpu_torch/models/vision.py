"""The vision zoo: AlexNet, ResNet-18 and a compact Inception.

Port of ``flexflow_tpu/models/vision.py`` (``_pool_scaled`` :17,
``build_alexnet`` :33, ``_res_block`` :53, ``build_resnet18`` :68,
``_inception_block`` :88, ``build_inception`` :103; the reference's
``examples/cpp/{AlexNet,ResNet,InceptionV3}``): NCHW graphs of
``Conv2D``, ``Pool2D`` and ``BatchNorm`` (``ops/conv.py``,
``ops/norm.py``) built through ``FFModel`` with the reference's node
names (``"stem.conv"``, ``"layer1.0.conv1"``, ``"mixed0.b1"``), so
parameters carry across by name.  The graphs are the reference's, not
torchvision's: ResNet's stem pool is 3x3 stride 2 ``VALID``
(``_pool_scaled``), its downsampling blocks take a 1x1 stride-s
shortcut with its own batch norm, and the head is a global average pool,
``flat`` and one dense layer under a softmax.
"""

from __future__ import annotations

from ..config import FFConfig
from ..model import FFModel


def _pool_scaled(ff, x, name, kernel=(3, 3), stride=(2, 2), **kw):
    """A Pool2D whose window (and stride) is clamped to the incoming
    spatial dims, skipped at 1x1: the reference's rule for running the
    224x224 stacks at smaller images."""
    h, w = x.shape[2], x.shape[3]
    if h <= 1 and w <= 1:
        return x
    kh, kw_ = min(kernel[0], h), min(kernel[1], w)
    sh, sw = min(stride[0], kh), min(stride[1], kw_)
    return ff.pool2d(x, kernel=(kh, kw_), stride=(sh, sw), name=name, **kw)


def _model(config, mesh, device, batch):
    return FFModel(config or FFConfig(batch_size=batch), mesh=mesh,
                   device=device)


def build_alexnet(config=None, mesh=None, batch=4, num_classes=10,
                  image=(3, 64, 64), device=None):
    """An AlexNet-style stack at ``image``; returns ``(model, input,
    output)``."""
    ff = _model(config, mesh, device, batch)
    x_in = ff.create_tensor((batch,) + tuple(image))
    x = ff.conv2d(x_in, 64, kernel=(11, 11), stride=(4, 4), padding="SAME",
                  activation="relu", name="conv1")
    x = _pool_scaled(ff, x, "pool1")
    x = ff.conv2d(x, 192, kernel=(5, 5), activation="relu", name="conv2")
    x = _pool_scaled(ff, x, "pool2")
    x = ff.conv2d(x, 384, activation="relu", name="conv3")
    x = ff.conv2d(x, 256, activation="relu", name="conv4")
    x = ff.conv2d(x, 256, activation="relu", name="conv5")
    x = _pool_scaled(ff, x, "pool5")
    x = ff.flat(x, name="flat")
    x = ff.dense(x, 512, activation="relu", name="fc6")
    x = ff.dense(x, 512, activation="relu", name="fc7")
    out = ff.softmax(ff.dense(x, num_classes, name="fc8"))
    return ff, x_in, out


def _res_block(ff, x, channels, stride, name):
    """The basic block: conv-bn-relu, conv-bn, the shortcut (a 1x1 conv
    and bn where the stride or the width changes), add, relu."""
    h = ff.conv2d(x, channels, stride=(stride, stride), use_bias=False,
                  name=f"{name}.conv1")
    h = ff.batch_norm(h, relu=True, name=f"{name}.bn1")
    h = ff.conv2d(h, channels, use_bias=False, name=f"{name}.conv2")
    h = ff.batch_norm(h, name=f"{name}.bn2")
    if stride != 1 or x.shape[1] != channels:
        x = ff.conv2d(x, channels, kernel=(1, 1), stride=(stride, stride),
                      use_bias=False, name=f"{name}.short")
        x = ff.batch_norm(x, name=f"{name}.short_bn")
    return ff.relu(ff.add(h, x, name=f"{name}.add"), name=f"{name}.out")


def build_resnet18(config=None, mesh=None, batch=4, num_classes=10,
                   image=(3, 64, 64), device=None):
    """ResNet-18 (He et al. 2016: widths 64-512, two basic blocks a
    stage) at ``image``; returns ``(model, input, output)``."""
    ff = _model(config, mesh, device, batch)
    x_in = ff.create_tensor((batch,) + tuple(image))
    x = ff.conv2d(x_in, 64, kernel=(7, 7), stride=(2, 2), use_bias=False,
                  name="stem.conv")
    x = ff.batch_norm(x, relu=True, name="stem.bn")
    x = _pool_scaled(ff, x, "stem.pool")
    for stage, (ch, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                          (512, 2)]):
        for blk in range(2):
            x = _res_block(ff, x, ch, stride if blk == 0 else 1,
                           f"layer{stage + 1}.{blk}")
    x = ff.pool2d(x, kernel=x.shape[2:], stride=(1, 1), pool_type="avg",
                  name="gap")
    x = ff.flat(x, name="flat")
    out = ff.softmax(ff.dense(x, num_classes, name="fc"))
    return ff, x_in, out


def _inception_block(ff, x, c1, c3r, c3, c5r, c5, cp, name):
    """A GoogLeNet-style mixed block: 1x1 | 1x1-3x3 | 1x1-5x5 |
    pool-1x1, concatenated over the channels."""
    b1 = ff.conv2d(x, c1, kernel=(1, 1), activation="relu", name=f"{name}.b1")
    b3 = ff.conv2d(x, c3r, kernel=(1, 1), activation="relu",
                   name=f"{name}.b3r")
    b3 = ff.conv2d(b3, c3, kernel=(3, 3), activation="relu", name=f"{name}.b3")
    b5 = ff.conv2d(x, c5r, kernel=(1, 1), activation="relu",
                   name=f"{name}.b5r")
    b5 = ff.conv2d(b5, c5, kernel=(5, 5), activation="relu", name=f"{name}.b5")
    bp = ff.pool2d(x, kernel=(3, 3), stride=(1, 1), padding="SAME",
                   name=f"{name}.pool")
    bp = ff.conv2d(bp, cp, kernel=(1, 1), activation="relu", name=f"{name}.bp")
    return ff.concat([b1, b3, b5, bp], axis=1, name=f"{name}.cat")


def build_inception(config=None, mesh=None, batch=4, num_classes=10,
                    image=(3, 64, 64), device=None):
    """A compact Inception: a stem, two mixed blocks and the head
    (InceptionV3's parallel branches merged by a channel concat, at
    example scale); returns ``(model, input, output)``."""
    ff = _model(config, mesh, device, batch)
    x_in = ff.create_tensor((batch,) + tuple(image))
    x = ff.conv2d(x_in, 32, stride=(2, 2), activation="relu", name="stem1")
    x = ff.conv2d(x, 64, activation="relu", name="stem2")
    x = _pool_scaled(ff, x, "stem_pool")
    x = _inception_block(ff, x, 64, 48, 64, 8, 16, 32, "mixed0")
    x = _inception_block(ff, x, 64, 48, 64, 8, 16, 32, "mixed1")
    x = ff.pool2d(x, kernel=x.shape[2:], stride=(1, 1), pool_type="avg",
                  name="gap")
    x = ff.flat(x, name="flat")
    out = ff.softmax(ff.dense(x, num_classes, name="fc"))
    return ff, x_in, out
