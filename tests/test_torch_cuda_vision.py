"""The conv-net and DLRM training ops on the card against the same
modules on the CPU (``chip_smoke.py`` phase 24(a)).

These tests need an NVIDIA GPU; without one each skips.  This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_vision.py

Each case of ``flexflow_tpu_torch/tools/op_parity.py`` (the shape ops;
``Conv2D`` with ``"SAME"`` at strides 1, 2 and 4, ``"VALID"``, an int
padding and two groups; ``Pool2D`` max and average, ``"SAME"`` and
``"VALID"``; ``BatchNorm`` in training and outside it;
``AddBiasResidualLayerNorm``; ``Embedding`` with ``aggr`` none, sum and
avg): the forward and every gradient from the same parameters, inputs
and cotangents within ``rtol 1e-4``, ``atol 1e-5``, float32, TF32 off.
"""

import pytest
import torch

from flexflow_tpu_torch.tools import op_parity

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(op_parity.SLICE_11C_I))
def test_op_on_the_card_equals_the_cpu(dev, name):
    assert op_parity.check(name, dev) <= 1.0
