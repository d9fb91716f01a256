"""The MoE ops, the decode heads and the cache op on the card against the
same modules on the CPU (``chip_smoke.py`` phase 25(a)).

These tests need an NVIDIA GPU; without one each skips.  This file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_moe.py

Each case of ``flexflow_tpu_torch/tools/op_parity.py`` of slice 11c-ii
(``GroupBy`` with random gates and with planted ties, ``Experts`` with
and without a hidden layer, ``Aggregate``, ``AggregateSpec``, ``ArgMax``,
``TopK``, ``ArgTopK``, ``BeamTopK`` on logits whose largest values tie,
``Cache``): the forward and every gradient from the same parameters,
inputs and cotangents within ``rtol 1e-4``, ``atol 1e-5``, float32, TF32
off, and every index output equal element for element.  ``Sampling``:
every token inside the CPU's nucleus mask, one seed giving the same
tokens twice.
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


@pytest.mark.parametrize("name", op_parity.SLICE_11C_II)
def test_op_on_the_card_equals_the_cpu(dev, name):
    assert op_parity.check(name, dev) <= 1.0
