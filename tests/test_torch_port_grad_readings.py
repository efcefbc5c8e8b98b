"""The lower-precision controls of ``tools/md17_grad_readings.py``, on the CPU.

The tool reads the MD17 grads on the card; here only its controls are held:
the mantissa rounding behind ``P<bits>`` (7 bits is bf16's rounding), the
patched attention against the plain one, and that each control restores the
plain path when it ends. Inputs are made from a seed.
"""

import numpy as np
import pytest
import torch

from lam_slide_tpu_torch.ops import attention as attention_ops
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.tools import md17_grad_readings as readings


def _weights(seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).random((64, 64), dtype=np.float32)
    return torch.from_numpy(x / x.sum(-1, keepdims=True))


def test_seven_mantissa_bits_is_bf16_rounding():
    w = _weights(0)
    assert torch.equal(readings._round_mantissa(w, 7), w.to(torch.bfloat16).float())


@pytest.mark.parametrize("bits", [3, 6])
def test_fewer_mantissa_bits_round_to_nearest(bits):
    w = _weights(bits)
    got = readings._round_mantissa(w, bits)
    assert float(((got - w).abs() / w).max()) <= 2.0 ** -(bits + 1)
    assert not torch.equal(got, w)


@pytest.mark.parametrize("name", ["repeat", "tf32", "P3"])
def test_controls_restore_the_plain_path(name):
    plain = fa.reference_attention, attention_ops.reference_attention
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 40, 16, generator=g) for _ in range(3))
    with readings._Control(name, torch.float32):
        got = attention_ops.attention(q, k, v, backend="plain")
    assert (fa.reference_attention, attention_ops.reference_attention) == plain
    assert not torch.backends.cuda.matmul.allow_tf32
    want = fa.reference_attention(q, k, v)
    if name == "P3":  # coarser weights, other dtypes untouched
        assert 0 < float((got - want).abs().max()) < 0.2
        with readings._Control(name, torch.float32):
            bf = fa.reference_attention(*(t.to(torch.bfloat16) for t in (q, k, v)))
        assert torch.equal(bf, fa.reference_attention(*(t.to(torch.bfloat16) for t in (q, k, v))))
    else:
        assert torch.equal(got, want)
