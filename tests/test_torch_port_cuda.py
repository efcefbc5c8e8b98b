"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it runs on a machine without it; the repository's root
conftest.py imports JAX, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import math

import pytest
import torch

from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import fused_mlp as fm

pytestmark = pytest.mark.cuda

# K1 and its plain version both round the output to bf16 and round P at
# different points, so they differ by about one bf16 ulp. The limit is 2 ulps
# at the largest |out|, and the gain mean(got*want) / mean(want^2) must be
# within 1e-3 of 1: an unmasked last key tile shrinks every row (a gain of
# 0.986 at the 4AA shape, far less than 1 at the ragged one).
K1_ULPS = 2
K1_GAIN_TOL = 1e-3
# one-ulp flips of the bf16 mid / gelu(mid) roundings, times |w2| ~ 0.05.
K2_ATOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _assert_k1_close(got, want):
    got, want = got.double(), want.double()
    ulp = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= K1_ULPS * ulp
    assert abs((got * want).mean().item() / (want * want).mean().item() - 1) <= K1_GAIN_TOL


@pytest.mark.parametrize("nq,nk,heads,dh", [
    (1000, 1000, 16, 24),  # the 4AA temporal axis
    (130, 257, 3, 64),     # ragged query and key tiles
    (64, 64, 2, 128),      # widest head dim
    (1, 70, 4, 16),        # single query row
])
def test_flash_matches_plain_on_packed_views(dev, nq, nk, heads, dh):
    g = _gen()
    b = 3
    qbuf = torch.randn(b, nq, heads * dh, generator=g).to(dev, torch.bfloat16)
    kvbuf = torch.randn(b, nk, 2 * heads * dh, generator=g).to(dev, torch.bfloat16)
    q = qbuf.view(b, nq, heads, dh).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kvbuf.view(b, nk, 2, heads, dh).unbind(2))
    before = fa.launches
    got = fa.flash_attention(q, k, v, scale=0.3)
    assert fa.launches == before + 1
    want = fa.reference_attention(q, k, v, scale=0.3)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.transpose(1, 2).is_contiguous()  # packed output memory
    _assert_k1_close(got, want)


def test_flash_matches_plain_on_contiguous_headmajor(dev):
    g = _gen(1)
    q, k, v = (torch.randn(2, 4, 300, 32, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    got = fa.flash_attention(q, k, v)
    want = fa.reference_attention(q, k, v)
    _assert_k1_close(got, want)


def test_flash_refuses_what_it_cannot_take(dev):
    q = torch.zeros(1, 2, 128, 24, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)  # fp32
    wide = torch.zeros(1, 2, 128, 160, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(wide, wide, wide)  # dh > 128


@pytest.mark.parametrize("rows,d_in,d_mid,d_out", [
    (4000, 384, 768, 384),
    (37, 64, 128, 32),
])
def test_fused_mlp_matches_plain(dev, rows, d_in, d_mid, d_out):
    g = _gen(2)
    x = torch.randn(rows, d_in, generator=g).to(dev, torch.bfloat16)
    w1 = (torch.randn(d_mid, d_in, generator=g) * 0.05).to(dev, torch.bfloat16).t()
    b1 = (torch.randn(d_mid, generator=g) * 0.1).to(dev, torch.bfloat16)
    w2 = (torch.randn(d_out, d_mid, generator=g) * 0.05).to(dev, torch.bfloat16).t()
    before = fm.launches
    got = fm.fused_mlp(x, w1, b1, w2)
    assert fm.launches == before + 1
    want = fm.reference_mlp(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, d_out)
    assert (got - want).abs().max().item() <= K2_ATOL


def test_fused_mlp_refuses_row_major_weights(dev):
    x = torch.zeros(8, 32, device=dev, dtype=torch.bfloat16)
    w1 = torch.zeros(32, 64, device=dev, dtype=torch.bfloat16)  # stride(0) != 1
    b1 = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    w2 = torch.zeros(32, 64, device=dev, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError):
        fm.fused_mlp(x, w1, b1, w2)


def test_dit_kernel_path_matches_plain_path(dev):
    """A small bf16 DiT whose temporal axis (T=200) takes both kernels."""
    model = LatentDiT(depth=2, in_dim=8, hidden_size=64, num_heads=4, reference_init=False,
                      dtype=torch.bfloat16, device=dev, generator=_gen(3))
    g = _gen(4)
    x = torch.randn(2, 200, 2, 8, generator=g).to(dev)
    t = torch.tensor([0.3, 0.7], device=dev)
    mask = torch.zeros(2, 200, 2, dtype=torch.long, device=dev)
    mask[:, :1] = 1
    with torch.no_grad():
        fa_before, fm_before = fa.launches, fm.launches
        got = model(x, t, torch.zeros_like(x), mask)
        assert fa.launches == fa_before + 2 and fm.launches == fm_before + 2
        model.backend = "plain"
        want = model(x, t, torch.zeros_like(x), mask)
    # two layers of bf16 activations rounded in another order; the same limit
    # as the full-width forward in chip_smoke.py (3x its measured 3.185e-3)
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
