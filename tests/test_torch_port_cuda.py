"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it runs on a machine without it; the repository's root
conftest.py imports JAX, so skip it there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import math

import pytest
import torch

from lam_slide_tpu_torch.experiments import registry
from lam_slide_tpu_torch.models import LatentDiT
from lam_slide_tpu_torch.data.loader import device_batch
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.nn.blocks import set_backend
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import flash_normrope as fnr
from lam_slide_tpu_torch.ops import fused_adaln as fad
from lam_slide_tpu_torch.ops import fused_mlp as fm
from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
from lam_slide_tpu_torch.ops import short_attention as tsa
from lam_slide_tpu_torch.ops.ablations import fused_temporal_attention as tft
from lam_slide_tpu_torch.ops.ablations import short_backward as tsb
from lam_slide_tpu_torch.ops.packed_attention import lane_rope_tables
from lam_slide_tpu_torch.transport import Sampler, create_transport
from lam_slide_tpu_torch.train import create_train_state, make_train_step

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
# K8 against its plain version, relative to max |out|: bf16 roundings of
# linear1, the norm, the softmax weights and linear2 that land one ulp apart
# when fp32 sums are taken in another order. The limit chip_smoke.py uses:
# 3x the first reading on an H100 (4.348e-3).
K8_REL_TOL = 1.3e-2
# K4/K6 against their plain versions, relative to max |grad| per output: the
# grads round to bf16 on both sides and P and dS round to bf16 at the same
# points, but a differently summed fp32 value can land one bf16 ulp apart.
# The limits chip_smoke.py uses (3x its first readings on an H100); the gain
# of each grad must be within 1e-3 of 1, as for K1.
K4_REL_TOL = 4.5e-3
K6_REL_TOL = 8.7e-3
# The transform kernel (K5's and K6's QK RMS-norm + RoPE) against
# pre_transform: the limits chip_smoke.py uses (its comment gives the
# readings). Same rounding points; the fp32 sum of squares in another order
# than PyTorch's can put a normed value one bf16 ulp apart, which the
# rotation carries into both elements of its pair. At most
# TRANSFORM_DIFF_SHARE of the elements, or one pair, may differ.
TRANSFORM_PAIR_ULPS = 4
TRANSFORM_DIFF_SHARE = 1.8e-5
# K1/K5 lse per head dim, the limits chip_smoke.py uses (its comment gives
# the readings): fp32 sums in another order, and for K5 the bf16 rounding of
# the transformed q/k, one ulp apart where the kernel's and PyTorch's fp32
# statistics differ. Each is 3x the worst reading at its head dim over six
# seeds per shape (python -m lam_slide_tpu_torch.tools.lse_readings).
LSE_ATOL = {"K1": {24: 6e-6, 64: 9e-6, 128: 2.3e-5},
            "K5": {24: 2e-2, 64: 2.3e-5, 128: 1.1e-3}}
# K1 with fp32 operands against its plain version (fp32 cuBLAS products and
# softmax), relative to max |out|: both are exact fp32 up to the order of
# the sums and the kernel's online rescaling, a few fp32 ulps; the limit is
# chip_smoke.py's.
K1_F32_REL_TOL = 1e-5
# K9's grads against its plain backward, per grad relative to its max: both
# round P and dS to bf16 at the same points, but a weight summed in another
# order can land one bf16 ulp apart. The limit chip_smoke.py uses (3x its
# first reading at the MD17 shape); the gain must be within 1e-3 of 1.
K9_GRAD_REL_TOL = 8.6e-3
# K4 with fp32 operands and K1-fp32's lse against the plain versions: exact
# fp32 up to the order of the sums; the limits chip_smoke.py uses.
K4_F32_REL_TOL = 1e-5
LSE_F32_ATOL = 6e-6
# The MD17 stage-1 train step, kernel path vs plain path on the same dropout
# draws, fp32: (relative error of the global grad norm, worst per-tensor
# relative error). The norm's limit is chip_smoke.py's S1_GRAD_REL_TOL[0]
# (3x its readings at B=256 over seeds 0-3); this test's own point over
# seeds 0-5 (tools/md17_grad_readings.py --step-test, seed 0 the test's) on
# an H100 80GB HBM3 at 700 W reads 3.745e-8, 3.552e-10, 7.998e-8,
# 7.783e-9, 3.722e-8 and 5.640e-9, all under it and under one fp32 ulp of
# the norm (1.1e-7 of it). The per-tensor limit is 3x this test's reading
# at B=16 on an H100, 2.361e-6 (decoder.output_layers.pos.2.bias, fewer
# rows averaged).
S1_GRAD_REL_TOL = (1.5e-7, 7.1e-6)
# A depth-2 DiT's parameter grads, kernel path vs plain path (bf16): worst
# per-tensor relative error (norm of the difference over the norm); the
# limit chip_smoke.py holds the full-width DiT to at B=2.
DIT_GRAD_REL_TOL = 1.6e-2
# K10's grads (its backward is autograd of the plain packed reference, as in
# JAX) against autograd of its plain version: the two recomputes round q/k
# at different points (twice against once), so a grad moves by a bf16 ulp of
# the transformed q/k times its weight; relative to max |grad| per output.
# K11 against its plain version: K4's formulas and rounding points, so K4's
# limits (bf16) and K4-fp32's (fp32).
K10_GRAD_REL_TOL = 3e-2
K11_REL_TOL = {torch.bfloat16: K4_REL_TOL, torch.float32: K4_F32_REL_TOL}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _ulp(want):
    return 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)


def _assert_k1_close(got, want):
    got, want = got.double(), want.double()
    assert (got - want).abs().max().item() <= K1_ULPS * _ulp(want)
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


@pytest.mark.parametrize("n,heads,dh", [(1000, 16, 24), (300, 3, 128)])
def test_flash_packed_entry_matches_plain(dev, n, heads, dh):
    """K3: packed [B, N, H*dh] views of one qkv buffer in, packed out."""
    g = _gen(5)
    qkv = torch.randn(4, n, 3 * heads * dh, generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    before = fa.launches
    got = fa.flash_attention_packed(q, k, v, heads)
    assert fa.launches == before + 1
    want = fa.reference_attention_packed(q, k, v, heads)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous()
    _assert_k1_close(got, want)


def _normrope_inputs(g, dev, b, heads, n, dh):
    qkv = torch.randn(b, n, 3, heads, dh, generator=g).to(dev, torch.bfloat16) * 2
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))  # raw strided views
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(n, dh, device=dev)
    return q, k, v, qs, ks, cos, sin


def _normrope_counts():
    return (fnr.launches, fnr.transform_launches, fnr.sm90_launches, fnr.sm90_cp_async_launches,
            fnr.bwd_launches, fnr.bwd_sm90_launches, fnr.bwd_sm90_cp_async_launches)


def _launched(before, after):
    return tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("n,heads,dh", [(1000, 3, 128), (130, 4, 24), (70, 2, 64)])
def test_flash_normrope_matches_plain(dev, n, heads, dh):
    """K5 on raw strided views, with scales around 1; K1's limits. It runs
    the transform kernel once and the redesigned forward on the TMA route
    (q_t/k_t contiguous, v a view of the packed buffer), and counts nothing
    under K1."""
    args = _normrope_inputs(_gen(6), dev, 2, heads, n, dh)
    before, k1_before = _normrope_counts(), (fa.launches, fa.sm90_launches)
    got = fnr.flash_attention_normrope(*args)
    assert _launched(before, _normrope_counts()) == (1, 1, 1, 0, 0, 0, 0)
    assert (fa.launches, fa.sm90_launches) == k1_before
    want = fnr.reference_attention_normrope(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    _assert_k1_close(got, want)


def test_flash_normrope_refuses_odd_dh_and_masks(dev):
    """With a key-padding mask, K5 takes JAX's fallback: the plain
    pre-transform, then K1 with the bias (one K1-bias launch, no K5 one),
    within K1's limits of the plain composition. Odd dh still raises."""
    q, k, v, qs, ks, cos, sin = _normrope_inputs(_gen(7), dev, 2, 2, 128, 24)
    mask = torch.arange(128, device=dev)[None] < torch.tensor([[128], [77]], device=dev)
    before, k1 = _normrope_counts(), (fa.launches, fa.bias_launches)
    got = fnr.flash_attention_normrope(q, k, v, qs, ks, cos, sin, mask=mask)
    assert _launched(before, _normrope_counts()) == (0,) * 7
    assert (fa.launches - k1[0], fa.bias_launches - k1[1]) == (1, 1)
    want = fa.reference_attention(*fnr.pre_transform(q, k, qs, ks, cos, sin), v, mask=mask)
    torch.cuda.synchronize()
    _assert_k1_close(got, want)
    odd = torch.zeros(1, 2, 128, 23, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fnr.flash_attention_normrope(odd, odd, odd, qs[:23], ks[:23], cos, sin)


def _pair_ulps(got, want):
    """|got - want| per element in bf16 ulps at the magnitude of its (even,
    odd) pair of ``want`` (a rotation keeps the pair's norm, so an element
    near zero is measured against its partner's size)."""
    g, w = got.double(), want.double()
    mag = w.unflatten(-1, (-1, 2)).abs().amax(-1, keepdim=True).expand(*w.shape[:-1], -1, 2)
    unit = torch.exp2(torch.floor(torch.log2(mag.flatten(-2).clamp_min(2.0 ** -126))) - 7)
    return (g - w).abs() / unit


@pytest.mark.parametrize("b,heads,nq,nk,dh", [(2, 3, 1000, 1000, 128), (2, 16, 1000, 1000, 24),
                                              (3, 4, 130, 257, 64), (2, 2, 70, 33, 22)])
def test_qk_normrope_matches_pre_transform(dev, b, heads, nq, nk, dh):
    """The transform kernel on raw strided views of packed buffers against
    ``pre_transform``: contiguous head-major outputs, at most
    TRANSFORM_PAIR_ULPS bf16 ulps (at the pair's magnitude) on at most
    TRANSFORM_DIFF_SHARE of the elements or one pair. dh 22 takes the
    element-wise route (dh % 4 != 0)."""
    g = _gen(15)
    qbuf = (2 * torch.randn(b, nq, 3 * heads * dh, generator=g)).to(dev, torch.bfloat16)
    kbuf = (2 * torch.randn(b, nk, 3 * heads * dh, generator=g)).to(dev, torch.bfloat16)
    q = qbuf[..., :heads * dh].unflatten(-1, (heads, dh)).transpose(1, 2)
    k = kbuf[..., heads * dh:2 * heads * dh].unflatten(-1, (heads, dh)).transpose(1, 2)
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(max(nq, nk), dh, device=dev)
    before = fnr.transform_launches
    got = fnr.qk_normrope(q, k, qs, ks, cos, sin)
    assert fnr.transform_launches == before + 1
    want = fnr.pre_transform(q, k, qs, ks, cos, sin)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.is_contiguous() and a.shape == w.shape and a.dtype == torch.bfloat16
        ulps = _pair_ulps(a, w)
        assert ulps.max().item() <= TRANSFORM_PAIR_ULPS
        assert int((ulps > 0).sum()) <= max(2, int(TRANSFORM_DIFF_SHARE * ulps.numel()))


@pytest.mark.parametrize("b,h,nq,nk,dh,route", [
    (2, 3, 300, 300, 128, "tma"), (3, 2, 130, 257, 128, "tma"), (2, 3, 200, 333, 128, "cp.async"),
])
def test_normrope_function_takes_the_sm90_pair(dev, b, h, nq, nk, dh, route):
    """``_FlashNormRope`` at dh 128: one transform and one redesigned forward
    per forward, the redesigned backward (three kernels) per backward with no
    second transform, on the TMA route, or on the cp.async route when v's
    base is not 16-byte aligned (a view one element into its buffer); the
    grads of q, k, v and both scales against autograd of the plain version,
    to K6's limit, and no launch under K1's or K4's counters."""
    g = _gen(16)
    qbuf = (2 * torch.randn(b, nq, h * dh, generator=g)).to(dev, torch.bfloat16)
    kvbuf = (2 * torch.randn(b, nk, 2 * h * dh + 8, generator=g)).to(dev, torch.bfloat16)
    v0 = h * dh + (1 if route == "cp.async" else 0)

    def views(qb, kvb):
        return (qb.unflatten(-1, (h, dh)).transpose(1, 2),
                kvb[..., :h * dh].unflatten(-1, (h, dh)).transpose(1, 2),
                kvb[..., v0:v0 + h * dh].unflatten(-1, (h, dh)).transpose(1, 2))

    assert fa.sm90_tma_ok(views(qbuf, kvbuf)[2]) == (route == "tma")
    scales = [(1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2)]
    cos, sin = rope_cos_sin(max(nq, nk), dh, device=dev)
    grad = torch.randn(b, h, nq, dh, generator=g).to(dev, torch.bfloat16)
    grads = {}
    for fn in (fnr.flash_attention_normrope, fnr.reference_attention_normrope):
        # the buffers are the leaves, so q/k/v stay strided views of them
        leaves = [t.detach().clone().requires_grad_() for t in (qbuf, kvbuf, *scales)]
        before, k14 = _normrope_counts(), (fa.launches, fa.bwd_kv_launches)
        (fn(*views(*leaves[:2]), *leaves[2:], cos, sin).float() * grad.float()).sum().backward()
        if fn is fnr.flash_attention_normrope:
            cp = route == "cp.async"
            assert _launched(before, _normrope_counts()) == (1, 1, 1, int(cp), 1, 3, int(cp))
            assert (fa.launches, fa.bwd_kv_launches) == k14
        grads[fn] = [*views(leaves[0].grad, leaves[1].grad), leaves[2].grad, leaves[3].grad]
    got, want = grads.values()
    _assert_grads_close(got[:3], want[:3], K6_REL_TOL)
    for a, w in zip(got[3:], want[3:]):  # the scales: sums over every row
        assert (a - w).norm().item() <= 1.6e-2 * w.norm().item()


@pytest.mark.parametrize("b,t,l,d", [(8, 1000, 2, 384), (3, 37, 4, 64), (320, 30, 192, 256),
                                     (2, 5, 3, 30)])
def test_adaln_matches_plain(dev, b, t, l, d):
    """K7: x_new bit-identical; y within 1 bf16 ulp at max |y|. h is the
    transposed view the DiT's temporal block hands over, and the mods are
    chunks of one [B, 1, 1, 6D] tensor: at the 4AA and MD17 shapes (8-byte
    and 16-byte accesses), a small one and one with D = 30 (4-byte
    accesses, lanes idle)."""
    g = _gen(8)
    x = torch.randn(b, t, l, d, generator=g).to(dev, torch.bfloat16) * 3
    h = torch.randn(b, l, t, d, generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    mods = (torch.randn(b, 1, 1, 6 * d, generator=g) * 0.5).to(dev, torch.bfloat16)
    shift, scale, gate = mods.chunk(6, dim=-1)[:3]
    before = fad.launches
    x_new, y = fad.residual_adaln_modulate(x, h, gate, shift, scale)
    y0 = fad.adaln_modulate(x, shift, scale)
    assert fad.launches == before + 2
    want_x, want_y = fad.reference_residual_adaln_modulate(x, h, gate, shift, scale)
    want_y0 = fad.reference_adaln_modulate(x, shift, scale)
    torch.cuda.synchronize()
    assert torch.equal(x_new, want_x)
    for got, want in ((y, want_y), (y0, want_y0)):
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert (got.float() - want.float()).abs().max().item() <= _ulp(want.float())


def test_adaln_refusals_after_a_kept_signature(dev):
    """K7's wrapper keeps the checked launch arguments per signature (shapes,
    strides, dtypes, devices, 4-byte alignment): after a good call, every
    operand it refuses still raises ValueError: a modulation row two bytes
    off 4-byte alignment, h with an odd stride, a non-contiguous x, fp32 x
    or h."""
    g = _gen(11)
    x = torch.randn(2, 9, 3, 64, generator=g).to(dev, torch.bfloat16)
    h = torch.randn(2, 3, 9, 64, generator=g).to(dev, torch.bfloat16).transpose(1, 2)
    shift, scale, gate = (torch.randn(2, 1, 1, 384, generator=g) * 0.5).to(
        dev, torch.bfloat16).chunk(6, dim=-1)[:3]
    fad.residual_adaln_modulate(x, h, gate, shift, scale)
    fad.adaln_modulate(x, shift, scale)
    odd_gate = torch.zeros(2, 1, 1, 65, dtype=torch.bfloat16, device=dev)[..., 1:]
    odd_h = torch.zeros(2, 3, 9, 65, dtype=torch.bfloat16, device=dev)[..., :64].transpose(1, 2)
    bad = [(x, h, odd_gate, shift, scale), (x, h, gate, odd_gate, scale),
           (x, odd_h, gate, shift, scale), (x.transpose(1, 2), h, gate, shift, scale),
           (x.float(), h, gate, shift, scale), (x, h.float(), gate, shift, scale)]
    for args in bad:
        with pytest.raises(ValueError):
            fad.residual_adaln_modulate(*args)
    with pytest.raises(ValueError):
        fad.adaln_modulate(x, shift, odd_gate)


def _spatial_inputs(g, dev, n, l, d, m, heads):
    dh = d // heads
    x = torch.randn(n, l, d, generator=g).to(dev, torch.bfloat16)
    w1 = (torch.randn(3 * d + m, d, generator=g) * d ** -0.5).to(dev, torch.bfloat16)
    b1 = (torch.randn(3 * d + m, generator=g) * 0.1).to(dev, torch.bfloat16)
    w2 = (torch.randn(d, d + m, generator=g) * (d + m) ** -0.5).to(dev, torch.bfloat16)
    b2 = (torch.randn(d, generator=g) * 0.1).to(dev, torch.bfloat16)
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(l, dh, device=dev)
    return x, w1, b1, qs, ks, w2, b2, cos, sin, heads, dh ** -0.5


@pytest.mark.parametrize("n,l,d,m,heads", [
    (2000, 2, 384, 768, 16),  # the 4AA spatial axis, 16 x 24 (B=2)
    (2000, 2, 384, 768, 3),   # 3 x 128
    (8000, 2, 384, 768, 16),  # B=8
    (8000, 2, 384, 768, 3),
    (4000, 1, 384, 768, 16),  # one position a frame
    (1333, 3, 384, 768, 3),   # 63-row tiles of 21 frames
    (500, 8, 384, 768, 16),   # eight positions a frame
    (777, 5, 256, 512, 16),   # the NBA DiT's width, 16 x 16
    (901, 7, 128, 256, 4),    # the pedestrian DiT's, 4 x 32
    (37, 4, 32, 64, 4),       # ragged frame block, dh 8 (WMMA route)
    (5, 3, 32, 64, 1),        # L that does not divide the block (WMMA route)
])
def test_spatial_block_matches_plain(dev, n, l, d, m, heads):
    """K8 on the route ``sm90_plan`` picks (the Hopper kernel at every
    composite's width, the WMMA route at hidden 32), within K8_REL_TOL of
    its plain version; a second call on the same inputs is bit-identical."""
    args = _spatial_inputs(_gen(9), dev, n, l, d, m, heads)
    before = (fsb.launches, fsb.wmma_launches)
    got = fsb.fused_spatial_block(*args)
    wmma = fsb.sm90_plan(n, l, d, m, heads) is None
    assert wmma == (d == 32)
    assert (fsb.launches - before[0], fsb.wmma_launches - before[1]) == (1, int(wmma))
    want = fsb.reference_spatial_block(*args)
    again = fsb.fused_spatial_block(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K8_REL_TOL * want.float().abs().max().item()


@pytest.mark.parametrize("n,l,d,m,heads,size,fp32,route", [
    (2000, 2, 384, 768, 16, 2, False, "sm90"),  # 4AA 16 x 24 at tp 2: Da 192, Mr 384
    (2000, 2, 384, 768, 16, 4, False, "sm90"),  # tp 4: Da 96, Mr 192
    (2000, 2, 384, 768, 3, 3, False, "sm90"),   # 3 x 128 at tp 3: one head, Da 128, Mr 256
    (777, 5, 256, 512, 16, 2, False, "sm90"),   # the NBA DiT's width at tp 2
    (901, 7, 128, 256, 4, 2, False, "sm90"),    # the pedestrian DiT's at tp 2
    (2000, 2, 384, 768, 16, 8, False, "wmma"),  # 16 x 24 at tp 8: Da 48 under a group of 96
    (901, 7, 128, 256, 4, 4, False, "wmma"),    # the pedestrian DiT at tp 4: Da 32 under 64
    (777, 5, 256, 512, 16, 8, False, "wmma"),   # NBA at tp 8: Da 32 under 64
    (37, 4, 32, 64, 4, 4, False, "wmma"),       # the tiny width at tp 4: Da 8, padded sections
    (2000, 2, 384, 768, 16, 2, True, "tiled"),  # fp32: the outer-product kernel, one MLP pass
    (2000, 2, 384, 768, 16, 4, True, "tiled"),  # Mr 192: a pass padded to D
    (2000, 2, 384, 768, 3, 3, True, "tiled"),   # Mr 256
    (777, 5, 256, 512, 16, 4, True, "tiled"),   # NBA tp 4: Mr 128 of a 256 pass
    (2000, 2, 384, 768, 16, 8, True, "dot"),    # below an instance's head group
    (901, 7, 128, 256, 4, 4, True, "dot"),
    (777, 5, 256, 512, 16, 8, True, "dot"),
    (37, 4, 32, 64, 4, 2, True, "dot"),         # the tiny width at tp 2: Da 16
])
def test_spatial_block_rank_partial_matches_plain(request, dev, n, l, d, m, heads, size, fp32,
                                                  route):
    """K8's per-rank instance (tensor parallelism), on every route: each
    rank's fp32 partial within K8_REL_TOL (bf16) or F32_REL_TOL["K8"] (fp32,
    TF32 off) of its plain version, a second call bit-identical, counted
    under ``tp_partial_launches`` and the route's counter (the Hopper kernel
    where ``sm90_plan`` has a plan, else WMMA; the fp32 routes of
    ``f32_plan``), an fp32 partial bit-identical to the dot-product route's;
    the ranks' partials summed, rounded and + b2 within the same limit of
    the whole block's kernel."""
    from lam_slide_tpu_torch.parallel import tp

    if fp32:
        request.getfixturevalue("no_tf32")
    make = _spatial_inputs_f32 if fp32 else _spatial_inputs
    x, w1, b1, qs, ks, w2, b2, cos, sin, _, scale = make(_gen(11), dev, n, l, d, m, heads)
    tol = F32_REL_TOL["K8"] if fp32 else K8_REL_TOL
    kw = {"attn_width": d // size, "partial": True}
    names = ("tp_partial_launches", "wmma_launches", "f32_tiled_launches", "f32_dot_launches")
    want_counts = (1, int(route == "wmma"), int(route == "tiled"), int(route == "dot"))
    parts = []
    for r in range(size):
        args = (x, tp.slice_linear1(w1, d, m, size, r), tp.slice_linear1(b1, d, m, size, r), qs,
                ks, tp.slice_linear2(w2, d, m, size, r), None, cos, sin, heads // size, scale)
        before = [getattr(fsb, name) for name in names]
        got = fsb.fused_spatial_block(*args, **kw)
        assert _launched(before, [getattr(fsb, name) for name in names]) == want_counts
        want = fsb.reference_spatial_block(*args, **kw)
        again = fsb.fused_spatial_block(*args, **kw)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert torch.equal(got, again)
        if fp32:
            assert torch.equal(got, fsb._launch_f32_dot(*args, **kw))
        err = (got - want).abs().max().item()
        assert err <= tol * want.abs().max().item()
        parts.append(got)
    whole = fsb.fused_spatial_block(x, w1, b1, qs, ks, w2, b2, cos, sin, heads, scale)
    summed = (sum(parts[1:], parts[0]).to(x.dtype) + b2).float()
    assert (summed - whole.float()).abs().max().item() <= tol * whole.float().abs().max()


def test_sharded_dit_forward_matches_the_whole_one(dev, no_tf32):
    """A 4AA-width DiT (depth 2) with every block split into two shards in
    this process: the forward within the kernel-vs-plain model limit of the
    whole model's, K8 launching only its partial instance; the same in fp32
    (TF32 off), where the partials run on K8-fp32's outer-product route and
    the sharded forward is within 1e-5 of the whole one's largest output
    (only the order of fp32 sums differs)."""
    from lam_slide_tpu_torch.parallel import tp

    def make(dtype):
        return LatentDiT(depth=2, in_dim=8, hidden_size=384, num_heads=16, reference_init=False,
                         dtype=dtype, device=dev, generator=_gen(12))

    g = _gen(13)
    x = torch.randn(2, 50, 2, 8, generator=g).to(dev)
    mask = torch.zeros(2, 50, 2, dtype=torch.long, device=dev)
    mask[:, :1] = 1
    t = torch.full((2,), 0.5, device=dev)
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        model = make(dtype)
        with torch.no_grad():
            want = model(x, t, x * mask[..., None], mask)
            tp.shard_model(model, tp.in_process(2))
            before = (fsb.launches, fsb.tp_partial_launches, fsb.f32_tiled_launches)
            got = model(x, t, x * mask[..., None], mask)
        launched = _launched(before, (fsb.launches, fsb.tp_partial_launches,
                                      fsb.f32_tiled_launches))
        assert launched == (4, 4, 4 if dtype == torch.float32 else 0)
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def test_spatial_block_refuses_a_misaligned_x_on_the_hopper_route(dev):
    """The Hopper kernel loads x by TMA: a view of x one element into its
    buffer raises instead of taking another route."""
    args = list(_spatial_inputs(_gen(10), dev, 64, 2, 128, 256, 4))
    x = torch.empty(64 * 2 * 128 + 1, dtype=torch.bfloat16, device=dev)[1:].view(64, 2, 128)
    x.copy_(args[0])
    with pytest.raises(ValueError):
        fsb.fused_spatial_block(x, *args[1:])


def _k4_kernels(dtype, dh, nq, nk):
    """Kernels of one K4 call on the older template: the bf16 pair (with the
    bias), or an fp32 one-pass kernel and, where it keeps more than one key
    tile's dQ shares, their sum."""
    if dtype != torch.float32:
        return 2
    return 1 + (fa.f32_dq_tiles(dh, nq, nk) > 1)


def _heads_views(g, dev, b, h, nq, nk, dh, scale=1.0):
    """q, k, v as head-major strided views of packed buffers, and a
    head-major output gradient."""
    qbuf = (torch.randn(b, nq, h * dh, generator=g) * scale).to(dev, torch.bfloat16)
    kvbuf = (torch.randn(b, nk, 2 * h * dh, generator=g) * scale).to(dev, torch.bfloat16)
    q = qbuf.view(b, nq, h, dh).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kvbuf.view(b, nk, 2, h, dh).unbind(2))
    grad = torch.randn(b, h, nq, dh, generator=g).to(dev, torch.bfloat16)
    return q, k, v, grad


def _assert_grads_close(got, want, tol):
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        a, w = a.double(), w.double()
        assert (a - w).abs().max().item() <= tol * w.abs().max().item()
        assert abs((a * w).mean().item() / (w * w).mean().item() - 1) <= K1_GAIN_TOL


SHAPES_BWD = [
    (2, 16, 1000, 1000, 24),  # the 4AA temporal axis, 16 x 24
    (3, 3, 130, 257, 64),     # ragged query and key tiles
    (2, 3, 300, 300, 128),    # 3 x 128
]


@pytest.mark.parametrize("b,h,nq,nk,dh", SHAPES_BWD)
def test_flash_lse_matches_plain(dev, b, h, nq, nk, dh):
    """K1's and K5's lse outputs, and that asking for lse leaves out unchanged."""
    g = _gen(10)
    q, k, v, _ = _heads_views(g, dev, b, h, nq, nk, dh)
    out, lse = fa._forward(q, k, v, 0.3, with_lse=True)
    want_out, want_lse = fa.reference_attention(q, k, v, 0.3, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, nq) and lse.dtype == torch.float32
    assert torch.equal(out, fa._forward(q, k, v, 0.3, with_lse=False)[0])
    err = (lse - want_lse).abs().max().item()
    assert err <= LSE_ATOL["K1"][dh], f"K1 lse err {err}"
    if dh % 2 == 0:
        qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
        cos, sin = rope_cos_sin(max(nq, nk), dh, device=dev)
        _, lse5 = fnr._forward(q, k, v, qs, ks, cos, sin, 0.3, with_lse=True)
        _, want5 = fa.reference_attention(*fnr.pre_transform(q, k, qs, ks, cos, sin), v, 0.3,
                                          return_lse=True)
        err = (lse5 - want5).abs().max().item()
        assert err <= LSE_ATOL["K5"][dh], f"K5 lse err {err}"


@pytest.mark.parametrize("b,h,nq,nk,dh", SHAPES_BWD)
def test_flash_backward_matches_plain(dev, b, h, nq, nk, dh):
    """K4 on strided views, from K1's out and lse; grads in packed memory."""
    q, k, v, grad = _heads_views(_gen(11), dev, b, h, nq, nk, dh)
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True)
    before = (fa.bwd_kv_launches, fa.bwd_q_launches)
    got = fa.flash_attention_backward(q, k, v, out, lse, grad, dh ** -0.5)
    assert (fa.bwd_kv_launches, fa.bwd_q_launches) == (before[0] + 1, before[1] + 1)
    want = fa.reference_flash_backward(q, k, v, out, lse, grad, dh ** -0.5)
    torch.cuda.synchronize()
    assert all(t.transpose(1, 2).is_contiguous() for t in got)
    _assert_grads_close(got, want, K4_REL_TOL)


@pytest.mark.parametrize("b,h,n,dh", [(4200, 16, 130, 24), (22000, 3, 20, 128),
                                      (4100, 16, 130, 16)])
def test_flash_grids_take_more_than_65535_batch_heads(dev, b, h, n, dh):
    """The flash kernels launch on one grid axis of (batch·head, tile)
    pairs. Past gridDim.y's cap of 65,535 pairs (the MD17 DiT's spatial axis
    has 153,600), K1 and K4 at dh 24 and 16 (the redesigned kernels), and K5
    and K6 at dh 128, still match their plain versions."""
    g = _gen(13)
    q, k, v, grad = _heads_views(g, dev, b, h, n, n, dh, scale=1.0 if dh % 128 else 2.0)
    scale = dh ** -0.5
    if dh % 128:
        before = (fa.sm90_launches, fa.bwd_sm90_launches)
        out, lse = fa._forward(q, k, v, scale, with_lse=True)
        assert fa.sm90_launches == before[0] + 1
        _assert_k1_close(out, fa.reference_attention(q, k, v, scale))
        args = (q, k, v, out, lse, grad, scale)
        kernel, plain, tol = fa.flash_attention_backward, fa.reference_flash_backward, K4_REL_TOL
    else:
        qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
        cos, sin = rope_cos_sin(n, dh, device=dev)
        out, lse = fnr._forward(q, k, v, qs, ks, cos, sin, scale, with_lse=True)
        _assert_k1_close(out, fnr.reference_attention_normrope(q, k, v, qs, ks, cos, sin, scale))
        args = (q, k, v, qs, ks, cos, sin, out, lse, grad, scale)
        kernel, plain, tol = (fnr.flash_attention_normrope_backward,
                              fnr.reference_normrope_backward, K6_REL_TOL)
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, tol)


@pytest.mark.parametrize("b,h,nq,nk,dh", SHAPES_BWD)
def test_flash_normrope_backward_matches_plain(dev, b, h, nq, nk, dh):
    """K6: grads with respect to the transformed q/k, and dv."""
    g = _gen(12)
    q, k, v, grad = _heads_views(g, dev, b, h, nq, nk, dh, scale=2.0)
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(max(nq, nk), dh, device=dev)
    out, lse = fnr._forward(q, k, v, qs, ks, cos, sin, dh ** -0.5, with_lse=True)
    before, k4_before = _normrope_counts(), (fa.bwd_kv_launches, fa.bwd_sm90_launches)
    args = (q, k, v, qs, ks, cos, sin, out, lse, grad, dh ** -0.5)
    got = fnr.flash_attention_normrope_backward(*args)
    assert _launched(before, _normrope_counts()) == (0, 1, 0, 0, 1, 3, 0)
    assert (fa.bwd_kv_launches, fa.bwd_sm90_launches) == k4_before
    want = fnr.reference_normrope_backward(*args)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, K6_REL_TOL)


def test_flash_refuses_what_it_cannot_take(dev):
    q = torch.zeros(1, 2, 128, 160, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)  # fp32 with dh > 128
    wide = torch.zeros(1, 2, 128, 160, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(wide, wide, wide)  # dh > 128
    with pytest.raises(ValueError):
        fa.flash_attention(wide[..., :16], wide[..., :16], wide[..., :16],
                           mask=torch.ones(1, 64, dtype=torch.bool, device=dev))  # [B, 128]


def _key_mask(g, dev, b, nk):
    """Ragged key-padding mask; batch row 0 fully masked."""
    lengths = torch.randint(1, nk + 1, (b,), generator=g)
    mask = torch.arange(nk)[None, :] < lengths[:, None]
    mask[0] = False
    return mask.to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,nq,nk,dh", [
    (4, 8, 192, 50, 16),    # the MD17 encoder's cross-attention
    (3, 2, 192, 192, 16),   # its self-attention
    (3, 3, 130, 257, 24),   # ragged: keys not a multiple of either tile
])
def test_flash_with_mask_matches_plain(dev, dtype, b, h, nq, nk, dh):
    """K1 with the key-padding bias row (an all-masked row gets uniform
    weights over its keys on both sides), in bf16 and with fp32 operands;
    counted under its variant counters."""
    g = _gen(15)
    q, k, v, _ = _heads_views(g, dev, b, h, nq, nk, dh)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    mask = _key_mask(g, dev, b, nk)
    before = (fa.launches, fa.bias_launches, fa.fp32_launches)
    got = fa.flash_attention(q, k, v, mask=mask)
    fp32 = dtype == torch.float32
    assert (fa.launches, fa.bias_launches, fa.fp32_launches) == (
        before[0] + 1, before[1] + 1, before[2] + fp32)
    want = fa.reference_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if fp32:
        err = (got - want).abs().max().item()
        assert err <= K1_F32_REL_TOL * want.abs().max().item()
        unmasked = fa.flash_attention(q, k, v)
        assert not torch.allclose(unmasked[0], got[0])
    else:
        _assert_k1_close(got, want)
    torch.testing.assert_close(got[0].float(), v[0].float().mean(dim=1, keepdim=True)
                               .expand_as(got[0]), atol=2e-2 if not fp32 else 1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,nq,nk,dh", [
    (4, 8, 192, 32, 16),    # the MD17 encoder's cross-attention
    (3, 3, 130, 257, 24),   # ragged: keys not a multiple of either tile
])
def test_flash_backward_with_mask_matches_plain(dev, dtype, b, h, nq, nk, dh):
    """K4 with the key-padding bias row (batch row 0 all masked: each of its
    keys gets P = 1, as in JAX), through the autograd path of a masked
    flash call, against the plain backward on the same out and lse."""
    g = _gen(19)
    q, k, v, grad = _heads_views(g, dev, b, h, nq, nk, dh)
    q, k, v, grad = (t.to(dtype) for t in (q, k, v, grad))
    mask = _key_mask(g, dev, b, nk)
    fp32 = dtype == torch.float32
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True, mask=mask)
    want = fa.reference_flash_backward(q, k, v, out, lse, grad, dh ** -0.5, fa.mask_to_bias(mask))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (fa.bwd_kv_launches, fa.bwd_q_launches, fa.bwd_bias_launches, fa.bwd_fp32_launches)
    fa.flash_attention(*leaves, mask=mask).backward(grad)
    torch.cuda.synchronize()
    n = _k4_kernels(dtype, dh, nq, nk)
    assert (fa.bwd_kv_launches, fa.bwd_q_launches, fa.bwd_bias_launches,
            fa.bwd_fp32_launches) == (before[0] + 1, before[1] + 1, before[2] + n,
                                      before[3] + n * fp32)
    _assert_grads_close([t.grad for t in leaves], want, K4_F32_REL_TOL if fp32 else K4_REL_TOL)


@pytest.mark.parametrize("b,h,nq,nk,dh", [(3, 2, 192, 192, 16), (2, 3, 130, 257, 64)])
def test_flash_fp32_lse_and_backward_match_plain(dev, b, h, nq, nk, dh):
    """K1-fp32's lse (and that asking for it leaves out unchanged), and K4's
    fp32 kernels on strided views, grads in packed memory."""
    q, k, v, grad = (t.float() for t in _heads_views(_gen(20), dev, b, h, nq, nk, dh))
    out, lse = fa._forward(q, k, v, 0.3, with_lse=True)
    _, want_lse = fa.reference_attention(q, k, v, 0.3, return_lse=True)
    assert torch.equal(out, fa._forward(q, k, v, 0.3, with_lse=False)[0])
    assert (lse - want_lse).abs().max().item() <= LSE_F32_ATOL
    before = fa.bwd_fp32_launches
    got = fa.flash_attention_backward(q, k, v, out, lse, grad, 0.3)
    assert fa.bwd_fp32_launches == before + _k4_kernels(torch.float32, dh, nq, nk)
    want = fa.reference_flash_backward(q, k, v, out, lse, grad, 0.3)
    torch.cuda.synchronize()
    assert all(t.dtype == torch.float32 and t.transpose(1, 2).is_contiguous() for t in got)
    _assert_grads_close(got, want, K4_F32_REL_TOL)


def test_md17_first_stage_step_on_the_card(dev):
    """One MD17 stage-1 train step at full width (fp32, 192 latents, 32 padded
    atoms) on 16 frames of the registry's loader: K1 three times (one with
    the bias) and K4 three times, all fp32; every grad finite and non-zero
    and within chip_smoke.py's limits of the plain path on the same dropout
    draws."""
    run = registry.md17_first_stage(device=dev)
    batch = {k: v[:16] for k, v in device_batch(next(iter(run.train_loader)), dev).items()}
    before = (fa.launches, fa.bias_launches, fa.fp32_launches, fa.bwd_kv_launches,
              fa.bwd_q_launches, fa.bwd_bias_launches, fa.bwd_fp32_launches)
    state = create_train_state(run.model, run.tx)
    state, metrics = make_train_step(run.loss_fn, run.tx)(state, batch, 0)
    after = (fa.launches, fa.bias_launches, fa.fp32_launches, fa.bwd_kv_launches,
             fa.bwd_q_launches, fa.bwd_bias_launches, fa.bwd_fp32_launches)
    cross = _k4_kernels(torch.float32, 16, 192, 32)  # the encoder's, with the bias
    latent = _k4_kernels(torch.float32, 16, 192, 192)  # the two latent self-attentions
    assert tuple(a - b for a, b in zip(after, before)) == (3, 1, 3, 3, 3, cross,
                                                            cross + 2 * latent)
    assert torch.isfinite(metrics["loss"])

    def grads():
        run.model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=dev).manual_seed(1)
        run.loss_fn(run.model, batch, gen, True)[0].backward()
        return {n: p.grad.clone() for n, p in run.model.named_parameters()}

    got = grads()
    set_backend(run.model, "plain")
    want = grads()
    assert all(bool(torch.isfinite(gr).all()) and gr.abs().max() > 0 for gr in got.values())
    # in fp64, as chip_smoke.py's _global_norm: an fp32 norm rounds both
    # paths' norms to a grid of one ulp, coarser than the limit
    norm = lambda gs: torch.stack([gr.double().norm() for gr in gs.values()]).norm().item()
    assert abs(norm(got) - norm(want)) <= S1_GRAD_REL_TOL[0] * norm(want)
    for name, gr in got.items():
        assert (gr - want[name]).norm() <= S1_GRAD_REL_TOL[1] * want[name].norm(), name


def _short_views(g, dev, b, n, heads, dh):
    """q/k as contiguous packed [B, n, H*dh] tensors and v a view of a
    wider buffer, as the DiT's temporal block hands them over."""
    q, k = (torch.randn(b, n, heads * dh, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    v = torch.randn(b, n, 3 * heads * dh, generator=g).to(dev, torch.bfloat16)[..., -heads * dh:]
    return q, k, v


@pytest.mark.parametrize("b,n,heads,dh", [
    (256, 30, 16, 16),   # the MD17 temporal axis
    (7, 9, 3, 24),       # shortest axis, dh padded to 32
    (5, 31, 2, 64),      # one past a warp of rows
    (3, 127, 4, 16),     # longest axis
    (6, 15, 5, 16),      # one 16-row query block, ragged
    (6, 16, 3, 32),      # exactly one query block
    (6, 17, 11, 8),      # one past it; 11 heads in groups of 6 and 5
    (4, 32, 16, 16),     # the longest one-pass item
    (4, 33, 2, 16),      # the shortest three-pass item
    (3, 63, 3, 24),      # key blocks of 32, ragged
    (3, 64, 2, 64),      # exactly two key blocks at dh 64 (one head a block)
    (3, 65, 3, 32),      # one past them
])
def test_short_attention_matches_plain(dev, b, n, heads, dh):
    """K9 forward (K1's limits) and its backward kernel against the plain
    backward, per grad (K4's limit and gain); the autograd Function routes a
    backward through the kernel."""
    g = _gen(16)
    q, k, v = _short_views(g, dev, b, n, heads, dh)
    before = tsa.launches
    got = tsa.short_attention(q, k, v, heads)
    assert tsa.launches == before + 1
    want = tsa.reference_short_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_k1_close(got, want)
    assert torch.equal(got, tsa.short_attention(q, k, v, heads))  # no atomics

    grad = torch.randn(b, n, heads * dh, generator=g).to(dev, torch.bfloat16)
    scale = dh ** -0.5
    before = tsa.bwd_launches
    grads = tsa.short_attention_backward(q, k, v, grad, heads, scale)
    assert tsa.bwd_launches == before + 1
    _assert_grads_close(grads, tsa.reference_short_backward(q, k, v, grad, heads, scale),
                        K9_GRAD_REL_TOL)
    # no atomics: a second call repeats bit for bit
    again = tsa.short_attention_backward(q, k, v, grad, heads, scale)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    # a non-contiguous output gradient (a view of a wider buffer) reads in place
    wide = torch.randn(b, n, 2 * heads * dh, generator=g).to(dev, torch.bfloat16)
    g_view = wide[..., heads * dh:]
    _assert_grads_close(tsa.short_attention_backward(q, k, v, g_view, heads, scale),
                        tsa.reference_short_backward(q, k, v, g_view, heads, scale),
                        K9_GRAD_REL_TOL)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (tsa.launches, tsa.bwd_launches)
    tsa.short_attention(*leaves, heads).backward(grad)
    assert (tsa.launches, tsa.bwd_launches) == (before[0] + 1, before[1] + 1)
    for leaf, want_grad in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, want_grad, atol=0, rtol=0)


def test_md17_dit_kernel_path_matches_plain_path(dev):
    """The MD17 stage-2 DiT's widths (hidden 256, 16 x dh 16, L=192, T=30)
    at depth 1: K3 on the spatial axis and K9 on the temporal axis, one each
    per forward, against the plain path; grads through K9's backward and K4."""
    model = LatentDiT(depth=1, in_dim=32, hidden_size=256, num_heads=16, vec_in_dim=256,
                      reference_init=False, dtype=torch.bfloat16, device=dev,
                      generator=_gen(17))
    g = _gen(18)
    x = torch.randn(2, 30, 192, 32, generator=g).to(dev)
    t = torch.tensor([0.3, 0.7], device=dev)
    mask = torch.zeros(2, 30, 192, dtype=torch.long, device=dev)
    mask[:, :10] = 1
    x_cond, y = x * mask[..., None], torch.randn(2, 256, generator=g).to(dev)
    with torch.no_grad():
        before = (fa.launches, tsa.launches)
        got = model(x, t, x_cond, mask, y)
        assert (fa.launches - before[0], tsa.launches - before[1]) == (1, 1)
        model.backend = "plain"
        want = model(x, t, x_cond, mask, y)
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    grads = {}
    for backend in ("auto", "plain"):
        model.backend = backend
        model.zero_grad(set_to_none=True)
        before = (tsa.bwd_launches, fa.bwd_kv_launches)
        model(x, t, x_cond, mask, y).square().mean().backward()
        launched = (tsa.bwd_launches - before[0], fa.bwd_kv_launches - before[1])
        assert launched == ((1, 1) if backend == "auto" else (0, 0))
        grads[backend] = {n: p.grad for n, p in model.named_parameters()}
    for name, got_grad in grads["auto"].items():
        want_grad = grads["plain"][name]
        assert bool(torch.isfinite(got_grad).all()), name
        err = (got_grad - want_grad).norm().item()
        assert err <= DIT_GRAD_REL_TOL * want_grad.norm().item(), name


def _mlp_inputs(g, dev, rows, d_in, d_mid, d_out, x_offset=0):
    """x [rows, d_in] (from element x_offset of a flat buffer) and the MLP
    slices as transposed nn.Linear weights."""
    flat = torch.randn(rows * d_in + x_offset, generator=g).to(dev, torch.bfloat16)
    x = flat[x_offset:].view(rows, d_in)
    w1 = (torch.randn(d_mid, d_in, generator=g) * 0.05).to(dev, torch.bfloat16).t()
    b1 = (torch.randn(d_mid, generator=g) * 0.1).to(dev, torch.bfloat16)
    w2 = (torch.randn(d_out, d_mid, generator=g) * 0.05).to(dev, torch.bfloat16).t()
    return x, w1, b1, w2


@pytest.mark.parametrize("rows,d_in,d_mid,d_out", [
    (4000, 384, 768, 384),
    (37, 64, 128, 32),
    (1, 16, 32, 16),          # one row; hidden 16 of the test configs
    (129, 32, 64, 32),        # one past a 128-row tile; hidden 32
    (300, 128, 256, 128),     # pedestrian's hidden
    (513, 256, 512, 256),     # MD17 and NBA's hidden, ragged rows
    (16000, 384, 768, 384),   # the 4AA sampling shape at B=8
    (1000, 48, 80, 272),      # widths off every tile: two output passes
    (368640, 256, 512, 256),  # the MD17 stage-2 train step
])
def test_fused_mlp_matches_plain(dev, rows, d_in, d_mid, d_out):
    """The Hopper K2 (x by TMA) against its plain version within K2_ATOL; a
    second call repeats bit for bit (no atomics)."""
    x, w1, b1, w2 = _mlp_inputs(_gen(2), dev, rows, d_in, d_mid, d_out)
    before = (fm.launches, fm.wmma_launches, fm.cp_async_launches)
    got = fm.fused_mlp(x, w1, b1, w2)
    assert (fm.launches, fm.wmma_launches, fm.cp_async_launches) == (before[0] + 1, *before[1:])
    want = fm.reference_mlp(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, d_out)
    assert (got - want).abs().max().item() <= K2_ATOL
    assert torch.equal(got, fm.fused_mlp(x, w1, b1, w2))


def test_fused_mlp_routes_and_their_counters(dev):
    """x at an odd element offset takes the Hopper kernel's cp.async route;
    d_in 1024 (no shared-memory plan) the WMMA route; each counts its own
    counter beside ``launches`` and matches the plain version."""
    g = _gen(3)
    for case, (rows, d_in, d_mid, d_out, off), counter in (
            ("cp.async", (513, 256, 512, 256, 1), "cp_async_launches"),
            ("wmma", (200, 1024, 512, 64, 0), "wmma_launches")):
        x, w1, b1, w2 = _mlp_inputs(g, dev, rows, d_in, d_mid, d_out, off)
        assert (fm.sm90_plan(d_in, d_out) is None) == (case == "wmma")
        assert fm.x_tma_ok(x) == (case == "wmma")
        before = (fm.launches, getattr(fm, counter))
        got = fm.fused_mlp(x, w1, b1, w2)
        assert (fm.launches, getattr(fm, counter)) == (before[0] + 1, before[1] + 1), case
        want = fm.reference_mlp(x, w1, b1, w2)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= K2_ATOL, case
        assert torch.equal(got, fm.fused_mlp(x, w1, b1, w2)), case


@pytest.mark.parametrize("w1_scale,w2_scale", [
    (1e-4, 0.05),  # |mid| mostly below 2^-9: below the GELU table, 0.5 mid
    (1.0, 0.002),  # |mid| ~ 11: many above the table, mid or -0
])
def test_fused_mlp_gelu_outside_its_table(dev, w1_scale, w2_scale):
    """The Hopper K2 reads the GELU of a bf16 mid from a table for |mid| in
    [2^-9, 8) and takes closed forms outside it; at mids mostly outside, the
    output still matches the plain version within K2_ATOL."""
    g = _gen(6)
    x = torch.randn(513, 128, generator=g).to(dev, torch.bfloat16)
    w1 = (torch.randn(256, 128, generator=g) * w1_scale).to(dev, torch.bfloat16).t()
    b1 = (torch.randn(256, generator=g) * w1_scale).to(dev, torch.bfloat16)
    w2 = (torch.randn(128, 256, generator=g) * w2_scale).to(dev, torch.bfloat16).t()
    got = fm.fused_mlp(x, w1, b1, w2)
    want = fm.reference_mlp(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= K2_ATOL


def test_fused_mlp_grads_match_autograd_of_plain(dev):
    """Inputs that need a grad run K2 inside _FusedMLP, whose backward is
    autograd of reference_mlp: the same grads as autograd of the plain
    version, and the forward within K2_ATOL."""
    x, w1, b1, w2 = _mlp_inputs(_gen(4), dev, 300, 128, 256, 128)
    leaves = [t.detach().clone().requires_grad_() for t in (x, w1, b1, w2)]
    plain = [t.detach().clone().requires_grad_() for t in (x, w1, b1, w2)]
    g_out = torch.randn(300, 128, generator=_gen(5)).to(dev)
    before = fm.launches
    got = fm.fused_mlp(*leaves)
    assert fm.launches == before + 1
    got.backward(g_out)
    want = fm.reference_mlp(*plain)
    want.backward(g_out)
    assert (got - want).abs().max().item() <= K2_ATOL
    for leaf, ref in zip(leaves, plain):
        torch.testing.assert_close(leaf.grad, ref.grad, atol=0, rtol=0)


def test_fused_mlp_refuses_row_major_weights(dev):
    x = torch.zeros(8, 32, device=dev, dtype=torch.bfloat16)
    w1 = torch.zeros(32, 64, device=dev, dtype=torch.bfloat16)  # stride(0) != 1
    b1 = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    w2 = torch.zeros(32, 64, device=dev, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError):
        fm.fused_mlp(x, w1, b1, w2)


_COUNTERS = {"K1": fa, "K5": fnr, "K2": fm, "K7": fad, "K8": fsb}


@pytest.mark.parametrize("hidden,heads,expected", [
    (64, 4, {"K1": 2, "K5": 0, "K2": 2, "K7": 5, "K8": 2}),    # dh 16: K3's entry
    (256, 2, {"K1": 0, "K5": 2, "K2": 2, "K7": 5, "K8": 2}),   # dh 128: K5
])
def test_dit_kernel_path_matches_plain_path(dev, hidden, heads, expected):
    """A small bf16 DiT (depth 2, T=200) on the kernel path against the plain
    path, with the launches of each kernel per forward."""
    model = LatentDiT(depth=2, in_dim=8, hidden_size=hidden, num_heads=heads,
                      reference_init=False, dtype=torch.bfloat16, device=dev,
                      generator=_gen(3))
    g = _gen(4)
    x = torch.randn(2, 200, 2, 8, generator=g).to(dev)
    t = torch.tensor([0.3, 0.7], device=dev)
    mask = torch.zeros(2, 200, 2, dtype=torch.long, device=dev)
    mask[:, :1] = 1
    with torch.no_grad():
        before = {name: mod.launches for name, mod in _COUNTERS.items()}
        got = model(x, t, torch.zeros_like(x), mask)
        counts = {name: mod.launches - before[name] for name, mod in _COUNTERS.items()}
        assert counts == expected
        model.backend = "plain"
        want = model(x, t, torch.zeros_like(x), mask)
    # two layers of bf16 activations rounded in another order; the same limit
    # as the full-width forward in chip_smoke.py (3x its measured 3.185e-3)
    assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()


@pytest.mark.parametrize("hidden,heads,attn", [(64, 4, fa), (256, 2, fnr)])
def test_dit_kernel_path_grads_match_plain_path(dev, hidden, heads, attn):
    """A small bf16 DiT (depth 2, T=200) under autograd: every parameter gets
    a finite, non-zero grad through the kernels (K4 at dh 16, K6 at dh 128,
    each the redesigned backward's three kernels a layer), close to the plain
    path's."""
    model = LatentDiT(depth=2, in_dim=8, hidden_size=hidden, num_heads=heads,
                      reference_init=False, dtype=torch.bfloat16, device=dev,
                      generator=_gen(13))
    g = _gen(14)
    x = torch.randn(2, 200, 2, 8, generator=g).to(dev)
    t = torch.tensor([0.3, 0.7], device=dev)
    mask = torch.zeros(2, 200, 2, dtype=torch.long, device=dev)
    mask[:, :1] = 1
    x_cond = x * mask[..., None]  # the conditioning frame, so cond_to_emb gets a grad
    grads = {}
    for backend in ("auto", "plain"):
        model.backend = backend
        model.zero_grad(set_to_none=True)
        before = attn.bwd_sm90_launches
        model(x, t, x_cond, mask).square().mean().backward()
        assert attn.bwd_sm90_launches - before == (6 if backend == "auto" else 0)
        grads[backend] = {n: p.grad for n, p in model.named_parameters()}
    for name, got in grads["auto"].items():
        want = grads["plain"][name]
        assert got is not None and bool(torch.isfinite(got).all()), name
        assert got.abs().max().item() > 0, name
        assert (got - want).norm().item() <= DIT_GRAD_REL_TOL * want.norm().item(), name


def _fused_temporal_inputs(g, dev, n, t, heads, dh, tiled=True):
    """q/k/v as packed [N, T, D] views of one linear1-like buffer, lane
    tables [T, D] and [1, D] lane scales (tiled [dh] ones, or one per lane)."""
    d = heads * dh
    qkv = (2 * torch.randn(n, t, 3 * d, generator=g)).to(dev, torch.bfloat16)
    q, k, v = qkv.split(d, dim=-1)
    cos_l, sin_l = lane_rope_tables(*rope_cos_sin(t, dh, device=dev), heads)
    if tiled:
        qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).repeat(heads)[None].to(dev)
                  for _ in range(2))
    else:
        qs, ks = ((1 + 0.2 * torch.randn(1, d, generator=g)).to(dev) for _ in range(2))
    return q, k, v, cos_l, sin_l, qs, ks


@pytest.mark.parametrize("n,t,heads,dh,tiled", [
    (4, 1000, 16, 24, True),   # the 4AA temporal axis, 16 x 24
    (2, 1000, 3, 128, True),   # 3 x 128
    (3, 131, 4, 16, False),    # ragged T, a scale per lane
])
def test_fused_temporal_matches_plain(dev, n, t, heads, dh, tiled):
    """K10 on packed views against its plain version (one rounding of q/k
    after norm and RoPE on both sides): K1's pair of limits."""
    args = _fused_temporal_inputs(_gen(30), dev, n, t, heads, dh, tiled)
    before = tft.launches
    got = tft.fused_temporal_attention(*args, heads, dh ** -0.5)
    assert tft.launches == before + 1
    want = tft.reference_fused_temporal(*args, heads, dh ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == args[0].shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    _assert_k1_close(got, want)


def test_fused_temporal_refuses_what_it_cannot_take(dev):
    q, k, v, cos_l, sin_l, qs, ks = _fused_temporal_inputs(_gen(31), dev, 2, 70, 2, 16)
    with pytest.raises(ValueError, match="bf16"):
        tft.fused_temporal_attention(q.float(), k.float(), v.float(), cos_l, sin_l, qs, ks, 2,
                                     0.25)
    with pytest.raises(ValueError, match="cos_l"):
        tft.fused_temporal_attention(q, k, v, cos_l[:10], sin_l, qs, ks, 2, 0.25)


def test_fused_temporal_grads_match_plain(dev):
    """K10 under autograd (the Function's backward recomputes the plain
    packed reference) against autograd of its plain version: dq, dk, dv and
    both lane scales."""
    args = _fused_temporal_inputs(_gen(32), dev, 2, 300, 4, 16)
    grad = torch.randn(args[0].shape, generator=_gen(33)).to(dev, torch.bfloat16)
    grads = []
    for fn in (tft.fused_temporal_attention, tft.reference_fused_temporal):
        leaves = [a.detach().clone().requires_grad_() if i in (0, 1, 2, 5, 6) else a
                  for i, a in enumerate(args)]
        (fn(*leaves, 4, 0.25).float() * grad.float()).sum().backward()
        grads.append([leaves[i].grad for i in (0, 1, 2, 5, 6)])
    for a, w in zip(*grads):
        assert bool(torch.isfinite(a).all())
        assert (a.double() - w.double()).abs().max().item() <= \
            K10_GRAD_REL_TOL * w.double().abs().max().item()


def test_fused_temporal_block_launches_k10_and_not_k5(dev):
    """ParallelMLPAttention(fused_temporal=True) at dh 128: K10 once and K2
    once per forward, no K5, close to the block's plain path."""
    from lam_slide_tpu_torch.models.latent_dit import ParallelMLPAttention

    block = ParallelMLPAttention(256, 2, 2.0, False, 8, torch.bfloat16, _gen(34),
                                 fused_temporal=True).to(dev)
    x = torch.randn(3, 200, 256, generator=_gen(35)).to(dev, torch.bfloat16)
    cos, sin = rope_cos_sin(200, 128, device=dev)
    with torch.no_grad():
        before = (tft.launches, fm.launches, fnr.launches)
        got = block(x, cos, sin)
        assert (tft.launches - before[0], fm.launches - before[1],
                fnr.launches - before[2]) == (1, 1, 0)
        want = block(x, cos, sin, backend="plain")
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * want.abs().max().item()


K11_SHAPES = [
    (8, 16, 192, 192, 16),   # the MD17 stage-2 spatial axis
    (2, 3, 64, 64, 16),      # JAX's shapes: bh not a multiple of the group,
    (2, 8, 192, 192, 24),    # the MD17 length at dh 24,
    (2, 2, 33, 33, 16),      # an odd length
    (3, 2, 130, 70, 32),     # different query and key lengths
    (2, 3, 64, 193, 16),     # one query chunk, four key warpgroups
    (2, 3, 193, 65, 16),     # four query chunks, two key warpgroups
    (2, 2, 65, 64, 24),      # one past a query chunk, dh 24
]
# bf16 only: the fp32 kernel takes dh <= 32
K11_BF16_SHAPES = [(2, 2, 256, 256, 64)]  # the largest item: one stage of shared memory


@pytest.mark.parametrize("dtype,b,h,nq,nk,dh", [
    *((dtype, *shape) for dtype in (torch.bfloat16, torch.float32) for shape in K11_SHAPES),
    *((torch.bfloat16, *shape) for shape in K11_BF16_SHAPES)],
    ids=lambda x: {torch.bfloat16: "bf16", torch.float32: "fp32"}.get(x))
def test_short_backward_matches_plain_and_k4(dev, dtype, b, h, nq, nk, dh):
    """K11 from K1's out and lse against its plain version and against K4 on
    the same inputs (the same function), grads the same dtype and shape; a
    second call repeats bit for bit (no atomics)."""
    q, k, v, grad = (t.to(dtype) for t in _heads_views(_gen(36), dev, b, h, nq, nk, dh))
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True)
    before = tsb.launches
    got = tsb.flash_backward_short(q, k, v, out, lse, grad, dh ** -0.5)
    assert tsb.launches == before + 1
    want = tsb.reference_flash_backward_short(q, k, v, out, lse, grad, dh ** -0.5)
    k4 = fa.flash_attention_backward(q, k, v, out, lse, grad, dh ** -0.5)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, K11_REL_TOL[dtype])
    _assert_grads_close(got, k4, 2 * K11_REL_TOL[dtype])
    again = tsb.flash_backward_short(q, k, v, out, lse, grad, dh ** -0.5)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


def test_short_backward_refuses_what_it_cannot_take(dev):
    q, k, v, grad = _heads_views(_gen(37), dev, 1, 2, 300, 300, 16)
    out, lse = fa._forward(q, k, v, 0.25, with_lse=True)
    with pytest.raises(ValueError, match="256"):
        tsb.flash_backward_short(q, k, v, out, lse, grad, 0.25)


def test_sde_and_likelihood_solves_on_the_card(dev):
    """A small bf16 DiT through the SDE sampler and the likelihood solve:
    finite outputs, the likelihood's VJP through K4 (two launches of each of
    its kernels per drift evaluation at depth 2), close to the plain path on
    the same noise."""
    model = LatentDiT(depth=2, in_dim=8, hidden_size=64, num_heads=4, reference_init=False,
                      dtype=torch.bfloat16, device=dev, generator=_gen(38))
    x = torch.randn(2, 200, 2, 8, generator=_gen(39)).to(dev)
    mask = torch.zeros(2, 200, 2, dtype=torch.long, device=dev)
    mask[:, :1] = 1
    kw = dict(x_cond=x * mask[..., None], x_cond_mask=mask)
    sampler = Sampler(create_transport(path_type="GVP", prediction="data"))
    sde = sampler.get_sample_fn("SDE", {"num_steps": 4})
    like = sampler.sample_ode_likelihood(num_steps=3)
    outs = {}
    for backend in ("auto", "plain"):
        model.backend = backend
        before = fa.bwd_kv_launches
        outs[backend] = (sde(torch.Generator(device=dev).manual_seed(0), x, model, **kw),
                         *like(torch.Generator(device=dev).manual_seed(1), x, model, **kw))
        assert fa.bwd_kv_launches - before == (2 * 2 if backend == "auto" else 0)
    for got, want in zip(outs["auto"], outs["plain"]):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= 2e-2 * want.abs().max().item()


# --- the redesigned Hopper kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu) -------------

SM90_HEAD_DIMS = [16, 24, 32, 64, 128]
SM90_LENGTHS = [1, 63, 64, 65, 192, 1000, 1001]
# lse limits per head dim: chip_smoke's K1 limits at the next head dim they
# were read at (a smaller dh sums fewer products).
SM90_LSE_ATOL = {16: LSE_ATOL["K1"][24], 24: LSE_ATOL["K1"][24], 32: LSE_ATOL["K1"][64],
                 64: LSE_ATOL["K1"][64], 128: LSE_ATOL["K1"][128]}


def _sm90_inputs(g, dev, n, dh, packed, b=2, h=2, nk=None):
    nk = n if nk is None else nk
    if packed:
        return _heads_views(g, dev, b, h, n, nk, dh)
    q, grad = (torch.randn(b, h, n, dh, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, h, nk, dh, generator=g).to(dev, torch.bfloat16) for _ in range(2))
    return q, k, v, grad


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "headmajor"])
@pytest.mark.parametrize("n", SM90_LENGTHS)
@pytest.mark.parametrize("dh", SM90_HEAD_DIMS)
def test_sm90_forward_matches_plain(dev, dh, n, packed):
    """The redesigned forward on the TMA route, with the lse, on head-major
    views of packed memory and on contiguous head-major tensors, at every
    head-dim class and at lengths around its 64-row tiles."""
    q, k, v, _ = _sm90_inputs(_gen(20 + n + dh), dev, n, dh, packed)
    assert fa.sm90_tma_ok(q, k, v)
    before = (fa.launches, fa.sm90_launches, fa.sm90_cp_async_launches)
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True)
    assert (fa.launches, fa.sm90_launches, fa.sm90_cp_async_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    want, want_lse = fa.reference_attention(q, k, v, dh ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    assert out.transpose(1, 2).is_contiguous()
    _assert_k1_close(out, want)
    assert (lse - want_lse).abs().max().item() <= SM90_LSE_ATOL[dh]
    assert torch.equal(out, fa._forward(q, k, v, dh ** -0.5, with_lse=False)[0])


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "headmajor"])
@pytest.mark.parametrize("n", SM90_LENGTHS)
@pytest.mark.parametrize("dh", SM90_HEAD_DIMS)
def test_sm90_backward_matches_plain(dev, dh, n, packed):
    """The redesigned one-pass backward, from the redesigned forward's out
    and lse: K4's limits per grad. One query row attends over 70 keys (a
    ragged key tile): over a single key dq and dk are zero in exact
    arithmetic, which the next test holds on its own."""
    q, k, v, grad = _sm90_inputs(_gen(40 + n + dh), dev, n, dh, packed, nk=70 if n == 1 else n)
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True)
    before = (fa.bwd_kv_launches, fa.bwd_q_launches, fa.bwd_sm90_launches,
              fa.bwd_sm90_cp_async_launches)
    got = fa.flash_attention_backward(q, k, v, out, lse, grad, dh ** -0.5)
    assert (fa.bwd_kv_launches, fa.bwd_q_launches, fa.bwd_sm90_launches,
            fa.bwd_sm90_cp_async_launches) == (before[0] + 1, before[1] + 1, before[2] + 3,
                                               before[3])
    want = fa.reference_flash_backward(q, k, v, out, lse, grad, dh ** -0.5)
    torch.cuda.synchronize()
    assert all(t.transpose(1, 2).is_contiguous() for t in got)
    _assert_grads_close(got, want, K4_REL_TOL)


@pytest.mark.parametrize("dh", SM90_HEAD_DIMS)
def test_sm90_backward_over_one_key(dev, dh):
    """One query and one key: P = 1 and dS = dP - delta = 0 in exact
    arithmetic, so dq and dk are zero up to the fp32 residue of two sums of
    the same products (the plain version's too), and dv is dO."""
    q, k, v, grad = _sm90_inputs(_gen(80 + dh), dev, 1, dh, True)
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True)
    dq, dk, dv = fa.flash_attention_backward(q, k, v, out, lse, grad, dh ** -0.5)
    torch.cuda.synchronize()
    residue = 1e-5 * grad.float().abs().max().item() * v.float().abs().max().item()
    assert dq.float().abs().max().item() <= residue
    assert dk.float().abs().max().item() <= residue
    assert torch.equal(dv, grad)


def _cp_async_views(g, dev, case, b=2, h=3, nq=130, nk=257):
    """Views TMA cannot load: dh 20 (rows 40 bytes apart), or dh 24 views of
    packed buffers offset by one element (2-byte aligned bases)."""
    dh, off = (20, 0) if case == "dh20" else (24, 1)
    qbuf = torch.randn(b, nq, h * dh + off, generator=g).to(dev, torch.bfloat16)
    kvbuf = torch.randn(b, nk, 2 * h * dh + off, generator=g).to(dev, torch.bfloat16)
    q = qbuf[..., off:].unflatten(-1, (h, dh)).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kvbuf[..., off:].unflatten(-1, (2, h, dh)).unbind(2))
    gbuf = torch.randn(b, nq, h * dh + off, generator=g).to(dev, torch.bfloat16)
    grad = gbuf[..., off:].unflatten(-1, (h, dh)).transpose(1, 2)
    return q, k, v, grad, dh


@pytest.mark.parametrize("case", ["dh20", "offset_by_one"])
def test_sm90_cp_async_route_matches_plain(dev, case):
    """The second route of the redesigned kernels (cp.async copies by the
    producer warp), forward with the lse and backward, counted as such."""
    q, k, v, grad, dh = _cp_async_views(_gen(60), dev, case)
    assert not fa.sm90_tma_ok(q, k, v)
    before = (fa.sm90_cp_async_launches, fa.bwd_sm90_cp_async_launches)
    out, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True)
    got = fa.flash_attention_backward(q, k, v, out, lse, grad, dh ** -0.5)
    assert (fa.sm90_cp_async_launches, fa.bwd_sm90_cp_async_launches) == (
        before[0] + 1, before[1] + 1)
    want_out, want_lse = fa.reference_attention(q, k, v, dh ** -0.5, return_lse=True)
    want = fa.reference_flash_backward(q, k, v, out, lse, grad, dh ** -0.5)
    torch.cuda.synchronize()
    _assert_k1_close(out, want_out)
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL["K1"][24]
    _assert_grads_close(got, want, K4_REL_TOL)


@pytest.mark.parametrize("n", [192, 1000])
def test_sm90_backward_dq_repeats_within_one_ulp(dev, n):
    """dQ's fp32 partial sums arrive in the order the key-tile blocks finish,
    so two runs may differ by one bf16 ulp of dq (at its largest |dq|, as
    the K1 limits count ulps); dk and dv are formed in one block each and
    repeat exactly."""
    q, k, v, grad = _heads_views(_gen(70), dev, 4, 16, n, n, 24)
    out, lse = fa._forward(q, k, v, 24 ** -0.5, with_lse=True)
    first = fa.flash_attention_backward(q, k, v, out, lse, grad, 24 ** -0.5)
    second = fa.flash_attention_backward(q, k, v, out, lse, grad, 24 ** -0.5)
    torch.cuda.synchronize()
    a, b = first[0].float(), second[0].float()
    assert (a - b).abs().max().item() <= _ulp(a)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


# ---- fp32 instances of K2, K7 and K9's forward (the MD17 test pass) -------

# K2-fp32, K7-fp32 (y) and K9-fp32 against their plain versions with TF32
# off, relative to max |out|: exact fp32 on both sides up to the order of
# the sums (and erff against PyTorch's erf, expf against its exp), a few
# fp32 ulps at every shape here (up to n 127 x dh 64 terms a sum). At the
# MD17 test pass's shapes chip_smoke.py holds them to its readings
# (python -m lam_slide_tpu_torch.tools.f32_readings: at most 5.5e-7).
F32_REL_TOL = {"K2": 1e-5, "K7": 1e-5, "K9": 1e-5}


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel_err(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("rows,d,m,route", [
    (36864, 256, 512, "tiled"), (77, 256, 512, "tiled"), (129, 256, 512, "tiled"),
    (1000, 384, 768, "tiled"), (4000, 384, 768, "tiled"), (16000, 384, 768, "tiled"),
    (33, 32, 64, "tiled"), (4096, 32, 64, "tiled"),
    (16000, 128, 256, "tiled"), (10240, 128, 256, "tiled"), (77, 128, 256, "tiled"),
    (130, 64, 48, "dot"), (16000, 96, 192, "dot"), (77, 256, 496, "dot")])
def test_fused_mlp_fp32_matches_plain(dev, no_tf32, rows, d, m, route):
    """K2-fp32 on the DiT's transposed nn.Linear weight views (w1 rows of a
    linear1 weight, w2 columns of a linear2 weight): each instance of the
    outer-product kernel (MD17's, the 4AA's at the eval's and the sampling
    B, the smoke width, the pedestrian's) with odd row counts, and the
    dot-product route (hidden 64 and 96, a d_mid off the chunk, which also
    leaves a partial chunk); the fp32 counter and the route's move, nothing
    else of K2's routes; two calls give bit-identical outputs."""
    g = _gen(80)
    x = torch.randn(rows, d, generator=g).to(dev)
    lin1 = (torch.randn(3 * d + m, d, generator=g) * d ** -0.5).to(dev)
    b1 = (torch.randn(m, generator=g) * 0.1).to(dev)
    lin2 = (torch.randn(d, d + m, generator=g) * (d + m) ** -0.5).to(dev)
    w1, w2 = lin1[3 * d:].t(), lin2[:, d:].t()
    before = (fm.launches, fm.fp32_launches, fm.wmma_launches, fm.cp_async_launches,
              fm.fp32_tiled_launches, fm.fp32_dot_launches)
    got = fm.fused_mlp(x, w1, b1, w2)
    again = fm.fused_mlp(x, w1, b1, w2)
    tiled = route == "tiled"
    assert _launched(before, (fm.launches, fm.fp32_launches, fm.wmma_launches,
                              fm.cp_async_launches, fm.fp32_tiled_launches,
                              fm.fp32_dot_launches)) == (2, 2, 0, 0, 2 * tiled, 2 * (not tiled))
    want = fm.reference_mlp(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (rows, d)
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= F32_REL_TOL["K2"]


def test_fused_mlp_fp32_routes_agree_bit_for_bit(dev):
    """The outer-product and dot-product kernels sum every output over k in
    one order, so at MD17's widths (which both take) they agree bit for bit."""
    g = _gen(82)
    rows, d, m = 5000, 256, 512
    x = torch.randn(rows, d, generator=g).to(dev)
    w1 = (torch.randn(m, d, generator=g) * d ** -0.5).to(dev).t()
    b1 = (torch.randn(m, generator=g) * 0.1).to(dev)
    w2 = (torch.randn(d, m, generator=g) * m ** -0.5).to(dev).t()
    dot = torch.empty(rows, d, device=dev)
    _build.launch("lam_fused_mlp_f32", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                  w2.data_ptr(), dot.data_ptr(), rows, d, m, d, x.stride(0), w1.stride(1),
                  w2.stride(1), dot.stride(0), *fm.f32_plan(d, d),
                  torch.cuda.current_stream(dev).cuda_stream)
    got = fm.fused_mlp(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert torch.equal(got, dot)


def test_fused_mlp_refuses_mixed_dtypes(dev):
    """Mixed dtypes raise, as do an fp32 d_out past the fp32 kernel's
    registers and an fp32 x its 16-byte copies cannot load."""
    x = torch.zeros(8, 32, device=dev)
    w1 = torch.zeros(64, 32, device=dev).t()
    b1 = torch.zeros(64, device=dev)
    w2 = torch.zeros(32, 64, device=dev).t()
    for args in ((x.bfloat16(), w1, b1, w2), (x, w1.bfloat16(), b1, w2),
                 (x, w1, b1.bfloat16(), w2), (x, w1, b1, w2.bfloat16())):
        with pytest.raises(ValueError):
            fm.fused_mlp(*args)
    with pytest.raises(ValueError):  # d_out past the fp32 kernel's registers
        fm.fused_mlp(x, w1, b1, torch.zeros(576, 64, device=dev).t())
    odd = torch.zeros(8 * 32 + 1, device=dev)[1:].view(8, 32)  # 4 bytes off 16-byte alignment
    with pytest.raises(ValueError):
        fm.fused_mlp(odd, w1, b1, w2)


@pytest.mark.parametrize("b,t,l,d", [(8, 30, 192, 256), (3, 37, 4, 64), (2, 5, 3, 30),
                                     (4, 1000, 2, 384)])
def test_adaln_fp32_matches_plain(dev, b, t, l, d):
    """K7-fp32, both entries: x_new bit-identical, y within F32_REL_TOL; h
    the transposed view of the DiT's temporal output, the mods chunks of one
    [B, 1, 1, 6D] tensor; at the MD17 test pass's widths (16-byte accesses),
    small ones and D = 30 (4-byte accesses)."""
    g = _gen(81)
    x = torch.randn(b, t, l, d, generator=g).to(dev) * 3
    h = torch.randn(b, l, t, d, generator=g).to(dev).transpose(1, 2)
    shift, scale, gate = (torch.randn(b, 1, 1, 6 * d, generator=g) * 0.5).to(dev).chunk(
        6, dim=-1)[:3]
    before = (fad.launches, fad.fp32_launches)
    x_new, y = fad.residual_adaln_modulate(x, h, gate, shift, scale)
    y0 = fad.adaln_modulate(x, shift, scale)
    assert _launched(before, (fad.launches, fad.fp32_launches)) == (2, 2)
    want_x, want_y = fad.reference_residual_adaln_modulate(x, h, gate, shift, scale)
    want_y0 = fad.reference_adaln_modulate(x, shift, scale)
    torch.cuda.synchronize()
    assert torch.equal(x_new, want_x)
    for got, want in ((y, want_y), (y0, want_y0)):
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert _rel_err(got, want) <= F32_REL_TOL["K7"]


@pytest.mark.parametrize("b,n,heads,dh", [(12288, 30, 16, 16), (7, 30, 16, 16), (5, 9, 4, 24),
                                          (3, 127, 2, 64), (4, 33, 11, 16)])
def test_short_attention_fp32_matches_plain(dev, no_tf32, b, n, heads, dh):
    """K9-fp32's forward on packed views of one qkv buffer (as the DiT hands
    over q, k and v): the MD17 test pass's temporal shape, odd batch rows,
    the shortest and longest n, dh 24 and 64; the fp32 counter moves, the
    output is packed, two calls are bit-identical."""
    g = _gen(82)
    qkv = torch.randn(b, n, 3 * heads * dh, generator=g).to(dev)
    q, k, v = qkv.chunk(3, dim=-1)
    before = (tsa.launches, tsa.fp32_launches)
    got = tsa.short_attention(q, k, v, heads)
    again = tsa.short_attention(q, k, v, heads)
    assert _launched(before, (tsa.launches, tsa.fp32_launches)) == (2, 2)
    want = tsa.reference_short_attention(q, k, v, heads, dh ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape and got.is_contiguous()
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= F32_REL_TOL["K9"]


def test_short_attention_fp32_refusals(dev):
    """Mixed dtypes raise, forward and backward, and nothing launches."""
    q = torch.zeros(2, 30, 64, device=dev)
    before = (tsa.launches, tsa.bwd_launches)
    with pytest.raises(ValueError):
        tsa.short_attention(q, q.bfloat16(), q, 4)
    with pytest.raises(ValueError):
        tsa.short_attention(q.bfloat16(), q, q.bfloat16(), 4)
    with pytest.raises(ValueError):
        tsa.short_attention_backward(q, q.bfloat16(), q, q, 4, 0.25)
    assert (tsa.launches, tsa.bwd_launches) == before


# K9-fp32's backward against its plain version with TF32 off, per grad
# relative to its max: exact fp32 on both sides up to the order of the sums
# (the kernel's delta from unnormalised weights, its P as e / l), over up
# to 127 terms here. chip_smoke.py holds the main path's shapes to 3x its
# readings (8.094e-7 at [12288, 30, 256]).
K9_F32_GRAD_REL_TOL = 1e-5


@pytest.mark.parametrize("b,n,heads,dh", [
    (12288, 30, 16, 16),  # the MD17 fp32 DiT's temporal axis at B = 64
    (64, 30, 4, 8),       # the MD17 smoke DiT's (hidden 32, 4 x dh 8)
    (64, 16, 4, 8),       # the 4AA smoke DiT's (T = 16)
    (7, 30, 16, 16), (5, 9, 4, 24), (3, 127, 2, 64), (4, 33, 11, 16), (6, 32, 3, 32)])
def test_short_attention_fp32_backward_matches_plain(dev, no_tf32, b, n, heads, dh):
    """K9-fp32's backward on packed views of one qkv buffer: within
    K9_F32_GRAD_REL_TOL of the plain backward, two calls bit-identical (no
    atomics), a strided output gradient read in place; the autograd Function
    runs the fp32 forward and this backward, one launch each."""
    g = _gen(95)
    qkv = torch.randn(b, n, 3 * heads * dh, generator=g).to(dev)
    q, k, v = qkv.chunk(3, dim=-1)
    grad = torch.randn(b, n, 2 * heads * dh, generator=g).to(dev)[..., heads * dh:]
    scale = dh ** -0.5
    before = (tsa.bwd_launches, tsa.bwd_fp32_launches)
    got = tsa.short_attention_backward(q, k, v, grad, heads, scale)
    again = tsa.short_attention_backward(q, k, v, grad, heads, scale)
    assert _launched(before, (tsa.bwd_launches, tsa.bwd_fp32_launches)) == (2, 2)
    want = tsa.reference_short_backward(q, k, v, grad, heads, scale)
    torch.cuda.synchronize()
    for a, w, b_ in zip(got, want, again):
        assert a.dtype == torch.float32 and a.shape == q.shape and a.is_contiguous()
        assert torch.equal(a, b_)
        assert _rel_err(a, w) <= K9_F32_GRAD_REL_TOL
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (tsa.fp32_launches, tsa.bwd_fp32_launches)
    tsa.short_attention(*leaves, heads).backward(grad)
    assert _launched(before, (tsa.fp32_launches, tsa.bwd_fp32_launches)) == (1, 1)
    for leaf, want_grad in zip(leaves, got):
        assert torch.equal(leaf.grad, want_grad)


@pytest.mark.parametrize("b,n,heads,dh,misaligned", [
    (4096, 16, 4, 8, False),  # the 4AA smoke width at a batch that fills the card
    (7, 9, 3, 24, True),      # the shortest axis, 4-byte copies
    (5, 31, 11, 20, True),    # 11 heads: uneven head groups
    (8, 32, 16, 16, False),   # the last length with 32 logits a row
    (4, 33, 2, 16, False),    # the first with 64
    (9, 64, 5, 32, False),    # one 64-row query chunk
    (6, 65, 3, 12, True),     # a row a thread; two query chunks
    (2, 127, 4, 5, True),     # dh 5 padded to 8
    (256, 127, 4, 64, False)])  # the widest item: the backward on one stage
def test_short_attention_fp32_kernels_at_their_tile_edges(dev, no_tf32, b, n, heads, dh,
                                                         misaligned):
    """K9-fp32's redesigned forward and backward (``f32_fwd_plan``,
    ``f32_bwd_plan``) on q/k/v views of one buffer, one column wider where
    ``misaligned`` so that the 16-byte copies give way to 4-byte ones: one
    launch a call, within F32_REL_TOL and K9_F32_GRAD_REL_TOL of the plain
    versions, two calls bit-identical."""
    g = _gen(96)
    d = heads * dh
    qkv = torch.randn(b, n, 3 * d + misaligned, generator=g).to(dev)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d + misaligned:]
    grad = torch.randn(b, n, d, generator=g).to(dev)
    scale = dh ** -0.5
    before = (tsa.fp32_launches, tsa.bwd_fp32_launches)
    out, again = tsa.short_attention(q, k, v, heads), tsa.short_attention(q, k, v, heads)
    grads = tsa.short_attention_backward(q, k, v, grad, heads, scale)
    grads_again = tsa.short_attention_backward(q, k, v, grad, heads, scale)
    assert _launched(before, (tsa.fp32_launches, tsa.bwd_fp32_launches)) == (2, 2)
    want = tsa.reference_short_attention(q, k, v, heads, scale)
    want_grads = tsa.reference_short_backward(q, k, v, grad, heads, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and _rel_err(out, want) <= F32_REL_TOL["K9"]
    for a, a2, w in zip(grads, grads_again, want_grads):
        assert torch.equal(a, a2)
        assert _rel_err(a, w) <= K9_F32_GRAD_REL_TOL


# ---- K8's fp32 kernel (the 4AA eval's fp32 DiT) ----------------------------

# K8-fp32 against its plain version with TF32 off, relative to max |out|:
# exact fp32 on both sides up to the order of the sums (linear1 over D
# terms, linear2 over D + M) and erff / expf against PyTorch's erf / exp.
F32_REL_TOL["K8"] = 1e-5
# K8-fp32 under autograd against the plain path: its output and the grads
# of the plain VJP on the saved inputs; the limit chip_smoke.py uses
K8_F32_GRAD_REL_TOL = 1.2e-6
# the fp32 DiT forward through the kernels against the plain path (TF32
# off): seven fp32 kernels' sums in another order through two layers
F32_MODEL_REL_TOL = 1e-4


def _spatial_inputs_f32(g, dev, n, l, d, m, heads):
    args = list(_spatial_inputs(g, dev, n, l, d, m, heads))
    for i in (0, 1, 2, 5, 6):
        args[i] = args[i].float()
    return args


@pytest.mark.parametrize("n,l,d,m,heads", [
    (8000, 2, 384, 768, 16),  # the 4AA eval at B=8, 16 x 24
    (8000, 2, 384, 768, 3),   # 3 x 128
    (2000, 2, 384, 768, 16),  # B=2
    (2000, 2, 384, 768, 3),
    (3999, 1, 384, 768, 16),  # one position a frame, odd N
    (1333, 3, 384, 768, 3),   # 30-row blocks of 10 frames
    (501, 8, 384, 768, 16),   # eight positions a frame
    (1001, 3, 384, 768, 16),
    (777, 5, 256, 512, 16),   # the NBA DiT's width
    (901, 7, 128, 256, 4),    # the pedestrian DiT's
    (37, 4, 32, 64, 4),       # the tiny registries', dh 8
])
def test_spatial_block_fp32_matches_plain(dev, no_tf32, n, l, d, m, heads):
    """K8-fp32 on all-fp32 operands within F32_REL_TOL["K8"] of the plain
    version; only the fp32 counter moves beside ``launches``; two calls give
    bit-identical outputs."""
    args = _spatial_inputs_f32(_gen(83), dev, n, l, d, m, heads)
    before = (fsb.launches, fsb.wmma_launches, fsb.f32_launches)
    got = fsb.fused_spatial_block(*args)
    again = fsb.fused_spatial_block(*args)
    assert _launched(before, (fsb.launches, fsb.wmma_launches, fsb.f32_launches)) == (2, 0, 2)
    want = fsb.reference_spatial_block(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= F32_REL_TOL["K8"]


def test_spatial_block_fp32_refusals(dev):
    """Mixed dtypes raise; so do a width without an fp32 plan and a
    misaligned x; nothing launches."""
    args = _spatial_inputs_f32(_gen(84), dev, 64, 2, 128, 256, 4)
    before = (fsb.launches, fsb.f32_launches)
    for i in (0, 1, 2, 5, 6):
        mixed = list(args)
        mixed[i] = mixed[i].bfloat16()
        with pytest.raises(ValueError):
            fsb.fused_spatial_block(*mixed)
    wide = _spatial_inputs_f32(_gen(85), dev, 4, 2, 512, 1024, 8)
    with pytest.raises(ValueError, match="shared memory"):
        fsb.fused_spatial_block(*wide)
    x = torch.empty(64 * 2 * 128 + 1, device=dev)[1:].view(64, 2, 128)
    x.copy_(args[0])
    with pytest.raises(ValueError):
        fsb.fused_spatial_block(x, *args[1:])
    assert (fsb.launches, fsb.f32_launches) == before


@pytest.mark.parametrize("n,l,heads", [
    (2000, 2, 16), (2000, 2, 3),  # the 4AA eval at B=2, both splits
    (8000, 2, 16), (16000, 2, 3),  # sampling at B=8, the train step's forward
    (37, 1, 16), (37, 3, 3), (37, 8, 16), (17, 5, 3), (1, 8, 16),  # ragged last blocks
])
def test_spatial_block_fp32_tiled_matches_plain_and_the_dot_route(dev, no_tf32, n, l, heads):
    """K8-fp32's outer-product kernel at the 4AA widths: the plan's route
    (its counter, not the dot-product one's, moves once a call), within
    F32_REL_TOL["K8"] of the plain version, a second call bit-identical, and
    bit-identical to the dot-product route on the same inputs (both sum in
    one order)."""
    d, m = 384, 768
    args = _spatial_inputs_f32(_gen(122), dev, n, l, d, m, heads)
    plan = fsb.f32_plan(n, l, d, m, heads)
    assert plan.route == "tiled"
    counters = (fsb.launches, fsb.f32_launches, fsb.f32_tiled_launches, fsb.f32_dot_launches)
    got = fsb.fused_spatial_block(*args)
    again = fsb.fused_spatial_block(*args)
    assert _launched(counters, (fsb.launches, fsb.f32_launches, fsb.f32_tiled_launches,
                                fsb.f32_dot_launches)) == (2, 2, 2, 0)
    dot = fsb._launch_f32_dot(*args)
    want = fsb.reference_spatial_block(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, dot)
    assert _rel_err(got, want) <= F32_REL_TOL["K8"]


@pytest.mark.parametrize("n,l,d,heads", [
    (20480, 8, 256, 16),  # the NBA fp32 test pass: 2,560 blocks of 64 rows
    (7, 8, 256, 16), (9, 8, 256, 16), (17, 8, 256, 16),  # 8 frames a block at L = 8
    (11, 5, 256, 16), (13, 5, 256, 16), (63, 1, 256, 16), (65, 1, 256, 16),
    (5120, 2, 128, 4),  # the pedestrian fp32 test pass: 320 blocks of 32 rows
    (15, 2, 128, 4), (17, 2, 128, 4), (33, 2, 128, 4),  # 16 frames a block at L = 2
    (9, 3, 128, 4), (11, 3, 128, 4), (3, 8, 128, 4), (5, 8, 128, 4),
])
def test_spatial_block_fp32_tiled_at_the_pedestrian_and_nba_widths(dev, no_tf32, n, l, d,
                                                                     heads):
    """K8-fp32's outer-product instances at the NBA (D 256, 16 x 16, M 512:
    head groups of 64, 64-row blocks) and pedestrian (D 128, 4 x 32, M 256:
    head groups of 128, 32-row blocks) widths, at the test passes' shapes and
    on both sides of a block's edge: the outer-product counter moves once a
    call, a second call bit-identical, bit-identical to the dot-product
    route (at its head group, 128) and within F32_REL_TOL["K8"] of the
    plain version."""
    m = 2 * d
    args = _spatial_inputs_f32(_gen(125), dev, n, l, d, m, heads)
    plan = fsb.f32_plan(n, l, d, m, heads)
    assert (plan.route, plan.group, plan.rows) == (("tiled", 64, 64) if d == 256
                                                   else ("tiled", 128, 32))
    counters = (fsb.launches, fsb.f32_launches, fsb.f32_tiled_launches, fsb.f32_dot_launches)
    got = fsb.fused_spatial_block(*args)
    again = fsb.fused_spatial_block(*args)
    assert _launched(counters, (fsb.launches, fsb.f32_launches, fsb.f32_tiled_launches,
                                fsb.f32_dot_launches)) == (2, 2, 2, 0)
    dot = fsb._launch_f32_dot(*args)
    want = fsb.reference_spatial_block(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, dot)
    assert _rel_err(got, want) <= F32_REL_TOL["K8"]


def test_spatial_block_fp32_tiled_grads_at_the_nba_width(dev, no_tf32):
    """One forward + backward through ``_SpatialBlock`` at the NBA width
    (2,560 frames of [8, 256], 16 x 16): the forward on the outer-product
    kernel, its output and every input's grad (the plain VJP on the saved
    inputs) within K8_F32_GRAD_REL_TOL of the plain path's."""
    n, l, d, m, heads = 2560, 8, 256, 512, 16
    args = _spatial_inputs_f32(_gen(126), dev, n, l, d, m, heads)
    grad = torch.randn(n, l, d, generator=_gen(127)).to(dev)
    outs, grads = {}, {}
    for kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_() if i < 7 else t
                  for i, t in enumerate(args)]
        before = fsb.f32_tiled_launches
        out = (fsb.fused_spatial_block if kernel else fsb.reference_spatial_block)(*leaves)
        assert fsb.f32_tiled_launches - before == kernel
        out.backward(grad)
        outs[kernel], grads[kernel] = out.detach(), [t.grad for t in leaves[:7]]
    torch.cuda.synchronize()
    assert _rel_err(outs[True], outs[False]) <= K8_F32_GRAD_REL_TOL
    for got, want in zip(grads[True], grads[False]):
        assert torch.isfinite(got).all() and _rel_err(got, want) <= K8_F32_GRAD_REL_TOL


def test_spatial_block_fp32_tiled_follows_weights_written_in_place(dev, no_tf32):
    """The outer-product route builds its k-major weight operands once for a
    pair of weight tensors and keeps them: a second call builds none, a write
    in place to w1 or w2 (as an optimizer step makes) is seen by the next
    call, and the entry goes with w1."""
    args = _spatial_inputs_f32(_gen(124), dev, 200, 2, 384, 768, 16)
    fsb.fused_spatial_block(*args)
    key = id(args[1])
    kept = fsb._tiled_weights[key][3]
    fsb.fused_spatial_block(*args)
    assert fsb._tiled_weights[key][3] is kept
    for i in (1, 5):
        with torch.no_grad():
            args[i].mul_(1.5)
        got = fsb.fused_spatial_block(*args)
        want = fsb.reference_spatial_block(*args)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= F32_REL_TOL["K8"]
    args[1] = None
    assert key not in fsb._tiled_weights


@pytest.mark.parametrize("b,h,nq,nk,dh,lse,masked", [
    (4, 16, 1000, 1000, 24, False, False),  # K3-fp32 at the 4AA eval's temporal axis
    (16, 16, 1000, 1000, 24, True, False),  # the 4AA fp32 train step's, with the lse
    (96, 2, 192, 192, 16, False, False),    # MD17 stage 1's latent self-attention
    (96, 8, 192, 32, 16, True, True),       # its cross-attention over 32 atoms, the bias
    (3, 3, 130, 257, 20, True, True),       # ragged, dh 20 (4-byte copies)
    (2, 2, 65, 63, 8, True, False),         # the tile edges at the other widths
    (2, 3, 193, 191, 48, True, True),
    (2, 3, 64, 65, 64, True, False),
    (3, 2, 30, 30, 40, False, False),
    (2, 2, 70, 1, 24, True, False),         # one key
])
def test_flash_fp32_narrow_matches_plain(dev, no_tf32, b, h, nq, nk, dh, lse, masked):
    """K1's narrow fp32 kernel (dh <= 64) on head-major strided views:
    within K1_F32_REL_TOL of the plain version and its lse within
    LSE_F32_ATOL (an all-masked row included), only the narrow kernel's
    counter moves beside K1's, a second call bit-identical."""
    g = _gen(121)
    q, k, v, _ = (t.float() for t in _heads_views(g, dev, b, h, nq, nk, dh))
    mask = _key_mask(g, dev, b, nk) if masked else None
    names = ("launches", "fp32_launches", "fp32_narrow_launches", "fp32_wide_launches",
             "bias_launches")
    before = tuple(getattr(fa, n) for n in names)
    got, got_lse = fa._forward(q, k, v, dh ** -0.5, with_lse=lse, mask=mask)
    again, _ = fa._forward(q, k, v, dh ** -0.5, with_lse=lse, mask=mask)
    assert _launched(before, tuple(getattr(fa, n) for n in names)) == (2, 2, 2, 0, 2 * masked)
    want = fa.reference_attention(q, k, v, dh ** -0.5, return_lse=lse, mask=mask)
    torch.cuda.synchronize()
    if lse:
        want, want_lse = want
        assert (got_lse - want_lse).abs().max().item() <= LSE_F32_ATOL
    assert torch.equal(got, again)
    assert _rel_err(got, want) <= K1_F32_REL_TOL


@pytest.mark.parametrize("b,n,heads,dh", [(4, 1000, 16, 24), (64, 192, 16, 16)])
def test_flash_packed_fp32_runs_the_narrow_kernel(dev, no_tf32, b, n, heads, dh):
    """K3-fp32 on packed q/k and v a view of linear1's output, as the fp32
    DiTs pass them (the 4AA temporal axis, MD17's spatial one): the narrow
    kernel, within K1_F32_REL_TOL of the plain version."""
    g = _gen(123)
    d = heads * dh
    q, k = (torch.randn(b, n, d, generator=g).to(dev) for _ in range(2))
    v = torch.randn(b, n, 3 * d, generator=g).to(dev)[..., 2 * d:]
    before = fa.fp32_narrow_launches
    got = fa.flash_attention_packed(q, k, v, heads)
    assert fa.fp32_narrow_launches == before + 1
    want = fa.reference_attention_packed(q, k, v, heads)
    torch.cuda.synchronize()
    assert got.shape == q.shape and _rel_err(got, want) <= K1_F32_REL_TOL


@pytest.mark.parametrize("n,l,d,m,heads", [
    (2000, 2, 384, 768, 16),  # the 4AA fp32 DiT's spatial axis at B=1, 16 x 24
    (2000, 2, 384, 768, 3),   # 3 x 128
    (1920, 8, 32, 64, 4),     # the MD17 smoke DiT (8 latents, 4 x dh 8)
    (64, 2, 32, 64, 4),       # the 4AA smoke DiT (L = 2)
])
def test_spatial_block_fp32_grads_match_plain(dev, no_tf32, n, l, d, m, heads):
    """K8-fp32 under autograd: ``_SpatialBlock`` launches the fp32 kernel
    once, its output within F32_REL_TOL["K8"] of the plain version, and its
    backward (autograd of the plain version on the saved inputs, JAX's
    ``_fused_bwd``) gives every input the plain path's grad."""
    args = _spatial_inputs_f32(_gen(96), dev, n, l, d, m, heads)
    grad = torch.randn(n, l, d, generator=_gen(97)).to(dev)
    grads = {}
    for kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_() if i in (0, 1, 2, 3, 4, 5, 6) else t
                  for i, t in enumerate(args)]
        before = (fsb.launches, fsb.f32_launches)
        fn = fsb.fused_spatial_block if kernel else fsb.reference_spatial_block
        out = fn(*leaves)
        assert _launched(before, (fsb.launches, fsb.f32_launches)) == ((1, 1) if kernel
                                                                       else (0, 0))
        out.backward(grad)
        grads[kernel] = [t.grad for t in leaves[:7]]
        if kernel:
            got_out = out.detach()
        else:
            assert _rel_err(got_out, out.detach()) <= F32_REL_TOL["K8"]
    torch.cuda.synchronize()
    for got, want in zip(grads[True], grads[False]):
        assert got is not None and torch.isfinite(got).all()
        assert _rel_err(got, want) <= F32_REL_TOL["K8"]


@pytest.mark.parametrize("heads", [16, 3])
def test_fp32_dit_forward_runs_the_fp32_kernels(dev, no_tf32, heads):
    """The 4AA eval's fp32 DiT (hidden 384, T = 1000, L = 2) at two layers and
    B=2, at 16 x 24 and 3 x 128: one forward launches K8-fp32, its temporal
    attention in fp32 (K3-fp32, K1's fp32 counter, at 16 x 24; K5-fp32, the
    fp32 transform then K1's fp32 kernel, at 3 x 128), K2-fp32 and K7-fp32,
    and no bf16 kernel; its output is within F32_MODEL_REL_TOL of the plain
    path's."""
    model = LatentDiT(depth=2, in_dim=96, hidden_size=384, num_heads=heads, mlp_ratio=2.0,
                      reference_init=False, dtype=torch.float32, device=dev,
                      generator=_gen(86)).eval()
    g = _gen(87)
    x = torch.randn(2, 1000, 2, 96, generator=g).to(dev)
    mask = torch.zeros(2, 1000, 2, dtype=torch.int32, device=dev)
    mask[:, 0] = 1
    t = torch.full((2,), 0.5, device=dev)
    attn = fa if heads == 16 else fnr
    counters = ((fsb, "f32_launches"), (fsb, "launches"), (attn, "fp32_launches"),
                (attn, "launches"), (fm, "fp32_launches"), (fm, "launches"),
                (fad, "fp32_launches"), (fad, "launches"))
    other = fnr if attn is fa else fa
    other_before = (other.launches, fnr.sm90_launches)
    before = [getattr(mod, name) for mod, name in counters]
    with torch.no_grad():
        got = model(x, t, x, mask)
        torch.cuda.synchronize()
        after = [getattr(mod, name) for mod, name in counters]
        model.backend = "plain"
        want = model(x, t, x, mask)
    moved = [a - b for a, b in zip(after, before)]
    for fp32, total in zip(moved[0::2], moved[1::2]):
        assert fp32 > 0 and fp32 == total, moved
    assert (other.launches, fnr.sm90_launches) == other_before
    assert torch.isfinite(got).all() and got.dtype == torch.float32
    assert _rel_err(got, want) <= F32_MODEL_REL_TOL


# ---- dh 128 in fp32: K1-fp32 over 64 < dh <= 128, the fp32 transform, K5-fp32 --

# Against the plain versions with TF32 off, relative to max |out| (the
# transform: per tensor), and the lse absolute: exact fp32 on both sides up
# to the order of the sums (the row sums split over 16 lanes, the
# transform's sum of squares a warp shuffle). The limits chip_smoke.py uses:
# 3x the worst readings of python -m lam_slide_tpu_torch.tools.dh128_readings
# on an H100 (2.210e-6, lse 2.384e-6, 2.122e-7, 2.326e-6).
K1_F32_WIDE_REL_TOL = 6.7e-6
LSE_F32_WIDE_ATOL = 7.2e-6
TRANSFORM_F32_REL_TOL = 6.4e-7
K5_F32_REL_TOL = 7e-6


def _fp32_counts():
    return (fa.launches, fa.fp32_launches, fa.bias_launches, fa.sm90_launches,
            fa.fp32_wide_launches)


@pytest.mark.parametrize("b,h,nq,nk,dh,masked", [
    (1920, 2, 192, 192, 128, False),  # the MD17 fp32 DiT's spatial axis
    (4096, 2, 30, 30, 128, False),    # its temporal axis (T = 30): two sequences a block
    (12288, 2, 30, 30, 128, False),   # at the test pass's B = 64
    (2, 3, 1000, 1000, 128, False),   # the 4AA eval's temporal axis at 3 x 128: 32-row blocks
    (4, 3, 1000, 1000, 128, False),   # the eval's B = 2 (two peptides, L = 2)
    (8, 3, 1000, 1000, 128, False),   # the sampling B = 8: 64-row blocks
    (64, 4, 192, 192, 96, False),     # dh 96
    (3, 2, 130, 257, 96, False),      # ragged query and key tiles
    (2, 2, 77, 45, 72, False),        # N % 32 != 0, dh % 8 != 0
    (2, 2, 77, 45, 70, False),        # dh % 4 != 0: 4-byte copies
    (3, 1, 31, 17, 128, False),       # ragged short axes, an odd count of sequences
    (3, 2, 130, 257, 128, True),      # the key-padding bias, an all-masked row
    (5, 2, 20, 29, 128, True),        # the bias with two sequences a block
    (22000, 3, 20, 20, 128, False),   # 66,000 batch x heads: past gridDim.y's cap
])
def test_flash_fp32_wide_heads_match_plain(dev, no_tf32, b, h, nq, nk, dh, masked):
    """K1's register-tiled fp32 kernel at 64 < dh <= 128 on head-major
    strided views, in each geometry of ``f32_wide_plan`` (64- and 32-row
    blocks, two short sequences a block): the output in packed memory, two
    calls bit-identical, the lse within K1-fp32's limit, counted under K1
    and its fp32, fp32-wide (and bias) counters, never the redesigned bf16
    kernel's."""
    g = _gen(90)
    qbuf = torch.randn(b, nq, h * dh, generator=g).to(dev)
    kvbuf = torch.randn(b, nk, 2 * h * dh, generator=g).to(dev)
    q = qbuf.view(b, nq, h, dh).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kvbuf.view(b, nk, 2, h, dh).unbind(2))
    mask = _key_mask(g, dev, b, nk) if masked else None
    before = _fp32_counts()
    got, lse = fa._forward(q, k, v, dh ** -0.5, with_lse=True, mask=mask)
    again = fa.flash_attention(q, k, v, mask=mask)
    assert _launched(before, _fp32_counts()) == (2, 2, 2 * masked, 0, 2)
    want, want_lse = fa.reference_attention(q, k, v, dh ** -0.5, return_lse=True, mask=mask)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.transpose(1, 2).is_contiguous() and torch.equal(got, again)
    assert _rel_err(got, want) <= K1_F32_WIDE_REL_TOL
    assert (lse - want_lse).abs().max().item() <= LSE_F32_WIDE_ATOL
    if masked:
        uniform = v[0].mean(dim=1, keepdim=True).expand_as(got[0])
        torch.testing.assert_close(got[0], uniform, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,h,nq,nk,dh,masked", [
    (32, 16, 1000, 1000, 24, False),  # the 4AA fp32 DiT's temporal axis (16 x 24)
    (1920, 16, 192, 192, 16, False),  # the MD17 fp32 DiT's spatial axis (16 x 16)
    (256, 8, 192, 32, 16, True),      # MD17 stage 1's encoder cross-attention, the bias
    (256, 2, 192, 192, 16, False),    # its latent self-attention
    (8, 4, 30, 30, 8, False),         # the smoke DiTs' dh 8
    (3, 2, 130, 257, 32, True),       # ragged query and key tiles, an all-masked row
    (3, 2, 65, 63, 48, False),        # dh 48
    (2, 3, 64, 193, 40, True),        # dh 40, padded to 48
    (3, 2, 130, 257, 64, False),      # dh 64: one slice of dK, dV
    (2, 3, 77, 45, 18, True),         # dh % 4 != 0: 4-byte copies, padded to 24
    (2, 2, 1, 3, 16, False),          # one query (a key tile of 3)
    (4100, 16, 70, 70, 16, False),    # 65,600 batch x heads
])
def test_flash_fp32_narrow_backward_matches_plain(dev, no_tf32, b, h, nq, nk, dh, masked):
    """K4's narrow fp32 kernel at dh <= 64 on head-major strided views, from
    K1-fp32's out and lse, at each padded width of ``f32_narrow_plan`` and
    its tiles' edges: every grad within K4_F32_REL_TOL of the plain
    version's largest, in packed memory, two calls bit-identical, counted
    under K4's fp32 counter (``_k4_kernels`` a call) and not the wide
    one's."""
    g = _gen(95)
    qbuf = torch.randn(b, nq, h * dh, generator=g).to(dev)
    kvbuf = torch.randn(b, nk, 2 * h * dh, generator=g).to(dev)
    q = qbuf.view(b, nq, h, dh).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kvbuf.view(b, nk, 2, h, dh).unbind(2))
    grad = torch.randn(b, h, nq, dh, generator=g).to(dev)
    mask = _key_mask(g, dev, b, nk) if masked else None
    scale = dh ** -0.5
    out, lse = fa._forward(q, k, v, scale, with_lse=True, mask=mask)
    before = (fa.bwd_fp32_launches, fa.bwd_fp32_wide_launches, fa.bwd_bias_launches)
    got = fa.flash_attention_backward(q, k, v, out, lse, grad, scale, mask=mask)
    again = fa.flash_attention_backward(q, k, v, out, lse, grad, scale, mask=mask)
    n = _k4_kernels(torch.float32, dh, nq, nk)
    assert _launched(before, (fa.bwd_fp32_launches, fa.bwd_fp32_wide_launches,
                              fa.bwd_bias_launches)) == (2 * n, 0, 2 * n * masked)
    want = fa.reference_flash_backward(q, k, v, out, lse, grad, scale,
                                       None if mask is None else fa.mask_to_bias(mask))
    torch.cuda.synchronize()
    for name, a, w, a2 in zip(("dq", "dk", "dv"), got, want, again):
        assert a.dtype == torch.float32 and a.shape == w.shape and a.transpose(1, 2).is_contiguous()
        assert torch.equal(a, a2), f"{name}: a second call differs"
        assert _rel_err(a, w) <= K4_F32_REL_TOL, f"{name}: rel err {_rel_err(a, w)}"


def _transform_views(g, dev, b, heads, nq, nk, dh, dtype):
    qbuf = (2 * torch.randn(b, nq, 3 * heads * dh, generator=g)).to(dev, dtype)
    kbuf = (2 * torch.randn(b, nk, 3 * heads * dh, generator=g)).to(dev, dtype)
    q = qbuf[..., :heads * dh].unflatten(-1, (heads, dh)).transpose(1, 2)
    k = kbuf[..., heads * dh:2 * heads * dh].unflatten(-1, (heads, dh)).transpose(1, 2)
    v = kbuf[..., 2 * heads * dh:].unflatten(-1, (heads, dh)).transpose(1, 2)
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(max(nq, nk), dh, device=dev)
    return q, k, v, qs, ks, cos, sin


@pytest.mark.parametrize("b,heads,nq,nk,dh", [(2, 3, 1000, 1000, 128), (12288, 2, 30, 30, 128),
                                              (3, 4, 130, 257, 64), (2, 2, 70, 33, 22)])
def test_qk_normrope_fp32_matches_pre_transform(dev, b, heads, nq, nk, dh):
    """The transform kernel in fp32 on raw strided views of packed buffers
    against ``pre_transform``: contiguous fp32 head-major outputs within
    TRANSFORM_F32_REL_TOL of max |want|, one launch under the transform's
    counter. dh 22 takes the element-wise route (dh % 4 != 0)."""
    q, k, _, qs, ks, cos, sin = _transform_views(_gen(91), dev, b, heads, nq, nk, dh,
                                                 torch.float32)
    before = fnr.transform_launches
    got = fnr.qk_normrope(q, k, qs, ks, cos, sin)
    assert fnr.transform_launches == before + 1
    want = fnr.pre_transform(q, k, qs, ks, cos, sin)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.is_contiguous() and a.shape == w.shape and a.dtype == torch.float32
        assert _rel_err(a, w) <= TRANSFORM_F32_REL_TOL


@pytest.mark.parametrize("b,heads,nq,nk,dh", [
    (2, 3, 1000, 1000, 128),   # the 4AA eval at 3 x 128, B = 2 (L = 1 here)
    (8, 3, 1000, 1000, 128),
    (1920, 2, 192, 192, 128),  # the MD17 fp32 DiT at 2 x 128: spatial
    (12288, 2, 30, 30, 128),   # and temporal
    (3, 2, 130, 257, 96),      # ragged
])
def test_flash_normrope_fp32_matches_plain(dev, no_tf32, b, heads, nq, nk, dh):
    """K5 in fp32: the fp32 transform, then K1's register-tiled fp32 kernel on
    (q_t, k_t, v), within K5_F32_REL_TOL of the plain version; K5's counters
    (K5, fp32, fp32-wide, transform) move once, its sm90 counters and K1's
    not at all."""
    args = _transform_views(_gen(92), dev, b, heads, nq, nk, dh, torch.float32)
    before, k1 = _normrope_counts(), _fp32_counts()
    fp32_before = (fnr.fp32_launches, fnr.fp32_wide_launches)
    got = fnr.flash_attention_normrope(*args)
    assert _launched(before, _normrope_counts()) == (1, 1, 0, 0, 0, 0, 0)
    assert (fnr.fp32_launches, fnr.fp32_wide_launches) == (fp32_before[0] + 1,
                                                            fp32_before[1] + 1)
    assert _fp32_counts() == k1
    want = fnr.reference_attention_normrope(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel_err(got, want) <= K5_F32_REL_TOL


@pytest.mark.parametrize("b,n", [(1920, 192), (12288, 30)])
def test_normrope_bf16_at_md17_2x128_shapes(dev, b, n):
    """K5 (with its lse) and K6 in bf16 at the MD17 stage-2 DiT's 2 x 128
    shapes at B = 64 (the spatial axis over L = 192 and the temporal one over
    T = 30), against the plain versions: K1's limits for the output, K5's lse
    limit at dh 128, K6_REL_TOL for the grads."""
    dh = 128
    g = _gen(93)
    q, k, v, grad = _heads_views(g, dev, b, 2, n, n, dh, scale=2.0)
    qs, ks = ((1 + 0.2 * torch.randn(dh, generator=g)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(n, dh, device=dev)
    before = _normrope_counts()
    out, lse = fnr._forward(q, k, v, qs, ks, cos, sin, dh ** -0.5, with_lse=True)
    args = (q, k, v, qs, ks, cos, sin, out, lse, grad, dh ** -0.5)
    got = fnr.flash_attention_normrope_backward(*args)
    assert _launched(before, _normrope_counts()) == (1, 2, 1, 0, 1, 3, 0)
    want_out, want_lse = fa.reference_attention(*fnr.pre_transform(q, k, qs, ks, cos, sin), v,
                                                dh ** -0.5, return_lse=True)
    want = fnr.reference_normrope_backward(*args)
    torch.cuda.synchronize()
    _assert_k1_close(out, want_out)
    assert (lse - want_lse).abs().max().item() <= LSE_ATOL["K5"][dh]
    _assert_grads_close(got, want, K6_REL_TOL)


# K4-fp32's wide kernel at 64 < dh <= 128 against its plain version with
# TF32 off, per grad relative to its max: exact fp32 on both sides up to the
# order of the sums (dK and dV over up to 1000 queries, dQ over the key
# tiles' shares); chip_smoke.py holds it to the same limit.
K4_F32_WIDE_REL_TOL = 1e-5


def _fp32_bwd_counts():
    return (fa.bwd_kv_launches, fa.bwd_q_launches, fa.bwd_fp32_launches,
            fa.bwd_fp32_wide_launches, fa.bwd_bias_launches, fa.bwd_sm90_launches)


@pytest.mark.parametrize("b,h,nq,nk,dh,masked", [
    (16, 3, 1000, 1000, 128, False),  # the 4AA fp32 DiT's temporal axis at 3 x 128, B = 16
    (1920, 2, 192, 192, 128, False),  # the MD17 fp32 DiT at 2 x 128: spatial
    (12288, 2, 30, 30, 128, False),   # and temporal: two sequences a block
    (3, 2, 130, 257, 96, False),      # ragged query and key tiles
    (2, 2, 77, 45, 70, False),        # dh % 4 != 0: 4-byte copies
    (3, 1, 31, 17, 128, False),       # ragged short axes, an odd count of sequences
    (3, 2, 130, 257, 128, True),      # the key-padding bias, an all-masked row
    (5, 2, 20, 29, 128, True),        # the bias with two sequences a block
])
def test_flash_fp32_wide_backward_matches_plain(dev, no_tf32, b, h, nq, nk, dh, masked):
    """K4's wide fp32 kernel on head-major strided views, from
    K1-fp32's out and lse: grads in packed memory within K4_F32_WIDE_REL_TOL
    of the plain backward, two calls bit-identical (no atomics), counted
    under K4 and its fp32 and fp32-wide counters (``_k4_kernels`` a call);
    the autograd Function runs the same kernels."""
    g = _gen(98)
    qbuf = torch.randn(b, nq, h * dh, generator=g).to(dev)
    kvbuf = torch.randn(b, nk, 2 * h * dh, generator=g).to(dev)
    q = qbuf.view(b, nq, h, dh).transpose(1, 2)
    k, v = (t.transpose(1, 2) for t in kvbuf.view(b, nk, 2, h, dh).unbind(2))
    grad = torch.randn(b, h, nq, dh, generator=g).to(dev)
    mask = _key_mask(g, dev, b, nk) if masked else None
    scale = dh ** -0.5
    out, lse = fa._forward(q, k, v, scale, with_lse=True, mask=mask)
    before = _fp32_bwd_counts()
    got = fa.flash_attention_backward(q, k, v, out, lse, grad, scale, mask=mask)
    again = fa.flash_attention_backward(q, k, v, out, lse, grad, scale, mask=mask)
    n = _k4_kernels(torch.float32, dh, nq, nk)
    assert _launched(before, _fp32_bwd_counts()) == (2, 2, 2 * n, 2 * n, 2 * n * masked, 0)
    want = fa.reference_flash_backward(q, k, v, out, lse, grad, scale,
                                       None if mask is None else fa.mask_to_bias(mask))
    torch.cuda.synchronize()
    for a, w, b_ in zip(got, want, again):
        assert a.dtype == torch.float32 and a.transpose(1, 2).is_contiguous()
        assert torch.equal(a, b_)
        assert _rel_err(a, w) <= K4_F32_WIDE_REL_TOL
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, mask=mask).backward(grad)
    for leaf, want_grad in zip(leaves, got):
        assert _rel_err(leaf.grad, want_grad) <= K4_F32_WIDE_REL_TOL


def test_fp32_grads_past_dh_128_raise_before_any_launch(dev):
    """K4-fp32 takes dh <= 128, as every forward kernel does: a wider fp32
    call raises, with a gradient or in the backward, and nothing launches."""
    q = torch.zeros(1, 2, 64, 136, device=dev, requires_grad=True)
    before = (*_fp32_counts(), *_fp32_bwd_counts())
    with pytest.raises(ValueError, match="backward"):
        fa.flash_attention(q, q, q)
    d = q.detach()
    with pytest.raises(ValueError, match="backward"):
        fa.flash_attention_backward(d, d, d, d, torch.zeros(1, 2, 64, device=dev), d, 0.1)
    assert (*_fp32_counts(), *_fp32_bwd_counts()) == before


# K6 in fp32 (the fp32 transform's q_t/k_t, K4's wide fp32 kernel, the
# plain chain VJP) against autograd of the plain version with TF32 off, per
# grad relative to its max; the chain's rsqrt and rotation carry the
# attention grads' few ulps.
K6_F32_REL_TOL = 2e-5


@pytest.mark.parametrize("b,heads,nq,nk,dh", [
    (16, 3, 1000, 1000, 128),  # the 4AA fp32 DiT's temporal axis at 3 x 128
    (64, 2, 192, 192, 128),    # the MD17 fp32 DiT's spatial axis at 2 x 128
    (256, 2, 30, 30, 128),     # and temporal
    (3, 2, 130, 257, 96),      # ragged
])
def test_flash_normrope_fp32_grads_match_plain(dev, no_tf32, b, heads, nq, nk, dh):
    """K5-fp32 under autograd: ``_FlashNormRope`` runs K5-fp32 (the fp32
    transform once, K1-fp32) and K6-fp32 (K4's wide fp32 kernels,
    ``_k4_kernels``, on the kept q_t/k_t; no transform again), and every grad (q, k,
    v, both scales) is within K6_F32_REL_TOL of autograd of the plain
    version; ``flash_attention_normrope_backward`` gives the same attention
    grads."""
    args = _transform_views(_gen(99), dev, b, heads, nq, nk, dh, torch.float32)
    grad = torch.randn(b, heads, nq, dh, generator=_gen(100)).to(dev)
    grads = {}
    for kernel in (True, False):
        leaves = [t.detach().clone().requires_grad_() if i < 5 else t
                  for i, t in enumerate(args)]
        counts = (fnr.launches, fnr.transform_launches, fnr.bwd_launches,
                  fnr.bwd_fp32_launches, fnr.bwd_fp32_wide_launches, fnr.bwd_sm90_launches)
        k4 = _fp32_bwd_counts()
        fn = fnr.flash_attention_normrope if kernel else fnr.reference_attention_normrope
        fn(*leaves).backward(grad)
        moved = _launched(counts, (fnr.launches, fnr.transform_launches, fnr.bwd_launches,
                                   fnr.bwd_fp32_launches, fnr.bwd_fp32_wide_launches,
                                   fnr.bwd_sm90_launches))
        n = _k4_kernels(torch.float32, dh, nq, nk)
        assert moved == ((1, 1, 1, n, n, 0) if kernel else (0,) * 6)
        assert _fp32_bwd_counts() == k4
        grads[kernel] = [t.grad for t in leaves[:5]]
    torch.cuda.synchronize()
    for got, want in zip(grads[True], grads[False]):
        assert got is not None and torch.isfinite(got).all()
        assert _rel_err(got, want) <= K6_F32_REL_TOL


# The fp32 DiT's grads through the kernels against the plain path's (TF32
# off), per parameter relative to its norm: every fp32 kernel's sums in
# another order through two layers, carried by the backward.
F32_DIT_GRAD_REL_TOL = 1e-4


@pytest.mark.parametrize("hidden,heads,t,l,checkpointing", [
    (384, 16, 1000, 2, False),  # 4AA: K8-fp32, K3-fp32 + K4-fp32 at dh 24
    (384, 3, 1000, 2, True),    # 4AA 3 x 128: K8-fp32, K5-fp32 + K6-fp32; recompute
    (256, 16, 30, 192, True),   # MD17: K3-fp32 + K4-fp32 at dh 16, K9-fp32 both ways
    (256, 2, 30, 192, False),   # MD17 2 x 128: K5-fp32 + K6-fp32 on both axes
])
def test_fp32_dit_grads_match_plain_path(dev, no_tf32, hidden, heads, t, l, checkpointing):
    """An fp32 DiT of depth 2 at a registry's width under autograd: every
    parameter gets a finite, non-zero grad through the fp32 kernels and no
    bf16 kernel launches, within F32_DIT_GRAD_REL_TOL of the plain path's."""
    model = LatentDiT(depth=2, in_dim=16, hidden_size=hidden, num_heads=heads, mlp_ratio=2.0,
                      reference_init=False, dtype=torch.float32, device=dev,
                      checkpointing=checkpointing, generator=_gen(101))
    g = _gen(102)
    b = 2
    x = torch.randn(b, t, l, 16, generator=g).to(dev)
    mask = torch.zeros(b, t, l, dtype=torch.long, device=dev)
    mask[:, :1] = 1
    x_cond = x * mask[..., None]
    tvec = torch.tensor([0.3, 0.7], device=dev)
    bf16 = lambda: (fa.sm90_launches, fa.bwd_sm90_launches, fnr.sm90_launches,
                    fnr.bwd_sm90_launches, fm.launches - fm.fp32_launches,
                    fad.launches - fad.fp32_launches, fsb.launches - fsb.f32_launches,
                    tsa.launches - tsa.fp32_launches, tsa.bwd_launches - tsa.bwd_fp32_launches)
    grads = {}
    for backend in ("auto", "plain"):
        model.backend = backend
        model.zero_grad(set_to_none=True)
        before = bf16()
        model(x, tvec, x_cond, mask).square().mean().backward()
        assert bf16() == before
        grads[backend] = {n: p.grad for n, p in model.named_parameters()}
    for name, got in grads["auto"].items():
        want = grads["plain"][name]
        assert got is not None and bool(torch.isfinite(got).all()), name
        assert got.abs().max().item() > 0, name
        assert (got - want).norm().item() <= F32_DIT_GRAD_REL_TOL * want.norm().item(), name

# ---- the pedestrian and NBA DiTs' widths (chip_smoke.py phase 17) ---------

# (B, hidden, heads, L) of each workload's stage-2 DiT at its registry's
# batch, T = 20 frames: the shapes of the bf16 train step and of one repeat
# of the fp32 test pass
PED_NBA = {"pedestrian": (256, 128, 4, 2), "nba": (1024, 256, 16, 8)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("workload", sorted(PED_NBA))
def test_spatial_block_at_the_pedestrian_and_nba_widths(dev, no_tf32, workload, dtype):
    """K8 over [B*T, L, D]: in bf16 the Hopper kernel within K8_REL_TOL, in
    fp32 the outer-product route within F32_REL_TOL["K8"] and bit-identical
    to the dot-product route launched directly; a second call
    bit-identical."""
    b, d, heads, l = PED_NBA[workload]
    args = (_spatial_inputs(_gen(110), dev, b * 20, l, d, 2 * d, heads)
            if dtype == torch.bfloat16 else
            _spatial_inputs_f32(_gen(110), dev, b * 20, l, d, 2 * d, heads))
    names = ("launches", "wmma_launches", "f32_launches", "f32_tiled_launches",
             "f32_dot_launches")
    before = [getattr(fsb, n) for n in names]
    got, again = fsb.fused_spatial_block(*args), fsb.fused_spatial_block(*args)
    moved = tuple(getattr(fsb, n) - v for n, v in zip(names, before))
    assert moved == ((2, 0, 0, 0, 0) if dtype == torch.bfloat16 else (2, 0, 2, 2, 0))
    want = fsb.reference_spatial_block(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape and torch.equal(got, again)
    tol = K8_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL["K8"]
    assert _rel_err(got, want) <= tol
    if dtype == torch.float32:
        assert torch.equal(got, fsb._launch_f32_dot(*args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("workload", sorted(PED_NBA))
def test_short_attention_at_the_pedestrian_and_nba_widths(dev, no_tf32, workload, dtype):
    """K9 forward and backward at n = 20 on packed views of one qkv buffer
    [B*L, 20, 3D]: bf16 within K1's limits and K9_GRAD_REL_TOL, fp32 within
    F32_REL_TOL["K9"] and K9_F32_GRAD_REL_TOL; second calls bit-identical."""
    b, d, heads, l = PED_NBA[workload]
    g = _gen(111)
    q, k, v = torch.randn(b * l, 20, 3 * d, generator=g).to(dev, dtype).chunk(3, dim=-1)
    grad = torch.randn(b * l, 20, d, generator=g).to(dev, dtype)
    scale = (d // heads) ** -0.5
    fp32 = dtype == torch.float32
    counters = ("fp32_launches", "bwd_fp32_launches") if fp32 else ("launches", "bwd_launches")
    before = [getattr(tsa, c) for c in counters]
    out, out_again = (tsa.short_attention(q, k, v, heads) for _ in range(2))
    grads, grads_again = (tsa.short_attention_backward(q, k, v, grad, heads, scale)
                          for _ in range(2))
    assert _launched(before, [getattr(tsa, c) for c in counters]) == (2, 2)
    want = tsa.reference_short_attention(q, k, v, heads, scale)
    want_grads = tsa.reference_short_backward(q, k, v, grad, heads, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, out_again)
    assert all(torch.equal(a, a2) for a, a2 in zip(grads, grads_again))
    if fp32:
        assert _rel_err(out, want) <= F32_REL_TOL["K9"]
        for a, w in zip(grads, want_grads):
            assert _rel_err(a, w) <= K9_F32_GRAD_REL_TOL
    else:
        _assert_k1_close(out, want)
        _assert_grads_close(grads, want_grads, K9_GRAD_REL_TOL)


def test_fused_mlp_fp32_dot_route_at_the_pedestrian_width(dev, no_tf32):
    """K2-fp32 at the pedestrian DiT's MLP branch (B*T*L = 10,240 rows of
    128 -> 256 -> 128) and at a ragged count: the outer-product kernel's
    d_out 128 instance (32-row blocks of 128 threads) within
    F32_REL_TOL["K2"], a second call bit-identical, and bit-identical
    to the dot-product route launched directly on the same inputs (both sum
    in one order)."""
    g = _gen(112)
    d, m = 128, 256
    for rows in (256 * 20 * 2, 10201):
        x = torch.randn(rows, d, generator=g).to(dev)
        lin1 = (torch.randn(3 * d + m, d, generator=g) * d ** -0.5).to(dev)
        b1 = (torch.randn(m, generator=g) * 0.1).to(dev)
        lin2 = (torch.randn(d, d + m, generator=g) * (d + m) ** -0.5).to(dev)
        args = (x, lin1[3 * d:].t(), b1, lin2[:, d:].t())
        assert fm.tiled_plan(d, m, d, rows)[:3] == (32, 128, 128)
        before = (fm.fp32_launches, fm.fp32_tiled_launches, fm.fp32_dot_launches)
        got, again = fm.fused_mlp(*args), fm.fused_mlp(*args)
        assert _launched(before, (fm.fp32_launches, fm.fp32_tiled_launches,
                                  fm.fp32_dot_launches)) == (2, 2, 0)
        want = fm.reference_mlp(*args)
        w1, w2 = args[1], args[3]
        dot = torch.empty(rows, d, device=dev)
        _build.launch("lam_fused_mlp_f32", x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                      w2.data_ptr(), dot.data_ptr(), rows, d, m, d, x.stride(0), w1.stride(1),
                      w2.stride(1), dot.stride(0), *fm.f32_plan(d, d),
                      torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, dot)
        assert _rel_err(got, want) <= F32_REL_TOL["K2"]


@pytest.mark.parametrize("workload", sorted(PED_NBA))
def test_pedestrian_and_nba_fp32_dit_forward_matches_plain_path(dev, no_tf32, workload):
    """The registry's fp32 test model (the class-conditional DiT of depth 6
    at the workload's width) at B=2 on weights perturbed by N(0, 0.02^2)
    (the reference init makes every block the identity): one forward
    through K8-fp32 (outer-product route), K9-fp32, K2-fp32 and K7-fp32, per
    layer one, one, one and two, and one more K7 (no bf16 kernel), against
    the plain path within F32_MODEL_REL_TOL."""
    from lam_slide_tpu_torch.experiments import registry

    _, d, heads, l = PED_NBA[workload]
    run1 = registry.build_experiment(f"{workload}_first_stage", device=dev)
    run2 = registry.build_experiment(f"{workload}_second_stage", first_stage=run1, device=dev)
    dit = run2.test_model.backbone
    g = _gen(113)
    with torch.no_grad():
        for p in dit.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g).to(dev))
    x = torch.randn(2, 20, l, 32, generator=g).to(dev)
    mask = torch.zeros(2, 20, l, dtype=torch.long, device=dev)
    mask[:, :8] = 1
    x_cond, t = x * mask[..., None], torch.tensor([0.3, 0.7], device=dev)
    y = torch.tensor([1, 0], device=dev)
    names = ((fsb, "f32_tiled_launches"), (tsa, "fp32_launches"), (fm, "fp32_launches"),
             (fad, "fp32_launches"), (fsb, "launches"), (tsa, "launches"), (fm, "launches"),
             (fad, "launches"))
    before = [getattr(mod, n) for mod, n in names]
    with torch.no_grad():
        got = dit(x, t, x_cond, mask, y)
        moved = tuple(getattr(mod, n) - v for (mod, n), v in zip(names, before))
        set_backend(dit, "plain")
        want = dit(x, t, x_cond, mask, y)
    torch.cuda.synchronize()
    assert moved == (6, 6, 6, 13) * 2
    assert bool(torch.isfinite(got).all()) and want.abs().max().item() > 0
    assert _rel_err(got, want) <= F32_MODEL_REL_TOL


@pytest.mark.parametrize("workload", ["md17", "nba"])
def test_engine_batches_land_on_the_card_as_the_numpy_route(dev, monkeypatch, workload):
    """The stage-2 whole-batch path on the native engine (the default) and on
    the numpy forms (LAM_SLIDE_NO_NATIVE=1), at one seed, through
    device_batch: integers and masks bit for bit, floats within 1e-5
    (tests/test_batch_assembly.py:68,79; the engine sums in another order)."""
    import numpy as np

    from lam_slide_tpu_torch import native
    from lam_slide_tpu_torch.data.md17 import MD17Dataset
    from lam_slide_tpu_torch.data.nba import NBADataset

    def batch():
        if workload == "md17":
            ds = MD17Dataset(molecule="aspirin", mode="train", first_stage=False, span=30,
                             num_entities=32, synthetic_frames=4000, scale=2.0)
        else:
            ds = NBADataset(scene="score", first_stage=False, flip=True, rand_rotation=True,
                            num_entities=11, shift=47.5787, scale=24.7269, synthetic_games=8)
        idx = np.arange(64)
        return device_batch(ds.sample_batch(idx, np.random.default_rng(0)), dev)

    calls = native.calls
    got = batch()
    assert native.calls > calls
    monkeypatch.setenv("LAM_SLIDE_NO_NATIVE", "1")
    want = batch()
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "cuda" and g.dtype == w.dtype and g.shape == w.shape, k
        if w.is_floating_point():
            assert torch.allclose(g, w, rtol=1e-5, atol=1e-5), k
        else:
            assert torch.equal(g, w), k
