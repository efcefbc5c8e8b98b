"""The plain versions behind the register-tiled fp32 kernels, and their
geometry, on the CPU.

``csrc/flash_attention.cu``'s register-tiled kernel takes K1 (and K5 after
its transform) in fp32 at 64 < dh <= 128: 64-row query blocks over 64-key
tiles, dh zero-padded to 128, two sequences in one block where both axes
are at most 32. ``csrc/fused_mlp_f32.cu``'s outer-product kernel
takes K2 in fp32 at the registries' widths: 128-row blocks with d_mid in
chunks of 64 (256 -> 512 -> 256), 64-row blocks with chunks of 96 (384 ->
768 -> 384), 32-row blocks with chunks of 128 (128 -> 256 -> 128) and
64-row blocks with chunks of 64 (32 -> 64 -> 32). On the
card each is held to its plain version; here the plain versions are held to
the JAX kernels (interpret mode, ``FORCE_KERNEL`` for K2) at those tiles'
edges, on inputs made with numpy from a seed:

* ``reference_attention`` in fp32 at dh 72 and 128 with Nq and Nk on both
  sides of 32 and 64 (31, 32, 33, 63, 64, 65, ragged pairs too), plain, with
  the lse and with a ragged key-padding bias (an all-masked row included),
  against JAX ``_flash_forward``;
* ``reference_mlp`` in fp32 against JAX ``fused_mlp``, rows on both sides of
  each instance's row block and d_mid on both sides of its chunk.

Also the plans (``f32_wide_plan``, ``tiled_plan``) over the whole domain
the wrappers' checks accept, with shared memory within an H100 block's
232,448 bytes, the route every registry width takes, and that CPU calls
count no launch.

Tolerances: fp32 on both sides, so only the order of the sums differs:
2e-5 for attention (tests/test_torch_port_dh128.py's), 1e-5 of the largest
output for K2 (tests/test_torch_port_mlp_tiles.py's fp32 limit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import flash_attention as tfa
from lam_slide_tpu_torch.ops import flash_normrope as tnr
from lam_slide_tpu_torch.ops import fused_mlp as tfm

ATTN_TOL = 2e-5
MLP_REL_TOL = 1e-5
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes
SM_SMEM = 233472  # an H100 SM's 228 KB, 1 KB of it reserved for each block

# (nq, nk) on both sides of the 32-row segments and of the 64-row / 64-key tiles
ATTN_SIZES = [(31, 31), (32, 32), (33, 33), (63, 63), (64, 64), (65, 65), (32, 65), (65, 32),
              (33, 63), (64, 31)]


@pytest.mark.parametrize("variant", ["plain", "lse", "bias"])
@pytest.mark.parametrize("nq,nk", ATTN_SIZES)
@pytest.mark.parametrize("dh", [72, 128])
def test_fp32_attention_matches_jax_at_the_tiled_kernels_edges(dh, nq, nk, variant):
    rng = np.random.default_rng(dh * 10000 + nq * 100 + nk)
    b, h = 3, 2
    q = rng.standard_normal((b, h, nq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nk, dh)).astype(np.float32) for _ in range(2))
    scale = dh ** -0.5
    mask = None
    if variant == "bias":
        mask = np.arange(nk)[None, :] < rng.integers(1, nk + 1, size=(b, 1))
        mask[0] = False  # an all-masked row: uniform weights over its keys on both sides
    bias = None if mask is None else jfa._mask_to_bias(jnp.asarray(mask), b, nk)
    want = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), bias, scale,
                              with_lse=variant == "lse")
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tfa.reference_attention(*targs, scale, return_lse=variant == "lse", mask=tmask)
    if variant == "lse":
        (got, got_lse), (want, want_lse) = got, want
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATTN_TOL,
                                   rtol=ATTN_TOL)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    if variant == "bias":
        np.testing.assert_allclose(got[0].numpy(),
                                   np.broadcast_to(v[0].mean(axis=1, keepdims=True), q[0].shape),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)


def _mlp_check(monkeypatch, rows, d_in, d_mid, d_out):
    monkeypatch.setattr(jfm, "FORCE_KERNEL", True)
    rng = np.random.default_rng(rows * 7919 + d_in * 31 + d_mid)
    x = rng.standard_normal((rows, d_in)).astype(np.float32)
    w1 = (rng.standard_normal((d_in, d_mid)) * d_in ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(d_mid) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((d_mid, d_out)) * d_mid ** -0.5).astype(np.float32)
    want = np.asarray(jfm.fused_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2))))
    # w1/w2 as the transposed nn.Linear weight views the DiT passes
    w1_t = torch.from_numpy(np.ascontiguousarray(w1.T)).t()
    w2_t = torch.from_numpy(np.ascontiguousarray(w2.T)).t()
    got = tfm.reference_mlp(torch.from_numpy(x), w1_t, torch.from_numpy(b1), w2_t)
    assert got.dtype == torch.float32 and got.shape == (rows, d_out)
    assert np.abs(got.numpy() - want).max() <= MLP_REL_TOL * np.abs(want).max()


# rows on both sides of each instance's row block: 128 (d_out 256), 64 (384, 32),
# 32 (128)
MLP_ROWS = ([(r, 256, 512, 256) for r in (127, 128, 129)]
            + [(r, 384, 768, 384) for r in (63, 64, 65)]
            + [(r, 128, 256, 128) for r in (31, 32, 33, 63, 65)]
            + [(r, 32, 64, 32) for r in (1, 63, 64, 65, 129)])
# d_mid on both sides of each instance's chunk: 64 (256, 32) and 96 (384)
MLP_MIDS = ([(33, 256, m, 256) for m in (48, 64, 80, 128)]
            + [(33, 384, m, 384) for m in (80, 96, 112, 192)]
            + [(33, 32, m, 32) for m in (48, 64, 80, 128)])


@pytest.mark.parametrize("rows,d_in,d_mid,d_out", MLP_ROWS + MLP_MIDS)
def test_k2_fp32_plain_matches_jax_at_the_tiled_kernels_edges(monkeypatch, rows, d_in, d_mid,
                                                              d_out):
    _mlp_check(monkeypatch, rows, d_in, d_mid, d_out)


@pytest.mark.parametrize("d_out", range(16, 1025, 16))
def test_tiled_plan_over_every_width_the_checks_accept(d_out):
    """Every d_in (multiples of 16 up to 1024), d_mid (multiples of 16 up to
    1536) and row count: the outer-product plan exists exactly for d_out 256,
    384, 128 or 32 with d_in a multiple of the instance's k-slice, d_mid one
    of its chunk and its shared memory (x^T grows with d_in) within the
    block's 227 KB; at d_out 384 it takes 32-row blocks exactly where 64-row
    ones would number fewer than the SMs."""
    sizes = sorted((bm for (o, bm) in tfm.TILED_INSTANCES if o == d_out), reverse=True)
    for rows in (1, 333, 4000, 8384, 8385, 16000, 368640):
        for d_in in range(16, 1025, 16):
            for d_mid in range(16, 1537, 16):
                plan = tfm.tiled_plan(d_in, d_mid, d_out, rows)
                if not sizes:
                    assert plan is None
                    continue
                bm = sizes[-1] if len(sizes) > 1 and -(-rows // sizes[0]) < 132 else sizes[0]
                threads, chunk, ks, _ = tfm.TILED_INSTANCES[(d_out, bm)]
                smem = tfm.tiled_smem_bytes(d_in, d_out, bm)
                if d_in % ks or d_mid % chunk or smem > SMEM_MAX:
                    assert plan is None
                    continue
                assert plan == (bm, threads, chunk, smem)
                assert threads <= 1024 and threads % 32 == 0
    # every instance takes its registry's d_in, and more
    for (o, bm), (_, _, ks, _) in tfm.TILED_INSTANCES.items():
        if o == d_out:
            assert tfm.tiled_smem_bytes(max(o, 2 * ks), o, bm) <= SMEM_MAX


def test_tiled_plans_at_the_registry_widths():
    """The registries' fp32 widths: MD17's 128-row blocks of 256 threads
    (x^T [256, 132], three stages of 64 w1^T rows [64, 68], G^T [64, 132]),
    the 4AA's 64-row blocks at the sampling B = 8 (16,000 rows) and 32-row
    blocks at the eval's B = 2 (4,000 rows), the smoke width's 64-row
    blocks."""
    md17 = 4 * (256 * 132 + 3 * 64 * 68 + 64 * 132)
    assert tfm.tiled_plan(256, 512, 256, 368640) == (128, 256, 64, md17) and md17 == 221184
    assert tfm.tiled_plan(384, 768, 384, 16000) == (64, 384, 96, 207360)
    assert tfm.tiled_plan(384, 768, 384, 4000) == (32, 192, 96, 216576)
    assert tfm.tiled_plan(32, 64, 32, 4096) == (64, 128, 64, 52224)
    assert tfm.tiled_plan(384, 768, 384, 8385) == (64, 384, 96, 207360)  # 132 blocks of 64
    assert tfm.tiled_plan(384, 768, 384, 8384) == (32, 192, 96, 216576)  # 131


@pytest.mark.parametrize("d_in,d_mid,d_out,route", [
    (256, 512, 256, "tiled"), (384, 768, 384, "tiled"), (32, 64, 32, "tiled"),
    (16, 32, 16, "dot"), (128, 256, 128, "tiled"), (96, 192, 96, "dot"),
    (256, 496, 256, "dot"), (480, 960, 256, "dot"), (1024, 2048, 1024, None)])
def test_k2_fp32_routes(d_in, d_mid, d_out, route):
    """The route each width takes on the card: the registries' fp32 widths
    (MD17, 4AA, the pedestrian's hidden 128, the smoke width) the
    outer-product kernel; the hidden-16 and hidden-96 widths, a d_mid off
    the chunk and a d_in off the k-slice the dot-product kernel; past both,
    the check refuses."""
    tiled = tfm.tiled_plan(d_in, d_mid, d_out)
    dot = tfm.f32_plan(d_in, d_out)
    got = "tiled" if tiled is not None else "dot" if dot is not None else None
    assert got == route


def test_tiled_plans_at_the_pedestrian_width():
    """The pedestrian DiT's MLP branch (128 -> 256 -> 128): 32-row blocks of
    128 threads at any row count (x^T [128, 36], three stages of the larger
    of a 32-row w1^T slice [32, 132] and a 32-row w2^T slice [32, 128], G^T
    [128, 36]), two blocks an SM: at the test pass's 10,240 rows 320 blocks
    (64-row blocks of 256 threads, 160 of them with 28 in a second wave, were
    slower on an H100, tools/kernel_variants.py K2-fp32)."""
    smem = 4 * (128 * 36 + 3 * 32 * 132 + 128 * 36)
    for rows in (1, 77, 10240, 368640):
        assert tfm.tiled_plan(128, 256, 128, rows) == (32, 128, 128, smem)
    assert smem == 87552 and 2 * smem <= 233472  # two blocks in an SM's 228 KB
    assert tfm.tiled_plan(128, 248, 128, 10240) is None  # d_mid off the chunk: the dot route
    assert tfm.tiled_plan(128, 248, 128, 10240) is None  # d_mid off the chunk: the dot route


@pytest.mark.parametrize("nq", [1, 20, 30, 31, 32, 33, 63, 64, 65, 130, 192, 1000])
def test_f32_wide_plan_over_its_domain(nq):
    """Two sequences a 64-row block exactly where Nq and Nk are both at most
    32, one elsewhere; the block's shared memory lets two blocks share an
    SM."""
    for nk in (1, 17, 30, 32, 33, 45, 64, 257, 1000):
        assert tfa.f32_wide_plan(nq, nk) == (2 if nq <= 32 and nk <= 32 else 1)
    assert 2 * (tfa.f32_wide_smem_bytes() + 1024) <= SM_SMEM
    assert tfa.f32_wide_smem_bytes() == 101120


def test_f32_wide_plans_at_the_main_paths():
    """MD17's fp32 DiT at 2 x 128 (spatial N = 192, temporal T = 30) and the
    4AA eval at 3 x 128 (T = 1000), and K1-fp32's lower edge: dh 65 takes
    the register-tiled kernel, dh 64 the kernel of a thread a row."""
    assert tfa.f32_wide_plan(192, 192) == 1
    assert tfa.f32_wide_plan(30, 30) == 2
    assert tfa.f32_wide_plan(1000, 1000) == 1
    assert tfa.F32_WIDE_MIN_DH == 65 and tfa.MAX_DH == 128


def test_cpu_calls_count_no_launch(monkeypatch):
    """On CPU tensors the fp32 wrappers take their plain versions and count
    nothing: K1 and K5 at dh 128, K2 at MD17's widths."""
    for mod, names in ((tfa, ("launches", "fp32_launches", "fp32_wide_launches")),
                       (tnr, ("launches", "fp32_launches", "fp32_wide_launches")),
                       (tfm, ("launches", "fp32_launches", "fp32_tiled_launches",
                              "fp32_dot_launches"))):
        for name in names:
            monkeypatch.setattr(mod, name, 0)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 33, 128)).astype(np.float32))
               for _ in range(3))
    torch.testing.assert_close(tfa.flash_attention(q, k, v), tfa.reference_attention(q, k, v),
                               atol=0, rtol=0)
    qs, ks = (torch.from_numpy(1 + 0.2 * rng.standard_normal(128).astype(np.float32))
              for _ in range(2))
    cos, sin = rope_cos_sin(33, 128)
    args = (q, k, v, qs, ks, cos, sin)
    torch.testing.assert_close(tnr.flash_attention_normrope(*args),
                               tnr.reference_attention_normrope(*args), atol=0, rtol=0)
    x = torch.from_numpy(rng.standard_normal((5, 256)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32) * 0.05).t()
    b1 = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32) * 0.05).t()
    torch.testing.assert_close(tfm.fused_mlp(x, w1, b1, w2), tfm.reference_mlp(x, w1, b1, w2),
                               atol=0, rtol=0)
    assert (tfa.launches, tfa.fp32_launches, tfa.fp32_wide_launches) == (0, 0, 0)
    assert (tnr.launches, tnr.fp32_launches, tnr.fp32_wide_launches) == (0, 0, 0)
    assert (tfm.launches, tfm.fp32_launches, tfm.fp32_tiled_launches,
            tfm.fp32_dot_launches) == (0, 0, 0, 0)
