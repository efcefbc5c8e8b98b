"""The plain version behind K1's narrow fp32 forward, and its geometry, on
the CPU.

``csrc/flash_attention.cu``'s narrow kernel takes K1 (and its packed entry
K3) in fp32 at dh <= 64: blocks of 256 threads over 64 query rows, key
tiles of 64 (32 where Nk <= 32, stage 1's padded atoms), dh zero-padded to
the next of 8, 16, 24, 32, 48, 64, a thread a 4 x 4 block of the scores and,
over a quarter of each key tile, a 4 x dh/4 block of the output, the four
quarters summed at the end of the block. On the card it is held to
``reference_attention`` / ``reference_attention_packed``; here those plain
versions are held to JAX ``_flash_forward`` / ``_flash_forward_packed``
(interpret mode) at the new kernel's tile edges, on inputs made with numpy
from a seed:

* Nq and Nk at 63/64/65, 191/192/193, 30 and 1000 and ragged pairs, at dh
  8, 16, 24, 32, 48 and 64, without and with the lse;
* with the key-padding bias (stage 1's 192 -> 32 atoms, ragged pairs), the
  first row masking every key;
* the packed entry on [B, N, H*dh] operands at each dh.

Also ``f32_narrow_fwd_plan`` over every dh in 1..64 (shared memory within an
H100 block's 232,448 bytes, the key tile), the widths it names are the
kernel's instances, and CPU calls count no launch.

Tolerance: fp32 on both sides, so only the order of the sums differs: 2e-5
of the largest output (tests/test_torch_port_f32_tiles.py's attention
limit).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as tfa

TOL = 2e-5
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes
DHS = [8, 16, 24, 32, 48, 64]
# (nq, nk) on both sides of the 64-row query tiles and the 64-key tiles, the
# short axes, the 4AA temporal axis and ragged pairs
EDGES = [(63, 63), (64, 64), (65, 65), (191, 191), (192, 192), (193, 193), (30, 30),
         (1000, 1000), (65, 191), (193, 63), (30, 65), (130, 257)]
BIAS_SIZES = [(192, 32), (192, 31), (65, 33), (130, 257)]
PACKED_SIZES = [(63, 63), (65, 65), (192, 192), (193, 130)]


def _assert_close(got, want):
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    top = np.abs(want).max()
    assert top > 0
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * top, f"max err {err} > {TOL} x {top}"


def _run(dh, nq, nk, masked, seed):
    """The plain version without and with the lse against JAX's forward with
    the lse (one JAX program a shape)."""
    rng = np.random.default_rng(seed)
    b, h = 2, 2
    q = rng.standard_normal((b, h, nq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, h, nk, dh)).astype(np.float32) for _ in range(2))
    scale = dh ** -0.5
    mask = None
    if masked:
        mask = np.arange(nk)[None, :] < rng.integers(1, nk + 1, size=(b, 1))
        mask[0] = False  # an all-masked row: uniform weights over its keys on both sides
    bias = None if mask is None else jfa._mask_to_bias(jnp.asarray(mask), b, nk)
    want, want_lse = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), bias, scale,
                                        with_lse=True)
    targs = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got, got_lse = tfa.reference_attention(*targs, scale, return_lse=True, mask=tmask)
    _assert_close(got_lse, want_lse)
    _assert_close(got, want)
    _assert_close(tfa.reference_attention(*targs, scale, mask=tmask), want)
    if masked:
        mean = np.broadcast_to(v[0].mean(axis=1, keepdims=True), q[0].shape)
        assert np.abs(got[0].numpy() - mean).max() <= TOL * np.abs(mean).max()


@pytest.mark.parametrize("nq,nk", EDGES)
@pytest.mark.parametrize("dh", DHS)
def test_fp32_attention_matches_jax_at_the_narrow_kernels_edges(dh, nq, nk):
    _run(dh, nq, nk, False, dh * 100000 + nq * 300 + nk)


@pytest.mark.parametrize("nq,nk", BIAS_SIZES)
@pytest.mark.parametrize("dh", DHS)
def test_fp32_attention_matches_jax_with_the_bias(dh, nq, nk):
    _run(dh, nq, nk, True, dh * 100000 + nq * 500 + nk)


@pytest.mark.parametrize("nq,nk", PACKED_SIZES)
@pytest.mark.parametrize("dh", DHS)
def test_fp32_packed_attention_matches_jax(dh, nq, nk):
    """K3's packed operands [B, N, H*dh] (16 heads at the registries' dh 16
    and 24, else 8: the JAX kernel takes multiples of 8 heads)."""
    rng = np.random.default_rng(dh * 7000 + nq * 13 + nk)
    b, h = 2, 16 if dh in (16, 24) else 8
    q = rng.standard_normal((b, nq, h * dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, nk, h * dh)).astype(np.float32) for _ in range(2))
    want = jfa._flash_forward_packed(*(jnp.asarray(a) for a in (q, k, v)), h, dh ** -0.5)
    got = tfa.reference_attention_packed(*(torch.from_numpy(a) for a in (q, k, v)), h,
                                         dh ** -0.5)
    _assert_close(got, want)


@pytest.mark.parametrize("dh", range(1, 65))
def test_f32_narrow_fwd_plan_over_every_width(dh):
    """dh padded to the next instance (a multiple of 8; 40 and 56 to 48 and
    64), key tiles of 32 exactly where Nk <= 32, shared memory within a
    block's limit."""
    for nk in (1, 30, 32, 33, 65, 192, 1000):
        plan = tfa.f32_narrow_fwd_plan(dh, nk)
        assert plan.dp in tfa.F32_NARROW_DPS and plan.dp >= dh > plan.dp - 16
        assert plan.dp % 8 == 0 and (dh > 32 or plan.dp - dh < 8)
        assert plan.keys == (32 if nk <= 32 else 64)
        # Q, two stages of K and V, P^T and the bias: the partial outputs of
        # the four key slices (4 x 64 rows of dp + 1) overlay them
        tiles = 4 * ((64 + 4 * plan.keys) * (plan.dp + 4) + plan.keys * 68 + 2 * plan.keys)
        assert max(tiles, 4 * 4 * 64 * (plan.dp + 1)) < plan.smem_bytes <= SMEM_MAX


def test_f32_narrow_fwd_plans_at_the_main_paths():
    """The registries' narrow widths run unpadded: the 4AA fp32 DiT's 16 x 24
    over T = 1000, MD17's dh 16 over 192 latents and stage 1's cross
    attention over 32 atoms (one 32-key tile), the smoke DiTs' dh 8; the
    plan's widths are the kernel's instances; past dh 64 it refuses (the
    wide kernel's domain)."""
    assert tfa.f32_narrow_fwd_plan(24, 1000)[:2] == (24, 64)
    assert tfa.f32_narrow_fwd_plan(16, 192)[:2] == (16, 64)
    assert tfa.f32_narrow_fwd_plan(16, 32)[:2] == (16, 32)
    assert tfa.f32_narrow_fwd_plan(8, 30).dp == 8
    source = (_build.CSRC / "flash_attention.cu").read_text()
    body = source[source.index("cudaError_t launch_f32_narrow_dp"):]
    body = body[:body.index("default:")]
    assert tuple(int(c) for c in re.findall(r"LAM_NARROW_FWD\((\d+)\)", body)) == (
        tfa.F32_NARROW_DPS)
    with pytest.raises(ValueError):
        tfa.f32_narrow_fwd_plan(65, 30)


def test_cpu_calls_count_no_launch(monkeypatch):
    """On CPU tensors the fp32 forward takes its plain version and counts
    nothing: head-major with and without the bias, with a gradient, and the
    packed entry."""
    names = ("launches", "bias_launches", "fp32_launches", "fp32_narrow_launches",
             "fp32_wide_launches", "bwd_fp32_launches")
    for name in names:
        monkeypatch.setattr(tfa, name, 0)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 3, 65, 24)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 3, 33, 24)).astype(np.float32))
            for _ in range(2))
    mask = torch.from_numpy(np.arange(33)[None, :] < np.array([[5], [33]]))
    for m in (None, mask):
        torch.testing.assert_close(tfa.flash_attention(q, k, v, mask=m),
                                   tfa.reference_attention(q, k, v, mask=m), atol=0, rtol=0)
    qg = q.clone().requires_grad_(True)
    tfa.flash_attention(qg, k, v, mask=mask).sum().backward()
    assert qg.grad is not None
    p = torch.from_numpy(rng.standard_normal((2, 40, 16 * 24)).astype(np.float32))
    torch.testing.assert_close(tfa.flash_attention_packed(p, p, p, 16),
                               tfa.reference_attention_packed(p, p, p, 16), atol=0, rtol=0)
    assert [getattr(tfa, n) for n in names] == [0] * len(names)
