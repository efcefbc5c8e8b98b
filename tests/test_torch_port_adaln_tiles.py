"""The plain versions behind the redesigned K7, and its wrapper, on the CPU.

``csrc/fused_adaln.cu`` walks the rows of each batch index two at a time a
warp, in 16-, 8- or 4-byte accesses of chunks of D (the widest that D, the
pointers and the strides allow), with the batch index's gate/shift/scale
loaded once a warp; on the card it is held to its plain versions. Here the
plain versions are held to the JAX kernels (``residual_adaln_modulate`` and
``adaln_modulate`` with ``FORCE_KERNEL``, in interpret mode) at the new
geometry's edges: D whose chunks fill every lane (256 at 16 bytes, 384 and
128 at 8) and D that leaves lanes idle (64, 30), row counts of a batch index
that are odd (a warp's second row past the end), h as the transposed view
the DiT hands over and the modulation as chunks of one [B, 1, 1, 6D]
tensor. Also the wrapper's signature cache (a refused call raises every
time and is not kept) and that CPU calls count no launch.

Inputs are made with numpy from a seed; fp32 on both sides, so only the
order of fp32 sums differs: 2e-5, the fp32 limit of
tests/test_torch_port_fused.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops import fused_adaln as jad
from lam_slide_tpu_torch.ops import fused_adaln as tad

ATOL = RTOL = 2e-5
# (B, T, L, D): the 4AA DiT's [B, 1000, 2, 384] cut in T, the MD17 DiT's
# [320, 30, 192, 256] cut in B and L, and widths that leave lanes idle
SHAPES = [(2, 37, 2, 384), (3, 5, 7, 256), (2, 9, 3, 128), (3, 11, 1, 64), (2, 5, 3, 30)]


def _inputs(seed, b, t, l, d):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, l, d)) * 3).astype(np.float32)
    h_blt = rng.standard_normal((b, l, t, d)).astype(np.float32)
    mods = (rng.standard_normal((b, 1, 1, 6 * d)) * 0.5).astype(np.float32)
    return x, h_blt, mods


@pytest.mark.parametrize("b,t,l,d", SHAPES)
def test_k7_plain_matches_jax_at_access_width_edges(monkeypatch, b, t, l, d):
    monkeypatch.setattr(jad, "FORCE_KERNEL", True)
    x, h_blt, mods = _inputs(b * 1000 + d, b, t, l, d)
    tshift, tscale, tgate = torch.from_numpy(mods).chunk(6, dim=-1)[:3]
    th = torch.from_numpy(h_blt).transpose(1, 2)  # [B, T, L, D] view of [B, L, T, D]
    jshift, jscale, jgate = (jnp.asarray(m.numpy()) for m in (tshift, tscale, tgate))
    jh = jnp.asarray(np.ascontiguousarray(h_blt.transpose(0, 2, 1, 3)))
    want_x, want_y = jad.residual_adaln_modulate(jnp.asarray(x), jh, jgate, jshift, jscale)
    got_x, got_y = tad.reference_residual_adaln_modulate(torch.from_numpy(x), th, tgate, tshift,
                                                         tscale)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=ATOL, rtol=RTOL)
    want_y0 = jad.adaln_modulate(jnp.asarray(x), jshift, jscale)
    got_y0 = tad.reference_adaln_modulate(torch.from_numpy(x), tshift, tscale)
    np.testing.assert_allclose(got_y0.numpy(), np.asarray(want_y0), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
def test_k7_refused_calls_are_not_kept(monkeypatch, residual):
    """The wrapper keeps the checked launch arguments per signature; a
    refused call (here on meta tensors, which no kernel takes) raises
    ValueError on every call and leaves nothing kept. (The card's tests
    check each refusal after a signature is kept.)"""
    monkeypatch.setattr(tad, "_DIMS", {})
    monkeypatch.setattr(tad, "launches", 0)
    x = torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16, device="meta")
    h = torch.zeros(2, 3, 5, 64, dtype=torch.bfloat16, device="meta").transpose(1, 2)
    shift, scale, gate = torch.zeros(2, 1, 1, 384, dtype=torch.bfloat16,
                                     device="meta").chunk(6, dim=-1)[:3]
    for _ in range(2):
        with pytest.raises(ValueError):
            if residual:
                tad.residual_adaln_modulate(x, h, gate, shift, scale)
            else:
                tad.adaln_modulate(x, shift, scale)
    assert tad._DIMS == {} and tad.launches == 0


def test_k7_cpu_calls_count_no_launch(monkeypatch):
    """On CPU tensors both entries take the plain versions and count
    nothing."""
    monkeypatch.setattr(tad, "launches", 0)
    x, h_blt, mods = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(0, 2, 5, 3, 64))
    shift, scale, gate = mods.chunk(6, dim=-1)[:3]
    h = h_blt.transpose(1, 2)
    got = tad.residual_adaln_modulate(x, h, gate, shift, scale)
    for a, w in zip(got, tad.reference_residual_adaln_modulate(x, h, gate, shift, scale)):
        torch.testing.assert_close(a, w, atol=0, rtol=0)
    torch.testing.assert_close(tad.adaln_modulate(x, shift, scale),
                               tad.reference_adaln_modulate(x, shift, scale), atol=0, rtol=0)
    assert tad.launches == 0


# The fp32 kernel (csrc/fused_adaln_f32.cu): a warp a row, 16-byte accesses
# (4 floats) where D allows, chunk c = lane + 32 k: D filling 1, 2, 3, 4 and
# 8 chunks a lane, D leaving lanes idle (64) and D that takes 4-byte
# accesses (30).
F32_SHAPES = [(2, 5, 3, 128), (3, 5, 7, 256), (2, 37, 2, 384), (2, 3, 2, 512), (2, 3, 2, 1024),
              (3, 11, 1, 64), (2, 5, 3, 30)]
F32_REL_TOL = 1e-5


@pytest.mark.parametrize("b,t,l,d", F32_SHAPES)
def test_k7_fp32_plain_matches_jax_at_the_fp32_kernels_edges(monkeypatch, b, t, l, d):
    """Both entries in fp32, h the transposed view, the mods chunks of one
    [B, 1, 1, 6D] tensor: y within 1e-5 of the largest |y|; x_new within one
    fp32 ulp at the largest |x_new|. The plain version rounds x + gate * h
    per op, as PyTorch's ops and the card's kernel do (the GPU tests hold
    those two bit for bit); XLA on the CPU contracts the product and the
    add into one FMA, which rounds once."""
    monkeypatch.setattr(jad, "FORCE_KERNEL", True)
    x, h_blt, mods = _inputs(b * 1000 + d + 1, b, t, l, d)
    tshift, tscale, tgate = torch.from_numpy(mods).chunk(6, dim=-1)[:3]
    th = torch.from_numpy(h_blt).transpose(1, 2)
    jshift, jscale, jgate = (jnp.asarray(m.numpy()) for m in (tshift, tscale, tgate))
    jh = jnp.asarray(np.ascontiguousarray(h_blt.transpose(0, 2, 1, 3)))
    want_x, want_y = jad.residual_adaln_modulate(jnp.asarray(x), jh, jgate, jshift, jscale)
    got_x, got_y = tad.reference_residual_adaln_modulate(torch.from_numpy(x), th, tgate, tshift,
                                                         tscale)
    assert got_x.dtype == got_y.dtype == torch.float32
    want_x = np.asarray(want_x)
    assert np.abs(got_x.numpy() - want_x).max() <= np.spacing(np.abs(want_x).max())
    want_y0 = np.asarray(jad.adaln_modulate(jnp.asarray(x), jshift, jscale))
    got_y0 = tad.reference_adaln_modulate(torch.from_numpy(x), tshift, tscale).numpy()
    for got, want in ((got_y.numpy(), np.asarray(want_y)), (got_y0, want_y0)):
        assert np.abs(got - want).max() <= F32_REL_TOL * np.abs(want).max()
