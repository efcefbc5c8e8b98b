"""The plain version behind K4's fp32 kernels at every head width, and the
narrow pair's geometry, on the CPU.

``csrc/flash_attention_bwd.cu`` takes K4 in fp32 on register-tiled
kernels that make one pass over a key tile's queries and write dK, dV and
the tile's share of dQ (a second kernel sums the shares in tile order where
there is more than one key tile): at dh <= 64 the narrow kernel (blocks of
256 threads over 64-key tiles, dh padded to a multiple of 8, the queries
summed in slices that meet once at the end of a block), at 64 < dh <= 128
the wide kernel. On the card each is held to
``reference_flash_backward``; here that
plain version is held to JAX ``_flash_backward`` (interpret mode, 64-row
blocks) from the JAX forward's out and lse, on inputs made with numpy from
a seed:

* at the tiles' edges, Nq and Nk at 63/64/65 and 191/192/193 (and ragged
  pairs), at dh 8, 16, 24, 32, 64 and 128;
* with the key-padding bias and Nq != Nk (stage 1's 192 -> 32, ragged
  pairs, one query), the first row masking every key.

Also ``f32_narrow_plan`` over every dh it takes and a spread of (Nq, Nk):
dh padded to the next multiple of 8 in {8, 16, 24, 32, 48, 64}, the
registries' 8, 16 and 24 unpadded, the slices tiling a 64-row tile, shared
memory within an H100 block's 232,448 bytes and two blocks an SM up to dh
48; the widths it names are the kernel's instances; ``f32_dq_tiles``; and
that CPU calls count no launch.

Tolerance: fp32 on both sides, so only the order of the sums differs:
2e-5 of the largest grad (tests/test_torch_port_f32_train.py's FLASH_TOL).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu_torch.ops import _build
from lam_slide_tpu_torch.ops import flash_attention as tfa

FLASH_TOL = 2e-5
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes

EDGES = [(63, 63), (64, 64), (65, 65), (191, 191), (192, 192), (193, 193), (65, 191),
         (193, 63)]
BIAS_SIZES = [(192, 32), (65, 191), (1, 63), (130, 257)]


def _run(dh, nq, nk, masked, seed):
    """(got, want): the plain version's and JAX's (dq, dk, dv) on one draw."""
    rng = np.random.default_rng(seed)
    b, h = 2, 2
    q, g = (rng.standard_normal((b, h, nq, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, dh)).astype(np.float32) for _ in range(2))
    bias = None
    if masked:
        mask = np.arange(nk)[None, :] < rng.integers(1, nk + 1, size=(b, 1))
        mask[0] = False  # an all-masked row: P = 1 at each of its keys on both sides
        bias = jfa._mask_to_bias(jnp.asarray(mask), b, nk)
    scale = dh ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, bias, scale, block_q=64, block_k=64, with_lse=True)
    want = jfa._flash_backward(jq, jk, jv, bias, out, lse, jg, scale, block_q=64, block_k=64)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    got = tfa.reference_flash_backward(t(q), t(k), t(v), t(out), t(lse), t(g), scale,
                                       None if bias is None else t(bias))
    return got, want


def _assert_close(got, want):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        top = np.abs(w).max()
        assert top > 0, name
        err = np.abs(a.numpy() - w).max()
        assert err <= FLASH_TOL * top, f"{name}: max err {err} > {FLASH_TOL} x {top}"


@pytest.mark.parametrize("nq,nk", EDGES)
@pytest.mark.parametrize("dh", [8, 16, 24, 32, 64, 128])
def test_fp32_backward_plain_matches_jax_at_the_tiles_edges(dh, nq, nk):
    _assert_close(*_run(dh, nq, nk, False, dh * 1000 + nq * 3 + nk))


@pytest.mark.parametrize("nq,nk", BIAS_SIZES)
@pytest.mark.parametrize("dh", [8, 16, 24, 32, 64, 128])
def test_fp32_backward_plain_matches_jax_with_the_bias(dh, nq, nk):
    _assert_close(*_run(dh, nq, nk, True, dh * 1000 + nq * 5 + nk))


@pytest.mark.parametrize("dh", range(1, 65))
def test_f32_narrow_plan_over_every_width(dh):
    """dh padded to the next instance (a multiple of 8, 40 and 56 to 48 and
    64), the slices tiling a tile, shared memory within a block's limit and
    two blocks an SM up to dh 48; a block a 64-key tile."""
    for nq, nk in ((1, 1), (30, 30), (63, 65), (192, 32), (192, 192), (1000, 1000)):
        plan = tfa.f32_narrow_plan(dh, nq, nk, bh=6)
        assert plan.dp in tfa.F32_NARROW_DPS and plan.dp >= dh > plan.dp - 16
        assert plan.dp % 8 == 0 and (dh > 32 or plan.dp - dh < 8)
        assert plan.dp % plan.cols == 0 and plan.cols in (4, 6)  # 48 accumulators at most
        assert 16 * (plan.dp // plan.cols) * plan.slices == 256 and 64 % plan.slices == 0
        assert plan.slices * 64 * (plan.dp + 1) * 4 <= plan.smem_bytes <= SMEM_MAX
        assert plan.blocks_per_sm == (2 if plan.dp <= 48 else 1)
        assert plan.blocks == 6 * -(-nk // 64)


def test_f32_narrow_plans_at_the_main_paths():
    """The registries' narrow widths run unpadded: the 4AA fp32 DiT's 16 x 24
    over T = 1000, MD17's 16 x 16 over L = 192 and stage 1's encoder at dh 16
    over 192 -> 32 atoms, the smoke DiTs' dh 8; the plan's widths are the
    kernel's instances; past dh 64 it refuses (the wide kernel's domain)."""
    assert tfa.f32_narrow_plan(24, 1000, 1000, 512)[:3] == (24, 6, 4)
    assert tfa.f32_narrow_plan(16, 192, 192, 30720)[:3] == (16, 4, 4)
    assert tfa.f32_narrow_plan(16, 192, 32, 2048).blocks == 2048
    assert tfa.f32_narrow_plan(8, 30, 30).dp == 8
    source = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    body = source[source.index("cudaError_t launch_f32_narrow_dp"):]
    body = body[:body.index("default:")]
    assert tuple(int(c) for c in re.findall(r"case (\d+):", body)) == tfa.F32_NARROW_DPS
    with pytest.raises(ValueError):
        tfa.f32_narrow_plan(65, 30, 30)


@pytest.mark.parametrize("nq,nk", [(1, 1), (30, 30), (32, 32), (33, 30), (30, 33), (64, 64),
                                   (65, 64), (64, 65), (192, 192), (1000, 1000), (192, 32)])
@pytest.mark.parametrize("dh", [16, 24, 128])
def test_f32_dq_tiles(dh, nq, nk):
    """K4's fp32 kernels keep a key tile's dQ shares in scratch only where
    more than one 64-key tile covers the keys, and at dh > 64 two short
    sequences do not share a block (f32_wide_plan 2: both axes at most
    32)."""
    tiles = tfa.f32_dq_tiles(dh, nq, nk)
    two_short = dh > 64 and nq <= 32 and nk <= 32
    assert tiles == (1 if two_short else -(-nk // 64))


def test_cpu_calls_count_no_launch(monkeypatch):
    """On CPU tensors the fp32 backward takes its plain version and counts
    nothing, with and without the bias."""
    names = ("bwd_kv_launches", "bwd_q_launches", "bwd_bias_launches", "bwd_fp32_launches",
             "bwd_fp32_wide_launches", "bwd_sm90_launches")
    for name in names:
        monkeypatch.setattr(tfa, name, 0)
    rng = np.random.default_rng(1)
    q, g = (torch.from_numpy(rng.standard_normal((2, 3, 65, 24)).astype(np.float32))
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 3, 33, 24)).astype(np.float32))
            for _ in range(2))
    mask = torch.from_numpy(np.arange(33)[None, :] < np.array([[20], [33]]))
    for m in (None, mask):
        out, lse = tfa.reference_attention(q, k, v, 0.3, return_lse=True, mask=m)
        got = tfa.flash_attention_backward(q, k, v, out, lse, g, 0.3, mask=m)
        want = tfa.reference_flash_backward(q, k, v, out, lse, g, 0.3,
                                            None if m is None else tfa.mask_to_bias(m))
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=0, rtol=0)
    assert all(getattr(tfa, name) == 0 for name in names)
