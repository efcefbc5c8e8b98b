"""The plain version behind the redesigned K2, and its geometry, on the CPU.

``csrc/fused_mlp.cu``'s Hopper kernel walks 128-row x tiles (two
warpgroups of 64 rows), d_mid in chunks of 64 (or 32) columns and d_out in
passes of up to 256; on the card it is held to ``reference_mlp``. Here
``reference_mlp`` is held to the JAX kernel (``fused_mlp`` with
``FORCE_KERNEL``, its Pallas kernel in interpret mode) at the new tile
edges: rows on both sides of 64 and 128, d_mid on both sides of both chunk
widths, and every registry width (hidden 16, 32, 128, 256, 384 with mid
2x). Also the wrapper's plan (``sm90_plan``) over the whole domain its
checks accept, with shared memory within the block's 227 KB, the closed
forms the kernel takes outside its GELU table, and that CPU calls count no
launch.

Inputs are made with numpy from a seed; fp32 on both sides, so only the
order of fp32 sums differs: 2e-5, the limit of tests/test_fused_mlp.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops import fused_mlp as jfm
from lam_slide_tpu_torch.nn.blocks import gelu_exact
from lam_slide_tpu_torch.ops import fused_mlp as tfm

ATOL = RTOL = 2e-5
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes
ROW_EDGES = [1, 63, 64, 65, 127, 128, 129]
# d_mid on both sides of the 64-column chunk (d_in 32) and of the 32-column
# chunk (d_in 384, whose plan takes chunks of 32)
MID_EDGES = [(32, m) for m in (16, 48, 64, 80, 128, 144)] + [(384, m) for m in (16, 32, 48, 96)]
REGISTRY_WIDTHS = [16, 32, 128, 256, 384]


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check_against_jax(monkeypatch, rows, d_in, d_mid, d_out, seed):
    monkeypatch.setattr(jfm, "FORCE_KERNEL", True)
    rng = np.random.default_rng(seed)
    x = _randn(rng, rows, d_in)
    w1 = _randn(rng, d_in, d_mid, scale=d_in ** -0.5)
    b1 = _randn(rng, d_mid, scale=0.1)
    w2 = _randn(rng, d_mid, d_out, scale=d_mid ** -0.5)
    want = jfm.fused_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2)))
    got = tfm.reference_mlp(*(torch.from_numpy(a) for a in (x, w1, b1, w2)))
    assert got.dtype == torch.float32 and got.shape == (rows, d_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows", ROW_EDGES)
def test_k2_plain_matches_jax_at_row_tile_edges(monkeypatch, rows):
    _check_against_jax(monkeypatch, rows, 32, 64, 32, seed=rows)


@pytest.mark.parametrize("d_in,d_mid", MID_EDGES)
def test_k2_plain_matches_jax_at_chunk_edges(monkeypatch, d_in, d_mid):
    _check_against_jax(monkeypatch, 65, d_in, d_mid, d_in, seed=d_in * 7 + d_mid)


@pytest.mark.parametrize("d", REGISTRY_WIDTHS)
def test_k2_plain_matches_jax_at_registry_widths(monkeypatch, d):
    _check_against_jax(monkeypatch, 130, d, 2 * d, d, seed=d)


@pytest.mark.parametrize("d_out", [16, 48, 256, 272, 384, 512, 528])
def test_k2_plain_matches_jax_across_output_passes(monkeypatch, d_out):
    """d_out on both sides of one 256-column pass (two passes from 272 on,
    three from 528)."""
    _check_against_jax(monkeypatch, 70, 64, 96, d_out, seed=d_out)


def test_k2_plan_fits_every_width_the_checks_accept():
    """Every d_in and d_out (multiples of 16) up to 1024: the plan's output
    passes cover d_out with as few passes of at most 256 columns as it
    allows, each a multiple of 64 and less than 64 wider than an even split;
    its shared memory fits the block; a plan exists for every d_in up to
    448, and none exists only where even the smallest plan does not fit."""
    for d_in in range(16, 1025, 16):
        for d_out in range(16, 1025, 16):
            passes = -(-d_out // 256)
            even = -(-d_out // passes)  # columns a pass, split evenly
            plan = tfm.sm90_plan(d_in, d_out)
            if plan is None:
                smallest = tfm.sm90_smem_bytes(d_in, 32, -(-even // 64) * 64, 2)
                assert d_in > 448 and smallest > SMEM_MAX
                continue
            nc, no, s1 = plan
            assert nc in (32, 64) and 2 <= s1 <= tfm.SM90_MAX_S1
            assert no % 64 == 0 and 64 <= no <= 256 and -(-d_out // no) == passes
            assert even <= no < even + 64
            assert tfm.sm90_smem_bytes(d_in, nc, no, s1) <= SMEM_MAX
            if nc == 32:  # chunks of 64 did not fit with two w1 stages
                assert tfm.sm90_smem_bytes(d_in, 64, no, 2) > SMEM_MAX


def test_k2_plans_at_the_registry_widths():
    """The plans the main paths run (d_in = d_out = hidden, mid 2x) and the
    kernel's shared-memory layout at MD17's: a 128 x 256 x tile (64 KB), two
    w1 panels of 64 x 256 and two w2 panels of 256 x 64 (32 KB each), four
    GELU tiles of 64 x 64 (8 KB each), 128 bytes of mbarriers and 1 KB of
    alignment slack."""
    assert tfm.sm90_plan(16, 16) == (64, 64, 4)
    assert tfm.sm90_plan(32, 32) == (64, 64, 4)
    assert tfm.sm90_plan(128, 128) == (64, 128, 4)
    assert tfm.sm90_plan(256, 256) == (64, 256, 2)
    assert tfm.sm90_plan(384, 384) == (32, 192, 3)  # two passes of 192
    assert tfm.sm90_smem_bytes(256, 64, 256, 2) == (65536 + 2 * 32768 + 2 * 32768 + 4 * 8192
                                                    + 128 + 1024)
    assert tfm.sm90_plan(1024, 64) is None  # the WMMA route


def test_gelu_closed_forms_outside_the_kernel_table():
    """The Hopper K2 reads the bf16 GELU of a bf16 mid from a table for
    |mid| in [2^-9, 8) and takes closed forms of the same fp32 formula
    outside it: 0.5 mid below (1 + erf is within half a bf16 ulp of 1), mid
    above for mid > 0 (erf is 1 in fp32) and -0 (NaN at -inf) for mid < 0.
    Over every bf16 bit pattern outside the table, the closed forms equal
    the plain version's ``gelu_exact`` bit for bit."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    mag = torch.arange(1 << 16) & 0x7FFF
    outside = ((mag < tfm.GELU_TABLE_LO) | (mag >= tfm.GELU_TABLE_LO + tfm.GELU_TABLE_SPAN))
    assert int((~outside).sum()) == tfm.GELU_TABLE_ENTRIES == 3072
    mid = bits[outside].float()
    keep = ~torch.isnan(mid)
    mid, m_small = mid[keep], (mag[outside] < tfm.GELU_TABLE_LO)[keep]
    closed = 0.5 * mid * torch.where(m_small, torch.ones_like(mid), 1 + torch.sign(mid))
    want = gelu_exact(mid.to(torch.bfloat16))
    got = closed.to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_cpu_calls_count_no_launch(monkeypatch):
    """On CPU tensors fused_mlp takes reference_mlp and counts nothing."""
    for name in ("launches", "wmma_launches", "cp_async_launches"):
        monkeypatch.setattr(tfm, name, 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_randn(rng, 5, 32)).to(torch.bfloat16)
    w1 = torch.from_numpy(_randn(rng, 64, 32, scale=0.1)).to(torch.bfloat16).t()
    b1 = torch.from_numpy(_randn(rng, 64)).to(torch.bfloat16)
    w2 = torch.from_numpy(_randn(rng, 32, 64, scale=0.1)).to(torch.bfloat16).t()
    got = tfm.fused_mlp(x, w1, b1, w2)
    torch.testing.assert_close(got, tfm.reference_mlp(x, w1, b1, w2), atol=0, rtol=0)
    assert (tfm.launches, tfm.wmma_launches, tfm.cp_async_launches) == (0, 0, 0)


# ---- the fp32 kernel (csrc/fused_mlp_f32.cu): 64- or 32-row blocks, d_mid
# in chunks of 32, a thread's outputs in columns tx + 16 j (j < 2..32)

F32_REL_TOL = 1e-5
# (rows, d_in, d_mid, d_out): rows on both sides of the 32- and 64-row
# blocks; d_mid with a partial last chunk; d_out at the column counts a
# thread's instances hold (32, 64, 128, 256, 384, 512) and one past; the
# registry widths (hidden 16, 32, 128, 256, 384, mid 2x)
F32_EDGES = ([(r, 32, 64, 32) for r in (31, 32, 33, 63, 64, 65)]
             + [(65, 32, m, 32) for m in (16, 48, 80, 96, 112)]
             + [(65, 384, m, 384) for m in (16, 48, 80)]
             + [(33, 64, 96, o) for o in (48, 64, 80, 144, 256, 272, 384, 400, 512)]
             + [(130, d, 2 * d, d) for d in REGISTRY_WIDTHS])


@pytest.mark.parametrize("rows,d_in,d_mid,d_out", F32_EDGES)
def test_k2_fp32_plain_matches_jax_at_the_fp32_kernels_edges(monkeypatch, rows, d_in, d_mid,
                                                             d_out):
    """The fp32 instance the MD17 test pass runs: ``reference_mlp`` in fp32
    (no rounding of the mid) against JAX's kernel in interpret mode, within
    1e-5 of the largest output."""
    monkeypatch.setattr(jfm, "FORCE_KERNEL", True)
    rng = np.random.default_rng(rows * 1000 + d_mid + d_out)
    x = _randn(rng, rows, d_in)
    w1 = _randn(rng, d_in, d_mid, scale=d_in ** -0.5)
    b1 = _randn(rng, d_mid, scale=0.1)
    w2 = _randn(rng, d_mid, d_out, scale=d_mid ** -0.5)
    want = np.asarray(jfm.fused_mlp(*(jnp.asarray(a) for a in (x, w1, b1, w2))))
    # w1/w2 as the transposed nn.Linear weight views the DiT passes
    w1_t = torch.from_numpy(np.ascontiguousarray(w1.T)).t()
    w2_t = torch.from_numpy(np.ascontiguousarray(w2.T)).t()
    got = tfm.reference_mlp(torch.from_numpy(x), w1_t, torch.from_numpy(b1), w2_t)
    assert got.dtype == torch.float32 and got.shape == (rows, d_out)
    assert np.abs(got.numpy() - want).max() <= F32_REL_TOL * np.abs(want).max()


def test_k2_fp32_plan_fits_every_width_the_checks_accept():
    """Every d_in and d_out (multiples of 16) up to 1024: the fp32 plan is
    the first of 64 rows with two chunk stages, 32 with two, 64 with one and
    32 with one that fits the block's 227 KB, and none only past d_out 512
    or where none fits; MD17's widths take 64 rows and two stages in 211 KB,
    the 4AA's one stage."""
    for d_in in range(16, 1025, 16):
        for d_out in range(16, 1025, 16):
            plan = tfm.f32_plan(d_in, d_out)
            fits = [p for p in tfm.F32_PLANS if tfm.f32_smem_bytes(*p, d_in, d_out) <= SMEM_MAX]
            if plan is None:
                assert d_out > tfm.F32_MAX_D_OUT or not fits
                continue
            assert d_out <= tfm.F32_MAX_D_OUT and plan == fits[0]
            assert tfm.f32_smem_bytes(*plan, d_in, d_out) <= SMEM_MAX
    assert tfm.f32_plan(256, 256) == (64, 2) and tfm.f32_plan(384, 384) == (64, 1)
    assert tfm.f32_smem_bytes(64, 2, 256, 256) == 4 * (128 * 260 + 576 * 36) == 216064
