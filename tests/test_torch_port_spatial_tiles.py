"""The plain version behind the redesigned K8, and its geometry, on the CPU.

``csrc/fused_spatial_block_sm90.cu`` walks 64-row tiles of whole frames
(64 // L * L rows), linear2's K dimension in head groups of ``group``
columns and MLP chunks of twice that; on the card it is held to
``reference_spatial_block``. Here ``reference_spatial_block`` is held to the
JAX kernel (``fused_spatial_block`` with ``FORCE_KERNEL``, its Pallas kernel
in interpret mode) at the new tile edges: frames on both sides of a tile at
L = 1, 2, 3, 5 and 8, head groups at dh 16, 24, 32 and 128, and the NBA,
pedestrian and 4AA widths. Also the wrapper's plan (``sm90_plan``) over the
whole domain its checks accept, with shared memory within the block's 227 KB,
the route every composite width and every tiny registry width takes, and
that CPU calls count no launch.

Inputs are made with numpy from a seed; fp32 on both sides, so only the
order of fp32 sums (and the JAX kernel's polynomial erf, 1.5e-7) differs:
2e-5, the fp32 limit of tests/test_torch_port_fused.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.models.latent_dit import rope_cos_sin as j_rope_cos_sin
from lam_slide_tpu.ops import fused_spatial_block as jsb
from lam_slide_tpu.ops.packed_attention import lane_rope_tables
from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import fused_spatial_block as tsb

ATOL = RTOL = 2e-5
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes
# (hidden, heads) of the composites whose DiTs run K8 (composites/nba.py:199-201,
# pedestrian.py:136-138, peptide.py:253-255 at both head splits)
COMPOSITE_WIDTHS = [(384, 16), (384, 3), (256, 16), (128, 4)]
# the tiny registries' DiTs (experiments/registry.py smoke widths), dh 4 to 8
TINY_WIDTHS = [(16, 2), (16, 4), (32, 4), (32, 8)]


def _check_against_jax(monkeypatch, n, l, heads, dh, m, seed):
    monkeypatch.setattr(jsb, "FORCE_KERNEL", True)
    rng = np.random.default_rng(seed)
    d = heads * dh
    x = rng.standard_normal((n, l, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, 3 * d + m)) * d ** -0.5).astype(np.float32)  # JAX [in, out]
    b1 = (rng.standard_normal(3 * d + m) * 0.1).astype(np.float32)
    qs, ks = ((np.abs(rng.standard_normal(dh)) + 0.5).astype(np.float32) for _ in range(2))
    w2 = (rng.standard_normal((d + m, d)) * (d + m) ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    cos_l, sin_l = lane_rope_tables(*j_rope_cos_sin(l, dh), heads)
    want = jsb.fused_spatial_block(jnp.asarray(x), *(jnp.asarray(a) for a in (w1, b1, qs, ks,
                                                                             w2, b2)),
                                   cos_l, sin_l, heads)
    t = torch.from_numpy
    got = tsb.reference_spatial_block(t(x), t(w1.T.copy()), t(b1), t(qs), t(ks), t(w2.T.copy()),
                                      t(b2), *rope_cos_sin(l, dh), heads, dh ** -0.5)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("l", [1, 2, 3, 5, 8])
def test_k8_plain_matches_jax_across_tile_edges(monkeypatch, l):
    """Two whole tiles of frames (64 // L frames each) and one frame more,
    so frames sit on both sides of each tile edge, at dh 16."""
    _check_against_jax(monkeypatch, 2 * (64 // l) + 1, l, 4, 16, 128, seed=l)


@pytest.mark.parametrize("heads,dh", [(4, 16), (4, 24), (2, 32), (1, 128)])
def test_k8_plain_matches_jax_at_head_group_widths(monkeypatch, heads, dh):
    """The head dims of the kernel's instances, several heads a group where
    the width allows; 67 frames of 2."""
    _check_against_jax(monkeypatch, 67, 2, heads, dh, 64, seed=dh)


@pytest.mark.parametrize("d,heads", COMPOSITE_WIDTHS)
def test_k8_plain_matches_jax_at_composite_widths(monkeypatch, d, heads):
    """The NBA, pedestrian and 4AA widths (mlp 2x), 33 frames of 3: the last
    tile ragged."""
    _check_against_jax(monkeypatch, 33, 3, heads, d // heads, 2 * d, seed=d + heads)


def test_k8_plan_fits_every_width_the_checks_accept():
    """Every (D, heads, M, L) the wrapper's checks accept (D and M multiples
    of 16 up to 1024, an even dh): a plan exists exactly for the (D, dh) of
    the kernel's instances, its tile rows are whole frames (64 // L * L), its
    rings hold at least three w1 stages beside three w2 stages or two of
    each, and its shared memory fits the block."""
    for d in range(16, 1025, 16):
        for heads in (h for h in range(1, d // 2 + 1) if d % h == 0 and (d // h) % 2 == 0):
            for m in (16, 2 * d, 1024):
                for l in range(1, 9):
                    plan = tsb.sm90_plan(1000, l, d, m, heads)
                    group = tsb.SM90_GROUPS.get((d, d // heads))
                    assert (plan is None) == (group is None)
                    if plan is None:
                        continue
                    assert plan.rows == 64 // l * l and plan.rows % l == 0
                    assert plan.group == group and plan.mlp_chunk == 2 * group
                    assert (plan.s2 == 3 and 3 <= plan.s1 <= tsb.SM90_MAX_STAGES
                            or plan.s2 == 2 and 2 <= plan.s1 <= tsb.SM90_MAX_STAGES)
                    assert plan.smem == tsb.sm90_smem_bytes(d, group, plan.s1, plan.s2)
                    assert plan.smem <= SMEM_MAX
                    assert tsb.sm90_smem_bytes(d, group, plan.s1 + 1, plan.s2) > SMEM_MAX or (
                        plan.s1 == tsb.SM90_MAX_STAGES)


@pytest.mark.parametrize("l", range(1, 9))
def test_k8_routes_of_the_composite_and_tiny_widths(l):
    """Every composite width takes the Hopper kernel at every L, at the main
    paths' sizes and at one frame; the tiny registries' widths take the WMMA
    route; the groups hold whole heads, and an attention chunk's items
    (64 rows x heads x parts) fill the block's 256 consumer threads."""
    for d, heads in COMPOSITE_WIDTHS:
        for n in (1, 2000, 8000, 16000):
            plan = tsb.sm90_plan(n, l, d, 2 * d, heads)
            assert plan is not None, (d, heads, n, l)
            dh = d // heads
            assert plan.group % dh == 0 and d % plan.group == 0
            assert 4 % (plan.group // dh) == 0
    for d, heads in TINY_WIDTHS:
        assert tsb.sm90_plan(2000, l, d, 2 * d, heads) is None


def test_k8_plans_at_the_main_path_widths():
    """The plans the main paths run and the kernel's shared-memory layout at
    the 4AA 16 x 24 split: a 64 x 384 x tile (48 KB), five w1 stages of 96
    rows by 64 columns (12 KB each), three w2 stages of 384 rows by 32
    columns (24 KB each), the staging area of q, k and v of a 96-column head
    group (36 KB), 256 bytes of mbarriers and 1 KB of alignment slack."""
    assert tsb.sm90_plan(8000, 2, 384, 768, 16) == (64, 96, 192, 5, 3, 222464)
    assert tsb.sm90_plan(8000, 2, 384, 768, 3) == (64, 128, 256, 3, 3, 222464)
    assert tsb.sm90_plan(2000, 3, 256, 512, 16) == (63, 64, 128, 6, 3, 156928)
    assert tsb.sm90_plan(2000, 7, 128, 256, 4) == (63, 64, 128, 6, 3, 115968)
    assert tsb.sm90_smem_bytes(384, 96, 5, 3) == (49152 + 5 * 12288 + 3 * 24576 + 36864
                                                  + 256 + 1024)


def test_cpu_calls_count_no_launch(monkeypatch):
    """On CPU tensors fused_spatial_block takes reference_spatial_block and
    counts nothing, at a Hopper width and at a WMMA width."""
    for name in ("launches", "wmma_launches"):
        monkeypatch.setattr(tsb, name, 0)
    rng = np.random.default_rng(0)
    for d, heads in ((128, 4), (32, 4)):
        m, dh = 2 * d, d // heads
        t = lambda *shape, s=1.0: torch.from_numpy(  # noqa: E731
            (rng.standard_normal(shape) * s).astype(np.float32)).to(torch.bfloat16)
        args = (t(5, 3, d), t(3 * d + m, d, s=0.1), t(3 * d + m), torch.ones(dh),
                torch.ones(dh), t(d, d + m, s=0.1), t(d), *rope_cos_sin(3, dh), heads,
                dh ** -0.5)
        got = tsb.fused_spatial_block(*args)
        torch.testing.assert_close(got, tsb.reference_spatial_block(*args), atol=0, rtol=0)
    assert (tsb.launches, tsb.wmma_launches) == (0, 0)


# --------------------------------------------------------------- fp32 (K8-fp32)

def _check_f32_against_jax(monkeypatch, n, l, heads, dh, m, seed):
    """``reference_spatial_block`` in fp32 against the JAX kernel in interpret
    mode: max |got - want| within 1e-5 of max |want|."""
    monkeypatch.setattr(jsb, "FORCE_KERNEL", True)
    rng = np.random.default_rng(seed)
    d = heads * dh
    x = rng.standard_normal((n, l, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, 3 * d + m)) * d ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(3 * d + m) * 0.1).astype(np.float32)
    qs, ks = ((np.abs(rng.standard_normal(dh)) + 0.5).astype(np.float32) for _ in range(2))
    w2 = (rng.standard_normal((d + m, d)) * (d + m) ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    cos_l, sin_l = lane_rope_tables(*j_rope_cos_sin(l, dh), heads)
    want = np.asarray(jsb.fused_spatial_block(
        jnp.asarray(x), *(jnp.asarray(a) for a in (w1, b1, qs, ks, w2, b2)), cos_l, sin_l,
        heads))
    t = torch.from_numpy
    got = tsb.reference_spatial_block(t(x), t(w1.T.copy()), t(b1), t(qs), t(ks), t(w2.T.copy()),
                                      t(b2), *rope_cos_sin(l, dh), heads, dh ** -0.5)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= F32_RTOL * np.abs(want).max()


F32_RTOL = 1e-5
# the 4AA splits at narrow widths: many heads of dh 24, one head of dh 128
F32_SPLITS = [(4, 24), (1, 128)]


@pytest.mark.parametrize("l", [1, 2, 3, 8])
@pytest.mark.parametrize("heads,dh", F32_SPLITS)
def test_k8_f32_plain_matches_jax(monkeypatch, l, heads, dh):
    """Frames on both sides of the fp32 kernel's 32-row blocks (32 // L
    frames each) and one more."""
    _check_f32_against_jax(monkeypatch, 2 * (32 // l) + 1, l, heads, dh, 2 * heads * dh,
                           seed=100 * l + dh)


def _f32_tiled_rule(d: int, m: int, heads: int):
    """(head group, rows a block) of the outer-product route at this width,
    or None where it has no instance: D 384 with M a multiple of 384 and the
    fp32 group (at most 128 columns) of 96 or 128 columns, 32-row blocks;
    D 256 with M a multiple of 256 and a head dim of at most 64, head groups
    of 64 columns and 64-row blocks; D 128 with M a multiple of 128, the fp32
    group (128 columns at every split) and 32-row blocks."""
    group, dh = tsb.f32_group(d, heads), d // heads
    if d == 384 and m % 384 == 0 and group in (96, 128):
        return group, 32
    if d == 256 and m % 256 == 0 and dh <= 64:
        return 64, 64
    if d == 128 and m % 128 == 0:
        return group, 32
    return None


def _f32_tiled_smem(d: int, group: int, rows: int) -> int:
    """x^T [d][rows + 4], S^T [ps][rows + 4] and two ring stages [32][ps],
    ps the wider pass (3 group or d columns), fp32, and two mbarriers."""
    ps = max(3 * group, d)
    return 4 * ((d + ps) * (rows + 4) + 2 * 32 * ps) + 16


def test_k8_f32_plan_over_every_width_the_checks_accept():
    """``f32_plan`` over D, M multiples of 16 (D up to 1024) and every even
    head dim: a plan exists exactly where a head group exists and, on the
    dot-product route, shared memory fits; its group holds whole heads, is a
    multiple of 4 dividing D and at most 128 columns unless one head is
    wider; the outer-product route takes the widths it has instances of
    (``_f32_tiled_rule``) at their group and block, and the dot-product
    route the rest at the fp32 group and 32-row blocks."""
    for d in range(16, 1025, 16):
        for heads in (h for h in range(1, d // 2 + 1) if d % h == 0 and (d // h) % 2 == 0):
            dh = d // heads
            for m in (16, 2 * d):
                for l in (1, 3, 8):
                    plan = tsb.f32_plan(1000, l, d, m, heads)
                    group = tsb.f32_group(d, heads)
                    tiled = None if group is None else _f32_tiled_rule(d, m, heads)
                    fits = group is not None and (
                        tiled is not None or tsb.f32_smem_bytes(d, group) <= SMEM_MAX)
                    assert (plan is None) == (not fits), (d, heads, m, l)
                    if plan is None:
                        continue
                    assert plan.group % dh == 0 and d % plan.group == 0 and plan.group % 4 == 0
                    assert plan.group <= 128 or plan.group == dh
                    assert plan.route == ("dot" if tiled is None else "tiled"), (d, heads, m)
                    want_group, rows = (group, 32) if tiled is None else tiled
                    assert (plan.group, plan.rows) == (want_group, rows)
                    smem = (tsb.f32_smem_bytes(d, group) if tiled is None
                            else _f32_tiled_smem(d, *tiled))
                    assert plan.smem == smem <= SMEM_MAX
                    assert plan.blocks == -(-1000 // (rows // l))


@pytest.mark.parametrize("l", range(1, 9))
def test_k8_f32_plans_at_the_checked_widths(l):
    """The 4AA widths at both splits and the other composite and tiny widths
    the card's checks run have an fp32 plan at every L. The composite widths
    take the outer-product kernel: at 4AA 32-row blocks, shared memory x^T
    and S^T of 384 x 36 floats and two ring stages of 32 x 384; at NBA
    64-row blocks, head groups of 64 and x^T and S^T of 256 x 68 floats with
    stages of 32 x 256; at the pedestrian width 32-row blocks, head groups
    of 128 (an attention pass of 384 columns, three times D) and S^T and
    the stages 384 columns wide. The tiny widths take the dot-product kernel,
    whose 256.0 KB at D 512 do not fit."""
    for d, heads in COMPOSITE_WIDTHS + TINY_WIDTHS:
        plan = tsb.f32_plan(2000, l, d, 2 * d, heads)
        assert plan is not None, (d, heads)
        assert plan.route == ("tiled" if d >= 128 else "dot"), (d, heads)
    blocks = -(-8000 // (32 // l))
    smem = 4 * (2 * 384 * 36 + 2 * 32 * 384) + 16  # and two mbarriers
    assert tsb.f32_plan(8000, l, 384, 768, 16) == (96, smem, "tiled", blocks, 32)
    assert tsb.f32_plan(8000, l, 384, 768, 3) == (128, smem, "tiled", blocks, 32)
    assert tsb.f32_plan(8000, l, 256, 512, 16) == (
        64, 4 * (2 * 256 * 68 + 2 * 32 * 256) + 16, "tiled", -(-8000 // (64 // l)), 64)
    assert tsb.f32_plan(8000, l, 128, 256, 4) == (
        128, 4 * ((128 + 384) * 36 + 2 * 32 * 384) + 16, "tiled", blocks, 32)
    assert tsb.f32_plan(8000, l, 256, 512, 2) == (  # dh 128: no instance
        128, 4 * (32 * 260 + 32 * 388 + 2 * 256 * 36), "dot", blocks, 32)
    assert tsb.f32_plan(8000, l, 512, 1024, 8) is None  # 265 KB


def test_cpu_fp32_call_takes_the_plain_version(monkeypatch):
    """An all-fp32 CPU call (and one that needs a gradient) takes
    reference_spatial_block and counts no launch of any route."""
    for name in ("launches", "wmma_launches", "f32_launches", "f32_tiled_launches",
                 "f32_dot_launches"):
        monkeypatch.setattr(tsb, name, 0)
    rng = np.random.default_rng(1)
    d, heads, m = 96, 4, 192
    dh = d // heads
    t = lambda *shape, s=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * s).astype(np.float32))
    args = [t(7, 2, d), t(3 * d + m, d, s=0.1), t(3 * d + m), torch.ones(dh), torch.ones(dh),
            t(d, d + m, s=0.1), t(d), *rope_cos_sin(2, dh), heads, dh ** -0.5]
    got = tsb.fused_spatial_block(*args)
    torch.testing.assert_close(got, tsb.reference_spatial_block(*args), atol=0, rtol=0)
    args[0].requires_grad_(True)
    tsb.fused_spatial_block(*args).sum().backward()
    assert args[0].grad is not None
    assert (tsb.launches, tsb.wmma_launches, tsb.f32_launches, tsb.f32_tiled_launches,
            tsb.f32_dot_launches) == (0, 0, 0, 0, 0)
