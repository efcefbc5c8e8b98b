"""The plain version behind K8-fp32's outer-product kernel, and its plan, on
the CPU.

``csrc/fused_spatial_block_f32.cu``'s outer-product kernel takes K8 in fp32
at the 4AA DiT's widths (D 384 at 16 x 24 and 3 x 128, M 768): blocks of 32
rows (32 // L whole frames), x^T resident, linear1 in passes of a head
group's q, k and v columns (288 or 384) and of 384 MLP columns, a thread a
4 x 12 block of the output; and at the NBA (D 256 at 16 x 16, M 512) and
pedestrian (D 128 at 4 x 32, M 256) DiTs' widths: head groups of 64 and
128 columns (attention passes of 192 and 384 columns), MLP passes of D
columns, blocks of 64 rows (NBA) and 32 rows (pedestrian). On the card it is held to
``reference_spatial_block`` (and to the dot-product route, bit for bit);
here that plain version is held to the JAX kernel (``fused_spatial_block``
with ``FORCE_KERNEL``, its Pallas kernel in interpret mode) on inputs made
with numpy from a seed:

* rows N * L on both sides of the 32-row blocks and of two of them (31/32/
  33, 63/64/65) at every L in 1..8, at 16 x 24 and 3 x 128;
* the eval's 4,000 rows and the sampling's 16,000 at L = 2;
* the other composite widths (NBA and pedestrian) and the tiny registries'
  widths (the dot-product route);
* frames on both sides of the NBA and pedestrian blocks at L = 8 and 2.

Also ``f32_plan`` over every width ``_check`` accepts: the route, the
group, the shared memory and the blocks, the 4AA plans at 4,000 rows and
the NBA and pedestrian plans at their test passes' rows; and the w1 stream
at the NBA and pedestrian widths.

Tolerance: fp32 on both sides, so only the order of the sums (and the JAX
kernel's polynomial erf, 1.5e-7) differs: 2e-5 of the largest output.
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

TOL = 2e-5
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes
SPLITS = [(16, 24), (3, 128)]  # the 4AA DiT's head splits of D 384
# (hidden, heads) of the other composites and of the tiny registries
OTHER_WIDTHS = [(256, 16), (128, 4), (16, 2), (32, 8)]


def _check(monkeypatch, n, l, heads, dh, m, seed):
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
    want = np.asarray(jsb.fused_spatial_block(
        jnp.asarray(x), *(jnp.asarray(a) for a in (w1, b1, qs, ks, w2, b2)), cos_l, sin_l,
        heads))
    t = torch.from_numpy
    got = tsb.reference_spatial_block(t(x), t(w1.T.copy()), t(b1), t(qs), t(ks), t(w2.T.copy()),
                                      t(b2), *rope_cos_sin(l, dh), heads, dh ** -0.5)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


# (L, N): N = ceil(rows / L) frames for N * L rows at 31/32/33 and 63/64/65,
# on both sides of one and two 32-row blocks (32 // L * L of whose rows are
# used), each N once
EDGE_FRAMES = sorted({(l, -(-rows // l)) for l in range(1, 9)
                      for rows in (31, 32, 33, 63, 64, 65)})


@pytest.mark.parametrize("l,n", EDGE_FRAMES)
@pytest.mark.parametrize("heads,dh", SPLITS)
def test_k8_f32_plain_matches_jax_at_the_row_blocks_edges(monkeypatch, heads, dh, l, n):
    _check(monkeypatch, n, l, heads, dh, 768, seed=1000 * l + 10 * n + heads)


@pytest.mark.parametrize("rows", [4000, 16000])
@pytest.mark.parametrize("heads,dh", SPLITS)
def test_k8_f32_plain_matches_jax_at_the_eval_rows(monkeypatch, heads, dh, rows):
    _check(monkeypatch, rows // 2, 2, heads, dh, 768, seed=rows + heads)


@pytest.mark.parametrize("l", [1, 2, 5, 8])
@pytest.mark.parametrize("d,heads", OTHER_WIDTHS)
def test_k8_f32_plain_matches_jax_at_the_other_widths(monkeypatch, d, heads, l):
    _check(monkeypatch, 33, l, heads, d // heads, 2 * d, seed=d * 10 + heads + l)


def test_k8_f32_plan_routes_over_every_width_the_checks_accept():
    """Every D, M multiple of 16 (D up to 1024, M 16 and 2D) and even head
    dim at L 1, 2 and 8: the outer-product route exactly where D is 384, M a
    multiple of 384 and the head group 96 or 128 columns, or D is 256, M a
    multiple of 256 and the head dim at most 64 (then head groups of 64,
    64-row blocks), or D is 128 and M a multiple of 128 (its own shared
    memory each), else the dot-product route where that fits; the blocks
    hold rows // L frames each."""
    for d in range(16, 1025, 16):
        for heads in (h for h in range(1, d // 2 + 1) if d % h == 0 and (d // h) % 2 == 0):
            group, dh = tsb.f32_group(d, heads), d // heads
            for m in (16, 2 * d):
                tiled = ((d == 384 and m % 384 == 0 and group in (96, 128))
                         or (d == 256 and m % 256 == 0 and dh <= 64)
                         or (d == 128 and m % 128 == 0))
                for l in (1, 2, 8):
                    plan = tsb.f32_plan(4000, l, d, m, heads)
                    if plan is None:
                        assert group is None or (
                            not tiled and tsb.f32_smem_bytes(d, group) > SMEM_MAX)
                        continue
                    assert plan.route == ("tiled" if tiled else "dot")
                    assert plan.smem <= SMEM_MAX
                    assert plan.group == (64 if tiled and d == 256 else group)
                    assert plan.rows == (64 if tiled and d == 256 else 32)
                    assert plan.blocks == -(-4000 // (plan.rows // l))


@pytest.mark.parametrize("heads", [16, 3])
def test_k8_f32_plans_at_the_eval_rows(heads):
    """At the eval's 4,000 rows (2,000 frames of L = 2) the outer-product
    kernel runs 125 blocks of 32 rows: one wave on the H100's 132 SMs at one
    block an SM (its 204 KB of shared memory), all but 7 SMs busy (250
    blocks of 16 rows, each streaming all the weights, were 1.34x slower on
    an H100, tools/kernel_variants.py K8-fp32). At the sampling's 16,000 rows, 500 blocks; its ring holds a
    32-row slice of either weight."""
    plan = tsb.f32_plan(2000, 2, 384, 768, heads)
    assert plan.route == "tiled"
    assert plan.blocks == 125  # <= the H100's 132 SMs
    assert plan.smem == 4 * (2 * 384 * 36 + 2 * 32 * 384) + 16 == tsb.f32_tiled_smem_bytes(
        384, plan.group, 32)
    assert SMEM_MAX // plan.smem == 1
    assert tsb.f32_plan(8000, 2, 384, 768, heads).blocks == 500
    assert plan.group == (96 if heads == 16 else 128)


# (D, heads, M, L, frames of a test pass's repeat) of the NBA and pedestrian
# DiTs: B*T frames of L latents at the registries' B (1024, 256) and T = 20
PED_NBA = {"nba": (256, 16, 512, 8, 20480), "pedestrian": (128, 4, 256, 2, 5120)}


@pytest.mark.parametrize("workload", sorted(PED_NBA))
def test_k8_f32_plans_at_the_pedestrian_and_nba_widths(workload):
    """The NBA and pedestrian widths take the outer-product kernel at any
    L <= 8 and row count, one block within an H100 block's 227 KB. NBA: head
    groups of 64 columns (4 heads of 16), x^T and S^T of 256 x 68 floats,
    stages of 32 x 256, 204,816 bytes. Pedestrian: head groups of 128 (all
    4 heads of 32), an attention pass of 384 columns, three times D, so S^T
    and the stages are 384 columns wide, 172,048 bytes. The test pass: 2,560
    blocks of 64 rows at NBA, 320 of 32 at the pedestrian width."""
    d, heads, m, l_pass, frames = PED_NBA[workload]
    group, rows, smem = (64, 64, 204816) if d == 256 else (128, 32, 172048)
    for l in range(1, 9):
        for n in (1, 7, 33, frames):
            plan = tsb.f32_plan(n, l, d, m, heads)
            assert plan == (group, smem, "tiled", -(-n // (rows // l)), rows), (n, l)
    assert smem <= SMEM_MAX
    assert tsb.f32_plan(frames, l_pass, d, m, heads).blocks == (2560 if d == 256 else 320)


@pytest.mark.parametrize("workload", sorted(PED_NBA))
def test_k8_f32_w1_stream_at_the_pedestrian_and_nba_widths(workload):
    """The outer-product kernel's w1 stream at the NBA and pedestrian widths
    (attention passes of 192 and 384 columns, three times D at the
    pedestrian width; MLP passes of D): each w1 row appears in exactly one
    pass, in pass order (each head group's q, k and v columns, then the MLP
    columns in order), and each 32-row slice of a pass's [D][P] block is one
    contiguous run of the stream that holds w1[cols, k0 : k0 + 32]^T, also
    at a row stride wider than D."""
    d, heads, m, _, _ = PED_NBA[workload]
    group = tsb.f32_plan(100, 2, d, m, heads).group
    passes = tsb.f32_tiled_passes(d, m, group, d)
    assert [len(p) for p in passes] == [3 * group] * (d // group) + [d] * (m // d)
    assert sorted(c for p in passes for c in p) == list(range(3 * d + m))
    for g in range(d // group):
        assert passes[g] == [part * d + g * group + c for part in range(3)
                             for c in range(group)]
    assert [c for p in passes[d // group:] for c in p] == list(range(3 * d, 3 * d + m))
    rng = np.random.default_rng(d)
    for stride in (d, d + 4):
        w1 = torch.from_numpy(rng.standard_normal((3 * d + m, stride)).astype(np.float32))
        index = tsb._w1_stream_index(d, m, group, stride, torch.device("cpu"), d)
        stream = w1.flatten()[index]
        assert stream.shape == ((3 * d + m) * d,)
        off = 0
        for cols in passes:
            p = len(cols)
            for k0 in range(0, d, 32):
                run = stream[off + k0 * p: off + (k0 + 32) * p].view(32, p)
                assert torch.equal(run, w1[cols, k0:k0 + 32].t())
            off += d * p
        assert off == stream.numel()


# (heads, dh, L, frames): frames on both sides of the NBA block (64 rows: 8
# frames at L = 8, 32 at L = 2) and the pedestrian one (32 rows: 4 frames at
# L = 8, 16 at L = 2)
BLOCK_EDGES = [(16, 16, 8, 7), (16, 16, 8, 9), (16, 16, 2, 31), (16, 16, 2, 33),
               (4, 32, 8, 3), (4, 32, 8, 5), (4, 32, 2, 15), (4, 32, 2, 17)]


@pytest.mark.parametrize("heads,dh,l,n", BLOCK_EDGES)
def test_k8_f32_plain_matches_jax_at_the_pedestrian_and_nba_blocks_edges(monkeypatch, heads,
                                                                           dh, l, n):
    _check(monkeypatch, n, l, heads, dh, 2 * heads * dh, seed=7000 + 100 * dh + 10 * l + n)


def test_cpu_calls_count_no_launch(monkeypatch):
    """At the 4AA width an fp32 CPU call (and one that needs a gradient)
    takes reference_spatial_block and counts no launch of any route."""
    names = ("launches", "wmma_launches", "f32_launches", "f32_tiled_launches",
             "f32_dot_launches")
    for name in names:
        monkeypatch.setattr(tsb, name, 0)
    rng = np.random.default_rng(2)
    d, heads, m = 384, 16, 768
    dh = d // heads
    t = lambda *shape, s=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(shape) * s).astype(np.float32))
    args = [t(5, 2, d), t(3 * d + m, d, s=0.05), t(3 * d + m), torch.ones(dh), torch.ones(dh),
            t(d, d + m, s=0.05), t(d), *rope_cos_sin(2, dh), heads, dh ** -0.5]
    torch.testing.assert_close(tsb.fused_spatial_block(*args),
                               tsb.reference_spatial_block(*args), atol=0, rtol=0)
    args[0].requires_grad_(True)
    tsb.fused_spatial_block(*args).sum().backward()
    assert args[0].grad is not None
    assert [getattr(tsb, n) for n in names] == [0] * len(names)


@pytest.mark.parametrize("source,table", [("fused_spatial_block_f32.cu", "K8_F32_VARIANTS"),
                                          ("fused_mlp_f32.cu", "K2_F32_VARIANTS")])
def test_timing_variants_find_their_text(source, table):
    """tools/kernel_variants.py builds its K8-fp32 and K2-fp32 variants by
    text substitutions in the kernel's source: each finds its text the
    stated number of times (once unless stated), and each layout variant
    names a variant."""
    from lam_slide_tpu_torch.ops import _build
    from lam_slide_tpu_torch.tools import kernel_variants as kv

    text = (_build.CSRC / source).read_text()
    for name, subs in getattr(kv, table).items():
        for old, _, *count in subs:
            assert text.count(old) == (count[0] if count else 1), (name, old)
    assert set(kv.K8_F32_LAYOUT) <= set(kv.K8_F32_VARIANTS)
    assert set(kv.K2_F32_LAYOUT) <= set(kv.K2_F32_VARIANTS)
