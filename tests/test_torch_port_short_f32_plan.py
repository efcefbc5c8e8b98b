"""The plans and plain versions behind K9-fp32's redesigned kernels, on the
CPU.

``csrc/short_attention_f32.cu`` runs K9's fp32 forward and backward as
persistent blocks over items, an item one batch row's group of heads, its
rows staged whole in shared memory.
``f32_fwd_plan`` and ``f32_bwd_plan`` size them: here, over every n and dh
the wrapper's checks accept, their shared memory fits a block and every
block takes at least one item; at MD17's temporal axis the grid covers the
132 SMs. On the card each kernel is held to its plain version,
``reference_short_attention`` and ``reference_short_backward``; here those
are held to the JAX ``_short_fwd`` and ``_short_bwd`` (their Pallas kernels
in interpret mode) at the new tiles' edges: n on both sides of 32 and 64
and at the MD17 and 4AA smoke lengths, dh on both sides of the 4-column
padding steps, 1, 3 and 16 heads, v a strided column view of a wider
tensor. CPU calls count no launch.

Inputs are made with numpy from a seed; fp32 on both sides, so only the
order of fp32 sums differs: 2e-5 of the largest output, as
``test_torch_port_short.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops.short_attention import _short_bwd, _short_fwd
from lam_slide_tpu_torch.ops import short_attention as tsa

REL_TOL = 2e-5
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes
H100_SMS = 132
LENGTHS = [9, 16, 30, 31, 32, 33, 63, 64, 65, 127]
HEAD_DIMS = [8, 16, 24, 32, 48, 64]
HEAD_COUNTS = [1, 3, 16]
# (n, dh, heads): each length and head dim once, the head counts in turn
EDGES = [(n, dh, HEAD_COUNTS[(i + j) % len(HEAD_COUNTS)])
         for i, n in enumerate(LENGTHS) for j, dh in enumerate(HEAD_DIMS)]
MD17 = (30, 16, 16, 12288)  # n, dh, heads, batch rows: 64 x 192 sequences


def _inputs(n, dh, heads, seed, b=2):
    """q, k contiguous and v a column view of a wider array, packed
    [B, n, H*dh] fp32, and the output gradient."""
    rng = np.random.default_rng(seed)
    d = heads * dh
    q, k, g = (rng.standard_normal((b, n, d)).astype(np.float32) for _ in range(3))
    wide = rng.standard_normal((b, n, 3 * d)).astype(np.float32)
    return q, k, wide, wide[..., d:2 * d], g


def _head_major(a, heads):  # packed [B, n, H*dh] -> [B*H*n, dh]
    b, n, d = a.shape
    return jnp.asarray(a.reshape(b, n, heads, d // heads).transpose(0, 2, 1, 3).reshape(-1, d // heads))


def _packed(a, b, n, heads):  # [B*H*n, dh] -> packed [B, n, H*dh]
    return np.asarray(a).reshape(b, heads, n, -1).transpose(0, 2, 1, 3).reshape(b, n, -1)


def _assert_close(got, want, name):
    assert got.shape == want.shape and got.dtype == torch.float32, name
    err = np.abs(got.numpy() - want).max()
    assert err <= REL_TOL * np.abs(want).max(), f"{name}: max err {err} of {np.abs(want).max()}"


@pytest.mark.parametrize("n,dh,heads", EDGES)
def test_k9_fp32_plain_forward_matches_jax_at_the_new_tiles(n, dh, heads):
    q, k, wide, v, _ = _inputs(n, dh, heads, seed=n * 67 + dh)
    scale = dh ** -0.5
    want = _packed(_short_fwd(*(_head_major(a, heads) for a in (q, k, v)), n, scale), 2, n, heads)
    d = heads * dh
    tv = torch.from_numpy(wide)[..., d:2 * d]
    assert tv.stride(-1) == 1 and not tv.is_contiguous()
    got = tsa.reference_short_attention(torch.from_numpy(q), torch.from_numpy(k), tv, heads, scale)
    _assert_close(got, want, "out")


@pytest.mark.parametrize("n,dh,heads", EDGES)
def test_k9_fp32_plain_backward_matches_jax_at_the_new_tiles(n, dh, heads):
    q, k, wide, v, g = _inputs(n, dh, heads, seed=n * 71 + dh)
    scale = dh ** -0.5
    want = _short_bwd(*(_head_major(a, heads) for a in (q, k, v, g)), n, scale)
    d = heads * dh
    tv = torch.from_numpy(wide)[..., d:2 * d]
    got = tsa.reference_short_backward(torch.from_numpy(q), torch.from_numpy(k), tv,
                                       torch.from_numpy(g), heads, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close(a, _packed(w, 2, n, heads), name)


@pytest.mark.parametrize("heads", HEAD_COUNTS)
def test_k9_fp32_plans_fit_every_length_and_head_dim(heads):
    """Every n in 9..127 and dh in 1..64: both plans' shared memory fits a
    block's 227 KB; an item takes 1..heads heads; a block has a multiple of
    32 threads, at most 256, enough for the forward's (head, row group)
    pairs (two query rows a thread at n <= 64, one past it) and, two tiles a
    thread at most, the backward's 4 x 4 dK/dV tiles."""
    for n in range(9, 128):
        rows = 2 if n <= 64 else 1
        for dh in range(1, 65):
            fwd, bwd = tsa.f32_fwd_plan(n, dh, heads), tsa.f32_bwd_plan(n, dh, heads)
            for plan in (fwd, bwd):
                assert 1 <= plan.heads <= heads
                assert plan.threads % 32 == 0 and 32 <= plan.threads <= tsa.F32_MAX_THREADS
                assert plan.smem_bytes <= SMEM_MAX
            assert fwd.threads >= fwd.heads * -(-n // rows)
            tiles = bwd.heads * -(-n // 4) * -(-dh // 4)
            assert tiles <= tsa.F32_KV_TILES * bwd.threads


def test_k9_fp32_plans_follow_the_kernel_layouts_and_fill_the_card_at_md17():
    """At MD17's temporal axis (n 30, 16 x dh 16, B·H = 196,608): the
    forward takes 4 heads an item in 64 threads, q, k, v (30 rows of 4 * 16
    + 4 floats) in 24,480 bytes; the backward 2 heads in 64 threads, q, k,
    v, dO (32 rows of 2 * 16 floats, plus 4) and S and dP (32 rows of 36
    floats a head, plus 4) in 36,928 bytes; their items outnumber the 132
    SMs a hundred times over, so the persistent grid reaches every SM."""
    n, dh, heads, b = MD17
    fwd, bwd = tsa.f32_fwd_plan(n, dh, heads), tsa.f32_bwd_plan(n, dh, heads)
    assert fwd == tsa.F32ShortPlan(4, 64, 4 * 3 * 30 * (4 * 16 + 4))
    assert fwd.smem_bytes == 24480
    assert bwd == tsa.F32ShortPlan(2, 64, 4 * (4 * 32 * (32 + 4) + 2 * 2 * (32 * 36 + 4)))
    assert bwd.smem_bytes == 36928
    for plan in (fwd, bwd):
        assert b * -(-heads // plan.heads) >= 100 * H100_SMS
    # the 4AA smoke DiT (n 16, 4 x dh 8): one item a batch row, a warp
    assert tsa.f32_fwd_plan(16, 8, 4)[:2] == (4, 32)
    assert tsa.f32_bwd_plan(16, 8, 4)[:2] == (4, 32)
    # n 127 at dh 64: one head an item; the backward's S and dP in two
    # 64-row chunks, two dK/dV tiles a thread
    assert tsa.f32_bwd_plan(127, 64, 4)[:2] == (1, 256)


@pytest.mark.parametrize("n,dh,heads", [(30, 16, 16), (16, 8, 4), (127, 64, 3), (33, 5, 11)])
def test_k9_fp32_cpu_calls_count_no_launch(n, dh, heads):
    """CPU tensors take the plain versions, forward, backward and through
    autograd: no counter moves."""
    q, k, wide, _, g = (torch.from_numpy(a) for a in _inputs(n, dh, heads, seed=5))
    d = heads * dh
    v = wide[..., d:2 * d]
    before = (tsa.launches, tsa.fp32_launches, tsa.bwd_launches, tsa.bwd_fp32_launches)
    out = tsa.short_attention(q, k, v, heads)
    grads = tsa.short_attention_backward(q, k, v, g, heads, dh ** -0.5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tsa.short_attention(*leaves, heads).backward(g)
    assert (tsa.launches, tsa.fp32_launches, tsa.bwd_launches, tsa.bwd_fp32_launches) == before
    assert out.shape == q.shape and all(t.shape == q.shape for t in grads)
    for leaf, want in zip(leaves, grads):
        torch.testing.assert_close(leaf.grad, want, rtol=1e-5, atol=1e-6)
