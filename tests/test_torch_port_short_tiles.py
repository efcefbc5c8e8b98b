"""The plain versions behind the redesigned K9 (forward and backward) and
K11, on the CPU.

``csrc/short_attention.cu``'s K9 runs a warp per head on mma.sync tiles:
the forward over 16-query by 32-key blocks (the scores of one key block
kept in registers for n <= 32, computed twice past it), the backward in one
pass for n <= 32 and three for longer n; ``csrc/short_backward.cu`` (K11)
runs a warpgroup per 64 keys over 64-query chunks. On the card each is held
to its plain version, ``reference_short_attention``,
``reference_short_backward`` and ``reference_flash_backward_short``. Here
those plain versions are held to the JAX kernels at the new tile edges:
K9's against ``_short_fwd`` and ``_short_bwd`` (their Pallas kernels in
interpret mode) at n on both sides of 16, 32 and 64 and at dh 16, 24
(padded to 32) and 64; K11's against ``_flash_backward_short`` at query and
key lengths on both sides of 64, 128 and 192, with Nq != Nk. Also the K9
wrapper's head-group choosers, forward and backward, over the whole domain
its checks accept, and that CPU calls count no launch.

Inputs are made with numpy from a seed; fp32 on both sides, so only the
order of fp32 sums differs: 2e-5 of the largest value (K9) and JAX's own
K11 limits (rtol 1e-4, atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops.ablations.short_backward import _flash_backward_short
from lam_slide_tpu.ops.short_attention import _short_bwd, _short_fwd
from lam_slide_tpu_torch.ops import short_attention as tsa
from lam_slide_tpu_torch.ops.ablations import short_backward as tsb

K9_REL_TOL = 2e-5
K11_RTOL, K11_ATOL = 1e-4, 1e-5
K9_LENGTHS = [9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127]
K9_HEAD_DIMS = [16, 24, 64]
K11_EDGES = [1, 63, 64, 65, 128, 191, 192, 193, 256]
# every length as queries once against itself and once against the next
# edge round the list as keys (Nq != Nk)
K11_PAIRS = ([(n, n) for n in K11_EDGES]
             + [(n, K11_EDGES[(i + 1) % len(K11_EDGES)]) for i, n in enumerate(K11_EDGES)])
SMEM_MAX = 232448  # 227 KB: the most dynamic shared memory an H100 block takes


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("dh", K9_HEAD_DIMS)
@pytest.mark.parametrize("n", K9_LENGTHS)
def test_k9_plain_backward_matches_jax_at_tile_edges(n, dh):
    heads, b = 2, 2
    rng = np.random.default_rng(n * 97 + dh)
    q, k, v, g = (_randn(rng, b, n, heads * dh) for _ in range(4))
    scale = dh ** -0.5

    def head_major(a):  # packed [B, n, H*dh] -> [B*H*n, dh]
        return jnp.asarray(a.reshape(b, n, heads, dh).transpose(0, 2, 1, 3).reshape(-1, dh))

    want = _short_bwd(*(head_major(a) for a in (q, k, v, g)), n, scale)
    got = tsa.reference_short_backward(_t(q), _t(k), _t(v), _t(g), heads, scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w).reshape(b, heads, n, dh).transpose(0, 2, 1, 3).reshape(b, n, -1)
        assert a.shape == w.shape and a.dtype == torch.float32
        err = np.abs(a.numpy() - w).max()
        assert err <= K9_REL_TOL * np.abs(w).max(), f"{name}: max err {err}"


@pytest.mark.parametrize("dh", K9_HEAD_DIMS)
@pytest.mark.parametrize("n", K9_LENGTHS)
def test_k9_plain_forward_matches_jax_at_tile_edges(n, dh):
    heads, b = 3, 2
    rng = np.random.default_rng(n * 131 + dh)
    q, k, v = (_randn(rng, b, n, heads * dh) for _ in range(3))
    scale = dh ** -0.5

    def head_major(a):  # packed [B, n, H*dh] -> [B*H*n, dh]
        return jnp.asarray(a.reshape(b, n, heads, dh).transpose(0, 2, 1, 3).reshape(-1, dh))

    want = _short_fwd(*(head_major(a) for a in (q, k, v)), n, scale)
    want = np.asarray(want).reshape(b, heads, n, dh).transpose(0, 2, 1, 3).reshape(b, n, -1)
    got = tsa.reference_short_attention(_t(q), _t(k), _t(v), heads, scale)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    assert err <= K9_REL_TOL * np.abs(want).max(), f"max err {err}"


@pytest.mark.parametrize("dh", [8, 16, 24, 32, 64])
def test_k9_forward_head_groups_fit_every_length_the_checks_accept(dh):
    """Every n in 9..127 and head count 1..32: the forward's group is 1..8
    heads and no more than there are, its shared memory fits the block's 227
    KB, and the groups are as even as the head count allows while they
    fit."""
    for n in range(9, 128):
        for heads in range(1, 33):
            hb = tsa.fwd_heads_per_block(n, heads, dh)
            assert 1 <= hb <= min(heads, tsa.FWD_MAX_HEADS)
            assert tsa.fwd_smem_bytes(n, dh, hb) <= SMEM_MAX
            groups = -(-heads // tsa.FWD_MAX_HEADS)
            even = -(-heads // groups)
            if tsa.fwd_smem_bytes(n, dh, even) <= SMEM_MAX:
                assert hb == even


def test_k9_forward_shared_memory_follows_the_kernel_layout():
    """Seven bf16 tiles (two stages of q/k/v, the output) of n rounded up to
    32 rows by hb * (dh padded to 16, 32 or 64) + 8 columns. The MD17
    temporal axis (n 30, 16 heads of 16) takes groups of 8 in 61 KB, three
    blocks an SM; dh 64 at n 127 fits one head a block."""
    assert tsa.fwd_heads_per_block(30, 16, 16) == 8
    assert tsa.fwd_smem_bytes(30, 16, 8) == 7 * 32 * (8 * 16 + 8) * 2 == 60928
    assert tsa.fwd_smem_bytes(33, 24, 3) == 7 * 64 * (3 * 32 + 8) * 2
    assert tsa.fwd_heads_per_block(127, 8, 64) == 1
    assert tsa.fwd_smem_bytes(127, 64, 1) == 7 * 128 * 72 * 2


def _softmax_stats(q, k, v, scale):
    """The forward's output and per-row log-sum-exp, in float64."""
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    m = s.max(-1, keepdims=True)
    lse = m[..., 0] + np.log(np.exp(s - m).sum(-1))
    out = np.einsum("bhqk,bhkd->bhqd", np.exp(s - lse[..., None]), v.astype(np.float64))
    return out.astype(np.float32), lse.astype(np.float32)


@pytest.mark.parametrize("nq,nk", K11_PAIRS, ids=[f"{a}x{b}" for a, b in K11_PAIRS])
def test_k11_plain_backward_matches_jax_at_tile_edges(nq, nk):
    b, h, dh = 1, 3, 16
    rng = np.random.default_rng(nq * 263 + nk)
    q, g = (_randn(rng, b, h, nq, dh) for _ in range(2))
    k, v = (_randn(rng, b, h, nk, dh) for _ in range(2))
    scale = dh ** -0.5
    out, lse = _softmax_stats(q, k, v, scale)
    want = _flash_backward_short(*(jnp.asarray(a) for a in (q, k, v, out, lse, g)), scale,
                                 group=2)
    got = tsb.reference_flash_backward_short(*(_t(a) for a in (q, k, v, out, lse, g)), scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=K11_RTOL, atol=K11_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("dh", [8, 16, 24, 32, 64])
def test_k9_head_groups_fit_every_length_the_checks_accept(dh):
    """Every n in 9..127 and head count 1..32: the chosen group is 1..8 heads
    and no more than there are, its shared memory fits the block's 227 KB
    (the kernel refuses more), and the groups are as even as the head count
    allows while they fit."""
    for n in range(9, 128):
        for heads in range(1, 33):
            hb = tsa.bwd_heads_per_block(n, heads, dh)
            assert 1 <= hb <= min(heads, tsa.BWD_MAX_HEADS)
            assert tsa.bwd_smem_bytes(n, dh, hb) <= SMEM_MAX
            groups = -(-heads // tsa.BWD_MAX_HEADS)
            even = -(-heads // groups)
            if tsa.bwd_smem_bytes(n, dh, even) <= SMEM_MAX:
                assert hb == even


def test_k9_shared_memory_follows_the_kernel_layout():
    """Eleven bf16 tiles of n rounded up to 32 rows by hb * (dh padded to
    16, 32 or 64) + 8 columns; past 32 rows three fp32 statistics a row and
    head. The MD17 temporal axis (n 30, 16 heads of 16) takes groups of 8."""
    assert tsa.bwd_heads_per_block(30, 16, 16) == 8
    assert tsa.bwd_smem_bytes(30, 16, 8) == 11 * 32 * (8 * 16 + 8) * 2
    assert tsa.bwd_smem_bytes(33, 24, 3) == 11 * 64 * (3 * 32 + 8) * 2 + 3 * 3 * 64 * 4
    assert tsa.bwd_smem_bytes(127, 64, 1) == 11 * 128 * 72 * 2 + 3 * 128 * 4


def test_cpu_calls_count_no_launch(monkeypatch):
    """On CPU tensors K9's forward and both backwards take their plain
    versions and count nothing."""
    monkeypatch.setattr(tsa, "launches", 0)
    monkeypatch.setattr(tsa, "bwd_launches", 0)
    monkeypatch.setattr(tsb, "launches", 0)
    rng = np.random.default_rng(0)
    q, k, v, g = (_t(_randn(rng, 2, 30, 32)).to(torch.bfloat16) for _ in range(4))
    tsa.short_attention(q, k, v, 2)
    tsa.short_attention_backward(q, k, v, g, 2, 0.25)
    hq, hk, hv, hg = (_t(_randn(rng, 2, 2, 65, 16)).to(torch.bfloat16) for _ in range(4))
    out, lse = _softmax_stats(*(t.float().numpy() for t in (hq, hk, hv)), 0.25)
    tsb.flash_backward_short(hq, hk, hv, _t(out).to(torch.bfloat16), _t(lse), hg, 0.25)
    assert (tsa.launches, tsa.bwd_launches, tsb.launches) == (0, 0, 0)


# The fp32 forward (csrc/short_attention_f32.cu): a block an item of one
# batch row's heads, a thread two query rows of a head (one past n 64), the
# item's q/k/v in shared memory padded to a multiple of 4 columns.
F32_LENGTHS = [9, 31, 32, 33, 63, 64, 65, 95, 96, 97, 127]
F32_HEAD_DIMS = [8, 16, 24, 32, 64]
F32_REL_TOL = 1e-5


@pytest.mark.parametrize("dh", F32_HEAD_DIMS)
@pytest.mark.parametrize("n", F32_LENGTHS)
def test_k9_fp32_plain_forward_matches_jax_at_the_fp32_kernels_edges(n, dh):
    """``reference_short_attention`` in fp32 against ``_short_fwd`` (its
    Pallas kernel in interpret mode) at n on both sides of each 32-row lane
    round and dh on both sides of each column padding, within 1e-5 of the
    largest output."""
    heads, b = 2, 2
    rng = np.random.default_rng(n * 211 + dh)
    q, k, v = (_randn(rng, b, n, heads * dh) for _ in range(3))
    scale = dh ** -0.5

    def head_major(a):  # packed [B, n, H*dh] -> [B*H*n, dh]
        return jnp.asarray(a.reshape(b, n, heads, dh).transpose(0, 2, 1, 3).reshape(-1, dh))

    want = _short_fwd(*(head_major(a) for a in (q, k, v)), n, scale)
    want = np.asarray(want).reshape(b, heads, n, dh).transpose(0, 2, 1, 3).reshape(b, n, -1)
    got = tsa.reference_short_attention(_t(q), _t(k), _t(v), heads, scale)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= F32_REL_TOL * np.abs(want).max()


def test_k9_fp32_forward_warps_fit_every_length_the_checks_accept():
    """Every n in 9..127 and dh in 1..64 at 16 heads: the fp32 forward's plan
    (``f32_fwd_plan``, which replaced the warps-a-block count) takes 1..16
    heads an item in at most 256 threads, a multiple of 32 and enough for a
    thread per (head, row group) (two query rows a thread at n <= 64, one
    past it), its q, k and v within the block's 227 KB. MD17's temporal
    axis (n 30, 16 x dh 16) takes 4 heads in 64 threads and 24,480 bytes;
    n 127 at dh 64 one head in 128 threads."""
    for n in range(9, 128):
        for dh in range(1, 65):
            plan = tsa.f32_fwd_plan(n, dh, 16)
            assert 1 <= plan.heads <= 16
            assert plan.threads % 32 == 0 and plan.threads <= tsa.F32_MAX_THREADS
            assert plan.threads >= plan.heads * -(-n // (2 if n <= 64 else 1))
            assert plan.smem_bytes <= SMEM_MAX
    assert tsa.f32_fwd_plan(30, 16, 16) == (4, 64, 24480)
    assert tsa.f32_fwd_plan(127, 64, 16)[:2] == (1, 128)
