"""The plain versions behind the redesigned Hopper flash kernels, on the CPU.

``csrc/flash_fwd_sm90.cu`` (K1 and its packed entry K3) and
``csrc/flash_bwd_sm90.cu`` (K4) are held on the card to
``reference_attention`` and ``reference_flash_backward``. Here those plain
versions are held to the JAX kernels (``_flash_forward`` with the lse and
``_flash_backward``, their Pallas kernels in interpret mode) at the new
kernels' tile edges: 64-row query and key tiles, so sequences of 1, 63, 65,
192 and 257, at the head dims the kernels pad (16 to 16, 20 and 24 to 24).
Also the wrapper's choice between the TMA and the cp.async route
(``sm90_tma_ok``).

Inputs are made with numpy from a seed; fp32 on both sides, only the order
of fp32 sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lam_slide_tpu.ops import flash_attention as jfa
from lam_slide_tpu_torch.ops import flash_attention as tfa

# fp32 through one attention or its backward: sums in another order (XLA on
# the JAX side); values are O(1).
TOL = 2e-5
# JAX blocks: one block up to 128 rows, 128-row blocks beyond (its rule).
JAX_BLOCK = 128
EDGES = [1, 63, 65, 192, 257]
HEAD_DIMS = [16, 20, 24]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL, err_msg=err_msg)


def _inputs(seed, n, dh, b=2, h=2, nk=None):
    rng = np.random.default_rng(seed)
    nk = n if nk is None else nk
    return (_randn(rng, b, h, n, dh), _randn(rng, b, h, nk, dh), _randn(rng, b, h, nk, dh),
            _randn(rng, b, h, n, dh))


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("n", EDGES)
def test_plain_forward_and_lse_match_jax_at_tile_edges(n, dh):
    q, k, v, _ = _inputs(n * 131 + dh, n, dh)
    scale = dh ** -0.5
    out, lse = jfa._flash_forward(*(jnp.asarray(a) for a in (q, k, v)), None, scale,
                                  block_q=JAX_BLOCK, block_k=JAX_BLOCK, with_lse=True)
    got_out, got_lse = tfa.reference_attention(_t(q), _t(k), _t(v), scale, return_lse=True)
    _close(got_out, out, "out")
    _close(got_lse, lse, "lse")


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("n", EDGES)
def test_plain_backward_matches_jax_at_tile_edges(n, dh):
    """Queries and keys of different lengths, so a key tile and a query tile
    are ragged at different places."""
    nk = {1: 2, 63: 65, 65: 63, 192: 192, 257: 130}[n]
    q, k, v, g = _inputs(n * 137 + dh, n, dh, nk=nk)
    scale = dh ** -0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jfa._flash_forward(jq, jk, jv, None, scale, block_q=JAX_BLOCK,
                                  block_k=JAX_BLOCK, with_lse=True)
    want = jfa._flash_backward(jq, jk, jv, None, out, lse, jg, scale, block_q=JAX_BLOCK,
                               block_k=JAX_BLOCK)
    got = tfa.reference_flash_backward(_t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape
        _close(a, w, name)


def _packed_views(b, n, h, dh, offset=0):
    buf = torch.zeros(b, n, 3 * h * dh + offset, dtype=torch.bfloat16)
    return [t.transpose(1, 2) for t in buf[..., offset:].unflatten(-1, (3, h, dh)).unbind(2)]


@pytest.mark.parametrize("case,want", [
    ("contiguous dh 24", True),
    ("contiguous dh 16 odd n", True),
    ("packed views dh 24", True),
    ("packed views dh 16", True),
    ("dh 20", False),
    ("dh 8 odd heads", True),
    ("view offset by one element", False),
    ("view offset by four elements", False),
    ("view offset by eight elements", True),
    ("seq stride of 12 elements", False),
    ("length-1 axes with odd strides", True),
    ("odd head stride", False),
])
def test_tma_route_predicate(case, want):
    """TMA takes dh % 8 == 0 with every base address and every stride of an
    axis longer than 1 a multiple of 16 bytes; anything else goes to the
    cp.async route of the same kernels."""
    bf = dict(dtype=torch.bfloat16)
    if case == "contiguous dh 24":
        ts = [torch.zeros(2, 16, 1000, 24, **bf) for _ in range(3)]
    elif case == "contiguous dh 16 odd n":
        ts = [torch.zeros(3, 2, 63, 16, **bf) for _ in range(3)]
    elif case == "packed views dh 24":
        ts = _packed_views(2, 1000, 16, 24)
    elif case == "packed views dh 16":
        ts = _packed_views(2, 192, 16, 16)
    elif case == "dh 20":
        ts = [torch.zeros(2, 3, 130, 20, **bf) for _ in range(3)]
    elif case == "dh 8 odd heads":
        ts = [torch.zeros(2, 3, 130, 8, **bf) for _ in range(3)]
    elif case.startswith("view offset by"):
        off = {"one": 1, "four": 4, "eight": 8}[case.split()[3]]
        ts = _packed_views(2, 130, 3, 24, offset=off)
    elif case == "seq stride of 12 elements":
        ts = [torch.zeros(2, 3, 130, 12, **bf)[..., :8] for _ in range(3)]
    elif case == "length-1 axes with odd strides":
        base = torch.zeros(4096, **bf)
        ts = [base.as_strided((1, 1, 64, 16), (3, 5, 16, 1)) for _ in range(3)]
    else:  # heads 36 elements (72 bytes) apart, rows 368 apart, dh 24
        base = torch.zeros(2 * 130 * 368, **bf)
        ts = [base.as_strided((2, 3, 130, 24), (130 * 368, 36, 368, 1)) for _ in range(3)]
    assert all(t.stride(-1) == 1 for t in ts)
    assert tfa.sm90_tma_ok(*ts) is want


def test_tma_route_needs_every_operand():
    """One misaligned operand (dO of the backward) sends the call to cp.async."""
    q, k, v = _packed_views(2, 130, 3, 24)
    g = torch.zeros(2, 3, 130, 25, dtype=torch.bfloat16)[..., 1:]
    assert tfa.sm90_tma_ok(q, k, v)
    assert not tfa.sm90_tma_ok(q, k, v, g)


def test_cpu_calls_count_no_redesigned_launch(monkeypatch):
    """On CPU tensors the wrappers take the plain versions and the new
    counters stay at zero."""
    for name in ("sm90_launches", "sm90_cp_async_launches", "bwd_sm90_launches",
                 "bwd_sm90_cp_async_launches"):
        monkeypatch.setattr(tfa, name, 0)
    q, k, v, g = (_t(a).to(torch.bfloat16) for a in _inputs(0, 65, 24))
    out, lse = tfa.reference_attention(q, k, v, 0.2, return_lse=True)
    tfa.flash_attention(q, k, v, scale=0.2)
    tfa.flash_attention_backward(q, k, v, out, lse, g, 0.2)
    assert (tfa.sm90_launches, tfa.sm90_cp_async_launches, tfa.bwd_sm90_launches,
            tfa.bwd_sm90_cp_async_launches) == (0, 0, 0, 0)
