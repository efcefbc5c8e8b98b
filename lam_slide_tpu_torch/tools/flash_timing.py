"""Time flash-attention calls of the main paths on the card (CUDA events).

The redesigned bf16 kernels at their main-path shapes: K1 at the 4AA
temporal axis [16, 16, 1000, 24] (Euler-10 at B=8), its packed entry K3 on
[16, 1000, 384] and on the MD17 protocol's spatial axis [9600, 192, 256],
and K4 at the 4AA train step [32, 16, 1000, 24] and the MD17 stage-2 step
[1920, 16, 192, 16], each from its forward's out and lse. Beside them the
kernels left on the older templates, which must keep their times: the MD17
protocol's fp32 K1 calls as ``evaluate_md17`` makes them (K1-fp32 on the
decoder's latent self-attention [9600, 2, 192, 16], K1-bias on the
encoder's masked cross-attention [1920, 8, 192 -> 32, 16]), K4 with the
bias and in fp32 at the MD17 stage-1 and stage-2 training shapes, and K10
at [16, 1000, 384]. K5 (the QK-norm + RoPE transform kernel, then the
redesigned forward) at the 3 x 128 Euler-10 B=8 solve's [16, 3, 1000, 128]
and, with the lse, at the train step's [32, 3, 1000, 128], and its backward
K6 (the transform, then the redesigned backward) there; the transform
kernel alone at [16, 3, 1000, 128], by events and by the profiler's device
time (a tree without it prints that it has none). Then K9 forward and
backward on the MD17 DiT's temporal axis, packed [B, 30, 256] (16 heads of
16, v a view of linear1's output) at the protocol batch's B = 61440 and the
stage-2 train step's B = 12288, and K11 at the MD17 spatial axis [1920, 16,
192, 16] (head-major views of one packed buffer, from K1's out and lse).
Then K2 (``fused_mlp``, the MLP slices of nn.Linear weights as the DiT
passes them) at its four main-path shapes: the 4AA Euler-10 solve at B=8
([16000, 384] -> 768) and train step ([32000, 384]), the MD17 protocol
batch ([1843200, 256] -> 512) and stage-2 step ([368640, 256]). Last, by
events and by the profiler's device time, K8 (``fused_spatial_block``) at
the 4AA solve's [2000, 2, 384] and [8000, 2, 384] at 16 x 24 and 3 x 128,
and K7 (``residual_adaln_modulate``, h the transposed temporal output) at
the 4AA B=8 solve's [8, 1000, 2, 384] and the MD17 protocol's [320, 30,
192, 256]. Last, the fp32 calls of the fp32 sampling DiTs (TF32 off):
K1-fp32 at dh 128 on head-major views of packed buffers (MD17's 2 x 128
axes [1920, 2, 192, 128] and [12288, 2, 30, 128], the 4AA eval's 3 x 128
axis at B = 2 and B = 8, [4, 3, 1000, 128] and [16, 3, 1000, 128], and with
the lse at [2, 3, 1000, 128]), K5-fp32 at MD17's and the 4AA eval's shapes,
and K2-fp32 at the MD17 test pass's [368640, 256] -> 512 and the 4AA
eval's [4000, 384] and sampling [16000, 384] -> 768, then K1-fp32 at
dh <= 64 (K3-fp32 on the 4AA eval's [4, 1000, 384] and [16, 1000, 384] and
MD17's [1920, 192, 256], with the lse at [16, 16, 1000, 24], stage 1's
[9600, 2, 192, 16] and, with the bias, [1920, 8, 192 -> 32, 16]) and
K8-fp32 at [2000, 2, 384] and [8000, 2, 384] at both splits and forward +
backward at [16000, 2, 384], and K9-fp32's forward and backward
(SHORT_FP32_SHAPES: MD17's temporal axis [12288, 30, 256] at 16 x 16 with
v a strided view, the 4AA smoke width's n = 16 at 4 x 8, [256, 127, 256]
at 4 x 64 and ragged n 9 / 31 / 33 at 16 x 16); ``--fp32`` times these
alone, ``--short-fp32`` K9-fp32's alone, with ``--yardsticks`` also their
plain versions, SDPA's (fp32, TF32 off; forward + backward less forward
for the backward) and their bounds. ``--bwd-fp32``
times K4 on fp32 operands alone (TF32 off) at the
shapes of fp32 training (BWD_FP32_SHAPES: the 4AA DiT's [32, 16, 1000, 24]
and [16, 3, 1000, 128], MD17's [1920, 16, 192, 16], [1920, 2, 192, 16],
[1920, 2, 192, 128] and [12288, 2, 30, 128], stage 1's encoder [256, 8, 192
-> 32, 16] with the bias) and K6 in fp32 at [16, 3, 1000, 128], with
``--yardsticks`` also their plain versions, SDPA's fp32 forward + backward
less forward (for K6 after the plain transform) and K4's bound. It uses only
entry points every tree of the port has, so an A/B of two trees runs it
from each in turns:

    cd <tree> && PYTHONPATH=. python <this file> <label> \
        [--fp32 | --short-fp32 [--yardsticks] | --bwd-fp32 [--yardsticks]]

and prints one line per call with the card's name and power limit.
"""

import subprocess
import sys

import torch

from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
from lam_slide_tpu_torch.ops import flash_attention as fa
from lam_slide_tpu_torch.ops import flash_normrope as fnr
from lam_slide_tpu_torch.ops import fused_adaln as fad
from lam_slide_tpu_torch.ops import fused_mlp as fm
from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
from lam_slide_tpu_torch.ops import short_attention as tsa
from lam_slide_tpu_torch.ops.ablations import fused_temporal_attention as tft
from lam_slide_tpu_torch.ops.ablations import short_backward as tsb
from lam_slide_tpu_torch.ops.packed_attention import lane_rope_tables

REPS = 50


def _ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, match: str, reps: int = REPS) -> float:
    """Device time a call of the kernels whose name holds ``match``, from
    torch.profiler (for a kernel shorter than its wrapper's host time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if match in e.key) / reps / 1e3


def _heads(gen, dev, dtype, b, n, h, dh, scale=1.0):
    """q, k, v as head-major views of one packed buffer, and a head-major grad."""
    qkv = (torch.randn(b, n, 3, h, dh, generator=gen) * scale).to(dev, dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    return q, k, v, torch.randn(b, h, n, dh, generator=gen).to(dev, dtype)


def _narrow_fp32_calls(gen, dev) -> list:
    """(name, call, reps) of K1-fp32 at dh <= 64 and K8-fp32 at their
    main-path shapes: K3-fp32 on the 4AA fp32 DiT's packed q/k/v (16 x 24, v
    a view of linear1's output) at the eval's B = 2 and the sampling B = 8,
    and on MD17's spatial axis [1920, 192, 256] (16 x 16); K1-fp32 with the
    lse at the 4AA train step's [16, 16, 1000, 24]; stage 1's latent
    self-attention [9600, 2, 192, 16] and its masked cross-attention
    [1920, 8, 192 -> 32, 16]; K8-fp32 at the eval's [2000, 2, 384] and
    [8000, 2, 384] at 16 x 24 and 3 x 128, and its forward + backward (the
    kernel's forward, the plain VJP) at the train step's [16000, 2, 384]."""
    calls = []
    for b, n, h, dh in ((4, 1000, 16, 24), (16, 1000, 16, 24), (1920, 192, 16, 16)):
        d = h * dh
        args = (torch.randn(b, n, d, generator=gen).to(dev),
                torch.randn(b, n, d, generator=gen).to(dev),
                torch.randn(b, n, 3 * d, generator=gen).to(dev)[..., 2 * d:], h)
        calls.append((f"K3-fp32 [{b},{n},{d}]",
                      lambda args=args: fa.flash_attention_packed(*args), 10))
    q, k, v, _ = _heads(gen, dev, torch.float32, 16, 1000, 16, 24)
    calls.append(("K1-fp32 lse [16,16,1000,24]",
                  lambda: fa._forward(q, k, v, 24 ** -0.5, with_lse=True), 10))
    q2, k2, v2, _ = _heads(gen, dev, torch.float32, 9600, 192, 2, 16)
    calls.append(("K1-fp32 [9600,2,192,16]", lambda: fa.flash_attention(q2, k2, v2), 10))
    cq = torch.randn(1920, 192, 8, 16, generator=gen).to(dev).transpose(1, 2)
    ck, cv = (t.transpose(1, 2) for t in torch.randn(1920, 32, 2, 8, 16, generator=gen)
              .to(dev).unbind(2))
    mask = (torch.arange(32)[None, :] < torch.randint(9, 22, (1920, 1), generator=gen)).to(dev)
    calls.append(("K1-bias fp32 [1920,8,192->32,16]",
                  lambda: fa.flash_attention(cq, ck, cv, mask=mask), 10))
    d, m, l = 384, 768, 2
    w1 = (torch.randn(3 * d + m, d, generator=gen) * d ** -0.5).to(dev)
    b1 = (torch.randn(3 * d + m, generator=gen) * 0.1).to(dev)
    w2 = (torch.randn(d, d + m, generator=gen) * (d + m) ** -0.5).to(dev)
    b2 = (torch.randn(d, generator=gen) * 0.1).to(dev)
    for n, heads in ((2000, 16), (8000, 16), (2000, 3), (8000, 3), (16000, 16)):
        dh = d // heads
        qs, ks = ((1 + 0.2 * torch.randn(dh, generator=gen)).to(dev) for _ in range(2))
        args = [torch.randn(n, l, d, generator=gen).to(dev), w1, b1, qs, ks, w2, b2,
                *rope_cos_sin(l, dh, device=dev), heads, dh ** -0.5]
        if n < 16000:
            calls.append((f"K8-fp32 [{n},{l},{d}] {heads}x{dh}",
                          lambda args=args: fsb.fused_spatial_block(*args), 10))
            continue
        leaves = [t.clone().requires_grad_(True) for t in args[:7]]
        g = torch.randn(n, l, d, generator=gen).to(dev)

        def fwd_bwd(leaves=leaves, g=g, rest=args[7:]):
            with torch.enable_grad():
                out = fsb.fused_spatial_block(*leaves, *rest)
                torch.autograd.grad(out, leaves, g)
        calls.append((f"K8-fp32 forward + backward [{n},{l},{d}] {heads}x{dh}", fwd_bwd, 5))
    return calls


# K9-fp32's shapes: (b, n, heads, dh), the first MD17's temporal axis at the
# fp32 stage-2 step's and the test pass's B = 64 (64 x 192 sequences)
SHORT_FP32_SHAPES = ((12288, 30, 16, 16), (65536, 16, 4, 8), (256, 127, 4, 64),
                     (12288, 9, 16, 16), (12288, 31, 16, 16), (12288, 33, 16, 16))


def _short_fp32_inputs(gen, dev, b, n, heads, dh):
    """K9-fp32's q and k contiguous, v a view of a wider buffer (as linear1's
    output hands it over), a contiguous output gradient."""
    d = heads * dh
    q, k, g = (torch.randn(b, n, d, generator=gen).to(dev) for _ in range(3))
    v = torch.randn(b, n, 3 * d, generator=gen).to(dev)[..., 2 * d:]
    return q, k, v, g


def _short_fp32_calls(gen, dev, yardsticks: bool = False) -> list:
    """(name, call, reps, yardsticks) of K9-fp32's forward and backward at
    SHORT_FP32_SHAPES; the yardsticks (plain ms, SDPA ms, bound ms and what
    bounds it) when asked for (chip_smoke.bound: four products for the
    forward, five for the backward, at fp32's rate; each input read and each
    output written once; one exponential a score)."""
    import chip_smoke as cs

    calls = []
    for b, n, heads, dh in SHORT_FP32_SHAPES:
        q, k, v, g = _short_fp32_inputs(gen, dev, b, n, heads, dh)
        scale = dh ** -0.5
        shape = f"[{b},{n},{heads * dh}] {heads}x{dh}"
        fwd = lambda q=q, k=k, v=v, heads=heads: tsa.short_attention(q, k, v, heads)  # noqa: E731
        bwd = lambda q=q, k=k, v=v, g=g, heads=heads, scale=scale: (  # noqa: E731
            tsa.short_attention_backward(q, k, v, g, heads, scale))
        extra = [None, None]
        if yardsticks:
            major = [t.unflatten(-1, (heads, dh)).transpose(1, 2) for t in (q, k, v, g)]
            scores, size = b * heads * n * n, 4 * q.numel()
            extra = [(_ms(lambda: tsa.reference_short_attention(q, k, v, heads, scale), 3),
                      cs.library_times(*major[:3], scale),
                      *cs.bound(4 * scores * dh, 4 * size, cs.PEAK_FP32_FLOPS, scores)),
                     (_ms(lambda: tsa.reference_short_backward(q, k, v, g, heads, scale), 3),
                      cs.library_times(*major[:3], scale, grad=major[3]),
                      *cs.bound(10 * scores * dh, 7 * size, cs.PEAK_FP32_FLOPS, scores))]
        calls += [(f"K9-fp32 forward {shape}", fwd, 10, extra[0]),
                  (f"K9-fp32 backward {shape}", bwd, 10, extra[1])]
    return calls


def _fp32_calls(gen, dev) -> list:
    """(name, call, reps) of the fp32 DiTs' K1-fp32 at dh 128, K5-fp32 and
    K2-fp32 at their main-path shapes, then ``_narrow_fp32_calls``."""
    calls = []
    for b, h, n in ((1920, 2, 192), (12288, 2, 30), (4, 3, 1000), (16, 3, 1000)):
        q, k, v, _ = _heads(gen, dev, torch.float32, b, n, h, 128)
        calls.append((f"K1-fp32 [{b},{h},{n},128]",
                      lambda q=q, k=k, v=v: fa.flash_attention(q, k, v), 10))
        qs, ks = ((1 + 0.2 * torch.randn(128, generator=gen)).to(dev) for _ in range(2))
        nr = (qs, ks, *rope_cos_sin(n, 128, device=dev))
        calls.append((f"K5-fp32 [{b},{h},{n},128]",
                      lambda q=q, k=k, v=v, nr=nr: fnr.flash_attention_normrope(q, k, v, *nr),
                      10))
    q, k, v, _ = _heads(gen, dev, torch.float32, 2, 1000, 3, 128)
    calls.append(("K1-fp32 lse [2,3,1000,128]",
                  lambda: fa._forward(q, k, v, 128 ** -0.5, with_lse=True), 10))
    for rows, d in ((368640, 256), (4000, 384), (16000, 384)):
        w1 = (torch.randn(5 * d, d, generator=gen) * d ** -0.5).to(dev)
        w2 = (torch.randn(d, 3 * d, generator=gen) * (3 * d) ** -0.5).to(dev)
        args = (torch.randn(rows, d, generator=gen).to(dev), w1[3 * d:].t(),
                (torch.randn(2 * d, generator=gen) * 0.1).to(dev), w2[:, d:].t())
        calls.append((f"K2-fp32 [{rows},{d}] -> {2 * d}", lambda args=args: fm.fused_mlp(*args),
                       10))
    return (calls + _narrow_fp32_calls(gen, dev)
            + [call[:3] for call in _short_fp32_calls(gen, dev)])


# K4-fp32's shapes on the fp32 training paths: (b, h, nq, nk, dh, masked)
BWD_FP32_SHAPES = ((32, 16, 1000, 1000, 24, False), (1920, 16, 192, 192, 16, False),
                   (1920, 2, 192, 192, 16, False), (256, 8, 192, 32, 16, True),
                   (16, 3, 1000, 1000, 128, False), (1920, 2, 192, 192, 128, False),
                   (12288, 2, 30, 30, 128, False))


def _bwd_fp32(gen, dev, label: str, smi: str, yardsticks: bool) -> None:
    """K4-fp32 (``flash_attention_backward`` on fp32 operands, from K1-fp32's
    out and lse) at BWD_FP32_SHAPES, TF32 off: q/k/v head-major views of one
    packed buffer (q of its own where nq != nk, the key-padding mask of
    stage 1's encoder there), g contiguous; then K6-fp32 at [16, 3, 1000,
    128] from K5-fp32's out and lse. With ``yardsticks`` also the plain
    versions, SDPA's fp32 forward + backward less forward and K4's bound
    (chip_smoke.bound: five products at fp32's rate)."""
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for b, h, nq, nk, dh, masked in BWD_FP32_SHAPES:
        if nq == nk:
            q, k, v, g = _heads(gen, dev, torch.float32, b, nq, h, dh)
        else:
            q = torch.randn(b, nq, h, dh, generator=gen).to(dev).transpose(1, 2)
            k, v = (t.transpose(1, 2) for t in torch.randn(b, nk, 2, h, dh, generator=gen)
                    .to(dev).unbind(2))
            g = torch.randn(b, h, nq, dh, generator=gen).to(dev)
        mask = None
        if masked:
            mask = (torch.arange(nk)[None, :] < torch.randint(9, nk - 10, (b, 1),
                                                              generator=gen)).to(dev)
        scale = dh ** -0.5
        out, lse = fa._forward(q, k, v, scale, with_lse=True, mask=mask)
        args = (q, k, v, out, lse, g, scale)
        shape = f"[{b},{h},{nq}{'' if nq == nk else f'->{nk}'},{dh}]{' bias' if masked else ''}"
        reps = 5 if dh == 128 or nq == 1000 else 10
        ms = _ms(lambda: fa.flash_attention_backward(*args, mask=mask), reps)
        text = f"{label}: K4-fp32 {shape} {ms:.4f} ms"
        if yardsticks:
            bias = None if mask is None else fa.mask_to_bias(mask)
            plain = _ms(lambda: fa.reference_flash_backward(*args, bias), 2)
            sdpa = cs.library_times(q, k, v, scale, grad=g, mask=mask)
            nbytes = 4 * (4 * b * h * nq * dh + 4 * b * h * nk * dh + b * h * nq
                          + (b * nk if masked else 0))
            bound_ms, by = cs.bound(10 * b * h * nq * nk * dh, nbytes, cs.PEAK_FP32_FLOPS,
                                    b * h * nq * nk)
            text += (f", plain {plain:.4f} ms, SDPA fwd+bwd - fwd {sdpa:.4f} ms, bound "
                     f"{bound_ms:.4f} ms ({by})")
        print(f"{text} | {smi}", flush=True)
        del q, k, v, g, out, lse, args
        torch.cuda.empty_cache()
    # K6-fp32: the fp32 transform, then K4-fp32 on q_t/k_t, at the 4AA fp32
    # DiT's 3 x 128 temporal axis
    b, h, n, dh = 16, 3, 1000, 128
    q, k, v, g = _heads(gen, dev, torch.float32, b, n, h, dh)
    tr = (*((1 + 0.2 * torch.randn(dh, generator=gen)).to(dev) for _ in range(2)),
          *rope_cos_sin(n, dh, device=dev))
    scale = dh ** -0.5
    out, lse = fnr._forward(q, k, v, *tr, scale, with_lse=True)
    args = (q, k, v, *tr, out, lse, g, scale)
    text = (f"{label}: K6-fp32 [{b},{h},{n},{dh}] "
            f"{_ms(lambda: fnr.flash_attention_normrope_backward(*args), 5):.4f} ms")
    if yardsticks:
        plain = _ms(lambda: fnr.reference_normrope_backward(*args), 2)
        composition = cs.library_times(q, k, v, scale, grad=g,
                                       pre=lambda q_, k_: fnr.pre_transform(q_, k_, *tr))
        text += f", plain {plain:.4f} ms, pre_transform + SDPA fwd+bwd - fwd {composition:.4f} ms"
    print(f"{text} | {smi}", flush=True)


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    if "--bwd-fp32" in sys.argv[2:]:
        with torch.no_grad():
            _bwd_fp32(gen, dev, label, smi, "--yardsticks" in sys.argv[2:])
        return 0
    if "--short-fp32" in sys.argv[2:]:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            for name, fn, reps, extra in _short_fp32_calls(gen, dev,
                                                           "--yardsticks" in sys.argv[2:]):
                text = f"{label}: {name} {_ms(fn, reps):.4f} ms"
                if extra is not None:
                    text += (f", plain {extra[0]:.4f} ms, SDPA {extra[1]:.4f} ms, bound "
                             f"{extra[2]:.4f} ms ({extra[3]})")
                print(f"{text} | {smi}", flush=True)
        return 0
    if "--fp32" in sys.argv[2:]:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            for name, fn, reps in _fp32_calls(gen, dev):
                print(f"{label}: {name} {_ms(fn, reps):.4f} ms | {smi}", flush=True)
        return 0
    q, k, v, _ = _heads(gen, dev, torch.float32, 9600, 192, 2, 16)
    cq = torch.randn(1920, 192, 8, 16, generator=gen).to(dev).transpose(1, 2)
    ck, cv = (t.transpose(1, 2) for t in torch.randn(1920, 32, 2, 8, 16, generator=gen)
              .to(dev).unbind(2))
    mask = (torch.arange(32)[None, :] < torch.randint(9, 22, (1920, 1), generator=gen)).to(dev)
    bf = torch.bfloat16
    # 4AA: K1 at B=8 (16 sequences), K3 on the same packed buffer
    qkv1 = torch.randn(16, 1000, 3 * 384, generator=gen).to(dev, bf)
    q1, k1, v1 = (t.transpose(1, 2) for t in qkv1.view(16, 1000, 3, 16, 24).unbind(2))
    p1 = qkv1.chunk(3, dim=-1)
    # MD17: K3 on the protocol's spatial axis; q/k contiguous, v a view
    q3, k3 = (torch.randn(9600, 192, 256, generator=gen).to(dev, bf) for _ in range(2))
    v3 = torch.randn(9600, 192, 768, generator=gen).to(dev, bf)[..., 512:]
    b4 = _heads(gen, dev, bf, 32, 1000, 16, 24)
    out4, lse4 = fa._forward(*b4[:3], 24 ** -0.5, with_lse=True)
    m4 = _heads(gen, dev, bf, 1920, 192, 16, 16)
    outm4, lsem4 = fa._forward(*m4[:3], 16 ** -0.5, with_lse=True)
    # K4 with the bias (stage 1's encoder, fp32) and in fp32 (stage 2's aux decode)
    eq = torch.randn(256, 192, 8, 16, generator=gen).to(dev).transpose(1, 2)
    ek, ev = (t.transpose(1, 2) for t in torch.randn(256, 32, 2, 8, 16, generator=gen)
              .to(dev).unbind(2))
    eg = torch.randn(256, 8, 192, 16, generator=gen).to(dev)
    emask = (torch.arange(32)[None, :] < torch.randint(9, 22, (256, 1), generator=gen)).to(dev)
    eout, else4 = fa._forward(eq, ek, ev, 16 ** -0.5, with_lse=True, mask=emask)
    f4 = _heads(gen, dev, torch.float32, 1920, 192, 2, 16)
    fout4, flse4 = fa._forward(*f4[:3], 16 ** -0.5, with_lse=True)
    b6 = _heads(gen, dev, bf, 32, 1000, 3, 128, scale=2.0)
    qs, ks = ((1 + 0.2 * torch.randn(128, generator=gen)).to(dev) for _ in range(2))
    cos, sin = rope_cos_sin(1000, 128, device=dev)
    nr = (qs, ks, cos, sin)
    out6, lse6 = fnr._forward(*b6[:3], *nr, 128 ** -0.5, with_lse=True)
    b5 = _heads(gen, dev, bf, 16, 1000, 3, 128, scale=2.0)
    # K10 at 3 x 128 on packed [16, 1000, 384] views, tiled lane scales
    qkv10 = (torch.randn(16, 1000, 3 * 384, generator=gen) * 2).to(dev, bf)
    cos_l, sin_l = lane_rope_tables(cos, sin, 3)
    k10 = (*qkv10.split(384, dim=-1), cos_l, sin_l, qs.repeat(3)[None], ks.repeat(3)[None], 3,
           128 ** -0.5)
    # K9 on the MD17 temporal axis: q/k contiguous, v a view, 16 heads of 16
    k9 = {}
    for b9 in (61440, 12288):
        q9, k9_, g9 = (torch.randn(b9, 30, 256, generator=gen).to(dev, bf) for _ in range(3))
        v9 = torch.randn(b9, 30, 768, generator=gen).to(dev, bf)[..., 512:]
        k9[b9] = (q9, k9_, v9, g9)
    m11 = _heads(gen, dev, bf, 1920, 192, 16, 16)
    out11, lse11 = fa._forward(*m11[:3], 16 ** -0.5, with_lse=True)
    # K2: x and the MLP slices of linear1 [3d + 2d, d] and linear2 [d, d + 2d]
    k2 = {}
    for rows, d in ((16000, 384), (32000, 384), (1843200, 256), (368640, 256)):
        w1 = (torch.randn(5 * d, d, generator=gen) * 0.05).to(dev, bf)
        w2 = (torch.randn(d, 3 * d, generator=gen) * 0.05).to(dev, bf)
        k2[rows, d] = (torch.randn(rows, d, generator=gen).to(dev, bf), w1[3 * d:].t(),
                       (torch.randn(2 * d, generator=gen) * 0.1).to(dev, bf), w2[:, d:].t())
    # K8 at the 4AA Euler-10 solve's [B*T, L, D] at B=2 and B=8, both splits
    k8 = {}
    for n in (2000, 8000):
        x8 = torch.randn(n, 2, 384, generator=gen).to(dev, bf)
        w18 = (torch.randn(1920, 384, generator=gen) * 384 ** -0.5).to(dev, bf)
        b18 = (torch.randn(1920, generator=gen) * 0.1).to(dev, bf)
        w28 = (torch.randn(384, 1152, generator=gen) * 1152 ** -0.5).to(dev, bf)
        b28 = (torch.randn(384, generator=gen) * 0.1).to(dev, bf)
        for heads in (16, 3):
            dh = 384 // heads
            qs8, ks8 = ((1 + 0.2 * torch.randn(dh, generator=gen)).to(dev) for _ in range(2))
            k8[n, heads] = (x8, w18, b18, qs8, ks8, w28, b28, *rope_cos_sin(2, dh, device=dev),
                            heads, dh ** -0.5)
    # K7 at the 4AA B=8 solve's [8, 1000, 2, 384] and the MD17 protocol's
    # [320, 30, 192, 256]: h the transposed temporal output, the modulation
    # chunks of one [B, 1, 1, 6D] tensor
    k7 = {}
    for b7, t7, l7, d7 in ((8, 1000, 2, 384), (320, 30, 192, 256)):
        mods = (torch.randn(b7, 1, 1, 6 * d7, generator=gen) * 0.5).to(dev, bf).chunk(6, -1)
        k7[b7, t7, l7, d7] = ((torch.randn(b7, t7, l7, d7, generator=gen) * 3).to(dev, bf),
                              torch.randn(b7, l7, t7, d7, generator=gen).to(dev, bf).transpose(
                                  1, 2), mods[2], mods[0], mods[1])
    calls = (
        ("K1 bf16 [16,16,1000,24]", lambda: fa.flash_attention(q1, k1, v1), REPS),
        ("K3 bf16 [16,1000,384]", lambda: fa.flash_attention_packed(*p1, 16), REPS),
        ("K3 bf16 [9600,192,256]", lambda: fa.flash_attention_packed(q3, k3, v3, 16), 10),
        ("K4 bf16 [32,16,1000,24]", lambda: fa.flash_attention_backward(
            *b4[:3], out4, lse4, b4[3], 24 ** -0.5), 10),
        ("K4 bf16 [1920,16,192,16]", lambda: fa.flash_attention_backward(
            *m4[:3], outm4, lsem4, m4[3], 16 ** -0.5), 10),
        ("K1-fp32 [9600,2,192,16]", lambda: fa.flash_attention(q, k, v), REPS),
        ("K1-bias fp32 [1920,8,192->32,16]", lambda: fa.flash_attention(cq, ck, cv, mask=mask),
         REPS),
        ("K4-bias fp32 [256,8,192->32,16]", lambda: fa.flash_attention_backward(
            eq, ek, ev, eout, else4, eg, 16 ** -0.5, mask=emask), REPS),
        ("K4-fp32 [1920,2,192,16]", lambda: fa.flash_attention_backward(
            *f4[:3], fout4, flse4, f4[3], 16 ** -0.5), 10),
        ("K5 bf16 [16,3,1000,128]", lambda: fnr.flash_attention_normrope(*b5[:3], *nr), REPS),
        ("K5 lse bf16 [32,3,1000,128]", lambda: fnr._forward(*b6[:3], *nr, 128 ** -0.5,
                                                              with_lse=True), REPS),
        ("K6 bf16 [32,3,1000,128]", lambda: fnr.flash_attention_normrope_backward(
            *b6[:3], *nr, out6, lse6, b6[3], 128 ** -0.5), 10),
        ("K10 bf16 [16,1000,384] 3x128", lambda: tft.fused_temporal_attention(*k10), REPS),
        *((f"K9 fwd bf16 [{b9},30,256]", lambda b9=b9: tsa.short_attention(*k9[b9][:3], 16), 10)
          for b9 in k9),
        *((f"K9 bwd bf16 [{b9},30,256]",
           lambda b9=b9: tsa.short_attention_backward(*k9[b9], 16, 0.25), 10) for b9 in k9),
        ("K11 bf16 [1920,16,192,16]", lambda: tsb.flash_backward_short(
            *m11[:3], out11, lse11, m11[3], 16 ** -0.5), 10),
        *((f"K2 bf16 [{rows},{d}] -> {2 * d}", lambda key=(rows, d): fm.fused_mlp(*k2[key]),
           10 if rows > 100000 else REPS) for rows, d in k2),
    )
    with torch.no_grad():
        for name, fn, reps in calls:
            print(f"{label}: {name} {_ms(fn, reps):.4f} ms | {smi}", flush=True)
        for (n, heads), args8 in k8.items():
            fn = lambda args8=args8: fsb.fused_spatial_block(*args8)  # noqa: E731
            print(f"{label}: K8 bf16 [{n},2,384] {heads}x{384 // heads} {_ms(fn):.4f} ms "
                  f"(events), {_device_ms(fn, 'spatial'):.4f} ms (device) | {smi}", flush=True)
        for shape, args7 in k7.items():
            fn = lambda args7=args7: fad.residual_adaln_modulate(*args7)  # noqa: E731
            reps = 10 if shape[0] > 100 else REPS
            print(f"{label}: K7 bf16 {list(shape)} {_ms(fn, reps):.4f} ms (events), "
                  f"{_device_ms(fn, 'adaln_kernel', reps):.4f} ms (device) | {smi}", flush=True)
        if hasattr(fnr, "qk_normrope"):
            tr = (b5[0], b5[1], *nr)
            print(f"{label}: K5 transform bf16 [16,3,1000,128] {_ms(lambda: fnr.qk_normrope(*tr)):.4f}"
                  f" ms (events), {_device_ms(lambda: fnr.qk_normrope(*tr), 'qk_normrope'):.4f} ms "
                  f"(device) | {smi}", flush=True)
        else:
            print(f"{label}: K5 transform: this tree has no transform kernel | {smi}", flush=True)
        for name, fn, reps in _fp32_calls(gen, dev):
            print(f"{label}: {name} {_ms(fn, reps):.4f} ms | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
