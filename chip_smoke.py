#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

The main path is the 4AA stage-2 sampler: the full-width ``LatentDiT``
(depth 7, hidden 384, mlp_ratio 2, T=1000 frames, L=2 latents, in_dim 96,
bf16) under the GVP data-prediction probability-flow ODE, with random
weights drawn from a seed, at both head splits (16 heads x dh 24 and
3 heads x dh 128) and with both samplers (Euler, num_steps=10, and the eval
protocol's dopri5 at atol 1e-6 / rtol 1e-3). Phases, each printed on its
own line with its seconds:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit from nvidia-smi;
2. build: compiles ``lam_slide_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   one process per source;
3. kernels: each kernel (K1 flash, K2 fused MLP, K3 packed flash, K5 flash
   with QKNorm + RoPE, K7 residual AdaLN, K8 spatial block) against its
   plain PyTorch version at main-path shapes at B=2 and B=8 in bf16, with
   the tolerance stated beside each check, its time, the plain version's
   time, its bound and, where one PyTorch call computes the same function,
   that call's time;
4. slice: Euler-10 solves at 16x24 (B=2, B=8) and 3x128 (B=8) and one
   dopri5 solve (16x24, B=8) through the kernels, checking shapes,
   finiteness and the launches of every kernel per solve, and one model
   forward per split against the plain path on the same weights, in bf16
   and in float32;
5. timing: solve times of the kernel path and the plain path, and the
   dopri5 drift evaluations per second;
6. profile: one solve per path and batch under ``torch.profiler``: device
   kernel time, the device's idle share, launches and the costliest kernels.

The last lines are a JSON summary of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero. Run from the repository root:

    python3 chip_smoke.py
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

T, L, DIN, DEPTH, HIDDEN, HEADS, MLP_RATIO = 1000, 2, 96, 7, 384, 16, 2
WIDE_HEADS = 3  # the 3 x dh 128 split
NUM_STEPS = 10
DRIFT_EVALS = NUM_STEPS - 1  # ode_fixed takes num_steps - 1 Euler steps
SEED = 0
DOPRI5_BATCH = 8
DOPRI5_MAX_STEPS = 1000  # ode_dopri5's bound on attempted steps

# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel could
# take is the larger of its tensor-core FLOPs over the bf16 rate and its
# bytes (each input read once, each output written once) over HBM's rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# K1 against its plain version: both round the output to bf16, and P is
# rounded to bf16 before the running-max rescale in the kernel but after
# normalization in the plain version, so the two differ by about one bf16
# ulp (measured 3.906e-3 at max |out| 0.617 on an H100). The limit is
# K1_ULPS ulps of bf16 at the largest |out|. A second check catches a
# uniform shrink or growth: the gain mean(got*want) / mean(want^2) must be
# within K1_GAIN_TOL of 1. Control: a K1 built without the last-tile key
# mask (T=1000 is 24 keys short of 16 tiles of 64, and zero-filled keys get
# logit 0) gave, on an H100 at [4,16,1000,24], a max error of 7.812e-3
# (2 ulps, inside the first limit) and a gain of 0.9861 (caught by the
# second); the correct K1 gave a gain within 6e-6 of 1. K3 and K5 are K1's
# binary on other views and with the QK transform, held to the same pair.
K1_ULPS = 2
K1_GAIN_TOL = 1e-3
# K2: the mid and gelu(mid) roundings to bf16 can land one ulp apart when
# fp32 sums are taken in another order; each flip moves an fp32 output by
# about ulp(mid) * |w2| ~ 4e-3 * 0.05, and outputs have |out| ~ 1.
K2_ATOL = 1e-2
# K7: x_new = x + bf16(gate * h) rounds per op as the plain version does,
# so it must be bit-identical; y may differ by K7_ULPS bf16 ulp at max |y|
# where the fp32 mean/variance, summed in another order, flip a rounding.
K7_ULPS = 1
# K8, relative to max |out|: bf16 roundings of linear1, the norm, the
# softmax weights and linear2 that land one ulp apart when fp32 sums are
# taken in another order. First reading on an H100: 4.348e-3 (3 x 128,
# [2000,2,384]; 2.212e-3 to 3.788e-3 at the other three shapes); the limit is
# 3x that.
K8_REL_TOL = 1.3e-2
# The model output of one full-width forward (the model call of one drift
# evaluation; the drift itself adds a noise term of the same size that
# would hide the model's error), relative to max |out|. Kernel path vs plain
# path, both bf16: 7 layers whose bf16 roundings differ in order; measured
# 3.185e-3 on an H100, the limit is 3x that.
MODEL_REL_TOL = 1e-2
# The kernel path against a float32 copy of the model on the plain path:
# measured 7.078e-3 on an H100, the limit is 3x that.
MODEL_FP32_REL_TOL = 2e-2
PROFILE_TOP = 12  # kernels listed per profiled solve


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Mean CUDA-event time of fn() over reps launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_times(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> float:
    """Time of PyTorch's own attention on K1's head-major inputs: the
    library yardstick of the kernel table, used nowhere in the port."""
    from torch.nn.functional import scaled_dot_product_attention

    return time_ms(lambda: scaled_dot_product_attention(q, k, v, scale=scale))


def bound(flops: float, nbytes: float):
    """(least ms, what bounds it) for FLOPs on the tensor cores and HBM bytes."""
    ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def errors(got: torch.Tensor, want: torch.Tensor):
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def gain(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return ((got * want).mean() / (want * want).mean()).item()


def k1_errors(got: torch.Tensor, want: torch.Tensor):
    """K1's max abs and rel error against its plain version, its abs limit
    (K1_ULPS bf16 ulps at the largest |want|) and its gain."""
    abs_err, rel_err = errors(got, want)
    return abs_err, rel_err, K1_ULPS * bf16_ulp(want.float().abs().max().item()), gain(got, want)


def check_k1(abs_err: float, atol: float, k1_gain: float, name: str = "K1") -> None:
    check(abs_err <= atol, f"{name} max abs err {abs_err} > {atol}")
    check(abs(k1_gain - 1) <= K1_GAIN_TOL, f"{name} gain {k1_gain} off 1 by > {K1_GAIN_TOL}")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


class KernelTable:
    """One row per kernel of the JSON summary, from the B=8 shapes."""

    def __init__(self):
        self.rows = {}

    def add(self, key, shape, err, limit, ms, plain_ms, flops, nbytes, lib_ms=None):
        bound_ms, bound_by = bound(flops, nbytes)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"kernel {key} {shape}: max_abs_err {err:.3e} ({limit}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms library {lib} bound {bound_ms:.4f} ms ({bound_by}, "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
        self.rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=lib_ms)


def kernel_checks(dev, gen, table: KernelTable) -> None:
    from lam_slide_tpu_torch.models.latent_dit import rope_cos_sin
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops import fused_adaln as fad
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
    from lam_slide_tpu_torch.ops.packed_attention import headmajor_rmsnorm, headmajor_rope

    d, m = HIDDEN, HIDDEN * MLP_RATIO
    bf = torch.bfloat16
    for batch in (2, 8):
        bp, rows = batch * L, batch * L * T  # temporal batch B*L; positions B*T*L
        attn_flops, attn_bytes = 4 * bp * T * T * d, 4 * bp * T * d * 2

        # K1 on head-major strided views of one qkv buffer
        dh = d // HEADS
        qkv = _rand(gen, bp, T, 3 * d).to(dev, bf)
        q, k, v = (t.transpose(1, 2) for t in qkv.view(bp, T, 3, HEADS, dh).unbind(2))
        got, want = fa.flash_attention(q, k, v), fa.reference_attention(q, k, v)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == bf, "K1 shape/dtype")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        table.add("K1", f"q/k/v [{bp},{HEADS},{T},{dh}] strided views, gain {k1_gain:.7f}",
                  abs_err, f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fa.flash_attention(q, k, v)),
                  time_ms(lambda: fa.reference_attention(q, k, v)), attn_flops, attn_bytes,
                  library_times(q, k, v, dh ** -0.5))
        check_k1(abs_err, atol, k1_gain)

        # K3: the packed entry on [B*L, T, H*dh] views of the same buffer
        qp, kp, vp = qkv.chunk(3, dim=-1)
        got = fa.flash_attention_packed(qp, kp, vp, HEADS)
        want = fa.reference_attention_packed(qp, kp, vp, HEADS)
        torch.cuda.synchronize()
        check(got.shape == qp.shape and got.is_contiguous(), "K3 shape/layout")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        table.add("K3", f"packed q/k/v [{bp},{T},{d}] views, gain {k1_gain:.7f}", abs_err,
                  f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fa.flash_attention_packed(qp, kp, vp, HEADS)),
                  time_ms(lambda: fa.reference_attention_packed(qp, kp, vp, HEADS)),
                  attn_flops, attn_bytes, library_times(q, k, v, dh ** -0.5))
        check_k1(abs_err, atol, k1_gain, "K3")

        # K5 on raw strided views of a 3 x 128 qkv buffer
        wdh = d // WIDE_HEADS
        qkv5 = _rand(gen, bp, T, 3, WIDE_HEADS, wdh, scale=2.0).to(dev, bf)
        q5, k5, v5 = (t.transpose(1, 2) for t in qkv5.unbind(2))
        qs, ks = ((1 + 0.2 * _rand(gen, wdh)).to(dev) for _ in range(2))
        cos, sin = rope_cos_sin(T, wdh, device=dev)
        args5 = (q5, k5, v5, qs, ks, cos, sin)
        got, want = fnr.flash_attention_normrope(*args5), fnr.reference_attention_normrope(*args5)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == bf, "K5 shape/dtype")
        abs_err, _, atol, k1_gain = k1_errors(got, want)
        table.add("K5", f"raw q/k/v [{bp},{WIDE_HEADS},{T},{wdh}] strided views, gain "
                  f"{k1_gain:.7f}", abs_err,
                  f"atol {atol:.3e} = {K1_ULPS} bf16 ulps, gain tol {K1_GAIN_TOL}",
                  time_ms(lambda: fnr.flash_attention_normrope(*args5)),
                  time_ms(lambda: fnr.reference_attention_normrope(*args5)),
                  attn_flops, attn_bytes + 2 * T * wdh // 2 * 4)
        check_k1(abs_err, atol, k1_gain, "K5")
        # the same binary without the in-tile transform, on pre-transformed
        # q/k: what the transform costs inside K5
        qt, kt = (headmajor_rope(headmajor_rmsnorm(t, s), cos, sin)
                  for t, s in ((q5, qs), (k5, ks)))
        print(f"kernel K5 without its transform (K1 at the same shape): "
              f"{time_ms(lambda: fa.flash_attention(qt, kt, v5)):.4f} ms")

        # K2 on the MLP slices of nn.Linear weights
        x = _rand(gen, rows, d).to(dev, bf)
        w1_full = _rand(gen, 3 * d + m, d, scale=0.05).to(dev, bf)
        w2_full = _rand(gen, d, d + m, scale=0.05).to(dev, bf)
        b1 = _rand(gen, m, scale=0.1).to(dev, bf)
        w1, w2 = w1_full[3 * d:].t(), w2_full[:, d:].t()
        got, want = fm.fused_mlp(x, w1, b1, w2), fm.reference_mlp(x, w1, b1, w2)
        torch.cuda.synchronize()
        check(got.shape == (rows, d) and got.dtype == torch.float32, "K2 shape/dtype")
        abs_err, _ = errors(got, want)
        table.add("K2", f"x [{rows},{d}] w1 [{d},{m}] w2 [{m},{d}]", abs_err,
                  f"atol {K2_ATOL}", time_ms(lambda: fm.fused_mlp(x, w1, b1, w2)),
                  time_ms(lambda: fm.reference_mlp(x, w1, b1, w2)),
                  4 * rows * d * m, rows * d * (2 + 4) + 2 * d * m * 2 + m * 2)
        check(abs_err <= K2_ATOL, f"K2 max abs err {abs_err} > {K2_ATOL}")

        # K7 on the DiT's [B, T, L, D] stream: h the transposed temporal
        # output, gate/shift/scale chunks of one [B, 1, 1, 6D] modulation
        x7 = _rand(gen, batch, T, L, d, scale=3.0).to(dev, bf)
        h7 = _rand(gen, batch, L, T, d).to(dev, bf).transpose(1, 2)
        shift, scale, gate = _rand(gen, batch, 1, 1, 6 * d, scale=0.5).to(dev, bf).chunk(6, -1)[:3]
        args7 = (x7, h7, gate, shift, scale)
        (x_new, y), (want_x, want_y) = (fad.residual_adaln_modulate(*args7),
                                        fad.reference_residual_adaln_modulate(*args7))
        y0, want_y0 = fad.adaln_modulate(x7, shift, scale), fad.reference_adaln_modulate(
            x7, shift, scale)
        torch.cuda.synchronize()
        check(torch.equal(x_new, want_x), "K7 x_new is not bit-identical to the plain version")
        abs_err, _ = errors(y, want_y)
        atol = K7_ULPS * bf16_ulp(want_y.float().abs().max().item())
        err0, _ = errors(y0, want_y0)
        table.add("K7", f"x/h [{batch},{T},{L},{d}] (x_new bit-identical; y without residual "
                  f"{err0:.3e})", abs_err, f"atol {atol:.3e} = {K7_ULPS} bf16 ulp at max |y|",
                  time_ms(lambda: fad.residual_adaln_modulate(*args7)),
                  time_ms(lambda: fad.reference_residual_adaln_modulate(*args7)),
                  0, 4 * rows * d * 2 + 3 * batch * d * 2)
        check(abs_err <= atol, f"K7 y max abs err {abs_err} > {atol}")
        check(err0 <= K7_ULPS * bf16_ulp(want_y0.float().abs().max().item()),
              f"K7 (no residual) y max abs err {err0}")

        # K8 on [B*T, L, D] frames at both head splits
        frames = batch * T
        x8 = _rand(gen, frames, L, d).to(dev, bf)
        w18 = _rand(gen, 3 * d + m, d, scale=d ** -0.5).to(dev, bf)
        b18 = _rand(gen, 3 * d + m, scale=0.1).to(dev, bf)
        w28 = _rand(gen, d, d + m, scale=(d + m) ** -0.5).to(dev, bf)
        b28 = _rand(gen, d, scale=0.1).to(dev, bf)
        for heads in (HEADS, WIDE_HEADS):
            hd = d // heads
            qs8, ks8 = ((1 + 0.2 * _rand(gen, hd)).to(dev) for _ in range(2))
            cos8, sin8 = rope_cos_sin(L, hd, device=dev)
            args8 = (x8, w18, b18, qs8, ks8, w28, b28, cos8, sin8, heads, hd ** -0.5)
            got, want = fsb.fused_spatial_block(*args8), fsb.reference_spatial_block(*args8)
            torch.cuda.synchronize()
            check(got.shape == x8.shape and got.dtype == bf, "K8 shape/dtype")
            abs_err, rel_err = errors(got, want)
            key = "K8" if heads == HEADS else "K8 3x128"
            table.add(key, f"x [{frames},{L},{d}] heads {heads} x {hd} (rel {rel_err:.3e})",
                      abs_err, f"rel tol {K8_REL_TOL}",
                      time_ms(lambda: fsb.fused_spatial_block(*args8)),
                      time_ms(lambda: fsb.reference_spatial_block(*args8)),
                      2 * rows * (d * (3 * d + m) + (d + m) * d),
                      2 * rows * d * 2 + ((3 * d + m) * d + d * (d + m)) * 2)
            check(rel_err <= K8_REL_TOL, f"K8 heads {heads} rel err {rel_err} > {K8_REL_TOL}")


def make_inputs(batch: int, dev, gen):
    noise = torch.randn(batch, T, L, DIN, generator=gen).to(dev)
    x_cond = torch.zeros_like(noise)
    mask = torch.zeros(batch, T, L, dtype=torch.long, device=dev)
    mask[:, :1] = 1  # frame 0 conditions, as bench.py:121-123
    return noise, x_cond, mask


def solve_time_s(solve, noise, kw) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    solve(noise, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def _device_time_us(evt) -> float:
    # the attribute's name differs across torch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_solve(solve, noise, kw, label: str) -> None:
    """One solve under torch.profiler: host wall time around the synchronized
    solve (inflated by the profiler), summed device kernel time, the device's
    idle share, kernel launches and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    solve(noise, **kw)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve(noise, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    check(busy_us > 0, f"profile {label}: no device time traced")
    print(f"profile {label}: solve wall {wall_us / 1e3:.3f} ms (profiled), device kernel "
          f"time {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.3f}, "
          f"kernel launches {len(kernels)}")
    for evt in sorted(prof.key_averages(), key=_device_time_us, reverse=True)[:PROFILE_TOP]:
        print(f"  {_device_time_us(evt) / 1e3:9.3f} ms device {evt.count:6d} calls  {evt.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    from lam_slide_tpu_torch.models import LatentDiT
    from lam_slide_tpu_torch.ops import _build
    from lam_slide_tpu_torch.ops import flash_attention as fa
    from lam_slide_tpu_torch.ops import flash_normrope as fnr
    from lam_slide_tpu_torch.ops import fused_adaln as fad
    from lam_slide_tpu_torch.ops import fused_mlp as fm
    from lam_slide_tpu_torch.ops import fused_spatial_block as fsb
    from lam_slide_tpu_torch.transport import Sampler, create_transport

    counters = {"K1": fa, "K2": fm, "K5": fnr, "K7": fad, "K8": fsb}

    def reset_counts():
        for mod in counters.values():
            mod.launches = 0

    def read_counts():
        return {key: mod.launches for key, mod in counters.items()}

    phase_t0 = time.perf_counter()

    def phase_done(name):
        nonlocal phase_t0
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0:.2f} s")
        phase_t0 = now

    # 1. device
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    phase_done("device")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.load_library()
    print(f"build: {lib.relative_to(_build.BUILD_ROOT.parent.parent)} "
          f"in {time.perf_counter() - t0:.2f} s")
    phase_done("build")

    # 3. kernels vs plain at main-path shapes
    gen = torch.Generator().manual_seed(SEED)
    table = KernelTable()
    kernel_checks(dev, gen, table)
    phase_done("kernels")

    # 4. the slice
    def make_model(heads, dtype=torch.bfloat16, backend="auto"):
        model = LatentDiT(depth=DEPTH, in_dim=DIN, hidden_size=HIDDEN, num_heads=heads,
                          mlp_ratio=MLP_RATIO, reference_init=False, dtype=dtype,
                          backend=backend, device=dev,
                          generator=torch.Generator().manual_seed(SEED))
        return model.eval()

    models = {HEADS: make_model(HEADS), WIDE_HEADS: make_model(WIDE_HEADS)}
    transport = create_transport(path_type="GVP", prediction="data")
    euler = Sampler(transport).sample_ode(sampling_method="euler", num_steps=NUM_STEPS)
    dopri5 = Sampler(transport).sample_ode(sampling_method="dopri5", atol=1e-6, rtol=1e-3,
                                           return_stats=True)

    def expected(heads, evals):
        """Launches per solve: per layer one temporal attention (K5 at
        dh % 128 == 0, else K1 through K3's entry), one K2, two K7 and one K8,
        and one more K7 for the output AdaLN of each forward."""
        attn = "K5" if HIDDEN // heads % 128 == 0 else "K1"
        per_layer = {"K1": 0, "K5": 0, "K2": 1, "K7": 2, "K8": 1, attn: 1}
        return {key: (DEPTH * n + (key == "K7")) * evals for key, n in per_layer.items()}

    launches = {}
    inputs = {}
    with torch.no_grad():
        for heads, batch in ((HEADS, 2), (HEADS, 8), (WIDE_HEADS, 8)):
            model = models[heads]
            noise, x_cond, mask = make_inputs(batch, dev, gen)
            inputs.setdefault(batch, (noise, dict(x_cond=x_cond, x_cond_mask=mask)))
            reset_counts()
            out = euler(noise, model, x_cond=x_cond, x_cond_mask=mask)
            torch.cuda.synchronize()
            counts, want = read_counts(), expected(heads, DRIFT_EVALS)
            if batch == 8:
                launches[heads] = counts
            print(f"slice: Euler-{NUM_STEPS} GVP data solve {heads}x{HIDDEN // heads} B={batch}: "
                  f"out {list(out.shape)} {out.dtype} finite={bool(torch.isfinite(out).all())} "
                  f"launches {counts} (expected {want})")
            check(tuple(out.shape) == (batch, T, L, DIN), f"output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "non-finite solve output")
            check(counts == want, f"launch counts {counts} != {want}")

        # one full-width forward per split, kernel path vs plain paths, same
        # weights and inputs: the model call of a drift evaluation at t=0.5
        noise, kw = inputs[2]
        tvec = torch.full((2,), 0.5, device=dev)
        for heads, model in models.items():
            got = model(noise, tvec, **kw)
            model.backend = "plain"
            want = model(noise, tvec, **kw)
            model.backend = "auto"
            ref32 = make_model(heads, torch.float32, "plain")
            ref32.load_state_dict(model.state_dict())
            want32 = ref32(noise, tvec, **kw)
            torch.cuda.synchronize()
            abs_err, rel_err = errors(got, want)
            abs32, rel32 = errors(got, want32)
            print(f"slice: one forward {heads}x{HIDDEN // heads} B=2 t=0.5, kernel vs plain bf16: "
                  f"max_abs_err {abs_err:.3e} rel {rel_err:.3e} (tol {MODEL_REL_TOL}); vs plain "
                  f"fp32: max_abs_err {abs32:.3e} rel {rel32:.3e} (tol {MODEL_FP32_REL_TOL}); "
                  f"max|out| {want.abs().max().item():.3f}")
            check(rel_err <= MODEL_REL_TOL, f"{heads} heads: kernel vs plain rel err {rel_err}")
            check(rel32 <= MODEL_FP32_REL_TOL, f"{heads} heads: kernel vs fp32 rel err {rel32}")
            del ref32

        # the eval protocol's sampler: one dopri5 solve at 16 x 24
        noise, kw = inputs[DOPRI5_BATCH]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, (n_iters, n_acc) = dopri5(noise, models[HEADS], **kw)
        torch.cuda.synchronize()
        dopri5_s = time.perf_counter() - t0
        counts, nfe = read_counts(), 1 + 6 * n_iters
        want = expected(HEADS, nfe)
        print(f"slice: dopri5 (atol 1e-6, rtol 1e-3) GVP data solve {HEADS}x{HIDDEN // HEADS} "
              f"B={DOPRI5_BATCH}: n_iters {n_iters} n_accepted {n_acc} NFE {nfe} solve "
              f"{dopri5_s:.3f} s finite={bool(torch.isfinite(out).all())} launches {counts} "
              f"(expected {want})")
        check(n_iters < DOPRI5_MAX_STEPS, f"dopri5 stopped at max_steps ({n_iters}) before t1")
        check(bool(torch.isfinite(out).all()), "non-finite dopri5 output")
        check(counts == want, f"dopri5 launch counts {counts} != {want}")
        phase_done("slice")

        # 5. timing: warm-up, then plain, kernel, kernel, plain per arm
        for heads, batch in ((HEADS, 2), (HEADS, 8), (WIDE_HEADS, 8)):
            model, (noise, kw) = models[heads], inputs[batch]

            def solve(x, **kwargs):
                return euler(x, model, **kwargs)

            times = {"auto": [], "plain": []}
            for backend in ("auto", "plain"):
                model.backend = backend
                solve(noise, **kw)
            for backend in ("plain", "auto", "auto", "plain"):
                model.backend = backend
                times[backend].append(solve_time_s(solve, noise, kw))
            model.backend = "auto"
            kern, plain = np.mean(times["auto"]), np.mean(times["plain"])
            print(f"timing {heads}x{HIDDEN // heads} B={batch}: solve kernel path "
                  f"{kern * 1e3:.3f} ms ({batch * DRIFT_EVALS / kern:.2f} traj-ODE steps/s), "
                  f"plain path {plain * 1e3:.3f} ms ({batch * DRIFT_EVALS / plain:.2f} traj-ODE "
                  f"steps/s); runs kernel {[round(t * 1e3, 3) for t in times['auto']]} "
                  f"plain {[round(t * 1e3, 3) for t in times['plain']]} ms | {smi}")
        print(f"timing dopri5 {HEADS}x{HIDDEN // HEADS} B={DOPRI5_BATCH}: {nfe} drift evals in "
              f"{dopri5_s:.3f} s, {nfe / dopri5_s:.2f} drift-evals/s "
              f"({DOPRI5_BATCH * nfe / dopri5_s:.2f} traj-drift-evals/s) | {smi}")
        phase_done("timing")

        # 6. profile
        for heads, batch, backends in ((HEADS, 2, ("auto", "plain")),
                                       (HEADS, 8, ("auto", "plain")),
                                       (WIDE_HEADS, 8, ("auto",))):
            model = models[heads]
            for backend in backends:
                model.backend = backend
                profile_solve(lambda x, **kw: euler(x, model, **kw), *inputs[batch],
                              f"{heads}x{HIDDEN // heads} backend={backend} B={batch}")
            model.backend = "auto"
        phase_done("profile")

    sources = {
        "K1": ("flash_attention_fwd", "flash_attention.cu", "flash_attention.py:37"),
        "K2": ("fused_mlp", "fused_mlp.cu", "fused_mlp.py:68"),
        "K3": ("flash_attention_packed", "flash_attention.cu", "flash_attention.py:228"),
        "K5": ("flash_attention_normrope", "flash_attention.cu", "flash_normrope.py:74"),
        "K7": ("residual_adaln_modulate", "fused_adaln.cu", "fused_adaln.py:98"),
        "K8": ("fused_spatial_block", "fused_spatial_block.cu", "fused_spatial_block.py:108"),
    }
    # launches on the main path: K1/K2/K7/K8 from the 16 x 24 B=8 Euler solve,
    # K3 under K1's counter (one binary), K5 from the 3 x 128 B=8 solve
    main_counts = dict(launches[HEADS], K3=launches[HEADS]["K1"], K5=launches[WIDE_HEADS]["K5"])
    kernels = [
        {"name": name, "route": "cuda", "source": f"lam_slide_tpu_torch/csrc/{src}",
         "replaces": f"lam_slide_tpu/ops/{tpu}", "launches": main_counts[key],
         **table.rows[key]}
        for key, (name, src, tpu) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
