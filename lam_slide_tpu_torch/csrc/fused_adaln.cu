// Residual add + LayerNorm + AdaLN modulate for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernels lam_slide_tpu/ops/fused_adaln.py
// `_adaln_kernel` (RESIDUAL=false: y = modulate(LN(x))) and
// `_residual_adaln_kernel` (RESIDUAL=true: x_new = x + gate*h,
// y = modulate(LN(x_new))), which the DiT calls twice per layer and once
// before its output layer (models/latent_dit.py LatentDiTLayer, LatentDiT).
//
// Design: one warp per row of D values (D even, <= 1024); a block of 8 warps
// takes 8 consecutive rows of x viewed as [B, R1, R2, D]. Each lane holds
// its pairs (columns 2p, 2p + 1 for p = lane, lane + 32, ...) in registers,
// so x and h are read once and x_new and y written once; the fp32 mean and
// variance are warp-shuffle sums. h is read through its own (B, R1, R2)
// strides, so the DiT's temporal output goes in as the [B, T, L, D] view of
// its [B, L, T, D] memory; gate/shift/scale are [B, 1.., D] rows addressed
// through their batch stride, so the chunks of the DiT's [B, 1, 1, 6D]
// modulation go in without a copy either.
//
// What bounds it on the H100: ~10 FLOPs per element against 8 bytes moved
// (x, h in; x_new, y out; bf16), so it is bound by HBM bytes; the design's
// one read and one write per tensor is what the bound counts.
//
// Numerics of fused_adaln.py:83-105 and of the plain composition: x_new =
// bf16(x + bf16(gate * h)) rounds per op as PyTorch's bf16 ops do, so it is
// bit-identical; mean and variance in fp32 (in another summation order than
// PyTorch's reduction); xn = bf16((x - mean) / sqrt(var + eps)); then
// bf16(bf16(xn * bf16(1 + scale)) + shift). The _rn intrinsics keep the
// compiler from fusing products into FMAs the separate ops do not have.

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int MAXP = 16;  // pairs per lane: D <= 2 * 32 * MAXP = 1024

template <bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
adaln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
             const bf16* __restrict__ gate, const bf16* __restrict__ shift,
             const bf16* __restrict__ scale, bf16* __restrict__ x_out,
             bf16* __restrict__ y, long long R, long long R1, long long R2, int D,
             long long h_s0, long long h_s1, long long h_s2, long long gate_sb,
             long long shift_sb, long long scale_sb, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * NWARPS + threadIdx.x / 32;
  if (row >= R) return;
  const long long b = row / (R1 * R2), i1 = (row / R2) % R1, i2 = row % R2;
  const int npairs = D / 2;
  const long long base = row * D;
  const bf16* hrow = h + b * h_s0 + i1 * h_s1 + i2 * h_s2;
  const float inv_d = 1.0f / static_cast<float>(D);

  float2 v[MAXP];
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    const int p = lane + 32 * j;
    if (p >= npairs) break;
    float2 xv = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(x + base)[p]);
    if constexpr (RESIDUAL) {
      const float2 hv =
          __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(hrow)[p]);
      const float2 gv = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(gate + b * gate_sb)[p]);
      xv.x = lam_round_bf16(__fadd_rn(xv.x, lam_round_bf16(__fmul_rn(gv.x, hv.x))));
      xv.y = lam_round_bf16(__fadd_rn(xv.y, lam_round_bf16(__fmul_rn(gv.y, hv.y))));
      reinterpret_cast<__nv_bfloat162*>(x_out + base)[p] = __floats2bfloat162_rn(xv.x, xv.y);
    }
    v[j] = xv;
    sum = __fadd_rn(sum, __fadd_rn(xv.x, xv.y));
  }
  const float mean = __fmul_rn(lam_warp_sum(sum), inv_d);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    if (lane + 32 * j >= npairs) break;
    const float dx = __fsub_rn(v[j].x, mean), dy = __fsub_rn(v[j].y, mean);
    sq = __fadd_rn(sq, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  }
  const float var = __fmul_rn(lam_warp_sum(sq), inv_d);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int j = 0; j < MAXP; ++j) {
    const int p = lane + 32 * j;
    if (p >= npairs) break;
    const float2 sh = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(shift + b * shift_sb)[p]);
    const float2 sc = __bfloat1622float2(
        reinterpret_cast<const __nv_bfloat162*>(scale + b * scale_sb)[p]);
    const float xnx = lam_round_bf16(__fmul_rn(__fsub_rn(v[j].x, mean), inv));
    const float xny = lam_round_bf16(__fmul_rn(__fsub_rn(v[j].y, mean), inv));
    const float yx = __fadd_rn(lam_round_bf16(__fmul_rn(xnx, lam_round_bf16(1.0f + sc.x))), sh.x);
    const float yy = __fadd_rn(lam_round_bf16(__fmul_rn(xny, lam_round_bf16(1.0f + sc.y))), sh.y);
    reinterpret_cast<__nv_bfloat162*>(y + base)[p] = __floats2bfloat162_rn(yx, yy);
  }
}

}  // namespace

// x, x_out, y: bf16 [B, R1, R2, D] contiguous (R = B * R1 * R2 rows); h:
// bf16 [B, R1, R2, D] with element strides h_s0/1/2 and unit stride on D;
// gate, shift, scale: bf16 rows of D with unit stride, batch b at b * *_sb
// elements. residual = 0 computes y = modulate(LN(x)) and reads neither h
// nor gate nor writes x_out. D even and <= 1024; pointers 4-byte aligned,
// strides even. Returns cudaGetLastError().
extern "C" int lam_adaln_fwd(const void* x, const void* h, const void* gate,
                             const void* shift, const void* scale, void* x_out, void* y,
                             long long R, long long R1, long long R2, int D, long long h_s0,
                             long long h_s1, long long h_s2, long long gate_sb,
                             long long shift_sb, long long scale_sb, float eps, int residual,
                             void* stream) {
  if (R <= 0 || R1 <= 0 || R2 <= 0 || D <= 0 || D % 2 || D > 64 * MAXP)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((R + NWARPS - 1) / NWARPS));
  auto st = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto hb = static_cast<const bf16*>(h);
  auto gb = static_cast<const bf16*>(gate);
  auto shb = static_cast<const bf16*>(shift);
  auto scb = static_cast<const bf16*>(scale);
  auto xob = static_cast<bf16*>(x_out);
  auto yb = static_cast<bf16*>(y);
  if (residual)
    adaln_kernel<true><<<grid, THREADS, 0, st>>>(xb, hb, gb, shb, scb, xob, yb, R, R1, R2,
                                                 D, h_s0, h_s1, h_s2, gate_sb, shift_sb,
                                                 scale_sb, eps);
  else
    adaln_kernel<false><<<grid, THREADS, 0, st>>>(xb, hb, gb, shb, scb, xob, yb, R, R1, R2,
                                                  D, h_s0, h_s1, h_s2, gate_sb, shift_sb,
                                                  scale_sb, eps);
  return static_cast<int>(cudaGetLastError());
}
