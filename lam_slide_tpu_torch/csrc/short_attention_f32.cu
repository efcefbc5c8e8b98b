// Attention over short unmasked self-attention axes (8 < n < 128), forward,
// fp32 in / fp32 out, for Hopper (sm_90a), on the FP32 pipes (FFMA; no
// tensor cores, so no TF32).
//
// Replaces the fp32 instance of the Pallas TPU kernel
// lam_slide_tpu/ops/short_attention.py `_short_fwd_kernel`, which the fp32
// DiT of the MD17 test pass runs on its temporal axis (T = 30). Numerics of
// `_scores` (short_attention.py:73-80) in fp32: logits q k^T * scale in
// fp32, the softmax in fp32 (its `astype(v.dtype)` of the weights is a
// no-op), fp32 accumulation of the AV product.
//
// Design: a warp owns one (batch row, head) item at a time and walks the
// items with a grid stride. It stages the item's k and v ([n, dh], read
// through packed [B, n, H*dh] strides with unit stride on dh, so the DiT's
// q/k and its v view of linear1's output go in without a copy) in its own
// shared-memory slab, zero-padded to DHP columns; each lane takes query
// rows lane, lane + 32, ... with its q row and output accumulator in
// registers. Per query row, two passes over the keys: the row max of the
// logits, then p = exp(s - max), its sum and sum p v (the logits computed
// again: n * dh FFMAs a pass, a few hundred at MD17's n 30, dh 16); the
// output is that sum over the sum of p. Every lane of a warp reads the same
// k/v element at once (a broadcast, 16 bytes a load). No atomics: a result
// repeats bit for bit.
//
// What bounds it on the H100: at [12288, 30, 256] with 16 heads x dh 16 it
// moves 4 x 377 MB of q/k/v/o (0.45 ms at 3.35 TB/s) for ~23 GFLOP of FFMA:
// bytes.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 8;

struct Args {
  const float *q, *k, *v;
  float* o;
  long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn;
  int B, H, n, dh;
  float scale;
};

// Shared memory of a warp: k and v of one item, n rows of DHP floats.
template <int DHP>
__host__ __device__ constexpr size_t warp_floats(int n) {
  return 2 * static_cast<size_t>(n) * DHP;
}

template <int DHP>
__global__ void short_fwd_f32_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wpb = blockDim.x / 32;
  float* k_s = reinterpret_cast<float*>(smem4) + warp * warp_floats<DHP>(a.n);
  float* v_s = k_s + a.n * DHP;
  const long long items = static_cast<long long>(a.B) * a.H;
  for (long long item = static_cast<long long>(blockIdx.x) * wpb + warp; item < items;
       item += static_cast<long long>(gridDim.x) * wpb) {
    const long long b = item / a.H;
    const int h = static_cast<int>(item % a.H);
    __syncwarp();  // the previous item's k/v are consumed
    for (int idx = lane; idx < a.n * DHP; idx += 32) {
      const int j = idx / DHP, d = idx % DHP;
      const bool in = d < a.dh;
      k_s[idx] = in ? a.k[b * a.k_sb + j * a.k_sn + h * a.dh + d] : 0.0f;
      v_s[idx] = in ? a.v[b * a.v_sb + j * a.v_sn + h * a.dh + d] : 0.0f;
    }
    __syncwarp();
    for (int i = lane; i < a.n; i += 32) {
      float qr[DHP];
      const float* qp = a.q + b * a.q_sb + i * a.q_sn + h * a.dh;
#pragma unroll
      for (int d = 0; d < DHP; ++d) qr[d] = d < a.dh ? qp[d] : 0.0f;
      float m = -CUDART_INF_F;
      for (int j = 0; j < a.n; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + j * DHP);
        float s = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < DHP / 4; ++d4) {
          const float4 kv = kr[d4];
          s = fmaf(qr[4 * d4], kv.x, s);
          s = fmaf(qr[4 * d4 + 1], kv.y, s);
          s = fmaf(qr[4 * d4 + 2], kv.z, s);
          s = fmaf(qr[4 * d4 + 3], kv.w, s);
        }
        m = fmaxf(m, __fmul_rn(s, a.scale));
      }
      float acc[DHP];
#pragma unroll
      for (int d = 0; d < DHP; ++d) acc[d] = 0.0f;
      float l = 0.0f;
      for (int j = 0; j < a.n; ++j) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + j * DHP);
        const float4* vr = reinterpret_cast<const float4*>(v_s + j * DHP);
        float s = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < DHP / 4; ++d4) {
          const float4 kv = kr[d4];
          s = fmaf(qr[4 * d4], kv.x, s);
          s = fmaf(qr[4 * d4 + 1], kv.y, s);
          s = fmaf(qr[4 * d4 + 2], kv.z, s);
          s = fmaf(qr[4 * d4 + 3], kv.w, s);
        }
        const float p = expf(__fsub_rn(__fmul_rn(s, a.scale), m));
        l = __fadd_rn(l, p);
#pragma unroll
        for (int d4 = 0; d4 < DHP / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      const float inv = __frcp_rn(l);
      float* op = a.o + b * a.o_sb + i * a.o_sn + h * a.dh;
#pragma unroll
      for (int d = 0; d < DHP; ++d)
        if (d < a.dh) op[d] = __fmul_rn(acc[d], inv);
    }
  }
}

template <int DHP>
cudaError_t launch(const Args& a, int warps, cudaStream_t stream) {
  const size_t smem = warps * warp_floats<DHP>(a.n) * sizeof(float);
  static cudaError_t attr = lam_set_smem(short_fwd_f32_kernel<DHP>, 232448);
  if (attr != cudaSuccess) return attr;
  const long long items = static_cast<long long>(a.B) * a.H;
  const int grid = lam_persistent_grid(short_fwd_f32_kernel<DHP>, 32 * warps, smem,
                                       (items + warps - 1) / warps);
  short_fwd_f32_kernel<DHP><<<grid, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: fp32 packed [B, n, H*dh] with element strides (batch, seq) and
// unit stride on H*dh; 8 < n < 128, dh <= 64; warps (1..8) a block, from the
// wrapper's f32_fwd_warps (each holds k and v of one item in n * 2 * DHP
// floats of shared memory, DHP = dh rounded up to 16, 32 or 64). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_short_attention_fwd_f32(const void* q, const void* k, const void* v,
                                           void* o, int B, int H, int n, int dh, int warps,
                                           long long q_sb, long long q_sn, long long k_sb,
                                           long long k_sn, long long v_sb, long long v_sn,
                                           long long o_sb, long long o_sn, float scale,
                                           void* stream) {
  const int dhp = dh <= 16 ? 16 : dh <= 32 ? 32 : 64;
  if (B <= 0 || H <= 0 || n <= 8 || n >= 128 || dh <= 0 || dh > 64 || warps < 1 ||
      warps > MAX_WARPS || static_cast<size_t>(warps) * 2 * n * dhp * sizeof(float) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(o), q_sb, q_sn, k_sb, k_sn,
               v_sb, v_sn, o_sb, o_sn, B, H, n, dh, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (dhp == 16) return static_cast<int>(launch<16>(a, warps, st));
  if (dhp == 32) return static_cast<int>(launch<32>(a, warps, st));
  return static_cast<int>(launch<64>(a, warps, st));
}
