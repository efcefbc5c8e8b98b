// Attention over short unmasked self-attention axes (8 < n < 128), forward
// and backward, fp32 in / fp32 out, for Hopper (sm_90a), on the FP32 pipes
// (FFMA; no tensor cores, so no TF32).
//
// Replaces the fp32 instances of the Pallas TPU kernels
// lam_slide_tpu/ops/short_attention.py `_short_fwd_kernel` and
// `_short_bwd_kernel`, which the fp32 DiT of the MD17 test pass (forward)
// and the fp32 stage-2 training of both registries (forward and backward)
// run on their temporal axis (T = 30, or 16 at the 4AA smoke width).
// Numerics of `_scores` (short_attention.py:73-80) in fp32: logits q k^T *
// scale in fp32, the softmax in fp32 (its `astype(v.dtype)` of the weights
// is a no-op), fp32 accumulation of the AV product; the backward's
// `astype` roundings of P and dS are no-ops in fp32 too.
//
// Forward design: a warp owns one (batch row, head) item at a time and
// walks the items with a grid stride. It stages the item's k and v ([n, dh],
// read through packed [B, n, H*dh] strides with unit stride on dh, so the
// DiT's q/k and its v view of linear1's output go in without a copy) in its
// own shared-memory slab, zero-padded to DHP columns; each lane takes query
// rows lane, lane + 32, ... with its q row and output accumulator in
// registers. Per query row, two passes over the keys: the row max of the
// logits, then p = exp(s - max), its sum and sum p v (the logits computed
// again: n * dh FFMAs a pass, a few hundred at MD17's n 30, dh 16); the
// output is that sum over the sum of p. Every lane of a warp reads the same
// k/v element at once (a broadcast, 16 bytes a load). No atomics: a result
// repeats bit for bit.
//
// Backward design: the same warp-an-item walk, with q, k, v and dO of the
// item in the warp's slab (4 n DHP floats) and three row statistics (max,
// 1 / sum, delta; 3 n floats). dQ sums over keys and dK, dV over queries,
// so the item takes two passes in which a lane owns different rows, and no
// lane ever adds into another's output (no atomics, a result repeats bit
// for bit):
// - query pass, a lane a query row i: the row max of the logits; then
//   e = exp(s - max), l = sum e and sum e dP (dP = dO_i . v_j), so
//   delta_i = rowsum(P * dP) = (sum e dP) / l; then dQ_i = sum_j dS_ij k_j
//   with P recomputed and dS = P (dP - delta) * scale. The statistics go to
//   the slab;
// - key pass, a lane a key row j with k_j, v_j, dK_j and dV_j in registers:
//   over the queries i, P_ij = exp(s - max_i) / l_i and dP_ij again from the
//   statistics, dV_j += P_ij dO_i, dK_j += dS_ij q_i.
// The logits are formed four times and dP three (no n x n buffer), so it
// does ~10 n^2 dh FMAs an item; every lane reads the same q/dO (key pass)
// or k/v (query pass) row at once, a broadcast. At dh 64 the key pass's
// four register rows spill to local memory, as K4's fp32 pair's do there.
//
// What bounds them on the H100: at [12288, 30, 256] with 16 heads x dh 16
// the forward moves 4 x 377 MB of q/k/v/o (0.45 ms at 3.35 TB/s) for ~23
// GFLOP of FFMA: bytes; the backward moves 7 x 377 MB (0.79 ms) for ~57
// GFLOP (0.85 ms at 67 TFLOP/s): operations, by a little.

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


struct BwdArgs {
  const float *q, *k, *v, *g;
  float *dq, *dk, *dv;
  long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, g_sb, g_sn, o_sb, o_sn;
  int B, H, n, dh;
  float scale;
};

// Shared memory of a backward warp: q, k, v and dO of one item (n rows of
// DHP floats each), then its row max, 1 / row sum and delta (n each, the
// three rounded up to a multiple of 4 floats so every slab stays 16-byte
// aligned).
__host__ __device__ constexpr size_t bwd_stats_floats(int n) {
  return 3 * ((static_cast<size_t>(n) + 3) & ~static_cast<size_t>(3));
}
template <int DHP>
__host__ __device__ constexpr size_t bwd_warp_floats(int n) {
  return 4 * static_cast<size_t>(n) * DHP + bwd_stats_floats(n);
}

template <int DHP>
__device__ __forceinline__ float dot_row(const float (&r)[DHP], const float* row) {
  const float4* p = reinterpret_cast<const float4*>(row);
  float s = 0.0f;
#pragma unroll
  for (int d4 = 0; d4 < DHP / 4; ++d4) {
    const float4 x = p[d4];
    s = fmaf(r[4 * d4], x.x, s);
    s = fmaf(r[4 * d4 + 1], x.y, s);
    s = fmaf(r[4 * d4 + 2], x.z, s);
    s = fmaf(r[4 * d4 + 3], x.w, s);
  }
  return s;
}

// acc += w * row over DHP columns (row 16-byte aligned in shared memory).
template <int DHP>
__device__ __forceinline__ void axpy_row(float (&acc)[DHP], float w, const float* row) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int d4 = 0; d4 < DHP / 4; ++d4) {
    const float4 x = p[d4];
    acc[4 * d4] = fmaf(w, x.x, acc[4 * d4]);
    acc[4 * d4 + 1] = fmaf(w, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(w, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(w, x.w, acc[4 * d4 + 3]);
  }
}

template <int DHP>
__device__ __forceinline__ void load_row(float (&r)[DHP], const float* row) {
#pragma unroll
  for (int d = 0; d < DHP; ++d) r[d] = row[d];
}

template <int DHP>
__device__ __forceinline__ void store_row(float* out, const float (&r)[DHP], int dh) {
#pragma unroll
  for (int d = 0; d < DHP; ++d)
    if (d < dh) out[d] = r[d];
}

template <int DHP>
__global__ void short_bwd_f32_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wpb = blockDim.x / 32;
  const int n = a.n;
  float* q_s = reinterpret_cast<float*>(smem4) + warp * bwd_warp_floats<DHP>(n);
  float* k_s = q_s + n * DHP;
  float* v_s = k_s + n * DHP;
  float* g_s = v_s + n * DHP;
  float* m_s = g_s + n * DHP;
  float* il_s = m_s + n;
  float* de_s = il_s + n;
  const long long items = static_cast<long long>(a.B) * a.H;
  for (long long item = static_cast<long long>(blockIdx.x) * wpb + warp; item < items;
       item += static_cast<long long>(gridDim.x) * wpb) {
    const long long b = item / a.H;
    const int h = static_cast<int>(item % a.H);
    __syncwarp();  // the previous item's operands and statistics are consumed
    for (int idx = lane; idx < n * DHP; idx += 32) {
      const int j = idx / DHP, d = idx % DHP;
      const bool in = d < a.dh;
      const long long col = h * a.dh + d;
      q_s[idx] = in ? a.q[b * a.q_sb + j * a.q_sn + col] : 0.0f;
      k_s[idx] = in ? a.k[b * a.k_sb + j * a.k_sn + col] : 0.0f;
      v_s[idx] = in ? a.v[b * a.v_sb + j * a.v_sn + col] : 0.0f;
      g_s[idx] = in ? a.g[b * a.g_sb + j * a.g_sn + col] : 0.0f;
    }
    __syncwarp();

    // query pass: a lane a query row
    for (int i = lane; i < n; i += 32) {
      float qr[DHP], gr[DHP];
      load_row<DHP>(qr, q_s + i * DHP);
      load_row<DHP>(gr, g_s + i * DHP);
      float m = -CUDART_INF_F;
      for (int j = 0; j < n; ++j) m = fmaxf(m, __fmul_rn(dot_row<DHP>(qr, k_s + j * DHP), a.scale));
      float l = 0.0f, edp = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float e = expf(__fsub_rn(__fmul_rn(dot_row<DHP>(qr, k_s + j * DHP), a.scale), m));
        l = __fadd_rn(l, e);
        edp = fmaf(e, dot_row<DHP>(gr, v_s + j * DHP), edp);
      }
      const float il = __frcp_rn(l);
      const float delta = __fmul_rn(edp, il);
      float acc[DHP];
#pragma unroll
      for (int d = 0; d < DHP; ++d) acc[d] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float s = __fmul_rn(dot_row<DHP>(qr, k_s + j * DHP), a.scale);
        const float p = __fmul_rn(expf(__fsub_rn(s, m)), il);
        const float dp = dot_row<DHP>(gr, v_s + j * DHP);
        axpy_row<DHP>(acc, __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), a.scale), k_s + j * DHP);
      }
      store_row<DHP>(a.dq + b * a.o_sb + i * a.o_sn + h * a.dh, acc, a.dh);
      m_s[i] = m;
      il_s[i] = il;
      de_s[i] = delta;
    }
    __syncwarp();

    // key pass: a lane a key row
    for (int j = lane; j < n; j += 32) {
      float kr[DHP], vr[DHP], dk[DHP], dv[DHP];
      load_row<DHP>(kr, k_s + j * DHP);
      load_row<DHP>(vr, v_s + j * DHP);
#pragma unroll
      for (int d = 0; d < DHP; ++d) dk[d] = dv[d] = 0.0f;
      for (int i = 0; i < n; ++i) {
        const float s = __fmul_rn(dot_row<DHP>(kr, q_s + i * DHP), a.scale);
        const float p = __fmul_rn(expf(__fsub_rn(s, m_s[i])), il_s[i]);
        const float dp = dot_row<DHP>(vr, g_s + i * DHP);
        axpy_row<DHP>(dv, p, g_s + i * DHP);
        axpy_row<DHP>(dk, __fmul_rn(__fmul_rn(p, __fsub_rn(dp, de_s[i])), a.scale),
                      q_s + i * DHP);
      }
      store_row<DHP>(a.dk + b * a.o_sb + j * a.o_sn + h * a.dh, dk, a.dh);
      store_row<DHP>(a.dv + b * a.o_sb + j * a.o_sn + h * a.dh, dv, a.dh);
    }
  }
}

template <int DHP>
cudaError_t launch_bwd(const BwdArgs& a, int warps, cudaStream_t stream) {
  const size_t smem = warps * bwd_warp_floats<DHP>(a.n) * sizeof(float);
  static cudaError_t attr = lam_set_smem(short_bwd_f32_kernel<DHP>, 232448);
  if (attr != cudaSuccess) return attr;
  const long long items = static_cast<long long>(a.B) * a.H;
  const int grid = lam_persistent_grid(short_bwd_f32_kernel<DHP>, 32 * warps, smem,
                                       (items + warps - 1) / warps);
  short_bwd_f32_kernel<DHP><<<grid, 32 * warps, smem, stream>>>(a);
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

// The backward: q, k, v, g (the output gradient, in q's dtype) fp32 packed
// [B, n, H*dh] with element strides (batch, seq) in `strides` in the order
// q, k, v, g (8 values) and unit stride on H*dh; dq, dk, dv fp32 packed
// [B, n, H*dh] sharing the strides (o_sb, o_sn); 8 < n < 128, dh <= 64;
// warps (1..8) a block, from the wrapper's f32_bwd_warps (each holds q, k, v
// and g of one item and three row statistics: 4 n DHP + 3 n4 floats, n4 =
// n rounded up to a multiple of 4).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it does not
// take.
extern "C" int lam_short_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* g, void* dq, void* dk, void* dv, int B,
                                           int H, int n, int dh, int warps,
                                           const long long* strides, long long o_sb,
                                           long long o_sn, float scale, void* stream) {
  const int dhp = dh <= 16 ? 16 : dh <= 32 ? 32 : 64;
  if (B <= 0 || H <= 0 || n <= 8 || n >= 128 || dh <= 0 || dh > 64 || warps < 1 ||
      warps > MAX_WARPS ||
      static_cast<size_t>(warps) * (4 * n * dhp + bwd_stats_floats(n)) * sizeof(float) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(g),
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                  strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
                  strides[6], strides[7], o_sb, o_sn, B, H, n, dh, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (dhp == 16) return static_cast<int>(launch_bwd<16>(a, warps, st));
  if (dhp == 32) return static_cast<int>(launch_bwd<32>(a, warps, st));
  return static_cast<int>(launch_bwd<64>(a, warps, st));
}
