// Attention over short unmasked self-attention axes (8 < n < 128), forward
// and backward, bf16 in / bf16 out, for Hopper (sm_90a).
//
// Replaces K9, lam_slide_tpu/ops/short_attention.py `_short_fwd_kernel` and
// `_short_bwd_kernel` (pallas_calls in `_short_fwd` / `_short_bwd`). The
// TPU design groups G (batch, head) pairs into one [G*n, G*n] matmul with
// block-diagonal masking to fill 128x128 MXU tiles; nothing on the card
// needs that, so it is not carried over.
//
// Design: one warp per (batch, head) pair, up to four warps (heads) of one
// batch row per block. q/k/v/o are read and written through packed
// [B, n, H*dh] strides (batch, seq; unit stride on dh), so the DiT's q/k
// and its v view of linear1's output go in without a relayout copy. The
// warp stages its head's K and V rows (the backward also Q and dO) in
// shared memory as fp32; a lane owns one query row at a time, keeps its q
// row in registers, and writes its row of scores into a per-lane row of
// shared memory (odd row stride: no bank conflicts), so the n x n scores
// never leave the chip. The backward's second pass gives each lane one key
// row, recomputes its column of scores from the saved per-row max, sum and
// delta, and accumulates dK and dV without atomics; nothing O(n^2) reaches
// device memory.
//
// Numerics of `_scores` (short_attention.py:73-80): fp32 logits (bf16
// products are exact in fp32) times the scale, fp32 max / exp / sum, the
// weights p / sum rounded to bf16 for the AV product, fp32 accumulation,
// one rounding of the output. Backward (`_short_bwd_kernel`): dV = bf16(P)^T
// dO, dP = dO V^T, delta = rowsum(P * dP) with P in fp32, dS = P * (dP -
// delta) * scale rounded to bf16, dQ = dS K, dK = dS^T Q, fp32 accumulation.
// The _rn intrinsics keep products from contracting into FMAs where the JAX
// math rounds them.
//
// What bounds it on the H100: at the MD17 temporal shape ([61440, 30, 256],
// 16 heads x dh 16) a call moves ~3.8 GB of q/k/v/o (~1.1 ms at 3.35 TB/s)
// for ~57 GFLOP, which this first version runs as FFMA on the CUDA cores
// (~1 ms at 67 TFLOP/s), one float4 shared-memory broadcast per four FMAs:
// no tensor cores, scalar global loads.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int MAX_WARPS = 4;             // heads of one batch row per block
constexpr size_t SMEM_BUDGET = 96 * 1024;  // per block, to pick the warps
constexpr size_t SMEM_MAX = 160 * 1024;    // the largest a single warp needs

struct Packed {
  const bf16* p;
  long long sb, sn;  // batch and sequence strides, in elements
};

// Shared-memory rows are 16-byte aligned (every per-warp region and every
// [n, DP] tile starts on a multiple of 4 floats), so they are read as
// float4 broadcasts: one load for four FMAs. The sums run in the order
// c = 0 .. DP-1 whichever pass computes them, so both backward passes see
// bit-identical logits.
template <int DP>
__device__ __forceinline__ float dot(const float* a, const float* row) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + c);
    s = fmaf(a[c], r.x, s);
    s = fmaf(a[c + 1], r.y, s);
    s = fmaf(a[c + 2], r.z, s);
    s = fmaf(a[c + 3], r.w, s);
  }
  return s;
}

// acc += w * row over DP values, row in shared memory.
template <int DP>
__device__ __forceinline__ void axpy(float* acc, float w, const float* row) {
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + c);
    acc[c] = fmaf(w, r.x, acc[c]);
    acc[c + 1] = fmaf(w, r.y, acc[c + 1]);
    acc[c + 2] = fmaf(w, r.z, acc[c + 2]);
    acc[c + 3] = fmaf(w, r.w, acc[c + 3]);
  }
}

// Rows [0, n) of head h of batch row b into a [n, DP] fp32 tile, zero for
// columns >= dh.
template <int DP>
__device__ __forceinline__ void stage(float* dst, Packed t, int b, int h, int n, int dh) {
  const int lane = threadIdx.x % 32;
  const bf16* src = t.p + b * t.sb + static_cast<long long>(h) * dh;
  for (int idx = lane; idx < n * DP; idx += 32) {
    const int r = idx / DP, c = idx % DP;
    dst[idx] = c < dh ? __bfloat162float(src[r * t.sn + c]) : 0.0f;
  }
}

template <int DP>
__device__ __forceinline__ void store_row(const float* acc, bf16* dst, int dh) {
#pragma unroll
  for (int c = 0; c < DP; ++c)
    if (c < dh) dst[c] = __float2bfloat16(acc[c]);
}

// Scores of one query row against all n keys into srow, as fp32 softmax
// weights p / sum; returns (max, sum) through m and l.
template <int DP>
__device__ __forceinline__ void softmax_row(const float* qr, const float* Ks, int n,
                                            float scale, float* srow, float& m, float& l) {
  m = -CUDART_INF_F;
#pragma unroll 4  // independent dot products in flight; each sums in order
  for (int j = 0; j < n; ++j) {
    const float s = __fmul_rn(dot<DP>(qr, Ks + j * DP), scale);
    srow[j] = s;
    m = fmaxf(m, s);
  }
  l = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float p = expf(srow[j] - m);
    srow[j] = p;
    l += p;
  }
#pragma unroll 4
  for (int j = 0; j < n; ++j) srow[j] = __fdiv_rn(srow[j], l);
}

template <int DP>
__host__ __device__ inline size_t fwd_warp_floats(int n) {
  return 2 * static_cast<size_t>(n) * DP + 32 * static_cast<size_t>(n | 1);
}

template <int DP>
__host__ __device__ inline size_t bwd_warp_floats(int n) {  // a multiple of 4
  return (4 * static_cast<size_t>(n) * DP + 3 * static_cast<size_t>(n) +
          32 * static_cast<size_t>(n | 1) + 3) & ~static_cast<size_t>(3);
}

template <int DP>
__global__ void short_fwd_kernel(Packed q, Packed k, Packed v, bf16* __restrict__ o,
                                 long long o_sb, long long o_sn, int H, int n, int dh,
                                 float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x, h = blockIdx.y * (blockDim.x / 32) + warp;
  if (h >= H) return;  // no block-wide barrier follows
  float* Ks = smem + warp * fwd_warp_floats<DP>(n);
  float* Vs = Ks + n * DP;
  float* srow = Vs + n * DP + lane * (n | 1);
  stage<DP>(Ks, k, b, h, n, dh);
  stage<DP>(Vs, v, b, h, n, dh);
  __syncwarp();

  const bf16* qp = q.p + b * q.sb + static_cast<long long>(h) * dh;
  for (int i = lane; i < n; i += 32) {
    float qr[DP], acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      qr[c] = c < dh ? __bfloat162float(qp[i * q.sn + c]) : 0.0f;
      acc[c] = 0.0f;
    }
    float m, l;
    softmax_row<DP>(qr, Ks, n, scale, srow, m, l);
    for (int j = 0; j < n; ++j) axpy<DP>(acc, lam_round_bf16(srow[j]), Vs + j * DP);
    store_row<DP>(acc, o + b * o_sb + i * o_sn + static_cast<long long>(h) * dh, dh);
  }
}

template <int DP>
__global__ void short_bwd_kernel(Packed q, Packed k, Packed v, Packed g, bf16* __restrict__ dq,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, long long o_sb,
                                 long long o_sn, int H, int n, int dh, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x, h = blockIdx.y * (blockDim.x / 32) + warp;
  if (h >= H) return;  // no block-wide barrier follows
  float* Qs = smem + warp * bwd_warp_floats<DP>(n);
  float* Ks = Qs + n * DP;
  float* Vs = Ks + n * DP;
  float* dOs = Vs + n * DP;
  float* Ms = dOs + n * DP;  // per query row: max, sum, delta
  float* Ls = Ms + n;
  float* Ds = Ls + n;
  float* srow = Ds + n + lane * (n | 1);
  stage<DP>(Qs, q, b, h, n, dh);
  stage<DP>(Ks, k, b, h, n, dh);
  stage<DP>(Vs, v, b, h, n, dh);
  stage<DP>(dOs, g, b, h, n, dh);
  __syncwarp();
  const long long off = static_cast<long long>(h) * dh;

  // pass 1, a lane per query row i: P, delta_i, dS and dQ_i = dS K
  for (int i = lane; i < n; i += 32) {
    const float* qr = Qs + i * DP;
    const float* dor = dOs + i * DP;
    float m, l;
    softmax_row<DP>(qr, Ks, n, scale, srow, m, l);
    float delta = 0.0f;
    for (int j = 0; j < n; ++j) delta = fmaf(srow[j], dot<DP>(dor, Vs + j * DP), delta);
    Ms[i] = m;
    Ls[i] = l;
    Ds[i] = delta;
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float dp = dot<DP>(dor, Vs + j * DP);
      const float ds =
          lam_round_bf16(__fmul_rn(__fmul_rn(srow[j], __fsub_rn(dp, delta)), scale));
      axpy<DP>(acc, ds, Ks + j * DP);
    }
    store_row<DP>(acc, dq + b * o_sb + i * o_sn + off, dh);
  }
  __syncwarp();

  // pass 2, a lane per key row j: the column of P and dS recomputed from the
  // saved row statistics; dK_j = dS^T Q, dV_j = bf16(P)^T dO
  for (int j = lane; j < n; j += 32) {
    const float* kr = Ks + j * DP;
    const float* vr = Vs + j * DP;
    float dk_acc[DP], dv_acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) dk_acc[c] = dv_acc[c] = 0.0f;
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const float s = __fmul_rn(dot<DP>(Qs + i * DP, kr), scale);
      const float w = __fdiv_rn(expf(s - Ms[i]), Ls[i]);
      const float dp = dot<DP>(dOs + i * DP, vr);
      const float ds = lam_round_bf16(__fmul_rn(__fmul_rn(w, __fsub_rn(dp, Ds[i])), scale));
      axpy<DP>(dk_acc, ds, Qs + i * DP);
      axpy<DP>(dv_acc, lam_round_bf16(w), dOs + i * DP);
    }
    store_row<DP>(dk_acc, dk + b * o_sb + j * o_sn + off, dh);
    store_row<DP>(dv_acc, dv + b * o_sb + j * o_sn + off, dh);
  }
}

// Warps (heads) per block under the shared-memory budget, and the bytes.
int warps_for(size_t warp_floats, int H, size_t* bytes) {
  const size_t per_warp = warp_floats * sizeof(float);
  int w = static_cast<int>(SMEM_BUDGET / per_warp);
  w = w < 1 ? 1 : (w > MAX_WARPS ? MAX_WARPS : w);
  if (w > H) w = H;
  *bytes = per_warp * w;
  return w;
}

template <int DP>
cudaError_t launch_fwd(Packed q, Packed k, Packed v, bf16* o, long long o_sb, long long o_sn,
                       int B, int H, int n, int dh, float scale, cudaStream_t stream) {
  static cudaError_t attr = lam_set_smem(short_fwd_kernel<DP>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  size_t bytes;
  const int w = warps_for(fwd_warp_floats<DP>(n), H, &bytes);
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  dim3 grid(B, (H + w - 1) / w);
  short_fwd_kernel<DP><<<grid, 32 * w, bytes, stream>>>(q, k, v, o, o_sb, o_sn, H, n, dh, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(Packed q, Packed k, Packed v, Packed g, bf16* dq, bf16* dk, bf16* dv,
                       long long o_sb, long long o_sn, int B, int H, int n, int dh, float scale,
                       cudaStream_t stream) {
  static cudaError_t attr = lam_set_smem(short_bwd_kernel<DP>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  size_t bytes;
  const int w = warps_for(bwd_warp_floats<DP>(n), H, &bytes);
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  dim3 grid(B, (H + w - 1) / w);
  short_bwd_kernel<DP><<<grid, 32 * w, bytes, stream>>>(q, k, v, g, dq, dk, dv, o_sb, o_sn, H,
                                                        n, dh, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int n, int dh) {
  return B <= 0 || H <= 0 || n <= 8 || n >= 128 || dh <= 0 || dh > 64;
}

Packed packed(const void* p, long long sb, long long sn) {
  return Packed{static_cast<const bf16*>(p), sb, sn};
}

}  // namespace

// q/k/v: bf16 [B, n, H*dh] addressed through element strides (batch, seq),
// unit stride on the last axis; o: bf16 [B, n, H*dh] with strides (o_sb,
// o_sn). 8 < n < 128, dh <= 64. Returns cudaGetLastError().
extern "C" int lam_short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int n, int dh, long long q_sb,
                                       long long q_sn, long long k_sb, long long k_sn,
                                       long long v_sb, long long v_sn, long long o_sb,
                                       long long o_sn, float scale, void* stream) {
  if (bad_shape(B, H, n, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Packed qp = packed(q, q_sb, q_sn), kp = packed(k, k_sb, k_sn),
               vp = packed(v, v_sb, v_sn);
  auto ob = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 16)
    err = launch_fwd<16>(qp, kp, vp, ob, o_sb, o_sn, B, H, n, dh, scale, st);
  else if (dh <= 32)
    err = launch_fwd<32>(qp, kp, vp, ob, o_sb, o_sn, B, H, n, dh, scale, st);
  else
    err = launch_fwd<64>(qp, kp, vp, ob, o_sb, o_sn, B, H, n, dh, scale, st);
  return static_cast<int>(err);
}

// q/k/v/g (the output gradient): bf16 [B, n, H*dh] through (batch, seq)
// strides given in `strides` in the order q, k, v, g (8 values); dq/dk/dv:
// bf16 [B, n, H*dh] sharing the strides (o_sb, o_sn). Returns
// cudaGetLastError().
extern "C" int lam_short_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv, int B,
                                       int H, int n, int dh, const long long* strides,
                                       long long o_sb, long long o_sn, float scale,
                                       void* stream) {
  if (bad_shape(B, H, n, dh)) return static_cast<int>(cudaErrorInvalidValue);
  const Packed qp = packed(q, strides[0], strides[1]), kp = packed(k, strides[2], strides[3]),
               vp = packed(v, strides[4], strides[5]), gp = packed(g, strides[6], strides[7]);
  auto dqb = static_cast<bf16*>(dq);
  auto dkb = static_cast<bf16*>(dk);
  auto dvb = static_cast<bf16*>(dv);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 16)
    err = launch_bwd<16>(qp, kp, vp, gp, dqb, dkb, dvb, o_sb, o_sn, B, H, n, dh, scale, st);
  else if (dh <= 32)
    err = launch_bwd<32>(qp, kp, vp, gp, dqb, dkb, dvb, o_sb, o_sn, B, H, n, dh, scale, st);
  else
    err = launch_bwd<64>(qp, kp, vp, gp, dqb, dkb, dvb, o_sb, o_sn, B, H, n, dh, scale, st);
  return static_cast<int>(err);
}
