// Per-head QK RMS-norm + RoPE for Hopper (sm_90a), written once: raw q and
// k in, contiguous transformed q_t and k_t out, in bf16 (the training and
// sampling DiT) or fp32 (the fp32 sampling DiT of the MD17 --test pass and
// the 4AA eval).
//
// Part of the port of K5, lam_slide_tpu/ops/flash_normrope.py
// `_nr_flash_kernel`, and of K6, `_nr_bwd_kv_kernel` / `_nr_bwd_q_kernel`:
// the TPU kernels norm and rotate every q and k tile inside the flash loop.
// Here the transform runs once, before the attention kernels of
// flash_fwd_sm90.cu and flash_bwd_sm90.cu (bf16) or the fp32 K1 kernel of
// flash_attention.cu, which read q_t and k_t; the bf16 forward's caller
// keeps them for the backward, so the backward never transforms again. On
// those kernels a K tile is shared by the query rows of two consumer
// warpgroups and every Q tile is walked by each key block, so a transform
// inside the tiles would be redone 8 to 16 times a tile at N = 1000, on the
// consumers' critical path.
//
// One launch transforms q and k. Rows of q (B*H*Nq) come first, then rows
// of k (B*H*Nk); a warp takes one row of dh values, lane l the elements
// [4l, 4l + 4) (two (even, odd) pairs), so dh <= 128. q and k are read
// through their (batch, head, seq) element strides, so head-major views of
// the DiT's packed linear1 output go in without a copy; when dh % 4 == 0 and
// the bases and strides allow, each lane moves its four values with one
// load and one store (8 bytes in bf16, 16 in fp32), otherwise element by
// element. Row n of q or k takes row n of cos/sin, as `pre_transform`
// slices the tables.
//
// Rounding points of the plain headmajor_rope(headmajor_rmsnorm(x)), as
// lam_rmsnorm_rope in common.cuh: fp32 sum of squares (a shuffle reduction,
// in another order than PyTorch's), / dh + eps, rsqrtf; x * rr * scale
// (rounded to bf16 in bf16; no rounding in fp32); the rotation of each
// (even, odd) pair in fp32 by cos/sin, rounded to the element type. The _rn
// intrinsics keep the compiler from contracting products into FMAs that
// the separate PyTorch ops do not have.
//
// What bounds it on the H100: bytes. q and k read once and written once,
// plus the tables (read through L2): in bf16 ~49 MB and ~0.015 ms at
// [16,3,1000,128]; in fp32 ~1.51 GB and ~0.45 ms at MD17's temporal
// [12288,2,30,128], as many bytes as the attention that follows.

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;

template <typename T>
struct Args {
  const T* src[2];         // raw q, k
  T* dst[2];               // q_t, k_t: contiguous [B, H, N, dh]
  const float* scale[2];   // the learned [dh] scales of q and k
  const float *cos, *sin;  // [>= max(Nq, Nk), dh/2], row-major
  long long s[2][3];       // (batch, head, seq) element strides of q and k
  long long rows_q, rows;  // B*H*Nq, B*H*(Nq + Nk)
  int H, n[2], dh;
  float eps;
};

// Four consecutive elements of a row in one access: 8 bytes of bf16, 16 of
// fp32.
__device__ __forceinline__ void load4(const bf16* p, float x[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  x[0] = raw.x;
  x[1] = raw.y;
  x[2] = raw.z;
  x[3] = raw.w;
}

__device__ __forceinline__ void store4(bf16* p, const float y[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store4(float* p, const float y[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
}

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
// The normed value's rounding to the element type (headmajor_rmsnorm's
// `.to(x.dtype)`): to bf16, or none in fp32.
__device__ __forceinline__ float round_to(const bf16*, float v) { return lam_round_bf16(v); }
__device__ __forceinline__ float round_to(const float*, float v) { return v; }

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) qk_normrope_kernel(const Args<T> a) {
  const long long row = static_cast<long long>(blockIdx.x) * NWARPS + threadIdx.x / 32;
  if (row >= a.rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int t = row >= a.rows_q;  // 0: q, 1: k
  const long long r = t ? row - a.rows_q : row;
  const long long bh = r / a.n[t];
  const int n = static_cast<int>(r % a.n[t]);
  const long long b = bh / a.H, h = bh % a.H;
  const T* src = a.src[t] + b * a.s[t][0] + h * a.s[t][1] + n * a.s[t][2];
  T* dst = a.dst[t] + r * a.dh;
  const int e0 = 4 * lane;

  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (VEC) {
    if (e0 < a.dh) load4(src + e0, x);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + j < a.dh) x[j] = to_float(src[e0 + j]);
  }

  float ss = __fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1]));
  ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x[2], x[2]), __fmul_rn(x[3], x[3])));
  ss = lam_warp_sum(ss);
  const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(a.dh)), a.eps));

  const float* scale = a.scale[t];
  const long long tab = static_cast<long long>(n) * (a.dh / 2);
  float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int e = e0 + 2 * p;
    if (e >= a.dh) break;
    const float na = round_to(dst, __fmul_rn(__fmul_rn(x[2 * p], rr), scale[e]));
    const float nb = round_to(dst, __fmul_rn(__fmul_rn(x[2 * p + 1], rr), scale[e + 1]));
    const float c = a.cos[tab + e / 2], s = a.sin[tab + e / 2];
    y[2 * p] = __fsub_rn(__fmul_rn(c, na), __fmul_rn(s, nb));
    y[2 * p + 1] = __fadd_rn(__fmul_rn(s, na), __fmul_rn(c, nb));
    if constexpr (!VEC) {
      put(dst + e, y[2 * p]);
      put(dst + e + 1, y[2 * p + 1]);
    }
  }
  if constexpr (VEC) {
    if (e0 < a.dh) store4(dst + e0, y);
  }
}

// Whether a view moves in 4-element pieces: a base address on 4 elements'
// bytes and every stride of an axis longer than 1 a multiple of 4 elements.
bool vec_ok(const void* p, size_t elem, const long long* s, const int* sizes) {
  if (reinterpret_cast<unsigned long long>(p) % (4 * elem)) return false;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && s[i] % 4) return false;
  return true;
}

template <typename T>
int run(const void* q, const void* k, void* q_t, void* k_t, const void* qs, const void* ks,
        const void* cos, const void* sin, int B, int H, int Nq, int Nk, int dh, long long q_sb,
        long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
        float eps, void* stream) {
  if (dh <= 0 || dh > 128 || dh % 2 || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args<T> a{};
  a.src[0] = static_cast<const T*>(q);
  a.src[1] = static_cast<const T*>(k);
  a.dst[0] = static_cast<T*>(q_t);
  a.dst[1] = static_cast<T*>(k_t);
  a.scale[0] = static_cast<const float*>(qs);
  a.scale[1] = static_cast<const float*>(ks);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  const long long s[2][3] = {{q_sb, q_sh, q_sn}, {k_sb, k_sh, k_sn}};
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j) a.s[i][j] = s[i][j];
  a.H = H;
  a.n[0] = Nq;
  a.n[1] = Nk;
  a.dh = dh;
  a.eps = eps;
  a.rows_q = static_cast<long long>(B) * H * Nq;
  a.rows = a.rows_q + static_cast<long long>(B) * H * Nk;
  const long long blocks = (a.rows + NWARPS - 1) / NWARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int q_sizes[3] = {B, H, Nq}, k_sizes[3] = {B, H, Nk};
  constexpr size_t E = sizeof(T);
  const bool vec = dh % 4 == 0 && vec_ok(q, E, s[0], q_sizes) && vec_ok(k, E, s[1], k_sizes) &&
                   reinterpret_cast<unsigned long long>(q_t) % (4 * E) == 0 &&
                   reinterpret_cast<unsigned long long>(k_t) % (4 * E) == 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    qk_normrope_kernel<T, true><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  else
    qk_normrope_kernel<T, false><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Nq, dh] and k [B, H, Nk, dh]: bf16 addressed through element
// strides (batch, head, seq), unit stride on dh; q_t and k_t: contiguous bf16
// outputs of the same shapes (4-byte aligned, as every allocation is); qs/ks:
// fp32 [dh]; cos/sin: fp32 [>= max(Nq, Nk), dh/2] row-major. dh even and
// <= 128. Returns cudaGetLastError(), or cudaErrorInvalidValue for inputs it
// does not take.
extern "C" int lam_qk_normrope(const void* q, const void* k, void* q_t, void* k_t,
                               const void* qs, const void* ks, const void* cos, const void* sin,
                               int B, int H, int Nq, int Nk, int dh, long long q_sb,
                               long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                               long long k_sn, float eps, void* stream) {
  return run<bf16>(q, k, q_t, k_t, qs, ks, cos, sin, B, H, Nq, Nk, dh, q_sb, q_sh, q_sn, k_sb,
                   k_sh, k_sn, eps, stream);
}

// As lam_qk_normrope on fp32 q/k and fp32 q_t/k_t (8-byte aligned, as every
// allocation is).
extern "C" int lam_qk_normrope_f32(const void* q, const void* k, void* q_t, void* k_t,
                                   const void* qs, const void* ks, const void* cos,
                                   const void* sin, int B, int H, int Nq, int Nk, int dh,
                                   long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                                   long long k_sh, long long k_sn, float eps, void* stream) {
  return run<float>(q, k, q_t, k_t, qs, ks, cos, sin, B, H, Nq, Nk, dh, q_sb, q_sh, q_sn, k_sb,
                    k_sh, k_sn, eps, stream);
}
