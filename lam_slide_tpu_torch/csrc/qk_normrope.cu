// Per-head QK RMS-norm + RoPE for Hopper (sm_90a), written once: raw bf16 q
// and k in, contiguous transformed q_t and k_t out.
//
// Part of the port of K5, lam_slide_tpu/ops/flash_normrope.py
// `_nr_flash_kernel`, and of K6, `_nr_bwd_kv_kernel` / `_nr_bwd_q_kernel`:
// the TPU kernels norm and rotate every q and k tile inside the flash loop.
// Here the transform runs once, before the attention kernels of
// flash_fwd_sm90.cu and flash_bwd_sm90.cu, which read q_t and k_t; the
// forward's caller keeps them for the backward, so the backward never
// transforms again. On those kernels a K tile is shared by the query rows
// of two consumer warpgroups and every Q tile is walked by each key block,
// so a transform inside the tiles would be redone 8 to 16 times a tile at
// N = 1000, on the consumers' critical path.
//
// One launch transforms q and k. Rows of q (B*H*Nq) come first, then rows
// of k (B*H*Nk); a warp takes one row of dh values, lane l the elements
// [4l, 4l + 4) (two (even, odd) pairs), so dh <= 128. q and k are read
// through their (batch, head, seq) element strides, so head-major views of
// the DiT's packed linear1 output go in without a copy; when dh % 4 == 0 and
// the bases and strides allow, each lane moves its four values with one
// 8-byte load and one 8-byte store, otherwise element by element. Row n of
// q or k takes row n of cos/sin, as `pre_transform` slices the tables.
//
// Rounding points of the plain headmajor_rope(headmajor_rmsnorm(x)), as
// lam_rmsnorm_rope in common.cuh: fp32 sum of squares (a shuffle reduction,
// in another order than PyTorch's), / dh + eps, rsqrtf; x * rr * scale
// rounded to bf16; the rotation of each (even, odd) pair in fp32 by cos/sin,
// rounded to bf16. The _rn intrinsics keep the compiler from contracting
// products into FMAs that the separate PyTorch ops do not have.
//
// What bounds it on the H100: bytes. q and k read once and written once,
// 2 bytes an element each way, plus the tables (read through L2): ~49 MB
// and ~0.015 ms at [16,3,1000,128].

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;

struct Args {
  const bf16* src[2];      // raw q, k
  bf16* dst[2];            // q_t, k_t: contiguous [B, H, N, dh]
  const float* scale[2];   // the learned [dh] scales of q and k
  const float *cos, *sin;  // [>= max(Nq, Nk), dh/2], row-major
  long long s[2][3];       // (batch, head, seq) element strides of q and k
  long long rows_q, rows;  // B*H*Nq, B*H*(Nq + Nk)
  int H, n[2], dh;
  float eps;
};

template <bool VEC>
__global__ void __launch_bounds__(THREADS) qk_normrope_kernel(const Args a) {
  const long long row = static_cast<long long>(blockIdx.x) * NWARPS + threadIdx.x / 32;
  if (row >= a.rows) return;  // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int t = row >= a.rows_q;  // 0: q, 1: k
  const long long r = t ? row - a.rows_q : row;
  const long long bh = r / a.n[t];
  const int n = static_cast<int>(r % a.n[t]);
  const long long b = bh / a.H, h = bh % a.H;
  const bf16* src = a.src[t] + b * a.s[t][0] + h * a.s[t][1] + n * a.s[t][2];
  bf16* dst = a.dst[t] + r * a.dh;
  const int e0 = 4 * lane;

  float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (VEC) {
    if (e0 < a.dh) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src + e0);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      x[0] = lo.x;
      x[1] = lo.y;
      x[2] = hi.x;
      x[3] = hi.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + j < a.dh) x[j] = __bfloat162float(src[e0 + j]);
  }

  float ss = __fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1]));
  ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(x[2], x[2]), __fmul_rn(x[3], x[3])));
  ss = lam_warp_sum(ss);
  const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(a.dh)), a.eps));

  const float* scale = a.scale[t];
  const long long tab = static_cast<long long>(n) * (a.dh / 2);
  __nv_bfloat162 y[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int e = e0 + 2 * p;
    if (e >= a.dh) break;
    const float na = lam_round_bf16(__fmul_rn(__fmul_rn(x[2 * p], rr), scale[e]));
    const float nb = lam_round_bf16(__fmul_rn(__fmul_rn(x[2 * p + 1], rr), scale[e + 1]));
    const float c = a.cos[tab + e / 2], s = a.sin[tab + e / 2];
    y[p].x = __float2bfloat16(__fsub_rn(__fmul_rn(c, na), __fmul_rn(s, nb)));
    y[p].y = __float2bfloat16(__fadd_rn(__fmul_rn(s, na), __fmul_rn(c, nb)));
    if constexpr (!VEC) *reinterpret_cast<__nv_bfloat162*>(dst + e) = y[p];
  }
  if constexpr (VEC) {
    if (e0 < a.dh) {
      uint2 raw;
      raw.x = *reinterpret_cast<const unsigned*>(&y[0]);
      raw.y = *reinterpret_cast<const unsigned*>(&y[1]);
      *reinterpret_cast<uint2*>(dst + e0) = raw;
    }
  }
}

// Whether a view moves in 8-byte pieces: a base address on 8 bytes and every
// stride of an axis longer than 1 a multiple of 4 elements.
bool vec_ok(const void* p, const long long* s, const int* sizes) {
  if (reinterpret_cast<unsigned long long>(p) % 8) return false;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && s[i] % 4) return false;
  return true;
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
  if (dh <= 0 || dh > 128 || dh % 2 || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.src[0] = static_cast<const bf16*>(q);
  a.src[1] = static_cast<const bf16*>(k);
  a.dst[0] = static_cast<bf16*>(q_t);
  a.dst[1] = static_cast<bf16*>(k_t);
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
  const bool vec = dh % 4 == 0 && vec_ok(q, s[0], q_sizes) && vec_ok(k, s[1], k_sizes) &&
                   reinterpret_cast<unsigned long long>(q_t) % 8 == 0 &&
                   reinterpret_cast<unsigned long long>(k_t) % 8 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    qk_normrope_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  else
    qk_normrope_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
