// FlashAttention-2 backward for Hopper (sm_90a) on the first tensor-core
// template: bf16 in / bf16 out with a key-padding bias row, and an fp32 in /
// fp32 out pair of kernels with an optional bias.
//
// Replaces variants of the Pallas TPU kernels of K4,
// lam_slide_tpu/ops/flash_attention.py `_flash_bwd_kv_kernel` and
// `_flash_bwd_q_kernel` (pallas_calls in `_flash_backward`): its key-padding
// bias and its fp32 operands. The unmasked bf16 K4 moved to
// flash_bwd_sm90.cu, redesigned for Hopper; K6 (flash_normrope.py
// `_nr_bwd_kv_kernel`, `_nr_bwd_q_kernel`) runs on that kernel too, on the
// q/k that qk_normrope.cu transformed once for the forward.
//
// Given the forward's lse [B, H, Nq] and delta = rowsum(dO * O) [B, H, Nq]
// (fp32, computed outside the kernels as in JAX), each tile recomputes
//   P = exp(Q K^T * scale + bias - lse), keys >= Nk and queries >= Nq give
//   P = 0,
//   dV += bf16(P)^T dO,   dP = dO V^T,
//   dS = bf16(P * (dP - delta) * scale),   dK += dS^T Q,   dQ += dS K,
// with fp32 accumulation and the JAX kernels' rounding points; the grads are
// written in bf16 through (batch, head, seq) strides, so packed [B, N, H*dh]
// views of them need no copy. As in JAX the work is split so that no block
// ever adds into another's output (no atomics): the kv kernel is one block
// per (batch*head, 64-key tile) looping over the query tiles, the q kernel
// one block per (batch*head, 64-query tile) looping over the key tiles.
//
// Design: 4 warps per block. Two 64-row tiles stay in shared memory for the
// whole block (K, V in the kv kernel; Q, dO in the q kernel), two stream
// through it. Each warp owns 16 rows of the stationary tiles: it computes
// its 16 x 64 slices of S and dP with WMMA into warp-private fp32 scratch,
// the lanes form P and dS there (two lanes per row), and the products with
// the streamed tile accumulate into WMMA fragments held in registers (dK and
// dV: 2 * DP/16 fragments, dQ: DP/16). dh is zero-padded to DP (32, 64 or
// 128) in shared memory only. Shared memory at DP=128: four 17 KB tiles,
// 34 KB of fp32 S/dP scratch and 18 KB of bf16 P/dS, ~121 KB.
//
// What bounds it on the H100: five products of 2*N^2*DP FLOPs per head (the
// forward has two) with O(N*dh) bytes per head, so tensor-core and
// shared-memory work per tile, as for K1. This first version favours
// clarity: WMMA through shared memory, scalar tile loads, no cp.async/TMA
// and no wgmma.
//
// Key-padding bias (`_bwd_probs`, flash_attention.py:411-440): the fp32
// [B, Nk] row the forward added (0 or -0.7*FLT_MAX) is added to the scaled
// logit before exp(s - lse), exactly where JAX adds it, in both kernels of
// the bf16 pair (the unmasked bf16 K4 is flash_bwd_sm90.cu) and, when given,
// of the fp32 pair. An all-masked row's lse is the mask fill itself
// (log(Nk) rounds away), so each of its keys gets P = exp(0) = 1, as in JAX.
//
// fp32 operands (stage 1 trains in fp32; the stage-2 aux losses decode
// through it): WMMA takes no fp32 operands and TF32 would not match the
// exact-fp32 JAX path, so a second pair of kernels runs FFMA on the CUDA
// cores in the style of the fp32 forward: one thread per owned row, 64 rows
// per block, the other side streamed through shared memory in 32-row tiles
// and read as broadcasts. The kv kernel owns key rows (k, v, dK, dV in
// registers) and walks the query tiles; the q kernel owns query rows (q, dO,
// dQ in registers) and walks the key tiles; P is rebuilt from the saved lse,
// no atomics. dh <= 64; at dh 64 the kv kernel's four register rows spill to
// local memory. Bound at the MD17 shapes (dh 16, <= 192 keys): the five
// products' FFMA work at fp32's 67 TFLOP/s, of the order of the bytes.

#include <mma.h>

#include "flash_tiles.cuh"

using namespace nvcuda;
using namespace lam_flash;

namespace {

template <int DP>
struct BwdLayout {
  static constexpr int LDT = DP + 8;  // bf16 tile row stride
  static constexpr int LDS = BK + 4;  // fp32 S / dP row stride
  static constexpr int LDP = BK + 8;  // bf16 P / dS row stride
  static constexpr size_t tile = BQ * LDT * sizeof(bf16);
  static constexpr size_t t0 = 0;  // stationary tiles
  static constexpr size_t t1 = lam_align128(t0 + tile);
  static constexpr size_t t2 = lam_align128(t1 + tile);  // streamed tiles
  static constexpr size_t t3 = lam_align128(t2 + tile);
  static constexpr size_t s_off = lam_align128(t3 + tile);
  static constexpr size_t dp_off = lam_align128(s_off + NWARPS * 16 * LDS * sizeof(float));
  static constexpr size_t p_off = lam_align128(dp_off + NWARPS * 16 * LDS * sizeof(float));
  static constexpr size_t ds_off = lam_align128(p_off + NWARPS * 16 * LDP * sizeof(bf16));
  static constexpr size_t row_off = lam_align128(ds_off + NWARPS * 16 * LDP * sizeof(bf16));
  static constexpr size_t bytes = lam_align128(row_off + 2 * BQ * sizeof(float));
};

// Strides are (batch, head, seq) element strides, in this order of tensors.
enum Tensor { TQ = 0, TK = 3, TV = 6, TDO = 9, TDQ = 12, TDK = 15, TDV = 18 };

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;  // fp32 [B, H, Nq], contiguous
  const float* bias;         // fp32 [B, Nk], contiguous
  bf16 *dq, *dk, *dv;
  int H, Nq, Nk, dh;
  long long s[21];
  float scale;
};

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using RowA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using RowB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using ColB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;

__device__ __forceinline__ const bf16* head(const bf16* base, const BwdArgs& a, Tensor t,
                                            int b, int h) {
  return base + b * a.s[t] + h * a.s[t + 1];
}

// The warp's 16 x 64 slices of X Y^T and Z W^T: X, Z are 16 rows of
// stationary tiles, Y, W the 64 rows of streamed ones; fp32 into xy / zw.
template <int DP, int LDT, int LDS>
__device__ __forceinline__ void two_products_t(const bf16* X, const bf16* Y, const bf16* Z,
                                               const bf16* W, float* xy, float* zw) {
#pragma unroll
  for (int jn = 0; jn < BK / 16; ++jn) {
    Acc c, e;
    wmma::fill_fragment(c, 0.0f);
    wmma::fill_fragment(e, 0.0f);
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      RowA x, z;
      ColB y, w;
      wmma::load_matrix_sync(x, X + kd * 16, LDT);
      wmma::load_matrix_sync(y, Y + jn * 16 * LDT + kd * 16, LDT);
      wmma::mma_sync(c, x, y, c);
      wmma::load_matrix_sync(z, Z + kd * 16, LDT);
      wmma::load_matrix_sync(w, W + jn * 16 * LDT + kd * 16, LDT);
      wmma::mma_sync(e, z, w, e);
    }
    wmma::store_matrix_sync(xy + jn * 16, c, LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(zw + jn * 16, e, LDS, wmma::mem_row_major);
  }
  __syncwarp();
}

// acc[dn] += A (16 x 64, bf16, row stride LDP) times columns [16dn, 16dn+16)
// of the 64-row tile T.
template <int DP, int LDT, int LDP>
__device__ __forceinline__ void accumulate(Acc (&acc)[DP / 16], const bf16* A, const bf16* T) {
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      RowA x;
      RowB y;
      wmma::load_matrix_sync(x, A + kk * 16, LDP);
      wmma::load_matrix_sync(y, T + kk * 16 * LDT + dn * 16, LDT);
      wmma::mma_sync(acc[dn], x, y, acc[dn]);
    }
  }
}

// Write a warp's 16 x DP accumulator as bf16 rows [row0, row0 + 16) of one
// head (rows < n, columns < dh), staged 16 x 16 at a time through the
// warp's fp32 scratch.
template <int DP, int LDS>
__device__ __forceinline__ void store_rows(Acc (&acc)[DP / 16], float* scratch, bf16* out,
                                           long long sn, int row0, int n, int dh) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn) {
    wmma::store_matrix_sync(scratch, acc[dn], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = i / 16, c = dn * 16 + i % 16;
      if (row0 + r < n && c < dh)
        out[static_cast<long long>(row0 + r) * sn + c] =
            __float2bfloat16(scratch[r * LDS + i % 16]);
    }
    __syncwarp();
  }
}

// P and dS of one score element from its scaled (and biased) logit sl;
// p = 0 outside the valid rows and keys.
__device__ __forceinline__ void probs(float sl, float dp, float lse, float delta, float scale,
                                      bool valid, bf16* p_out, bf16* ds_out) {
  const float p = valid ? expf(__fsub_rn(sl, lse)) : 0.0f;
  if (p_out != nullptr) *p_out = __float2bfloat16(p);
  *ds_out = __float2bfloat16(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale));
}

// One (batch*head, 64-key tile): dK, dV over all query tiles.
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_kv_kernel(const BwdArgs a) {
  using Lay = BwdLayout<DP>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::t0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::t1);
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::t2);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Lay::t3);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off) + warp * 16 * LDS;
  float* DPs = reinterpret_cast<float*>(smem + Lay::dp_off) + warp * 16 * LDS;
  bf16* Ps = reinterpret_cast<bf16*>(smem + Lay::p_off) + warp * 16 * LDP;
  bf16* dSs = reinterpret_cast<bf16*>(smem + Lay::ds_off) + warp * 16 * LDP;
  float* lse_s = reinterpret_cast<float*>(smem + Lay::row_off);
  float* delta_s = lse_s + BQ;

  const TileIdx ti = tile_index(a.Nk, BK);
  const int b = ti.bh / a.H, h = ti.bh % a.H;
  const int k0 = ti.tile * BK;
  const bf16* qp = head(a.q, a, TQ, b, h);
  const bf16* dop = head(a.dout, a, TDO, b, h);
  const float* lsep = a.lse + static_cast<long long>(ti.bh) * a.Nq;
  const float* deltap = a.delta + static_cast<long long>(ti.bh) * a.Nq;

  load_tile<DP>(Ks, LDT, head(a.k, a, TK, b, h), a.s[TK + 2], k0, a.Nk, a.dh);
  load_tile<DP>(Vs, LDT, head(a.v, a, TV, b, h), a.s[TV + 2], k0, a.Nk, a.dh);

  Acc dk[DP / 16], dv[DP / 16];
#pragma unroll
  for (int i = 0; i < DP / 16; ++i) {
    wmma::fill_fragment(dk[i], 0.0f);
    wmma::fill_fragment(dv[i], 0.0f);
  }
  // lane owns key row r of its warp's 16 and half of the 64 query columns
  const int r = lane >> 1, half = lane & 1;
  const int key = k0 + warp * 16 + r;
  const bool key_ok = key < a.Nk;
  const float key_bias = key_ok ? a.bias[static_cast<long long>(b) * a.Nk + key] : 0.0f;
  const int n_tiles = (a.Nq + BQ - 1) / BQ;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // previous Q/dO tiles consumed
    load_tile<DP>(Qs, LDT, qp, a.s[TQ + 2], q0, a.Nq, a.dh);
    load_tile<DP>(dOs, LDT, dop, a.s[TDO + 2], q0, a.Nq, a.dh);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool ok = q0 + i < a.Nq;
      lse_s[i] = ok ? lsep[q0 + i] : 0.0f;
      delta_s[i] = ok ? deltap[q0 + i] : 0.0f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
    two_products_t<DP, LDT, LDS>(Ks + warp * 16 * LDT, Qs, Vs + warp * 16 * LDT, dOs, Ss, DPs);
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float sl = __fmul_rn(Ss[r * LDS + c], a.scale);
      sl = __fadd_rn(sl, key_bias);
      probs(sl, DPs[r * LDS + c], lse_s[c], delta_s[c], a.scale, key_ok && q0 + c < a.Nq,
            Ps + r * LDP + c, dSs + r * LDP + c);
    }
    __syncwarp();
    accumulate<DP, LDT, LDP>(dv, Ps, dOs);   // dV += P^T dO
    accumulate<DP, LDT, LDP>(dk, dSs, Qs);   // dK += dS^T Q
  }

  const int row0 = k0 + warp * 16;
  store_rows<DP, LDS>(dk, Ss, a.dk + b * a.s[TDK] + h * a.s[TDK + 1], a.s[TDK + 2], row0,
                      a.Nk, a.dh);
  store_rows<DP, LDS>(dv, Ss, a.dv + b * a.s[TDV] + h * a.s[TDV + 1], a.s[TDV + 2], row0,
                      a.Nk, a.dh);
}

// One (batch*head, 64-query tile): dQ over all key tiles.
template <int DP>
__global__ void __launch_bounds__(THREADS) flash_bwd_q_kernel(const BwdArgs a) {
  using Lay = BwdLayout<DP>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::t0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + Lay::t1);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::t2);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::t3);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off) + warp * 16 * LDS;
  float* DPs = reinterpret_cast<float*>(smem + Lay::dp_off) + warp * 16 * LDS;
  bf16* dSs = reinterpret_cast<bf16*>(smem + Lay::ds_off) + warp * 16 * LDP;
  float* bias_s = reinterpret_cast<float*>(smem + Lay::row_off);  // the key tile's bias

  const TileIdx ti = tile_index(a.Nq, BQ);
  const int b = ti.bh / a.H, h = ti.bh % a.H;
  const int q0 = ti.tile * BQ;
  const bf16* kp = head(a.k, a, TK, b, h);
  const bf16* vp = head(a.v, a, TV, b, h);

  load_tile<DP>(Qs, LDT, head(a.q, a, TQ, b, h), a.s[TQ + 2], q0, a.Nq, a.dh);
  load_tile<DP>(dOs, LDT, head(a.dout, a, TDO, b, h), a.s[TDO + 2], q0, a.Nq, a.dh);

  Acc dq[DP / 16];
#pragma unroll
  for (int i = 0; i < DP / 16; ++i) wmma::fill_fragment(dq[i], 0.0f);
  // lane owns query row r of its warp's 16 and half of the 64 key columns
  const int r = lane >> 1, half = lane & 1;
  const int qrow = q0 + warp * 16 + r;
  const bool row_ok = qrow < a.Nq;
  const long long row = static_cast<long long>(ti.bh) * a.Nq + qrow;
  const float lse = row_ok ? a.lse[row] : 0.0f;
  const float delta = row_ok ? a.delta[row] : 0.0f;
  const int n_tiles = (a.Nk + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous K/V tiles consumed
    load_tile<DP>(Ks, LDT, kp, a.s[TK + 2], k0, a.Nk, a.dh);
    load_tile<DP>(Vs, LDT, vp, a.s[TV + 2], k0, a.Nk, a.dh);
    for (int i = threadIdx.x; i < BK; i += THREADS)
      bias_s[i] = k0 + i < a.Nk ? a.bias[static_cast<long long>(b) * a.Nk + k0 + i] : 0.0f;
    __syncthreads();

    // S = Q K^T and dP = dO V^T: the warp's 16 queries x 64 keys
    two_products_t<DP, LDT, LDS>(Qs + warp * 16 * LDT, Ks, dOs + warp * 16 * LDT, Vs, Ss, DPs);
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      float sl = __fmul_rn(Ss[r * LDS + c], a.scale);
      sl = __fadd_rn(sl, bias_s[c]);
      probs(sl, DPs[r * LDS + c], lse, delta, a.scale, row_ok && k0 + c < a.Nk, nullptr,
            dSs + r * LDP + c);
    }
    __syncwarp();
    accumulate<DP, LDT, LDP>(dq, dSs, Ks);  // dQ += dS K
  }

  store_rows<DP, LDS>(dq, Ss, a.dq + b * a.s[TDQ] + h * a.s[TDQ + 1], a.s[TDQ + 2],
                      q0 + warp * 16, a.Nq, a.dh);
}

template <int DP>
cudaError_t launch(bool kv, const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = BwdLayout<DP>::bytes;
  if (kv) {
    static cudaError_t attr = lam_set_smem(flash_bwd_kv_kernel<DP>, smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(grid_blocks(B * a.H, a.Nk, BK));
    flash_bwd_kv_kernel<DP><<<grid, THREADS, smem, stream>>>(a);
  } else {
    static cudaError_t attr = lam_set_smem(flash_bwd_q_kernel<DP>, smem);
    if (attr != cudaSuccess) return attr;
    const dim3 grid(grid_blocks(B * a.H, a.Nq, BQ));
    flash_bwd_q_kernel<DP><<<grid, THREADS, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// The bf16 pair with the bias; a null bias is refused (the unmasked bf16 K4
// is flash_bwd_sm90.cu).
int launch_bwd(bool kv, const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* bias, void* dq, void* dk,
               void* dv, int B, int H, int Nq, int Nk, int dh, const long long* strides,
               float scale, void* stream) {
  if (dh <= 0 || dh > 128 || bias == nullptr || Nq <= 0 || Nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<const float*>(bias),
            static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
            H, Nq, Nk, dh, {}, scale};
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 32)
    err = launch<32>(kv, a, B, st);
  else if (dh <= 64)
    err = launch<64>(kv, a, B, st);
  else
    err = launch<128>(kv, a, B, st);
  return static_cast<int>(err);
}

// fp32 operands: 64 owned rows per block, one thread per row; the other
// side in 32-row shared-memory tiles read as broadcasts.
constexpr int F32_ROWS = 64;
constexpr int F32_TILE = 32;

struct BwdF32Args {
  const float *q, *k, *v, *dout;
  const float *lse, *delta;  // fp32 [B, H, Nq], contiguous
  const float* bias;         // fp32 [B, Nk] contiguous, or null
  float *dq, *dk, *dv;
  int H, Nq, Nk, dh;
  long long s[21];
  float scale;
};

__device__ __forceinline__ long long row_offset(const BwdF32Args& a, Tensor t, int b, int h,
                                                int n) {
  return b * a.s[t] + h * a.s[t + 1] + static_cast<long long>(n) * a.s[t + 2];
}

// One (batch*head, 64-key block): thread = key row; dK, dV over all queries.
template <int DP>
__global__ void __launch_bounds__(F32_ROWS) flash_bwd_kv_f32_kernel(const BwdF32Args a) {
  __shared__ float Qs[F32_TILE][DP];
  __shared__ float dOs[F32_TILE][DP];
  __shared__ float lse_s[F32_TILE], delta_s[F32_TILE];
  const TileIdx ti = tile_index(a.Nk, F32_ROWS);
  const int b = ti.bh / a.H, h = ti.bh % a.H;
  const int key = ti.tile * F32_ROWS + threadIdx.x;
  const bool key_ok = key < a.Nk;

  float kr[DP], vr[DP], dk[DP], dv[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool ok = key_ok && c < a.dh;
    kr[c] = ok ? a.k[row_offset(a, TK, b, h, key) + c] : 0.0f;
    vr[c] = ok ? a.v[row_offset(a, TV, b, h, key) + c] : 0.0f;
    dk[c] = dv[c] = 0.0f;
  }
  // bias of this key (adding 0.0 when there is none leaves the logit exact)
  const float kb = (a.bias != nullptr && key_ok) ? a.bias[static_cast<long long>(b) * a.Nk + key]
                                                 : 0.0f;
  const float* lsep = a.lse + static_cast<long long>(ti.bh) * a.Nq;
  const float* deltap = a.delta + static_cast<long long>(ti.bh) * a.Nq;

  for (int q0 = 0; q0 < a.Nq; q0 += F32_TILE) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < F32_TILE * DP; idx += F32_ROWS) {
      const int r = idx / DP, c = idx % DP;
      const bool ok = q0 + r < a.Nq && c < a.dh;
      Qs[r][c] = ok ? a.q[row_offset(a, TQ, b, h, q0 + r) + c] : 0.0f;
      dOs[r][c] = ok ? a.dout[row_offset(a, TDO, b, h, q0 + r) + c] : 0.0f;
    }
    const int t = threadIdx.x;
    if (t < F32_TILE) {
      lse_s[t] = q0 + t < a.Nq ? lsep[q0 + t] : 0.0f;
      delta_s[t] = q0 + t < a.Nq ? deltap[q0 + t] : 0.0f;
    }
    __syncthreads();
    const int rows = min(F32_TILE, a.Nq - q0);
    for (int j = 0; j < rows; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        s = fmaf(Qs[j][c], kr[c], s);
        dp = fmaf(dOs[j][c], vr[c], dp);
      }
      const float sl = __fadd_rn(__fmul_rn(s, a.scale), kb);
      const float p = key_ok ? expf(__fsub_rn(sl, lse_s[j])) : 0.0f;
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta_s[j])), a.scale);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dv[c] = fmaf(p, dOs[j][c], dv[c]);
        dk[c] = fmaf(ds, Qs[j][c], dk[c]);
      }
    }
  }
  if (key_ok) {
    float* dkp = a.dk + row_offset(a, TDK, b, h, key);
    float* dvp = a.dv + row_offset(a, TDV, b, h, key);
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < a.dh) {
        dkp[c] = dk[c];
        dvp[c] = dv[c];
      }
    }
  }
}

// One (batch*head, 64-query block): thread = query row; dQ over all keys.
template <int DP>
__global__ void __launch_bounds__(F32_ROWS) flash_bwd_q_f32_kernel(const BwdF32Args a) {
  __shared__ float Ks[F32_TILE][DP];
  __shared__ float Vs[F32_TILE][DP];
  __shared__ float Bs[F32_TILE];
  const TileIdx ti = tile_index(a.Nq, F32_ROWS);
  const int b = ti.bh / a.H, h = ti.bh % a.H;
  const int qrow = ti.tile * F32_ROWS + threadIdx.x;
  const bool row_ok = qrow < a.Nq;

  float qr[DP], dor[DP], dq[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    const bool ok = row_ok && c < a.dh;
    qr[c] = ok ? a.q[row_offset(a, TQ, b, h, qrow) + c] : 0.0f;
    dor[c] = ok ? a.dout[row_offset(a, TDO, b, h, qrow) + c] : 0.0f;
    dq[c] = 0.0f;
  }
  const long long row = static_cast<long long>(ti.bh) * a.Nq + qrow;
  const float lse = row_ok ? a.lse[row] : 0.0f;
  const float delta = row_ok ? a.delta[row] : 0.0f;

  for (int k0 = 0; k0 < a.Nk; k0 += F32_TILE) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < F32_TILE * DP; idx += F32_ROWS) {
      const int r = idx / DP, c = idx % DP;
      const bool ok = k0 + r < a.Nk && c < a.dh;
      Ks[r][c] = ok ? a.k[row_offset(a, TK, b, h, k0 + r) + c] : 0.0f;
      Vs[r][c] = ok ? a.v[row_offset(a, TV, b, h, k0 + r) + c] : 0.0f;
    }
    const int t = threadIdx.x;
    if (t < F32_TILE) {
      Bs[t] = (a.bias != nullptr && k0 + t < a.Nk)
                  ? a.bias[static_cast<long long>(b) * a.Nk + k0 + t] : 0.0f;
    }
    __syncthreads();
    const int keys = min(F32_TILE, a.Nk - k0);
    for (int j = 0; j < keys; ++j) {
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        s = fmaf(qr[c], Ks[j][c], s);
        dp = fmaf(dor[c], Vs[j][c], dp);
      }
      const float sl = __fadd_rn(__fmul_rn(s, a.scale), Bs[j]);
      const float p = expf(__fsub_rn(sl, lse));
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), a.scale);
#pragma unroll
      for (int c = 0; c < DP; ++c) dq[c] = fmaf(ds, Ks[j][c], dq[c]);
    }
  }
  if (row_ok) {
    float* dqp = a.dq + row_offset(a, TDQ, b, h, qrow);
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < a.dh) dqp[c] = dq[c];
  }
}

template <int DP>
cudaError_t launch_f32(bool kv, const BwdF32Args& a, int B, cudaStream_t stream) {
  if (kv)
    flash_bwd_kv_f32_kernel<DP><<<grid_blocks(B * a.H, a.Nk, F32_ROWS), F32_ROWS, 0, stream>>>(a);
  else
    flash_bwd_q_f32_kernel<DP><<<grid_blocks(B * a.H, a.Nq, F32_ROWS), F32_ROWS, 0, stream>>>(a);
  return cudaGetLastError();
}

int launch_bwd_f32(bool kv, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* bias, void* dq, void* dk,
                   void* dv, int B, int H, int Nq, int Nk, int dh, const long long* strides,
                   float scale, void* stream) {
  if (dh <= 0 || dh > 64 || Nq <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(dout),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(bias), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nk, dh, {}, scale};
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 16)
    err = launch_f32<16>(kv, a, B, st);
  else if (dh <= 32)
    err = launch_f32<32>(kv, a, B, st);
  else
    err = launch_f32<64>(kv, a, B, st);
  return static_cast<int>(err);
}

}  // namespace

// q/k/v/dout and dq/dk/dv: bf16 [B, H, N, dh] addressed through element
// strides (batch, head, seq) given in `strides` in the order q, k, v, dout,
// dq, dk, dv (21 values); dh has unit stride. lse/delta: fp32 [B, H, Nq]
// contiguous. bias: the fp32 key-padding bias [B, Nk] contiguous; a null
// bias is refused, the unmasked bf16 K4 being lam_flash_attention_bwd_sm90.
// The kv entry writes dk and dv, the q entry dq. Each returns
// cudaGetLastError().
extern "C" int lam_flash_attention_bwd_kv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dq, void* dk, void* dv, int B, int H, int Nq,
    int Nk, int dh, const long long* strides, float scale, void* stream) {
  return launch_bwd(true, q, k, v, dout, lse, delta, bias, dq, dk, dv, B, H, Nq, Nk, dh,
                    strides, scale, stream);
}

extern "C" int lam_flash_attention_bwd_q(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dq, void* dk, void* dv, int B, int H, int Nq,
    int Nk, int dh, const long long* strides, float scale, void* stream) {
  return launch_bwd(false, q, k, v, dout, lse, delta, bias, dq, dk, dv, B, H, Nq, Nk, dh,
                    strides, scale, stream);
}

// As the two entries above on fp32 q/k/v/dout and dq/dk/dv (dh <= 64), with
// the same strides, lse, delta and optional bias.
extern "C" int lam_flash_attention_bwd_f32_kv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dq, void* dk, void* dv, int B, int H, int Nq,
    int Nk, int dh, const long long* strides, float scale, void* stream) {
  return launch_bwd_f32(true, q, k, v, dout, lse, delta, bias, dq, dk, dv, B, H, Nq, Nk, dh,
                        strides, scale, stream);
}

extern "C" int lam_flash_attention_bwd_f32_q(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dq, void* dk, void* dv, int B, int H, int Nq,
    int Nk, int dh, const long long* strides, float scale, void* stream) {
  return launch_bwd_f32(false, q, k, v, dout, lse, delta, bias, dq, dk, dv, B, H, Nq, Nk, dh,
                        strides, scale, stream);
}
