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
// no atomics. This pair takes dh <= 64; at dh 64 the kv kernel's four
// register rows spill to local memory. Bound at the MD17 shapes (dh 16, <= 192 keys): the five
// products' FFMA work at fp32's 67 TFLOP/s, of the order of the bytes.
// Above dh 64 (the fp32 DiTs' 2 x 128 and 3 x 128 splits in training, K6's
// fp32 attention part on the transformed q/k too) the register-tiled pair
// below takes the fp32 operands instead: a thread holds 4 x 4 blocks of S
// and dP and a 4 x 8 block of each output, as the fp32 forward does.

#include <math_constants.h>
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

// fp32 operands at 64 < dh <= 128: a register-tiled pair in the manner of
// flash_attention.cu's flash_fwd_f32_tiled_kernel, FFMA, no atomics. A block
// of WIDE_THREADS owns a 64-row tile of one (batch, head) sequence (SEG = 1),
// or the rows of two sequences whose Nq and Nk are both at most 32 (SEG =
// 2: MD17's temporal axis, N = 30), with its two stationary operands in
// shared memory (the kv kernel K and V, the q kernel Q and dO) and walks the
// other side in 64-row tiles (Q and dO, or K and V), each copied by cp.async
// (16 bytes where bases, strides and dh allow it: VEC), dh zero-padded to
// WIDE_DP.
// - S and dP: thread (rg, kg), rg = 2 * warp + lane / 16, kg = lane % 16,
//   holds S and dP of its stationary rows rg * 4 + i (i < 4) against the
//   streamed rows kg + 16 j (j < 4 / SEG), two 4 x 4 blocks: per 4 columns
//   of dh it reads 4 float4 of its own rows (shared by the 16 lanes of a
//   half warp) and one of each streamed row (16 rows at once, on distinct
//   banks) for 16 FFMAs of each product. Then P = exp(S * scale + bias -
//   lse) and dS = P (dP - delta) * scale, with the JAX kernels' rounding
//   points; a key past Nk gets a -inf bias and a query past Nq a +inf lse,
//   so its P is 0. The kv kernel puts P and dS in shared memory query-major
//   (a query's 64 keys), the q kernel dS key-major.
// - The products over the streamed rows: thread (prg, cg), prg = 4 * (warp
//   / 2) + lane / 8, cg = 8 * (warp % 2) + lane % 8, holds the stationary
//   rows prg * 4 + i and columns 4 cg .. + 4 and 64 + 4 cg .. + 4 of each
//   output (dK and dV: 64 accumulators; dQ: 32); per streamed row it reads
//   one float4 of P or dS and two of dO or Q (or K) a product.
// One block an SM (~167 KB / ~150 KB of shared memory: four 64 x 132
// tiles, P and dS 64 x 68); SEG = 2 runs a warp's own segment only (its
// rows lie in one sequence), as the forward does. Bounds on the H100 (five
// products at 67 TFLOP/s; the kernels do seven, S and dP in both):
// [16,3,1000,128] 0.92 ms, [1920,2,192,128] 2.70 ms, [12288,2,30,128]
// 0.90 ms (bytes).
constexpr int WB_RM = 4;               // stationary rows a thread holds
constexpr int WB_LDP = WIDE_KEYS + 4;  // P / dS rows of the kernels' 64 columns

struct WideBwdLayout {
  static constexpr int tile = WIDE_KEYS * WIDE_LDQK;
  static constexpr int s0 = 0;          // stationary tiles: K, V (kv) or Q, dO (q)
  static constexpr int s1 = tile;
  static constexpr int t0 = 2 * tile;   // streamed tiles: Q, dO (kv) or K, V (q)
  static constexpr int t1 = 3 * tile;
  static constexpr int p_off = 4 * tile;               // P (kv kernel only)
  static constexpr int ds_off = p_off + WIDE_KEYS * WB_LDP;
  static constexpr int row_off = ds_off + WIDE_KEYS * WB_LDP;  // lse, delta, bias [64] each
  static constexpr size_t bytes = sizeof(float) * (row_off + 3 * WIDE_KEYS);
};

// Offsets of the block's two sequences in tensor t (the second is unread
// when ok1 is false).
__device__ __forceinline__ long long seq_offset(const BwdF32Args& a, Tensor t, int bh) {
  return (bh / a.H) * a.s[t] + (bh % a.H) * a.s[t + 1];
}

// Row r of the block's 64 (a position of sequence r / 32 when SEG = 2):
// its sequence and position; valid when the sequence exists and pos < n.
template <int SEG>
__device__ __forceinline__ bool wide_row(int r, int n0, int n, bool ok1, int& seq, int& pos) {
  seq = SEG == 1 ? 0 : r / (WIDE_KEYS / 2);
  pos = n0 + (SEG == 1 ? r : r % (WIDE_KEYS / 2));
  return (seq == 0 || ok1) && pos < n;
}

// The 4 x (4 / SEG) blocks of X Y^T and Z W^T: X, Z the thread's own rows
// (row stride WIDE_LDQK), Y, W the streamed rows kg + 16 j.
template <int JN>
__device__ __forceinline__ void wide_two_products(const float* X, const float* Y, const float* Z,
                                                  const float* W, float (&xy)[WB_RM][JN],
                                                  float (&zw)[WB_RM][JN]) {
#pragma unroll
  for (int i = 0; i < WB_RM; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) xy[i][j] = zw[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < WIDE_DP; d += 4) {
    float4 xv[WB_RM];
#pragma unroll
    for (int i = 0; i < WB_RM; ++i) xv[i] = *reinterpret_cast<const float4*>(X + i * WIDE_LDQK + d);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float4 yv = *reinterpret_cast<const float4*>(Y + 16 * j * WIDE_LDQK + d);
#pragma unroll
      for (int i = 0; i < WB_RM; ++i) xy[i][j] = wide_dot4(xv[i], yv, xy[i][j]);
    }
#pragma unroll
    for (int i = 0; i < WB_RM; ++i) xv[i] = *reinterpret_cast<const float4*>(Z + i * WIDE_LDQK + d);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(W + 16 * j * WIDE_LDQK + d);
#pragma unroll
      for (int i = 0; i < WB_RM; ++i) zw[i][j] = wide_dot4(xv[i], wv, zw[i][j]);
    }
  }
}

// acc[i][0..8) += w_i * (row's columns 4 cg .. + 4 and 64 + 4 cg .. + 4).
__device__ __forceinline__ void wide_axpy(float (&acc)[WB_RM][8], const float4 w,
                                          const float* row) {
  const float4 r0 = *reinterpret_cast<const float4*>(row);
  const float4 r1 = *reinterpret_cast<const float4*>(row + 64);
#pragma unroll
  for (int i = 0; i < WB_RM; ++i) {
    const float wi = f4(w, i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[i][c] = fmaf(wi, f4(r0, c), acc[i][c]);
      acc[i][4 + c] = fmaf(wi, f4(r1, c), acc[i][4 + c]);
    }
  }
}

// Write rows prg * 4 + i of acc (columns 4 cg .. and 64 + 4 cg ..) to
// tensor t at the block's positions n0 + ..., those valid only.
template <int SEG, bool VEC>
__device__ __forceinline__ void wide_store(const BwdF32Args& a, float* base, Tensor t, int bh0,
                                           bool ok1, int n0, int n, int prg, int cg,
                                           const float (&acc)[WB_RM][8]) {
#pragma unroll
  for (int i = 0; i < WB_RM; ++i) {
    int seq, pos;
    if (!wide_row<SEG>(prg * WB_RM + i, n0, n, ok1, seq, pos)) continue;
    float* out = base + seq_offset(a, t, bh0 + seq) + static_cast<long long>(pos) * a.s[t + 2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 64 * half + 4 * cg;
      if constexpr (VEC) {
        if (c0 < a.dh)
          *reinterpret_cast<float4*>(out + c0) =
              make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                          acc[i][4 * half + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < a.dh) out[c0 + c] = acc[i][4 * half + c];
      }
    }
  }
}

// The block's first sequence and first row of its stationary tile.
template <int SEG>
__device__ __forceinline__ void wide_block(int n, int& bh0, int& n0) {
  if constexpr (SEG == 1) {
    const TileIdx ti = tile_index(n, WIDE_KEYS);
    bh0 = ti.bh;
    n0 = ti.tile * WIDE_KEYS;
  } else {
    bh0 = SEG * blockIdx.x;
    n0 = 0;
  }
}

// dK, dV of one 64-key tile (or of two sequences' keys) over all queries.
template <int SEG, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_kv_f32_tiled_kernel(const BwdF32Args a, int BH) {
  using L = WideBwdLayout;
  constexpr int JN = 4 / SEG;
  extern __shared__ __align__(16) float wbs[];
  float *Ks = wbs + L::s0, *Vs = wbs + L::s1, *Qs = wbs + L::t0, *Gs = wbs + L::t1;
  float *Ps = wbs + L::p_off, *dSs = wbs + L::ds_off;
  float *Ls = wbs + L::row_off, *Ds = Ls + WIDE_KEYS, *Bk = Ds + WIDE_KEYS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int bh0, k0;
  wide_block<SEG>(a.Nk, bh0, k0);
  const bool ok1 = SEG == 2 && bh0 + 1 < BH;
  const int seg = SEG == 1 ? 0 : warp / 4;

  wide_stage<SEG, VEC>(Ks, WIDE_LDQK, WIDE_KEYS, a.k, seq_offset(a, TK, bh0),
                       seq_offset(a, TK, bh0 + 1), ok1, a.s[TK + 2], k0, a.Nk, a.dh);
  wide_stage<SEG, VEC>(Vs, WIDE_LDQK, WIDE_KEYS, a.v, seq_offset(a, TV, bh0),
                       seq_offset(a, TV, bh0 + 1), ok1, a.s[TV + 2], k0, a.Nk, a.dh);
  if (tid < WIDE_KEYS) {
    int sq, key;
    const bool ok = wide_row<SEG>(tid, k0, a.Nk, ok1, sq, key);
    const float kb = (ok && a.bias != nullptr)
                         ? a.bias[static_cast<long long>((bh0 + sq) / a.H) * a.Nk + key] : 0.0f;
    Bk[tid] = ok ? kb : -CUDART_INF_F;
  }

  const int rg = 2 * warp + lane / 16, kg = lane % 16;
  const int prg = 4 * (warp / 2) + lane / 8, cg = 8 * (warp % 2) + lane % 8;
  float dk[WB_RM][8], dv[WB_RM][8];
#pragma unroll
  for (int i = 0; i < WB_RM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk[i][c] = dv[i][c] = 0.0f;

  const int n_tiles = SEG == 1 ? (a.Nq + WIDE_KEYS - 1) / WIDE_KEYS : 1;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * WIDE_KEYS;
    wide_stage<SEG, VEC>(Qs, WIDE_LDQK, WIDE_KEYS, a.q, seq_offset(a, TQ, bh0),
                         seq_offset(a, TQ, bh0 + 1), ok1, a.s[TQ + 2], q0, a.Nq, a.dh);
    wide_stage<SEG, VEC>(Gs, WIDE_LDQK, WIDE_KEYS, a.dout, seq_offset(a, TDO, bh0),
                         seq_offset(a, TDO, bh0 + 1), ok1, a.s[TDO + 2], q0, a.Nq, a.dh);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid < WIDE_KEYS) {
      int sq, pos;
      const bool ok = wide_row<SEG>(tid, q0, a.Nq, ok1, sq, pos);
      const long long row = static_cast<long long>(bh0 + sq) * a.Nq + pos;
      Ls[tid] = ok ? a.lse[row] : CUDART_INF_F;
      Ds[tid] = ok ? a.delta[row] : 0.0f;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys rg * 4 + i, queries kg + 16 (seg JN + j)
    float st[WB_RM][JN], dpt[WB_RM][JN];
    const int col0 = kg + 16 * seg * JN;
    wide_two_products<JN>(Ks + rg * WB_RM * WIDE_LDQK, Qs + col0 * WIDE_LDQK,
                          Vs + rg * WB_RM * WIDE_LDQK, Gs + col0 * WIDE_LDQK, st, dpt);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int col = col0 + 16 * j;
      float p[WB_RM], ds[WB_RM];
#pragma unroll
      for (int i = 0; i < WB_RM; ++i) {
        const float sl = __fadd_rn(__fmul_rn(st[i][j], a.scale), Bk[rg * WB_RM + i]);
        p[i] = expf(__fsub_rn(sl, Ls[col]));
        ds[i] = __fmul_rn(__fmul_rn(p[i], __fsub_rn(dpt[i][j], Ds[col])), a.scale);
      }
      *reinterpret_cast<float4*>(Ps + col * WB_LDP + rg * WB_RM) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dSs + col * WB_LDP + rg * WB_RM) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the segment's queries
    const int qb = seg * (WIDE_KEYS / SEG);
    const int qe = SEG == 1 ? min(WIDE_KEYS, (a.Nq - q0 + 3) & ~3) : qb + WIDE_KEYS / SEG;
#pragma unroll 2
    for (int qi = qb; qi < qe; ++qi) {
      wide_axpy(dv, *reinterpret_cast<const float4*>(Ps + qi * WB_LDP + prg * WB_RM),
                Gs + qi * WIDE_LDQK + 4 * cg);
      wide_axpy(dk, *reinterpret_cast<const float4*>(dSs + qi * WB_LDP + prg * WB_RM),
                Qs + qi * WIDE_LDQK + 4 * cg);
    }
    __syncthreads();  // Q, dO, P and dS consumed before the next copies
  }
  wide_store<SEG, VEC>(a, a.dk, TDK, bh0, ok1, k0, a.Nk, prg, cg, dk);
  wide_store<SEG, VEC>(a, a.dv, TDV, bh0, ok1, k0, a.Nk, prg, cg, dv);
}

// dQ of one 64-query tile (or of two sequences' queries) over all keys.
template <int SEG, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_q_f32_tiled_kernel(const BwdF32Args a, int BH) {
  using L = WideBwdLayout;
  constexpr int JN = 4 / SEG;
  extern __shared__ __align__(16) float wbs[];
  float *Qs = wbs + L::s0, *Gs = wbs + L::s1, *Ks = wbs + L::t0, *Vs = wbs + L::t1;
  float* dSs = wbs + L::ds_off;
  float *Ls = wbs + L::row_off, *Ds = Ls + WIDE_KEYS, *Bk = Ds + WIDE_KEYS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int bh0, q0;
  wide_block<SEG>(a.Nq, bh0, q0);
  const bool ok1 = SEG == 2 && bh0 + 1 < BH;
  const int seg = SEG == 1 ? 0 : warp / 4;

  wide_stage<SEG, VEC>(Qs, WIDE_LDQK, WIDE_KEYS, a.q, seq_offset(a, TQ, bh0),
                       seq_offset(a, TQ, bh0 + 1), ok1, a.s[TQ + 2], q0, a.Nq, a.dh);
  wide_stage<SEG, VEC>(Gs, WIDE_LDQK, WIDE_KEYS, a.dout, seq_offset(a, TDO, bh0),
                       seq_offset(a, TDO, bh0 + 1), ok1, a.s[TDO + 2], q0, a.Nq, a.dh);
  if (tid < WIDE_KEYS) {
    int sq, pos;
    const bool ok = wide_row<SEG>(tid, q0, a.Nq, ok1, sq, pos);
    const long long row = static_cast<long long>(bh0 + sq) * a.Nq + pos;
    Ls[tid] = ok ? a.lse[row] : CUDART_INF_F;
    Ds[tid] = ok ? a.delta[row] : 0.0f;
  }

  const int rg = 2 * warp + lane / 16, kg = lane % 16;
  const int prg = 4 * (warp / 2) + lane / 8, cg = 8 * (warp % 2) + lane % 8;
  float dq[WB_RM][8];
#pragma unroll
  for (int i = 0; i < WB_RM; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dq[i][c] = 0.0f;

  const int n_tiles = SEG == 1 ? (a.Nk + WIDE_KEYS - 1) / WIDE_KEYS : 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * WIDE_KEYS;
    wide_stage<SEG, VEC>(Ks, WIDE_LDQK, WIDE_KEYS, a.k, seq_offset(a, TK, bh0),
                         seq_offset(a, TK, bh0 + 1), ok1, a.s[TK + 2], k0, a.Nk, a.dh);
    wide_stage<SEG, VEC>(Vs, WIDE_LDQK, WIDE_KEYS, a.v, seq_offset(a, TV, bh0),
                         seq_offset(a, TV, bh0 + 1), ok1, a.s[TV + 2], k0, a.Nk, a.dh);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid < WIDE_KEYS) {
      int sq, key;
      const bool ok = wide_row<SEG>(tid, k0, a.Nk, ok1, sq, key);
      const float kb = (ok && a.bias != nullptr)
                           ? a.bias[static_cast<long long>((bh0 + sq) / a.H) * a.Nk + key]
                           : 0.0f;
      Bk[tid] = ok ? kb : -CUDART_INF_F;
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries rg * 4 + i, keys kg + 16 (seg JN + j)
    float sc[WB_RM][JN], dp[WB_RM][JN];
    const int col0 = kg + 16 * seg * JN;
    wide_two_products<JN>(Qs + rg * WB_RM * WIDE_LDQK, Ks + col0 * WIDE_LDQK,
                          Gs + rg * WB_RM * WIDE_LDQK, Vs + col0 * WIDE_LDQK, sc, dp);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int col = col0 + 16 * j;
      float ds[WB_RM];
#pragma unroll
      for (int i = 0; i < WB_RM; ++i) {
        const int r = rg * WB_RM + i;
        const float sl = __fadd_rn(__fmul_rn(sc[i][j], a.scale), Bk[col]);
        const float p = expf(__fsub_rn(sl, Ls[r]));
        ds[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], Ds[r])), a.scale);
      }
      *reinterpret_cast<float4*>(dSs + col * WB_LDP + rg * WB_RM) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over the segment's keys
    const int kb = seg * (WIDE_KEYS / SEG);
    const int ke = SEG == 1 ? min(WIDE_KEYS, (a.Nk - k0 + 3) & ~3) : kb + WIDE_KEYS / SEG;
#pragma unroll 2
    for (int key = kb; key < ke; ++key)
      wide_axpy(dq, *reinterpret_cast<const float4*>(dSs + key * WB_LDP + prg * WB_RM),
                Ks + key * WIDE_LDQK + 4 * cg);
    __syncthreads();  // K, V and dS consumed before the next copies
  }
  wide_store<SEG, VEC>(a, a.dq, TDQ, bh0, ok1, q0, a.Nq, prg, cg, dq);
}

template <int SEG, bool VEC>
cudaError_t launch_f32_tiled(bool kv, const BwdF32Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = WideBwdLayout::bytes;
  const int bh = B * a.H;
  if (kv) {
    static cudaError_t attr = lam_set_smem(flash_bwd_kv_f32_tiled_kernel<SEG, VEC>, smem);
    if (attr != cudaSuccess) return attr;
    const unsigned grid = SEG == 1 ? grid_blocks(bh, a.Nk, WIDE_KEYS)
                                   : static_cast<unsigned>((bh + 1) / 2);
    flash_bwd_kv_f32_tiled_kernel<SEG, VEC><<<grid, WIDE_THREADS, smem, stream>>>(a, bh);
  } else {
    static cudaError_t attr = lam_set_smem(flash_bwd_q_f32_tiled_kernel<SEG, VEC>, smem);
    if (attr != cudaSuccess) return attr;
    const unsigned grid = SEG == 1 ? grid_blocks(bh, a.Nq, WIDE_KEYS)
                                   : static_cast<unsigned>((bh + 1) / 2);
    flash_bwd_q_f32_tiled_kernel<SEG, VEC><<<grid, WIDE_THREADS, smem, stream>>>(a, bh);
  }
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_f32_wide(bool kv, const BwdF32Args& a, int B, int seg, cudaStream_t st) {
  return seg == 2 ? launch_f32_tiled<2, VEC>(kv, a, B, st) : launch_f32_tiled<1, VEC>(kv, a, B, st);
}

int launch_bwd_f32(bool kv, const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* bias, void* dq, void* dk,
                   void* dv, int B, int H, int Nq, int Nk, int dh, const long long* strides,
                   float scale, int seg, void* stream) {
  if (dh <= 0 || dh > WIDE_DP || Nq <= 0 || Nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(dout),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(bias), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nk, dh, {}, scale};
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh > 64) {
    if ((seg != 1 && seg != 2) || (seg == 2 && (Nq > 32 || Nk > 32)))
      return static_cast<int>(cudaErrorInvalidValue);
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    unsigned long long bits = 0;
    for (const void* p : ptrs) bits |= reinterpret_cast<unsigned long long>(p);
    for (int i = 0; i < 21; ++i) bits |= 4ull * static_cast<unsigned long long>(strides[i]);
    if ((bits & 15) == 0 && dh % 4 == 0)
      err = launch_f32_wide<true>(kv, a, B, seg, st);
    else
      err = launch_f32_wide<false>(kv, a, B, seg, st);
  } else if (dh <= 16)
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

// As the two entries above on fp32 q/k/v/dout and dq/dk/dv (dh <= 128), with
// the same strides, lse, delta and optional bias. seg: the plan of the
// register-tiled pair at 64 < dh <= 128 (the wrapper's f32_wide_plan: 1, or
// 2 sequences a block where Nq and Nk are at most 32); unread at dh <= 64.
extern "C" int lam_flash_attention_bwd_f32_kv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dq, void* dk, void* dv, int B, int H, int Nq,
    int Nk, int dh, const long long* strides, float scale, int seg, void* stream) {
  return launch_bwd_f32(true, q, k, v, dout, lse, delta, bias, dq, dk, dv, B, H, Nq, Nk, dh,
                        strides, scale, seg, stream);
}

extern "C" int lam_flash_attention_bwd_f32_q(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dq, void* dk, void* dv, int B, int H, int Nq,
    int Nk, int dh, const long long* strides, float scale, int seg, void* stream) {
  return launch_bwd_f32(false, q, k, v, dout, lse, delta, bias, dq, dk, dv, B, H, Nq, Nk, dh,
                        strides, scale, seg, stream);
}
