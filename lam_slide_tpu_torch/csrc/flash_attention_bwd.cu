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
// of the fp32 kernels. An all-masked row's lse is the mask fill itself
// (log(Nk) rounds away), so each of its keys gets P = exp(0) = 1, as in JAX.
//
// fp32 operands (stage 1 trains in fp32; the stage-2 aux losses decode
// through it; the fp32 DiTs train through it): WMMA takes no fp32 operands
// and TF32 would not match the exact-fp32 JAX path, so two register-tiled
// kernels run FFMA on the CUDA cores, a thread a 4 x 4 block of S and dP and
// a register tile of each grad, so that each shared load feeds several
// FFMAs: the narrow kernel at dh <= 64 (dh padded to a multiple of 8, two
// blocks an SM, the query tiles double-buffered) and the wide kernel at
// 64 < dh <= 128 (the fp32 DiTs' 2 x 128 and 3 x 128 splits, K6's fp32
// attention part on the transformed q/k too). Each makes one pass over a
// key tile's queries, forms S and dP once and writes dK, dV and the tile's
// share of dQ; where more than one key tile covers the keys, a second kernel
// adds the shares in tile order. Both take the bias, and neither uses
// atomics.

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

struct BwdF32Args {
  const float *q, *k, *v, *dout;
  const float *lse, *delta;  // fp32 [B, H, Nq], contiguous
  const float* bias;         // fp32 [B, Nk] contiguous, or null
  float *dq, *dk, *dv;
  int H, Nq, Nk, dh;
  long long s[21];
  float scale;
  float* scratch;  // the one-pass kernels' dQ partials [key tiles][B*H][Nq][dh], or null
  int BH;          // B*H
};

// fp32 operands at dh <= 64 (MD17's dh 16, the 4AA DiT's dh 24, the smoke
// DiTs' dh 8): a register-tiled kernel sized for narrow heads, FFMA, no
// atomics, that forms S and dP once for all three grads (five products). A
// block of NB_THREADS owns a 64-key tile of one (batch, head) sequence with
// K and V in shared memory and walks the queries in 64-row tiles of Q, dO,
// lse and delta, double-buffered through cp.async (16 bytes where bases,
// strides and dh allow it: VEC); dh zero-padded only to DP, the next of 8,
// 16, 24, 32, 48, 64; rows of DP + 4 floats, so 16 rows read at once fall on
// distinct banks.
// - S and dP: thread (rg, kg) = (tid / 16, tid % 16) holds S^T and dP^T of
//   its keys 4 rg + i against the queries kg + 16 j (i, j < 4): per 4
//   columns of dh, 8 float4 of its own rows (one address a half warp) and
//   8 of query rows for 128 FFMAs. Then P = exp(S * scale + bias - lse) and
//   dS = P (dP - delta) * scale with the JAX kernels' rounding points, into
//   shared memory query-major (a query's 64 keys); a key past Nk gets a -inf
//   bias, so its P and dS are 0.
// - dK, dV: thread (rg, cg, sl) of NarrowSplit<DP, CN> holds keys 4 rg + i
//   and columns CN cg .. + CN (CN = 4 or 6: 32 or 48 accumulators, so two
//   blocks of 256 threads fit an SM at dh <= 48) and sums over slice sl of
//   the tile's valid queries; a query costs it a float4 of P or dS and CN /
//   4 (CN / 2) loads of dO or Q a product for 4 CN FFMAs. The slices'
//   partial sums meet once, at the end of the block, in shared memory, in
//   slice order.
// - dQ: each query tile's share over the block's keys (narrow_dq_share),
//   written to dq where the block holds every key (Nk <= 64), else to its
//   key tile's slice of fp32 scratch partials that a second kernel sums in
//   tile order (flash_bwd_f32_dq_sum_kernel). A second call repeats bit for
//   bit.
// Edges: query rows past Nq are zero and never summed or stored, key rows
// past Nk are never stored. Bounds on the H100 (five products at 67
// TFLOP/s): [32,16,1000,24] 1.83 ms, [1920,16,192,16] 2.70 ms; the partials
// add 2 x 4 B x key tiles x B*H*Nq*dh of traffic (0.79 GB at
// [32,16,1000,24], 1.13 GB at [1920,16,192,16]).
constexpr int NB_THREADS = 256;
constexpr int NB_ROWS = 64;             // stationary and streamed rows of a tile
constexpr int NB_LDP = NB_ROWS + 4;     // P / dS row stride

// The dK/dV products' split of a block's threads for outputs of DP columns,
// CN a thread: 16 row groups x DP / CN column groups, and the query rows in
// `slices` slices of `rows`.
template <int DP, int CN>
struct NarrowSplit {
  static_assert(DP % CN == 0 && CN % 2 == 0, "a thread's columns tile DP in pairs");
  static constexpr int groups = 16 * (DP / CN);
  static constexpr int slices = NB_THREADS / groups;
  static constexpr int rows = NB_ROWS / slices;
  static_assert(groups >= 32 && NB_THREADS % groups == 0, "a warp sums one slice");
};

template <int DP>
struct NarrowLayout {
  static constexpr int LD = DP + 4;
  static constexpr int CN = DP % 6 == 0 ? 6 : 4;  // dK, dV columns a thread
  static constexpr int tile = NB_ROWS * LD;
  static constexpr int s0 = 0, s1 = tile;  // K, V
  static constexpr int t0 = 2 * tile;      // Q, dO: stage st at t0 + 2 st tile
  static constexpr int p_off = 6 * tile;   // P
  static constexpr int ds_off = p_off + NB_ROWS * NB_LDP;
  static constexpr int row_off = ds_off + NB_ROWS * NB_LDP;  // [stage][lse, delta][64]
  static constexpr int floats = row_off + 4 * NB_ROWS;
  static constexpr size_t bytes = sizeof(float) * floats;
  // the partial sums (slices x 64 rows of DP + 1) overlay the tiles at the end
  static_assert(NarrowSplit<DP, CN>::slices * NB_ROWS * (DP + 1) <= floats,
                "partial sums fit the block's shared memory");
};

__device__ __forceinline__ const float* seq_ptr(const float* base, const BwdF32Args& a, Tensor t,
                                                int b, int h) {
  return base + b * a.s[t] + h * a.s[t + 1];
}

// Rows [n0, n0 + 64) of one sequence (row stride sn) into a 64 x DP tile of
// row stride DP + 4 by cp.async, zero past n and past dh.
template <int DP, bool VEC>
__device__ __forceinline__ void narrow_stage(float* dst, const float* src, long long sn, int n0,
                                             int n, int dh) {
  constexpr int LD = DP + 4;
  if constexpr (VEC) {
    for (int idx = threadIdx.x; idx < NB_ROWS * (DP / 4); idx += NB_THREADS) {
      const int r = idx / (DP / 4), c = 4 * (idx % (DP / 4));
      const bool ok = n0 + r < n && c < dh;
      cp_async16(dst + r * LD + c, ok ? src + (n0 + r) * sn + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < NB_ROWS * DP; idx += NB_THREADS) {
      const int r = idx / DP, c = idx % DP;
      const bool ok = n0 + r < n && c < dh;
      cp_async4(dst + r * LD + c, ok ? src + (n0 + r) * sn + c : src, ok);
    }
  }
}

// Values [n0, n0 + 64) of a contiguous fp32 row into dst by cp.async, zero
// past n.
__device__ __forceinline__ void narrow_stage_row(float* dst, const float* src, int n0, int n) {
  const int r = threadIdx.x;
  if (r < NB_ROWS) cp_async4(dst + r, n0 + r < n ? src + n0 + r : src, n0 + r < n);
}

// The 4 x 4 blocks of X Y^T and Z W^T: X, Z the thread's own rows, Y, W the
// streamed rows 16 j (all of row stride DP + 4).
template <int DP>
__device__ __forceinline__ void narrow_two_products(const float* X, const float* Y, const float* Z,
                                                    const float* W, float (&xy)[4][4],
                                                    float (&zw)[4][4]) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) xy[i][j] = zw[i][j] = 0.0f;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(X + i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 yv = *reinterpret_cast<const float4*>(Y + 16 * j * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) xy[i][j] = wide_dot4(xv[i], yv, xy[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(Z + i * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(W + 16 * j * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) zw[i][j] = wide_dot4(xv[i], wv, zw[i][j]);
    }
  }
}

// CN consecutive floats of a shared-memory row, in float4 or float2 loads.
template <int CN>
__device__ __forceinline__ void narrow_row(const float* p, float (&r)[CN]) {
  if constexpr (CN % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CN; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      r[c] = v.x, r[c + 1] = v.y, r[c + 2] = v.z, r[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CN; c += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + c);
      r[c] = v.x, r[c + 1] = v.y;
    }
  }
}

// acc[i][c] += w_i * row[c]
template <int CN>
__device__ __forceinline__ void narrow_axpy(float (&acc)[4][CN], const float4 w,
                                            const float (&row)[CN]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float wi = f4(w, i);
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(wi, row[c], acc[i][c]);
  }
}

// The block's 64 x DP output from the slices' partial sums (thread rg, cg,
// sl holds rows 4 rg + i, columns CN cg + c of slice sl): summed in slice
// order through shared memory R, which overlays the tiles, then written to
// rows n0 + r < n and columns < dh of out (row stride sn).
template <int DP, int CN>
__device__ __forceinline__ void narrow_store(float* R, const float (&acc)[4][CN], int rg, int cg,
                                             int sl, float* out, long long sn, int n0, int n,
                                             int dh) {
  constexpr int RLD = DP + 1, SLICES = NarrowSplit<DP, CN>::slices;
  __syncthreads();  // every read of the tiles (or of R) is done
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) R[(sl * NB_ROWS + 4 * rg + i) * RLD + CN * cg + c] = acc[i][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NB_ROWS * DP; idx += NB_THREADS) {
    const int r = idx / DP, c = idx % DP;
    if (n0 + r >= n || c >= dh) continue;
    float v = R[r * RLD + c];
#pragma unroll
    for (int s = 1; s < SLICES; ++s) v += R[(s * NB_ROWS + r) * RLD + c];
    out[(n0 + r) * sn + c] = v;
  }
}

// A query tile's share of dQ over the block's 64 keys, dS K, from the dS in
// shared memory (query-major). Thread (qr, qc, half) holds queries 4 qr + i
// and columns DP / 8 qc .. + DP / 8, summed over the keys of its half of the
// tile (a key past Nk has dS = 0) in steps of 4; lanes lane and lane ^ 16
// hold the two halves, and their sum, keys in order, goes to dq (Nk <= 64)
// or to the key tile's scratch partials.
template <int DP>
__device__ __forceinline__ void narrow_dq_share(const BwdF32Args& a, const float* Ks,
                                                const float* dSs, int bh, int k0, int q0) {
  constexpr int LD = DP + 4, QCN = DP / 8;
  const int tid = threadIdx.x, lane = tid % 32, half = lane / 16;
  const int qr = 2 * (tid / 32) + lane % 16 / 8, qc = lane % 8;
  float dq[4][QCN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < QCN; ++c) dq[i][c] = 0.0f;
  const int kb = 32 * half, ke = min(kb + 32, (a.Nk - k0 + 3) & ~3);
#pragma unroll 2
  for (int kk = kb; kk < ke; kk += 4) {
    float4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const float4*>(dSs + (4 * qr + i) * NB_LDP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float kr[QCN];
#pragma unroll
      for (int c = 0; c < QCN; ++c) kr[c] = Ks[(kk + u) * LD + QCN * qc + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < QCN; ++c) dq[i][c] = fmaf(f4(w[i], u), kr[c], dq[i][c]);
    }
  }
  // the first half's keys come first in the sum
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < QCN; ++c) {
      const float other = __shfl_xor_sync(0xffffffffu, dq[i][c], 16);
      dq[i][c] = half == 0 ? dq[i][c] + other : other + dq[i][c];
    }
  float* out;
  long long sn;
  if (a.scratch == nullptr) {
    out = a.dq + (bh / a.H) * a.s[TDQ] + (bh % a.H) * a.s[TDQ + 1];
    sn = a.s[TDQ + 2];
  } else {
    const long long per = static_cast<long long>(a.Nq) * a.dh;
    out = a.scratch + (static_cast<long long>(k0 / NB_ROWS) * a.BH + bh) * per;
    sn = a.dh;
  }
  // each of the two lanes writes two of the four rows
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = 2 * half + u, q = q0 + 4 * qr + i;
    if (q >= a.Nq) continue;
#pragma unroll
    for (int c = 0; c < QCN; ++c)
      if (QCN * qc + c < a.dh) out[q * sn + QCN * qc + c] = dq[i][c];
  }
}

// dK, dV of one 64-key tile over all queries, and the tile's share of dQ
// from the same S and dP: into dq where the tile holds every key (Nk <=
// 64), else into its key tile's slice of the scratch partials, which
// flash_bwd_f32_dq_sum_kernel adds.
template <int DP, bool VEC>
__global__ void __launch_bounds__(NB_THREADS, 2)
flash_bwd_f32_narrow_kernel(const BwdF32Args a) {
  using L = NarrowLayout<DP>;
  constexpr int LD = L::LD, CN = L::CN;
  using Split = NarrowSplit<DP, CN>;
  extern __shared__ __align__(16) float nbs[];
  float *Ks = nbs + L::s0, *Vs = nbs + L::s1, *Ps = nbs + L::p_off, *dSs = nbs + L::ds_off;
  const int tid = threadIdx.x;
  const TileIdx ti = tile_index(a.Nk, NB_ROWS);
  const int b = ti.bh / a.H, h = ti.bh % a.H, k0 = ti.tile * NB_ROWS;
  const float *qp = seq_ptr(a.q, a, TQ, b, h), *dop = seq_ptr(a.dout, a, TDO, b, h);
  const float* lsep = a.lse + static_cast<long long>(ti.bh) * a.Nq;
  const float* deltap = a.delta + static_cast<long long>(ti.bh) * a.Nq;
  const int n_tiles = (a.Nq + NB_ROWS - 1) / NB_ROWS;

  auto stage = [&](int t) {
    float* Qn = nbs + L::t0 + 2 * (t & 1) * L::tile;
    float* Rn = nbs + L::row_off + 2 * (t & 1) * NB_ROWS;
    narrow_stage<DP, VEC>(Qn, qp, a.s[TQ + 2], t * NB_ROWS, a.Nq, a.dh);
    narrow_stage<DP, VEC>(Qn + L::tile, dop, a.s[TDO + 2], t * NB_ROWS, a.Nq, a.dh);
    narrow_stage_row(Rn, lsep, t * NB_ROWS, a.Nq);
    narrow_stage_row(Rn + NB_ROWS, deltap, t * NB_ROWS, a.Nq);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  narrow_stage<DP, VEC>(Ks, seq_ptr(a.k, a, TK, b, h), a.s[TK + 2], k0, a.Nk, a.dh);
  narrow_stage<DP, VEC>(Vs, seq_ptr(a.v, a, TV, b, h), a.s[TV + 2], k0, a.Nk, a.dh);
  stage(0);

  // S phase: keys 4 rg + i against queries kg + 16 j; a key's bias (0.0 when
  // there is none leaves the logit exact), -inf past Nk, so its P and dS
  // are 0
  const int rg = tid / 16, kg = tid % 16;
  float kb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * rg + i;
    kb[i] = key >= a.Nk ? -CUDART_INF_F
                        : a.bias != nullptr ? a.bias[static_cast<long long>(b) * a.Nk + key]
                                            : 0.0f;
  }
  // products: keys 4 ra + i, columns CN cg .., queries of slice sl
  const int g = tid % Split::groups, sl = tid / Split::groups;
  const int ra = g % 16, cg = g / 16;
  float dk[4][CN], dv[4][CN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const float* Qs = nbs + L::t0 + 2 * (t & 1) * L::tile;
    const float* Gs = Qs + L::tile;
    const float* Ls = nbs + L::row_off + 2 * (t & 1) * NB_ROWS;
    const float* Ds = Ls + NB_ROWS;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile t landed; tile t - 1, P and dS consumed
    if (t + 1 < n_tiles) stage(t + 1);

    // S^T = K Q^T and dP^T = V dO^T
    float st[4][4], dpt[4][4];
    narrow_two_products<DP>(Ks + 4 * rg * LD, Qs + kg * LD, Vs + 4 * rg * LD, Gs + kg * LD, st,
                            dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = kg + 16 * j;
      const float lse = Ls[col], delta = Ds[col];
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = __fadd_rn(__fmul_rn(st[i][j], a.scale), kb[i]);
        p[i] = expf(__fsub_rn(s, lse));
        ds[i] = __fmul_rn(__fmul_rn(p[i], __fsub_rn(dpt[i][j], delta)), a.scale);
      }
      *reinterpret_cast<float4*>(Ps + col * NB_LDP + 4 * rg) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dSs + col * NB_LDP + 4 * rg) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the slice's valid queries
    const int qb = sl * Split::rows, qe = min(qb + Split::rows, a.Nq - t * NB_ROWS);
#pragma unroll 2
    for (int qi = qb; qi < qe; ++qi) {
      float o[CN], x[CN];
      narrow_row<CN>(Gs + qi * LD + CN * cg, o);
      narrow_row<CN>(Qs + qi * LD + CN * cg, x);
      narrow_axpy<CN>(dv, *reinterpret_cast<const float4*>(Ps + qi * NB_LDP + 4 * ra), o);
      narrow_axpy<CN>(dk, *reinterpret_cast<const float4*>(dSs + qi * NB_LDP + 4 * ra), x);
    }
    narrow_dq_share<DP>(a, Ks, dSs, ti.bh, k0, t * NB_ROWS);
  }
  narrow_store<DP, CN>(nbs, dv, ra, cg, sl, a.dv + b * a.s[TDV] + h * a.s[TDV + 1],
                       a.s[TDV + 2], k0, a.Nk, a.dh);
  narrow_store<DP, CN>(nbs, dk, ra, cg, sl, a.dk + b * a.s[TDK] + h * a.s[TDK + 1],
                       a.s[TDK + 2], k0, a.Nk, a.dh);
}


// fp32 operands at 64 < dh <= 128: a register-tiled kernel in the manner of
// flash_attention.cu's flash_fwd_f32_tiled_kernel, FFMA, no atomics, that
// forms S and dP once for all three grads (five products, not the seven of
// a dK/dV and a dQ kernel that each form them). A block of WIDE_THREADS
// owns a 64-key tile of one (batch, head) sequence (SEG = 1), or the keys
// of two sequences whose Nq and Nk are both at most 32 (SEG = 2: MD17's
// temporal axis, N = 30), with K and V in shared memory, and walks the
// queries in 64-row tiles of Q and dO, each copied by cp.async (16 bytes
// where bases, strides and dh allow it: VEC), dh zero-padded to WIDE_DP.
// - S and dP: thread (rg, kg), rg = 2 * warp + lane / 16, kg = lane % 16,
//   holds S^T and dP^T of its keys rg * 4 + i (i < 4) against the queries
//   kg + 16 j (j < 4 / SEG), two 4 x 4 blocks: per 4 columns of dh it reads
//   4 float4 of its own rows (shared by the 16 lanes of a half warp) and one
//   of each query row (16 rows at once, on distinct banks) for 16 FFMAs of
//   each product. Then P = exp(S * scale + bias - lse) and dS = P (dP -
//   delta) * scale, with the JAX kernels' rounding points; a key past Nk
//   gets a -inf bias and a query past Nq a +inf lse, so its P is 0. P and
//   dS go to shared memory query-major (a query's 64 keys).
// - The products: thread (prg, cg), prg = 4 * (warp / 2) + lane / 8, cg =
//   8 * (warp % 2) + lane % 8, holds rows prg * 4 + i and columns 4 cg .. + 4
//   and 64 + 4 cg .. + 4 of each output: dK and dV of its keys (64
//   accumulators; per query it reads one float4 of P or dS and two of dO or
//   Q a product), then the query tile's share of dQ over the block's keys
//   (32 accumulators; per 4 keys a float4 of dS for each of its queries and
//   two of each key's K row), written to dq where the block holds every key
//   and else to the key tile's slice of the scratch partials.
// One block an SM (~170 KB of shared memory: four 64 x 132 tiles, P and dS
// 64 x 68); SEG = 2 runs a warp's own segment only (its rows lie in one
// sequence), as the forward does. Bounds on the H100 (five products at 67
// TFLOP/s): [16,3,1000,128] 0.92 ms, [1920,2,192,128] 2.70 ms,
// [12288,2,30,128] 0.90 ms (bytes); the partials add 2 x 4 B x key tiles x
// B*H*Nq*dh of traffic (0.39 GB at [16,3,1000,128], 1.13 GB at
// [1920,2,192,128]).
constexpr int WB_RM = 4;               // stationary rows a thread holds
constexpr int WB_LDP = WIDE_KEYS + 4;  // P / dS rows of the kernel's 64 columns

struct WideBwdLayout {
  static constexpr int tile = WIDE_KEYS * WIDE_LDQK;
  static constexpr int s0 = 0;          // K, V
  static constexpr int s1 = tile;
  static constexpr int t0 = 2 * tile;   // Q, dO
  static constexpr int t1 = 3 * tile;
  static constexpr int p_off = 4 * tile;               // P
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

// Write rows prg * 4 + i of acc (columns 4 cg .. and 64 + 4 cg ..) to the
// tensor at base with (batch, head, seq) strides sb, sh, sn at the block's
// positions n0 + ..., those valid only.
template <int SEG, bool VEC>
__device__ __forceinline__ void wide_store(float* base, long long sb, long long sh, long long sn,
                                           int H, int dh, int bh0, bool ok1, int n0, int n,
                                           int prg, int cg, const float (&acc)[WB_RM][8]) {
#pragma unroll
  for (int i = 0; i < WB_RM; ++i) {
    int seq, pos;
    if (!wide_row<SEG>(prg * WB_RM + i, n0, n, ok1, seq, pos)) continue;
    const int bh = bh0 + seq;
    float* out = base + (bh / H) * sb + (bh % H) * sh + static_cast<long long>(pos) * sn;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 64 * half + 4 * cg;
      if constexpr (VEC) {
        if (c0 < dh)
          *reinterpret_cast<float4*>(out + c0) =
              make_float4(acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
                          acc[i][4 * half + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < dh) out[c0 + c] = acc[i][4 * half + c];
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

// dK, dV of one 64-key tile (or of two sequences' keys) over all queries,
// and the tile's share of dQ from the same S and dP: into dq where the tile
// holds every key (Nk <= 64, or SEG = 2), else into the scratch partials of
// its key tile, which flash_bwd_f32_dq_sum_kernel adds.
template <int SEG, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_f32_wide_kernel(const BwdF32Args a) {
  using L = WideBwdLayout;
  constexpr int JN = 4 / SEG;
  extern __shared__ __align__(16) float wbs[];
  float *Ks = wbs + L::s0, *Vs = wbs + L::s1, *Qs = wbs + L::t0, *Gs = wbs + L::t1;
  float *Ps = wbs + L::p_off, *dSs = wbs + L::ds_off;
  float *Ls = wbs + L::row_off, *Ds = Ls + WIDE_KEYS, *Bk = Ds + WIDE_KEYS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int bh0, k0;
  wide_block<SEG>(a.Nk, bh0, k0);
  const bool ok1 = SEG == 2 && bh0 + 1 < a.BH;
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
    {
      // dQ += dS K over the tile's keys: queries prg * 4 + i of the streamed
      // tile, the keys of their segment in steps of 4 (a key past Nk has
      // dS = 0); dS[q][k] is a query's row of the tile's keys
      float dq[WB_RM][8];
#pragma unroll
      for (int i = 0; i < WB_RM; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) dq[i][c] = 0.0f;
      const int kb = SEG == 1 ? 0 : (prg * WB_RM) / (WIDE_KEYS / 2) * (WIDE_KEYS / 2);
      const int ke = SEG == 1 ? min(WIDE_KEYS, (a.Nk - k0 + 3) & ~3) : kb + WIDE_KEYS / 2;
#pragma unroll 1
      for (int kk = kb; kk < ke; kk += 4) {
        float4 w[WB_RM];
#pragma unroll
        for (int i = 0; i < WB_RM; ++i)
          w[i] = *reinterpret_cast<const float4*>(dSs + (prg * WB_RM + i) * WB_LDP + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wide_axpy(dq, make_float4(f4(w[0], u), f4(w[1], u), f4(w[2], u), f4(w[3], u)),
                    Ks + (kk + u) * WIDE_LDQK + 4 * cg);
      }
      if (a.scratch == nullptr) {
        wide_store<SEG, VEC>(a.dq, a.s[TDQ], a.s[TDQ + 1], a.s[TDQ + 2], a.H, a.dh, bh0, ok1,
                             q0, a.Nq, prg, cg, dq);
      } else {
        const long long sn = a.dh, sh = sn * a.Nq, sb = sh * a.H;
        wide_store<SEG, VEC>(a.scratch + (k0 / WIDE_KEYS) * (sh * a.BH), sb, sh, sn, a.H, a.dh,
                             bh0, ok1, q0, a.Nq, prg, cg, dq);
      }
    }
    __syncthreads();  // Q, dO, P and dS consumed before the next copies
  }
  wide_store<SEG, VEC>(a.dk, a.s[TDK], a.s[TDK + 1], a.s[TDK + 2], a.H, a.dh, bh0, ok1, k0,
                       a.Nk, prg, cg, dk);
  wide_store<SEG, VEC>(a.dv, a.s[TDV], a.s[TDV + 1], a.s[TDV + 2], a.H, a.dh, bh0, ok1, k0,
                       a.Nk, prg, cg, dv);
}

// dq = the sum of a one-pass kernel's dQ shares over the key tiles, in tile
// order: a thread 4 (VEC) or 1 of a row's dh values.
template <bool VEC>
__global__ void __launch_bounds__(256) flash_bwd_f32_dq_sum_kernel(const BwdF32Args a,
                                                                   int tiles) {
  constexpr int W = VEC ? 4 : 1;
  const long long per = static_cast<long long>(a.BH) * a.Nq * a.dh;
  for (long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * W;
       e < per; e += static_cast<long long>(gridDim.x) * blockDim.x * W) {
    const int c = static_cast<int>(e % a.dh);
    const long long row = e / a.dh;
    const int n = static_cast<int>(row % a.Nq), bh = static_cast<int>(row / a.Nq);
    float* out = a.dq + (bh / a.H) * a.s[TDQ] + (bh % a.H) * a.s[TDQ + 1] + n * a.s[TDQ + 2] + c;
    if constexpr (VEC) {
      float4 v = __ldcs(reinterpret_cast<const float4*>(a.scratch + e));
      for (int t = 1; t < tiles; ++t) {
        const float4 u = __ldcs(reinterpret_cast<const float4*>(a.scratch + t * per + e));
        v.x += u.x, v.y += u.y, v.z += u.z, v.w += u.w;
      }
      *reinterpret_cast<float4*>(out) = v;
    } else {
      float v = __ldcs(a.scratch + e);
      for (int t = 1; t < tiles; ++t) v += __ldcs(a.scratch + t * per + e);
      *out = v;
    }
  }
}

// After a one-pass kernel: the launch error, or, where it wrote dQ shares
// (a.scratch set), the sum kernel's.
template <bool VEC>
cudaError_t launch_dq_sum(const BwdF32Args& a, cudaStream_t stream) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.scratch == nullptr) return err;
  const long long items = static_cast<long long>(a.BH) * a.Nq * a.dh / (VEC ? 4 : 1);
  const long long blocks = (items + 255) / 256;
  flash_bwd_f32_dq_sum_kernel<VEC><<<static_cast<unsigned>(blocks < 132 * 64 ? blocks : 132 * 64),
                                     256, 0, stream>>>(a, (a.Nk + 63) / 64);
  return cudaGetLastError();
}

// The wide kernel, then the dQ shares' sum where there is more than one key
// tile (a.scratch set).
template <int SEG, bool VEC>
cudaError_t launch_f32_wide(const BwdF32Args& a, cudaStream_t stream) {
  constexpr size_t smem = WideBwdLayout::bytes;
  static cudaError_t attr = lam_set_smem(flash_bwd_f32_wide_kernel<SEG, VEC>, smem);
  if (attr != cudaSuccess) return attr;
  const unsigned grid = SEG == 1 ? grid_blocks(a.BH, a.Nk, WIDE_KEYS)
                                 : static_cast<unsigned>((a.BH + 1) / 2);
  flash_bwd_f32_wide_kernel<SEG, VEC><<<grid, WIDE_THREADS, smem, stream>>>(a);
  return launch_dq_sum<VEC>(a, stream);
}

// The narrow kernel, then the dQ shares' sum where there is more than one
// key tile (a.scratch set).
template <int DP, bool VEC>
cudaError_t launch_f32_narrow(const BwdF32Args& a, cudaStream_t stream) {
  constexpr size_t smem = NarrowLayout<DP>::bytes;
  static cudaError_t attr = lam_set_smem(flash_bwd_f32_narrow_kernel<DP, VEC>, smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_f32_narrow_kernel<DP, VEC>
      <<<grid_blocks(a.BH, a.Nk, NB_ROWS), NB_THREADS, smem, stream>>>(a);
  return launch_dq_sum<VEC>(a, stream);
}

// The narrow kernel at the padded width dp of the wrapper's f32_narrow_plan.
template <bool VEC>
cudaError_t launch_f32_narrow_dp(const BwdF32Args& a, int dp, cudaStream_t st) {
  switch (dp) {
    case 8: return launch_f32_narrow<8, VEC>(a, st);
    case 16: return launch_f32_narrow<16, VEC>(a, st);
    case 24: return launch_f32_narrow<24, VEC>(a, st);
    case 32: return launch_f32_narrow<32, VEC>(a, st);
    case 48: return launch_f32_narrow<48, VEC>(a, st);
    case 64: return launch_f32_narrow<64, VEC>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

// The one-pass kernels: the narrow one at dh <= 64 (plan: its padded width),
// the wide one at 64 < dh <= 128 (plan: its sequences a block); scratch for
// the dQ shares where more than one key tile covers the keys, else null.
int launch_bwd_f32_one_pass(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* bias, void* dq,
                            void* dk, void* dv, void* scratch, int B, int H, int Nq, int Nk,
                            int dh, const long long* strides, float scale, int plan,
                            void* stream) {
  const bool wide = dh > 64;
  const bool one_tile = (wide && plan == 2) || Nk <= WIDE_KEYS;
  if (dh <= 0 || dh > WIDE_DP || Nq <= 0 || Nk <= 0 || one_tile != (scratch == nullptr) ||
      (wide ? (plan != 1 && plan != 2) || (plan == 2 && (Nq > 32 || Nk > 32))
            : plan < dh || plan > 64 || plan % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(dout),
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const float*>(bias), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv), H, Nq, Nk, dh, {}, scale,
               static_cast<float*>(scratch), B * H};
  for (int i = 0; i < 21; ++i) a.s[i] = strides[i];
  // 16-byte copies where every base and stride allows them and dh % 4 == 0
  const void* ptrs[8] = {q, k, v, dout, dq, dk, dv, scratch};
  unsigned long long bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<unsigned long long>(p);
  for (int i = 0; i < 21; ++i) bits |= 4ull * static_cast<unsigned long long>(strides[i]);
  const bool vec = (bits & 15) == 0 && dh % 4 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!wide)
    err = vec ? launch_f32_narrow_dp<true>(a, plan, st)
              : launch_f32_narrow_dp<false>(a, plan, st);
  else if (plan == 2)
    err = vec ? launch_f32_wide<2, true>(a, st) : launch_f32_wide<2, false>(a, st);
  else
    err = vec ? launch_f32_wide<1, true>(a, st) : launch_f32_wide<1, false>(a, st);
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

// fp32 q/k/v/dout and dq/dk/dv (dh <= 128) with the strides, lse, delta and
// optional bias of the entries above, in one pass over the key tiles: one
// kernel writes dk, dv and each key tile's share of dq, from S and dP formed
// once. plan: at dh <= 64 the narrow kernel's padded width (the wrapper's
// f32_narrow_plan: 8, 16, 24, 32, 48 or 64, at least dh), at 64 < dh <= 128
// the wide kernel's sequences a block (f32_wide_plan: 1, or 2 where Nq and
// Nk are at most 32). scratch, fp32 [ceil(Nk / 64)][B*H][Nq][dh], takes the
// shares and a second kernel adds them in tile order into dq; it is null
// where one key tile holds every key (Nk <= 64, or plan 2 at dh > 64) and
// the first kernel writes dq itself.
extern "C" int lam_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dq, void* dk, void* dv, void* scratch, int B,
    int H, int Nq, int Nk, int dh, const long long* strides, float scale, int plan,
    void* stream) {
  return launch_bwd_f32_one_pass(q, k, v, dout, lse, delta, bias, dq, dk, dv, scratch, B, H, Nq,
                                 Nk, dh, strides, scale, plan, stream);
}
