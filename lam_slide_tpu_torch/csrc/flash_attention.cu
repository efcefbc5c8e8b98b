// Flash-attention forward for Hopper (sm_90a) on the first tensor-core
// template: bf16 in / bf16 out with a key-padding bias row, K10's variant
// with the per-head QK RMS-norm + RoPE applied inside the kernel in its
// lane form, and an fp32 in / fp32 out kernel with an optional bias.
//
// Replaces these Pallas TPU kernels, or variants of them (the unmasked bf16
// K1 and K3 moved to flash_fwd_sm90.cu, which was redesigned for Hopper; K5
// runs on that kernel after the write-once transform of qk_normrope.cu):
// - K1, lam_slide_tpu/ops/flash_attention.py `_flash_kernel` (pallas_call in
//   `_flash_forward`), the head-major forward, with its key-padding bias and
//   with fp32 operands; q/k/v/o are read and written through per-tensor
//   (batch, head, seq) strides with unit stride on dh, so they can be views
//   of packed buffers;
// - K10, lam_slide_tpu/ops/ablations/fused_temporal_attention.py `_kernel`
//   (pallas_call in `_fused_forward`): the XF_LANE instantiation, packed
//   strides with the QK transform of each tile in shared memory in the lane
//   form of the JAX op. Its scales are [D] lane scales and its tables [T, D]
//   lane tables (D = H*dh), read at the head's lane offset h*dh, so any
//   table the JAX op accepts gives its result, not only tiled ones; and it
//   rounds once, after norm and RoPE together (lam_rmsnorm_rope_lanes).
//   The JAX kernel keeps a whole key row per query block; the online-softmax
//   recurrence here computes the same function.
//
// Design: one thread block = one (batch*head, 64-row query tile), 4 warps of
// 16 query rows each. The block loops over 64-key K/V tiles staged in shared
// memory and keeps the running softmax (m, l, acc) in fp32. Products run on
// the tensor cores through WMMA (bf16 operands, fp32 accumulation): S = Q K^T
// per warp into shared memory, the fp32 softmax update by the warp's lanes
// (two lanes per row), P rounded to bf16, then acc += P V with the
// accumulator kept in shared memory so that each row can be rescaled.
// dh is zero-padded to DP (32, 64 or 128) in shared memory only; keys >= Nk
// on the last tile get a -inf logit (weight exactly 0). At
// DP=128 the tiles take ~113 KB of shared memory (Q, K, V and S at 17 KB,
// P 9 KB, the fp32 accumulator 33 KB), so the K transform reuses the K tile.
//
// What bounds it on the H100: at the 4AA temporal shape (N=1000, dh=24) a
// call is ~4*N^2*32 FLOPs per head with no score matrix in device memory,
// so it is bound by the tensor-core and shared-memory work per tile, not
// by HBM bytes (q/k/v are ~150 KB per head). This first version favours
// clarity: WMMA through shared memory, scalar tile loads, no cp.async/TMA
// pipelining and no wgmma; those are the levers for making it fast. K10's
// transform is redone for every (query tile, key tile) pair, as in the TPU
// kernel: 16x the minimal norm/rope work at N=1000, all on chip.
//
// Numerics (docs/PERF.md "Kernel numerics"): bf16 operands, fp32 logits
// and statistics, P rounded to bf16 before the AV product, output in q's
// dtype (bf16), division by max(l, 1e-30) as in the JAX kernel.
//
// Key-padding bias (`_mask_to_bias`, flash_attention.py:624-629): when the
// caller passes an fp32 [B, Nk] row (0 on kept keys, -0.7*FLT_MAX on masked
// ones), it is added to the scaled logits of every key tile before the
// running max, broadcast over heads and queries, as `_flash_kernel` adds
// `bias_ref` (flash_attention.py:90-91). A masked key's logit rounds to
// exactly -0.7*FLT_MAX, so a row whose keys are all masked gets uniform
// weights over its Nk keys, as in JAX; padded keys past Nk stay at -inf,
// below any masked key, so they never share that weight.
//
// fp32 operands (stage 1 runs in fp32, composites/md17.py:93, and the fp32
// sampling DiT of the MD17 --test pass and the 4AA eval): FFMA on the CUDA
// cores (no TF32: the JAX interpret path it is held to is exact fp32), the
// same online softmax and bias, in two register-tiled kernels that hold,
// as a SIMT GEMM does, a thread's block of the scores and of the output:
// for dh <= 64 (the 4AA DiT's dh 24, MD17's dh 16) the narrow kernel
// (flash_fwd_f32_narrow_kernel below: 64-row blocks of 256 threads, a
// thread 4 x 4 scores and, over a quarter of each key tile, 4 x dh/4
// outputs, dh padded to a multiple of 8, three blocks an SM at dh <= 16 and
// two above); for 64 < dh <= 128 (the 2 x 128 and 3 x 128 DiTs, through
// K5's transform)
// flash_fwd_f32_tiled_kernel: a thread a 4 x 4 block of a 64 x 64 score
// tile and a 4 x 8 block of the output, so a 16-byte shared load feeds 8 to
// 10.7 FFMAs. Each score takes one expf. Bound on the H100: bytes at the
// stage-1 cross-attention (keys 32, dh 16; ~0.13 ms), operations over
// N >= 192 (0.68 ms at [9600,2,192,16], 72.5 GFLOP and ~1.08 ms at
// [1920,2,192,128]), bytes over MD17's T = 30 (~0.45 ms at
// [12288,2,30,128]).
//
// lse: when the caller passes an fp32 [B, H, Nq] buffer (training), each
// query row of either kernel also writes m + log(max(l, 1e-30)), the
// log-sum-exp the backward kernels (flash_attention_bwd.cu) rebuild P from,
// as `_flash_forward(..., with_lse=True)` does; a null pointer (sampling)
// writes nothing. An all-masked row's lse rounds to the mask fill itself
// (log(Nk) is far below its ulp), as in JAX.

#include <math_constants.h>
#include <mma.h>

#include "flash_tiles.cuh"

using namespace nvcuda;
using namespace lam_flash;

namespace {

template <int DP>
struct Layout {
  static constexpr int LDT = DP + 8;  // bf16 Q/K/V tile row stride
  static constexpr int LDS = BK + 4;  // fp32 logits row stride
  static constexpr int LDP = BK + 8;  // bf16 probabilities row stride
  static constexpr int LDA = DP + 4;  // fp32 accumulator row stride
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = lam_align128(q_off + BQ * LDT * sizeof(bf16));
  static constexpr size_t v_off = lam_align128(k_off + BK * LDT * sizeof(bf16));
  static constexpr size_t s_off = lam_align128(v_off + BK * LDT * sizeof(bf16));
  static constexpr size_t p_off = lam_align128(s_off + NWARPS * 16 * LDS * sizeof(float));
  static constexpr size_t a_off = lam_align128(p_off + NWARPS * 16 * LDP * sizeof(bf16));
  static constexpr size_t bytes = lam_align128(a_off + NWARPS * 16 * LDA * sizeof(float));
};

// The transform of the q/k tiles in shared memory: none (K1), or K10's lane
// form (scales [H*dh], tables [>= max(Nq, Nk), H*dh], one rounding, eps
// given) on RAW q/k.
enum Transform : int { XF_NONE = 0, XF_LANE = 2 };

__device__ __forceinline__ void transform_tile(bf16* tile, int ld, int n0, int n, int dh, int h,
                                               int H, const float* scale, const float* cos,
                                               const float* sin, float eps) {
  normrope_lane_tile(tile, ld, n0, n, dh, h * dh, H * dh, scale, cos, sin, eps);
}

// XF: the tile transform above. BIAS: add the key-padding bias row (a
// separate instantiation, so the unmasked kernels keep their inner loop as
// it was).
template <int DP, int XF, bool BIAS>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 const float* __restrict__ bias, const float* __restrict__ qs,
                 const float* __restrict__ ks,
                 const float* __restrict__ cos, const float* __restrict__ sin,
                 int H, int Nq, int Nk, int dh,
                 long long q_sb, long long q_sh, long long q_sn,
                 long long k_sb, long long k_sh, long long k_sn,
                 long long v_sb, long long v_sh, long long v_sn,
                 long long o_sb, long long o_sh, long long o_sn, float scale, float eps) {
  using Lay = Layout<DP>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP, LDA = Lay::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Lay::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::v_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Ss = reinterpret_cast<float*>(smem + Lay::s_off) + warp * 16 * LDS;
  bf16* Ps = reinterpret_cast<bf16*>(smem + Lay::p_off) + warp * 16 * LDP;
  float* As = reinterpret_cast<float*>(smem + Lay::a_off) + warp * 16 * LDA;

  const TileIdx ti = tile_index(Nq, BQ);
  const int b = ti.bh / H, h = ti.bh % H;
  const int q0 = ti.tile * BQ;
  const bf16* qp = q + b * q_sb + h * q_sh;
  const bf16* kp = k + b * k_sb + h * k_sh;
  const bf16* vp = v + b * v_sb + h * v_sh;

  load_tile<DP>(Qs, LDT, qp, q_sn, q0, Nq, dh);
  if constexpr (XF != XF_NONE) {
    __syncthreads();
    transform_tile(Qs, LDT, q0, Nq, dh, h, H, qs, cos, sin, eps);
  }
  for (int i = lane; i < 16 * LDA; i += 32) As[i] = 0.0f;

  // lane owns query row r of its warp's 16, and half of its columns
  const int r = lane >> 1, half = lane & 1;
  float m = NEG_INF, l = 0.0f;
  const int n_tiles = (Nk + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP>(Ks, LDT, kp, k_sn, kt * BK, Nk, dh);
    load_tile<DP>(Vs, LDT, vp, v_sn, kt * BK, Nk, dh);
    __syncthreads();
    if constexpr (XF != XF_NONE) {
      transform_tile(Ks, LDT, kt * BK, Nk, dh, h, H, ks, cos, sin, eps);
      __syncthreads();
    }

    // S = Q K^T for this warp's 16 rows x 64 keys, fp32 accumulation
#pragma unroll
    for (int jn = 0; jn < BK / 16; ++jn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * LDT + kd * 16, LDT);
        wmma::load_matrix_sync(bt, Ks + jn * 16 * LDT + kd * 16, LDT);
        wmma::mma_sync(c, a, bt, c);
      }
      wmma::store_matrix_sync(Ss + jn * 16, c, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update for row r over columns [half*32, half*32 + 32)
    const int key0 = kt * BK + half * 32;
    float sv[32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float s = Ss[r * LDS + half * 32 + j] * scale;
      if (key0 + j >= Nk)
        s = -CUDART_INF_F;
      else if constexpr (BIAS)
        s = __fadd_rn(s, bias[static_cast<long long>(b) * Nk + key0 + j]);
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_new);
      sum += p;
      Ps[r * LDP + half * 32 + j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) As[r * LDA + c] *= alpha;
    __syncwarp();

    // acc += P V
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, As + dn * 16, LDA, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + kk * 16, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * LDT + dn * 16, LDT);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(As + dn * 16, acc, LDA, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int qrow = q0 + warp * 16 + r;
  if (qrow < Nq) {
    const float denom = fmaxf(l, 1e-30f);
    bf16* op = o + b * o_sb + h * o_sh + static_cast<long long>(qrow) * o_sn;
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2) && c < dh; ++c)
      op[c] = __float2bfloat16(As[r * LDA + c] / denom);
    if (lse != nullptr && half == 0)
      lse[static_cast<long long>(ti.bh) * Nq + qrow] = m + logf(denom);
  }
}

struct NormRope {
  const float *qs, *ks, *cos, *sin;
  float eps;
};

template <int DP, int XF, bool BIAS>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   const float* bias, NormRope nr, int B, int H, int Nq, int Nk, int dh,
                   const long long* s, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<DP>::bytes;
  static cudaError_t attr = lam_set_smem(flash_fwd_kernel<DP, XF, BIAS>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(grid_blocks(B * H, Nq, BQ));
  flash_fwd_kernel<DP, XF, BIAS><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, bias, nr.qs, nr.ks, nr.cos, nr.sin, H, Nq, Nk, dh, s[0], s[1], s[2],
      s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale, nr.eps);
  return cudaGetLastError();
}

template <int XF, bool BIAS>
cudaError_t launch_dp(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                      const float* bias, NormRope nr, int B, int H, int Nq, int Nk, int dh,
                      const long long* s, float scale, cudaStream_t st) {
  if (dh <= 32)
    return launch<32, XF, BIAS>(q, k, v, o, lse, bias, nr, B, H, Nq, Nk, dh, s, scale, st);
  if (dh <= 64)
    return launch<64, XF, BIAS>(q, k, v, o, lse, bias, nr, B, H, Nq, Nk, dh, s, scale, st);
  return launch<128, XF, BIAS>(q, k, v, o, lse, bias, nr, B, H, Nq, Nk, dh, s, scale, st);
}

template <int XF>
int launch_dh(const void* q, const void* k, const void* v, void* o, void* lse,
              const void* bias, NormRope nr, int B, int H, int Nq, int Nk, int dh,
              const long long* s, float scale, void* stream) {
  constexpr bool NR = XF != XF_NONE;
  if (dh <= 0 || dh > 128 || (NR && (dh % 2 || bias != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto qb = static_cast<const bf16*>(q);
  auto kb = static_cast<const bf16*>(k);
  auto vb = static_cast<const bf16*>(v);
  auto ob = static_cast<bf16*>(o);
  auto lf = static_cast<float*>(lse);
  auto bf = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (NR)
    err = launch_dp<XF, false>(qb, kb, vb, ob, lf, bf, nr, B, H, Nq, Nk, dh, s, scale, st);
  else if (bias == nullptr)  // unmasked bf16 K1/K3: flash_fwd_sm90.cu
    return static_cast<int>(cudaErrorInvalidValue);
  else
    err = launch_dp<XF_NONE, true>(qb, kb, vb, ob, lf, bf, nr, B, H, Nq, Nk, dh, s, scale, st);
  return static_cast<int>(err);
}

// fp32 operands at dh <= 64 (the 4AA fp32 DiT's dh 24 through K3, MD17's
// dh 16: stage 1 with and without the bias, and the fp32 DiT's K3):
// register-tiled FFMA in the narrow geometry of K4's fp32 kernel
// (flash_attention_bwd.cu). A block of NF_THREADS takes 64 query rows of
// one (batch, head) sequence and walks the keys in tiles of KT (the
// wrapper's f32_narrow_fwd_plan: 64, or 32 where Nk <= 32, stage 1's padded
// atoms, so that tile is not half empty);
// the K and V tiles and the bias slice are double-buffered by cp.async (16
// bytes where bases, strides and dh allow it: VEC), dh zero-padded to DP,
// the next of 8, 16, 24, 32, 48, 64, in shared memory only, in rows of
// DP + 4 floats (16 rows read at once fall on distinct banks).
// - S = Q K^T: thread (rg, kg) = (tid / 16, tid % 16) holds the scores of
//   query rows 4 rg + i and keys kg + 16 j (i < 4, j < KT / 16): per 4
//   columns of dh it reads 4 float4 of Q (one address a half warp) and
//   KT / 16 of K (16 rows at once), one FMA chain over dh a score.
// - The softmax keeps a row in the 16 lanes of one half warp, as the
//   register-tiled kernel at dh 128 does: the tile's row max by four xor
//   shuffles, one expf a score, each lane's partial row sum rescaled by
//   alpha. P goes to shared memory key-major, alpha beside it.
// - O = P V: thread (sl, ro, co) sums slice sl of the tile's keys (KT / 4
//   of them) into query rows 4 ro + i and columns DP / 4 co .. + DP / 4:
//   per key a float4 of P and DP / 4 floats of V for DP FFMAs, with no
//   padding past the keys that exist. The four slices' partial outputs,
//   each rescaled by alpha at every tile, meet once at the end of the block
//   in shared memory, summed in slice order, so a result repeats bit for
//   bit.
// Two blocks an SM (at most 128 registers a thread; 54 KB of shared memory
// at DP 24), three at DP <= 16 (at most 85 registers). Bound on the H100:
// operations (4 dh FLOPs a score; 0.0917 ms at [4,1000,384] 16 x dh 24),
// or bytes where the keys are few (stage 1's cross-attention over 32
// atoms).
constexpr int NF_THREADS = 256;
constexpr int NF_ROWS = 64;          // query rows a block
constexpr int NF_LDP = NF_ROWS + 4;  // P^T: a key's row of 64 probabilities
constexpr int NF_SLICES = 4;         // key slices of O = P V

template <int DP, int KT>
struct NarrowFwdLayout {
  static constexpr int LD = DP + 4;
  static constexpr int k_off = NF_ROWS * LD;          // Q [64][LD] at 0, K [2][KT][LD]
  static constexpr int v_off = k_off + 2 * KT * LD;   // V [2][KT][LD]
  static constexpr int p_off = v_off + 2 * KT * LD;   // P^T [KT][NF_LDP]
  static constexpr int b_off = p_off + KT * NF_LDP;   // the bias slice [2][KT]
  static constexpr int tiles = b_off + 2 * KT;
  // the slices' partial outputs [NF_SLICES][64][DP + 1] overlay the tiles at the end
  static constexpr int partials = NF_SLICES * NF_ROWS * (DP + 1);
  static constexpr int a_off = tiles > partials ? tiles : partials;  // alpha [64]
  static constexpr int l_off = a_off + NF_ROWS;                      // l [64]
  static constexpr size_t bytes = sizeof(float) * (l_off + NF_ROWS);
};

// Rows [n0, n0 + rows) of one sequence (row stride sn) into a [rows][DP + 4]
// tile by cp.async, zero past n and past dh.
template <int DP, bool VEC>
__device__ __forceinline__ void narrow_fwd_stage(float* dst, const float* src, long long sn,
                                                 int rows, int n0, int n, int dh) {
  constexpr int LD = DP + 4;
  if constexpr (VEC) {
    for (int idx = threadIdx.x; idx < rows * (DP / 4); idx += NF_THREADS) {
      const int r = idx / (DP / 4), c = 4 * (idx % (DP / 4));
      const bool ok = n0 + r < n && c < dh;
      cp_async16(dst + r * LD + c, ok ? src + (n0 + r) * sn + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * DP; idx += NF_THREADS) {
      const int r = idx / DP, c = idx % DP;
      const bool ok = n0 + r < n && c < dh;
      cp_async4(dst + r * LD + c, ok ? src + (n0 + r) * sn + c : src, ok);
    }
  }
}

// CN consecutive floats of a shared-memory row, in float4 or float2 loads.
template <int CN>
__device__ __forceinline__ void narrow_fwd_row(const float* p, float (&r)[CN]) {
  if constexpr (CN % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CN; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      r[c] = x.x, r[c + 1] = x.y, r[c + 2] = x.z, r[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CN; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + c);
      r[c] = x.x, r[c + 1] = x.y;
    }
  }
}

// Blocks an SM: three at dh <= 16 (MD17's short axes over 192 or 32 keys,
// where a block's prologue and epilogue weigh most: 0.6062 against 0.7373 ms
// at [1920,8,192->32,16] on an H100), else two (0.2634 against 0.2694 at
// [4,16,1000,24]; tools/kernel_variants.py K1-fp32-narrow).
template <int DP>
constexpr int nf_blocks_per_sm() { return DP <= 16 ? 3 : 2; }

template <int DP, int KT, bool VEC>
__global__ void __launch_bounds__(NF_THREADS, nf_blocks_per_sm<DP>())
flash_fwd_f32_narrow_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, const float* __restrict__ bias, int H,
                            int Nq, int Nk, int dh,
                            long long q_sb, long long q_sh, long long q_sn,
                            long long k_sb, long long k_sh, long long k_sn,
                            long long v_sb, long long v_sh, long long v_sn,
                            long long o_sb, long long o_sh, long long o_sn, float scale) {
  using L = NarrowFwdLayout<DP, KT>;
  constexpr int LD = L::LD, JN = KT / 16, CO = DP / 4, SK = KT / NF_SLICES;
  extern __shared__ __align__(16) float nfs[];
  float* Qs = nfs;
  float* Ps = nfs + L::p_off;
  float* As = nfs + L::a_off;
  float* Ls = nfs + L::l_off;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const TileIdx ti = tile_index(Nq, NF_ROWS);
  const int b = ti.bh / H, h = ti.bh % H, q0 = ti.tile * NF_ROWS;
  const float* kp = k + b * k_sb + h * k_sh;
  const float* vp = v + b * v_sb + h * v_sh;
  const float* bp = bias == nullptr ? nullptr : bias + static_cast<long long>(b) * Nk;

  // tile t of K, V and the bias into stage t % 2; without a bias both
  // stages' slices stay 0, and 0.0 leaves a logit exact
  auto stage = [&](int t) {
    const int st = t & 1, k0 = t * KT;
    narrow_fwd_stage<DP, VEC>(nfs + L::k_off + st * KT * LD, kp, k_sn, KT, k0, Nk, dh);
    narrow_fwd_stage<DP, VEC>(nfs + L::v_off + st * KT * LD, vp, v_sn, KT, k0, Nk, dh);
    if (bp != nullptr && tid < KT)
      cp_async4(nfs + L::b_off + st * KT + tid, k0 + tid < Nk ? bp + k0 + tid : bp,
                k0 + tid < Nk);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (bp == nullptr && tid < 2 * KT) nfs[L::b_off + tid] = 0.0f;
  narrow_fwd_stage<DP, VEC>(Qs, q + b * q_sb + h * q_sh, q_sn, NF_ROWS, q0, Nq, dh);
  stage(0);

  const int rg = tid / 16, kg = tid % 16;  // S and the softmax
  const int sl = warp / 2, ro = 8 * (warp % 2) + lane / 4, co = lane % 4;  // O = P V
  float m[4], lp[4], acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    lp[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.0f;
  }
  const int n_tiles = (Nk + KT - 1) / KT;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * KT;
    const float* Ks = nfs + L::k_off + (t & 1) * KT * LD;
    const float* Vs = nfs + L::v_off + (t & 1) * KT * LD;
    const float* Bs = nfs + L::b_off + (t & 1) * KT;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile t (and Q) landed; tile t - 1's P and V consumed
    if (t + 1 < n_tiles) stage(t + 1);

    // S: rows 4 rg + i, tile keys kg + 16 j
    float sc[4][JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) sc[i][j] = 0.0f;
    const float* qrow = Qs + 4 * rg * LD;
    const float* krow = Ks + kg * LD;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qrow + i * LD + d);
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + 16 * j * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][j] = wide_dot4(qv[i], kv, sc[i][j]);
      }
    }
    // the scaled logit rounds before the bias add, as in JAX; keys past Nk: -inf
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int col = kg + 16 * j;
        sc[i][j] = k0 + col < Nk ? __fadd_rn(__fmul_rn(sc[i][j], scale), Bs[col])
                                 : -CUDART_INF_F;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        sum += p;
      }
      lp[i] = lp[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < JN; ++j)
      *reinterpret_cast<float4*>(Ps + (kg + 16 * j) * NF_LDP + 4 * rg) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    if (kg == 0)
      *reinterpret_cast<float4*>(As + 4 * rg) = make_float4(alpha[0], alpha[1], alpha[2], alpha[3]);
    __syncthreads();  // P^T and alpha in place

    // O = O * alpha + P V over the slice's keys that exist
    const float4 al = *reinterpret_cast<const float4*>(As + 4 * ro);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= f4(al, i);
    const int kb = sl * SK, ke = min(kb + SK, Nk - k0);
    const float* prow = Ps + 4 * ro;
    const float* vrow = Vs + CO * co;
#pragma unroll 4
    for (int kk = kb; kk < ke; ++kk) {
      const float4 pv = *reinterpret_cast<const float4*>(prow + kk * NF_LDP);
      float vr[CO];
      narrow_fwd_row<CO>(vrow + kk * LD, vr);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(f4(pv, i), vr[c], acc[i][c]);
    }
  }

  // l over the row's 16 lanes and the lse; then the slices' partial outputs
  // summed in slice order, divided by max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = lp[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int r = 4 * rg + i;
    if (kg == 0) {
      Ls[r] = l;
      if (lse != nullptr && q0 + r < Nq)
        lse[static_cast<long long>(ti.bh) * Nq + q0 + r] = m[i] + logf(fmaxf(l, 1e-30f));
    }
  }
  __syncthreads();  // every read of the tiles is done: the partials overlay them
  constexpr int RLD = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) nfs[(sl * NF_ROWS + 4 * ro + i) * RLD + CO * co + c] = acc[i][c];
  __syncthreads();
  float* op = o + b * o_sb + h * o_sh;
  for (int idx = tid; idx < NF_ROWS * DP; idx += NF_THREADS) {
    const int r = idx / DP, c = idx % DP;
    if (q0 + r >= Nq || c >= dh) continue;
    float y = nfs[r * RLD + c];
#pragma unroll
    for (int s = 1; s < NF_SLICES; ++s) y += nfs[(s * NF_ROWS + r) * RLD + c];
    op[(q0 + r) * o_sn + c] = y / fmaxf(Ls[r], 1e-30f);
  }
}

template <int DP, int KT, bool VEC>
cudaError_t launch_f32_narrow(const float* q, const float* k, const float* v, float* o,
                              float* lse, const float* bias, int B, int H, int Nq, int Nk,
                              int dh, const long long* s, float scale, cudaStream_t stream) {
  constexpr size_t smem = NarrowFwdLayout<DP, KT>::bytes;
  static cudaError_t attr = lam_set_smem(flash_fwd_f32_narrow_kernel<DP, KT, VEC>, smem);
  if (attr != cudaSuccess) return attr;
  flash_fwd_f32_narrow_kernel<DP, KT, VEC>
      <<<grid_blocks(B * H, Nq, NF_ROWS), NF_THREADS, smem, stream>>>(
          q, k, v, o, lse, bias, H, Nq, Nk, dh, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
          s[8], s[9], s[10], s[11], scale);
  return cudaGetLastError();
}

// The narrow kernel at the padded width dp and key tile (32 or 64) of the
// wrapper's f32_narrow_fwd_plan.
template <bool VEC>
cudaError_t launch_f32_narrow_dp(const float* q, const float* k, const float* v, float* o,
                                 float* lse, const float* bias, int B, int H, int Nq, int Nk,
                                 int dh, const long long* s, float scale, int dp, int keys,
                                 cudaStream_t st) {
#define LAM_NARROW_FWD(DP)                                                                     \
  case DP:                                                                                     \
    return keys == 32 ? launch_f32_narrow<DP, 32, VEC>(q, k, v, o, lse, bias, B, H, Nq, Nk,    \
                                                       dh, s, scale, st)                       \
                      : launch_f32_narrow<DP, 64, VEC>(q, k, v, o, lse, bias, B, H, Nq, Nk,    \
                                                       dh, s, scale, st);
  switch (dp) {
    LAM_NARROW_FWD(8)
    LAM_NARROW_FWD(16)
    LAM_NARROW_FWD(24)
    LAM_NARROW_FWD(32)
    LAM_NARROW_FWD(48)
    LAM_NARROW_FWD(64)
    default: return cudaErrorInvalidValue;
  }
#undef LAM_NARROW_FWD
}

// fp32 operands at 64 < dh <= 128: register-tiled FFMA. A block of
// WIDE_THREADS takes ROWS = 64 query rows of one (batch, head) sequence
// (SEG = 1), or the first 32 query rows of two sequences whose Nq and Nk are
// both at most 32 (SEG = 2: MD17's temporal axis, N = 30), and walks the
// keys in tiles of WIDE_KEYS (ROWS = 32, two rows a thread, is the second
// micro-tile size of tools/kernel_variants.py). dh is zero-padded to
// WIDE_DP in shared memory only.
// Q, K and V sit row-major in shared memory (Q and K rows padded to 132
// floats, so the 16 key rows a warp reads at once fall on distinct banks),
// copied by cp.async straight from the strided views: 16 bytes at a time
// where every base, stride and dh allow it (VEC), else 4.
// - S = Q K^T: thread (rg, kg), rg = 2 * warp + lane / 16, kg = lane % 16,
//   holds the scores of query rows rg * RM + i (i < RM = ROWS / 16) and
//   keys kg + 16 j (j < 4): per 4 columns of dh it reads RM float4 of Q
//   (broadcast: the warp reads two rows' worth) and 4 of K, 4 RM dot4 (one
//   FMA chain over dh a score), so a 16-byte shared load feeds 8 FFMAs at
//   RM = 4.
// - The softmax keeps a row in the 16 lanes of one half warp: the tile's
//   row max by four xor shuffles, one expf a score, each lane's partial
//   row sum rescaled by alpha (summed over the 16 lanes at the end). P goes
//   to shared memory key-major, over the K tile (read by then), alpha
//   beside it.
// - O = P V: thread (prg, cg), prg = 4 * (warp / 2) + lane / 8, cg =
//   8 * (warp % 2) + lane % 8, holds O's rows prg * RM + i and columns
//   4 cg .. + 4 and 64 + 4 cg .. + 4 (RM x 8 floats); per key it reads one
//   float4 (float2) of P and two of V for 8 RM FFMAs. O is rescaled by its
//   rows' alpha from shared memory, divided by max(l, 1e-30) at the end.
// A row's logit rounds as JAX's (the scaled dot product, then the bias);
// keys past Nk get -inf. Two blocks an SM (~99 KB of shared memory and at
// most 128 registers each), so there is no room for a second K/V stage (or
// for the next K tile in registers: that spills): the V tile's copy runs
// under the scores, the other block's products cover the rest. SEG = 2
// runs the segment's half of the scores and keys only (a warp's rows lie in
// one segment), so N = 30 does not run a 64-row block that is three
// quarters empty.
constexpr int WIDE_LDV = WIDE_DP;       // V row stride

template <int ROWS>
struct WideLayout {
  static constexpr int RM = ROWS / 16;  // rows of a thread's micro-tiles
  static constexpr int LDP = ROWS + 4;  // P^T: a key's row of ROWS probabilities
  static constexpr int k_off = ROWS * WIDE_LDQK;
  static constexpr int v_off = k_off + WIDE_KEYS * WIDE_LDQK;
  static constexpr int b_off = v_off + WIDE_KEYS * WIDE_LDV;  // bias slice [WIDE_KEYS]
  static constexpr int a_off = b_off + WIDE_KEYS;             // alpha [ROWS]
  static constexpr int l_off = a_off + ROWS;                  // l [ROWS]
  static constexpr size_t bytes = sizeof(float) * (l_off + ROWS);
  static_assert(WIDE_KEYS * LDP <= WIDE_KEYS * WIDE_LDQK, "P^T fits in the K tile");
};

template <int RM>
struct RowVec;
template <>
struct RowVec<4> {
  using T = float4;
  __device__ static float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static float4 make(const float* x) { return make_float4(x[0], x[1], x[2], x[3]); }
};
template <>
struct RowVec<2> {
  using T = float2;
  __device__ static float get(const float2& v, int i) { return i == 0 ? v.x : v.y; }
  __device__ static float2 make(const float* x) { return make_float2(x[0], x[1]); }
};



// Two blocks an SM cap a thread at 128 registers; the 4-byte copies and
// stores of the unaligned instance (VEC false, off the main paths) need a
// few more, so it runs one block an SM rather than spill.
template <int ROWS, int SEG, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS, VEC ? 2 : 1)
flash_fwd_f32_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, const float* __restrict__ bias, int BH,
                           int H, int Nq, int Nk, int dh,
                           long long q_sb, long long q_sh, long long q_sn,
                           long long k_sb, long long k_sh, long long k_sn,
                           long long v_sb, long long v_sh, long long v_sn,
                           long long o_sb, long long o_sh, long long o_sn, float scale) {
  using L = WideLayout<ROWS>;
  using RV = RowVec<L::RM>;
  constexpr int RM = L::RM, LDP = L::LDP, JN = 4 / SEG, QPER = ROWS / SEG;
  static_assert(SEG == 1 || ROWS == 64, "two sequences a block take 64 rows");
  extern __shared__ __align__(16) float wsm[];
  float* Qs = wsm;
  float* Ks = wsm + L::k_off;
  float* Ps = Ks;  // P^T over the K tile, once the scores are formed
  float* Vs = wsm + L::v_off;
  float* Bs = wsm + L::b_off;
  float* As = wsm + L::a_off;
  float* Ls = wsm + L::l_off;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the block's sequences: bh0 (and bh0 + 1 when SEG = 2), its first query row
  int bh0, q0;
  if constexpr (SEG == 1) {
    const TileIdx ti = tile_index(Nq, ROWS);
    bh0 = ti.bh;
    q0 = ti.tile * ROWS;
  } else {
    bh0 = SEG * blockIdx.x;
    q0 = 0;
  }
  const bool ok1 = SEG == 2 && bh0 + 1 < BH;
  const int b0 = bh0 / H, h0 = bh0 % H, b1 = (bh0 + 1) / H, h1 = (bh0 + 1) % H;
  const int seg = SEG == 1 ? 0 : warp / 4;  // a warp's rows (both layouts) lie in one segment

  wide_stage<SEG, VEC>(Qs, WIDE_LDQK, ROWS, q, b0 * q_sb + h0 * q_sh, b1 * q_sb + h1 * q_sh, ok1,
                       q_sn, q0, Nq, dh);

  const int rg = 2 * warp + lane / 16, kg = lane % 16;  // S and softmax
  const int prg = 4 * (warp / 2) + lane / 8, cg = 8 * (warp % 2) + lane % 8;  // O = P V
  float m[RM], lp[RM], acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    lp[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }
  const int n_tiles = SEG == 1 ? (Nk + WIDE_KEYS - 1) / WIDE_KEYS : 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * WIDE_KEYS;
    wide_stage<SEG, VEC>(Ks, WIDE_LDQK, WIDE_KEYS, k, b0 * k_sb + h0 * k_sh,
                         b1 * k_sb + h1 * k_sh, ok1, k_sn, k0, Nk, dh);
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // K (and Q, on the first tile)
    wide_stage<SEG, VEC>(Vs, WIDE_LDV, WIDE_KEYS, v, b0 * v_sb + h0 * v_sh,
                         b1 * v_sb + h1 * v_sh, ok1, v_sn, k0, Nk, dh);
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // V: lands while S is formed
    if (tid < WIDE_KEYS) {
      const int s = SEG == 1 ? 0 : tid / (WIDE_KEYS / SEG);
      const int key = k0 + (SEG == 1 ? tid : tid % (WIDE_KEYS / SEG));
      const bool ok = bias != nullptr && (s == 0 || ok1) && key < Nk;
      Bs[tid] = ok ? bias[static_cast<long long>(s ? b1 : b0) * Nk + key] : 0.0f;
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    // S: rows rg * RM + i, tile keys kg + 16 (seg * JN + j)
    float sc[RM][JN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) sc[i][j] = 0.0f;
    const float* krow = Ks + (kg + 16 * seg * JN) * WIDE_LDQK;
    const float* qrow = Qs + rg * RM * WIDE_LDQK;
#pragma unroll 4
    for (int d = 0; d < WIDE_DP; d += 4) {
      float4 qv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qrow + i * WIDE_LDQK + d);
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + 16 * j * WIDE_LDQK + d);
#pragma unroll
        for (int i = 0; i < RM; ++i) sc[i][j] = wide_dot4(qv[i], kv, sc[i][j]);
      }
    }
    // the scaled logit rounds before the bias add, as in JAX; keys past Nk: -inf
    float alpha[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int col = kg + 16 * (seg * JN + j);
        const int key = SEG == 1 ? k0 + col : kg + 16 * j;
        sc[i][j] = key < Nk ? __fadd_rn(__fmul_rn(sc[i][j], scale), Bs[col]) : -CUDART_INF_F;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      lp[i] = lp[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();  // every warp has read the K tile: P^T replaces it
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      float pj[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pj[i] = sc[i][j];
      *reinterpret_cast<typename RV::T*>(Ps + (kg + 16 * (seg * JN + j)) * LDP + rg * RM) =
          RV::make(pj);
    }
    if (kg == 0)
      *reinterpret_cast<typename RV::T*>(As + rg * RM) = RV::make(alpha);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // P^T, alpha and the V tile in place

    // O = O * alpha + P V over the segment's keys
    const typename RV::T al = *reinterpret_cast<const typename RV::T*>(As + prg * RM);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= RV::get(al, i);
    const int kb = seg * (WIDE_KEYS / SEG);
    const int ke = SEG == 1 ? min(WIDE_KEYS, (Nk - k0 + 3) & ~3) : kb + WIDE_KEYS / SEG;
    const float* prow = Ps + prg * RM;
    const float* vrow = Vs + 4 * cg;
#pragma unroll 4
    for (int key = kb; key < ke; ++key) {
      const typename RV::T pv = *reinterpret_cast<const typename RV::T*>(prow + key * LDP);
      const float4 v0 = *reinterpret_cast<const float4*>(vrow + key * WIDE_LDV);
      const float4 v1 = *reinterpret_cast<const float4*>(vrow + key * WIDE_LDV + 64);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = RV::get(pv, i);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[i][c] = fmaf(p, f4(v0, c), acc[i][c]);
          acc[i][4 + c] = fmaf(p, f4(v1, c), acc[i][4 + c]);
        }
      }
    }
    __syncthreads();  // P (the K tile) and V consumed before the next copies
  }

  // l over the row's 16 lanes; the lse; then O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float l = lp[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int r = rg * RM + i;
    if (kg == 0) {
      Ls[r] = l;
      const int s = SEG == 1 ? 0 : r / QPER, pos = q0 + (SEG == 1 ? r : r % QPER);
      if (lse != nullptr && (s == 0 || ok1) && pos < Nq)
        lse[static_cast<long long>(bh0 + s) * Nq + pos] = m[i] + logf(fmaxf(l, 1e-30f));
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = prg * RM + i;
    const int s = SEG == 1 ? 0 : r / QPER, pos = q0 + (SEG == 1 ? r : r % QPER);
    if ((s != 0 && !ok1) || pos >= Nq) continue;
    const float denom = fmaxf(Ls[r], 1e-30f);
    float* op = o + (s ? b1 * o_sb + h1 * o_sh : b0 * o_sb + h0 * o_sh) +
                static_cast<long long>(pos) * o_sn;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 64 * half + 4 * cg;
      const float y[4] = {acc[i][4 * half] / denom, acc[i][4 * half + 1] / denom,
                          acc[i][4 * half + 2] / denom, acc[i][4 * half + 3] / denom};
      if constexpr (VEC) {
        if (c0 < dh) *reinterpret_cast<float4*>(op + c0) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < dh) op[c0 + c] = y[c];
      }
    }
  }
}

template <int ROWS, int SEG, bool VEC>
cudaError_t launch_f32_tiled(const float* q, const float* k, const float* v, float* o,
                             float* lse, const float* bias, int B, int H, int Nq, int Nk, int dh,
                             const long long* s, float scale, cudaStream_t stream) {
  constexpr size_t smem = WideLayout<ROWS>::bytes;
  static cudaError_t attr = lam_set_smem(flash_fwd_f32_tiled_kernel<ROWS, SEG, VEC>, smem);
  if (attr != cudaSuccess) return attr;
  const int bh = B * H;
  const unsigned grid = SEG == 1 ? grid_blocks(bh, Nq, ROWS) : static_cast<unsigned>((bh + 1) / 2);
  flash_fwd_f32_tiled_kernel<ROWS, SEG, VEC><<<grid, WIDE_THREADS, smem, stream>>>(
      q, k, v, o, lse, bias, bh, H, Nq, Nk, dh, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
      s[8], s[9], s[10], s[11], scale);
  return cudaGetLastError();
}

// The plan's instance: seg sequences a 64-row block (1, or 2 where Nq and Nk
// are at most 32), 16-byte copies where q/k/v/o's bases and strides and dh
// are multiples of 4 floats.
template <bool VEC>
cudaError_t launch_f32_wide(const float* q, const float* k, const float* v, float* o, float* lse,
                            const float* bias, int B, int H, int Nq, int Nk, int dh,
                            const long long* s, float scale, int seg, cudaStream_t st) {
  if (seg == 2)
    return launch_f32_tiled<64, 2, VEC>(q, k, v, o, lse, bias, B, H, Nq, Nk, dh, s, scale, st);
  return launch_f32_tiled<64, 1, VEC>(q, k, v, o, lse, bias, B, H, Nq, Nk, dh, s, scale, st);
}

}  // namespace

// q/k/v/o: bf16 [B, H, N, dh] addressed through element strides
// (batch, head, seq); dh has unit stride. lse: null, or fp32 [B, H, Nq]
// contiguous. bias: the fp32 key-padding bias [B, Nk] contiguous; a null
// bias is refused (cudaErrorInvalidValue): the unmasked bf16 forward is
// lam_flash_attention_fwd_sm90 (flash_fwd_sm90.cu). Returns
// cudaGetLastError().
extern "C" int lam_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* bias, int B,
    int H, int Nq, int Nk, int dh, long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn, float scale,
    void* stream) {
  const long long s[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                           v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  return launch_dh<XF_NONE>(q, k, v, o, lse, bias, NormRope{}, B, H, Nq, Nk, dh, s, scale,
                            stream);
}

// As lam_flash_attention_fwd on fp32 q/k/v/o, with or without a bias; dh <= 128.
// plan: at dh <= 64 the narrow kernel's padded width and keys its key
// tile (the wrapper's f32_narrow_fwd_plan: 8, 16, 24, 32, 48 or 64, at
// least dh; 32 or 64); at 64 < dh <= 128 the register-tiled kernel's
// sequences a block (f32_wide_plan: 1, or 2 where Nq and Nk are at most
// 32), keys unused.
extern "C" int lam_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* bias, int B,
    int H, int Nq, int Nk, int dh, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn, float scale, int plan, int keys,
    void* stream) {
  const long long s[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                           v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(o);
  auto lf = static_cast<float*>(lse);
  auto bf = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  const bool wide = dh > 64;
  if (dh <= 0 || dh > WIDE_DP || Nq <= 0 || Nk <= 0 ||
      (wide ? (plan != 1 && plan != 2) || (plan == 2 && (Nq > 32 || Nk > 32))
            : plan < dh || plan > 64 || plan % 8 != 0 || (keys != 32 && keys != 64)))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies where every base and stride allows them and dh % 4 == 0
  unsigned long long bits = reinterpret_cast<unsigned long long>(q) |
                            reinterpret_cast<unsigned long long>(k) |
                            reinterpret_cast<unsigned long long>(v) |
                            reinterpret_cast<unsigned long long>(o);
  for (long long x : s) bits |= 4ull * static_cast<unsigned long long>(x);
  const bool vec = (bits & 15) == 0 && dh % 4 == 0;
  cudaError_t err;
  if (wide)
    err = vec ? launch_f32_wide<true>(qf, kf, vf, of, lf, bf, B, H, Nq, Nk, dh, s, scale, plan, st)
              : launch_f32_wide<false>(qf, kf, vf, of, lf, bf, B, H, Nq, Nk, dh, s, scale, plan,
                                       st);
  else
    err = vec ? launch_f32_narrow_dp<true>(qf, kf, vf, of, lf, bf, B, H, Nq, Nk, dh, s, scale,
                                           plan, keys, st)
              : launch_f32_narrow_dp<false>(qf, kf, vf, of, lf, bf, B, H, Nq, Nk, dh, s, scale,
                                            plan, keys, st);
  return static_cast<int>(err);
}

// K10: packed q/k/v [N, T, H*dh] as head-major bf16 [N, H, T, dh] strided
// views (heads are contiguous dh lane segments, unit stride on dh) and o
// the same, plus fp32 qs/ks [H*dh] lane scales and fp32 cos/sin
// [>= T, H*dh] row-major lane tables; dh even. QK RMS-norm (eps) and RoPE
// in the lane form with one rounding, then K1's recurrence. No bias, no lse.
extern "C" int lam_fused_temporal_fwd(
    const void* q, const void* k, const void* v, void* o, const void* qs, const void* ks,
    const void* cos, const void* sin, int N, int H, int T, int dh, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long o_sb, long long o_sh,
    long long o_sn, float scale, float eps, void* stream) {
  const long long s[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                           v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  const NormRope nr{static_cast<const float*>(qs), static_cast<const float*>(ks),
                    static_cast<const float*>(cos), static_cast<const float*>(sin), eps};
  return launch_dh<XF_LANE>(q, k, v, o, nullptr, nullptr, nr, N, H, T, T, dh, s, scale, stream);
}
