// Attention over short unmasked self-attention axes (8 < n < 128), forward
// and backward, bf16 in / bf16 out, for Hopper (sm_90a).
//
// Replaces K9, lam_slide_tpu/ops/short_attention.py `_short_fwd_kernel` and
// `_short_bwd_kernel` (pallas_calls in `_short_fwd` / `_short_bwd`). The
// TPU design groups G (batch, head) pairs into one [G*n, G*n] matmul with
// block-diagonal masking to fill 128x128 MXU tiles; nothing on the card
// needs that, so it is not carried over.
//
// Forward, on the tensor cores, on the blocks of the backward below: a
// persistent block owns a group of hb <= 8 heads (a warp each,
// fwd_heads_per_block) and walks over batch rows. Whole rows of the group's
// q, k and v columns (256 contiguous bytes a row at MD17) come in by
// cp.async, 16 bytes a thread, into bf16 tiles double-buffered over batch
// rows; q/k/v are read through packed [B, n, H*dh] strides (batch, seq;
// unit stride on dh), so the DiT's q/k and its v view of linear1's output
// go in without a relayout copy. A warp runs its head in 16-query blocks:
// S = Q K^T on mma.sync.m16n8k16 over 32-key blocks, the fp32 row max and
// sum of the exponentials online over the key blocks, then the weights
// p / sum in fp32 rounded to bf16 as A fragments and O = bf16(P) V on
// mma.sync, rounded once into a bf16 output tile that leaves as whole rows
// of 16-byte stores. For n <= 32 (one key block) the scores stay in
// registers between the statistics and P V; longer rows compute them twice,
// so the weights round where the plain version rounds them (after the
// normalisation), not where an online rescale would.
//
// Backward, on the tensor cores: a persistent block owns a group of hb <= 8
// heads (a warp each) and walks over batch rows. Whole rows of the group's
// q, k, v and dO columns (hb*dh*2 contiguous bytes a row; 256 at MD17) come
// in by cp.async, 16 bytes a thread, neighbouring threads on neighbouring
// addresses, into bf16 tiles double-buffered over batch rows (cp.async
// groups), so the next row's loads overlap this row's math. A warp runs
// its head's five products with mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). wgmma is not used: its 64-row minimum would waste more than
// half its rows on a 30-row item, or would need the TPU's block-diagonal
// masking over grouped items. For n <= 32 the warp holds S and dP of the
// whole item in registers (32 floats a lane each), forms P, delta and dS
// there, and turns them into A fragments: dS as it stands for dQ = dS K,
// and P^T and dS^T (movmatrix transposes of the 8x8 blocks) for dV =
// bf16(P)^T dO and dK = dS^T Q. One pass, nothing recomputed. Longer n
// (33..127) runs in three passes over 16-query by 32-key blocks: the row
// statistics (online max, sum and delta), then dQ, then dK and dV, each
// recomputing S and dP of its blocks. The grads go to a bf16 output tile
// and leave as whole rows, 16 bytes a thread. No atomics: every grad
// element is summed by one warp in a fixed order, so a result repeats bit
// for bit.
//
// Numerics of `_scores` (short_attention.py:73-80): fp32 logits (bf16
// products are exact in fp32) times the scale, fp32 max / exp / sum, the
// weights p / sum rounded to bf16 for the AV product, fp32 accumulation,
// one rounding of the output. Backward (`_short_bwd_kernel`): dV = bf16(P)^T
// dO, dP = dO V^T, delta = rowsum(P * dP) with P in fp32, dS = P * (dP -
// delta) * scale rounded to bf16, dQ = dS K, dK = dS^T Q, fp32 accumulation.
// Both take the exponential as ex2 of the logits times scale*log2(e); the
// _rn intrinsics keep products from contracting into FMAs where the JAX math
// rounds them. Neither uses atomics, so a result repeats bit for bit.
//
// What bounds it on the H100: at the MD17 temporal shape ([61440, 30, 256],
// 16 heads x dh 16) the forward moves ~3.8 GB of q/k/v/o (~1.1 ms at
// 3.35 TB/s) for ~57 GFLOP, a fraction of that on the tensor cores: bytes.
// The backward moves ~6.6 GB of q/k/v/dO/dq/dk/dv (~2.0 ms) for 2.5x the
// forward's FLOPs: bytes too.

#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

bool bad_shape(int B, int H, int n, int dh) {
  return B <= 0 || H <= 0 || n <= 8 || n >= 128 || dh <= 0 || dh > 64;
}

// ---- backward ------------------------------------------------------------

namespace bwd {

using lam_sm90::ex2;
using lam_sm90::pack_bf16;
using lam_sm90::smem_u32;

constexpr int MAX_HEADS = 8;  // warps (heads) a block
constexpr int THREADS = 32 * MAX_HEADS;
constexpr size_t SMEM_MAX = 232448;  // the most dynamic shared memory a block takes

struct Args {
  const bf16* in[4];        // q, k, v, dO
  bf16* out[3];             // dq, dk, dv
  long long sb[4], sn[4];   // batch and sequence strides of the inputs
  long long o_sb, o_sn;     // of the outputs
  int B, H, n, dh, hb, groups, np, rs, piece, out_piece;
  float scale, c;           // c = scale * log2(e)
};

// Shared memory of a block, in tiles of np rows (n rounded up to 32) by rs
// = hb*DP + 8 bf16 (head hh in columns [hh*DP, hh*DP + dh); the 8-element
// pad puts the eight rows an ldmatrix reads in eight bank groups): two
// stages of the q, k, v, dO tiles, the dq, dk, dv tiles, and past 32 rows
// each warp's row statistics (3 * np floats). ops/short_attention.py's
// bwd_smem_bytes mirrors this to choose hb.
inline size_t smem_bytes(int np, int rs, int hb) {
  return 11 * static_cast<size_t>(np) * rs * sizeof(bf16) +
         (np > 32 ? static_cast<size_t>(hb) * 3 * np * sizeof(float) : 0);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of an 8x8 bf16 block held one row pair a lane.
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragments (lane = 4g + c): a 16 x 32 block x[j][e] of C fragments holds
// row g + 8(e/2), column 8j + 2c + e%2. Its m16k16 A fragment for columns
// [16ks, 16ks + 16), rounded to bf16:
__device__ __forceinline__ void a_frag(const float (&x)[4][4], int ks, uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
  a[1] = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
  a[2] = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
  a[3] = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
}

// The A fragment of X^T from that of X (its four 8x8 blocks transposed and
// the off-diagonal pair swapped).
__device__ __forceinline__ void a_frag_t(const uint32_t (&x)[4], uint32_t (&y)[4]) {
  y[0] = movt(x[0]);
  y[1] = movt(x[2]);
  y[2] = movt(x[1]);
  y[3] = movt(x[3]);
}

// s = A B^T over DP columns for 16 rows of tile a and 32 rows of tile b
// (row stride rs), a 16 x 32 block of C fragments.
template <int DP>
__device__ __forceinline__ void score_tile(float (&s)[4][4], const bf16* a, const bf16* b,
                                           int rs) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    uint32_t af[4];
    ldsm4(af, a + (lane % 16) * rs + kd * 16 + (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t bf[4];
      ldsm4(bf, b + (16 * jp + (lane / 16) * 8 + lane % 8) * rs + kd * 16 + ((lane / 8) % 2) * 8);
      mma(s[2 * jp], af, bf[0], bf[1]);
      mma(s[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[m][j] += a[m] times rows [k0, k0 + 16) of tile t (row stride rs),
// columns [col0 + 8j, col0 + 8j + 8): MT row blocks sharing the B fragments.
template <int MT, int NJ>
__device__ __forceinline__ void mma_rows(float (&acc)[MT][NJ][4], const uint32_t (&a)[MT][4],
                                         const bf16* t, int rs, int k0, int col0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int jp = 0; jp < NJ / 2; ++jp) {
    uint32_t bf[4];
    ldsm4_t(bf, t + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * rs + col0 + 16 * jp + (lane / 16) * 8);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma(acc[m][2 * jp], a[m], bf[0], bf[1]);
      mma(acc[m][2 * jp + 1], a[m], bf[2], bf[3]);
    }
  }
}

template <int MT, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MT][NJ][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
}

// Rows [row0, row0 + 16) x columns [col0, col0 + 8NJ) of a bf16 tile from
// C fragments (rows past n and columns past dh land in the tile's padding,
// which is never stored).
template <int NJ>
__device__ __forceinline__ void store_frag(bf16* t, int rs, int row0, int col0,
                                           const float (&acc)[NJ][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(t + (row0 + g + 8 * r) * rs + col0 + 8 * j + 2 * c) =
          pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
}

// The whole-row softmax of row half r (row g + 8r) of a 16 x 32 block of
// raw scores s over keys < n, then delta and dS: s becomes P (fp32), dp
// becomes dS = P (dP - delta) scale (fp32, rounded when packed).
__device__ __forceinline__ void probs_rows(float (&s)[4][4], float (&dp)[4][4], int r, int n,
                                           float c, float scale) {
  const int cq = threadIdx.x % 4;
  float m = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float t = 8 * j + 2 * cq + e < n ? s[j][2 * r + e] * c : -CUDART_INF_F;
      s[j][2 * r + e] = t;
      m = fmaxf(m, t);
    }
  m = quad_max(m);
  float l = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = ex2(s[j][2 * r + e] - m);
      s[j][2 * r + e] = p;
      l += p;
    }
  const float inv = __frcp_rn(quad_sum(l));
  float delta = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = __fmul_rn(s[j][2 * r + e], inv);
      s[j][2 * r + e] = p;
      delta = fmaf(p, dp[j][2 * r + e], delta);
    }
  delta = quad_sum(delta);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      dp[j][2 * r + e] =
          __fmul_rn(__fmul_rn(s[j][2 * r + e], __fsub_rn(dp[j][2 * r + e], delta)), scale);
}

// n <= 32: one pass. Q, K, V, G (dO) and the outputs point at the warp's
// head in their tiles (row stride rs). Padding rows of Q and dO are zero,
// so their P meets zero dO rows and their dS is zero.
template <int DP>
__device__ __forceinline__ void head_single(const bf16* Q, const bf16* K, const bf16* V,
                                            const bf16* G, bf16* dQ, bf16* dK, bf16* dV, int rs,
                                            int n, float c, float scale) {
  float s[2][4][4], dp[2][4][4];
#pragma unroll
  for (int qt = 0; qt < 2; ++qt) {
    score_tile<DP>(s[qt], Q + 16 * qt * rs, K, rs);
    score_tile<DP>(dp[qt], G + 16 * qt * rs, V, rs);
#pragma unroll
    for (int r = 0; r < 2; ++r) probs_rows(s[qt], dp[qt], r, n, c, scale);
  }
  // dS (queries x keys) for dQ, by key step; P^T and dS^T (keys x
  // queries) for dV and dK, by query step
  uint32_t ds_a[2][2][4], pt_a[2][2][4], dst_a[2][2][4];
#pragma unroll
  for (int qt = 0; qt < 2; ++qt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t p_a[4];
      a_frag(s[qt], ks, p_a);
      a_frag(dp[qt], ks, ds_a[ks][qt]);
      a_frag_t(p_a, pt_a[qt][ks]);
      a_frag_t(ds_a[ks][qt], dst_a[qt][ks]);
    }
  constexpr int CW = DP < 32 ? DP : 32;  // output columns at a time
#pragma unroll
  for (int cc = 0; cc < DP; cc += CW) {
    float acc[2][CW / 8][4];
    zero(acc);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) mma_rows<2, CW / 8>(acc, ds_a[ks], K, rs, 16 * ks, cc);
#pragma unroll
    for (int m = 0; m < 2; ++m) store_frag<CW / 8>(dQ, rs, 16 * m, cc, acc[m]);
    zero(acc);
#pragma unroll
    for (int qs = 0; qs < 2; ++qs) mma_rows<2, CW / 8>(acc, pt_a[qs], G, rs, 16 * qs, cc);
#pragma unroll
    for (int m = 0; m < 2; ++m) store_frag<CW / 8>(dV, rs, 16 * m, cc, acc[m]);
    zero(acc);
#pragma unroll
    for (int qs = 0; qs < 2; ++qs) mma_rows<2, CW / 8>(acc, dst_a[qs], Q, rs, 16 * qs, cc);
#pragma unroll
    for (int m = 0; m < 2; ++m) store_frag<CW / 8>(dK, rs, 16 * m, cc, acc[m]);
  }
}

// P and dS of the 16 x 32 block at (row0, key0) from the saved row
// statistics st (max of the log2-scaled logits, 1/sum, delta; np apart).
__device__ __forceinline__ void probs_saved(float (&s)[4][4], float (&dp)[4][4], const float* st,
                                            int np, int row0, int key0, int n, float c,
                                            float scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, cq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const float m = st[row], inv = st[np + row], delta = st[2 * np + row];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[j][2 * r + e];
        const float p = key0 + 8 * j + 2 * cq + e < n ? __fmul_rn(ex2(x * c - m), inv) : 0.0f;
        x = p;
        float& d = dp[j][2 * r + e];
        d = __fmul_rn(__fmul_rn(p, __fsub_rn(d, delta)), scale);
      }
  }
}

// 32 < n < 128: the row statistics (online over key blocks), then dQ by
// query blocks, then dK and dV by key blocks, 16 columns at a time. st is
// the warp's 3 * np floats of statistics.
template <int DP>
__device__ __forceinline__ void head_multi(const bf16* Q, const bf16* K, const bf16* V,
                                           const bf16* G, bf16* dQ, bf16* dK, bf16* dV,
                                           float* st, int rs, int np, int n, float c,
                                           float scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, cq = lane % 4;
  const int nqb = (n + 15) / 16, nkb = (n + 31) / 32;
  for (int qb = 0; qb < nqb; ++qb) {
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f}, d[2] = {0.0f, 0.0f};
    for (int kb = 0; kb < nkb; ++kb) {
      float s[4][4], dp[4][4];
      score_tile<DP>(s, Q + 16 * qb * rs, K + 32 * kb * rs, rs);
      score_tile<DP>(dp, G + 16 * qb * rs, V + 32 * kb * rs, rs);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float t =
                32 * kb + 8 * j + 2 * cq + e < n ? s[j][2 * r + e] * c : -CUDART_INF_F;
            s[j][2 * r + e] = t;
            mt = fmaxf(mt, t);
          }
        const float mn = fmaxf(m[r], quad_max(mt));
        const float alpha = ex2(m[r] - mn);
        l[r] *= alpha;
        d[r] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(s[j][2 * r + e] - mn);
            l[r] += p;
            d[r] = fmaf(p, dp[j][2 * r + e], d[r]);
          }
        m[r] = mn;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]), dr = quad_sum(d[r]);
      if (cq == 0) {
        const int row = 16 * qb + g + 8 * r;
        st[row] = m[r];
        st[np + row] = __frcp_rn(lr);
        st[2 * np + row] = __fdiv_rn(dr, lr);
      }
    }
  }
  __syncwarp();
  for (int qb = 0; qb < nqb; ++qb) {
    float acc[1][DP / 8][4];
    zero(acc);
    for (int kb = 0; kb < nkb; ++kb) {
      float s[4][4], dp[4][4];
      score_tile<DP>(s, Q + 16 * qb * rs, K + 32 * kb * rs, rs);
      score_tile<DP>(dp, G + 16 * qb * rs, V + 32 * kb * rs, rs);
      probs_saved(s, dp, st, np, 16 * qb, 32 * kb, n, c, scale);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[1][4];
        a_frag(dp, ks, a[0]);
        mma_rows<1, DP / 8>(acc, a, K, rs, 32 * kb + 16 * ks, 0);
      }
    }
    store_frag<DP / 8>(dQ, rs, 16 * qb, 0, acc[0]);
  }
  for (int kb = 0; kb < nkb; ++kb)
    for (int cc = 0; cc < DP; cc += 16) {
      float av[2][2][4], ak[2][2][4];
      zero(av);
      zero(ak);
      for (int qb = 0; qb < nqb; ++qb) {
        float s[4][4], dp[4][4];
        score_tile<DP>(s, Q + 16 * qb * rs, K + 32 * kb * rs, rs);
        score_tile<DP>(dp, G + 16 * qb * rs, V + 32 * kb * rs, rs);
        probs_saved(s, dp, st, np, 16 * qb, 32 * kb, n, c, scale);
        uint32_t pt[2][4], dt[2][4];
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          uint32_t x[4];
          a_frag(s, kt, x);
          a_frag_t(x, pt[kt]);
          a_frag(dp, kt, x);
          a_frag_t(x, dt[kt]);
        }
        mma_rows<2, 2>(av, pt, G, rs, 16 * qb, cc);
        mma_rows<2, 2>(ak, dt, Q, rs, 16 * qb, cc);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        store_frag<2>(dV, rs, 32 * kb + 16 * m, cc, av[m]);
        store_frag<2>(dK, rs, 32 * kb + 16 * m, cc, ak[m]);
      }
    }
}

// Rows [0, n) of heads [0, nh) of the block's group between device memory
// (row r of head hh at g + r*sn + hh*dh, unit stride) and a tile (row
// stride rs, head hh at column hh*DP), `piece` bytes at a time (16, 8, 4
// or 2, dividing 2*dh and every address): neighbouring threads take
// neighbouring pieces of a row. LOAD: cp.async into the tile (2-byte
// pieces through registers); else plain stores to device memory.
template <int DP, bool LOAD>
__device__ __forceinline__ void move_rows(bf16* tile, bf16* gm, long long sn, int n, int hb,
                                          int nh, int dh, int rs, int piece) {
  const int ph = 2 * dh / piece, per_row = hb * ph;
  auto move = [&](int r, int p) {
    const int hh = p / ph, byte = (p - hh * ph) * piece;
    if (hh >= nh) return;
    unsigned char* t = reinterpret_cast<unsigned char*>(tile + r * rs + hh * DP) + byte;
    unsigned char* m = reinterpret_cast<unsigned char*>(gm + r * sn + hh * dh) + byte;
    if constexpr (LOAD) {
      if (piece == 2)
        *reinterpret_cast<bf16*>(t) = *reinterpret_cast<const bf16*>(m);
      else
        lam_sm90::cp_async(t, m, piece);
    } else if (piece == 16) {
      *reinterpret_cast<uint4*>(m) = *reinterpret_cast<const uint4*>(t);
    } else if (piece == 8) {
      *reinterpret_cast<uint2*>(m) = *reinterpret_cast<const uint2*>(t);
    } else if (piece == 4) {
      *reinterpret_cast<uint32_t*>(m) = *reinterpret_cast<const uint32_t*>(t);
    } else {
      *reinterpret_cast<bf16*>(m) = *reinterpret_cast<const bf16*>(t);
    }
  };
  if (blockDim.x % per_row == 0) {  // each thread keeps one piece of a row
    const int p = threadIdx.x % per_row, step = blockDim.x / per_row;
    for (int r = threadIdx.x / per_row; r < n; r += step) move(r, p);
  } else {
    for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) move(i / per_row, i % per_row);
  }
}

template <int DP>
__device__ __forceinline__ void load_item(const Args& a, bf16* stage, long long t) {
  const int b = static_cast<int>(t / a.groups), h0 = static_cast<int>(t % a.groups) * a.hb;
  const int nh = min(a.hb, a.H - h0);
  const size_t te = static_cast<size_t>(a.np) * a.rs;
#pragma unroll
  for (int o = 0; o < 4; ++o)
    move_rows<DP, true>(stage + o * te,
                       const_cast<bf16*>(a.in[o]) + b * a.sb[o] + static_cast<long long>(h0) * a.dh,
                       a.sn[o], a.n, a.hb, nh, a.dh, a.rs, a.piece);
}

template <int DP, bool SINGLE>
__global__ void __launch_bounds__(THREADS, 2) short_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const size_t te = static_cast<size_t>(a.np) * a.rs;
  bf16* outs = smem + 8 * te;
  float* stats = reinterpret_cast<float*>(smem + 11 * te);
  // zero the stages once: rows past n and columns past dh stay zero, so the
  // products over them add nothing
  for (size_t i = threadIdx.x; i < te; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const long long items = static_cast<long long>(a.B) * a.groups;
  long long t = blockIdx.x;
  if (t < items) load_item<DP>(a, smem, t);
  cp_commit();
  for (int j = 0; t < items; ++j, t += gridDim.x) {
    bf16* cur = smem + (j & 1) * 4 * te;
    if (t + gridDim.x < items) load_item<DP>(a, smem + ((j & 1) ^ 1) * 4 * te, t + gridDim.x);
    cp_commit();
    cp_wait1();  // this item's copies (the thread's own) have landed
    __syncthreads();  // everyone's have; the outputs of the last item are stored
    const int b = static_cast<int>(t / a.groups), h0 = static_cast<int>(t % a.groups) * a.hb;
    if (h0 + warp < a.H) {
      const int col = warp * DP;
      if constexpr (SINGLE)
        head_single<DP>(cur + col, cur + te + col, cur + 2 * te + col, cur + 3 * te + col,
                        outs + col, outs + te + col, outs + 2 * te + col, a.rs, a.n, a.c,
                        a.scale);
      else
        head_multi<DP>(cur + col, cur + te + col, cur + 2 * te + col, cur + 3 * te + col,
                       outs + col, outs + te + col, outs + 2 * te + col,
                       stats + warp * 3 * a.np, a.rs, a.np, a.n, a.c, a.scale);
    }
    __syncthreads();  // the output tiles are complete and this stage is read
    const int nh = min(a.hb, a.H - h0);
#pragma unroll
    for (int o = 0; o < 3; ++o)
      move_rows<DP, false>(outs + o * te,
                           a.out[o] + b * a.o_sb + static_cast<long long>(h0) * a.dh, a.o_sn,
                           a.n, a.hb, nh, a.dh, a.rs, a.out_piece);
  }
}

template <int DP, bool SINGLE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static cudaError_t attr = lam_set_smem(short_bwd_kernel<DP, SINGLE>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_bytes(a.np, a.rs, a.hb);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const int threads = 32 * a.hb;
  const int grid = lam_persistent_grid(short_bwd_kernel<DP, SINGLE>, threads, smem,
                                       static_cast<long long>(a.B) * a.groups);
  short_bwd_kernel<DP, SINGLE><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dp(Args& a, cudaStream_t stream) {
  a.rs = a.hb * DP + 8;
  return a.n <= 32 ? launch<DP, true>(a, stream) : launch<DP, false>(a, stream);
}

}  // namespace bwd

// ---- forward -------------------------------------------------------------

namespace fwd {

using bwd::a_frag;
using bwd::cp_commit;
using bwd::cp_wait1;
using bwd::mma_rows;
using bwd::move_rows;
using bwd::quad_max;
using bwd::quad_sum;
using bwd::score_tile;
using bwd::store_frag;
using bwd::zero;
using lam_sm90::ex2;

constexpr int MAX_HEADS = 8;  // warps (heads) a block
constexpr int THREADS = 32 * MAX_HEADS;
constexpr size_t SMEM_MAX = 232448;  // the most dynamic shared memory a block takes

struct Args {
  const bf16* in[3];        // q, k, v
  bf16* out;                // o
  long long sb[3], sn[3];   // batch and sequence strides of the inputs
  long long o_sb, o_sn;     // of the output
  int B, H, n, dh, hb, groups, np, rs, piece, out_piece;
  float c;                  // scale * log2(e)
};

// Shared memory of a block, in tiles of np rows (n rounded up to 32) by rs
// = hb*DP + 8 bf16, laid out as the backward's: two stages of the q, k, v
// tiles and the output tile. ops/short_attention.py's fwd_smem_bytes
// mirrors this to choose hb.
inline size_t smem_bytes(int np, int rs) {
  return 7 * static_cast<size_t>(np) * rs * sizeof(bf16);
}

// The scaled logits t = s * c of row half r of a 16 x 32 block of raw
// scores at key0, -inf past n; returns their largest over the row (quad).
__device__ __forceinline__ float logits_rows(float (&s)[4][4], int r, int key0, int n, float c) {
  const int cq = threadIdx.x % 4;
  float mt = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float t = key0 + 8 * j + 2 * cq + e < n ? s[j][2 * r + e] * c : -CUDART_INF_F;
      s[j][2 * r + e] = t;
      mt = fmaxf(mt, t);
    }
  return quad_max(mt);
}

// One head of one batch row: Q, K, V and the output O point at the warp's
// head in their tiles (row stride rs). Per 16-query block: the row
// statistics (max and sum of 2^(t - max)) online over 32-key blocks, then
// the weights p = 2^(t - max) / sum in fp32, rounded to bf16 as A fragments,
// and O = bf16(P) V on mma.sync, rounded once into the output tile. For
// n <= 32 the scores of the one key block stay in registers between the two
// steps; longer rows compute them again. Padding rows of Q are zero and
// their outputs are never stored; keys past n get p = 0.
template <int DP>
__device__ __forceinline__ void head_fwd(const bf16* Q, const bf16* K, const bf16* V, bf16* O,
                                         int rs, int n, float c) {
  const int nqb = (n + 15) / 16, nkb = (n + 31) / 32;
  for (int qb = 0; qb < nqb; ++qb) {
    float s[4][4];
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
    for (int kb = 0; kb < nkb; ++kb) {
      score_tile<DP>(s, Q + 16 * qb * rs, K + 32 * kb * rs, rs);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], logits_rows(s, r, 32 * kb, n, c));
        l[r] *= ex2(m[r] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) l[r] += ex2(s[j][2 * r + e] - mn);
        m[r] = mn;
      }
    }
    const float inv[2] = {__frcp_rn(quad_sum(l[0])), __frcp_rn(quad_sum(l[1]))};
    float acc[1][DP / 8][4];
    zero(acc);
    for (int kb = 0; kb < nkb; ++kb) {
      if (nkb > 1) {
        score_tile<DP>(s, Q + 16 * qb * rs, K + 32 * kb * rs, rs);
#pragma unroll
        for (int r = 0; r < 2; ++r) logits_rows(s, r, 32 * kb, n, c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(ex2(s[j][e] - m[e / 2]), inv[e / 2]);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[1][4];
        a_frag(s, ks, a[0]);
        mma_rows<1, DP / 8>(acc, a, V, rs, 32 * kb + 16 * ks, 0);
      }
    }
    store_frag<DP / 8>(O, rs, 16 * qb, 0, acc[0]);
  }
}

template <int DP>
__device__ __forceinline__ void load_rows(const Args& a, bf16* stage, long long t) {
  const int b = static_cast<int>(t / a.groups), h0 = static_cast<int>(t % a.groups) * a.hb;
  const int nh = min(a.hb, a.H - h0);
  const size_t te = static_cast<size_t>(a.np) * a.rs;
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    bf16* src = const_cast<bf16*>(a.in[o]) + b * a.sb[o] + static_cast<long long>(h0) * a.dh;
    move_rows<DP, true>(stage + o * te, src, a.sn[o], a.n, a.hb, nh, a.dh, a.rs, a.piece);
  }
}

// A persistent block walks over (batch row, head group) items: whole rows
// of the group's q, k, v columns by cp.async into tiles double-buffered
// over items, a warp a head, the output tile stored as whole rows.
template <int DP>
__global__ void __launch_bounds__(THREADS) short_fwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const size_t te = static_cast<size_t>(a.np) * a.rs;
  bf16* out_tile = smem + 6 * te;
  // zero both stages once (6 tiles, 3 * te / 4 pieces of 16 bytes): rows
  // past n and columns past dh stay zero, so the products over them add
  // nothing
  for (size_t i = threadIdx.x; i < 3 * te / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const long long items = static_cast<long long>(a.B) * a.groups;
  long long t = blockIdx.x;
  if (t < items) load_rows<DP>(a, smem, t);
  cp_commit();
  for (int j = 0; t < items; ++j, t += gridDim.x) {
    bf16* cur = smem + (j & 1) * 3 * te;
    if (t + gridDim.x < items) load_rows<DP>(a, smem + ((j & 1) ^ 1) * 3 * te, t + gridDim.x);
    cp_commit();
    cp_wait1();  // this item's copies (the thread's own) have landed
    __syncthreads();  // everyone's have; the output of the last item is stored
    const int b = static_cast<int>(t / a.groups), h0 = static_cast<int>(t % a.groups) * a.hb;
    const int nh = min(a.hb, a.H - h0);
    if (warp < nh)
      head_fwd<DP>(cur + warp * DP, cur + te + warp * DP, cur + 2 * te + warp * DP,
                   out_tile + warp * DP, a.rs, a.n, a.c);
    __syncthreads();  // the output tile is complete and this stage is read
    move_rows<DP, false>(out_tile, a.out + b * a.o_sb + static_cast<long long>(h0) * a.dh, a.o_sn,
                         a.n, a.hb, nh, a.dh, a.rs, a.out_piece);
  }
}

template <int DP>
cudaError_t launch(Args& a, cudaStream_t stream) {
  a.rs = a.hb * DP + 8;
  static cudaError_t attr = lam_set_smem(short_fwd_kernel<DP>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_bytes(a.np, a.rs);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const int threads = 32 * a.hb;
  const int grid = lam_persistent_grid(short_fwd_kernel<DP>, threads, smem,
                                       static_cast<long long>(a.B) * a.groups);
  short_fwd_kernel<DP><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fwd

}  // namespace

// q/k/v: bf16 [B, n, H*dh] addressed through element strides (batch, seq),
// unit stride on the last axis; o: bf16 [B, n, H*dh] with strides (o_sb,
// o_sn). 8 < n < 128, dh <= 64. heads_per_block (1..8) sets the block's head
// group (ops/short_attention.py's fwd_heads_per_block). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int H, int n, int dh, int heads_per_block,
                                       long long q_sb, long long q_sn, long long k_sb,
                                       long long k_sn, long long v_sb, long long v_sn,
                                       long long o_sb, long long o_sn, float scale,
                                       void* stream) {
  if (bad_shape(B, H, n, dh) || heads_per_block < 1 || heads_per_block > fwd::MAX_HEADS)
    return static_cast<int>(cudaErrorInvalidValue);
  fwd::Args a{};
  const void* ins[3] = {q, k, v};
  const long long sb[3] = {q_sb, k_sb, v_sb}, sn[3] = {q_sn, k_sn, v_sn};
  long long in_s[9];
  for (int t = 0; t < 3; ++t) {
    a.in[t] = static_cast<const bf16*>(ins[t]);
    a.sb[t] = sb[t];
    a.sn[t] = sn[t];
    in_s[3 * t] = sb[t];
    in_s[3 * t + 1] = dh;  // head offsets are multiples of dh
    in_s[3 * t + 2] = sn[t];
  }
  const long long out_s[3] = {o_sb, dh, o_sn};
  a.out = static_cast<bf16*>(o);
  a.o_sb = o_sb;
  a.o_sn = o_sn;
  a.B = B;
  a.H = H;
  a.n = n;
  a.dh = dh;
  a.hb = heads_per_block;
  a.groups = (H + heads_per_block - 1) / heads_per_block;
  a.np = (n + 31) / 32 * 32;
  a.piece = lam_sm90_host::copy_piece(ins, in_s, 3, dh);
  const void* outs[1] = {o};
  a.out_piece = lam_sm90_host::copy_piece(outs, out_s, 1, dh);
  a.c = scale * lam_sm90::LOG2E;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 16)
    err = fwd::launch<16>(a, st);
  else if (dh <= 32)
    err = fwd::launch<32>(a, st);
  else
    err = fwd::launch<64>(a, st);
  return static_cast<int>(err);
}

// q/k/v/g (g the output gradient, dO): bf16 [B, n, H*dh] through (batch,
// seq) element strides given in `strides` in the order q, k, v, g (8
// values), unit stride on the last axis; dq/dk/dv: bf16 [B, n, H*dh]
// sharing the strides (o_sb, o_sn). heads_per_block (1..8) sets the block's
// head group (ops/short_attention.py's bwd_heads_per_block). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_short_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv, int B,
                                       int H, int n, int dh, int heads_per_block,
                                       const long long* strides, long long o_sb, long long o_sn,
                                       float scale, void* stream) {
  if (bad_shape(B, H, n, dh) || heads_per_block < 1 || heads_per_block > bwd::MAX_HEADS)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd::Args a{};
  const void* ins[4] = {q, k, v, g};
  const void* outs[3] = {dq, dk, dv};
  long long in_s[12], out_s[9];
  for (int t = 0; t < 4; ++t) {
    a.in[t] = static_cast<const bf16*>(ins[t]);
    a.sb[t] = strides[2 * t];
    a.sn[t] = strides[2 * t + 1];
    in_s[3 * t] = a.sb[t];
    in_s[3 * t + 1] = dh;  // head offsets are multiples of dh
    in_s[3 * t + 2] = a.sn[t];
  }
  for (int t = 0; t < 3; ++t) {
    a.out[t] = static_cast<bf16*>(const_cast<void*>(outs[t]));
    out_s[3 * t] = o_sb;
    out_s[3 * t + 1] = dh;
    out_s[3 * t + 2] = o_sn;
  }
  a.o_sb = o_sb;
  a.o_sn = o_sn;
  a.B = B;
  a.H = H;
  a.n = n;
  a.dh = dh;
  a.hb = heads_per_block;
  a.groups = (H + heads_per_block - 1) / heads_per_block;
  a.np = (n + 31) / 32 * 32;
  a.piece = lam_sm90_host::copy_piece(ins, in_s, 4, dh);
  a.out_piece = lam_sm90_host::copy_piece(outs, out_s, 3, dh);
  a.scale = scale;
  a.c = scale * lam_sm90::LOG2E;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 16)
    err = bwd::launch_dp<16>(a, st);
  else if (dh <= 32)
    err = bwd::launch_dp<32>(a, st);
  else
    err = bwd::launch_dp<64>(a, st);
  return static_cast<int>(err);
}
