// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas TPU kernel lam_slide_tpu/ops/flash_attention.py
// `_flash_kernel` (pallas_call in `_flash_forward`), which the DiT's temporal
// axis reaches through `flash_attention_packed`'s head-major fallback at
// dh=24. The same strided design covers the packed-layout kernel
// (`_packed_manual_kernel`) later: q/k/v/o are read and written through
// per-tensor (batch, head, seq) strides with unit stride on dh, so q/k/v can
// be views of linear1's output and o a view of a packed [B, N, H*dh] buffer.
//
// Design: one thread block = one (batch*head, 64-row query tile), 4 warps of
// 16 query rows each. The block loops over 64-key K/V tiles staged in shared
// memory and keeps the running softmax (m, l, acc) in fp32. Products run on
// the tensor cores through WMMA (bf16 operands, fp32 accumulation): S = Q K^T
// per warp into shared memory, the fp32 softmax update by the warp's lanes
// (two lanes per row), P rounded to bf16, then acc += P V with the
// accumulator kept in shared memory so that each row can be rescaled.
// dh is zero-padded to DP (32, 64 or 128) in shared memory only; keys >= Nk
// on the last tile get the -0.7*FLT_MAX logit the JAX kernel uses.
//
// What bounds it on the H100: at the 4AA temporal shape (N=1000, dh=24) a
// call is ~4*N^2*32 FLOPs per head with no score matrix in device memory,
// so it is bound by the tensor-core and shared-memory work per tile, not
// by HBM bytes (q/k/v are ~150 KB per head). This first version favours
// clarity: WMMA through shared memory, scalar tile loads, no cp.async/TMA
// pipelining and no wgmma; those are the levers for making it fast.
//
// Numerics (docs/PERF.md "Kernel numerics"): bf16 operands, fp32 logits
// and statistics, P rounded to bf16 before the AV product, output in q's
// dtype (bf16), division by max(l, 1e-30) as in the JAX kernel.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int NWARPS = 4;     // 16 query rows per warp
constexpr int THREADS = NWARPS * 32;
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

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

// rows [n0, n0 + 64) of one head, zero outside [0, n) x [0, dh)
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long sn,
                                          int n0, int n, int dh) {
  constexpr int LDT = Layout<DP>::LDT;
  for (int idx = threadIdx.x; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    bf16 val = __float2bfloat16(0.0f);
    if (c < dh && n0 + r < n) val = src[static_cast<long long>(n0 + r) * sn + c];
    dst[r * LDT + c] = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int H, int Nq, int Nk, int dh,
                 long long q_sb, long long q_sh, long long q_sn,
                 long long k_sb, long long k_sh, long long k_sn,
                 long long v_sb, long long v_sh, long long v_sn,
                 long long o_sb, long long o_sh, long long o_sn, float scale) {
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

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qp = q + b * q_sb + h * q_sh;
  const bf16* kp = k + b * k_sb + h * k_sh;
  const bf16* vp = v + b * v_sb + h * v_sh;

  load_tile<DP>(Qs, qp, q_sn, q0, Nq, dh);
  for (int i = lane; i < 16 * LDA; i += 32) As[i] = 0.0f;

  // lane owns query row r of its warp's 16, and half of its columns
  const int r = lane >> 1, half = lane & 1;
  float m = NEG_INF, l = 0.0f;
  const int n_tiles = (Nk + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP>(Ks, kp, k_sn, kt * BK, Nk, dh);
    load_tile<DP>(Vs, vp, v_sn, kt * BK, Nk, dh);
    __syncthreads();

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
      if (key0 + j >= Nk) s = NEG_INF;
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
  }
}

template <int DP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int H,
                   int Nq, int Nk, int dh, const long long* s, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<DP>::bytes;
  static cudaError_t attr = lam_set_smem(flash_fwd_kernel<DP>, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Nq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, H, Nq, Nk, dh, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8],
      s[9], s[10], s[11], scale);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/o: bf16 [B, H, N, dh] addressed through element strides
// (batch, head, seq); dh has unit stride. Returns cudaGetLastError().
extern "C" int lam_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H, int Nq, int Nk,
    int dh, long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, void* stream) {
  const long long s[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                           v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  auto qb = static_cast<const bf16*>(q);
  auto kb = static_cast<const bf16*>(k);
  auto vb = static_cast<const bf16*>(v);
  auto ob = static_cast<bf16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 0 || dh > 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dh <= 32)
    err = launch<32>(qb, kb, vb, ob, B, H, Nq, Nk, dh, s, scale, st);
  else if (dh <= 64)
    err = launch<64>(qb, kb, vb, ob, B, H, Nq, Nk, dh, s, scale, st);
  else
    err = launch<128>(qb, kb, vb, ob, B, H, Nq, Nk, dh, s, scale, st);
  return static_cast<int>(err);
}
