// Grouped whole-attention backward for short sequences on Hopper (sm_90a):
// bf16 in / bf16 out on the tensor cores and an fp32 in / fp32 out FFMA
// kernel.
//
// Replaces K11, lam_slide_tpu/ops/ablations/short_backward.py
// `_flash_bwd_short_kernel` (pallas_call in `_flash_backward_short`): the
// backward of unmasked attention over whole short sequences from the
// forward's output, its per-row log-sum-exp and the output gradient. Given
// lse [B, H, Nq] and delta = rowsum(dO * O) [B, H, Nq] (fp32, computed
// outside the kernel as in JAX), for each (batch*head) item
//   P = exp(Q K^T * scale - lse),
//   dV = bf16(P)^T dO,   dP = dO V^T,
//   dS = bf16(P * (dP - delta) * scale),   dQ = dS K,   dK = dS^T Q,
// with fp32 accumulation and the JAX kernel's rounding points; the grads are
// written in the operands' dtype through (batch, head, seq) strides.
//
// Design: one thread block per (batch*head) item, which the TPU kernel runs
// `group` at a time (the group only sets how its grid pads, so it has no
// counterpart here). Q, dO, K and V of the item are staged whole in shared
// memory, rows zero-padded to a multiple of 16 and dh to DP (16, 32 or 64);
// at the MD17 spatial shape (N = 192, dh = 16) each is 9 KB with its row
// padding. The TPU kernel failed at this shape for lack of device memory,
// because Mosaic lays the 24-wide lane axis of every operand out in (8, 128)
// tiles; here nothing is padded in device memory. Four warps split the work
// so that no output is summed by two of them (no atomics): for dK and dV a
// warp owns 16-key blocks and walks the 16-query blocks, for dQ it owns
// 16-query blocks and walks the key blocks, recomputing S and dP (WMMA,
// bf16 operands, fp32 accumulation) into warp-private scratch, where its
// lanes form P and dS; the products with the other side accumulate in WMMA
// fragments held in registers.
//
// What bounds it on the H100: at N = 192, dh = 16 the item's five products
// (seven with the recompute of S and dP for dQ) are ~2.4 MFLOP against
// ~37 KB of q/k/v/out/dO/dq/dk/dv in bf16, 64 FLOP per byte, so device
// memory bytes, as for the forward. This first version favours clarity:
// scalar staging loads, WMMA through shared memory, S and dP computed twice.
//
// fp32 operands (JAX's own K11 tests run in fp32): WMMA takes no fp32
// operands and TF32 would not match, so a second kernel runs FFMA on the
// CUDA cores: the item's fp32 Q, dO, K, V in shared memory, one thread per
// key for dK/dV and one per query for dQ, no atomics. dh <= 32.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int SB_WARPS = 4;
constexpr int SB_THREADS = SB_WARPS * 32;
constexpr int MAX_N = 256;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of the bf16 kernel for padded lengths nqp/nkp.
template <int DP>
struct ShortBwdLayout {
  static constexpr int LDT = DP + 8;  // bf16 tile row stride
  static constexpr int LDS = 16 + 4;  // fp32 S / dP row stride
  static constexpr int LDP = 16 + 8;  // bf16 P / dS row stride
  static constexpr int LDO = DP + 4;  // fp32 output staging row stride
  static constexpr size_t warp_bytes = lam_align128(2 * 16 * LDS * sizeof(float)) +
                                       lam_align128(2 * 16 * LDP * sizeof(bf16)) +
                                       lam_align128(16 * LDO * sizeof(float));
  int nqp, nkp;
  __host__ __device__ size_t q_off() const { return 0; }
  __host__ __device__ size_t do_off() const {
    return lam_align128(q_off() + nqp * LDT * sizeof(bf16));
  }
  __host__ __device__ size_t k_off() const {
    return lam_align128(do_off() + nqp * LDT * sizeof(bf16));
  }
  __host__ __device__ size_t v_off() const {
    return lam_align128(k_off() + nkp * LDT * sizeof(bf16));
  }
  __host__ __device__ size_t rows_off() const {
    return lam_align128(v_off() + nkp * LDT * sizeof(bf16));
  }
  __host__ __device__ size_t warps_off() const {
    return lam_align128(rows_off() + 2 * nqp * sizeof(float));
  }
  __host__ __device__ size_t bytes() const { return warps_off() + SB_WARPS * warp_bytes; }
};

// Rows [0, np) of one head into a [np, DP] tile with row stride ld, zero
// outside [0, n) x [0, dh).
template <int DP, typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long sn, int np, int n,
                                      int dh) {
  for (int idx = threadIdx.x; idx < np * DP; idx += blockDim.x) {
    const int r = idx / DP, c = idx % DP;
    T val{};  // zero for float and bf16
    if (c < dh && r < n) val = src[static_cast<long long>(r) * sn + c];
    dst[r * ld + c] = val;
  }
}

struct Item {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int H, Nq, Nk, dh;
  long long s[21];  // (batch, head, seq) strides of q, k, v, g, dq, dk, dv
  float scale;
};

// One warp's 16 x 16 block of S = Q K^T and dP = dO V^T (fp32, into Ss and
// Dps), then P and dS for it (bf16, into Ps and Dss); rows >= Nq and keys
// >= Nk give P = dS = 0.
template <int DP>
__device__ __forceinline__ void probs_block(const bf16* Qs, const bf16* Dos, const bf16* Ks,
                                            const bf16* Vs, const float* lse_s,
                                            const float* delta_s, int ib, int jb, int Nq, int Nk,
                                            float scale, float* Ss, float* Dps, bf16* Ps,
                                            bf16* Dss) {
  using Lay = ShortBwdLayout<DP>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dp;
  wmma::fill_fragment(s, 0.0f);
  wmma::fill_fragment(dp, 0.0f);
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
    wmma::load_matrix_sync(a, Qs + ib * 16 * LDT + kd * 16, LDT);
    wmma::load_matrix_sync(bt, Ks + jb * 16 * LDT + kd * 16, LDT);
    wmma::mma_sync(s, a, bt, s);
    wmma::load_matrix_sync(a, Dos + ib * 16 * LDT + kd * 16, LDT);
    wmma::load_matrix_sync(bt, Vs + jb * 16 * LDT + kd * 16, LDT);
    wmma::mma_sync(dp, a, bt, dp);
  }
  wmma::store_matrix_sync(Ss, s, LDS, wmma::mem_row_major);
  wmma::store_matrix_sync(Dps, dp, LDS, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32;
  for (int e = lane; e < 256; e += 32) {
    const int r = e / 16, c = e % 16;
    const int row = ib * 16 + r, key = jb * 16 + c;
    float p = 0.0f, ds = 0.0f;
    if (row < Nq && key < Nk) {
      p = expf(__fsub_rn(__fmul_rn(Ss[r * LDS + c], scale), lse_s[row]));
      ds = __fmul_rn(__fmul_rn(p, __fsub_rn(Dps[r * LDS + c], delta_s[row])), scale);
    }
    Ps[r * LDP + c] = __float2bfloat16(p);
    Dss[r * LDP + c] = __float2bfloat16(ds);
  }
  __syncwarp();
}

// Write a warp's 16 x DP fp32 fragments (staged through Os) as rows
// [row0, row0 + 16) of a [n, dh] bf16 output, rows < n and columns < dh.
template <int DP>
__device__ __forceinline__ void write_block(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[DP / 16], float* Os, bf16* dst,
    long long sn, int row0, int n, int dh) {
  constexpr int LDO = ShortBwdLayout<DP>::LDO;
#pragma unroll
  for (int dn = 0; dn < DP / 16; ++dn)
    wmma::store_matrix_sync(Os + dn * 16, acc[dn], LDO, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32;
  for (int e = lane; e < 16 * DP; e += 32) {
    const int r = e / DP, c = e % DP;
    if (row0 + r < n && c < dh)
      dst[static_cast<long long>(row0 + r) * sn + c] = __float2bfloat16(Os[r * LDO + c]);
  }
  __syncwarp();
}

template <int DP>
__global__ void __launch_bounds__(SB_THREADS) short_bwd_kernel(Item it) {
  using Lay = ShortBwdLayout<DP>;
  constexpr int LDT = Lay::LDT, LDS = Lay::LDS, LDP = Lay::LDP;
  const Lay lay{round16(it.Nq), round16(it.Nk)};
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + lay.q_off());
  bf16* Dos = reinterpret_cast<bf16*>(smem + lay.do_off());
  bf16* Ks = reinterpret_cast<bf16*>(smem + lay.k_off());
  bf16* Vs = reinterpret_cast<bf16*>(smem + lay.v_off());
  float* lse_s = reinterpret_cast<float*>(smem + lay.rows_off());
  float* delta_s = lse_s + lay.nqp;
  const int warp = threadIdx.x / 32;
  unsigned char* wbase = smem + lay.warps_off() + warp * Lay::warp_bytes;
  float* Ss = reinterpret_cast<float*>(wbase);
  float* Dps = Ss + 16 * LDS;
  bf16* Ps = reinterpret_cast<bf16*>(wbase + lam_align128(2 * 16 * LDS * sizeof(float)));
  bf16* Dss = Ps + 16 * LDP;
  float* Os = reinterpret_cast<float*>(wbase + lam_align128(2 * 16 * LDS * sizeof(float)) +
                                       lam_align128(2 * 16 * LDP * sizeof(bf16)));

  const long long* s = it.s;
  const int bh = blockIdx.x, b = bh / it.H, h = bh % it.H;
  auto at = [&](const void* p, int t) {
    return static_cast<const bf16*>(p) + b * s[3 * t] + h * s[3 * t + 1];
  };
  stage<DP>(Qs, LDT, at(it.q, 0), s[2], lay.nqp, it.Nq, it.dh);
  stage<DP>(Ks, LDT, at(it.k, 1), s[5], lay.nkp, it.Nk, it.dh);
  stage<DP>(Vs, LDT, at(it.v, 2), s[8], lay.nkp, it.Nk, it.dh);
  stage<DP>(Dos, LDT, at(it.g, 3), s[11], lay.nqp, it.Nq, it.dh);
  for (int r = threadIdx.x; r < lay.nqp; r += blockDim.x) {
    const bool ok = r < it.Nq;
    lse_s[r] = ok ? it.lse[static_cast<long long>(bh) * it.Nq + r] : 0.0f;
    delta_s[r] = ok ? it.delta[static_cast<long long>(bh) * it.Nq + r] : 0.0f;
  }
  __syncthreads();

  const int qblocks = lay.nqp / 16, kblocks = lay.nkp / 16;
  // dK and dV: this warp's key blocks, every query block
  for (int jb = warp; jb < kblocks; jb += SB_WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[DP / 16], dv[DP / 16];
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) {
      wmma::fill_fragment(dk[dn], 0.0f);
      wmma::fill_fragment(dv[dn], 0.0f);
    }
    for (int ib = 0; ib < qblocks; ++ib) {
      probs_block<DP>(Qs, Dos, Ks, Vs, lse_s, delta_s, ib, jb, it.Nq, it.Nk, it.scale, Ss, Dps,
                      Ps, Dss);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pt, dst;
      wmma::load_matrix_sync(pt, Ps, LDP);
      wmma::load_matrix_sync(dst, Dss, LDP);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, Dos + ib * 16 * LDT + dn * 16, LDT);
        wmma::mma_sync(dv[dn], pt, bm, dv[dn]);
        wmma::load_matrix_sync(bm, Qs + ib * 16 * LDT + dn * 16, LDT);
        wmma::mma_sync(dk[dn], dst, bm, dk[dn]);
      }
      __syncwarp();
    }
    bf16* dkp = static_cast<bf16*>(it.dk) + b * s[15] + h * s[16];
    bf16* dvp = static_cast<bf16*>(it.dv) + b * s[18] + h * s[19];
    write_block<DP>(dk, Os, dkp, s[17], jb * 16, it.Nk, it.dh);
    write_block<DP>(dv, Os, dvp, s[20], jb * 16, it.Nk, it.dh);
  }
  // dQ: this warp's query blocks, every key block
  for (int ib = warp; ib < qblocks; ib += SB_WARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq[DP / 16];
#pragma unroll
    for (int dn = 0; dn < DP / 16; ++dn) wmma::fill_fragment(dq[dn], 0.0f);
    for (int jb = 0; jb < kblocks; ++jb) {
      probs_block<DP>(Qs, Dos, Ks, Vs, lse_s, delta_s, ib, jb, it.Nq, it.Nk, it.scale, Ss, Dps,
                      Ps, Dss);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> dsm;
      wmma::load_matrix_sync(dsm, Dss, LDP);
#pragma unroll
      for (int dn = 0; dn < DP / 16; ++dn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(bm, Ks + jb * 16 * LDT + dn * 16, LDT);
        wmma::mma_sync(dq[dn], dsm, bm, dq[dn]);
      }
      __syncwarp();
    }
    bf16* dqp = static_cast<bf16*>(it.dq) + b * s[12] + h * s[13];
    write_block<DP>(dq, Os, dqp, s[14], ib * 16, it.Nq, it.dh);
  }
}

template <int DP>
cudaError_t launch_bf16(const Item& it, int BH, cudaStream_t stream) {
  const ShortBwdLayout<DP> lay{round16(it.Nq), round16(it.Nk)};
  const size_t smem = lay.bytes();
  // the largest layout (both lengths MAX_N) sets the attribute once
  static cudaError_t attr = lam_set_smem(short_bwd_kernel<DP>,
                                         ShortBwdLayout<DP>{MAX_N, MAX_N}.bytes());
  if (attr != cudaSuccess) return attr;
  short_bwd_kernel<DP><<<BH, SB_THREADS, smem, stream>>>(it);
  return cudaGetLastError();
}

// fp32: the item's Q, dO, K, V in shared memory ([n][DP], zero beyond dh),
// one thread per owned row, FFMA.
constexpr int F32_DP = 32;

template <int DP>
__global__ void __launch_bounds__(SB_THREADS) short_bwd_f32_kernel(Item it) {
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Dos = Qs + it.Nq * DP;
  float* Ks = Dos + it.Nq * DP;
  float* Vs = Ks + it.Nk * DP;
  float* lse_s = Vs + it.Nk * DP;
  float* delta_s = lse_s + it.Nq;
  const long long* s = it.s;
  const int bh = blockIdx.x, b = bh / it.H, h = bh % it.H;
  auto at = [&](const void* p, int t) {
    return static_cast<const float*>(p) + b * s[3 * t] + h * s[3 * t + 1];
  };
  stage<DP>(Qs, DP, at(it.q, 0), s[2], it.Nq, it.Nq, it.dh);
  stage<DP>(Ks, DP, at(it.k, 1), s[5], it.Nk, it.Nk, it.dh);
  stage<DP>(Vs, DP, at(it.v, 2), s[8], it.Nk, it.Nk, it.dh);
  stage<DP>(Dos, DP, at(it.g, 3), s[11], it.Nq, it.Nq, it.dh);
  for (int r = threadIdx.x; r < it.Nq; r += blockDim.x) {
    lse_s[r] = it.lse[static_cast<long long>(bh) * it.Nq + r];
    delta_s[r] = it.delta[static_cast<long long>(bh) * it.Nq + r];
  }
  __syncthreads();
  const float scale = it.scale;

  // dK and dV: one thread per key
  for (int j = threadIdx.x; j < it.Nk; j += blockDim.x) {
    float kr[DP], vr[DP], dk[DP], dv[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      kr[c] = Ks[j * DP + c];
      vr[c] = Vs[j * DP + c];
      dk[c] = dv[c] = 0.0f;
    }
    for (int i = 0; i < it.Nq; ++i) {
      const float* qi = Qs + i * DP;
      const float* doi = Dos + i * DP;
      float sv = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        sv = fmaf(qi[c], kr[c], sv);
        dp = fmaf(doi[c], vr[c], dp);
      }
      const float p = expf(__fsub_rn(__fmul_rn(sv, scale), lse_s[i]));
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta_s[i])), scale);
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        dv[c] = fmaf(p, doi[c], dv[c]);
        dk[c] = fmaf(ds, qi[c], dk[c]);
      }
    }
    float* dkp = static_cast<float*>(it.dk) + b * s[15] + h * s[16] + j * s[17];
    float* dvp = static_cast<float*>(it.dv) + b * s[18] + h * s[19] + j * s[20];
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < it.dh) {
        dkp[c] = dk[c];
        dvp[c] = dv[c];
      }
  }
  // dQ: one thread per query
  for (int i = threadIdx.x; i < it.Nq; i += blockDim.x) {
    float qr[DP], dor[DP], dq[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      qr[c] = Qs[i * DP + c];
      dor[c] = Dos[i * DP + c];
      dq[c] = 0.0f;
    }
    for (int j = 0; j < it.Nk; ++j) {
      const float* kj = Ks + j * DP;
      const float* vj = Vs + j * DP;
      float sv = 0.0f, dp = 0.0f;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        sv = fmaf(qr[c], kj[c], sv);
        dp = fmaf(dor[c], vj[c], dp);
      }
      const float p = expf(__fsub_rn(__fmul_rn(sv, scale), lse_s[i]));
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta_s[i])), scale);
#pragma unroll
      for (int c = 0; c < DP; ++c) dq[c] = fmaf(ds, kj[c], dq[c]);
    }
    float* dqp = static_cast<float*>(it.dq) + b * s[12] + h * s[13] + i * s[14];
#pragma unroll
    for (int c = 0; c < DP; ++c)
      if (c < it.dh) dqp[c] = dq[c];
  }
}

template <int DP>
cudaError_t launch_f32(const Item& it, int BH, cudaStream_t stream) {
  const size_t smem = (2 * (it.Nq + it.Nk) * DP + 2 * it.Nq) * sizeof(float);
  static cudaError_t attr =
      lam_set_smem(short_bwd_f32_kernel<DP>, (4 * MAX_N * DP + 2 * MAX_N) * sizeof(float));
  if (attr != cudaSuccess) return attr;
  short_bwd_f32_kernel<DP><<<BH, SB_THREADS, smem, stream>>>(it);
  return cudaGetLastError();
}

Item make_item(const void* q, const void* k, const void* v, const void* g, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, int H, int Nq, int Nk, int dh,
               const long long* strides, float scale) {
  Item it{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
          dq, dk, dv, H, Nq, Nk, dh, {}, scale};
  for (int i = 0; i < 21; ++i) it.s[i] = strides[i];
  return it;
}

}  // namespace

// q/k/v/g(= dO, in q's dtype) and dq/dk/dv: [B, H, N, dh] addressed through
// element strides (batch, head, seq), 21 of them in the order q, k, v, g,
// dq, dk, dv; unit stride on dh. lse, delta: fp32 [B, H, Nq] contiguous.
// Nq, Nk <= 256. bf16: dh <= 64. Returns cudaGetLastError().
extern "C" int lam_short_backward(const void* q, const void* k, const void* v, const void* g,
                                  const void* lse, const void* delta, void* dq, void* dk,
                                  void* dv, int B, int H, int Nq, int Nk, int dh,
                                  const long long* strides, float scale, void* stream) {
  if (dh <= 0 || dh > 64 || Nq <= 0 || Nk <= 0 || Nq > MAX_N || Nk > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Item it = make_item(q, k, v, g, lse, delta, dq, dk, dv, H, Nq, Nk, dh, strides, scale);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh <= 16)
    err = launch_bf16<16>(it, B * H, st);
  else if (dh <= 32)
    err = launch_bf16<32>(it, B * H, st);
  else
    err = launch_bf16<64>(it, B * H, st);
  return static_cast<int>(err);
}

// As lam_short_backward on fp32 tensors; dh <= 32.
extern "C" int lam_short_backward_f32(const void* q, const void* k, const void* v,
                                      const void* g, const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int B, int H, int Nq,
                                      int Nk, int dh, const long long* strides, float scale,
                                      void* stream) {
  if (dh <= 0 || dh > F32_DP || Nq <= 0 || Nk <= 0 || Nq > MAX_N || Nk > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Item it = make_item(q, k, v, g, lse, delta, dq, dk, dv, H, Nq, Nk, dh, strides, scale);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dh <= 16 ? launch_f32<16>(it, B * H, st)
                                   : launch_f32<F32_DP>(it, B * H, st);
  return static_cast<int>(err);
}
