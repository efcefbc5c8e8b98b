// FlashAttention backward redesigned for Hopper (sm_90a): bf16 q/k/v/dO and
// dq/dk/dv, no bias and no QK transform, in one pass over the scores.
//
// Replaces the Pallas TPU kernels of K4, lam_slide_tpu/ops/flash_attention.py
// `_flash_bwd_kv_kernel` and `_flash_bwd_q_kernel` (pallas_calls in
// `_flash_backward`, probabilities from `_bwd_probs`), for bf16 inputs
// without a key-padding bias, and of K6, lam_slide_tpu/ops/flash_normrope.py
// `_nr_bwd_kv_kernel` and `_nr_bwd_q_kernel`, which it runs on the q/k that
// qk_normrope.cu transformed once for the forward (K6's grads are those with
// respect to the transformed q/k). csrc/flash_attention_bwd.cu keeps K4's
// bias and fp32 operands.
//
// Three kernels, in the FlashAttention-2/3 structure:
// 1. preprocess: delta = rowsum(dO * O) in fp32 and lse2 = lse * log2(e)
//    per query row into a stats buffer [B*H, Nq/64 rounded up, 2, 64]
//    (padding rows get lse2 = +inf, so their p is 0, and delta 0);
// 2. main: one block per (batch*head, 64-key tile). One producer warp loads
//    the block's K and V once and keeps a 2-stage ring of (Q, dO, stats)
//    query tiles in flight (TMA boxes into swizzled tiles, or cp.async on
//    the second route, as the forward in flash_fwd_sm90.cu); one consumer
//    warpgroup owns the 64 keys, with dK and dV in registers. For each query
//    tile it computes S^T = K Q^T and dP^T = V dO^T on wgmma (keys as M, so
//    no transpose of the score tile is ever needed for dK and dV), then in
//    registers P = 2^(s c - lse2) (c = scale * log2(e): one FFMA and one ex2
//    a score) and dS = bf16(P (dP - delta) scale), and runs dV += bf16(P)^T
//    dO and dK += dS^T Q with P and dS straight from the accumulator
//    registers, dO and Q read MN-major. dQ += dS K needs dS with queries as
//    M, so dS is stored once to shared memory as bf16 and read back MN-major
//    by the fifth product. The warpgroup's dQ tile goes through shared
//    memory and is added into an fp32 accumulator [B*H, Nq rounded up to
//    64, DV] by one asynchronous bulk reduction (cp.reduce.async.bulk
//    .add.f32) a tile, issued by one thread, not element atomics;
// 3. dq: the accumulator rounded to bf16 and written through the caller's
//    strides (packed [B, N, H, dh] memory from the wrapper).
// Five products and one ex2 a score, against seven products and two
// exponentials in flash_attention_bwd.cu (which recomputes S and dP in
// both of its kernels).
//
// dQ's fp32 partial tiles from the key blocks of a head are added in the
// order the blocks get there, so dQ may differ by one bf16 ulp from run to
// run (dK and dV are deterministic). A fixed order (tickets between the
// blocks) and a separate reducer warp (one block an SM less) both measured
// slower on the card.
//
// Rounding points as `_bwd_probs`: P rounded to bf16 for dV, dS =
// bf16(P * (dP - delta) * scale) for dK and dQ, fp32 sums (in another
// order than the plain version's).
//
// What bounds it on the H100: as the forward, the exponential (one ex2 a
// score, 0.13 ms at [32,16,1000,24], 0.29 ms at [1920,16,192,16]) and the
// bytes at the MD17 shape. Padding keys of the last tile are zero rows of K
// and V (TMA's fill), so their dQ contribution is zero and their dK/dV rows
// are not written; padding query rows have p = 0 through lse2 = +inf.
// Registers: dK, dV, S^T and dP^T are 2*DV/2 + 64 floats a thread; at
// dh 128 dQ is formed in two 64-wide halves to stay within 255.

#include <math_constants.h>

#include "hopper.cuh"

using namespace lam_sm90;

namespace {

constexpr int BKEY = 64;   // keys a block (one consumer warpgroup)
constexpr int BQ = 64;     // query rows a tile
constexpr int STAGES = 2;  // (Q, dO, stats) ring
constexpr int CONSUMERS = 128;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int STATS_TILE = 2 * BQ;  // lse2[64] then delta[64], fp32

// Strides are (batch, head, seq) element strides, in this order of tensors.
enum Tensor { TQ = 0, TK = 3, TV = 6, TO = 9, TDO = 12, TDQ = 15, TDK = 18, TDV = 21 };

struct alignas(64) BwdArgs {
  CUtensorMap mq, mk, mv, mdo;  // TMA route
  const bf16 *q, *k, *v, *dout;  // cp.async route
  const float* stats;
  float* dq_acc;
  bf16 *dk, *dv;
  int H, Nq, Nk, dh, piece, k_pairs, v_pairs, q_tiles;
  long long s[24];
  float scale, c;
};

// ---- 1. delta and lse2 ----
__global__ void bwd_preprocess_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                                      const float* __restrict__ lse, float* __restrict__ stats,
                                      int H, int Nq, int dh, int q_tiles, long long o_sb,
                                      long long o_sh, long long o_sn, long long d_sb,
                                      long long d_sh, long long d_sn, long long rows) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int pad = q_tiles * BQ;
  const int bh = static_cast<int>(idx / pad), qi = static_cast<int>(idx % pad);
  const int b = bh / H, h = bh % H;
  float* tile = stats + (static_cast<long long>(bh) * q_tiles + qi / BQ) * STATS_TILE;
  if (qi >= Nq) {
    tile[qi % BQ] = CUDART_INF_F;
    tile[BQ + qi % BQ] = 0.0f;
    return;
  }
  const bf16* o = out + b * o_sb + h * o_sh + qi * o_sn;
  const bf16* d = dout + b * d_sb + h * d_sh + qi * d_sn;
  float delta = 0.0f;
  for (int c = 0; c < dh; ++c) delta = fmaf(__bfloat162float(d[c]), __bfloat162float(o[c]), delta);
  tile[qi % BQ] = lse[static_cast<long long>(bh) * Nq + qi] * LOG2E;
  tile[BQ + qi % BQ] = delta;
}

// ---- 3. dq ----
__global__ void bwd_dq_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, int H, int Nq,
                              int dh, int dv, int pad, long long sb, long long sh, long long sn,
                              long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % dh);
  const long long row = idx / dh;
  const int qi = static_cast<int>(row % Nq), bh = static_cast<int>(row / Nq);
  const int b = bh / H, h = bh % H;
  dq[b * sb + h * sh + qi * sn + c] =
      __float2bfloat16(acc[(static_cast<long long>(bh) * pad + qi) * dv + c]);
}

// ---- 2. the main kernel ----
template <int DV>
struct BwdLayout {
  static constexpr int DP = depth_for(DV);
  // swizzled 64-row tiles of DP columns (hopper.cuh), 1024-byte aligned
  static constexpr size_t tile = BQ * DP * 2;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align1024(tile);
  static constexpr size_t ring_off = v_off + align1024(tile);
  static constexpr size_t stage = align1024(2 * align1024(tile) + STATS_TILE * 4);
  static constexpr size_t ds_off = ring_off + STAGES * stage;
  static constexpr size_t dq_off = ds_off + lam_align128(BKEY * BQ * 2);
  static constexpr size_t bar_off = dq_off + lam_align128(BQ * DV * 4);
  static constexpr size_t bytes = bar_off + (2 * STAGES + 1) * 8 + 1024;  // + base alignment
};

template <int DV, bool TMA>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_sm90_kernel(const __grid_constant__ BwdArgs a) {
  using Lay = BwdLayout<DV>;
  constexpr int DP = Lay::DP;
  constexpr int DQN = DV < 64 ? DV : 64;  // dQ is formed DQN columns at a time
  using G = Swz<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Lay::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Lay::v_off);
  bf16* dSs = reinterpret_cast<bf16*>(smem + Lay::ds_off);
  float* dQs = reinterpret_cast<float*>(smem + Lay::dq_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* kbar = empty + STAGES;
  auto Qs = [&](int st) { return reinterpret_cast<bf16*>(smem + Lay::ring_off + st * Lay::stage); };
  auto dOs = [&](int st) {
    return reinterpret_cast<bf16*>(smem + Lay::ring_off + st * Lay::stage + align1024(Lay::tile));
  };
  auto Ss = [&](int st) {
    return reinterpret_cast<float*>(smem + Lay::ring_off + st * Lay::stage +
                                    2 * align1024(Lay::tile));
  };

  const int k_tiles = (a.Nk + BKEY - 1) / BKEY;
  const int bh = blockIdx.x / k_tiles, k0 = (blockIdx.x % k_tiles) * BKEY;
  const int b = bh / a.H, h = bh % a.H;
  const int n_qt = a.q_tiles;

  if (threadIdx.x == 0) {
    const uint32_t loads = TMA ? 1 : CP_ARRIVALS;
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], loads);
      mbar_init(&empty[st], CONSUMERS / 32);  // one arrival a consumer warp
    }
    mbar_init(kbar, loads);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: K and V once, then the query-tile ring ----
    const int lane = threadIdx.x % 32;
    const float* stats = a.stats + static_cast<long long>(bh) * n_qt * STATS_TILE;
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kbar, 2 * Lay::tile);
#pragma unroll
        for (int p = 0; p < G::PANELS; ++p) {
          tma_load_4d(Ks + p * BKEY * G::PE, &a.mk, kbar, p * G::PE, k0, h, b);
          tma_load_4d(Vs + p * BKEY * G::PE, &a.mv, kbar, p * G::PE, k0, h, b);
        }
        for (int qt = 0; qt < n_qt; ++qt) {
          const int st = qt % STAGES;
          mbar_wait(&empty[st], ((qt / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * Lay::tile + STATS_TILE * 4);
#pragma unroll
          for (int p = 0; p < G::PANELS; ++p) {
            tma_load_4d(Qs(st) + p * BQ * G::PE, &a.mq, &full[st], p * G::PE, qt * BQ, h, b);
            tma_load_4d(dOs(st) + p * BQ * G::PE, &a.mdo, &full[st], p * G::PE, qt * BQ, h, b);
          }
          bulk_load(Ss(st), stats + qt * STATS_TILE, STATS_TILE * 4, &full[st]);
        }
      }
    } else {
      const bf16* qp = a.q + b * a.s[TQ] + h * a.s[TQ + 1];
      const bf16* dop = a.dout + b * a.s[TDO] + h * a.s[TDO + 1];
      cp_tile<BKEY, DP>(Ks, a.k + b * a.s[TK] + h * a.s[TK + 1], a.s[TK + 2], k0, a.Nk, a.dh,
                        a.piece);
      cp_tile<BKEY, DP>(Vs, a.v + b * a.s[TV] + h * a.s[TV + 1], a.s[TV + 2], k0, a.Nk, a.dh,
                        a.piece);
      cp_tile_arrive(kbar);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int st = qt % STAGES;
        mbar_wait(&empty[st], ((qt / STAGES) & 1) ^ 1);
        cp_tile<BQ, DP>(Qs(st), qp, a.s[TQ + 2], qt * BQ, a.Nq, a.dh, a.piece);
        cp_tile<BQ, DP>(dOs(st), dop, a.s[TDO + 2], qt * BQ, a.Nq, a.dh, a.piece);
        cp_async(Ss(st) + 4 * lane, stats + qt * STATS_TILE + 4 * lane, 16);  // 512 bytes
        cp_tile_arrive(&full[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 keys ----
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = lane % 4;
  const float c = a.c, scale = a.scale;

  float dk[DV / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dk[i] = dv[i] = 0.0f;

  mbar_wait(kbar, 0);
  if constexpr (!TMA) fence_proxy_async();
  const uint64_t ds_mn = make_desc(dSs, 128, BKEY * 16);  // dS as A of dQ (MN-major)

  for (int qt = 0; qt < n_qt; ++qt) {
    const int st = qt % STAGES;
    mbar_wait(&full[st], (qt / STAGES) & 1);
    if constexpr (!TMA) fence_proxy_async();
    const float* lse2 = Ss(st);
    const float* delta = lse2 + BQ;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      wgmma_ss<BQ, 0, 0>(s, kmajor_desc<DP, BKEY>(Ks, 0, kd), kmajor_desc<DP, BQ>(Qs(st), 0, kd),
                         kd > 0);
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      wgmma_ss<BQ, 0, 0>(dp, kmajor_desc<DP, BKEY>(Vs, 0, kd),
                         kmajor_desc<DP, BQ>(dOs(st), 0, kd), kd > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    reg_fence(dp);

    // P and dS in registers; element i is key row 16w + g + 8((i/2)%2),
    // query column 8(i/4) + 2cq + i%2
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * cq + i % 2;
      const float p = ex2(fmaf(s[i], c, -lse2[col]));
      s[i] = p;
      dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], delta[col])), scale);
    }
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_fragment<BQ>(s, kk, pf[kk]);
      a_fragment<BQ>(dp, kk, df[kk]);
    }
    // dS^T into shared memory as a slab tile (keys as rows, queries in
    // slabs): the A operand of dQ = dS K, read MN-major
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int slab = 2 * kk + m / 2, row = 16 * warp + g + 8 * (m % 2);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(dSs) + slab * BKEY * 16 +
                                     row * 16 + cq * 4) = df[kk][m];
      }
    }
    fence_proxy_async();
    named_sync(1, CONSUMERS);

    // dV += P^T dO, dK += dS^T Q (A from registers), then dQ = dS K
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<DV, 1>(dv, pf[kk], mnmajor_desc<DP, BQ>(dOs(st), kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<DV, 1>(dk, df[kk], mnmajor_desc<DP, BQ>(Qs(st), kk), 1);
#pragma unroll
    for (int ch = 0; ch < DV / DQN; ++ch) {
      float dq[DQN / 2];
      if (ch > 0) wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk)
        wgmma_ss<DQN, 1, 1>(dq, ds_mn + (kk * 256 >> 4),
                            mnmajor_desc<DP, BKEY>(Ks, kk, ch * DQN / G::PE), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dq);
      if (ch == 0) {
        reg_fence(dv);
        reg_fence(dk);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          reg_fence(pf[kk]);
          reg_fence(df[kk]);
        }
        // the previous tile's reduction has read the dQ buffer
        if (threadIdx.x == 0) bulk_wait_read();
        named_sync(1, CONSUMERS);
      }
#pragma unroll
      for (int e = 0; e < DQN / 2; e += 2) {
        const int row = 16 * warp + g + 8 * ((e / 2) % 2);
        const int col = ch * DQN + 8 * (e / 4) + 2 * cq;
        *reinterpret_cast<float2*>(dQs + row * DV + col) = make_float2(dq[e], dq[e + 1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    fence_proxy_async();  // the bulk reduction reads the tile through the async proxy
    named_sync(1, CONSUMERS);
    if (threadIdx.x == 0)
      bulk_reduce_add_f32(a.dq_acc + (static_cast<long long>(bh) * n_qt + qt) * BQ * DV, dQs,
                          BQ * DV * 4);
  }
  if (threadIdx.x == 0) bulk_wait_all();

  // dK, dV rows < Nk, columns < dh, in bf16 through the caller's strides
  bf16* dkb = a.dk + b * a.s[TDK] + h * a.s[TDK + 1];
  bf16* dvb = a.dv + b * a.s[TDV] + h * a.s[TDV + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + g + 8 * r;
    if (key >= a.Nk) continue;
    bf16* krow = dkb + static_cast<long long>(key) * a.s[TDK + 2];
    bf16* vrow = dvb + static_cast<long long>(key) * a.s[TDV + 2];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * cq;
      const int i = 4 * j + 2 * r;
      if (a.k_pairs && col + 1 < a.dh) {
        *reinterpret_cast<__nv_bfloat162*>(krow + col) = __floats2bfloat162_rn(dk[i], dk[i + 1]);
      } else {
        if (col < a.dh) krow[col] = __float2bfloat16(dk[i]);
        if (col + 1 < a.dh) krow[col + 1] = __float2bfloat16(dk[i + 1]);
      }
      if (a.v_pairs && col + 1 < a.dh) {
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) = __floats2bfloat162_rn(dv[i], dv[i + 1]);
      } else {
        if (col < a.dh) vrow[col] = __float2bfloat16(dv[i]);
        if (col + 1 < a.dh) vrow[col + 1] = __float2bfloat16(dv[i + 1]);
      }
    }
  }
}

template <int DV, bool TMA>
cudaError_t launch_main(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = BwdLayout<DV>::bytes;
  static cudaError_t attr = lam_set_smem(flash_bwd_sm90_kernel<DV, TMA>, smem);
  if (attr != cudaSuccess) return attr;
  const unsigned grid = static_cast<unsigned>(B) * a.H * ((a.Nk + BKEY - 1) / BKEY);
  flash_bwd_sm90_kernel<DV, TMA><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool TMA>
cudaError_t launch_dv(const BwdArgs& a, int B, cudaStream_t st) {
  switch (width_for(a.dh)) {
    case 16: return launch_main<16, TMA>(a, B, st);
    case 24: return launch_main<24, TMA>(a, B, st);
    case 32: return launch_main<32, TMA>(a, B, st);
    case 64: return launch_main<64, TMA>(a, B, st);
    default: return launch_main<128, TMA>(a, B, st);
  }
}

bool pairs_ok(const void* p, const long long* s) {
  return reinterpret_cast<unsigned long long>(p) % 4 == 0 && s[0] % 2 == 0 && s[1] % 2 == 0 &&
         s[2] % 2 == 0;
}

}  // namespace

// q/k/v/out/dout and dq/dk/dv: bf16 [B, H, N, dh] addressed through element
// strides (batch, head, seq) given in `strides` in the order q, k, v, out,
// dout, dq, dk, dv (24 values); unit stride on dh. lse: fp32 [B, H, Nq]
// contiguous, the forward's. scratch: fp32, 16-byte aligned, of the size
// lam_flash_attention_bwd_sm90_scratch gives; it holds the stats tiles,
// [B*H, ceil(Nq/64), 2, 64], then the dQ accumulator, [B*H, ceil(Nq/64)*64,
// DV] with DV the kernel's width for dh (16, 24, 32, 64 or 128). tma: as
// lam_flash_attention_fwd_sm90, for q, k, v and dout. Launches the three
// kernels (and a memset of the accumulator) on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for inputs it does not take.
extern "C" int lam_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* scratch, void* dq, void* dk, void* dv, int B, int H, int Nq, int Nk,
    int dh, const long long* strides, float scale, int tma, void* stream) {
  if (dh <= 0 || dh > 128 || Nq <= 0 || Nk <= 0 || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const int dvw = width_for(dh), dpw = depth_for(dvw);
  const int q_tiles = (Nq + BQ - 1) / BQ;
  const long long bhs = static_cast<long long>(B) * H;
  auto st = static_cast<cudaStream_t>(stream);
  float* stats = static_cast<float*>(scratch);
  float* dq_acc = stats + bhs * q_tiles * STATS_TILE;  // 512 bytes a tile: aligned

  cudaError_t err = cudaMemsetAsync(dq_acc, 0, bhs * q_tiles * BQ * dvw * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = bhs * q_tiles * BQ;
  bwd_preprocess_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), stats, H, Nq, dh, q_tiles, s[TO],
      s[TO + 1], s[TO + 2], s[TDO], s[TDO + 1], s[TDO + 2], rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  BwdArgs a{};
  for (int i = 0; i < 24; ++i) a.s[i] = s[i];
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.stats = stats;
  a.dq_acc = dq_acc;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.dh = dh;
  a.q_tiles = q_tiles;
  a.scale = scale;
  a.c = scale * LOG2E;
  a.k_pairs = pairs_ok(dk, s + TDK);
  a.v_pairs = pairs_ok(dv, s + TDV);
  if (tma) {
    if (dh % 8) return static_cast<int>(cudaErrorInvalidValue);
    using lam_sm90_host::encode_tile_map;
    if (!encode_tile_map(&a.mq, q, B, H, Nq, dh, s[TQ], s[TQ + 1], s[TQ + 2], BQ, dpw) ||
        !encode_tile_map(&a.mdo, dout, B, H, Nq, dh, s[TDO], s[TDO + 1], s[TDO + 2], BQ, dpw) ||
        !encode_tile_map(&a.mk, k, B, H, Nk, dh, s[TK], s[TK + 1], s[TK + 2], BKEY, dpw) ||
        !encode_tile_map(&a.mv, v, B, H, Nk, dh, s[TV], s[TV + 1], s[TV + 2], BKEY, dpw))
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch_dv<true>(a, B, st);
  } else {
    const void* ptrs[4] = {q, k, v, dout};
    const long long ps[12] = {s[TQ], s[TQ + 1], s[TQ + 2], s[TK], s[TK + 1], s[TK + 2],
                              s[TV], s[TV + 1], s[TV + 2], s[TDO], s[TDO + 1], s[TDO + 2]};
    a.piece = lam_sm90_host::copy_piece(ptrs, ps, 4, dh);
    err = launch_dv<false>(a, B, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = bhs * Nq * dh;
  bwd_dq_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      dq_acc, static_cast<bf16*>(dq), H, Nq, dh, dvw, q_tiles * BQ,
      s[TDQ], s[TDQ + 1], s[TDQ + 2], total);
  return static_cast<int>(cudaGetLastError());
}

// Floats of fp32 scratch lam_flash_attention_bwd_sm90 takes for these
// sizes (its caller allocates them), or -1 for sizes it does not take.
extern "C" long long lam_flash_attention_bwd_sm90_scratch(int B, int H, int Nq, int dh) {
  if (dh <= 0 || dh > 128 || Nq <= 0 || B <= 0 || H <= 0) return -1;
  const long long q_tiles = (Nq + BQ - 1) / BQ;
  return static_cast<long long>(B) * H * q_tiles * (STATS_TILE + BQ * width_for(dh));
}
