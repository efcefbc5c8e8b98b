// Flash-attention forward redesigned for Hopper (sm_90a): bf16 q/k/v/o,
// fp32 statistics, no bias and no QK transform.
//
// Replaces two Pallas TPU kernels for these inputs:
// - K1, lam_slide_tpu/ops/flash_attention.py `_flash_kernel` (pallas_call
//   in `_flash_forward`), the head-major forward;
// - K3, the same file's `_packed_manual_kernel` (`flash_attention_packed`):
//   this kernel reads q/k/v and writes o through (batch, head, seq) element
//   strides, so K3 is the same binary called on head-major views of packed
//   [B, N, H*dh] memory, with no copy in or out.
// It also runs K5, lam_slide_tpu/ops/flash_normrope.py `_nr_flash_kernel`,
// on the q/k that qk_normrope.cu transforms once. K1's key-padding bias, its
// fp32 operands and K10 stay on the template of flash_attention.cu.
//
// What bounds it on the H100. At the main paths' head dims (16 at N = 192,
// 24 at N = 1000) the products are small (4*N^2*dh FLOPs a head) and the
// bytes smaller still, so the floor is the exponential: one ex2 per score on
// the special-function units, 16 per SM per clock, ~3.9 T/s on the card
// (0.066 ms at [16,16,1000,24], 1.45 ms at [9600,16,192,16]; the tensor-core
// bound is 0.025 ms and the bytes bound 1.13 ms there). The design keeps the
// softmax off shared memory and gives each score one FFMA, one ex2, one
// compare and one add:
// - warp specialisation: one producer warp keeps the K/V tiles of a
//   3-stage ring in flight (a full and an empty mbarrier per stage; the
//   consumers arrive once a warp) while NCW consumer warpgroups own 64
//   query rows each and share every K/V tile;
// - loads: row-major tiles in TMA's 32/64/128-byte swizzle (hopper.cuh),
//   one TMA box a 64-column panel (route TMA: dh % 8 == 0 and every base
//   and stride 16-byte aligned, the predicate `sm90_tma_ok` of the
//   wrapper); otherwise the same producer warp writes the same swizzled
//   tiles with cp.async in the largest pieces the alignment allows (2-byte
//   pieces through registers), the template's second route;
// - products on wgmma: S = Q K^T as m64n64k16 with Q and K read K-major
//   from shared memory, dh zero-padded to DP (a multiple of 16) in shared
//   memory only; O += P V as m64nDVk16 with P from registers and V read
//   MN-major, DV = dh rounded up to 8 (16, 24, 32) or to 64 / 128 above
//   32, so the output accumulator at dh 24 is 24 wide;
// - the softmax in registers: the S accumulator's fragments are the P
//   operand's (hopper.cuh a_fragment), the row extreme by quad shuffles
//   (the largest logit, or the smallest when scale < 0: one compare a
//   score, under a uniform branch), the row sum kept per thread and reduced
//   once at the end, p = ex2(s * c - m2) with c = scale * log2(e) folded
//   into one FFMA.
// Tile sizes: 64 keys a tile. Query rows a block: 128 (two warpgroups) for
// long sequences, so K/V loads are shared and two blocks fit an SM (~78
// registers a thread); 192 (three) for 129..192 queries, so at N = 192 a
// block holds the whole sequence, loads K and V once a head and pads no
// row; 64 for at most 64 queries. A 128-key tile (one block an SM at 128
// registers) and the unswizzled 16-byte-row layout measured slower (PERF.md
// §6). Within a warpgroup S, softmax and P V run in order; the overlap is
// across warpgroups and blocks, so at dh 24 the softmax's instruction issue
// and latency, not the ex2 units, set the time (~2x the exp floor).
//
// Numerics (docs/PERF.md "Kernel numerics", as `_flash_kernel`): bf16
// operands, fp32 logits and statistics, P rounded to bf16 before P V, the
// row sum l over the unrounded fp32 p, output o / max(l, 1e-30) in bf16,
// and when asked lse = m + log(max(l, 1e-30)) in natural-log units, with m
// the row's largest scaled logit (the raw extreme times scale, as the plain
// version scales it). Keys >= Nk get p = 0; rows >= Nq are not written.
// ex2.approx's relative error (~2^-22) is far below bf16's rounding.
//
// Grid: one axis over (batch*head, query tile), tile fastest, as
// flash_tiles.cuh's tile_index: the MD17 spatial axis has 153,600
// batch*head pairs.

#include <math_constants.h>

#include "hopper.cuh"

using namespace lam_sm90;

namespace {

constexpr int BK = 64;      // keys a tile
constexpr int STAGES = 3;  // K/V ring

// A block's shape: NCW consumer warpgroups of 64 query rows each and one
// producer warp.
template <int NCW>
struct Shape {
  static constexpr int BQ = 64 * NCW;
  static constexpr int CONSUMERS = 128 * NCW;
  static constexpr int THREADS = CONSUMERS + 32;
};

struct alignas(64) FwdArgs {
  CUtensorMap mq, mk, mv;  // TMA route
  const bf16 *q, *k, *v;   // cp.async route
  bf16* o;
  float* lse;
  int H, Nq, Nk, dh, piece, o_pairs;
  long long s[12];  // (batch, head, seq) element strides of q, k, v, o
  float scale, c;   // c = scale * log2(e)
};

template <int DV, int NCW>
struct FwdLayout {
  static constexpr int BQ = Shape<NCW>::BQ;
  static constexpr int DP = depth_for(DV);
  // swizzled tiles (hopper.cuh), each 1024-byte aligned; V is DP wide too,
  // its columns past dh zero
  static constexpr size_t q_bytes = BQ * DP * 2;
  static constexpr size_t k_bytes = BK * DP * 2;
  static constexpr size_t k_off = align1024(q_bytes);
  static constexpr size_t v_off = k_off + STAGES * align1024(k_bytes);
  static constexpr size_t bar_off = v_off + STAGES * align1024(k_bytes);
  static constexpr size_t bytes = bar_off + (2 * STAGES + 1) * 8 + 1024;  // + base alignment
};

template <int DV, int NCW, bool TMA>
__global__ void __launch_bounds__(Shape<NCW>::THREADS)
    flash_fwd_sm90_kernel(const __grid_constant__ FwdArgs a) {
  using Lay = FwdLayout<DV, NCW>;
  constexpr int DP = Lay::DP, BQ = Lay::BQ;
  constexpr int CONSUMERS = Shape<NCW>::CONSUMERS;
  using G = Swz<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  auto Ks = [&](int st) {
    return reinterpret_cast<bf16*>(smem + Lay::k_off + st * align1024(Lay::k_bytes));
  };
  auto Vs = [&](int st) {
    return reinterpret_cast<bf16*>(smem + Lay::v_off + st * align1024(Lay::k_bytes));
  };

  const int q_tiles = (a.Nq + BQ - 1) / BQ;
  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x % q_tiles) * BQ;
  const int b = bh / a.H, h = bh % a.H;
  const int n_kt = (a.Nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    const uint32_t loads = TMA ? 1 : CP_ARRIVALS;
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], loads);
      mbar_init(&empty[st], CONSUMERS / 32);  // one arrival a consumer warp
    }
    mbar_init(qbar, loads);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: Q once, then the K/V ring ----
    const int lane = threadIdx.x % 32;
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, Lay::q_bytes);
#pragma unroll
        for (int p = 0; p < G::PANELS; ++p)
          tma_load_4d(Qs + p * BQ * G::PE, &a.mq, qbar, p * G::PE, q0, h, b);
        for (int kt = 0; kt < n_kt; ++kt) {
          const int st = kt % STAGES;
          mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[st], 2 * Lay::k_bytes);
#pragma unroll
          for (int p = 0; p < G::PANELS; ++p) {
            tma_load_4d(Ks(st) + p * BK * G::PE, &a.mk, &full[st], p * G::PE, kt * BK, h, b);
            tma_load_4d(Vs(st) + p * BK * G::PE, &a.mv, &full[st], p * G::PE, kt * BK, h, b);
          }
        }
      }
    } else {
      const bf16* qp = a.q + b * a.s[0] + h * a.s[1];
      const bf16* kp = a.k + b * a.s[3] + h * a.s[4];
      const bf16* vp = a.v + b * a.s[6] + h * a.s[7];
      cp_tile<BQ, DP>(Qs, qp, a.s[2], q0, a.Nq, a.dh, a.piece);
      cp_tile_arrive(qbar);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(&empty[st], ((kt / STAGES) & 1) ^ 1);
        cp_tile<BK, DP>(Ks(st), kp, a.s[5], kt * BK, a.Nk, a.dh, a.piece);
        cp_tile<BK, DP>(Vs(st), vp, a.s[8], kt * BK, a.Nk, a.dh, a.piece);
        cp_tile_arrive(&full[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = lane % 4;
  const float c = a.c;
  // a masked key's logit: -inf after the FFMA whatever the sign of c, and
  // never the row's extreme
  const float mask_val = c >= 0.0f ? -CUDART_INF_F : CUDART_INF_F;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  // rows g and g + 8 of the warp's 16: the raw logit extreme that maximises
  // s * c (the largest logit for c >= 0, the smallest for c < 0), the
  // log2-domain running max m2 = extreme * c, and this thread's share of
  // the row sum
  const bool up = c >= 0.0f;
  float ext[2] = {up ? -CUDART_INF_F : CUDART_INF_F, up ? -CUDART_INF_F : CUDART_INF_F};
  float m2[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};

  mbar_wait(qbar, 0);
  if constexpr (!TMA) fence_proxy_async();

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&full[st], (kt / STAGES) & 1);
    if constexpr (!TMA) fence_proxy_async();

    // S = Q K^T, raw fp32 dot products [64 x 64]
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      wgmma_ss<BK, 0, 0>(s, kmajor_desc<DP, BQ>(Qs, 64 * wg, kd),
                         kmajor_desc<DP, BK>(Ks(st), 0, kd), kd > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);

    if (kt * BK + BK > a.Nk) {  // the last tile: keys >= Nk
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = kt * BK + 8 * (i / 4) + 2 * cq + (i % 2);
        if (key >= a.Nk) s[i] = mask_val;
      }
    }

    // the row extreme over the tile (one compare a score; the branch is
    // uniform), reduced over the quad that holds a row
    float te[2] = {ext[0], ext[1]};
    if (up) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) te[(i / 2) % 2] = fmaxf(te[(i / 2) % 2], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        te[r] = fmaxf(te[r], __shfl_xor_sync(0xffffffffu, te[r], 1));
        te[r] = fmaxf(te[r], __shfl_xor_sync(0xffffffffu, te[r], 2));
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) te[(i / 2) % 2] = fminf(te[(i / 2) % 2], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        te[r] = fminf(te[r], __shfl_xor_sync(0xffffffffu, te[r], 1));
        te[r] = fminf(te[r], __shfl_xor_sync(0xffffffffu, te[r], 2));
      }
    }
    float alpha[2], nm2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ext[r] = te[r];
      nm2[r] = ext[r] * c;
      alpha[r] = ex2(m2[r] - nm2[r]);
      m2[r] = nm2[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // p = 2^(s c - m2): one FFMA and one ex2 a score
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      const float p = ex2(fmaf(s[i], c, -m2[r]));
      l[r] += p;
      s[i] = p;
    }

    // O += bf16(P) V, P straight from the accumulator registers
    uint32_t pf[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) a_fragment<BK>(s, kk, pf[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DV, 1>(o, pf[kk], mnmajor_desc<DP, BK>(Vs(st), kk), 1);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) reg_fence(pf[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // epilogue: the row sums over the quad, o / max(l, 1e-30), lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* ob = a.o + b * a.s[9] + h * a.s[10];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * r;
    if (row >= a.Nq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + static_cast<long long>(row) * a.s[11];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * cq;
      const float v0 = o[4 * j + 2 * r] / denom, v1 = o[4 * j + 2 * r + 1] / denom;
      if (a.o_pairs && col + 1 < a.dh) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (col < a.dh) orow[col] = __float2bfloat16(v0);
        if (col + 1 < a.dh) orow[col + 1] = __float2bfloat16(v1);
      }
    }
    if (a.lse != nullptr && cq == 0) {
      const float m = ext[r] * a.scale;
      a.lse[static_cast<long long>(bh) * a.Nq + row] = m + logf(denom);
    }
  }
}

template <int DV, int NCW, bool TMA>
cudaError_t launch(const FwdArgs& a, int B, cudaStream_t stream) {
  using S = Shape<NCW>;
  constexpr size_t smem = FwdLayout<DV, NCW>::bytes;
  static cudaError_t attr = lam_set_smem(flash_fwd_sm90_kernel<DV, NCW, TMA>, smem);
  if (attr != cudaSuccess) return attr;
  const unsigned grid = static_cast<unsigned>(B) * a.H * ((a.Nq + S::BQ - 1) / S::BQ);
  flash_fwd_sm90_kernel<DV, NCW, TMA><<<grid, S::THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Consumer warpgroups a block for Nq query rows: one (64 rows) for at most
// 64 queries, three (the whole sequence, K and V loaded once a head) for
// 129..192, else two sharing each K/V tile.
int block_warpgroups(int Nq) { return Nq <= 64 ? 1 : (Nq > 128 && Nq <= 192) ? 3 : 2; }

template <int DV, bool TMA>
cudaError_t launch_shape(const FwdArgs& a, int B, cudaStream_t st) {
  switch (block_warpgroups(a.Nq)) {
    case 1: return launch<DV, 1, TMA>(a, B, st);
    case 3: return launch<DV, 3, TMA>(a, B, st);
    default: return launch<DV, 2, TMA>(a, B, st);
  }
}

template <bool TMA>
cudaError_t launch_dv(const FwdArgs& a, int B, cudaStream_t st) {
  switch (width_for(a.dh)) {
    case 16: return launch_shape<16, TMA>(a, B, st);
    case 24: return launch_shape<24, TMA>(a, B, st);
    case 32: return launch_shape<32, TMA>(a, B, st);
    case 64: return launch_shape<64, TMA>(a, B, st);
    default: return launch_shape<128, TMA>(a, B, st);
  }
}

}  // namespace

// q/k/v/o: bf16 [B, H, N, dh] addressed through element strides (batch,
// head, seq), unit stride on dh; lse: null, or fp32 [B, H, Nq] contiguous.
// tma = 1 takes the TMA route (dh % 8 == 0, every base address and every
// stride of an axis longer than 1 a multiple of 8 elements), 0 the
// cp.async route, which takes any dh <= 128 and any alignment. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for inputs it does not take.
extern "C" int lam_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int Nq,
    int Nk, int dh, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn, float scale, int tma, void* stream) {
  if (dh <= 0 || dh > 128 || Nq <= 0 || Nk <= 0 || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{};
  const long long s[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                           v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  for (int i = 0; i < 12; ++i) a.s[i] = s[i];
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.dh = dh;
  a.scale = scale;
  a.c = scale * LOG2E;
  a.o_pairs = (reinterpret_cast<unsigned long long>(o) % 4 == 0) && o_sb % 2 == 0 &&
              o_sh % 2 == 0 && o_sn % 2 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (tma) {
    if (dh % 8) return static_cast<int>(cudaErrorInvalidValue);
    const int dv = width_for(dh), dp = depth_for(dv);
    using lam_sm90_host::encode_tile_map;
    const int bq = 64 * block_warpgroups(Nq);
    if (!encode_tile_map(&a.mq, q, B, H, Nq, dh, q_sb, q_sh, q_sn, bq, dp) ||
        !encode_tile_map(&a.mk, k, B, H, Nk, dh, k_sb, k_sh, k_sn, BK, dp) ||
        !encode_tile_map(&a.mv, v, B, H, Nk, dh, v_sb, v_sh, v_sn, BK, dp))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_dv<true>(a, B, st));
  }
  const void* ptrs[3] = {q, k, v};
  a.piece = lam_sm90_host::copy_piece(ptrs, s, 3, dh);
  return static_cast<int>(launch_dv<false>(a, B, st));
}
