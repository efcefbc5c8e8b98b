// Grouped whole-attention backward for short sequences on Hopper (sm_90a):
// bf16 in / bf16 out on the tensor cores (wgmma) and an fp32 in / fp32 out
// FFMA kernel.
//
// Replaces K11, lam_slide_tpu/ops/ablations/short_backward.py
// `_flash_bwd_short_kernel` (pallas_call in `_flash_backward_short`): the
// backward of unmasked attention over whole short sequences from the
// forward's output, its per-row log-sum-exp and the output gradient. Given
// lse [B, H, Nq] and delta = rowsum(dO * O) [B, H, Nq] (fp32, outside the
// main kernel as JAX computes it outside its pallas_call: a delta kernel in
// bf16, PyTorch in fp32), for each (batch*head) item
//   P = exp(Q K^T * scale - lse),
//   dV = bf16(P)^T dO,   dP = dO V^T,
//   dS = bf16(P * (dP - delta) * scale),   dQ = dS K,   dK = dS^T Q,
// with fp32 accumulation and the JAX kernel's rounding points (P as
// 2^(s * scale * log2(e) - lse * log2(e)), as the flash backward takes it);
// the grads are written in the operands' dtype through (batch, head, seq)
// strides.
//
// bf16 design: a persistent block walks over items (the TPU kernel's
// `group` only sets how its grid pads, so it has no counterpart here). A
// producer warp loads an item whole, Q and dO (Nq rows) and K and V (Nk
// rows), into swizzled tiles (csrc/hopper.cuh: TMA 4-D boxes on the
// head-major views, or the cp.async route where TMA cannot take a view)
// with lse and delta beside them, two items in flight where shared memory
// holds two stages, so the next item's loads overlap this item's math. One
// consumer warpgroup owns each 64 keys (Nk <= 256: up to four) and walks
// the query chunks of 64: S^T = K Q^T and dP^T = V dO^T on wgmma (keys as
// M), P and dS in registers, dV += bf16(P)^T dO and dK += dS^T Q on wgmma
// with P and dS as register A operands, so dK and dV stay in registers for
// the whole item. Each warpgroup writes its keys' block of dS^T once to a
// shared slab (bf16, hopper.cuh's interleave layout) holding the chunk's
// dS for every key; after one named barrier the chunk's owner warpgroup
// (chunk index mod warpgroups) forms dQ for its 64 queries from the slab
// and K. Two slabs alternate, so the next chunk's dS goes in while dQ
// reads this one. S and dP are computed once; no atomics and no bulk
// reductions, each grad summed by one owner in a fixed order, so the grads
// repeat bit for bit (unlike csrc/flash_bwd_sm90.cu's dQ, which is why K11
// stays its own kernel). At the MD17 spatial shape (N = 192, dh 16) an
// item is ~24 KB of tiles and three warpgroups; padding rows are TMA's zero
// fill (query rows past Nq get lse = +inf, so p = 0).
//
// What bounds it on the H100: at N = 192, dh = 16 the item's five products
// are ~1.9 MFLOP against ~37 KB of q/k/v/out/dO/dq/dk/dv in bf16, ~50
// FLOP per byte, far below the card's ~295: device memory bytes, then the
// exponential (one ex2 a score).
//
// fp32 operands (JAX's own K11 tests run in fp32): wgmma takes no fp32
// operands and TF32 would not match, so a second kernel runs FFMA on the
// CUDA cores: the item's fp32 Q, dO, K, V in shared memory, one thread per
// key for dK/dV and one per query for dQ, no atomics. dh <= 32.

#include <math_constants.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int SB_THREADS = 128;  // the fp32 kernel's block
constexpr int MAX_N = 256;

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

// ---- bf16: wgmma over whole items ------------------------------------------

namespace sm90 {

using namespace lam_sm90;

constexpr int BKEY = 64;  // keys a consumer warpgroup
constexpr int BQ = 64;    // queries a chunk: one dS slab, one dQ tile
constexpr size_t SMEM_MAX = 232448;  // the most dynamic shared memory a block takes

// Strides are (batch, head, seq) element strides, in this order of tensors.
enum Tensor { TQ = 0, TK = 3, TV = 6, TO = 9, TG = 12, TDQ = 15, TDK = 18, TDV = 21 };

struct alignas(64) Args {
  CUtensorMap mq, mk, mv, mdo;   // TMA route
  const bf16 *q, *k, *v, *dout;  // cp.async route
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int H, Nq, Nk, dh, items, nqc, nqp, stages, piece, tma, q_pairs, k_pairs, v_pairs;
  long long s[24];
  float scale, c;  // c = scale * log2(e)
};

// Shared memory: `stages` input stages, each Q and dO (nqp rows) and K and
// V (nkp rows) as swizzled tiles of dp columns, 1024-byte aligned, then lse
// and delta (nqp fp32 each); two dS^T slabs of nkp keys by 64 queries
// (bf16, interleave: 8-query groups nkp*16 bytes apart, 16 bytes a key);
// the full and empty barriers of the stages.
struct Layout {
  int dp, nqp, nkp, stages;
  __host__ __device__ size_t qtile() const { return align1024(static_cast<size_t>(nqp) * dp * 2); }
  __host__ __device__ size_t ktile() const { return align1024(static_cast<size_t>(nkp) * dp * 2); }
  __host__ __device__ size_t stats_off() const { return 2 * qtile() + 2 * ktile(); }
  __host__ __device__ size_t stage() const { return align1024(stats_off() + 2 * static_cast<size_t>(nqp) * 4); }
  __host__ __device__ size_t slab() const { return static_cast<size_t>(nkp) * BQ * 2; }
  __host__ __device__ size_t slab_off() const { return stages * stage(); }
  __host__ __device__ size_t bar_off() const { return slab_off() + 2 * slab(); }
  __host__ __device__ size_t bytes() const { return bar_off() + 4 * 8 + 1024; }  // + base alignment
};

// The cp.async route's load of rows [0, rows) of one head into a swizzled
// one-panel tile (DP <= 64), zero outside [0, n) x [0, dh): hopper.cuh's
// cp_tile with a run-time row count, by the producer warp's 32 lanes.
template <int DP>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* src, long long sn, int rows,
                                        int n, int dh, int piece) {
  using G = Swz<DP>;
  static_assert(G::PANELS == 1, "one panel");
  const int lane = threadIdx.x % 32;
  const int per_row = DP * 2 / piece;
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int it = lane; it < rows * per_row; it += 32) {
    const int r = it / per_row, byte = (it % per_row) * piece;
    const int elem = byte / 2, chunk = byte / 16;
    unsigned char* d = base + r * G::W + ((chunk ^ G::swz(r)) * 16) + byte % 16;
    if (r < n && elem < dh) {
      const bf16* s = src + static_cast<long long>(r) * sn + elem;
      if (piece == 2)
        *reinterpret_cast<bf16*>(d) = *s;
      else
        cp_async(d, s, piece);
    } else {
      zero_piece(d, piece);
    }
  }
}

// Rows row0 + [0, 64) of a warpgroup's m64nDV accumulator (element 4j + e
// of thread t: row 16w + g + 8(e/2), column 8j + 2c + e%2), rows < n and
// columns < dh, in bf16 through row stride sn; a column pair as one 4-byte
// store where `pairs` says the addresses allow it. (Sixteen-byte stores
// after a 4x4 transpose across each quad measured slower.)
template <int DV>
__device__ __forceinline__ void write_rows(const float (&acc)[DV / 2], bf16* base, long long sn,
                                           int row0, int n, int dh, int pairs) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, cq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= n) continue;
    bf16* p = base + static_cast<long long>(row) * sn;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * cq, i = 4 * j + 2 * r;
      if (pairs && col + 1 < dh) {
        *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
      } else {
        if (col < dh) p[col] = __float2bfloat16(acc[i]);
        if (col + 1 < dh) p[col + 1] = __float2bfloat16(acc[i + 1]);
      }
    }
  }
}

// delta = rowsum(dO * O) in fp32, outside the main kernel as JAX computes it
// outside its pallas_call: one thread a query row, the exact bf16 products
// summed in order c = 0 .. dh-1, 16-byte loads where `vec` allows.
__global__ void delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                             float* __restrict__ delta, int H, int Nq, int dh, long long o_sb,
                             long long o_sh, long long o_sn, long long d_sb, long long d_sh,
                             long long d_sn, long long rows, int vec) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int r = static_cast<int>(idx % Nq), bh = static_cast<int>(idx / Nq);
  const int b = bh / H, h = bh % H;
  const bf16* o = out + b * o_sb + h * o_sh + r * o_sn;
  const bf16* d = dout + b * d_sb + h * d_sh + r * d_sn;
  float acc = 0.0f;
  if (vec) {
    for (int c = 0; c < dh; c += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + c);
      const uint4 y = *reinterpret_cast<const uint4*>(d + c);
      const bf16* xs = reinterpret_cast<const bf16*>(&x);
      const bf16* ys = reinterpret_cast<const bf16*>(&y);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(ys[e]), __bfloat162float(xs[e]), acc);
    }
  } else {
    for (int c = 0; c < dh; ++c) acc = fmaf(__bfloat162float(d[c]), __bfloat162float(o[c]), acc);
  }
  delta[idx] = acc;
}

template <int DV, int NW>
__global__ void __launch_bounds__(128 * NW + 32, 1)
    short_bwd_sm90_kernel(const __grid_constant__ Args a) {
  constexpr int DP = depth_for(DV);
  constexpr int QS = DV <= 24 ? 64 : 32;  // queries a score block (registers)
  constexpr int NKP = NW * BKEY;          // keys, padded
  const Layout lay{DP, a.nqp, NKP, a.stages};
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte aligned tiles
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off());
  uint64_t* empty = full + 2;
  constexpr int consumers = 128 * NW;
  const size_t qt = lay.qtile(), kt = lay.ktile();

  if (threadIdx.x == 0) {
    for (int st = 0; st < a.stages; ++st) {
      mbar_init(&full[st], a.tma ? CP_ARRIVALS + 1 : CP_ARRIVALS);
      mbar_init(&empty[st], consumers / 32);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= consumers) {
    // ---- producer warp: whole items, `stages` ahead ----
    const int lane = threadIdx.x % 32;
    for (int j = 0, item = blockIdx.x; item < a.items; ++j, item += gridDim.x) {
      const int st = j % a.stages;
      mbar_wait(&empty[st], ((j / a.stages) & 1) ^ 1);
      const int b = item / a.H, h = item % a.H;
      unsigned char* sp = smem + st * lay.stage();
      bf16* Qs = reinterpret_cast<bf16*>(sp);
      bf16* dOs = reinterpret_cast<bf16*>(sp + qt);
      bf16* Ks = reinterpret_cast<bf16*>(sp + 2 * qt);
      bf16* Vs = reinterpret_cast<bf16*>(sp + 2 * qt + kt);
      float* rows = reinterpret_cast<float*>(sp + lay.stats_off());
      if (a.tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], (2 * a.nqp + 2 * NKP) * DP * 2);
          tma_load_4d(Qs, &a.mq, &full[st], 0, 0, h, b);
          tma_load_4d(dOs, &a.mdo, &full[st], 0, 0, h, b);
          tma_load_4d(Ks, &a.mk, &full[st], 0, 0, h, b);
          tma_load_4d(Vs, &a.mv, &full[st], 0, 0, h, b);
        }
      } else {
        cp_rows<DP>(Qs, a.q + b * a.s[TQ] + h * a.s[TQ + 1], a.s[TQ + 2], a.nqp, a.Nq, a.dh,
                    a.piece);
        cp_rows<DP>(dOs, a.dout + b * a.s[TG] + h * a.s[TG + 1], a.s[TG + 2], a.nqp, a.Nq, a.dh,
                    a.piece);
        cp_rows<DP>(Ks, a.k + b * a.s[TK] + h * a.s[TK + 1], a.s[TK + 2], NKP, a.Nk, a.dh,
                    a.piece);
        cp_rows<DP>(Vs, a.v + b * a.s[TV] + h * a.s[TV + 1], a.s[TV + 2], NKP, a.Nk, a.dh,
                    a.piece);
      }
      // lse and delta; padding query rows get lse = +inf (p = 0) and delta 0
      const long long row0 = static_cast<long long>(item) * a.Nq;
      for (int r = lane; r < a.nqp; r += 32) {
        if (r < a.Nq) {
          cp_async(rows + r, a.lse + row0 + r, 4);
          cp_async(rows + a.nqp + r, a.delta + row0 + r, 4);
        } else {
          rows[r] = CUDART_INF_F;
          rows[a.nqp + r] = 0.0f;
        }
      }
      cp_tile_arrive(&full[st]);
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = lane % 4;
  const int key0 = wg * BKEY;
  const float c = a.c, scale = a.scale;
  int seq = 0;  // chunks this block has done: which slab is next
  for (int j = 0, item = blockIdx.x; item < a.items; ++j, item += gridDim.x) {
    const int st = j % a.stages;
    mbar_wait(&full[st], (j / a.stages) & 1);
    if (!a.tma) fence_proxy_async();
    const int b = item / a.H, h = item % a.H;
    unsigned char* sp = smem + st * lay.stage();
    const bf16* Qs = reinterpret_cast<const bf16*>(sp);
    const bf16* dOs = reinterpret_cast<const bf16*>(sp + qt);
    const bf16* Ks = reinterpret_cast<const bf16*>(sp + 2 * qt);
    const bf16* Vs = reinterpret_cast<const bf16*>(sp + 2 * qt + kt);
    const float* lse = reinterpret_cast<const float*>(sp + lay.stats_off());
    const float* delta = lse + a.nqp;

    float dk[DV / 2], dv[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dk[i] = dv[i] = 0.0f;

    for (int qc = 0; qc < a.nqc; ++qc, ++seq) {
      unsigned char* slab = smem + lay.slab_off() + (seq & 1) * lay.slab();
#pragma unroll
      for (int sub = 0; sub < BQ / QS; ++sub) {
        const int q0 = qc * BQ + sub * QS;
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x QS queries each
        float s[QS / 2], dp[QS / 2];
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd)
          wgmma_ss<QS, 0, 0>(s, kmajor_desc<DP, BKEY>(Ks, key0, kd),
                             kmajor_desc<DP, BQ>(Qs, q0, kd), kd > 0);
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd)
          wgmma_ss<QS, 0, 0>(dp, kmajor_desc<DP, BKEY>(Vs, key0, kd),
                             kmajor_desc<DP, BQ>(dOs, q0, kd), kd > 0);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(s);
        reg_fence(dp);

        // P and dS in registers; element i is key row 16w + g + 8((i/2)%2),
        // query q0 + 8(i/4) + 2cq + i%2
#pragma unroll
        for (int i = 0; i < QS / 2; ++i) {
          const int col = q0 + 8 * (i / 4) + 2 * cq + i % 2;
          const float p = ex2(fmaf(s[i], c, -(lse[col] * LOG2E)));
          s[i] = p;
          dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], delta[col])), scale);
        }
        uint32_t pf[QS / 16][4], df[QS / 16][4];
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk) {
          a_fragment<QS>(s, kk, pf[kk]);
          a_fragment<QS>(dp, kk, df[kk]);
        }
        // this block of dS^T into the chunk's slab: key rows as they are,
        // queries in groups of 8
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk)
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int grp = sub * QS / 8 + 2 * kk + m / 2;
            const int row = key0 + 16 * warp + g + 8 * (m % 2);
            *reinterpret_cast<uint32_t*>(slab + grp * NKP * 16 + row * 16 + cq * 4) = df[kk][m];
          }
        fence_proxy_async();

        // dV += P^T dO, dK += dS^T Q (A from registers)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk)
          wgmma_rs<DV, 1>(dv, pf[kk], mnmajor_desc<DP, BQ>(dOs, q0 / 16 + kk), 1);
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk)
          wgmma_rs<DV, 1>(dk, df[kk], mnmajor_desc<DP, BQ>(Qs, q0 / 16 + kk), 1);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(dv);
        reg_fence(dk);
#pragma unroll
        for (int kk = 0; kk < QS / 16; ++kk) {
          reg_fence(pf[kk]);
          reg_fence(df[kk]);
        }
      }
      named_sync(1, consumers);  // the slab holds the chunk's dS for every key
      if (qc % NW == wg) {
        // dQ = dS K over all keys, dS read MN-major from the slab
        float dq[DV / 2];
        const uint64_t ds_mn = make_desc(slab, 128, NKP * 16);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NKP / 16; ++kk)
          wgmma_ss<DV, 1, 1>(dq, ds_mn + (kk * 256 >> 4), mnmajor_desc<DP, BKEY>(Ks, kk),
                             kk > 0);
        wgmma_commit();
        wgmma_wait0();
        reg_fence(dq);
        write_rows<DV>(dq, a.dq + b * a.s[TDQ] + h * a.s[TDQ + 1], a.s[TDQ + 2], qc * BQ, a.Nq,
                       a.dh, a.q_pairs);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
    write_rows<DV>(dk, a.dk + b * a.s[TDK] + h * a.s[TDK + 1], a.s[TDK + 2], key0, a.Nk, a.dh,
                   a.k_pairs);
    write_rows<DV>(dv, a.dv + b * a.s[TDV] + h * a.s[TDV + 1], a.s[TDV + 2], key0, a.Nk, a.dh,
                   a.v_pairs);
  }
}

template <int DV, int NW>
cudaError_t launch(Args& a, cudaStream_t stream) {
  Layout lay{depth_for(DV), a.nqp, NW * BKEY, 2};
  if (lay.bytes() > SMEM_MAX) lay.stages = 1;  // one item at a time
  if (lay.bytes() > SMEM_MAX) return cudaErrorInvalidValue;
  a.stages = lay.stages;
  static cudaError_t attr = lam_set_smem(short_bwd_sm90_kernel<DV, NW>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  constexpr int threads = 128 * NW + 32;
  const int grid =
      lam_persistent_grid(short_bwd_sm90_kernel<DV, NW>, threads, lay.bytes(), a.items);
  short_bwd_sm90_kernel<DV, NW><<<grid, threads, lay.bytes(), stream>>>(a);
  return cudaGetLastError();
}

// One instantiation per consumer warpgroup count: Nk rounded up to 64.
template <int DV>
cudaError_t launch_nw(Args& a, int nw, cudaStream_t stream) {
  switch (nw) {
    case 1: return launch<DV, 1>(a, stream);
    case 2: return launch<DV, 2>(a, stream);
    case 3: return launch<DV, 3>(a, stream);
    default: return launch<DV, 4>(a, stream);
  }
}

bool pairs_ok(const void* p, const long long* s) {
  return reinterpret_cast<unsigned long long>(p) % 4 == 0 && s[0] % 2 == 0 && s[1] % 2 == 0 &&
         s[2] % 2 == 0;
}

}  // namespace sm90

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

// q/k/v/out/g (g = dO, in q's dtype) and dq/dk/dv: bf16 [B, H, N, dh]
// addressed through element strides (batch, head, seq), 24 of them in the
// order q, k, v, out, g, dq, dk, dv; unit stride on dh. lse: fp32 [B, H, Nq]
// contiguous, the forward's; delta: fp32 [B, H, Nq], written here first
// (rowsum(g * out)). Nq, Nk <= 256, dh <= 64. tma: 1 to load q, k, v and g
// by TMA (dh a multiple of 8, 16-byte aligned bases and strides:
// ops.flash_attention's sm90_tma_ok), 0 for the cp.async route. Launches
// the delta kernel and the main kernel on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_short_backward(const void* q, const void* k, const void* v, const void* out,
                                  const void* g, const void* lse, void* delta, void* dq,
                                  void* dk, void* dv, int B, int H, int Nq, int Nk, int dh,
                                  const long long* strides, float scale, int tma,
                                  void* stream) {
  if (dh <= 0 || dh > 64 || Nq <= 0 || Nk <= 0 || Nq > MAX_N || Nk > MAX_N || B <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using namespace sm90;
  const long long* s = strides;
  auto st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * Nq;
  const void* od[2] = {out, g};
  const long long ods[6] = {s[TO], s[TO + 1], s[TO + 2], s[TG], s[TG + 1], s[TG + 2]};
  const int vec = dh % 8 == 0 && lam_sm90_host::copy_piece(od, ods, 2, dh) == 16;
  delta_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(g), static_cast<float*>(delta), H,
      Nq, dh, s[TO], s[TO + 1], s[TO + 2], s[TG], s[TG + 1], s[TG + 2], rows, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Args a{};
  for (int i = 0; i < 24; ++i) a.s[i] = s[i];
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(g);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.dh = dh;
  a.items = B * H;
  a.nqc = (Nq + BQ - 1) / BQ;
  a.nqp = a.nqc * BQ;
  a.tma = tma;
  a.q_pairs = pairs_ok(dq, s + TDQ);
  a.k_pairs = pairs_ok(dk, s + TDK);
  a.v_pairs = pairs_ok(dv, s + TDV);
  a.scale = scale;
  a.c = scale * LOG2E;
  const int nw = (Nk + BKEY - 1) / BKEY;
  const int dvw = width_for(dh), dpw = depth_for(dvw);
  if (tma) {
    if (dh % 8) return static_cast<int>(cudaErrorInvalidValue);
    using lam_sm90_host::encode_tile_map;
    if (!encode_tile_map(&a.mq, q, B, H, Nq, dh, s[TQ], s[TQ + 1], s[TQ + 2], a.nqp, dpw) ||
        !encode_tile_map(&a.mdo, g, B, H, Nq, dh, s[TG], s[TG + 1], s[TG + 2], a.nqp, dpw) ||
        !encode_tile_map(&a.mk, k, B, H, Nk, dh, s[TK], s[TK + 1], s[TK + 2], nw * BKEY, dpw) ||
        !encode_tile_map(&a.mv, v, B, H, Nk, dh, s[TV], s[TV + 1], s[TV + 2], nw * BKEY, dpw))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const void* ptrs[4] = {q, k, v, g};
    const long long ps[12] = {s[TQ], s[TQ + 1], s[TQ + 2], s[TK], s[TK + 1], s[TK + 2],
                              s[TV], s[TV + 1], s[TV + 2], s[TG], s[TG + 1], s[TG + 2]};
    a.piece = lam_sm90_host::copy_piece(ptrs, ps, 4, dh);
  }
  switch (dvw) {
    case 16: err = launch_nw<16>(a, nw, st); break;
    case 24: err = launch_nw<24>(a, nw, st); break;
    case 32: err = launch_nw<32>(a, nw, st); break;
    default: err = launch_nw<64>(a, nw, st); break;
  }
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
