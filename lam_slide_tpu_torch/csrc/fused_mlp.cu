// Fused MLP branch for Hopper (sm_90a): out = gelu(x @ w1 + b1) @ w2, fp32 out.
//
// Replaces the Pallas TPU kernel lam_slide_tpu/ops/fused_mlp.py `_mlp_kernel`
// (pallas_call in `_fused_mlp_vjp`), the parallel-MLP branch of every DiT
// block (models/latent_dit.py:216-218). As on the TPU, the [rows, d_mid]
// gelu intermediate never reaches device memory.
//
// What bounds it on the H100: 4 * d_in * d_mid FLOPs a row (d_in = d_out)
// against 2 * d_in bytes of x and 4 * d_out of fp32 output. At the MD17 DiT
// ([1843200, 256] -> 512 -> 256) that is 966 GFLOP (0.98 ms at 989 TFLOP/s)
// against 2.83 GB (0.85 ms at 3.35 TB/s): both bounds nearly meet, so the
// tensor cores, the loads and the stores must all overlap.
//
// Two routes of one entry point each; the wrapper (ops/fused_mlp.py,
// `sm90_plan`) picks one:
//
// 1. `lam_fused_mlp_sm90`, the main route (d_in up to 448, any d_mid and
//    d_out). It has the structure of the flash forward with x in Q's place,
//    a w1 panel in K's, a w2 panel in V's and exact GELU in the softmax's,
//    without running statistics:
//    - a persistent grid, one block an SM, walking 128-row x tiles; two
//      consumer warpgroups of 64 rows each and a producer warpgroup, one
//      warp of which loads (setmaxnreg moves registers from the producers
//      to the consumers, 40 and 232 a thread);
//    - the producer loads by TMA the x tile (once a tile, every 64-column
//      panel in 128-byte swizzle) and, for each NC-wide chunk of d_mid, the
//      w1 panel [NC x d_in] into a ring of S1 stages and the w2 panel
//      [NO x NC] into a ring of two, each ring with its own full/empty
//      mbarriers, so a w1 slot frees as soon as GEMM1 has read it and the
//      producer keeps the w1 ring one chunk ahead of the w2 ring. All
//      blocks read the same weights, which stay in the 50 MB L2; an x view
//      TMA refuses (alignment) is copied by the producer warp with cp.async
//      into the same swizzled panels, the kernel's second load route;
//    - a consumer warpgroup runs, per chunk: GEMM1 as wgmma SS (x and the
//      w1 panel K-major from shared memory) into a 64 x NC fp32 accumulator;
//      then mid = bf16(acc + b1) and its GELU, rounded to bf16, into a
//      swizzled GELU tile of its own in shared memory (two alternate), and
//      GEMM2 as wgmma SS from that tile against the w2 panel into the fp32
//      64 x NO output accumulator. GEMM1 of chunk c+1 and GEMM2 of chunk c
//      are in flight together while the GELU of chunk c+1 runs on the CUDA
//      cores.
//      The GELU of a bf16 mid is read from a 6 KB table (gelu_table.cuh,
//      the same fp32 formula, built first on the same stream) with closed
//      forms outside it: the exact GELU with erff on the CUDA cores, not
//      the products, bounded the kernel (ablations in PERF.md);
//    - the epilogue stores the accumulator from registers (8-byte
//      streaming stores, whole 32-byte sectors), while the producer already
//      loads the next tile, whose x slot freed after the tile's last GEMM1.
//    Widths: d_in padded to 64-column panels in shared memory only (TMA's
//    zero fill); the output in passes of NO <= 256 columns (a 64 x 256 fp32
//    accumulator is 128 registers a thread), e.g. two passes of 192 at
//    d_out 384; NC = 64, or 32 where the shared memory of 64 does not fit
//    (d_in 384). No atomics: every output element is summed by one thread
//    in a fixed order, so a result repeats bit for bit.
// 2. `lam_fused_mlp_wmma`, the first port's kernel, kept as an explicit
//    route (its own counter in the wrapper) for the widths the main route's
//    shared memory cannot hold: one block (8 warps) = 32 rows of x, WMMA
//    (mma.sync) GEMMs with B fragments read from L2, the bf16 gelu
//    intermediate in shared memory.
//
// Numerics (both routes, `reference_mlp`): bf16 operands, fp32
// accumulation, mid = bf16(x @ w1 + b1), exact GELU in fp32,
// 0.5 mid (1 + erff(mid / sqrt 2)), rounded to bf16, fp32 output. The JAX
// kernel's polynomial erf exists only because Mosaic has none; these kernels
// use the real erff (the Hopper route through its table, bit for bit).

#include <mma.h>

#include "common.cuh"
#include "gelu_table.cuh"
#include "hopper.cuh"

namespace {

// ---- route 1: TMA + wgmma ------------------------------------------------------

namespace sm90 {

using namespace lam_sm90;

constexpr int NWG = 2;            // consumer warpgroups, 64 rows each
constexpr int BM = 64 * NWG;      // rows a tile
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup (one warp loads)
// Registers a thread after setmaxnreg (the block launches at 168: 65,536 /
// 384 threads rounded down to 8): the producer warpgroup gives up to 40 so
// the consumers can hold the 64 x 256 fp32 output accumulator and GEMM1's
// 64 x NC one (128 + 32 at NO 256, NC 64) with room for the GELU's
// temporaries; at 168 the first build spilled 884 bytes.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PANEL = 64;         // bf16 columns of one 128-byte swizzle panel
constexpr int MAX_S1 = 4;         // w1 ring stages
constexpr int S2 = 2;             // w2 ring stages
constexpr size_t SMEM_MAX = 232448;

struct alignas(64) Args {
  CUtensorMap mx, mw1, mw2;
  const bf16* x;  // the cp.async route's x
  const bf16* b1;
  float* out;
  long long x_sr, out_sr;
  int R, din, dmid, dout, kp, nch, passes, s1, tiles, x_tma, x_piece, b1_pairs;
  uint32_t x_bytes, w1_bytes, w2_bytes;  // one tile of each in shared memory
  const unsigned short* table;           // the GELU table (gelu_table_kernel)
};

// Shared memory of a block (ops/fused_mlp.py's sm90_smem_bytes mirrors it):
// the x tile (BM rows of kp 128-byte panels), s1 w1 panels (nc rows of kp
// panels), two w2 panels (no rows of nc bf16), two GELU tiles a consumer
// warpgroup (64 rows of nc bf16), the mbarriers and the slack that aligns
// the base to 1024 bytes.
inline size_t smem_bytes(int kp, int nc, int no, int s1) {
  return static_cast<size_t>(BM) * kp * 128 + static_cast<size_t>(s1) * nc * kp * 128 +
         static_cast<size_t>(S2) * no * nc * 2 + static_cast<size_t>(2 * NWG) * 64 * nc * 2 +
         128 + 1024;
}

// GEMM1 of one chunk: s = x[64 rows of warpgroup wg] @ w1_panel^T over kp
// panels of four k16 steps (zero columns past d_in add nothing), committed.
// The descriptors of a step are the first step's plus the step's byte
// offset over 16 (the 14-bit address field never carries: shared memory is
// below 256 KB), so an issue costs two integer adds.
template <int NC>
__device__ __forceinline__ void gemm1(float (&s)[NC / 2], const bf16* xs, const bf16* w1, int wg,
                                      int kp) {
  const uint64_t dx = kmajor_desc<128, BM>(xs, 64 * wg, 0), dw = kmajor_desc<128, NC>(w1, 0, 0);
  wgmma_fence();
#pragma unroll 1
  for (int p = 0; p < kp; ++p) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<NC, 0, 0>(s, dx + p * (BM * 128 / 16) + 2 * kk, dw + p * (NC * 128 / 16) + 2 * kk,
                         p + kk > 0);
  }
  wgmma_commit();
}

// b1 of the chunk's columns this thread's accumulator holds, as bf16 pairs
// (column 8j + 2cq and the next in bb[j]; zero past d_mid), read where
// their latency hides behind a wgmma: as pairs where b1 is 4-byte aligned.
template <int NC>
__device__ __forceinline__ void load_bias(const Args& a, int col0, uint32_t (&bb)[NC / 8]) {
  const int cq = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = col0 + 8 * j + 2 * cq;
    bb[j] = 0u;
    if (col < a.dmid) {
      if (a.b1_pairs) {
        bb[j] = __ldg(reinterpret_cast<const unsigned int*>(a.b1 + col));
      } else {
        const unsigned short* b = reinterpret_cast<const unsigned short*>(a.b1 + col);
        bb[j] = static_cast<uint32_t>(__ldg(b)) | (static_cast<uint32_t>(__ldg(b + 1)) << 16);
      }
    }
  }
}

// mid = bf16(s + b1), gelu(mid) = 0.5 mid (1 + erf(mid / sqrt 2)) in fp32,
// rounded to bf16 into the warpgroup's GELU tile (64 rows by NC, K-major in
// the NC-wide swizzle of hopper.cuh), GEMM2's A operand. Accumulator element
// 4j + e of thread (warp w, g, cq) is row 16w + g + 8(e/2), column
// 8j + 2cq + e%2 of the chunk: a 4-byte pair in 16-byte chunk j of its row,
// so the warp's 32 stores of one j fall in 32 banks. The tile is then
// fenced for the async proxy and the warpgroup synchronised (named barrier
// 1 + wg) before GEMM2.
template <int NC>
__device__ __forceinline__ void gelu_tile(const float (&s)[NC / 2], const uint32_t (&bb)[NC / 8],
                                          const unsigned short* table, bf16* tile, int wg) {
  using G = Swz<NC>;
  const int cq = threadIdx.x % 4, g = (threadIdx.x % 32) / 4, warp = (threadIdx.x % 128) / 32;
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const float bias[2] = {__uint_as_float(bb[j] << 16), __uint_as_float(bb[j] & 0xffff0000u)};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {  // row g + 8rr: elements 4j + 2rr + q, column pair q
      uint32_t looked = 0u, keep = 0u;
      float val[2];  // the closed forms outside the table
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(s[4 * j + 2 * rr + q] + bias[q]));
        const uint32_t k = (h & 0x7fffu) - GELU_LO;
        const bool in = k < GELU_SPAN;
        looked |= static_cast<uint32_t>(__ldg(table + (in ? k + (h >> 15) * GELU_SPAN : 0u)))
                  << (16 * q);
        keep |= in ? 0xffffu << (16 * q) : 0u;
        const float mid = __uint_as_float(h << 16);
        val[q] = 0.5f * mid * ((h & 0x7fffu) < GELU_LO ? 1.0f : 1.0f + copysignf(1.0f, mid));
      }
      const int row = 16 * warp + g + 8 * rr;
      *reinterpret_cast<uint32_t*>(base + row * G::W + (j ^ G::swz(row)) * 16 + 4 * cq) =
          (looked & keep) | (pack_bf16(val[0], val[1]) & ~keep);
    }
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
}

template <int R>
__device__ __forceinline__ void regs_down() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_up() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// One arrival of this warp on `bar` (the barriers count consumer warps).
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

struct Smem {
  bf16* xs;
  unsigned char* w1;   // s1 panels of w1_bytes
  unsigned char* w2;   // S2 panels of w2_bytes
  unsigned char* mid;  // 2 GELU tiles a consumer warpgroup, mid_bytes each
  uint32_t mid_bytes;
  uint64_t *full1, *empty1, *full2, *empty2, *xfull, *xempty;
  // the GELU tile of the block's chunk u for warpgroup wg (two alternate)
  __device__ bf16* gelu(int wg, int u) const {
    return reinterpret_cast<bf16*>(mid + (2 * wg + (u & 1)) * mid_bytes);
  }
};

// GEMM2 of one chunk: o += gelu tile @ w2_panel^T, one m64nNOk16 product a
// k16 step with both operands K-major in shared memory, committed. (With
// the GELU as register A fragments, an RS product, the GELU of the next
// chunk did not overlap it: 3.47 ms at MD17 against 1.60 without the GELU.)
template <int NC, int NO>
__device__ __forceinline__ void gemm2(float (&o)[NO / 2], const bf16* mid, const bf16* w2) {
  const uint64_t dm = kmajor_desc<NC, 64>(mid, 0, 0), dw = kmajor_desc<NC, NO>(w2, 0, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) wgmma_ss<NO, 0, 0>(o, dm + 2 * kk, dw + 2 * kk, 1);
  wgmma_commit();
}

// Chunk c of a pass whose first chunk is the block's chunk u0, the GELU of
// chunk c in its tile, chunk c+1 to come: GEMM1 of chunk c+1 and GEMM2 of
// chunk c in flight together, the GELU of chunk c+1 into the other tile
// while GEMM2 runs. Every group is retired before it returns, so ptxas sees
// no wgmma in flight across a branch. release_x: chunk c+1 is the tile's
// last GEMM1, after which the x slot is free.
template <int NC, int NO>
__device__ __forceinline__ void chunk_next(const Args& a, const Smem& sm, int u0, int c, int wg,
                                           bool release_x, float (&o)[NO / 2],
                                           float (&s)[NC / 2]) {
  const int u = u0 + c;
  const int st1 = (u + 1) % a.s1, st2 = u % S2;
  mbar_wait(&sm.full1[st1], ((u + 1) / a.s1) & 1);
  mbar_wait(&sm.full2[st2], (u / S2) & 1);
  gemm1<NC>(s, sm.xs, reinterpret_cast<const bf16*>(sm.w1 + st1 * a.w1_bytes), wg, a.kp);
  gemm2<NC, NO>(o, sm.gelu(wg, u), reinterpret_cast<const bf16*>(sm.w2 + st2 * a.w2_bytes));
  uint32_t bb[NC / 8];
  load_bias<NC>(a, (c + 1) * NC, bb);
  wgmma_wait1();  // GEMM1 of chunk c+1 is done; GEMM2 of chunk c may still run
  reg_fence(s);
  warp_arrive(&sm.empty1[st1]);
  if (release_x) warp_arrive(sm.xempty);
  gelu_tile<NC>(s, bb, a.table, sm.gelu(wg, u + 1), wg);
  wgmma_wait0();
  reg_fence(o);
  warp_arrive(&sm.empty2[st2]);
}

// The pass's last chunk c: GEMM2 alone.
template <int NC, int NO>
__device__ __forceinline__ void chunk_last(const Args& a, const Smem& sm, int u0, int c, int wg,
                                           float (&o)[NO / 2]) {
  const int u = u0 + c, st2 = u % S2;
  mbar_wait(&sm.full2[st2], (u / S2) & 1);
  gemm2<NC, NO>(o, sm.gelu(wg, u), reinterpret_cast<const bf16*>(sm.w2 + st2 * a.w2_bytes));
  wgmma_wait0();
  reg_fence(o);
  warp_arrive(&sm.empty2[st2]);
}

template <int NC, int NO>
__global__ void __launch_bounds__(THREADS, 1) mlp_sm90_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  Smem sm;
  sm.xs = reinterpret_cast<bf16*>(base);
  sm.w1 = base + a.x_bytes;
  sm.w2 = sm.w1 + a.s1 * a.w1_bytes;
  sm.mid = sm.w2 + S2 * a.w2_bytes;
  sm.mid_bytes = 64 * NC * 2;
  sm.full1 = reinterpret_cast<uint64_t*>(sm.mid + 2 * NWG * sm.mid_bytes);
  sm.empty1 = sm.full1 + MAX_S1;
  sm.full2 = sm.empty1 + MAX_S1;
  sm.empty2 = sm.full2 + S2;
  sm.xfull = sm.empty2 + S2;
  sm.xempty = sm.xfull + 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < a.s1; ++st) {
      mbar_init(&sm.full1[st], 1);
      mbar_init(&sm.empty1[st], CONSUMERS / 32);  // one arrival a consumer warp
    }
    for (int st = 0; st < S2; ++st) {
      mbar_init(&sm.full2[st], 1);
      mbar_init(&sm.empty2[st], CONSUMERS / 32);
    }
    mbar_init(sm.xfull, a.x_tma ? 1 : CP_ARRIVALS);
    mbar_init(sm.xempty, CONSUMERS / 32);
    mbar_init_fence();
  }
  __syncthreads();

  const int per_tile = a.passes * a.nch;  // chunks a tile
  const int my_tiles = (a.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup, whose first warp walks the block's chunk
    // sequence u = (tile, pass, chunk): w1 of chunk u+1 issued before w2 of
    // chunk u, each tile's x before its first w1 ----
    regs_down<PRODUCER_REGS>();
    if (threadIdx.x >= CONSUMERS + 32) return;
    const int lane = threadIdx.x % 32;
    const uint32_t w1_tx = a.w1_bytes, w2_tx = a.w2_bytes;
    auto load_w1 = [&](int u) {
      const int i = u / per_tile, c = (u % per_tile) % a.nch;
      if (u % per_tile == 0) {
        const int t = blockIdx.x + i * gridDim.x;
        mbar_wait(sm.xempty, (i & 1) ^ 1);
        if (a.x_tma) {
          if (lane == 0) {
            mbar_arrive_expect_tx(sm.xfull, a.x_bytes);
            for (int p = 0; p < a.kp; ++p)
              tma_load_4d(sm.xs + p * BM * PANEL, &a.mx, sm.xfull, p * PANEL, t * BM, 0, 0);
          }
        } else {
          for (int p = 0; p < a.kp; ++p)
            cp_tile<BM, PANEL>(sm.xs + p * BM * PANEL, a.x + p * PANEL, a.x_sr, t * BM, a.R,
                               min(PANEL, a.din - p * PANEL), a.x_piece);
          cp_tile_arrive(sm.xfull);
        }
      }
      const int st = u % a.s1;
      mbar_wait(&sm.empty1[st], ((u / a.s1) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full1[st], w1_tx);
        bf16* dst = reinterpret_cast<bf16*>(sm.w1 + st * a.w1_bytes);
        for (int p = 0; p < a.kp; ++p)
          tma_load_4d(dst + p * NC * PANEL, &a.mw1, &sm.full1[st], p * PANEL, c * NC, 0, 0);
      }
    };
    auto load_w2 = [&](int u) {
      const int j = (u % per_tile) / a.nch, c = (u % per_tile) % a.nch;
      const int st = u % S2;
      mbar_wait(&sm.empty2[st], ((u / S2) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.full2[st], w2_tx);
        tma_load_4d(sm.w2 + st * a.w2_bytes, &a.mw2, &sm.full2[st], c * NC, j * NO, 0, 0);
      }
    };
    const int chunks = my_tiles * per_tile;
    if (chunks > 0) load_w1(0);
    for (int u = 0; u < chunks; ++u) {
      if (u + 1 < chunks) load_w1(u + 1);
      load_w2(u);
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows of the tile each ----
  regs_up<CONSUMER_REGS>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = lane % 4;
  for (int i = 0; i < my_tiles; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    mbar_wait(sm.xfull, i & 1);
    if (!a.x_tma) fence_proxy_async();
    for (int j = 0; j < a.passes; ++j) {
      const int u0 = (i * a.passes + j) * a.nch;
      const bool last_pass = j + 1 == a.passes;
      float o[NO / 2];
#pragma unroll
      for (int e = 0; e < NO / 2; ++e) o[e] = 0.0f;
      float s[NC / 2];
      {  // GEMM1 and GELU of chunk 0
        const int st1 = u0 % a.s1;
        mbar_wait(&sm.full1[st1], (u0 / a.s1) & 1);
        gemm1<NC>(s, sm.xs, reinterpret_cast<const bf16*>(sm.w1 + st1 * a.w1_bytes), wg, a.kp);
        uint32_t bb[NC / 8];
        load_bias<NC>(a, 0, bb);
        wgmma_wait0();
        reg_fence(s);
        warp_arrive(&sm.empty1[st1]);
        if (last_pass && a.nch == 1) warp_arrive(sm.xempty);
        gelu_tile<NC>(s, bb, a.table, sm.gelu(wg, u0), wg);
      }
      for (int c = 0; c + 1 < a.nch; ++c)
        chunk_next<NC, NO>(a, sm, u0, c, wg, last_pass && c + 2 == a.nch, o, s);
      chunk_last<NC, NO>(a, sm, u0, a.nch - 1, wg, o);
      // epilogue: rows g and g + 8 of each warp's 16, column pairs, fp32
      const long long row0 = static_cast<long long>(t) * BM + 64 * wg + 16 * warp + g;
#pragma unroll
      for (int jj = 0; jj < NO / 8; ++jj) {
        const int col = j * NO + 8 * jj + 2 * cq;
        if (col >= a.dout) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long row = row0 + 8 * r;
          if (row < a.R)
            __stcs(reinterpret_cast<float2*>(a.out + row * a.out_sr + col),
                   make_float2(o[4 * jj + 2 * r], o[4 * jj + 2 * r + 1]));
        }
      }
    }
  }
}

template <int NC, int NO>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  static cudaError_t attr = lam_set_smem(mlp_sm90_kernel<NC, NO>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const int grid = lam_persistent_grid(mlp_sm90_kernel<NC, NO>, THREADS, smem, a.tiles);
  mlp_sm90_kernel<NC, NO><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_no(const Args& a, int no, size_t smem, cudaStream_t stream) {
  switch (no) {
    case 64: return launch<NC, 64>(a, smem, stream);
    case 128: return launch<NC, 128>(a, smem, stream);
    case 192: return launch<NC, 192>(a, smem, stream);
    default: return launch<NC, 256>(a, smem, stream);
  }
}

}  // namespace sm90

// ---- route 2: WMMA, 32 rows a block -------------------------------------------

namespace wmma_route {

using namespace nvcuda;

constexpr int BR = 32;  // rows per block
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int LDC = 16 + 4;  // per-warp fp32 scratch row stride

struct Layout {
  int ldx, ldm;
  size_t x_off, m_off, c_off, bytes;
  __host__ __device__ Layout(int din, int dmid) {
    ldx = din + 8;
    ldm = dmid + 8;
    x_off = 0;
    m_off = lam_align128(x_off + BR * ldx * sizeof(bf16));
    c_off = lam_align128(m_off + BR * ldm * sizeof(bf16));
    bytes = lam_align128(c_off + NWARPS * 16 * LDC * sizeof(float));
  }
};

__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                 float* __restrict__ out, int R, int Din, int Dmid, int Dout,
                 long long x_sr, long long w1_ld, long long w2_ld, long long out_sr) {
  const Layout lay(Din, Dmid);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + lay.x_off);
  bf16* Ms = reinterpret_cast<bf16*>(smem + lay.m_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Cs = reinterpret_cast<float*>(smem + lay.c_off) + warp * 16 * LDC;
  const int r0 = blockIdx.x * BR;

  for (int idx = threadIdx.x; idx < BR * Din; idx += THREADS) {
    const int rr = idx / Din, c = idx % Din;
    bf16 val = __float2bfloat16(0.0f);
    if (r0 + rr < R) val = x[static_cast<long long>(r0 + rr) * x_sr + c];
    Xs[rr * lay.ldx + c] = val;
  }
  __syncthreads();

  // phase 1: Ms = bf16(gelu(bf16(x @ w1 + b1)))
  const int n_mid = (BR / 16) * (Dmid / 16);
  for (int f = warp; f < n_mid; f += NWARPS) {
    const int rf = f % (BR / 16), cf = f / (BR / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < Din; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, Xs + rf * 16 * lay.ldx + k0, lay.ldx);
      wmma::load_matrix_sync(bw, w1 + cf * 16 * w1_ld + k0, static_cast<unsigned>(w1_ld));
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(Cs, acc, LDC, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = e / 16, cc = e % 16, n = cf * 16 + cc;
      const float mid = __bfloat162float(
          __float2bfloat16(Cs[rr * LDC + cc] + __bfloat162float(b1[n])));
      const float g = 0.5f * mid * (1.0f + erff(mid * 0.70710678118654752f));
      Ms[(rf * 16 + rr) * lay.ldm + n] = __float2bfloat16(g);
    }
    __syncwarp();
  }
  __syncthreads();

  // phase 2: out = Ms @ w2, fp32
  const int n_out = (BR / 16) * (Dout / 16);
  for (int f = warp; f < n_out; f += NWARPS) {
    const int rf = f % (BR / 16), cf = f / (BR / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < Dmid; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(a, Ms + rf * 16 * lay.ldm + k0, lay.ldm);
      wmma::load_matrix_sync(bw, w2 + cf * 16 * w2_ld + k0, static_cast<unsigned>(w2_ld));
      wmma::mma_sync(acc, a, bw, acc);
    }
    wmma::store_matrix_sync(Cs, acc, LDC, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int rr = e / 16, cc = e % 16, row = r0 + rf * 16 + rr;
      if (row < R) out[static_cast<long long>(row) * out_sr + cf * 16 + cc] = Cs[rr * LDC + cc];
    }
    __syncwarp();
  }
}

}  // namespace wmma_route

bool bad_dims(int R, int Din, int Dmid, int Dout) {
  return R <= 0 || Din <= 0 || Dmid <= 0 || Dout <= 0 || Din % 16 || Dmid % 16 || Dout % 16;
}

}  // namespace

// x: bf16 [R, Din] with row stride x_sr (unit stride on Din); w1: bf16
// [Dmid, Din] rows with row stride w1_ld (nn.Linear layout of the MLP-up
// slice); b1: bf16 [Dmid]; w2: bf16 [Dout, Dmid] rows with row stride w2_ld
// (the MLP-down slice); out: fp32 [R, Dout] with row stride out_sr (even,
// 8-byte aligned). Din, Dmid, Dout multiples of 16; w1/w2 16-byte aligned
// with strides that are multiples of 8. The plan (ops/fused_mlp.py
// sm90_plan): nc (32 or 64) columns of d_mid a chunk, no (64, 128, 192 or
// 256) output columns a pass, s1 (2..4) w1 stages. x_tma = 1 loads x by TMA
// (16-byte aligned base and row stride), 0 by cp.async. table: scratch for
// the GELU table (GELU_ENTRIES bf16), filled by a small kernel first on the
// same stream. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// what it does not take.
extern "C" int lam_fused_mlp_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                                  void* out, void* table, int R, int Din, int Dmid, int Dout,
                                  long long x_sr, long long w1_ld, long long w2_ld,
                                  long long out_sr, int nc, int no, int s1, int x_tma,
                                  void* stream) {
  using namespace sm90;
  if (bad_dims(R, Din, Dmid, Dout) || (nc != 32 && nc != 64) || no % 64 || no < 64 ||
      no > 256 || s1 < 2 || s1 > MAX_S1 || out_sr % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.b1 = static_cast<const bf16*>(b1);
  a.out = static_cast<float*>(out);
  a.x_sr = x_sr;
  a.out_sr = out_sr;
  a.R = R;
  a.din = Din;
  a.dmid = Dmid;
  a.dout = Dout;
  a.kp = (Din + PANEL - 1) / PANEL;
  a.nch = (Dmid + nc - 1) / nc;
  a.passes = (Dout + no - 1) / no;
  a.s1 = s1;
  a.tiles = (R + BM - 1) / BM;
  a.x_tma = x_tma;
  a.b1_pairs = reinterpret_cast<unsigned long long>(b1) % 4 == 0;
  a.table = static_cast<const unsigned short*>(table);
  a.x_bytes = static_cast<uint32_t>(BM) * a.kp * 128;
  a.w1_bytes = static_cast<uint32_t>(nc) * a.kp * 128;
  a.w2_bytes = static_cast<uint32_t>(no) * nc * 2;
  const size_t smem = smem_bytes(a.kp, nc, no, s1);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  using lam_sm90_host::encode_tile_map;
  // 2-D maps as the 4-D map of hopper.cuh with unit batch and head axes;
  // boxes of one 128-byte panel (x, w1) or one nc-wide panel (w2)
  if (!encode_tile_map(&a.mw1, w1, 1, 1, Dmid, Din, 0, 0, w1_ld, nc, PANEL) ||
      !encode_tile_map(&a.mw2, w2, 1, 1, Dout, Dmid, 0, 0, w2_ld, no, nc))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_tma) {
    if (!encode_tile_map(&a.mx, x, 1, 1, R, Din, 0, 0, x_sr, BM, PANEL))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const long long s[3] = {0, 0, x_sr};
    a.x_piece = lam_sm90_host::copy_piece(&x, s, 1, Din);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fill_gelu_table(static_cast<unsigned short*>(table), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = nc == 64 ? launch_no<64>(a, no, smem, st) : launch_no<32>(a, no, smem, st);
  return static_cast<int>(err);
}

// The WMMA route: the same operands and layouts (w1/w2 32-byte aligned).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it does not
// take (including widths whose shared memory exceeds the block's).
extern "C" int lam_fused_mlp_wmma(const void* x, const void* w1, const void* b1, const void* w2,
                                  void* out, int R, int Din, int Dmid, int Dout, long long x_sr,
                                  long long w1_ld, long long w2_ld, long long out_sr,
                                  void* stream) {
  using namespace wmma_route;
  if (bad_dims(R, Din, Dmid, Dout)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(Din, Dmid);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + BR - 1) / BR);
  fused_mlp_kernel<<<grid, THREADS, lay.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<float*>(out), R, Din, Dmid, Dout, x_sr, w1_ld, w2_ld, out_sr);
  return static_cast<int>(cudaGetLastError());
}
