// The DiT's whole small-L spatial block redesigned for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel lam_slide_tpu/ops/fused_spatial_block.py
// `_kernel` (pallas_call in `_fused_vjp`) at the widths the models run
// (ops/fused_spatial_block.py `sm90_plan`); fused_spatial_block.cu keeps the
// first port's WMMA kernel for the widths this one does not take. Over the
// L <= 8 positions of each frame:
//
//   xw   = bf16(bf16(x @ w1^T) + b1)                      [rows, 3D + M]
//   q, k = RoPE(RMSNorm_head(q or k)) at the frame's L positions
//   attn = softmax(q k^T * scale) v per head, over the L positions
//   out  = bf16(bf16([attn | gelu(mlp)] @ w2^T) + b2)      [rows, D]
//
// Under tensor parallelism (parallel/tp.py) a rank holds whole heads and a
// slice of the MLP: q, k and v of Da = (H / tp) * dh columns and Mr = M / tp
// MLP columns, so linear1 is [3 Da + Mr, D] and linear2 [D, Da + Mr]; the
// input and output stay D wide. With `partial` set the kernel stores the
// fp32 sum [attn | gelu(mlp)] @ w2^T itself, unrounded and without b2: the
// model group adds the ranks' partials, then rounds once and adds b2, the
// rounding points of the whole block. At Da = D without `partial` it is
// the whole block, the same instructions as before the parameter existed.
//
// What bounds it on the H100: 2 * rows * D * (3D + M + D + M) FLOPs (37.7
// GFLOP at 16,000 positions of the 4AA DiT, 0.038 ms at 989 TFLOP/s)
// against 1.5 KB of x and output a position: two GEMMs back to back, bound
// by the tensor cores as long as the 2.36 MB of weights a 64-row tile
// streams from L2 keep up with them. The design:
// - a persistent grid, one block an SM, walking 64-row tiles of whole
//   frames (rows = floor(64 / L) * L; the rows past them in the tile and the
//   padding past the last position, zero-filled by TMA, are computed and
//   never stored); two consumer warpgroups share the tile's 64 rows and a
//   producer warpgroup, one thread of which loads (setmaxnreg: 40 and 232
//   registers a thread);
// - linear1 is computed once a row: linear2's K dimension is walked in
//   chunks, first the attention half by head groups of SB columns, then the
//   MLP half in chunks of 2 * SB, and each chunk's linear1 columns are
//   computed, finished and multiplied into the output right away. The fp32
//   output accumulator lives for the whole tile, split by columns between
//   the two warpgroups (64 x D/2 each: 96 registers a thread at D 384),
//   both reading the chunk's bf16 A tile in shared memory;
// - linear1 runs in steps of SB columns of w1, SB / 2 a warpgroup, on wgmma
//   SS (x and the w1 rows K-major in shared memory): q, k and v of a head
//   group in three steps, an MLP chunk in two. The producer loads the x
//   tile once a tile (128-byte swizzle panels of 64 columns) and streams
//   w1 and w2 through two mbarrier rings by TMA, k-panel by k-panel: a w1
//   stage holds 64 columns of a step's SB rows, a w2 stage 32 columns of all
//   D rows of w2 (64-byte swizzle). Every block reads the same weights,
//   which stay in the 50 MB L2;
// - a step's epilogue works on the accumulator fragments: bias and bf16
//   rounding, and for the MLP the exact GELU from K2's table
//   (gelu_table.cuh), into shared memory: q, k and v of the head group to a
//   staging area, the MLP's GELU straight to the chunk's A tile (64-byte
//   swizzle panels of 32 columns, K-major);
// - the per-head RMS-norm, RoPE and L x L attention read the staging area,
//   which serves any L <= 8 (a frame of L = 3, 5, 6 or 7 rows straddles the
//   accumulator's 8-row lane groups, and a head's q and k come from two
//   warpgroups, so shuffles cannot reach them). Each of the 256 consumer
//   threads takes one (row, head, part) item: 4 / (SB / dh) threads split a
//   head's dh, so every lane works at every head split, and sum their
//   partial sums of squares and q.k by shuffles. The attention output
//   overwrites the item's own q slice, so the q panels are the chunk's A
//   tile. (Norm and RoPE on the fragments, with a whole head in a thread's
//   quad, held up to 64 accumulator registers beside the output's and
//   spilled; staged, a step needs 24 to 32);
// - linear2 of a chunk: wgmma SS of the A tile against the w2 stages into
//   the output accumulator; named barriers of the two warpgroups order the
//   staging area and the A tile between writers and readers;
// - epilogue: bf16(bf16(acc) + b2), stored once. No atomics: every output
//   element is summed by one thread in a fixed order, so a result repeats
//   bit for bit.
// What holds it back (tools/kernel_variants.py K8, PERF.md): the
// epilogues. Without them (bias, GELU, norm, RoPE, attention) it takes two
// thirds of its time; both warpgroups run them in step, so the tensor cores
// idle meanwhile. Without either GEMM's products it keeps ~97% of its time,
// with each weight stage loaded once ~98%. Measured slower and dropped: a
// cluster of two blocks sharing each weight stage by TMA multicast, three
// k-panels' products in flight instead of two, and a step's epilogue in
// pieces beside the next step's products (two accumulators).
// Widths: the instances below, (D, dh) = (384, 24), (384, 128), (256, 16),
// (128, 32), with SB = 96, 128, 64 and 64, at any L from 1 to 8 and any M a
// multiple of 16 (a ragged last MLP chunk is zero-filled by TMA).
//
// Numerics follow the plain composition (ops/fused_spatial_block.py
// reference_spatial_block) op for op, as the WMMA route's: bf16 rounding
// after each matmul and bias add, fp32 norm statistics, q*k products
// rounded to bf16 and summed in fp32, fp32 softmax with the weights rounded
// to bf16, fp32 AV rounded once, GELU in fp32 rounded once. Sums are taken
// in another order than PyTorch's (linear2's also as partial sums over the
// chunks), so a bf16 rounding can land one ulp apart.

#include <float.h>

#include "common.cuh"
#include "gelu_table.cuh"
#include "hopper.cuh"

namespace {

using namespace lam_sm90;

constexpr int BM = 64;                    // rows (positions) a tile
constexpr int CONSUMERS = 256;            // two warpgroups on the tile's rows
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
// Registers a thread after setmaxnreg (the block launches at 168, which is
// also all a block of two warpgroups and one producer warp gets: the SM
// sub-partition that holds three of its warps has 170 a thread; it spilled
// and took 0.21 ms at 4AA against 0.19 here): the producer warpgroup gives
// up to 40 so the consumers hold the output accumulator (96 at D 384)
// beside a linear1 step's (24 or 32) and the epilogues' temporaries.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int XP = 64;                 // columns of an x / w1 k-panel (128-byte swizzle)
constexpr int AP = 32;                 // columns of an A-tile / w2 k-panel (64-byte swizzle)
constexpr int A_PANEL = BM * AP * 2;   // bytes of one A-tile panel
constexpr int MAX_STAGES = 6;
constexpr int MAXL = 8;
constexpr float EPS = 1e-6f;
constexpr size_t SMEM_MAX = 232448;
constexpr int BAR_TILE = 1;  // the named barrier of the two consumer warpgroups

struct alignas(64) Args {
  CUtensorMap mx, mw1, mw2;
  const bf16 *b1, *b2;
  const float *qs, *ks, *cos, *sin;
  const unsigned short* table;  // the GELU table
  bf16* out;
  float* out32;  // the fp32 partial (partial set), else null
  int R, L, M, DA, rt, tiles, kp, s1, s2, n_attn, n_mlp, b1_pairs, partial;
  float scale;
};

// Shared memory of a block (ops/fused_spatial_block.py sm90_smem_bytes
// mirrors it): the x tile (64 rows by D), s1 w1 stages (SB rows by 64
// columns), s2 w2 stages (D rows by 32 columns), the staging area (q, k, v
// of a head group: 3 SB columns by 64 rows), the mbarriers (256 bytes) and
// the slack that aligns the base to 1024 bytes.
inline size_t smem_bytes(int d, int sb, int s1, int s2) {
  return static_cast<size_t>(d) * BM * 2 + static_cast<size_t>(s1) * sb * XP * 2 +
         static_cast<size_t>(s2) * d * AP * 2 + static_cast<size_t>(3 * sb / AP) * A_PANEL +
         256 + 1024;
}

// The head group width of the instance for (D, dh), or 0.
inline int group_for(int d, int dh) {
  if (d == 384 && dh == 24) return 96;
  if (d == 384 && dh == 128) return 128;
  if (d == 256 && dh == 16) return 64;
  if (d == 128 && dh == 32) return 64;
  return 0;
}

struct Smem {
  unsigned char *x, *w1, *w2, *stg;
  uint32_t w1_stage, w2_stage;  // bytes of one stage
  uint64_t *full1, *empty1, *full2, *empty2, *xfull, *xempty;
};

// One arrival of this warp on `bar` (the barriers count consumer warps).
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}


// Byte offset of (row, col) in a 64-row tile of 32-column panels in the
// 64-byte swizzle (the staging area and the A tiles).
__device__ __forceinline__ int stg_offset(int row, int col) {
  return (col / AP) * A_PANEL + row * (AP * 2) + ((((col % AP) >> 3) ^ Swz<AP>::swz(row)) << 4) +
         (col & 7) * 2;
}

__device__ __forceinline__ void store_pair(unsigned char* tile, int row, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(tile + stg_offset(row, col)) = v;
}

// EP bf16 values of a row from column col0 (a multiple of 8), as floats.
template <int EP>
__device__ __forceinline__ void load_row(float (&v)[EP], const unsigned char* tile, int row,
                                         int col0) {
#pragma unroll
  for (int c = 0; c < EP / 8; ++c) {
    const uint4 u = *reinterpret_cast<const uint4*>(tile + stg_offset(row, col0 + 8 * c));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[8 * c + 2 * e] = __uint_as_float(w[e] << 16);
      v[8 * c + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

template <int EP>
__device__ __forceinline__ void store_row(unsigned char* tile, int row, int col0,
                                          const float (&v)[EP]) {
#pragma unroll
  for (int c = 0; c < EP / 8; ++c)
    *reinterpret_cast<uint4*>(tile + stg_offset(row, col0 + 8 * c)) =
        make_uint4(pack_bf16(v[8 * c], v[8 * c + 1]), pack_bf16(v[8 * c + 2], v[8 * c + 3]),
                   pack_bf16(v[8 * c + 4], v[8 * c + 5]), pack_bf16(v[8 * c + 6], v[8 * c + 7]));
}

// One linear1 step of a warpgroup: s = x[64 rows] @ w1_sub^T, where w1_sub
// is the N rows from row0 of each w1 stage, over the kp k-panels of x,
// streamed from stage counter u. A stage frees as soon as its products are
// done; the next k-panel's are already issued. (Keeping three k-panels'
// products in flight held more stages from the producer and measured
// slower, PERF.md.)
template <int N, int SB>
__device__ __forceinline__ void gemm1(float (&s)[N / 2], const Smem& sm, const Args& a, int row0,
                                      int& u) {
  const uint64_t dx = kmajor_desc<XP, BM>(reinterpret_cast<const bf16*>(sm.x), 0, 0);
  wgmma_fence();
#pragma unroll 1
  for (int p = 0; p < a.kp; ++p, ++u) {
    const int st = u % a.s1;
    mbar_wait(&sm.full1[st], (u / a.s1) & 1);
    const uint64_t dw =
        kmajor_desc<XP, SB>(reinterpret_cast<const bf16*>(sm.w1 + st * sm.w1_stage), row0, 0);
#pragma unroll
    for (int kk = 0; kk < XP / 16; ++kk)
      wgmma_ss<N, 0, 0>(s, dx + p * (BM * XP * 2 / 16) + 2 * kk, dw + 2 * kk, p + kk > 0);
    wgmma_commit();
    if (p > 0) {
      wgmma_wait1();
      warp_arrive(&sm.empty1[(u - 1) % a.s1]);
    }
  }
  wgmma_wait0();
  reg_fence(s);
  warp_arrive(&sm.empty1[(u - 1) % a.s1]);
}

// linear2 of one chunk for a warpgroup: o += A @ w2_half^T over `panels`
// 32-column k-panels of the A tile at the staging area's start, the
// warpgroup's NO rows of each w2 stage, streamed from stage counter u.
template <int NO>
__device__ __forceinline__ void gemm2(float (&o)[NO / 2], const Smem& sm, const Args& a,
                                      int panels, int wg, int& u) {
  const uint64_t da = kmajor_desc<AP, BM>(reinterpret_cast<const bf16*>(sm.stg), 0, 0);
  wgmma_fence();
#pragma unroll 1
  for (int q = 0; q < panels; ++q, ++u) {
    const int st = u % a.s2;
    mbar_wait(&sm.full2[st], (u / a.s2) & 1);
    const uint64_t db = kmajor_desc<AP, 2 * NO>(
        reinterpret_cast<const bf16*>(sm.w2 + st * sm.w2_stage), wg * NO, 0);
#pragma unroll
    for (int kk = 0; kk < AP / 16; ++kk)
      wgmma_ss<NO, 0, 0>(o, da + q * (A_PANEL / 16) + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    if (q > 0) {
      wgmma_wait1();
      warp_arrive(&sm.empty2[(u - 1) % a.s2]);
    }
  }
  wgmma_wait0();
  reg_fence(o);
  warp_arrive(&sm.empty2[(u - 1) % a.s2]);
}

// The accumulator of an m64nN step holds, in thread (warp w, g, cq) of the
// warpgroup, element 4j + e at row 16w + g + 8(e/2), column 8j + 2cq + e%2.
// bf16(s) + b1 in place, b1 from w1 row `brow` on (0 past `valid`
// columns); the callers round it to bf16 when they pack it.
template <int N>
__device__ __forceinline__ void add_bias(float (&s)[N / 2], const Args& a, int brow, int valid) {
  const int cq = threadIdx.x % 4;
  const unsigned short* b1 = reinterpret_cast<const unsigned short*>(a.b1) + brow;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * cq;  // even, as brow and valid are
    uint32_t pair = 0u;
    if (col < valid)
      pair = a.b1_pairs ? __ldg(reinterpret_cast<const unsigned int*>(b1 + col))
                        : static_cast<uint32_t>(__ldg(b1 + col)) |
                              (static_cast<uint32_t>(__ldg(b1 + col + 1)) << 16);
    const float b0 = __uint_as_float(pair << 16), b1v = __uint_as_float(pair & 0xffff0000u);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      s[4 * j + 2 * rr] = __fadd_rn(lam_round_bf16(s[4 * j + 2 * rr]), b0);
      s[4 * j + 2 * rr + 1] = __fadd_rn(lam_round_bf16(s[4 * j + 2 * rr + 1]), b1v);
    }
  }
}

// A step of q, k or v columns: bias and rounding into staging columns
// from col0.
template <int N>
__device__ __forceinline__ void bias_epilogue(float (&s)[N / 2], const Args& a, int brow,
                                              unsigned char* dst, int col0) {
  const int lane = threadIdx.x % 32, g = lane / 4, cq = lane % 4, warp = (threadIdx.x % 128) / 32;
  add_bias<N>(s, a, brow, N);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      store_pair(dst, 16 * warp + g + 8 * rr, col0 + 8 * j + 2 * cq,
                 pack_bf16(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
}

// The items of the attention of a head group: thread t of the 256 takes row
// t / 4 and, of its SB / DH heads, the part (t % 4) of TPI = 4 / (SB / DH)
// parts of EP = DH / TPI columns, so every lane works at every head split.
// An item walks its NC 16-byte pieces from piece `rot` on, so that at each
// step the four items of a row read four different 16-byte chunks of the
// 64-byte swizzle rows, in four different bank groups: their first chunks
// are (0, 3, 2, 1) at dh 24, all 0 at dh 128 (rot = item), and (0, 2, 0,
// 2) at dh 16 and 32 (rot = item / 2). Walked in one order, the dh 128
// items met 4-way bank conflicts (3 x 128: 0.191 ms against 0.174).
template <int SB, int DH>
struct Item {
  static constexpr int HG = SB / DH, TPI = 4 / HG, EP = DH / TPI, NC = EP / 8;
  static_assert(HG * TPI == 4 && EP % 8 == 0, "one item a thread, 16-byte row pieces");
  int i, h, t, col0, rot;
  __device__ Item() {
    const int tid = threadIdx.x;
    i = tid / 4, h = (tid % 4) / TPI, t = tid % TPI;
    col0 = h * DH + t * EP;
    rot = NC == 4 ? tid % 4 : NC == 2 ? tid % 4 / 2 : 0;
  }
  // the column of the item's c-th piece in walking order
  __device__ int col(int c) const { return col0 + 8 * ((c + rot) % NC); }
};

// RMS-norm and RoPE of the staged q and k in place, at the rounding points
// of lam_rmsnorm_rope: each thread its item's slice of q and of k (whole
// (2p, 2p + 1) pairs), fp32 sum of squares over the slice, summed over the
// head's TPI parts by shuffles, x * rsqrt(mean + eps) * scale rounded to
// bf16, then the rotation at the row's position rounded to bf16. The slice
// is walked in 16-byte pieces, read twice, so few values are live beside
// the output accumulator.
template <int SB, int DH>
__device__ __forceinline__ void normrope(const Args& a, unsigned char* stg) {
  using I = Item<SB, DH>;
  const I it;
  const int pos = it.i % a.L, p0 = it.t * I::EP / 2;  // the slice's first pair in the head
  const float* cs = a.cos + pos * (DH / 2) + p0;
  const float* sn = a.sin + pos * (DH / 2) + p0;
#pragma unroll 1
  for (int side = 0; side < 2; ++side) {  // q, then k
    unsigned char* tile = stg + side * (SB / AP) * A_PANEL;
    const float* ns = (side ? a.ks : a.qs) + 2 * p0;
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < I::NC; ++c) {
      float v[8];
      load_row<8>(v, tile, it.i, it.col(c));
#pragma unroll
      for (int e = 0; e < 8; e += 2)
        ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(v[e], v[e]), __fmul_rn(v[e + 1], v[e + 1])));
    }
#pragma unroll
    for (int o = 1; o < I::TPI; o <<= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(DH)), EPS));
#pragma unroll
    for (int c = 0; c < I::NC; ++c) {
      float v[8];
      load_row<8>(v, tile, it.i, it.col(c));
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const int q = it.col(c) - it.col0 + e;  // the slice's element of the pair
        const float na = lam_round_bf16(__fmul_rn(__fmul_rn(v[e], r), __ldg(ns + q)));
        const float nb = lam_round_bf16(__fmul_rn(__fmul_rn(v[e + 1], r), __ldg(ns + q + 1)));
        const float co = __ldg(cs + q / 2), si = __ldg(sn + q / 2);
        v[e] = __fsub_rn(__fmul_rn(co, na), __fmul_rn(si, nb));
        v[e + 1] = __fadd_rn(__fmul_rn(si, na), __fmul_rn(co, nb));
      }
      store_row<8>(tile, it.i, it.col(c), v);
    }
  }
}

// An MLP sub-block (mlp columns from mcol): bias, rounding and the exact
// GELU, rounded to bf16, into the A tile's columns from col0.
template <int N>
__device__ __forceinline__ void gelu_epilogue(float (&s)[N / 2], const Args& a, int brow, int mcol,
                                              unsigned char* dst, int col0) {
  const int lane = threadIdx.x % 32, g = lane / 4, cq = lane % 4, warp = (threadIdx.x % 128) / 32;
  add_bias<N>(s, a, brow, a.M - mcol);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const uint32_t h0 = __bfloat16_as_ushort(__float2bfloat16(s[4 * j + 2 * rr]));
      const uint32_t h1 = __bfloat16_as_ushort(__float2bfloat16(s[4 * j + 2 * rr + 1]));
      store_pair(dst, 16 * warp + g + 8 * rr, col0 + 8 * j + 2 * cq,
                 gelu_bits(h0, a.table) | (gelu_bits(h1, a.table) << 16));
    }
}

// The L x L attention of a head group from the staged q, k, v, an item a
// thread (Item); the parts of a head sum their q.k by shuffles. The thread
// walks its columns in 16-byte pieces, so few
// values are live beside the output accumulator: the q.k partial sums of
// the frame's L keys first, then the weighted sum of v piece by piece,
// written over its own q slice (no other thread reads it), which makes the
// q panels the chunk's A tile. Rows past the tile's whole frames are not
// written.
template <int SB, int DH>
__device__ __forceinline__ void attention(const Args& a, unsigned char* stg) {
  using I = Item<SB, DH>;
  constexpr int TPI = I::TPI;
  const I it;
  const int i = it.i;
  unsigned char* qt = stg;
  const unsigned char* kt = stg + (SB / AP) * A_PANEL;
  const unsigned char* vt = stg + 2 * (SB / AP) * A_PANEL;
  const int f0 = i / a.L * a.L;
  float lg[MAXL];
#pragma unroll
  for (int j = 0; j < MAXL; ++j) lg[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < I::NC; ++c) {
    float q[8];
    load_row<8>(q, qt, i, it.col(c));
#pragma unroll
    for (int j = 0; j < MAXL; ++j) {
      if (j >= a.L) break;
      float k[8];
      load_row<8>(k, kt, min(f0 + j, BM - 1), it.col(c));
#pragma unroll
      for (int e = 0; e < 8; ++e) lg[j] = __fadd_rn(lg[j], lam_round_bf16(__fmul_rn(q[e], k[e])));
    }
  }
  float mx = -FLT_MAX;
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    if (j >= a.L) break;
#pragma unroll
    for (int o = 1; o < TPI; o <<= 1) lg[j] = __fadd_rn(lg[j], __shfl_xor_sync(0xffffffffu, lg[j], o));
    lg[j] = __fmul_rn(lg[j], a.scale);
    mx = fmaxf(mx, lg[j]);
  }
  float den = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    if (j >= a.L) break;
    lg[j] = expf(__fsub_rn(lg[j], mx));
    den = __fadd_rn(den, lg[j]);
  }
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    if (j >= a.L) break;
    lg[j] = lam_round_bf16(__fdiv_rn(lg[j], den));
  }
#pragma unroll
  for (int c = 0; c < I::NC; ++c) {
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXL; ++j) {
      if (j >= a.L) break;
      float v[8];
      load_row<8>(v, vt, min(f0 + j, BM - 1), it.col(c));
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(lg[j], v[e], acc[e]);
    }
    if (i < a.rt) store_row<8>(qt, i, it.col(c), acc);
  }
}

// The consumer warpgroups: all 64 rows of the block's tiles; SW = SB / 2
// columns of each linear1 step and output columns [wg NO, wg NO + NO) each.
template <int NO, int SB, int DH>
__device__ __forceinline__ void consume(const Args& a, const Smem& sm, int my_tiles) {
  constexpr int D = 2 * NO, SW = SB / 2;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, cq = lane % 4;
  int u1 = 0, u2 = 0;
  for (int i = 0; i < my_tiles; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    mbar_wait(sm.xfull, i & 1);
    float o[NO / 2];
#pragma unroll
    for (int e = 0; e < NO / 2; ++e) o[e] = 0.0f;
    float s[SW / 2];
    for (int c = 0; c < a.n_attn; ++c) {
      // q, k and v of head group c into the staging area, raw
#pragma unroll 1
      for (int part = 0; part < 3; ++part) {
        gemm1<SW, SB>(s, sm, a, wg * SW, u1);
        if (part == 0) named_sync(BAR_TILE, CONSUMERS);  // both linear2 of the last chunk are done
        bias_epilogue<SW>(s, a, part * a.DA + c * SB + wg * SW, sm.stg + part * (SB / AP) * A_PANEL,
                          wg * SW);
      }
      named_sync(BAR_TILE, CONSUMERS);
      normrope<SB, DH>(a, sm.stg);
      named_sync(BAR_TILE, CONSUMERS);  // q and k are normed and rotated
      attention<SB, DH>(a, sm.stg);
      fence_proxy_async();
      named_sync(BAR_TILE, CONSUMERS);  // the A tile is whole
      gemm2<NO>(o, sm, a, SB / AP, wg, u2);
    }
    for (int c = 0; c < a.n_mlp; ++c) {
#pragma unroll 1
      for (int part = 0; part < 2; ++part) {
        const int mcol = c * 2 * SB + part * SB + wg * SW;
        gemm1<SW, SB>(s, sm, a, wg * SW, u1);
        if (part == 1 && c + 1 == a.n_mlp) warp_arrive(sm.xempty);  // the tile's last step
        if (part == 0) named_sync(BAR_TILE, CONSUMERS);
        gelu_epilogue<SW>(s, a, 3 * a.DA + mcol, mcol, sm.stg, part * SB + wg * SW);
      }
      fence_proxy_async();
      named_sync(BAR_TILE, CONSUMERS);
      gemm2<NO>(o, sm, a, 2 * SB / AP, wg, u2);
    }
    // epilogue, rows g and g + 8 of each warp's 16: the fp32 partial acc,
    // or out = bf16(bf16(acc) + b2)
    if (a.partial) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 16 * warp + g + 8 * rr;
        const long long grow = static_cast<long long>(t) * a.rt + row;
        if (row >= a.rt || grow >= a.R) continue;
        float* dst = a.out32 + grow * D + wg * NO;
#pragma unroll
        for (int j = 0; j < NO / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j + 2 * cq) =
              make_float2(o[4 * j + 2 * rr], o[4 * j + 2 * rr + 1]);
      }
      continue;
    }
    const unsigned short* b2 = reinterpret_cast<const unsigned short*>(a.b2) + wg * NO;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = 16 * warp + g + 8 * rr;
      const long long grow = static_cast<long long>(t) * a.rt + row;
      if (row >= a.rt || grow >= a.R) continue;
      bf16* dst = a.out + grow * D + wg * NO;
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int col = 8 * j + 2 * cq;
        const float b0 = __uint_as_float(static_cast<uint32_t>(__ldg(b2 + col)) << 16);
        const float b1 = __uint_as_float(static_cast<uint32_t>(__ldg(b2 + col + 1)) << 16);
        *reinterpret_cast<uint32_t*>(dst + col) =
            pack_bf16(__fadd_rn(lam_round_bf16(o[4 * j + 2 * rr]), b0),
                      __fadd_rn(lam_round_bf16(o[4 * j + 2 * rr + 1]), b1));
      }
    }
  }
}

template <int NO, int SB, int DH>
__global__ void __launch_bounds__(THREADS, 1)
    spatial_sm90_kernel(const __grid_constant__ Args a) {
  constexpr int D = 2 * NO;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  Smem sm;
  sm.x = base;
  sm.w1 = sm.x + D * BM * 2;
  sm.w1_stage = SB * XP * 2;
  sm.w2 = sm.w1 + a.s1 * sm.w1_stage;
  sm.w2_stage = D * AP * 2;
  sm.stg = sm.w2 + a.s2 * sm.w2_stage;
  sm.full1 = reinterpret_cast<uint64_t*>(sm.stg + 3 * (SB / AP) * A_PANEL);
  sm.empty1 = sm.full1 + MAX_STAGES;
  sm.full2 = sm.empty1 + MAX_STAGES;
  sm.empty2 = sm.full2 + MAX_STAGES;
  sm.xfull = sm.empty2 + MAX_STAGES;
  sm.xempty = sm.xfull + 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < MAX_STAGES; ++st) {
      mbar_init(&sm.full1[st], 1);
      mbar_init(&sm.empty1[st], CONSUMERS / 32);  // one arrival a consumer warp
      mbar_init(&sm.full2[st], 1);
      mbar_init(&sm.empty2[st], CONSUMERS / 32);
    }
    mbar_init(sm.xfull, 1);
    mbar_init(sm.xempty, CONSUMERS / 32);
    mbar_init_fence();
  }
  __syncthreads();

  const int my_tiles = (a.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != CONSUMERS) return;
    // ---- producer: one thread walks the consumers' sequence: per tile the
    // x tile, then per chunk its linear1 steps' w1 stages (SB rows of w1,
    // k-panel by k-panel) and its w2 stages ----
    const uint32_t box2 = NO * AP * 2;
    int u1 = 0, u2 = 0;
    for (int i = 0; i < my_tiles; ++i) {
      const int t = blockIdx.x + i * gridDim.x;
      mbar_wait(sm.xempty, (i & 1) ^ 1);
      mbar_arrive_expect_tx(sm.xfull, D * BM * 2);
      for (int p = 0; p < a.kp; ++p)
        tma_load_4d(sm.x + p * BM * XP * 2, &a.mx, sm.xfull, p * XP, t * a.rt, 0, 0);
      for (int c = 0; c < a.n_attn + a.n_mlp; ++c) {
        const bool attn = c < a.n_attn;
        for (int step = 0; step < (attn ? 3 : 2); ++step) {
          // the step's first w1 row: q, k and v of the head group, or the
          // MLP chunk's two halves
          const int r0 =
              attn ? step * a.DA + c * SB : 3 * a.DA + (c - a.n_attn) * 2 * SB + step * SB;
          for (int p = 0; p < a.kp; ++p, ++u1) {
            const int st = u1 % a.s1;
            mbar_wait(&sm.empty1[st], ((u1 / a.s1) & 1) ^ 1);
            mbar_arrive_expect_tx(&sm.full1[st], sm.w1_stage);
            tma_load_4d(sm.w1 + st * sm.w1_stage, &a.mw1, &sm.full1[st], p * XP, r0, 0, 0);
          }
        }
        const int k0 = attn ? c * SB : a.DA + (c - a.n_attn) * 2 * SB;  // the chunk's w2 column
        for (int q = 0; q < (attn ? SB : 2 * SB) / AP; ++q, ++u2) {
          const int st = u2 % a.s2;
          mbar_wait(&sm.empty2[st], ((u2 / a.s2) & 1) ^ 1);
          unsigned char* dst = sm.w2 + st * sm.w2_stage;
          mbar_arrive_expect_tx(&sm.full2[st], 2 * box2);
          tma_load_4d(dst, &a.mw2, &sm.full2[st], k0 + q * AP, 0, 0, 0);
          tma_load_4d(dst + box2, &a.mw2, &sm.full2[st], k0 + q * AP, NO, 0, 0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  consume<NO, SB, DH>(a, sm, my_tiles);
}

template <int NO, int SB, int DH>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  static cudaError_t attr = lam_set_smem(spatial_sm90_kernel<NO, SB, DH>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const int grid = lam_persistent_grid(spatial_sm90_kernel<NO, SB, DH>, THREADS, smem, a.tiles);
  spatial_sm90_kernel<NO, SB, DH><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: bf16 [N, L, D] contiguous, 16-byte aligned; H heads of dh = DA / H
// columns, DA a multiple of the head group and at most D (D: the whole
// block); w1: bf16 [3 DA + M, D] rows with row stride ld1 (nn.Linear
// layout), b1: bf16 [3 DA + M]; w2: bf16 [D, DA + M] rows with row stride
// ld2, b2: bf16 [D] (unread with `partial`); qs, ks: fp32 [dh]; cos, sin:
// fp32 [L, dh / 2] row-major; out: bf16 [N, L, D], or with `partial` fp32
// [N, L, D] (the partial sum, no b2); table: scratch for the GELU table
// (GELU_ENTRIES bf16). 1 <= L <= 8, M a multiple of 16, (D, dh) one of the
// instances of group_for; w1/w2 16-byte aligned with strides that are
// multiples of 8. The plan (ops/fused_spatial_block.py sm90_plan): s1 w1
// stages and s2 w2 stages, 2..6 each. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int lam_spatial_block_sm90(const void* x, const void* w1, const void* b1,
                                      const void* qs, const void* ks, const void* w2,
                                      const void* b2, const void* cos, const void* sin, void* out,
                                      void* table, long long N, int L, int D, int M, int H,
                                      long long ld1, long long ld2, float scale, int s1, int s2,
                                      int DA, int partial, void* stream) {
  const int dh = H > 0 && DA > 0 && DA % H == 0 ? DA / H : 0;
  const int sb = group_for(D, dh);
  if (N <= 0 || L < 1 || L > MAXL || N * L >= (1LL << 31) || M <= 0 || M % 16 || sb == 0 ||
      DA > D || DA % sb || s1 < 2 || s1 > MAX_STAGES || s2 < 2 || s2 > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D, sb, s1, s2);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.b1 = static_cast<const bf16*>(b1);
  a.b2 = static_cast<const bf16*>(b2);
  a.qs = static_cast<const float*>(qs);
  a.ks = static_cast<const float*>(ks);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.table = static_cast<const unsigned short*>(table);
  a.partial = partial != 0;
  a.out = a.partial ? nullptr : static_cast<bf16*>(out);
  a.out32 = a.partial ? static_cast<float*>(out) : nullptr;
  a.R = static_cast<int>(N * L);
  a.L = L;
  a.M = M;
  a.DA = DA;
  a.rt = BM / L * L;
  a.tiles = (a.R + a.rt - 1) / a.rt;
  a.kp = D / XP;
  a.s1 = s1;
  a.s2 = s2;
  a.n_attn = DA / sb;
  a.n_mlp = (M + 2 * sb - 1) / (2 * sb);
  a.scale = scale;
  a.b1_pairs = reinterpret_cast<unsigned long long>(b1) % 4 == 0;
  using lam_sm90_host::encode_tile_map;
  // 2-D maps as the 4-D map of hopper.cuh with unit batch and head axes:
  // x and w1 in boxes of one 64-column panel (64 and SB rows), w2 in boxes
  // of one 32-column panel of D / 2 rows
  if (!encode_tile_map(&a.mx, x, 1, 1, a.R, D, 0, 0, D, BM, XP) ||
      !encode_tile_map(&a.mw1, w1, 1, 1, 3 * DA + M, D, 0, 0, ld1, sb, XP) ||
      !encode_tile_map(&a.mw2, w2, 1, 1, D, DA + M, 0, 0, ld2, D / 2, AP))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = fill_gelu_table(static_cast<unsigned short*>(table), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (D == 384 && dh == 24) err = launch<192, 96, 24>(a, smem, st);
  else if (D == 384) err = launch<192, 128, 128>(a, smem, st);
  else if (D == 256) err = launch<128, 64, 16>(a, smem, st);
  else err = launch<64, 64, 32>(a, smem, st);
  return static_cast<int>(err);
}
