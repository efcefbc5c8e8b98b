// Fused MLP branch gelu(x @ w1 + b1) @ w2 with fp32 operands, for Hopper
// (sm_90a), on the FP32 pipes (FFMA; no tensor cores, so no TF32).
//
// Replaces the fp32 instance of the Pallas TPU kernel
// lam_slide_tpu/ops/fused_mlp.py `_mlp_kernel`, which the DiT runs in fp32
// in the MD17 test pass (the registry's fp32 `test_model`). In fp32 the
// kernel's `astype(x.dtype)` of the mid is a no-op, so the mid is not
// rounded: mid = x @ w1 + b1 in fp32, then the exact GELU
// 0.5 * mid * (1 + erf(mid * 2^-0.5)) in fp32 (erff; the bf16 kernel's GELU
// table covers bf16 mids only), then out = gelu(mid) @ w2 in fp32.
//
// Layout: w1 [d_in, d_mid] and w2 [d_mid, d_out] are the transposed views of
// nn.Linear weights the DiT passes (unit stride on their first axis), so
// w1[i, m] = w1[i + m * w1_s] and w2[m, o] = w2[m + o * w2_s]: the rows of
// the weights' own memory are columns here.
//
// Two kernels. The outer-product kernel (namespace tiled, below) takes the
// widths the registries build in fp32 (256 -> 512 -> 256, 384 -> 768 -> 384,
// 32 -> 64 -> 32). The dot-product kernel takes the other widths, as a
// route; both sum every output in the same order, so they agree bit for
// bit.
//
// The dot-product kernel: a block of 256 threads owns BM rows of x
// (64, or 32) and keeps their [BM, d_out] fp32 output in registers (a
// 16 x 16 thread grid: rows ty*RPT .. +RPT, columns tx + 16 j). x's tile
// stays in shared memory for the whole block; d_mid streams through in
// chunks of 32 columns, their w1 and w2 tiles double-buffered where shared
// memory holds two stages (MD17's widths), so the next chunk's copies are in
// flight while this one's products run. Every copy is a 16-byte cp.async
// (x, w1 and w2 16-byte aligned, their strides multiples of 4 floats; the
// wrapper checks), with zero fill past the last row or past d_mid. Every
// tile keeps the layout of its source, rows along the reduction axis, so a
// copy is a run of contiguous floats and a product reads 16 bytes at a
// time:
// - the chunk's w1 columns are 32 contiguous rows of the weight's memory,
//   [32][d_in + 4]; GEMM1: each thread forms RPT x 2 mids (columns tx,
//   tx + 16), reading x and w1 as float4 along d_in, adds b1, takes the GELU
//   and stores them into a [BM][36] tile;
// - the chunk's w2 rows are d_out runs of 32 contiguous floats of the
//   weight's memory, [d_out][36]; GEMM2 adds the chunk's contribution to
//   every output in registers, reading the GELU tile and w2 as float4 along
//   d_mid.
// Row strides of 4 mod 32 floats put the 16 distinct rows a warp reads at
// once on distinct banks (two wavefronts for 256 bytes, the least). No
// atomics: every output is summed by one thread in a fixed order, so a
// result repeats bit for bit.
//
// What bounds both on the H100: 2 * rows * (d_in * d_mid + d_mid * d_out)
// FLOPs on the FP32 pipes (67 TFLOP/s) against rows * (d_in + d_out) * 4
// bytes: operations (2.88 ms at the MD17 test pass's 368,640 rows of 256 ->
// 512 -> 256). The dot-product kernel reads shared memory 16 bytes for 4 to
// 13 FFMAs; the outer-product kernel, at MD17's 16 x 8 outputs and 4 x 8
// mids a thread, 16 bytes for 21 FFMAs in GEMM2 and 10.7 in GEMM1. Both run
// one block an SM at MD17's widths (8 warps; the output tile and x^T fill
// the registers and shared memory), so each slice's barrier stalls the SM:
// tools/kernel_variants.py K2-fp32 times what the products, the copies, the
// GELU and the barriers cost.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid: columns x rows
constexpr int BC = 32;           // d_mid columns a chunk
constexpr int GS = BC + 4;       // row stride of the GELU and w2 tiles

// Shared memory of a block (the wrapper's f32_smem_bytes mirrors it): the x
// tile and `stages` w1 chunks with rows of d_in + 4 floats, the GELU chunk
// and `stages` w2 chunks with rows of 36.
size_t smem_bytes(int bm, int stages, int d_in, int d_out) {
  return sizeof(float) * (static_cast<size_t>(bm + stages * BC) * (d_in + 4) +
                          static_cast<size_t>(bm + stages * d_out) * GS);
}

struct Args {
  const float *x, *w1, *b1, *w2;
  float* out;
  long long rows, x_s, w1_s, w2_s, o_s;
  int d_in, d_mid, d_out;
};

__device__ __forceinline__ float gelu_exact(float v) {
  // 0.5 * v * (1 + erf(v * 2^-0.5)), each op rounded as the plain version's
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, erff(__fmul_rn(v, 0.70710678118654752f))));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16 bytes from global to shared memory, asynchronously; zeros where !valid
// (src is then not read).
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// RPT rows a thread (BM = 16 * RPT), STAGES chunk buffers (1 or 2), NJ output
// columns a thread (d_out <= 16 * NJ).
template <int RPT, int STAGES, int NJ>
__global__ void __launch_bounds__(THREADS) mlp_f32_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  constexpr int BM = TY * RPT;
  const int xs = a.d_in + 4, k4 = a.d_in / 4;
  float* x_s = reinterpret_cast<float*>(smem4);  // [BM][xs]
  float* w1_s = x_s + BM * xs;                   // [STAGES][BC][xs]
  float* g_s = w1_s + STAGES * BC * xs;          // [BM][GS]
  float* w2_s = g_s + BM * GS;                   // [STAGES][d_out][GS]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;

  auto load_chunk = [&](int m0, int st) {
    float* w1_t = w1_s + st * BC * xs;
    float* w2_t = w2_s + st * a.d_out * GS;
    for (int idx = tid; idx < BC * k4; idx += THREADS) {
      const int c = idx / k4, i = 4 * (idx % k4);
      const bool valid = m0 + c < a.d_mid;
      copy16(&w1_t[c * xs + i], a.w1 + i + static_cast<long long>(valid ? m0 + c : 0) * a.w1_s,
             valid);
    }
    for (int idx = tid; idx < a.d_out * (BC / 4); idx += THREADS) {
      const int o = idx / (BC / 4), m = 4 * (idx % (BC / 4));
      const bool valid = m0 + m < a.d_mid;  // d_mid % 16 == 0: all 4 or none
      copy16(&w2_t[o * GS + m], a.w2 + (valid ? m0 + m : 0) + static_cast<long long>(o) * a.w2_s,
             valid);
    }
  };

  for (int idx = tid; idx < BM * k4; idx += THREADS) {
    const int r = idx / k4, k = 4 * (idx % k4);
    const bool valid = row0 + r < a.rows;
    copy16(&x_s[r * xs + k], a.x + (valid ? row0 + r : 0) * a.x_s + k, valid);
  }
  load_chunk(0, 0);
  commit();

  float acc[RPT][NJ];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.0f;

  const int chunks = (a.d_mid + BC - 1) / BC;
  for (int ch = 0; ch < chunks; ++ch) {
    const int m0 = ch * BC, st = STAGES == 2 ? ch % 2 : 0;
    if (STAGES == 2 && ch + 1 < chunks) {
      load_chunk(m0 + BC, (ch + 1) % 2);  // its stage was freed by the last barrier
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();  // this chunk's tiles (and x's) have landed for every thread
    const float* w1_t = w1_s + st * BC * xs;
    const float* w2_t = w2_s + st * a.d_out * GS;
    // GEMM1: rows ty*RPT + r, chunk columns tx and tx + 16
    float mid[RPT][2];
#pragma unroll
    for (int r = 0; r < RPT; ++r) mid[r][0] = mid[r][1] = 0.0f;
    for (int k = 0; k < a.d_in; k += 4) {
      float4 xv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        xv[r] = *reinterpret_cast<const float4*>(&x_s[(ty * RPT + r) * xs + k]);
      const float4 w0 = *reinterpret_cast<const float4*>(&w1_t[tx * xs + k]);
      const float4 w1 = *reinterpret_cast<const float4*>(&w1_t[(tx + TX) * xs + k]);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        mid[r][0] = dot4(xv[r], w0, mid[r][0]);
        mid[r][1] = dot4(xv[r], w1, mid[r][1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = m0 + tx + TX * e;
      const float b = col < a.d_mid ? a.b1[col] : 0.0f;
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        g_s[(ty * RPT + r) * GS + tx + TX * e] = gelu_exact(__fadd_rn(mid[r][e], b));
    }
    __syncthreads();
    // GEMM2: out[rows, columns tx + 16 j] += gelu(mid) chunk @ w2 chunk
#pragma unroll 2
    for (int m = 0; m < BC; m += 4) {
      float4 gv[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        gv[r] = *reinterpret_cast<const float4*>(&g_s[(ty * RPT + r) * GS + m]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int o = tx + TX * j;
        if (o >= a.d_out) break;
        const float4 wv = *reinterpret_cast<const float4*>(&w2_t[o * GS + m]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) acc[r][j] = dot4(gv[r], wv, acc[r][j]);
      }
    }
    __syncthreads();  // this stage and the GELU tile are consumed
    if (STAGES == 1 && ch + 1 < chunks) {
      load_chunk(m0 + BC, 0);
      commit();
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long row = row0 + ty * RPT + r;
    if (row >= a.rows) break;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = tx + TX * j;
      if (o < a.d_out) a.out[row * a.o_s + o] = acc[r][j];
    }
  }
}

template <int RPT, int STAGES, int NJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int BM = TY * RPT;
  const size_t smem = smem_bytes(BM, STAGES, a.d_in, a.d_out);
  static cudaError_t attr = lam_set_smem(mlp_f32_kernel<RPT, STAGES, NJ>, 232448);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (a.rows + BM - 1) / BM;
  mlp_f32_kernel<RPT, STAGES, NJ><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int RPT, int STAGES>
cudaError_t launch_nj(const Args& a, cudaStream_t stream) {
  const int nj = (a.d_out + 15) / 16;
  if (nj <= 2) return launch<RPT, STAGES, 2>(a, stream);
  if (nj <= 4) return launch<RPT, STAGES, 4>(a, stream);
  if (nj <= 8) return launch<RPT, STAGES, 8>(a, stream);
  if (nj <= 16) return launch<RPT, STAGES, 16>(a, stream);
  if (nj <= 24) return launch<RPT, STAGES, 24>(a, stream);
  return launch<RPT, STAGES, 32>(a, stream);
}

// ---------------------------------------------------------------------------
// The outer-product kernel (the route of every width with an instance:
// d_out 256, 384, 128 and 32, tiled_plan in the wrapper). A block of NT
// threads owns BM rows of x and keeps their [BM, D_OUT] output in
// registers, a TM x TN micro-tile a thread. x is staged once, transposed
// through registers, as x^T [d_in][BM + 4]. d_mid streams through in chunks
// of C columns, in order; each chunk:
// - GEMM1: the [BM, C] mid, a 4 x G1N micro-tile a thread (rows 4 rg .. + 4,
//   mids 4 (mg + M1 jj) .. + 4), over k-slices of KS rows of w1^T
//   [KS][C + 4] (rows of the wrapper's contiguous [d_in, d_mid] copy of the
//   transposed nn.Linear view). Per column of d_in, one float4 of x^T and
//   G1N / 4 of w1^T feed 4 G1N FFMAs; each mid one FMA chain over d_in, in
//   order;
// - b1, then the exact GELU, stored mid-major into G^T [C][BM + 4];
// - GEMM2: the chunk's contribution to the output over m-slices of MS rows
//   of w2^T (the wrapper's contiguous [d_mid, d_out] copy): per mid, TM / 4
//   float4 of G^T and TN / 4 of w2^T feed TM TN FFMAs (21 a 16-byte load at
//   16 x 8); each output one FMA chain over d_mid, in order.
// The slices (GEMM1's w1^T, GEMM2's w2^T) pass through a ring of STAGES
// stages by 16-byte cp.async, two slices in flight ahead of the one in use;
// one barrier a slice. Lane layouts: a warp's eight neighbouring
// lanes take eight neighbouring column groups and its four lane octets four
// neighbouring row groups, so every shared load of a warp reads 64 or 128
// contiguous bytes. The sums run in the order of the dot-product kernel
// above, so the two routes agree bit for bit.
namespace tiled {

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

constexpr int STAGES = 3;

template <int D_OUT_, int BM_, int NT_, int TM_, int TN_, int C_, int G1N_, int KS_, int MS_>
struct Inst {
  static constexpr int D_OUT = D_OUT_, BM = BM_, NT = NT_, TM = TM_, TN = TN_, C = C_,
                       G1N = G1N_, KS = KS_, MS = MS_;
  static constexpr int R1 = BM / 4, M1 = C / G1N;      // GEMM1 row and mid groups
  static constexpr int R2 = BM / TM, C2 = D_OUT / TN;  // GEMM2 row and column groups
  static constexpr int LDX = BM + 4, LDW1 = C + 4, LDG = BM + 4;
  static constexpr int STAGE1 = KS * LDW1, STAGE2 = MS * D_OUT;
  static constexpr int STAGE = STAGE1 > STAGE2 ? STAGE1 : STAGE2;  // floats a stage
  // the wrapper's tiled_smem_bytes mirrors this
  static size_t smem(int d_in) {
    return sizeof(float) * (static_cast<size_t>(d_in) * LDX + STAGES * STAGE + C * LDG);
  }
  static_assert(R1 * M1 == NT && R2 * C2 == NT, "one micro-tile a thread");
  static_assert(M1 % 8 == 0 && C2 % 8 == 0 && R1 % 4 == 0 && R2 % 4 == 0, "lane layout");
  static_assert(C % MS == 0 && TM % 4 == 0 && TN % 4 == 0 && G1N % 4 == 0, "vectors");
};

// the wrapper's TILED_INSTANCES mirror these (d_out, rows a block)
// MD17 (256 -> 512 -> 256): 128 rows, 256 threads at 16 x 8, one block an SM.
using Inst256 = Inst<256, 128, 256, 16, 8, 64, 8, 64, 16>;
// 4AA (384 -> 768 -> 384): 64 rows, 384 threads at 8 x 8, chunks of 96; and
// 32 rows of 192 threads where 64-row blocks would not cover the SMs.
using Inst384 = Inst<384, 64, 384, 8, 8, 96, 4, 64, 16>;
using Inst384h = Inst<384, 32, 192, 8, 8, 96, 4, 64, 32>;
// the smoke widths (32 -> 64 -> 32): 64 rows, 128 threads at 4 x 4.
using Inst32 = Inst<32, 64, 128, 4, 4, 64, 8, 32, 64>;
// the pedestrian DiT (128 -> 256 -> 128): 32 rows, 128 threads at 4 x 8,
// chunks of 128 (at its test pass's 10,240 rows 320 blocks, two an SM).
using Inst128 = Inst<128, 32, 128, 4, 8, 128, 8, 32, 32>;

struct TArgs {
  const float *x, *w1t, *b1, *w2t;
  float* out;
  long long rows, x_s, o_s;
  int d_in, d_mid;
};

template <class I>
__global__ void __launch_bounds__(I::NT, 1) mlp_f32_tiled_kernel(const TArgs a) {
  constexpr int BM = I::BM, C = I::C, D_OUT = I::D_OUT, TM = I::TM, TN = I::TN, G1N = I::G1N;
  constexpr int KS = I::KS, MS = I::MS, M1 = I::M1, R2 = I::R2, C2 = I::C2;
  constexpr int LDX = I::LDX, LDW1 = I::LDW1, LDG = I::LDG, STAGE = I::STAGE;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // x^T [d_in][BM + 4]
  float* ring = xs + a.d_in * LDX;              // [STAGES][STAGE]
  float* gs = ring + STAGES * STAGE;            // G^T [C][BM + 4]
  const int t = threadIdx.x, lane = t % 32, wp = t / 32;
  const int mg = lane % 8 + 8 * (wp % (M1 / 8)), rg = lane / 8 + 4 * (wp / (M1 / 8));
  const int cg = lane % 8 + 8 * (wp % (C2 / 8)), rg2 = lane / 8 + 4 * (wp / (C2 / 8));
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int ksl = a.d_in / KS, per = ksl + C / MS, total = (a.d_mid / C) * per;

  // slice u: chunk u / per, then its ksl GEMM1 slices (w1^T), then its C / MS
  // GEMM2 slices (w2^T), each into stage u % STAGES
  auto load_slice = [&](int u) {
    float* st = ring + (u % STAGES) * STAGE;
    const int c = u / per, r = u % per;
    if (r < ksl) {
      const float* src = a.w1t + static_cast<long long>(r) * KS * a.d_mid + c * C;
      for (int idx = t; idx < KS * (C / 4); idx += I::NT) {
        const int k = idx / (C / 4), m = 4 * (idx % (C / 4));
        copy16(st + k * LDW1 + m, src + static_cast<long long>(k) * a.d_mid + m, true);
      }
    } else {
      const float* src = a.w2t + (static_cast<long long>(c) * C + (r - ksl) * MS) * D_OUT;
      for (int idx = t; idx < MS * (D_OUT / 4); idx += I::NT)
        copy16(st + 4 * idx, src + 4 * idx, true);
    }
  };
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    if (u < total) load_slice(u);
    commit();
  }
  // x^T: eight lanes read 128 contiguous bytes of a row, zeros past the rows
  for (int idx = t; idx < BM * (a.d_in / 4); idx += I::NT) {
    const int k = 4 * (idx % 8 + 8 * (idx / (8 * BM))), r = (idx / 8) % BM;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < a.rows) v = *reinterpret_cast<const float4*>(a.x + (row0 + r) * a.x_s + k);
    xs[k * LDX + r] = v.x;
    xs[(k + 1) * LDX + r] = v.y;
    xs[(k + 2) * LDX + r] = v.z;
    xs[(k + 3) * LDX + r] = v.w;
  }

  float acc[TM][TN], mid[4][G1N];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int u = 0; u < total; ++u) {
    wait_groups<STAGES - 2>();
    __syncthreads();  // slice u (and x^T) landed; slice u - 1's stage is free
    if (u + STAGES - 1 < total) load_slice(u + STAGES - 1);
    commit();
    const float* st = ring + (u % STAGES) * STAGE;
    const int c = u / per, r = u % per;
    if (r < ksl) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < G1N; ++j) mid[i][j] = 0.0f;
      }
      const float* xt = xs + r * KS * LDX + 4 * rg;
      const float* w1t = st + 4 * mg;
#pragma unroll 8
      for (int k = 0; k < KS; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + k * LDX);
        float4 wv[G1N / 4];
#pragma unroll
        for (int jj = 0; jj < G1N / 4; ++jj)
          wv[jj] = *reinterpret_cast<const float4*>(w1t + k * LDW1 + 4 * M1 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < G1N; ++j)
            mid[i][j] = fmaf(f4(xv, i), f4(wv[j / 4], j % 4), mid[i][j]);
      }
      if (r == ksl - 1) {
#pragma unroll
        for (int j = 0; j < G1N; ++j) {
          const int m = 4 * (mg + M1 * (j / 4)) + j % 4;
          const float b = a.b1[c * C + m];
          float g[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) g[i] = gelu_exact(__fadd_rn(mid[i][j], b));
          *reinterpret_cast<float4*>(gs + m * LDG + 4 * rg) = make_float4(g[0], g[1], g[2], g[3]);
        }
      }
    } else {
      const float* w2t = st + 4 * cg;
      const float* gr = gs + (r - ksl) * MS * LDG + 4 * rg2;
#pragma unroll 4
      for (int m = 0; m < MS; ++m) {
        float4 gv[TM / 4], wv[TN / 4];
#pragma unroll
        for (int i = 0; i < TM / 4; ++i)
          gv[i] = *reinterpret_cast<const float4*>(gr + m * LDG + 4 * R2 * i);
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          wv[j] = *reinterpret_cast<const float4*>(w2t + m * D_OUT + 4 * C2 * j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float g = f4(gv[i / 4], i % 4);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(g, f4(wv[j / 4], j % 4), acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long row = row0 + 4 * (rg2 + R2 * (i / 4)) + i % 4;
    if (row >= a.rows) continue;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j)
      *reinterpret_cast<float4*>(a.out + row * a.o_s + 4 * (cg + C2 * j)) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
  }
}

template <class I>
cudaError_t launch(const TArgs& a, cudaStream_t stream) {
  static cudaError_t attr = lam_set_smem(mlp_f32_tiled_kernel<I>, 232448);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (a.rows + I::BM - 1) / I::BM;
  mlp_f32_tiled_kernel<I><<<static_cast<unsigned>(blocks), I::NT, I::smem(a.d_in), stream>>>(a);
  return cudaGetLastError();
}

template <class I>
bool takes(int d_in, int d_mid) {
  return d_in % I::KS == 0 && d_mid % I::C == 0 && I::smem(d_in) <= 232448;
}

}  // namespace tiled

}  // namespace

// x: fp32 [rows, d_in] (row stride x_s, unit stride on d_in); w1: fp32
// [d_in, d_mid] at w1[i + m * w1_s]; b1: fp32 [d_mid] contiguous; w2: fp32
// [d_mid, d_out] at w2[m + o * w2_s]; out: fp32 [rows, d_out] (row stride
// o_s). x, w1, w2 16-byte aligned and x_s, w1_s, w2_s multiples of 4; d_in,
// d_mid, d_out multiples of 16, d_out <= 512; bm rows a block (64 or 32)
// and `stages` chunk buffers (2 or 1), from the wrapper's f32_plan. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_fused_mlp_f32(const void* x, const void* w1, const void* b1, const void* w2,
                                 void* out, int rows, int d_in, int d_mid, int d_out,
                                 long long x_s, long long w1_s, long long w2_s, long long o_s,
                                 int bm, int stages, void* stream) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(x) |
                                  reinterpret_cast<unsigned long long>(w1) |
                                  reinterpret_cast<unsigned long long>(w2) |
                                  4ull * static_cast<unsigned long long>(x_s | w1_s | w2_s);
  if (rows <= 0 || d_in <= 0 || d_in % 16 || d_mid <= 0 || d_mid % 16 || d_out <= 0 ||
      d_out % 16 || d_out > 512 || (bm != 64 && bm != 32) || (stages != 1 && stages != 2) ||
      (bits & 15) || smem_bytes(bm, stages, d_in, d_out) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(w1),
               static_cast<const float*>(b1), static_cast<const float*>(w2),
               static_cast<float*>(out), rows, x_s, w1_s, w2_s, o_s, d_in, d_mid, d_out};
  auto st = static_cast<cudaStream_t>(stream);
  if (bm == 64)
    return static_cast<int>(stages == 2 ? launch_nj<4, 2>(a, st) : launch_nj<4, 1>(a, st));
  return static_cast<int>(stages == 2 ? launch_nj<2, 2>(a, st) : launch_nj<2, 1>(a, st));
}

// As lam_fused_mlp_f32, on the outer-product kernel: w1t and w2t the
// contiguous [d_in, d_mid] and [d_mid, d_out] copies of w1 and w2
// (w1t[i * d_mid + m], w2t[m * d_out + o]); out contiguous; x, w1t, w2t
// and out 16-byte aligned, x_s and o_s multiples of 4. d_out and bm (rows a
// block) those of an instance (256 and 128, 384 and 64 or 32, 128 and 32,
// 32 and 64), d_in a multiple of its k-slice, d_mid of its chunk,
// the shared memory within 232,448 bytes (the wrapper's tiled_plan);
// cudaErrorInvalidValue for the rest.
extern "C" int lam_fused_mlp_f32_tiled(const void* x, const void* w1t, const void* b1,
                                       const void* w2t, void* out, int rows, int d_in,
                                       int d_mid, int d_out, long long x_s, long long o_s,
                                       int bm, void* stream) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(x) |
                                  reinterpret_cast<unsigned long long>(w1t) |
                                  reinterpret_cast<unsigned long long>(w2t) |
                                  reinterpret_cast<unsigned long long>(out) |
                                  4ull * static_cast<unsigned long long>(x_s | o_s);
  const tiled::TArgs a{static_cast<const float*>(x), static_cast<const float*>(w1t),
                       static_cast<const float*>(b1), static_cast<const float*>(w2t),
                       static_cast<float*>(out), rows, x_s, o_s, d_in, d_mid};
  auto st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d_in <= 0 || d_mid <= 0 || (bits & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_out == 256 && bm == 128 && tiled::takes<tiled::Inst256>(d_in, d_mid))
    return static_cast<int>(tiled::launch<tiled::Inst256>(a, st));
  if (d_out == 384 && bm == 64 && tiled::takes<tiled::Inst384>(d_in, d_mid))
    return static_cast<int>(tiled::launch<tiled::Inst384>(a, st));
  if (d_out == 384 && bm == 32 && tiled::takes<tiled::Inst384h>(d_in, d_mid))
    return static_cast<int>(tiled::launch<tiled::Inst384h>(a, st));
  if (d_out == 32 && bm == 64 && tiled::takes<tiled::Inst32>(d_in, d_mid))
    return static_cast<int>(tiled::launch<tiled::Inst32>(a, st));
  if (d_out == 128 && bm == 32 && tiled::takes<tiled::Inst128>(d_in, d_mid))
    return static_cast<int>(tiled::launch<tiled::Inst128>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
