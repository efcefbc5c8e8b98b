// The DiT's whole small-L spatial block with fp32 operands, for Hopper
// (sm_90a), on the FP32 pipes (FFMA; no tensor cores, so no TF32).
//
// Replaces the fp32 instance of the Pallas TPU kernel
// lam_slide_tpu/ops/fused_spatial_block.py `_kernel` (pallas_call in
// `_fused_vjp`), which computes in x's dtype: the 4AA eval samples the DiT
// in fp32 (analysis/eval_cli.py, the registry's fp32 `test_model`). For x
// [N, L <= 8, D] in nn.Linear layout weights w1 [3D + M, D], w2 [D, D + M]:
//
//   xw   = x @ w1^T + b1                                [rows, 3D + M]
//   q, k = RoPE(RMSNorm_head(q or k) * scale) at the frame's L positions
//   attn = softmax(q k^T * scale) v per head, over the L positions
//   out  = [attn | gelu(mlp)] @ w2^T + b2                [rows, D]
//
// all in fp32, as the plain composition (ops/fused_spatial_block.py
// reference_spatial_block) computes it in fp32; sums are taken in another
// order, so results agree to a few fp32 ulps, not bit for bit.
//
// A tensor-parallel rank (parallel/tp.py) runs the same block on its slice:
// H/tp whole heads over Da = D/tp attention columns and M/tp MLP columns
// (w1 [3 Da + M/tp, D], w2 [D, Da + M/tp]); with `partial` both kernels
// write linear2's fp32 sum without b2, which the model group adds up before
// the block's one + b2.
//
// Two kernels. The outer-product kernel (namespace tiled, below) takes the
// widths it has instances of: the 4AA DiT's (D 384 at 16 x 24 and 3 x 128,
// M 768), the NBA DiT's (D 256 at 16 x 16, M 512) and the pedestrian DiT's
// (D 128 at 4 x 32, M 256), and the tensor-parallel ranks whose head group
// is an instance's (4AA at tp 2, 3, 4, NBA at tp 2, 4); the dot-product
// kernel takes the other widths the wrapper's checks accept (the smoke and
// tiny registries', the narrower ranks), as a route.
// Both sum every output and every mid in the same order, so they agree bit
// for bit.
//
// The dot-product kernel (K2-fp32's first machinery): a block of 256
// threads owns RB = 32 rows, i.e. 32 / L whole frames, and keeps their
// [RB, D] fp32 output in registers (a 16 x 16 thread grid: rows 2 ty,
// 2 ty + 1, columns tx + 16 j). The x tile stays in shared memory for the
// whole block. linear1 is never held whole (at 4AA it is 1,920 floats a
// position); linear2's K dimension is walked chunk by chunk instead:
// - per head group (`group` columns, whole heads, at most 128 unless one
//   head is wider): the group's q, k and v columns (3 x group) are computed
//   into a staging tile [RB][3 group + 4], normed and rotated in place (one
//   thread a (row, head, q|k)), attended (one thread a (row, head): L logits,
//   softmax, the AV sum written over q), then `out += attn @ w2[:, group]^T`;
// - per 32 MLP columns: their linear1 columns, + b1, the exact GELU into the
//   staging tile, then `out += gelu @ w2[:, D + m0 ..]^T`.
// The weights stream through one ring of two stages in 32-column tiles, a
// w1 tile [32][D + 4] (32 rows of w1's memory) or a w2 tile [D][36] (D runs
// of 32 floats), the next tile's cp.async copies in flight while this one's
// products run; every copy is 16 bytes, zero-filled past the rows or
// columns that exist. GEMM1 tiles: each thread forms RPT x 2 mids (columns
// tx, tx + 16), reading x and w1 as float4 along D; GEMM2 tiles add a
// tile's contribution to every output in registers, reading the staging
// tile and w2 as float4 along K. Row strides of 4 mod 32 floats keep the 16
// distinct rows a warp reads at once on distinct banks. No atomics: every
// output is summed by one thread in a fixed order (attention groups, then
// MLP chunks, K in order), so a result repeats bit for bit.
//
// What bounds both on the H100: 2 * rows * (D * (3D + M) + (D + M) * D)
// FLOPs on the FP32 pipes (67 TFLOP/s) against rows * 2D * 4 bytes:
// operations (0.14 ms at the 4AA eval's [2000, 2, 384], 0.56 at
// [8000, 2, 384], 2.56 at NBA's [20480, 8, 256]). The dot-product kernel
// reads shared memory 16 bytes for 4 FFMAs in linear1 (a thread 2 x 2 mids
// of a 32-column tile); the outer-product kernel 16 bytes for 12 or more
// (a thread 4 x 12 outputs or mids at 4AA, 8 x 8 at NBA), and its weights
// arrive by bulk copies that cost the threads no instructions.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16, TY = 16;  // thread grid: columns x rows
constexpr int RPT = 2;           // rows a thread
constexpr int RB = TY * RPT;     // rows a block
constexpr int BC = 32;           // columns a weight tile
constexpr int GS = BC + 4;       // row stride of a w2 tile
constexpr int MAXL = 8;

// The floats of one ring stage: a w1 tile or a w2 tile, whichever is larger.
__host__ __device__ inline int stage_floats(int d) {
  const int w1 = BC * (d + 4), w2 = d * GS;
  return w1 > w2 ? w1 : w2;
}

// Shared memory of a block (the wrapper's f32_smem_bytes mirrors it): the x
// tile [RB][D + 4], the staging tile [RB][3 group + 4] and two ring stages.
size_t smem_bytes(int d, int group) {
  return sizeof(float) * (static_cast<size_t>(RB) * (d + 4) +
                          static_cast<size_t>(RB) * (3 * group + 4) +
                          2 * static_cast<size_t>(stage_floats(d)));
}

struct Args {
  const float *x, *w1, *b1, *qs, *ks, *w2, *b2, *cos, *sin;
  float* out;
  long long n, w1_s, w2_s;
  int l, d, m, dh, group, frames;  // frames: whole frames a block
  int da;       // attention width: the q, k and v columns of the heads (D, or a rank's Da)
  bool partial;  // write linear2's fp32 sum without b2 (b2 unread)
  float scale;
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

// One weight tile of the stream. w1 tiles: `n` columns (at most 32) of
// linear1 whose c-th is w1 row `row(c)`, their mids written to staging
// columns `dst + c` (through the GELU for an MLP tile). w2 tiles: K columns
// k0 .. k0 + n of w2, read against staging columns `base ..`.
struct Tile {
  bool w1, gelu, last_of_group;
  int n, k0, base, dst;  // base: the first staging/K column of the tile
};

// Tile t of the stream: for each head group g of the Da attention columns,
// ceil(3 group / 32) w1 tiles (q, k, v of its heads) then ceil(group / 32)
// w2 tiles; then for each 32 MLP columns one w1 tile and one w2 tile.
__device__ __forceinline__ Tile tile_of(int t, const Args& a) {
  const int n1 = (3 * a.group + BC - 1) / BC, n2 = (a.group + BC - 1) / BC;
  const int groups = a.da / a.group, attn_tiles = groups * (n1 + n2);
  Tile tl{};
  if (t < attn_tiles) {
    const int g = t / (n1 + n2), u = t % (n1 + n2);
    if (u < n1) {
      tl.w1 = true;
      tl.base = g * a.group;  // the group's first q column of linear1
      tl.dst = u * BC;
      tl.n = min(BC, 3 * a.group - u * BC);
      tl.last_of_group = u == n1 - 1;
    } else {
      tl.k0 = g * a.group + (u - n1) * BC;
      tl.base = (u - n1) * BC;
      tl.n = min(BC, a.group - (u - n1) * BC);
    }
    return tl;
  }
  const int v = t - attn_tiles, m0 = (v / 2) * BC;
  tl.n = min(BC, a.m - m0);
  if (v % 2 == 0) {
    tl.w1 = tl.gelu = true;
    tl.base = 3 * a.da + m0;
  } else {
    tl.k0 = a.da + m0;
  }
  return tl;
}

// The w1 row of staging column c of an attention tile (q, k or v of the
// group starting at column `base`), or of an MLP tile.
__device__ __forceinline__ long long w1_row(const Tile& tl, int c, const Args& a) {
  if (tl.gelu) return tl.base + c;
  const int col = tl.dst + c, part = col / a.group;
  return static_cast<long long>(part) * a.da + tl.base + col % a.group;
}

template <int NJ>
__global__ void __launch_bounds__(THREADS) spatial_f32_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  const int xs = a.d + 4, ss = 3 * a.group + 4, k4 = a.d / 4;
  float* x_s = reinterpret_cast<float*>(smem4);  // [RB][xs]
  float* st_s = x_s + RB * xs;                   // [RB][ss]
  float* ring = st_s + RB * ss;                  // 2 x stage_floats(d)
  const int sf = stage_floats(a.d);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long item0 = static_cast<long long>(blockIdx.x) * a.frames;
  const long long items = min(static_cast<long long>(a.frames), a.n - item0);
  const int rows = static_cast<int>(items) * a.l;  // rows of this block that exist
  const long long row0 = item0 * a.l;

  auto load_tile = [&](int t, int st) {
    const Tile tl = tile_of(t, a);
    float* dst = ring + st * sf;
    if (tl.w1) {
      for (int idx = tid; idx < BC * k4; idx += THREADS) {
        const int c = idx / k4, i = 4 * (idx % k4);
        const bool valid = c < tl.n;
        copy16(&dst[c * xs + i], a.w1 + i + (valid ? w1_row(tl, c, a) : 0) * a.w1_s, valid);
      }
    } else {
      for (int idx = tid; idx < a.d * (BC / 4); idx += THREADS) {
        const int o = idx / (BC / 4), mm = 4 * (idx % (BC / 4));
        const bool valid = mm < tl.n;  // n % 4 == 0: all 4 or none
        copy16(&dst[o * GS + mm],
               a.w2 + (valid ? tl.k0 + mm : 0) + static_cast<long long>(o) * a.w2_s, valid);
      }
    }
  };

  for (int idx = tid; idx < RB * k4; idx += THREADS) {
    const int r = idx / k4, k = 4 * (idx % k4);
    const bool valid = r < rows;
    copy16(&x_s[r * xs + k], a.x + (valid ? row0 + r : 0) * a.d + k, valid);
  }
  const int n1 = (3 * a.group + BC - 1) / BC, n2 = (a.group + BC - 1) / BC;
  const int tiles = (a.da / a.group) * (n1 + n2) + 2 * ((a.m + BC - 1) / BC);
  load_tile(0, 0);
  commit();

  float acc[RPT][NJ];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.0f;

  const int heads_g = a.group / a.dh, half = a.dh / 2;
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_tile(t + 1, (t + 1) % 2);  // its stage was freed by the last barrier
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();  // tile t (and x) landed for every thread; staging writes visible
    const Tile tl = tile_of(t, a);
    const float* wt = ring + (t % 2) * sf;
    if (tl.w1) {
      // GEMM1: rows ty*RPT + r, tile columns tx and tx + 16
      float mid[RPT][2];
#pragma unroll
      for (int r = 0; r < RPT; ++r) mid[r][0] = mid[r][1] = 0.0f;
      for (int k = 0; k < a.d; k += 4) {
        float4 xv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          xv[r] = *reinterpret_cast<const float4*>(&x_s[(ty * RPT + r) * xs + k]);
        const float4 w0 = *reinterpret_cast<const float4*>(&wt[tx * xs + k]);
        const float4 w1 = *reinterpret_cast<const float4*>(&wt[(tx + TX) * xs + k]);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          mid[r][0] = dot4(xv[r], w0, mid[r][0]);
          mid[r][1] = dot4(xv[r], w1, mid[r][1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = tx + TX * e;
        if (c >= tl.n) continue;
        const float b = a.b1[w1_row(tl, c, a)];
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float v = __fadd_rn(mid[r][e], b);
          st_s[(ty * RPT + r) * ss + (tl.gelu ? c : tl.dst + c)] = tl.gelu ? gelu_exact(v) : v;
        }
      }
      if (tl.last_of_group) {
        __syncthreads();  // the group's q, k, v are whole
        // QK RMS-norm and RoPE, in place: one thread a (row, head, q|k)
        for (int task = tid; task < RB * heads_g * 2; task += THREADS) {
          const int r = task / (heads_g * 2), h = (task / 2) % heads_g, which = task % 2;
          if (r >= rows) continue;
          float* v = st_s + r * ss + which * a.group + h * a.dh;
          const float* scale = which ? a.ks : a.qs;
          const float* cs = a.cos + (r % a.l) * half;
          const float* sn = a.sin + (r % a.l) * half;
          float sq = 0.0f;
          for (int e = 0; e < a.dh; ++e) sq = fmaf(v[e], v[e], sq);
          const float rr = rsqrtf(__fadd_rn(__fdiv_rn(sq, static_cast<float>(a.dh)), 1e-6f));
          for (int p = 0; p < half; ++p) {
            const float na = __fmul_rn(__fmul_rn(v[2 * p], rr), scale[2 * p]);
            const float nb = __fmul_rn(__fmul_rn(v[2 * p + 1], rr), scale[2 * p + 1]);
            v[2 * p] = __fsub_rn(__fmul_rn(cs[p], na), __fmul_rn(sn[p], nb));
            v[2 * p + 1] = __fadd_rn(__fmul_rn(sn[p], na), __fmul_rn(cs[p], nb));
          }
        }
        __syncthreads();
        // L x L attention: one thread a (row, head); the output over q
        for (int task = tid; task < RB * heads_g; task += THREADS) {
          const int r = task / heads_g, h = task % heads_g;
          if (r >= rows) continue;
          const int f0 = r - r % a.l;  // the frame's first row
          float* q = st_s + r * ss + h * a.dh;
          float logit[MAXL];
          float mx = __int_as_float(0xff800000);  // -inf
          for (int j = 0; j < a.l; ++j) {
            const float* kj = st_s + (f0 + j) * ss + a.group + h * a.dh;
            float s = 0.0f;
            for (int e = 0; e < a.dh; ++e) s = fmaf(q[e], kj[e], s);
            logit[j] = __fmul_rn(s, a.scale);
            mx = fmaxf(mx, logit[j]);
          }
          float sum = 0.0f;
          for (int j = 0; j < a.l; ++j) {
            logit[j] = expf(__fsub_rn(logit[j], mx));
            sum = __fadd_rn(sum, logit[j]);
          }
          for (int j = 0; j < a.l; ++j) logit[j] = __fdiv_rn(logit[j], sum);
          for (int e = 0; e < a.dh; ++e) {
            float o = 0.0f;
            for (int j = 0; j < a.l; ++j)
              o = fmaf(logit[j], st_s[(f0 + j) * ss + 2 * a.group + h * a.dh + e], o);
            q[e] = o;  // q[e] is read by this thread alone, and no more
          }
        }
      }
    } else {
      // GEMM2: out[rows, columns tx + 16 j] += staging[:, base ..] @ w2 tile
      const float* src = st_s + tl.base;
#pragma unroll 2
      for (int mm = 0; mm < BC; mm += 4) {
        float4 gv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          gv[r] = *reinterpret_cast<const float4*>(&src[(ty * RPT + r) * ss + mm]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int o = tx + TX * j;
          if (o >= a.d) break;
          const float4 wv = *reinterpret_cast<const float4*>(&wt[o * GS + mm]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[r][j] = dot4(gv[r], wv, acc[r][j]);
        }
      }
    }
    __syncthreads();  // this stage and the staging tile are consumed
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = ty * RPT + r;
    if (row >= rows) break;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = tx + TX * j;
      if (o < a.d)
        a.out[(row0 + row) * a.d + o] = a.partial ? acc[r][j] : __fadd_rn(acc[r][j], a.b2[o]);
    }
  }
}

template <int NJ>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d, a.group);
  static cudaError_t attr = lam_set_smem(spatial_f32_kernel<NJ>, 232448);
  if (attr != cudaSuccess) return attr;
  const long long blocks = (a.n + a.frames - 1) / a.frames;
  spatial_f32_kernel<NJ><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The outer-product kernel (namespace tiled; the route of the widths the
// wrapper's f32_plan gives it: the instances below, the 4AA DiT's D 384 at
// head groups of 96 and 128 columns, the NBA DiT's D 256 at head groups of
// 64 and the pedestrian DiT's D 128 at head groups of 128, each with M a
// multiple of 32 and any attention width Da that is a whole number of head
// groups), in the shape of K2-fp32's outer-product kernel (fused_mlp_f32.cu). A
// block of NT threads owns BM rows (BM / L whole frames) and keeps their
// [BM, D] output in registers, a TM x D / C micro-tile a thread (C column
// groups); x^T [D][BM + 4] stays in shared memory for the whole block.
// linear1 runs in passes of P columns: a head group's q, k and v columns
// (P = 3 x GROUP), then D MLP columns at a time (a rank's M/tp below D, 192
// at 4AA tp 4, 256 at 3 x 128 tp 3, is one pass that the wrapper's stream
// pads to D with zero columns: their mids are formed and never read, so a
// short pass costs a full pass's GEMM1). Per pass:
// - GEMM1 over k-slices of KS = 32 rows of the pass's [D][P] block of the
//   w1 stream (the wrapper's pass-ordered copy of w1^T): per row of the
//   slice, TM / 4 float4 of x^T and the thread's P / C floats of w1^T
//   (float4s, and scalars where P / C is not a multiple of 4) feed
//   TM P / C FFMAs;
// - + b1 (and the exact GELU for an MLP pass) into the staging tile S^T
//   [max(3 GROUP, D)][BM + 4], column-major (a column's BM rows contiguous);
// - for a head group, the QK RMS-norm and RoPE (one thread a (row, head,
//   q|k)) and the L x L attention (one thread a (row, head), the output
//   over q) in place;
// - GEMM2: the pass's contribution to every output over m-slices of MS = 32
//   rows of w2^T (the wrapper's contiguous [D + M, D] copy): per row, TM / 4
//   float4 of S^T and D / 4C of w2^T feed TM D / C FFMAs.
// Every slice is one contiguous run of the w1 stream or of w2^T, so thread
// 0 moves it with one bulk copy (cp.async.bulk) into a ring of two stages
// of KS x max(3 GROUP, D) floats, completing on the stage's mbarrier, the
// next slice in flight under this one's products; the threads spend no
// instruction on the copies. One barrier a slice frees the stage for the
// next copy. Lane layout: a warp's eight neighbouring lanes take eight
// neighbouring column groups and its four lane octets four neighbouring row
// groups, so a warp's shared load reads 64 or 128 contiguous bytes. Every
// output and every mid is one FMA chain in the order of the dot-product
// kernel above (k in order; linear2's K dimension by head groups, then MLP
// columns, in order), whatever the head group and the row block, so the two
// routes agree bit for bit.
// 4AA (D 384): x^T and S^T 54 KB each and the ring 96 KB, one block an SM;
// the eval's 4,000 rows run 125 blocks on 132 SMs. 16-row blocks (250,
// each streaming all 4.7 MB of weights) took 0.4092 against 0.3060 ms there
// on an H100. tools/kernel_variants.py K8-fp32 times those, the other
// layouts and rings (all slower at 4AA) and the pedestrian and NBA
// instances' alternatives.
namespace tiled {

constexpr int KS = 32;     // w1^T rows a GEMM1 slice
constexpr int MS = KS;     // w2^T rows a GEMM2 slice
constexpr int STAGES = 2;  // ring stages
constexpr int MAXL = 8;

// D columns, BM rows a block, NT threads of TM rows each, head groups of
// GROUP columns; MLP passes of D columns.
template <int D_, int BM_, int NT_, int TM_, int GROUP_>
struct Inst {
  static constexpr int D = D_, BM = BM_, NT = NT_, TM = TM_, GROUP = GROUP_;
  static constexpr int PA = 3 * GROUP, PM = D;         // columns of a pass
  static constexpr int PS = PA > PM ? PA : PM;         // S^T columns
  static constexpr int LDX = BM + 4;                   // x^T and S^T column stride
  static constexpr int STAGE = KS * PS;                // floats a ring stage
  static constexpr int R = BM / TM, C = NT / R;        // row and column groups
  static constexpr int TN2 = D / C;                    // output columns a thread
  static constexpr int NA = PA / C, NM = PM / C;       // mids a thread a row of a pass
  // the wrapper's f32_tiled_smem_bytes mirrors this: x^T, S^T, the ring and
  // its mbarriers
  static constexpr size_t smem =
      sizeof(float) * (static_cast<size_t>(D + PS) * LDX + STAGES * STAGE) + 8 * STAGES;
  static_assert(R % 4 == 0 && C % 8 == 0 && TM % 4 == 0 && TN2 % 4 == 0 && PA % C == 0 &&
                    PM % C == 0 && D % 32 == 0,
                "lane layout");
  static_assert(GROUP % MS == 0 && D % GROUP == 0 && D % KS == 0, "slices");
  static_assert(smem <= 232448, "shared memory");
};

// the wrapper's F32_TILED_INSTANCES mirrors these: (D, head group) -> rows
// a block
// 4AA (D 384, M 768) at 16 x 24 and 3 x 128: 32 rows, 256 threads of 4 x 12.
using I384g96 = Inst<384, 32, 256, 4, 96>;
using I384g128 = Inst<384, 32, 256, 4, 128>;
// NBA (D 256, M 512, 16 x 16): 64 rows, 256 threads of 8 x 8.
using I256 = Inst<256, 64, 256, 8, 64>;
// pedestrian (D 128, M 256, 4 x 32): 32 rows, 256 threads of 4 x 4, head
// groups of 128 (an attention pass of 384 columns, three times D).
using I128 = Inst<128, 32, 256, 4, 128>;

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct TArgs {
  const float *x, *w1s, *b1, *qs, *ks, *w2t, *b2, *cos, *sin;
  float* out;
  long long n;     // frames
  int l, m, dh, frames;  // frames: whole frames a block
  int da;          // attention width (D, or a tensor-parallel rank's Da)
  bool partial;    // linear2's fp32 sum without b2
  float scale;
};

// Columns of a thread in a P-wide pass of C column groups: Q float4 at
// 4 (cg + C q) and S scalars at 4 C Q + cg + C s.
template <int C, int Q, int S>
struct Cols {
  static constexpr int N = 4 * Q + S, P = C * N;
  __device__ static int col(int cg, int j) {
    return j < 4 * Q ? 4 * (cg + C * (j / 4)) + j % 4 : 4 * C * Q + cg + C * (j - 4 * Q);
  }
};

// mid[i][j] += sum over the slice's KS rows k of x^T[k][TM rg + i] w[k][col j]
template <int LDX, int C, int Q, int S, int TM, int TN>
__device__ __forceinline__ void gemm1_slice(float (&mid)[TM][TN], const float* xt,
                                            const float* w, int cg) {
  using CL = Cols<C, Q, S>;
#pragma unroll 2
  for (int k = 0; k < KS; ++k) {
    float4 xv[TM / 4];
#pragma unroll
    for (int i = 0; i < TM / 4; ++i) xv[i] = *reinterpret_cast<const float4*>(xt + k * LDX + 4 * i);
    float wv[CL::N];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + k * CL::P + 4 * (cg + C * q));
      wv[4 * q] = w4.x, wv[4 * q + 1] = w4.y, wv[4 * q + 2] = w4.z, wv[4 * q + 3] = w4.w;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) wv[4 * Q + s] = w[k * CL::P + 4 * C * Q + cg + C * s];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float xi = f4(xv[i / 4], i % 4);
#pragma unroll
      for (int j = 0; j < CL::N; ++j) mid[i][j] = fmaf(xi, wv[j], mid[i][j]);
    }
  }
}

// mid + b1 (through the exact GELU for an MLP pass) into S^T; `src(c)` is
// the linear1 column (b1 index) of pass column c, for the pass's first
// `width` columns (the rest, of a short last MLP pass, ran on the stream's
// zero padding and are never read)
template <int LDX, int C, int Q, int S, int TM, int TN, class Src>
__device__ __forceinline__ void gemm1_store(const float (&mid)[TM][TN], float* st,
                                            const float* b1, bool gelu, int rg, int cg,
                                            int width, Src src) {
  using CL = Cols<C, Q, S>;
#pragma unroll
  for (int j = 0; j < CL::N; ++j) {
    const int c = CL::col(cg, j);
    const float b = c < width ? b1[src(c)] : 0.0f;
    float y[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float v = __fadd_rn(mid[i][j], b);
      y[i] = gelu ? gelu_exact(v) : v;
    }
#pragma unroll
    for (int i = 0; i < TM; i += 4)
      *reinterpret_cast<float4*>(st + c * LDX + TM * rg + i) =
          make_float4(y[i], y[i + 1], y[i + 2], y[i + 3]);
  }
}

// One head group: q, k, v at S^T columns [0, GROUP), [GROUP, 2 GROUP),
// [2 GROUP, 3 GROUP); QK RMS-norm and RoPE in place, then the L x L
// attention, its output over q. The same per-element arithmetic as the
// dot-product kernel.
template <class I>
__device__ __forceinline__ void attend(float* st, const TArgs& a, int rows) {
  constexpr int BM = I::BM, LDX = I::LDX, GROUP = I::GROUP;
  const int tid = threadIdx.x, heads_g = GROUP / a.dh, half = a.dh / 2;
  for (int task = tid; task < BM * heads_g * 2; task += I::NT) {
    const int r = task % BM, hw = task / BM, h = hw / 2, which = hw % 2;
    if (r >= rows) continue;
    float* v = st + (which * GROUP + h * a.dh) * LDX + r;  // element e at v[e * LDX]
    const float* scale = which ? a.ks : a.qs;
    const float* cs = a.cos + (r % a.l) * half;
    const float* sn = a.sin + (r % a.l) * half;
    float sq = 0.0f;
    for (int e = 0; e < a.dh; ++e) sq = fmaf(v[e * LDX], v[e * LDX], sq);
    const float rr = rsqrtf(__fadd_rn(__fdiv_rn(sq, static_cast<float>(a.dh)), 1e-6f));
    for (int p = 0; p < half; ++p) {
      const float na = __fmul_rn(__fmul_rn(v[2 * p * LDX], rr), scale[2 * p]);
      const float nb = __fmul_rn(__fmul_rn(v[(2 * p + 1) * LDX], rr), scale[2 * p + 1]);
      v[2 * p * LDX] = __fsub_rn(__fmul_rn(cs[p], na), __fmul_rn(sn[p], nb));
      v[(2 * p + 1) * LDX] = __fadd_rn(__fmul_rn(sn[p], na), __fmul_rn(cs[p], nb));
    }
  }
  __syncthreads();
  for (int task = tid; task < BM * heads_g; task += I::NT) {
    const int r = task % BM, h = task / BM;
    if (r >= rows) continue;
    const int f0 = r - r % a.l;  // the frame's first row
    float* q = st + h * a.dh * LDX + r;
    const float* kf = st + (GROUP + h * a.dh) * LDX + f0;
    const float* vf = st + (2 * GROUP + h * a.dh) * LDX + f0;
    float logit[MAXL];
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < a.l; ++j) {
      float s = 0.0f;
      for (int e = 0; e < a.dh; ++e) s = fmaf(q[e * LDX], kf[e * LDX + j], s);
      logit[j] = __fmul_rn(s, a.scale);
      mx = fmaxf(mx, logit[j]);
    }
    float sum = 0.0f;
    for (int j = 0; j < a.l; ++j) {
      logit[j] = expf(__fsub_rn(logit[j], mx));
      sum = __fadd_rn(sum, logit[j]);
    }
    for (int j = 0; j < a.l; ++j) logit[j] = __fdiv_rn(logit[j], sum);
    for (int e = 0; e < a.dh; ++e) {
      float o = 0.0f;
      for (int j = 0; j < a.l; ++j) o = fmaf(logit[j], vf[e * LDX + j], o);
      q[e * LDX] = o;  // q[e] is read by this thread alone, and no more
    }
  }
}

template <class I>
__global__ void __launch_bounds__(I::NT, 1) spatial_f32_tiled_kernel(const TArgs a) {
  constexpr int D = I::D, BM = I::BM, NT = I::NT, TM = I::TM, GROUP = I::GROUP;
  constexpr int LDX = I::LDX, STAGE = I::STAGE, C = I::C, TN2 = I::TN2;
  constexpr int PA = I::PA, PM = I::PM, NA = I::NA, NM = I::NM;
  constexpr int TN = NA > NM ? NA : NM;             // mids a thread a row
  constexpr int N1 = D / KS;                        // GEMM1 slices a pass
  constexpr int NA2 = GROUP / MS, NM2 = PM / MS;    // GEMM2 slices a pass
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // x^T [D][LDX]
  float* st = xs + D * LDX;                     // S^T [PS][LDX]
  float* ring = st + I::PS * LDX;               // [STAGES][STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);  // [STAGES]
  const int t = threadIdx.x, lane = t % 32, wp = t / 32;
  const int rg = lane / 8 + 4 * (wp / (C / 8)), cg = lane % 8 + 8 * (wp % (C / 8));
  const long long item0 = static_cast<long long>(blockIdx.x) * a.frames;
  const int rows = static_cast<int>(min(static_cast<long long>(a.frames), a.n - item0)) * a.l;
  const long long row0 = item0 * a.l;
  // head groups of the Da attention columns; MLP passes of PM columns, the
  // last `last` wide (a multiple of MS; the w1 stream pads it to PM with
  // zeros, and only its `last` columns reach GEMM2)
  const int G = a.da / GROUP, np = (a.m + PM - 1) / PM, last = a.m - (np - 1) * PM;
  const int per_attn = N1 + NA2, per_mlp = N1 + NM2;
  const int total = G * per_attn + (np - 1) * per_mlp + N1 + last / MS;

  // slice u: pass u's GEMM1 slices (KS rows of the pass's [D][P] block of
  // the w1 stream), then its GEMM2 slices (w2^T rows k0 + s MS .. + MS),
  // each one contiguous bulk copy into stage u % STAGES by thread 0
  auto load_slice = [&](int u) {
    const bool attn = u < G * per_attn;
    const int v = attn ? u : u - G * per_attn, per = attn ? per_attn : per_mlp;
    const int pass = v / per, s = v % per;
    const float* src;
    uint32_t bytes;
    if (s < N1) {
      const long long off = attn ? pass * PA : G * PA + pass * PM;
      const int p = attn ? PA : PM;
      src = a.w1s + off * D + static_cast<long long>(s) * KS * p;
      bytes = sizeof(float) * KS * p;
    } else {
      const long long k0 = (attn ? pass * GROUP : a.da + pass * PM) + (s - N1) * MS;
      src = a.w2t + k0 * D;
      bytes = sizeof(float) * MS * D;
    }
    uint64_t* bar = full + u % STAGES;
    lam_sm90::fence_proxy_async();  // the stage's earlier reads come first
    lam_sm90::mbar_arrive_expect_tx(bar, bytes);
    lam_sm90::bulk_load(ring + (u % STAGES) * STAGE, src, bytes, bar);
  };
  if (t == 0) {
    for (int i = 0; i < STAGES; ++i) lam_sm90::mbar_init(full + i, 1);
    lam_sm90::mbar_init_fence();
    for (int u = 0; u < STAGES - 1 && u < total; ++u) load_slice(u);
  }
  // x^T: eight lanes read 128 contiguous bytes of a row, zeros past the rows
  for (int idx = t; idx < BM * (D / 4); idx += NT) {
    const int k = 4 * (idx % 8 + 8 * (idx / (8 * BM))), r = (idx / 8) % BM;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows) v = *reinterpret_cast<const float4*>(a.x + (row0 + r) * D + k);
    xs[k * LDX + r] = v.x;
    xs[(k + 1) * LDX + r] = v.y;
    xs[(k + 2) * LDX + r] = v.z;
    xs[(k + 3) * LDX + r] = v.w;
  }

  float acc[TM][TN2], mid[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN2; ++j) acc[i][j] = 0.0f;
  for (int u = 0; u < total; ++u) {
    __syncthreads();  // x^T written, the mbarriers set; slice u - 1's stage and reads done
    if (t == 0 && u + STAGES - 1 < total) load_slice(u + STAGES - 1);
    lam_sm90::mbar_wait(full + u % STAGES, (u / STAGES) & 1);  // slice u landed
    const float* w = ring + (u % STAGES) * STAGE;
    const bool attn = u < G * per_attn;
    const int v = attn ? u : u - G * per_attn, per = attn ? per_attn : per_mlp;
    const int pass = v / per, s = v % per;
    if (s < N1) {
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) mid[i][j] = 0.0f;
      }
      const float* xt = xs + s * KS * LDX + TM * rg;
      if (attn)
        gemm1_slice<LDX, C, NA / 4, NA % 4, TM, TN>(mid, xt, w, cg);
      else
        gemm1_slice<LDX, C, NM / 4, NM % 4, TM, TN>(mid, xt, w, cg);
      if (s == N1 - 1) {
        if (attn) {
          gemm1_store<LDX, C, NA / 4, NA % 4, TM, TN>(mid, st, a.b1, false, rg, cg, PA,
                                                      [&](int c) {
            return (c / GROUP) * a.da + pass * GROUP + c % GROUP;
          });
          __syncthreads();  // the group's q, k, v are whole
          attend<I>(st, a, rows);
        } else {
          gemm1_store<LDX, C, NM / 4, NM % 4, TM, TN>(
              mid, st, a.b1, true, rg, cg, pass == np - 1 ? last : PM,
              [&](int c) { return 3 * a.da + pass * PM + c; });
        }
      }
    } else {
      // out += S^T[(s - N1) MS ..][rows] (x) the w2^T slice
      const float* sr = st + (s - N1) * MS * LDX + TM * rg;
#pragma unroll 2
      for (int kk = 0; kk < MS; ++kk) {
        float4 av[TM / 4];
#pragma unroll
        for (int i = 0; i < TM / 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(sr + kk * LDX + 4 * i);
        float4 wv[TN2 / 4];
#pragma unroll
        for (int q = 0; q < TN2 / 4; ++q)
          wv[q] = *reinterpret_cast<const float4*>(w + kk * D + 4 * (cg + C * q));
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float ai = f4(av[i / 4], i % 4);
#pragma unroll
          for (int j = 0; j < TN2; ++j) acc[i][j] = fmaf(ai, f4(wv[j / 4], j % 4), acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = TM * rg + i;
    if (r >= rows) continue;
#pragma unroll
    for (int q = 0; q < TN2 / 4; ++q) {
      const int o = 4 * (cg + C * q);
      float4 v = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                             acc[i][4 * q + 3]);
      if (!a.partial)
        v = make_float4(__fadd_rn(v.x, a.b2[o]), __fadd_rn(v.y, a.b2[o + 1]),
                        __fadd_rn(v.z, a.b2[o + 2]), __fadd_rn(v.w, a.b2[o + 3]));
      *reinterpret_cast<float4*>(a.out + (row0 + r) * D + o) = v;
    }
  }
}

// Whether instance I takes width d, attention width da, MLP width m, head
// group `group` and `bm` rows a block.
template <class I>
bool takes(int d, int da, int m, int group, int bm) {
  return d == I::D && da % I::GROUP == 0 && m % MS == 0 && group == I::GROUP && bm == I::BM;
}

template <class I>
cudaError_t launch(TArgs a, cudaStream_t stream) {
  static cudaError_t attr = lam_set_smem(spatial_f32_tiled_kernel<I>, 232448);
  if (attr != cudaSuccess) return attr;
  a.frames = I::BM / a.l;
  const long long blocks = (a.n + a.frames - 1) / a.frames;
  spatial_f32_tiled_kernel<I><<<static_cast<unsigned>(blocks), I::NT, I::smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tiled

}  // namespace

// x: fp32 [N, L, D] contiguous; w1: fp32 [3 Da + M, D] (row stride w1_s,
// unit column stride); b1 [3 Da + M], q/k scales [Da / H], cos/sin
// [L, dh / 2], w2 [D, Da + M] (row stride w2_s), b2 [D], all fp32 and
// contiguous where no stride is given; out fp32 [N, L, D]. Da is the
// attention width of the H heads: D for a whole block, a tensor-parallel
// rank's H/tp heads' columns for its slice (w1's rows those heads' q, k and
// v, then its MLP rows; w2's columns their attention columns, then its MLP
// columns). With `partial` out is linear2's fp32 sum without b2 (b2 is not
// read: the rank's share, which the model group adds up before the block's
// one rounding and + b2). x, w1, w2 16-byte aligned, w1_s and w2_s
// multiples of 4; D and M multiples of 16, an even head dim, `group` a
// multiple of dh and of 4 that divides Da (the wrapper's f32_plan), shared
// memory within 227 KB (D up to 438 at head groups of 128 columns). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_spatial_block_f32(const void* x, const void* w1, const void* b1,
                                     const void* qs, const void* ks, const void* w2,
                                     const void* b2, const void* cos, const void* sin,
                                     void* out, long long N, int L, int D, int M, int H,
                                     long long w1_s, long long w2_s, float scale, int group,
                                     int Da, int partial, void* stream) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(x) |
                                  reinterpret_cast<unsigned long long>(w1) |
                                  reinterpret_cast<unsigned long long>(w2) |
                                  4ull * static_cast<unsigned long long>(w1_s | w2_s);
  if (N <= 0 || L < 1 || L > MAXL || D <= 0 || D % 16 || D > 16 * 32 || M <= 0 || M % 16 ||
      Da <= 0 || Da > D || H <= 0 || Da % H || (Da / H) % 2 || group <= 0 ||
      group % (Da / H) || group % 4 || Da % group || (bits & 15) ||
      smem_bytes(D, group) > 232448 || (!partial && b2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x),   static_cast<const float*>(w1),
               static_cast<const float*>(b1),  static_cast<const float*>(qs),
               static_cast<const float*>(ks),  static_cast<const float*>(w2),
               static_cast<const float*>(b2),  static_cast<const float*>(cos),
               static_cast<const float*>(sin), static_cast<float*>(out),
               N,
               w1_s,
               w2_s,
               L,
               D,
               M,
               Da / H,
               group,
               RB / L,
               Da,
               partial != 0,
               scale};
  auto st = static_cast<cudaStream_t>(stream);
  const int nj = (D + 15) / 16;
  if (nj <= 2) return static_cast<int>(launch<2>(a, st));
  if (nj <= 8) return static_cast<int>(launch<8>(a, st));
  if (nj <= 16) return static_cast<int>(launch<16>(a, st));
  if (nj <= 24) return static_cast<int>(launch<24>(a, st));
  return static_cast<int>(launch<32>(a, st));
}

// As lam_spatial_block_f32, on the outer-product kernel: w1s the w1 stream,
// linear1's columns in the kernel's passes (each head group's q, k and v
// columns of the Da attention columns, then the MLP columns D at a time, the
// last pass zero-padded to D where M is not a multiple of D), a pass of P
// columns a contiguous [D][P] block of w1^T, the passes one after another;
// w2t the contiguous [Da + M, D] copy of w2 (w2t[k * D + o]); out
// contiguous; x, w1s, w2t and out 16-byte aligned. (D, group, bm) those of
// an instance (tiled::I*: the wrapper's f32_plan), Da a multiple of
// `group`, M a multiple of 32, an even head dim dividing `group`; with
// `partial` linear2's fp32 sum without b2 (b2 unread); cudaErrorInvalidValue
// for the rest.
extern "C" int lam_spatial_block_f32_tiled(const void* x, const void* w1s, const void* b1,
                                           const void* qs, const void* ks, const void* w2t,
                                           const void* b2, const void* cos, const void* sin,
                                           void* out, long long N, int L, int D, int M, int H,
                                           float scale, int group, int bm, int Da, int partial,
                                           void* stream) {
  const unsigned long long bits = reinterpret_cast<unsigned long long>(x) |
                                  reinterpret_cast<unsigned long long>(w1s) |
                                  reinterpret_cast<unsigned long long>(w2t) |
                                  reinterpret_cast<unsigned long long>(out);
  if (N <= 0 || L < 1 || L > tiled::MAXL || M <= 0 || Da <= 0 || Da > D || H <= 0 || Da % H ||
      (Da / H) % 2 || group <= 0 || group % (Da / H) || (bits & 15) ||
      (!partial && b2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const tiled::TArgs a{static_cast<const float*>(x),   static_cast<const float*>(w1s),
                       static_cast<const float*>(b1),  static_cast<const float*>(qs),
                       static_cast<const float*>(ks),  static_cast<const float*>(w2t),
                       static_cast<const float*>(b2),  static_cast<const float*>(cos),
                       static_cast<const float*>(sin), static_cast<float*>(out),
                       N, L, M, Da / H, 0, Da, partial != 0, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (tiled::takes<tiled::I384g96>(D, Da, M, group, bm))
    return static_cast<int>(tiled::launch<tiled::I384g96>(a, st));
  if (tiled::takes<tiled::I384g128>(D, Da, M, group, bm))
    return static_cast<int>(tiled::launch<tiled::I384g128>(a, st));
  if (tiled::takes<tiled::I256>(D, Da, M, group, bm))
    return static_cast<int>(tiled::launch<tiled::I256>(a, st));
  if (tiled::takes<tiled::I128>(D, Da, M, group, bm))
    return static_cast<int>(tiled::launch<tiled::I128>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
