// Attention over short unmasked self-attention axes (8 < n < 128), forward
// and backward, fp32 in / fp32 out, for Hopper (sm_90a), on the FP32 pipes
// (FFMA; no tensor cores, so no TF32).
//
// Replaces the fp32 instances of the Pallas TPU kernels
// lam_slide_tpu/ops/short_attention.py `_short_fwd_kernel` and
// `_short_bwd_kernel`, which the fp32 DiT of the MD17 test pass (forward)
// and the fp32 stage-2 training of both registries (forward and backward)
// run on their temporal axis (T = 30, or 16 at the 4AA smoke width).
// Numerics of `_scores` (short_attention.py:73-80) in fp32: logits q k^T *
// scale in fp32, the softmax in fp32 (its `astype(v.dtype)` of the weights
// is a no-op), fp32 accumulation of the AV product; the backward's
// `astype` roundings of P and dS are no-ops in fp32 too. The TPU kernels
// pack several sequences into one block-diagonal tile; these compute the
// same function per sequence.
//
// Both kernels are persistent blocks over items, an item one batch row's
// group of `hg` heads (the wrapper's plan: f32_fwd_plan / f32_bwd_plan in
// ops/short_attention.py). A batch row of the packed [B, n, H*dh] operands
// holds all its heads in one contiguous row, so an item's rows are copied
// whole (the group's hg * dh floats of each of n rows) by cp.async, 16 bytes
// a copy where dh % 4 == 0 and every base and stride is 16-byte aligned
// (VEC), else 4; q/k/v may be strided views (the DiT's v is a view of
// linear1's output). In shared memory head hh of a row sits at column
// hh * dp (dh zero-padded to dp, a multiple of 4), rows `ld` floats apart
// (hg * dp rounded up to 32, plus 4: the float4s of 8 consecutive rows fall
// on distinct banks). One stage: other blocks on the SM hide an item's
// copies, and small blocks on one stage put more warps on an SM, which the
// latency-bound loops below need more than an overlap of copies with
// compute (two stages lost: tools/kernel_variants.py K9-fp32). Shared
// memory is zeroed once at the start, so padding columns and rows past n,
// which no copy writes, stay zero. No atomics: every output element has one
// writer that sums in a fixed order, so a second call repeats bit for bit.
//
// Forward: a thread owns R query rows of one head (R = 2 for n <= 64, else
// 1: rows gi and gi + G, G = ceil(n / R)) and forms each row's logits once,
// kept in registers (NKP >= n of them a row): per 4 columns of dp a float4
// of its rows of q and, per key, one broadcast float4 of k for 4 R FFMAs;
// then the row max, p = exp(s - max) in place, l summed in key order, and
// per 4 columns the AV product (one float4 of v a key for 4 R FFMAs) times
// __frcp_rn(l): the rounding points of the warp-an-item kernel this
// replaces (the logit rounded after the scale, l in key order, 1 / l at the
// end), so its results are the same bits. The output is written over the
// thread's own q rows in shared memory, then the item's rows go out whole.
//
// Backward: per item, in query chunks of qc rows (all np = ceil4(n) rows at
// n <= 64, else 64), three phases between barriers:
// - products: S = Q K^T * scale and dP = dO V^T, formed once, by 4 x 4
//   blocks (a thread's queries bi + qc/4 r, strided so a warp reads distinct
//   rows, its keys 4 bj + u, broadcast) into shared memory query-major;
// - statistics, a thread a row: m = max S, e = exp(S - m), l = sum e and
//   sum e dP in key order, delta = (sum e dP) / l by 1 / l; then P = e / l
//   and dS = P (dP - delta) * scale in place (zero past n): the rounding
//   points of the kernel this replaces;
// - grads as 4 x 4 outer-product tiles from shared memory: dV = P^T dO and
//   dK = dS^T Q (a thread 4 keys x 4 columns of both, one tile or two, kept
//   in registers across chunks, summed over queries in order), dQ = dS K (4
//   queries x 4 columns, summed over keys in order). Five products, not the
//   ~10 n^2 dh FMAs of forming S four times and dP three.
//
// What bounds them on the H100: at [12288, 30, 256] with 16 heads x dh 16
// the forward moves 4 x 377 MB of q/k/v/o (0.45 ms at 3.35 TB/s) for ~11
// GFLOP of FFMA: bytes; the backward moves 7 x 377 MB (0.79 ms) for ~31
// GFLOP of five products on 32 x 32 tiles (0.47 ms at 67 TFLOP/s): bytes.

#include <math_constants.h>

#include <initializer_list>

#include "common.cuh"
#include "flash_tiles.cuh"

namespace {

using lam_flash::cp_async16;
using lam_flash::cp_async4;
using lam_flash::f4;
using lam_flash::wide_dot4;

constexpr int MAX_THREADS = 256;
constexpr size_t SMEM_MAX = 232448;  // the most dynamic shared memory an H100 block takes

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride (floats) of a staged tile of hg heads of dp columns.
__host__ __device__ constexpr int tile_ld(int hg, int dp) { return round_up(hg * dp, 32) + 4; }

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of heads [h0, h0 + nh) of one sequence (src at head h0, row
// stride sn, heads dh floats apart) into a tile of row stride ld with head
// hh at column hh * dp, by cp.async: 16 bytes a copy under VEC (then dp ==
// dh and a row's copies land side by side), else 4. A thread walks its
// copies by steps of the block, without a division a copy.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int dp, const float* src,
                                           long long sn, int n, int nh, int dh) {
  constexpr int W = VEC ? 4 : 1;
  const int row = nh * dh / W, dr = blockDim.x / row, dc = blockDim.x - dr * row;
  int r = threadIdx.x / row, p = threadIdx.x - r * row;
  while (r < n) {
    const int col = W * p;
    if constexpr (VEC)
      cp_async16(dst + r * ld + col, src + r * sn + col, true);
    else
      cp_async4(dst + r * ld + col + col / dh * (dp - dh), src + r * sn + col, true);
    r += dr, p += dc;
    if (p >= row) p -= row, ++r;
  }
}

// The reverse for the forward's output: rows [0, n) of a tile to memory.
template <bool VEC>
__device__ __forceinline__ void write_rows(float* dst, long long sn, const float* src, int ld,
                                           int dp, int n, int nh, int dh) {
  constexpr int W = VEC ? 4 : 1;
  const int row = nh * dh / W, dr = blockDim.x / row, dc = blockDim.x - dr * row;
  int r = threadIdx.x / row, p = threadIdx.x - r * row;
  while (r < n) {
    const int col = W * p;
    if constexpr (VEC)
      *reinterpret_cast<float4*>(dst + r * sn + col) =
          *reinterpret_cast<const float4*>(src + r * ld + col);
    else
      dst[r * sn + col] = src[r * ld + col + col / dh * (dp - dh)];
    r += dr, p += dc;
    if (p >= row) p -= row, ++r;
  }
}

// One item: batch row b, heads [h0, h0 + nh).
struct Item {
  long long b;
  int h0, nh;
};

__device__ __forceinline__ Item item_of(long long item, int H, int hg) {
  const int groups = (H + hg - 1) / hg;
  const long long b = item / groups;
  const int h0 = static_cast<int>(item - b * groups) * hg;
  return {b, h0, min(hg, H - h0)};
}

namespace fwd {

struct Args {
  const float *q, *k, *v;
  float* o;
  long long q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn;
  int B, H, n, dh, hg;
  int dp, g, ld;  // padded dh, query rows a thread group spans (G), tile row stride
  float scale;
};

// Rows of one staged tile: G * R (a thread's last row may pass n).
template <int R>
__host__ __device__ constexpr int tile_rows(int n) { return round_up(n, R); }

// Query rows gi + G r (r < R) of head hh: logits, softmax, AV product, the
// output written over the thread's own rows of Qs.
template <int NKP, int R>
__device__ __forceinline__ void attend(float* Qs, const float* Ks, const float* Vs,
                                       const Args& a, int hh, int gi) {
  const int col = hh * a.dp;
  float s[R][NKP];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NKP; ++j) s[r][j] = 0.0f;
  for (int c = 0; c < a.dp; c += 4) {
    float4 qv[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      qv[r] = *reinterpret_cast<const float4*>(Qs + (gi + a.g * r) * a.ld + col + c);
#pragma unroll
    for (int j = 0; j < NKP; ++j) {
      if (j >= a.n) break;
      const float4 kv = *reinterpret_cast<const float4*>(Ks + j * a.ld + col + c);
#pragma unroll
      for (int r = 0; r < R; ++r) s[r][j] = wide_dot4(qv[r], kv, s[r][j]);
    }
  }
  float inv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // the row max (exact in any order) in eight interleaved chains, then a
    // tree; -inf past n
    float t[8];
#pragma unroll
    for (int j = 0; j < NKP; ++j) {
      s[r][j] = j < a.n ? __fmul_rn(s[r][j], a.scale) : -CUDART_INF_F;
      t[j % 8] = j < 8 ? s[r][j] : fmaxf(t[j % 8], s[r][j]);
    }
#pragma unroll
    for (int w = 4; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    const float m = t[0];
    float l = 0.0f;
#pragma unroll
    for (int j = 0; j < NKP; ++j) {
      if (j >= a.n) break;
      s[r][j] = expf(__fsub_rn(s[r][j], m));
      l = __fadd_rn(l, s[r][j]);
    }
    inv[r] = __frcp_rn(l);
  }
  for (int c = 0; c < a.dp; c += 4) {
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < NKP; ++j) {
      if (j >= a.n) break;
      const float4 vv = *reinterpret_cast<const float4*>(Vs + j * a.ld + col + c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r].x = fmaf(s[r][j], vv.x, acc[r].x);
        acc[r].y = fmaf(s[r][j], vv.y, acc[r].y);
        acc[r].z = fmaf(s[r][j], vv.z, acc[r].z);
        acc[r].w = fmaf(s[r][j], vv.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<float4*>(Qs + (gi + a.g * r) * a.ld + col + c) =
          make_float4(__fmul_rn(acc[r].x, inv[r]), __fmul_rn(acc[r].y, inv[r]),
                      __fmul_rn(acc[r].z, inv[r]), __fmul_rn(acc[r].w, inv[r]));
  }
}

// At most 128 registers at NKP 32 and 168 past it (a row's 128 logits, or
// two rows' 64, and the rest): left to itself ptxas takes 254 there, which
// leaves 64-thread blocks at n 33..64 four an SM instead of five and cost
// them a quarter of their time on an H100. The cap holds up to 256 threads
// a block.
template <int NKP, int R, bool VEC>
__global__ void __maxnreg__(NKP == 32 ? 128 : 168) short_fwd_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float fs[];
  const int tile = tile_rows<R>(a.n) * a.ld, stage = 3 * tile;
  for (int i = threadIdx.x; i < stage; i += blockDim.x) fs[i] = 0.0f;
  __syncthreads();  // zeroed before any copy lands
  const long long items = static_cast<long long>(a.B) * ((a.H + a.hg - 1) / a.hg);
  auto load = [&](long long item, float* base) {
    const Item it = item_of(item, a.H, a.hg);
    const long long col = static_cast<long long>(it.h0) * a.dh;
    stage_rows<VEC>(base, a.ld, a.dp, a.q + it.b * a.q_sb + col, a.q_sn, a.n, it.nh, a.dh);
    stage_rows<VEC>(base + tile, a.ld, a.dp, a.k + it.b * a.k_sb + col, a.k_sn, a.n, it.nh, a.dh);
    stage_rows<VEC>(base + 2 * tile, a.ld, a.dp, a.v + it.b * a.v_sb + col, a.v_sn, a.n, it.nh,
                    a.dh);
  };
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    float* const Qs = fs;  // the item's tiles: q, k, v (and dO) from here
    __syncthreads();  // the previous item's reads of shared memory are done
    load(item, Qs);
    commit();
    wait_group<0>();
    __syncthreads();  // this item's rows landed
    for (int u = threadIdx.x; u < a.hg * a.g; u += blockDim.x)
      attend<NKP, R>(Qs, Qs + tile, Qs + 2 * tile, a, u / a.g, u % a.g);
    __syncthreads();  // every output row is in Qs
    const Item at = item_of(item, a.H, a.hg);
    write_rows<VEC>(a.o + at.b * a.o_sb + static_cast<long long>(at.h0) * a.dh, a.o_sn, Qs,
                    a.ld, a.dp, a.n, at.nh, a.dh);
  }
}

template <int NKP, int R, bool VEC>
cudaError_t launch(Args a, int threads, cudaStream_t stream) {
  a.g = (a.n + R - 1) / R;
  const size_t smem = sizeof(float) * 3 * tile_rows<R>(a.n) * a.ld;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  static cudaError_t attr = lam_set_smem(short_fwd_f32_kernel<NKP, R, VEC>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const long long items = static_cast<long long>(a.B) * ((a.H + a.hg - 1) / a.hg);
  const int grid = lam_persistent_grid(short_fwd_f32_kernel<NKP, R, VEC>, threads, smem, items);
  short_fwd_f32_kernel<NKP, R, VEC><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// Logits a row (32, 64 or 128, at least n) and query rows a thread (2 at n
// <= 64, where two rows' logits fit the registers, else 1).
template <bool VEC>
cudaError_t launch_n(const Args& a, int threads, cudaStream_t stream) {
  if (a.n <= 32) return launch<32, 2, VEC>(a, threads, stream);
  if (a.n <= 64) return launch<64, 2, VEC>(a, threads, stream);
  return launch<128, 1, VEC>(a, threads, stream);
}

}  // namespace fwd

namespace bwd {

struct Args {
  const float *q, *k, *v, *g;
  float *dq, *dk, *dv;
  long long s[8];  // (batch, seq) strides of q, k, v, g
  long long o_sb, o_sn;
  int B, H, n, dh, hg;
  int dp, np, qc, nr, ld, ldp, hs;  // see geometry()
  float scale;
};

// dp: dh padded to 4; np: n padded to 4 (keys and the S/dP row length); qc:
// query rows a chunk; nr: staged rows (whole chunks); ld: tile row stride;
// ldp: S/dP row stride (ldp / 4 odd, so a warp's float4s of consecutive rows
// fall on distinct banks); hs: S/dP floats a head (qc ldp, plus 4 to skew
// the heads' banks).
__host__ __device__ inline void geometry(Args& a) {
  a.dp = round_up(a.dh, 4);
  a.np = round_up(a.n, 4);
  a.qc = a.np <= 64 ? a.np : 64;
  a.nr = round_up(a.np, a.qc);
  a.ld = tile_ld(a.hg, a.dp);
  a.ldp = (a.np / 4) % 2 ? a.np : a.np + 4;
  a.hs = a.qc * a.ldp + 4;
}

__host__ __device__ inline size_t smem_floats(const Args& a) {
  return 4 * static_cast<size_t>(a.nr) * a.ld + 2 * static_cast<size_t>(a.hg) * a.hs;
}

// S = Q K^T * scale and dP = dO V^T of the chunk's query rows [i0, i0 + qc)
// against all np keys, into Sb / Db (query-major, row stride ldp, head
// stride hs). Block (hh, bi, bj): queries bi + qc/4 r, keys 4 bj + u.
__device__ __forceinline__ void products(const float* Qs, const float* Ks, const float* Vs,
                                         const float* Gs, float* Sb, float* Db, const Args& a,
                                         int i0) {
  const int qb = a.qc / 4, kb = a.np / 4;
  for (int blk = threadIdx.x; blk < a.hg * qb * kb; blk += blockDim.x) {
    const int bi = blk % qb, t = blk / qb, bj = t % kb, hh = t / kb;
    const int col = hh * a.dp;
    float s[4][4], p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) s[r][u] = p[r][u] = 0.0f;
    for (int d = 0; d < a.dp; d += 4) {
      float4 x[4], y[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[r] = *reinterpret_cast<const float4*>(Qs + (i0 + bi + qb * r) * a.ld + col + d);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        y[u] = *reinterpret_cast<const float4*>(Ks + (4 * bj + u) * a.ld + col + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[r][u] = wide_dot4(x[r], y[u], s[r][u]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[r] = *reinterpret_cast<const float4*>(Gs + (i0 + bi + qb * r) * a.ld + col + d);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        y[u] = *reinterpret_cast<const float4*>(Vs + (4 * bj + u) * a.ld + col + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) p[r][u] = wide_dot4(x[r], y[u], p[r][u]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int off = hh * a.hs + (bi + qb * r) * a.ldp + 4 * bj;
      *reinterpret_cast<float4*>(Sb + off) =
          make_float4(__fmul_rn(s[r][0], a.scale), __fmul_rn(s[r][1], a.scale),
                      __fmul_rn(s[r][2], a.scale), __fmul_rn(s[r][3], a.scale));
      *reinterpret_cast<float4*>(Db + off) = make_float4(p[r][0], p[r][1], p[r][2], p[r][3]);
    }
  }
}

// A thread a valid query row of the chunk: the row statistics, then P and
// dS over S and dP in place (zero at keys past n).
__device__ __forceinline__ void statistics(float* Sb, float* Db, const Args& a, int i0) {
  const int rows = min(a.qc, a.n - i0);
  for (int u = threadIdx.x; u < a.hg * a.qc; u += blockDim.x) {
    const int hh = u / a.qc, r = u - hh * a.qc;
    if (r >= rows) continue;
    float4* S = reinterpret_cast<float4*>(Sb + hh * a.hs + r * a.ldp);
    float4* D = reinterpret_cast<float4*>(Db + hh * a.hs + r * a.ldp);
    float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int j = 0; j < a.n; j += 4) {  // the max (exact in any order) in four chains
      const float4 x = S[j / 4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j + e < a.n) mx[e] = fmaxf(mx[e], f4(x, e));
    }
    const float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    float l = 0.0f, edp = 0.0f;
    for (int j = 0; j < a.n; j += 4) {
      const float4 x = S[j / 4], y = D[j / 4];
      float ev[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ev[e] = 0.0f;
        if (j + e < a.n) {
          ev[e] = expf(__fsub_rn(f4(x, e), m));
          l = __fadd_rn(l, ev[e]);
          edp = fmaf(ev[e], f4(y, e), edp);
        }
      }
      S[j / 4] = make_float4(ev[0], ev[1], ev[2], ev[3]);
    }
    const float il = __frcp_rn(l), delta = __fmul_rn(edp, il);
    for (int j = 0; j < a.np; j += 4) {
      const float4 x = S[j / 4], y = D[j / 4];
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ds[e] = 0.0f;
        if (j + e < a.n) {
          p[e] = __fmul_rn(f4(x, e), il);
          ds[e] = __fmul_rn(__fmul_rn(p[e], __fsub_rn(f4(y, e), delta)), a.scale);
        }
      }
      S[j / 4] = make_float4(p[0], p[1], p[2], p[3]);
      D[j / 4] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
  }
}

// acc[r][c] += w_r * x_c
__device__ __forceinline__ void outer(float (&acc)[4][4], const float4 w, const float4 x) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float wr = f4(w, r);
    acc[r][0] = fmaf(wr, x.x, acc[r][0]);
    acc[r][1] = fmaf(wr, x.y, acc[r][1]);
    acc[r][2] = fmaf(wr, x.z, acc[r][2]);
    acc[r][3] = fmaf(wr, x.w, acc[r][3]);
  }
}

// 4 rows x 4 columns of an output: rows row0 + r < n, columns 4 cg + c < dh
// of head h0 + hh.
template <bool VEC>
__device__ __forceinline__ void store_tile(float* out, const Args& a, const Item& it, int hh,
                                           int cg, int row0, const float (&acc)[4][4]) {
  float* base = out + it.b * a.o_sb + static_cast<long long>(it.h0 + hh) * a.dh + 4 * cg;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= a.n) continue;
    float* p = base + (row0 + r) * a.o_sn;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(p) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * cg + c < a.dh) p[c] = acc[r][c];
    }
  }
}

// W: dK/dV tiles a thread (1, or 2 where the item has more tiles than the
// block threads). At most 160 registers at W 1 and 216 at W 2, which hold
// 256-thread blocks: left to itself ptxas spilled the 4-byte-copy instance
// at W 1.
template <int W, bool VEC>
__global__ void __maxnreg__(W == 1 ? 160 : 216) short_bwd_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float fs[];
  const int tile = a.nr * a.ld, stage = 4 * tile;
  float* Sb = fs + stage;
  float* Db = Sb + a.hg * a.hs;
  for (int i = threadIdx.x; i < static_cast<int>(smem_floats(a)); i += blockDim.x) fs[i] = 0.0f;
  __syncthreads();  // zeroed before any copy lands
  const long long items = static_cast<long long>(a.B) * ((a.H + a.hg - 1) / a.hg);
  const int cgs = a.dp / 4, kv_units = a.hg * (a.np / 4) * cgs;
  const int q_units = a.hg * (a.qc / 4) * cgs;
  auto load = [&](long long item, float* base) {
    const Item it = item_of(item, a.H, a.hg);
    const long long col = static_cast<long long>(it.h0) * a.dh;
    const float* src[4] = {a.q, a.k, a.v, a.g};
#pragma unroll
    for (int x = 0; x < 4; ++x)
      stage_rows<VEC>(base + x * tile, a.ld, a.dp, src[x] + it.b * a.s[2 * x] + col,
                      a.s[2 * x + 1], a.n, it.nh, a.dh);
  };
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    float* const Qs = fs;  // the item's tiles: q, k, v (and dO) from here
    __syncthreads();  // the previous item's reads of shared memory are done
    load(item, Qs);
    commit();
    wait_group<0>();
    __syncthreads();  // this item's rows landed
    const float *Ks = Qs + tile, *Vs = Ks + tile, *Gs = Vs + tile;
    const Item at = item_of(item, a.H, a.hg);
    float dk[W][4][4], dv[W][4][4];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) dk[w][r][c] = dv[w][r][c] = 0.0f;
    for (int i0 = 0; i0 < a.n; i0 += a.qc) {
      if (i0 > 0) __syncthreads();  // the previous chunk's P and dS are consumed
      products(Qs, Ks, Vs, Gs, Sb, Db, a, i0);
      __syncthreads();
      statistics(Sb, Db, a, i0);
      __syncthreads();
      const int rows = min(a.qc, a.n - i0);
      // dV += P^T dO, dK += dS^T Q: tile (kg, hh, cg), keys 4 kg + r
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int u = threadIdx.x + w * blockDim.x;
        if (u >= kv_units) continue;
        const int cg = u % cgs, t = u / cgs, hh = t % a.hg, kg = t / a.hg;
        const float* P = Sb + hh * a.hs + 4 * kg;
        const float* dS = Db + hh * a.hs + 4 * kg;
        const int col = hh * a.dp + 4 * cg;
#pragma unroll 2
        for (int i = 0; i < rows; ++i) {
          const float4 o = *reinterpret_cast<const float4*>(Gs + (i0 + i) * a.ld + col);
          const float4 x = *reinterpret_cast<const float4*>(Qs + (i0 + i) * a.ld + col);
          outer(dv[w], *reinterpret_cast<const float4*>(P + i * a.ldp), o);
          outer(dk[w], *reinterpret_cast<const float4*>(dS + i * a.ldp), x);
        }
      }
      // dQ = dS K: tile (qg, hh, cg), the chunk's queries 4 qg + r
      for (int u = threadIdx.x; u < q_units; u += blockDim.x) {
        const int cg = u % cgs, t = u / cgs, hh = t % a.hg, qg = t / a.hg;
        const float* dS = Db + hh * a.hs + 4 * qg * a.ldp;
        const int col = hh * a.dp + 4 * cg;
        float dq[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) dq[r][c] = 0.0f;
#pragma unroll 2
        for (int j = 0; j < a.np; j += 4) {
          float4 w4[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) w4[r] = *reinterpret_cast<const float4*>(dS + r * a.ldp + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 kr = *reinterpret_cast<const float4*>(Ks + (j + e) * a.ld + col);
            outer(dq, make_float4(f4(w4[0], e), f4(w4[1], e), f4(w4[2], e), f4(w4[3], e)), kr);
          }
        }
        if (hh < at.nh) store_tile<VEC>(a.dq, a, at, hh, cg, i0 + 4 * qg, dq);
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int u = threadIdx.x + w * blockDim.x;
      if (u >= kv_units) continue;
      const int cg = u % cgs, t = u / cgs, hh = t % a.hg, kg = t / a.hg;
      if (hh >= at.nh) continue;
      store_tile<VEC>(a.dv, a, at, hh, cg, 4 * kg, dv[w]);
      store_tile<VEC>(a.dk, a, at, hh, cg, 4 * kg, dk[w]);
    }
  }
}

template <int W, bool VEC>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a);
  static cudaError_t attr = lam_set_smem(short_bwd_f32_kernel<W, VEC>, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const long long items = static_cast<long long>(a.B) * ((a.H + a.hg - 1) / a.hg);
  const int grid = lam_persistent_grid(short_bwd_f32_kernel<W, VEC>, threads, smem, items);
  short_bwd_f32_kernel<W, VEC><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_w(const Args& a, int threads, cudaStream_t stream) {
  const int tiles = a.hg * (a.np / 4) * (a.dp / 4);
  if (sizeof(float) * smem_floats(a) > SMEM_MAX || tiles > 2 * threads)
    return cudaErrorInvalidValue;
  return tiles <= threads ? launch<1, VEC>(a, threads, stream) : launch<2, VEC>(a, threads, stream);
}

}  // namespace bwd

bool bad_geometry(int B, int H, int n, int dh, int hg, int threads) {
  return B <= 0 || H <= 0 || n <= 8 || n >= 128 || dh <= 0 || dh > 64 || hg < 1 || hg > H ||
         threads < 32 || threads > MAX_THREADS || threads % 32 != 0;
}

// 16-byte copies where every base and stride allows them and dh % 4 == 0
bool vec_ok(std::initializer_list<const void*> ptrs, std::initializer_list<long long> strides,
            int dh) {
  unsigned long long bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<unsigned long long>(p);
  for (long long x : strides) bits |= 4ull * static_cast<unsigned long long>(x);
  return (bits & 15) == 0 && dh % 4 == 0;
}

}  // namespace

// q, k, v, o: fp32 packed [B, n, H*dh] with element strides (batch, seq) and
// unit stride on H*dh; 8 < n < 128, dh <= 64; hg heads an item and threads
// a block (a multiple of 32, at most 256) from the wrapper's f32_fwd_plan.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what it does not
// take.
extern "C" int lam_short_attention_fwd_f32(const void* q, const void* k, const void* v,
                                           void* o, int B, int H, int n, int dh, int hg,
                                           int threads, long long q_sb, long long q_sn,
                                           long long k_sb, long long k_sn, long long v_sb,
                                           long long v_sn, long long o_sb, long long o_sn,
                                           float scale, void* stream) {
  if (bad_geometry(B, H, n, dh, hg, threads)) return static_cast<int>(cudaErrorInvalidValue);
  fwd::Args a{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<float*>(o), q_sb, q_sn, k_sb, k_sn,
              v_sb, v_sn, o_sb, o_sn, B, H, n, dh, hg};
  a.dp = round_up(dh, 4);
  a.ld = tile_ld(hg, a.dp);
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok({q, k, v, o}, {q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, o_sb, o_sn}, dh);
  return static_cast<int>(vec ? fwd::launch_n<true>(a, threads, st)
                              : fwd::launch_n<false>(a, threads, st));
}

// The backward: q, k, v, g (the output gradient, in q's dtype) fp32 packed
// [B, n, H*dh] with element strides (batch, seq) in `strides` in the order
// q, k, v, g (8 values) and unit stride on H*dh; dq, dk, dv fp32 packed
// [B, n, H*dh] sharing the strides (o_sb, o_sn); 8 < n < 128, dh <= 64; hg
// and threads from the wrapper's f32_bwd_plan. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_short_attention_bwd_f32(const void* q, const void* k, const void* v,
                                           const void* g, void* dq, void* dk, void* dv, int B,
                                           int H, int n, int dh, int hg, int threads,
                                           const long long* strides, long long o_sb,
                                           long long o_sn, float scale, void* stream) {
  if (bad_geometry(B, H, n, dh, hg, threads)) return static_cast<int>(cudaErrorInvalidValue);
  bwd::Args a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.g = static_cast<const float*>(g);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  for (int i = 0; i < 8; ++i) a.s[i] = strides[i];
  a.o_sb = o_sb;
  a.o_sn = o_sn;
  a.B = B, a.H = H, a.n = n, a.dh = dh, a.hg = hg;
  a.scale = scale;
  bwd::geometry(a);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = vec_ok({q, k, v, g, dq, dk, dv},
                          {strides[0], strides[1], strides[2], strides[3], strides[4],
                           strides[5], strides[6], strides[7], o_sb, o_sn},
                          dh);
  return static_cast<int>(vec ? bwd::launch_w<true>(a, threads, st)
                              : bwd::launch_w<false>(a, threads, st));
}
