// The DiT's whole small-L spatial block for Hopper (sm_90a), bf16: the
// first port's kernel, now the WMMA route of K8.
//
// Replaces the Pallas TPU kernel lam_slide_tpu/ops/fused_spatial_block.py
// `_kernel` (pallas_call in `_fused_vjp`): ParallelMLPAttention over the
// L <= 8 latents of each frame, every layer of the DiT
// (models/latent_dit.py, n <= packed_threshold):
//
//   xw   = bf16(bf16(x @ w1^T) + b1)                      [rows, 3D + M]
//   q, k = RoPE(RMSNorm_head(q or k)) at the frame's L positions
//   attn = softmax(q k^T * scale) v per head, over the L positions
//   out  = bf16(bf16([attn | gelu(mlp)] @ w2^T) + b2)      [rows, D]
//
// K8 has two routes; the wrapper (ops/fused_spatial_block.py) picks one by
// `sm90_plan`, from the widths alone:
// 1. `lam_spatial_block_sm90` (fused_spatial_block_sm90.cu), TMA-fed wgmma
//    GEMMs with linear1 computed once a row, for the (D, dh) it has
//    instances of: every width of the composites (the 4AA DiT at 16 x 24
//    and 3 x 128, NBA, pedestrian) at every L;
// 2. `lam_spatial_block_wmma`, this file, for every other width the wrapper
//    accepts (the tiny test registries' hidden 16 and 32 with dh 4 to 8):
//    one thread block (8 warps) = FB = 32 / L frames, i.e. up to 32
//    positions, padded to 32 rows with zeros. The x tile (32 x D) and the
//    whole linear1 output (32 x (3D + M)) stay in dynamic shared memory;
//    only x is read from and the output written to device memory. Both
//    products run on the tensor cores through WMMA (mma.sync: bf16
//    operands, fp32 accumulation), each warp taking 16-column strips for
//    both 16-row halves so a weight fragment is loaded once for 32 rows; the
//    weights stay in torch nn.Linear layout and are read as column-major
//    fragments from L2. Per head the warps then norm and rotate q/k in place
//    (lam_rmsnorm_rope), take the L x L softmax attention with lanes over dh
//    (any even dh that divides D) and write attn over q; GELU (real erff)
//    runs in place on the MLP columns; linear2 reads [attn | gelu] straight
//    from there. At the 4AA widths it took 1.08 ms where the bound is 0.038
//    (PERF.md): every block reads all of w1 and w2 again as fragments, with
//    no staging and no pipelining, and 8 of 32 lanes idle at dh 24.
//
// What bounds it on the H100: 2 * rows * D * (3D + M + D + M) FLOPs against
// 1.5 KB of x and output per position at the 4AA widths, a compute-bound
// pair of GEMMs.
//
// Numerics follow the plain composition (ops/fused_spatial_block.py
// reference_spatial_block) op for op: bf16 rounding after each matmul and
// bias add, fp32 norm statistics, q*k products rounded to bf16 and summed
// in fp32, fp32 softmax with the weights rounded to bf16, fp32 AV rounded
// once, GELU in fp32 rounded once. Sums are taken in another order than
// PyTorch's, so a bf16 rounding can land one ulp apart.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 32;  // positions per block (two 16-row WMMA halves)
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int LDC = 16 + 4;  // per-warp fp32 scratch row stride
constexpr int MAXL = 8;
constexpr float EPS = 1e-6f;

struct Layout {
  int ldx, ldw;
  size_t x_off, w_off, c_off, bytes;
  __host__ __device__ Layout(int d, int w) {
    ldx = d + 8;
    ldw = w + 8;
    x_off = 0;
    w_off = lam_align128(x_off + ROWS * ldx * sizeof(bf16));
    c_off = lam_align128(w_off + ROWS * ldw * sizeof(bf16));
    bytes = lam_align128(c_off + NWARPS * 16 * LDC * sizeof(float));
  }
};

struct Params {
  const bf16 *x, *w1, *b1, *w2, *b2;
  const float *qs, *ks, *cos, *sin;
  bf16* out;
  long long N;  // frames
  int L, D, M, H;
  long long ld1, ld2;
  float scale;
};

__global__ void __launch_bounds__(THREADS) spatial_block_kernel(const Params p) {
  const int D = p.D, M = p.M, L = p.L, W = 3 * D + p.M, dh = D / p.H;
  const Layout lay(D, W);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + lay.x_off);
  bf16* Ws = reinterpret_cast<bf16*>(smem + lay.w_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Cs = reinterpret_cast<float*>(smem + lay.c_off) + warp * 16 * LDC;

  const int fb = ROWS / L;
  const long long f0 = static_cast<long long>(blockIdx.x) * fb;
  const int nf = static_cast<int>(min(static_cast<long long>(fb), p.N - f0));
  const int rows = nf * L;
  const long long r0 = f0 * L;  // first position of the block

  for (int idx = threadIdx.x; idx < ROWS * (D / 2); idx += THREADS) {
    const int r = idx / (D / 2), c = 2 * (idx % (D / 2));
    __nv_bfloat162 val = __floats2bfloat162_rn(0.0f, 0.0f);
    if (r < rows)
      val = *reinterpret_cast<const __nv_bfloat162*>(p.x + (r0 + r) * D + c);
    *reinterpret_cast<__nv_bfloat162*>(Xs + r * lay.ldx + c) = val;
  }
  __syncthreads();

  // linear1: Ws = bf16(bf16(x @ w1^T) + b1)
  for (int cf = warp; cf < W / 16; cf += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int k0 = 0; k0 < D; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(bw, p.w1 + cf * 16 * p.ld1 + k0, static_cast<unsigned>(p.ld1));
#pragma unroll
      for (int rf = 0; rf < 2; ++rf) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Xs + rf * 16 * lay.ldx + k0, lay.ldx);
        wmma::mma_sync(acc[rf], a, bw, acc[rf]);
      }
    }
#pragma unroll
    for (int rf = 0; rf < 2; ++rf) {
      wmma::store_matrix_sync(Cs, acc[rf], LDC, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = e / 16, cc = e % 16, n = cf * 16 + cc;
        const float val = __fadd_rn(lam_round_bf16(Cs[rr * LDC + cc]), __bfloat162float(p.b1[n]));
        Ws[(rf * 16 + rr) * lay.ldw + n] = __float2bfloat16(val);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // per-head RMS-norm + RoPE of q and k, one warp per (position, q|k, head)
  for (int u = warp; u < rows * 2 * p.H; u += NWARPS) {
    const int r = u / (2 * p.H), which = (u / p.H) % 2, hh = u % p.H;
    const int pos = r % L;
    lam_rmsnorm_rope(Ws + r * lay.ldw + which * D + hh * dh, dh, which ? p.ks : p.qs,
                     p.cos + pos * (dh / 2), p.sin + pos * (dh / 2), EPS);
  }
  // exact GELU of the MLP columns, in place
  for (int idx = threadIdx.x; idx < rows * M; idx += THREADS) {
    bf16* m = Ws + (idx / M) * lay.ldw + 3 * D + idx % M;
    const float xm = __bfloat162float(*m);
    *m = __float2bfloat16(__fmul_rn(__fmul_rn(0.5f, xm),
                                    __fadd_rn(1.0f, erff(__fmul_rn(xm, 0.70710678118654752f)))));
  }
  __syncthreads();

  // L x L attention per (frame, head), lanes over dh; attn overwrites q
  for (int u = warp; u < nf * p.H; u += NWARPS) {
    const int fl = u / p.H, hh = u % p.H;
    bf16* fr = Ws + fl * L * lay.ldw + hh * dh;  // q of position 0 of the frame
    for (int i = 0; i < L; ++i) {
      bf16* qi = fr + i * lay.ldw;
      float lg[MAXL];
      float mx = -3.4028234663852886e38f;
#pragma unroll
      for (int j = 0; j < MAXL; ++j) {
        if (j >= L) break;
        const bf16* kj = fr + j * lay.ldw + D;
        float s = 0.0f;
        for (int e = lane; e < dh; e += 32)
          s = __fadd_rn(s, lam_round_bf16(__fmul_rn(__bfloat162float(qi[e]),
                                                     __bfloat162float(kj[e]))));
        lg[j] = __fmul_rn(lam_warp_sum(s), p.scale);
        mx = fmaxf(mx, lg[j]);
      }
      float den = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXL; ++j) {
        if (j >= L) break;
        lg[j] = expf(__fsub_rn(lg[j], mx));
        den = __fadd_rn(den, lg[j]);
      }
#pragma unroll
      for (int j = 0; j < MAXL; ++j) {
        if (j >= L) break;
        lg[j] = lam_round_bf16(__fdiv_rn(lg[j], den));
      }
      __syncwarp();  // every lane has read q_i before it is overwritten
      for (int e = lane; e < dh; e += 32) {
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXL; ++j) {
          if (j >= L) break;
          a = fmaf(lg[j], __bfloat162float(fr[j * lay.ldw + 2 * D + e]), a);
        }
        qi[e] = __float2bfloat16(a);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // linear2: out = bf16(bf16([attn | gelu] @ w2^T) + b2); attn sits in
  // columns [0, D) and gelu in [3D, 3D + M), so A's column k0 >= D is 2D + k0
  for (int cf = warp; cf < D / 16; cf += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int k0 = 0; k0 < D + M; k0 += 16) {
      const int acol = k0 < D ? k0 : 2 * D + k0;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
      wmma::load_matrix_sync(bw, p.w2 + cf * 16 * p.ld2 + k0, static_cast<unsigned>(p.ld2));
#pragma unroll
      for (int rf = 0; rf < 2; ++rf) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ws + rf * 16 * lay.ldw + acol, lay.ldw);
        wmma::mma_sync(acc[rf], a, bw, acc[rf]);
      }
    }
#pragma unroll
    for (int rf = 0; rf < 2; ++rf) {
      wmma::store_matrix_sync(Cs, acc[rf], LDC, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int rr = e / 16, cc = e % 16, n = cf * 16 + cc, row = rf * 16 + rr;
        if (row < rows) {
          const float val =
              __fadd_rn(lam_round_bf16(Cs[rr * LDC + cc]), __bfloat162float(p.b2[n]));
          p.out[(r0 + row) * D + n] = __float2bfloat16(val);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x, out: bf16 [N, L, D] contiguous; w1: bf16 [3D + M, D] rows with row
// stride ld1 (nn.Linear layout), b1: bf16 [3D + M]; w2: bf16 [D, D + M] rows
// with row stride ld2, b2: bf16 [D]; qs, ks: fp32 [D / H]; cos, sin: fp32
// [L, D / H / 2] row-major. 1 <= L <= 8, D and M multiples of 16, D / H
// even; w1/w2 32-byte aligned with strides that are multiples of 8.
// Returns cudaGetLastError().
extern "C" int lam_spatial_block_wmma(const void* x, const void* w1, const void* b1,
                                      const void* qs, const void* ks, const void* w2,
                                      const void* b2, const void* cos, const void* sin,
                                      void* out, long long N, int L, int D, int M, int H,
                                      long long ld1, long long ld2, float scale, void* stream) {
  if (N <= 0 || L < 1 || L > MAXL || D % 16 || M % 16 || H <= 0 || D % H || (D / H) % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(D, 3 * D + M);
  cudaError_t err = cudaFuncSetAttribute(spatial_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params prm{static_cast<const bf16*>(x),   static_cast<const bf16*>(w1),
             static_cast<const bf16*>(b1),  static_cast<const bf16*>(w2),
             static_cast<const bf16*>(b2),  static_cast<const float*>(qs),
             static_cast<const float*>(ks), static_cast<const float*>(cos),
             static_cast<const float*>(sin), static_cast<bf16*>(out),
             N, L, D, M, H, ld1, ld2, scale};
  const int fb = ROWS / L;
  const dim3 grid(static_cast<unsigned>((N + fb - 1) / fb));
  spatial_block_kernel<<<grid, THREADS, lay.bytes, static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
