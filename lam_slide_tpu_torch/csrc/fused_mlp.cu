// Fused MLP branch for Hopper (sm_90a): out = gelu(x @ w1 + b1) @ w2, fp32 out.
//
// Replaces the Pallas TPU kernel lam_slide_tpu/ops/fused_mlp.py `_mlp_kernel`
// (pallas_call in `_fused_mlp_vjp`), the parallel-MLP branch of every DiT
// block (models/latent_dit.py:425-427). As on the TPU, the [rows, d_mid]
// gelu intermediate never reaches device memory.
//
// Design: one thread block (8 warps) = 32 rows of x. Phase 1 computes
// mid = x @ w1 on the tensor cores (WMMA, bf16 operands, fp32 accumulation),
// adds b1 in fp32, rounds once to bf16, applies exact GELU with erff in fp32
// and keeps the bf16 result in shared memory (32 x 768 bf16 = 48 KB at the
// 4AA widths). Phase 2 multiplies it by w2 into the fp32 output. The weights
// stay in torch nn.Linear layout ([out, in] rows with a row stride), which
// WMMA reads as column-major B fragments straight from global memory (both
// slices, 1.1 MB in bf16, stay resident in the 50 MB L2).
//
// What bounds it on the H100: ~1.18 MFLOP per row against 768 bytes of x
// and 1.5 KB of output, so it is a compute-bound pair of GEMMs; this first
// version issues WMMA (mma.sync) with B fragments loaded from L2, without
// TMA, wgmma or pipelining, which is what later work can add.
//
// The JAX kernel's polynomial erf exists only because Mosaic has none; this
// kernel uses the real erff.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

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

}  // namespace

// x: bf16 [R, Din] with row stride x_sr; w1: bf16 [Dmid, Din] rows with row
// stride w1_ld (nn.Linear layout of the MLP-up slice); b1: bf16 [Dmid];
// w2: bf16 [Dout, Dmid] rows with row stride w2_ld (the MLP-down slice);
// out: fp32 [R, Dout] with row stride out_sr. Din, Dmid, Dout multiples of
// 16; w1/w2 32-byte aligned with strides that are multiples of 8.
// Returns cudaGetLastError().
extern "C" int lam_fused_mlp_fwd(const void* x, const void* w1, const void* b1,
                                 const void* w2, void* out, int R, int Din, int Dmid,
                                 int Dout, long long x_sr, long long w1_ld, long long w2_ld,
                                 long long out_sr, void* stream) {
  if (R <= 0 || Din % 16 || Dmid % 16 || Dout % 16)
    return static_cast<int>(cudaErrorInvalidValue);
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
