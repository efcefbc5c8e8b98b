// Shared helpers for the port's CUDA kernels (plain C interface, ctypes-bound).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

// Round a byte offset up to 128 so every shared-memory region starts on an
// address that WMMA fragment loads accept (they need 32-byte alignment).
__host__ __device__ constexpr size_t lam_align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

// Raise a kernel's dynamic shared-memory cap once per instantiation; the
// attribute is needed above 48 KB.
template <typename Kernel>
inline cudaError_t lam_set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Blocks of a persistent grid: as many as the card holds at once (the
// occupancy of `kernel` at this block size and dynamic shared memory, times
// the SMs), at most `items`, at least one.
template <typename Kernel>
inline int lam_persistent_grid(Kernel kernel, int threads, size_t smem, long long items) {
  int dev = 0, sms = 1, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(grid < items ? grid : items);
}

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float lam_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lam_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Per-head QK RMS-norm then RoPE of one head's dh values x[0, dh), in place,
// by the 32 lanes of one warp (all lanes must call it). Rounding points of
// the plain headmajor_rope(headmajor_rmsnorm(x)): fp32 statistics,
// rsqrt(mean(x^2) + eps), x * rr * scale rounded to bf16, the rotation of
// adjacent (even, odd) pairs in fp32 by cos/sin[dh/2], rounded to bf16.
// The _rn intrinsics keep the compiler from contracting products into
// FMAs, so each product rounds as the separate PyTorch ops round it.
__device__ __forceinline__ void lam_rmsnorm_rope(bf16* x, int dh, const float* scale,
                                                 const float* cos, const float* sin,
                                                 float eps) {
  const int lane = threadIdx.x % 32;
  float ss = 0.0f;
  for (int p = lane; p < dh / 2; p += 32) {
    const float a = __bfloat162float(x[2 * p]), b = __bfloat162float(x[2 * p + 1]);
    ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
  }
  ss = lam_warp_sum(ss);
  const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(dh)), eps));
  for (int p = lane; p < dh / 2; p += 32) {
    const float a = __bfloat162float(x[2 * p]), b = __bfloat162float(x[2 * p + 1]);
    const float na = lam_round_bf16(__fmul_rn(__fmul_rn(a, rr), scale[2 * p]));
    const float nb = lam_round_bf16(__fmul_rn(__fmul_rn(b, rr), scale[2 * p + 1]));
    const float c = cos[p], s = sin[p];
    x[2 * p] = __float2bfloat16(__fsub_rn(__fmul_rn(c, na), __fmul_rn(s, nb)));
    x[2 * p + 1] = __float2bfloat16(__fadd_rn(__fmul_rn(s, na), __fmul_rn(c, nb)));
  }
  __syncwarp();
}

// K10's form of the same (fused_temporal_attention.py:58-71): the same fp32
// statistics, then xn = x * rr * scale and xn * cos + partner(xn) * sin with
// a scale and an angle per lane (partner = (-x_odd, x_even)), all in fp32,
// rounded to bf16 once.
__device__ __forceinline__ void lam_rmsnorm_rope_lanes(bf16* x, int dh, const float* scale,
                                                       const float* cos, const float* sin,
                                                       float eps) {
  const int lane = threadIdx.x % 32;
  float ss = 0.0f;
  for (int p = lane; p < dh / 2; p += 32) {
    const float a = __bfloat162float(x[2 * p]), b = __bfloat162float(x[2 * p + 1]);
    ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)));
  }
  ss = lam_warp_sum(ss);
  const float rr = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(dh)), eps));
  for (int p = lane; p < dh / 2; p += 32) {
    const int e = 2 * p, o = 2 * p + 1;
    const float na = __fmul_rn(__fmul_rn(__bfloat162float(x[e]), rr), scale[e]);
    const float nb = __fmul_rn(__fmul_rn(__bfloat162float(x[o]), rr), scale[o]);
    x[e] = __float2bfloat16(__fsub_rn(__fmul_rn(na, cos[e]), __fmul_rn(nb, sin[e])));
    x[o] = __float2bfloat16(__fadd_rn(__fmul_rn(nb, cos[o]), __fmul_rn(na, sin[o])));
  }
  __syncwarp();
}
