// The exact GELU of a bf16 value through a 6 KB table, shared by K2's
// Hopper kernel (fused_mlp.cu) and K8's (fused_spatial_block_sm90.cu).
//
// A bf16 mid has at most 65,536 GELUs. The table holds gelu_fp32 rounded to
// bf16 for |mid| in [2^-9, 8) (biased exponents 118..129, both signs: 3,072
// entries, 6 KB, which stay in L1); outside it the same formula has closed
// forms: below, 1 + erf lies within half a bf16 ulp of 1, so the result
// rounds to 0.5 mid; above, erf is +-1 in fp32, so the result is mid, or -0
// (NaN at -inf) for negative mid. A lookup costs about a third of erff's
// instructions and latency, which bounded K2 (at MD17 on an H100: 3.36 ms
// with erff in the kernel, 2.97 with the table). ops/fused_mlp.py mirrors
// these constants (GELU_TABLE_*). Each kernel's entry point fills the table
// with gelu_table_kernel on its stream before the kernel that reads it.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace {

// The exact GELU of a bf16 mid in fp32: 0.5 mid (1 + erf(mid / sqrt 2)),
// rounded to bf16 by the caller.
__device__ __forceinline__ float gelu_fp32(float mid) {
  return 0.5f * mid * (1.0f + erff(mid * 0.70710678118654752f));
}

constexpr uint32_t GELU_LO = 118u << 7;  // the table's first |mid| bits, 2^-9
constexpr uint32_t GELU_SPAN = 12u << 7; // entries a sign
constexpr int GELU_ENTRIES = 2 * GELU_SPAN;

__global__ void gelu_table_kernel(unsigned short* table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= GELU_ENTRIES) return;
  const uint32_t sign = i >= static_cast<int>(GELU_SPAN) ? 0x8000u : 0u;
  const uint32_t bits = sign | (GELU_LO + i % GELU_SPAN);
  table[i] = __bfloat16_as_ushort(__float2bfloat16(gelu_fp32(__uint_as_float(bits << 16))));
}

inline cudaError_t fill_gelu_table(unsigned short* table, cudaStream_t stream) {
  gelu_table_kernel<<<(GELU_ENTRIES + 255) / 256, 256, 0, stream>>>(table);
  return cudaGetLastError();
}

// The bf16 bits of gelu(mid) for the bf16 bits h of mid: the table inside
// [2^-9, 8), the closed forms outside.
// Branch-free, so the lanes of a warp stay together.
__device__ __forceinline__ uint32_t gelu_bits(uint32_t h, const unsigned short* table) {
  const uint32_t m = h & 0x7fffu, k = m - GELU_LO;
  const bool in = k < GELU_SPAN;
  const uint32_t looked = __ldg(table + (in ? k + (h >> 15) * GELU_SPAN : 0u));
  const float mid = __uint_as_float(h << 16);
  const float val = 0.5f * mid * (m < GELU_LO ? 1.0f : 1.0f + copysignf(1.0f, mid));
  return in ? looked : static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(val)));
}

}  // namespace
