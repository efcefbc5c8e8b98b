// Tile shapes and shared-memory tile loaders of the flash-attention forward
// (flash_attention.cu: K1 with a bias or fp32 operands, K10) and backward
// (flash_attention_bwd.cu: K4 with a bias or fp32 operands) kernels, and the
// helpers of their register-tiled fp32 kernels at dh 128.
#pragma once

#include "common.cuh"

namespace lam_flash {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NWARPS = 4;     // 16 rows of a 64-row tile per warp
constexpr int THREADS = NWARPS * 32;
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;  // the JAX kernels' mask fill

static_assert(BQ == BK, "the tile loaders serve Q, K, V and dO tiles alike");

// The grid is one axis over (batch*head, tile) pairs with the tile index
// fastest: the order in which a (tiles, batch*head) grid launches its
// blocks, without gridDim.y's cap of 65,535 (the MD17 DiT's spatial axis
// has 153,600 batch*head pairs).
struct TileIdx {
  int bh, tile;
};

__device__ __forceinline__ TileIdx tile_index(int n, int rows) {
  const int tiles = (n + rows - 1) / rows;
  return {static_cast<int>(blockIdx.x / tiles), static_cast<int>(blockIdx.x % tiles)};
}

inline unsigned grid_blocks(int bh, int n, int rows) {
  return static_cast<unsigned>(bh) * static_cast<unsigned>((n + rows - 1) / rows);
}

// Rows [n0, n0 + 64) of one head into a [64, DP] tile with row stride ld,
// zero outside [0, n) x [0, dh).
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, long long sn,
                                          int n0, int n, int dh) {
  for (int idx = threadIdx.x; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    bf16 val = __float2bfloat16(0.0f);
    if (c < dh && n0 + r < n) val = src[static_cast<long long>(n0 + r) * sn + c];
    dst[r * ld + c] = val;
  }
}

// K10's QK RMS-norm + RoPE of a tile's rows at sequence positions n0 + r < n,
// in place, in the lane form; warp w takes rows [16w, 16w + 16), padding
// rows stay zero. Row r takes its [dh] slice of the [D] lane scale and of
// the position's [D] lane-table rows at the head's lane offset lane0
// (D = H*dh), eps given, one rounding.
__device__ __forceinline__ void normrope_lane_tile(bf16* tile, int ld, int n0, int n, int dh,
                                                   int lane0, int D, const float* scale,
                                                   const float* cos, const float* sin,
                                                   float eps) {
  const int warp = threadIdx.x / 32;
  for (int r = warp * 16; r < warp * 16 + 16 && n0 + r < n; ++r) {
    const long long row = static_cast<long long>(n0 + r) * D + lane0;
    lam_rmsnorm_rope_lanes(tile + r * ld, dh, scale + lane0, cos + row, sin + row, eps);
  }
}

// The register-tiled fp32 kernels at 64 < dh <= 128 (flash_attention.cu's
// forward, flash_attention_bwd.cu's dK/dV and dQ pair): blocks of
// WIDE_THREADS over 64-row tiles, dh zero-padded to WIDE_DP in shared
// memory, rows of WIDE_LDQK floats where 16 rows are read at once (their
// float4 loads fall on distinct banks), copied by cp.async.
constexpr int WIDE_THREADS = 256;
constexpr int WIDE_DP = 128;
constexpr int WIDE_KEYS = 64;
constexpr int WIDE_LDQK = WIDE_DP + 4;  // Q and K row stride (floats)

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float wide_dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// cp.async of 16 or 4 bytes, zeros where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [0, rows) of a tile: row r of sequence s = r / (rows / SEG) (offset
// off0 or off1 from base) at position n0 + r % (rows / SEG), zero where the
// sequence is past B*H (ok1 false), the position past n or the column past
// dh.
template <int SEG, bool VEC>
__device__ __forceinline__ void wide_stage(float* dst, int ld, int rows, const float* base,
                                           long long off0, long long off1, bool ok1,
                                           long long sn, int n0, int n, int dh) {
  const int per = rows / SEG;
  if constexpr (VEC) {
    for (int idx = threadIdx.x; idx < rows * (WIDE_DP / 4); idx += WIDE_THREADS) {
      const int r = idx / (WIDE_DP / 4), c = 4 * (idx % (WIDE_DP / 4));
      const int s = SEG == 1 ? 0 : r / per, pos = n0 + (SEG == 1 ? r : r % per);
      const bool ok = (s == 0 || ok1) && pos < n && c < dh;
      cp_async16(dst + r * ld + c, ok ? base + (s ? off1 : off0) + pos * sn + c : base, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * WIDE_DP; idx += WIDE_THREADS) {
      const int r = idx / WIDE_DP, c = idx % WIDE_DP;
      const int s = SEG == 1 ? 0 : r / per, pos = n0 + (SEG == 1 ? r : r % per);
      const bool ok = (s == 0 || ok1) && pos < n && c < dh;
      cp_async4(dst + r * ld + c, ok ? base + (s ? off1 : off0) + pos * sn + c : base, ok);
    }
  }
}


}  // namespace lam_flash
