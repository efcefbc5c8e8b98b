// Tile shapes and shared-memory tile loaders of the flash-attention forward
// (flash_attention.cu: K1 with a bias or fp32 operands, K10) and backward
// (flash_attention_bwd.cu: K4 with a bias or fp32 operands) kernels.
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

}  // namespace lam_flash
