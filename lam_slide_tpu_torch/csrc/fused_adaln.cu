// Residual add + LayerNorm + AdaLN modulate for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernels lam_slide_tpu/ops/fused_adaln.py
// `_adaln_kernel` (RESIDUAL=false: y = modulate(LN(x))) and
// `_residual_adaln_kernel` (RESIDUAL=true: x_new = x + gate*h,
// y = modulate(LN(x_new))), which the DiT calls twice per layer and once
// before its output layer (models/latent_dit.py LatentDiTLayer, LatentDiT).
//
// What bounds it on the H100: ~10 FLOPs per element against 8 bytes moved
// (x, h in; x_new, y out; bf16), so it is bound by HBM bytes (1.127 ms at
// MD17's [320, 30, 192, 256]; at the 4AA DiT's [8, 1000, 2, 384] the 12 MB
// may still sit in the 50 MB L2 from the kernel before). The design reads
// each of x and h once and writes x_new and y once, in as few, wide and
// early accesses as it can:
// - a warp takes RPW = 2 rows of D values at a time, so two rows' loads are
//   in flight before either's reductions; each lane holds its chunks of VEC
//   bf16 (chunk c = lane + 32k, columns [VEC c, VEC c + VEC)) in registers:
//   16-byte accesses (VEC 8), or 8-byte ones (VEC 4) where D / 8 chunks
//   would leave lanes idle and D / 4 do not (D 384: 96 chunks, 3 a lane),
//   or narrower where the alignment of a pointer or stride asks for it;
// - the grid's y axis is the batch index b, so gate/shift/scale (the b-th
//   [1.., D] rows, addressed through their batch stride, so the chunks of
//   the DiT's [B, 1, 1, 6D] modulation go in without a copy) are loaded
//   once a warp, before its rows, and kept in registers with 1 + scale
//   rounded once; the warps of a block walk the batch index's rows with a
//   grid stride, R1 * R2 of them in x's order (x, x_new and y contiguous);
// - h is read through its own (b, i1, i2) strides, so the DiT's temporal
//   output goes in as the [B, T, L, D] view of its [B, L, T, D] memory.
//   Each row of it is one contiguous run of 2D bytes (768 at 4AA, 512 at
//   MD17), and the rows in flight across the card cover long runs of every
//   (b, l) stream of h at once (tools/kernel_variants.py K7 times the walk
//   in h's order against x's);
// - the mean and variance are fp32 warp-shuffle sums, the two rows'
//   shuffles interleaved.
//
// Numerics of fused_adaln.py:83-105 and of the plain composition: x_new =
// bf16(x + bf16(gate * h)) rounds per op as PyTorch's bf16 ops do, so it is
// bit-identical; mean and variance in fp32 (in another summation order than
// PyTorch's reduction); xn = bf16((x - mean) / sqrt(var + eps)); then
// bf16(bf16(xn * bf16(1 + scale)) + shift). The _rn intrinsics keep the
// compiler from fusing products into FMAs the separate ops do not have.

#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = 2;  // rows in flight a warp
constexpr int MAX_D = 1024;

struct Args {
  const bf16 *x, *h, *gate, *shift, *scale;
  bf16 *x_out, *y;
  long long B, R1, R2, h_s0, h_s1, h_s2, gate_sb, shift_sb, scale_sb;
  int D, chunks;  // chunks = D / VEC
  float eps;
};

// VEC bf16 values at p (VEC * 2-byte aligned) as VEC / 2 packed pairs, and
// back. Values stay packed in registers until used (a lane holds up to two
// rows of x and h and the modulation), so more warps fit an SM.
template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, uint32_t (&w)[VEC / 2]) {
  if constexpr (VEC == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else if constexpr (VEC == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x, w[1] = u.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const uint32_t (&w)[VEC / 2]) {
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (VEC == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = w[0];
}

// Element e of packed pairs w, and a pair from two floats (rounded to bf16).
template <int N>
__device__ __forceinline__ float elem(const uint32_t (&w)[N], int e) {
  return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// NV chunks a lane at most (D <= 32 * NV * VEC).
template <bool RESIDUAL, int VEC, int NV>
__global__ void __launch_bounds__(THREADS) adaln_kernel(const Args a) {
  constexpr int W = VEC / 2;  // packed pairs a chunk
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long rows = a.R1 * a.R2;  // rows of a batch index
  const float inv_d = 1.0f / static_cast<float>(a.D);
  for (long long b = blockIdx.y; b < a.B; b += gridDim.y) {
    // the batch index's modulation, once a warp: bf16(1 + scale), shift, gate
    uint32_t sc1[NV][W], sh[NV][W], gt[NV][W];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + 32 * k;
      if (c >= a.chunks) break;
      load_vec<VEC>(a.scale + b * a.scale_sb + c * VEC, sc1[k]);
      load_vec<VEC>(a.shift + b * a.shift_sb + c * VEC, sh[k]);
      if constexpr (RESIDUAL) load_vec<VEC>(a.gate + b * a.gate_sb + c * VEC, gt[k]);
#pragma unroll
      for (int e = 0; e < W; ++e)
        sc1[k][e] = pack2(1.0f + elem(sc1[k], 2 * e), 1.0f + elem(sc1[k], 2 * e + 1));
    }
    for (long long r0 = (static_cast<long long>(blockIdx.x) * NWARPS + warp) * RPW; r0 < rows;
         r0 += static_cast<long long>(gridDim.x) * NWARPS * RPW) {
      // every load of the warp's rows first; walk index r0 + q is row xr
      // of the batch index in x's order
      uint32_t v[RPW][NV][W], hv[RPW][NV][W];
      long long xr[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const long long row = r0 + q;
        xr[q] = row;
        if (row >= rows) break;
        const bf16* xrow = a.x + (b * rows + xr[q]) * a.D;
        const bf16* hrow =
            a.h + b * a.h_s0 + (xr[q] / a.R2) * a.h_s1 + (xr[q] % a.R2) * a.h_s2;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = lane + 32 * k;
          if (c >= a.chunks) break;
          load_vec<VEC>(xrow + c * VEC, v[q][k]);
          if constexpr (RESIDUAL) load_vec<VEC>(hrow + c * VEC, hv[q][k]);
        }
      }
      float sum[RPW], sq[RPW];
#pragma unroll
      for (int q = 0; q < RPW; ++q) sum[q] = sq[q] = 0.0f;
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        if (r0 + q >= rows) break;
        bf16* orow = a.x_out + (b * rows + xr[q]) * a.D;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = lane + 32 * k;
          if (c >= a.chunks) break;
          if constexpr (RESIDUAL) {
            // x_new = bf16(x + bf16(gate * h))
#pragma unroll
            for (int e = 0; e < W; ++e) {
              float nx[2];
#pragma unroll
              for (int o = 0; o < 2; ++o)
                nx[o] = __fadd_rn(elem(v[q][k], 2 * e + o),
                                  lam_round_bf16(__fmul_rn(elem(gt[k], 2 * e + o),
                                                           elem(hv[q][k], 2 * e + o))));
              v[q][k][e] = pack2(nx[0], nx[1]);
            }
            store_vec<VEC>(orow + c * VEC, v[q][k]);
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) sum[q] = __fadd_rn(sum[q], elem(v[q][k], e));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < RPW; ++q) sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        sum[q] = __fmul_rn(sum[q], inv_d);  // the mean
        if (r0 + q >= rows) continue;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          if (lane + 32 * k >= a.chunks) break;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float dx = __fsub_rn(elem(v[q][k], e), sum[q]);
            sq[q] = __fadd_rn(sq[q], __fmul_rn(dx, dx));
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int q = 0; q < RPW; ++q) sq[q] += __shfl_xor_sync(0xffffffffu, sq[q], o);
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        if (r0 + q >= rows) break;
        const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(sq[q], inv_d), a.eps)));
        bf16* yrow = a.y + (b * rows + xr[q]) * a.D;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const int c = lane + 32 * k;
          if (c >= a.chunks) break;
          uint32_t out[W];
#pragma unroll
          for (int e = 0; e < W; ++e) {
            float y[2];
#pragma unroll
            for (int o = 0; o < 2; ++o) {
              const float xn =
                  lam_round_bf16(__fmul_rn(__fsub_rn(elem(v[q][k], 2 * e + o), sum[q]), inv));
              y[o] = __fadd_rn(lam_round_bf16(__fmul_rn(xn, elem(sc1[k], 2 * e + o))),
                               elem(sh[k], 2 * e + o));
            }
            out[e] = pack2(y[0], y[1]);
          }
          store_vec<VEC>(yrow + c * VEC, out);
        }
      }
    }
  }
}

template <bool RESIDUAL, int VEC, int NV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static int blocks = [] {
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adaln_kernel<RESIDUAL, VEC, NV>,
                                                  THREADS, 0);
    return 4 * sms * (per_sm > 0 ? per_sm : 1);
  }();
  const long long gy = a.B < 65535 ? a.B : 65535;
  const long long per_b = (a.R1 * a.R2 + NWARPS * RPW - 1) / (NWARPS * RPW);
  long long gx = (blocks + gy - 1) / gy;
  gx = gx < per_b ? gx : per_b;
  adaln_kernel<RESIDUAL, VEC, NV><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                                    THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool RESIDUAL, int VEC>
cudaError_t launch_nv(const Args& a, cudaStream_t stream) {
  const int nv = (a.chunks + 31) / 32;
  if constexpr (VEC == 2) {
    return launch<RESIDUAL, 2, MAX_D / 64>(a, stream);
  } else {
    if (nv <= 1) return launch<RESIDUAL, VEC, 1>(a, stream);
    if (nv <= 2) return launch<RESIDUAL, VEC, 2>(a, stream);
    if (nv <= 3) return launch<RESIDUAL, VEC, 3>(a, stream);
    if (nv <= 4) return launch<RESIDUAL, VEC, 4>(a, stream);
    if constexpr (VEC == 4) return launch<RESIDUAL, 4, 8>(a, stream);
    return cudaErrorInvalidValue;
  }
}

template <bool RESIDUAL>
cudaError_t launch_vec(const Args& a, int vec, cudaStream_t stream) {
  if (vec == 8) return launch_nv<RESIDUAL, 8>(a, stream);
  if (vec == 4) return launch_nv<RESIDUAL, 4>(a, stream);
  return launch_nv<RESIDUAL, 2>(a, stream);
}

}  // namespace

// x, x_out, y: bf16 [B, R1, R2, D] contiguous (R = B * R1 * R2 rows); h:
// bf16 [B, R1, R2, D] with element strides h_s0/1/2 and unit stride on D;
// gate, shift, scale: bf16 rows of D with unit stride, batch b at b * *_sb
// elements. dims: {R, R1, R2, D, h_s0, h_s1, h_s2, gate_sb, shift_sb,
// scale_sb} (one array, which the wrapper keeps per signature). residual =
// 0 computes y = modulate(LN(x)) and reads neither h nor gate nor writes
// x_out. D even and <= 1024; pointers 4-byte aligned, strides even. The
// access width is the widest of 16, 8 and 4 bytes that D, every pointer and
// every stride allow, 8 rather than 16 where that puts the same number of
// chunks on every lane and 16 does not. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take.
extern "C" int lam_adaln_fwd(const void* x, const void* h, const void* gate,
                             const void* shift, const void* scale, void* x_out, void* y,
                             const long long* dims, float eps, int residual, void* stream) {
  const long long R = dims[0], R1 = dims[1], R2 = dims[2], h_s0 = dims[4], h_s1 = dims[5],
                  h_s2 = dims[6], gate_sb = dims[7], shift_sb = dims[8], scale_sb = dims[9];
  const int D = static_cast<int>(dims[3]);
  if (R <= 0 || R1 <= 0 || R2 <= 0 || R % (R1 * R2) || D <= 0 || D % 2 || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long bits = 2ull * D;  // byte offsets every access must divide
  for (const void* p : {x, shift, scale, static_cast<const void*>(x_out), static_cast<const void*>(y)})
    bits |= reinterpret_cast<unsigned long long>(p);
  for (long long s : {shift_sb, scale_sb}) bits |= 2ull * static_cast<unsigned long long>(s);
  if (residual) {
    for (const void* p : {h, gate}) bits |= reinterpret_cast<unsigned long long>(p);
    for (long long s : {h_s0, h_s1, h_s2, gate_sb})
      bits |= 2ull * static_cast<unsigned long long>(s);
  }
  int vec = (bits & 15) == 0 ? 8 : (bits & 7) == 0 ? 4 : 2;
  if ((bits & 3) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 8 && (D / 8) % 32 != 0 && (D / 4) % 32 == 0) vec = 4;
  Args a{static_cast<const bf16*>(x), static_cast<const bf16*>(h),
         static_cast<const bf16*>(gate), static_cast<const bf16*>(shift),
         static_cast<const bf16*>(scale), static_cast<bf16*>(x_out), static_cast<bf16*>(y),
         R / (R1 * R2), R1, R2, h_s0, h_s1, h_s2, gate_sb, shift_sb, scale_sb, D, D / vec, eps};
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      residual ? launch_vec<true>(a, vec, st) : launch_vec<false>(a, vec, st);
  return static_cast<int>(err);
}
