// Residual add + LayerNorm + AdaLN modulate with fp32 operands, for Hopper
// (sm_90a).
//
// Replaces the fp32 instance of the Pallas TPU kernels
// lam_slide_tpu/ops/fused_adaln.py `_adaln_kernel` (RESIDUAL=false: y =
// modulate(LN(x))) and `_residual_adaln_kernel` (RESIDUAL=true: x_new = x +
// gate*h, y = modulate(LN(x_new))), which the fp32 DiT of the MD17 test pass
// calls twice a layer and once before its output layer.
//
// Numerics of fused_adaln.py:83-105 in fp32: x_new = x + gate * h rounds per
// op (no FMA), so it is bit-identical to the plain version; mean and
// variance in fp32 (a warp-shuffle sum, in another order than PyTorch's
// reduction); xn = (x - mean) * (1 / sqrt(var + eps)); y = xn * (1 + scale)
// + shift, each op rounded as the separate PyTorch ops round it (the _rn
// intrinsics keep products from contracting into FMAs).
//
// Design: a warp a row, the row's D values in registers (VEC floats a
// chunk, chunk c = lane + 32 k, columns [VEC c, VEC c + VEC)), in 16-byte
// accesses (VEC 4) where D, every pointer and every stride allow it, else
// one float at a time. The grid's y axis is the batch index b, so a warp
// loads the b-th gate/shift/scale rows (through their batch strides: the
// DiT's [B, 1, 1, 6D] modulation chunks go in without a copy) once and keeps
// them in registers with 1 + scale rounded once, then walks the batch
// index's rows with a grid stride. h is read through its own (b, i1, i2)
// strides, so the DiT's temporal output goes in as the [B, T, L, D] view of
// its [B, L, T, D] memory.
//
// What bounds it on the H100: ~10 FLOPs per element against 16 bytes moved
// (x, h in; x_new, y out; fp32), so HBM bytes: 0.45 ms at the MD17 test
// pass's [64, 30, 192, 256].

#include <stdint.h>

#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int MAX_D = 1024;

struct Args {
  const float *x, *h, *gate, *shift, *scale;
  float *x_out, *y;
  long long B, R1, R2, h_s0, h_s1, h_s2, gate_sb, shift_sb, scale_sb;
  int D, chunks;  // chunks = D / VEC
  float eps;
};

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

// NV chunks a lane at most (D <= 32 * NV * VEC).
template <bool RESIDUAL, int VEC, int NV>
__global__ void __launch_bounds__(THREADS) adaln_f32_kernel(const Args a) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long rows = a.R1 * a.R2;  // rows of a batch index
  const float inv_d = 1.0f / static_cast<float>(a.D);
  for (long long b = blockIdx.y; b < a.B; b += gridDim.y) {
    float sc1[NV][VEC], sh[NV][VEC], gt[NV][VEC];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = lane + 32 * k;
      if (c >= a.chunks) break;
      Vec<VEC>::load(a.scale + b * a.scale_sb + c * VEC, sc1[k]);
      Vec<VEC>::load(a.shift + b * a.shift_sb + c * VEC, sh[k]);
      if constexpr (RESIDUAL) Vec<VEC>::load(a.gate + b * a.gate_sb + c * VEC, gt[k]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sc1[k][e] = __fadd_rn(1.0f, sc1[k][e]);
    }
    for (long long r = static_cast<long long>(blockIdx.x) * NWARPS + warp; r < rows;
         r += static_cast<long long>(gridDim.x) * NWARPS) {
      const float* xrow = a.x + (b * rows + r) * a.D;
      const float* hrow = a.h + b * a.h_s0 + (r / a.R2) * a.h_s1 + (r % a.R2) * a.h_s2;
      float v[NV][VEC];
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = lane + 32 * k;
        if (c >= a.chunks) break;
        Vec<VEC>::load(xrow + c * VEC, v[k]);
        if constexpr (RESIDUAL) {
          float hv[VEC];
          Vec<VEC>::load(hrow + c * VEC, hv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[k][e] = __fadd_rn(v[k][e], __fmul_rn(gt[k][e], hv[e]));
          Vec<VEC>::store(a.x_out + (b * rows + r) * a.D + c * VEC, v[k]);
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) sum = __fadd_rn(sum, v[k][e]);
      }
      const float mean = __fmul_rn(lam_warp_sum(sum), inv_d);
      float sq = 0.0f;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (lane + 32 * k >= a.chunks) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float dx = __fsub_rn(v[k][e], mean);
          sq = __fadd_rn(sq, __fmul_rn(dx, dx));
        }
      }
      const float var = __fmul_rn(lam_warp_sum(sq), inv_d);
      const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, a.eps)));
      float* yrow = a.y + (b * rows + r) * a.D;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int c = lane + 32 * k;
        if (c >= a.chunks) break;
        float out[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xn = __fmul_rn(__fsub_rn(v[k][e], mean), inv);
          out[e] = __fadd_rn(__fmul_rn(xn, sc1[k][e]), sh[k][e]);
        }
        Vec<VEC>::store(yrow + c * VEC, out);
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
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adaln_f32_kernel<RESIDUAL, VEC, NV>,
                                                  THREADS, 0);
    return 4 * sms * (per_sm > 0 ? per_sm : 1);
  }();
  const long long gy = a.B < 65535 ? a.B : 65535;
  const long long per_b = (a.R1 * a.R2 + NWARPS - 1) / NWARPS;
  long long gx = (blocks + gy - 1) / gy;
  gx = gx < per_b ? gx : per_b;
  adaln_f32_kernel<RESIDUAL, VEC, NV>
      <<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)), THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool RESIDUAL, int VEC>
cudaError_t launch_nv(const Args& a, cudaStream_t stream) {
  const int nv = (a.chunks + 31) / 32;
  if (nv <= 1) return launch<RESIDUAL, VEC, 1>(a, stream);
  if (nv <= 2) return launch<RESIDUAL, VEC, 2>(a, stream);
  if (nv <= 4) return launch<RESIDUAL, VEC, 4>(a, stream);
  if constexpr (VEC == 4) return launch<RESIDUAL, 4, 8>(a, stream);
  else return launch<RESIDUAL, 1, MAX_D / 32>(a, stream);
}

}  // namespace

// As lam_adaln_fwd (csrc/fused_adaln.cu), with fp32 operands: x, x_out, y
// fp32 [B, R1, R2, D] contiguous (R = B * R1 * R2 rows); h fp32 [B, R1, R2,
// D] with element strides h_s0/1/2 and unit stride on D; gate, shift, scale
// fp32 rows of D with unit stride, batch b at b * *_sb elements. dims: {R,
// R1, R2, D, h_s0, h_s1, h_s2, gate_sb, shift_sb, scale_sb}. residual = 0
// computes y = modulate(LN(x)) and reads neither h nor gate nor writes
// x_out. D <= 1024; pointers 4-byte aligned. Accesses are 16 bytes wide
// where D, every pointer and every stride allow it, else 4. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int lam_adaln_fwd_f32(const void* x, const void* h, const void* gate,
                                 const void* shift, const void* scale, void* x_out, void* y,
                                 const long long* dims, float eps, int residual, void* stream) {
  const long long R = dims[0], R1 = dims[1], R2 = dims[2], h_s0 = dims[4], h_s1 = dims[5],
                  h_s2 = dims[6], gate_sb = dims[7], shift_sb = dims[8], scale_sb = dims[9];
  const int D = static_cast<int>(dims[3]);
  if (R <= 0 || R1 <= 0 || R2 <= 0 || R % (R1 * R2) || D <= 0 || D > MAX_D)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long bits = 4ull * D;  // byte offsets every access must divide
  for (const void* p : {x, shift, scale, static_cast<const void*>(x_out), static_cast<const void*>(y)})
    bits |= reinterpret_cast<unsigned long long>(p);
  for (long long s : {shift_sb, scale_sb}) bits |= 4ull * static_cast<unsigned long long>(s);
  if (residual) {
    for (const void* p : {h, gate}) bits |= reinterpret_cast<unsigned long long>(p);
    for (long long s : {h_s0, h_s1, h_s2, gate_sb})
      bits |= 4ull * static_cast<unsigned long long>(s);
  }
  if ((bits & 3) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (bits & 15) == 0 ? 4 : 1;
  Args a{static_cast<const float*>(x), static_cast<const float*>(h),
         static_cast<const float*>(gate), static_cast<const float*>(shift),
         static_cast<const float*>(scale), static_cast<float*>(x_out), static_cast<float*>(y),
         R / (R1 * R2), R1, R2, h_s0, h_s1, h_s2, gate_sb, shift_sb, scale_sb, D, D / vec, eps};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec == 4)
    err = residual ? launch_nv<true, 4>(a, st) : launch_nv<false, 4>(a, st);
  else
    err = residual ? launch_nv<true, 1>(a, st) : launch_nv<false, 1>(a, st);
  return static_cast<int>(err);
}
