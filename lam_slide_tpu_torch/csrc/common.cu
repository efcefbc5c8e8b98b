// Error reporting for the ctypes-bound entry points, and the host side of
// hopper.cuh's tensor maps (shared by flash_fwd_sm90.cu and flash_bwd_sm90.cu).
#include "common.cuh"
#include "hopper.cuh"

extern "C" const char* lam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace lam_sm90_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor-map encoder, reached through the runtime so the library links no
// -lcuda.
static EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

bool encode_tile_map(CUtensorMap* map, const void* base, int B, int H, int N, int dh,
                     long long sb, long long sh, long long sn, int rows, int dp) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int w = dp >= 64 ? 128 : 2 * dp;  // Swz<DP>::W
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {N > 1 ? 2ull * sn : 16ull, H > 1 ? 2ull * sh : 16ull,
                                 B > 1 ? 2ull * sb : 16ull};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(w / 2), static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = w == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : w == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace lam_sm90_host
