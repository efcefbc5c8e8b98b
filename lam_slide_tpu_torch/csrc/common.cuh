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
