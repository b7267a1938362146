// Device helpers shared by the port's kernels.
//
// fmix32 is the murmur3 32-bit finalizer behind every hash-dropout stream
// of the JAX package (ops/attention.py::dropout_keep, ops/dropout.py::
// keep_factor_rows); to_f / from_f convert between the storage types and
// fp32 with one round-to-nearest-even rounding; smem_attr_once raises a
// kernel's dynamic shared-memory limit once per device.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

#define FDT_MAX_DEVICES 64

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) for `kernel` on the
// current device, only when `bytes` exceeds what it already allows there:
// `done` is the launcher's own table (a static array a kernel
// instantiation), so a fixed-size kernel sets it once a device.  The
// attribute is not a stream operation, so the launchers stay legal under
// stream capture, and a launch no longer pays for it.
template <typename F>
inline cudaError_t smem_attr_once(F kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= FDT_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (__atomic_load_n(&done[dev], __ATOMIC_ACQUIRE) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) __atomic_store_n(&done[dev], bytes, __ATOMIC_RELEASE);
  return err;
}

}  // namespace
