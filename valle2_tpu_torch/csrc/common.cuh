// Shared helpers of the port's CUDA kernels: dtype conversion and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace valle2 {

constexpr float NEG_INF = -1e30f;   // the JAX kernels' finite mask sentinel

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision and back: the value a cast to T then back yields.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Runs `set` (a cudaFuncSetAttribute) once per card for the caller's static
// mask, one bit per card: a kernel's attributes belong to the current device,
// and tensor-parallel ranks launch the same kernels on several cards.
template <typename F>
inline cudaError_t once_per_device(unsigned& done, F&& set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (done >> dev & 1u) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace valle2
