// Shared helpers of the port's CUDA kernels: dtype conversion, warp reductions,
// and the tensor-core fragment helpers (cp.async, ldmatrix, mma.sync m16n8k16
// bf16 -> f32) of the flash forward and backward bf16 routes (#1-#5).  The
// Hopper primitives of the GEMM (#9, #10) are in hopper.cuh.
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

// ---- cp.async, ldmatrix and mma.sync (sm_80+; used on sm_90a) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 16 bytes from src, or 16 zero bytes when !valid (src-size 0: nothing is
// read, so src need only be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from src, or 4 zero bytes when !valid (.ca: the 16-byte form needs
// 16-byte alignment, which a (b, h, s) f32 row at an odd s lacks).
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.  Fragment
// layout (gid = lane / 4, tig = lane % 4): a[0] (row gid, cols 2tig, 2tig+1),
// a[1] (row gid+8, same cols), a[2] / a[3] the same rows at cols + 8; b[0]
// (k 2tig, 2tig+1; n gid), b[1] (k + 8); d[0], d[1] (row gid, cols 2tig,
// 2tig+1), d[2], d[3] (row gid+8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- padded bf16 tiles of the flash kernels' tensor-core routes (#1-#5) ----

// bf16 (16 bytes) of padding per shared row, so that the 8 rows an ldmatrix
// reads fall in distinct banks.
constexpr int TILE_PAD = 8;

// 64 rows of an (s, HD) bf16 matrix, from row0 of the head at `base`, into a
// shared tile of row stride HD + TILE_PAD, by cp.async over NTHREADS
// threads; rows past s are zero-filled.
template <int HD, int NTHREADS>
__device__ __forceinline__ void cp_async_rows64(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                                size_t base, int row0, int s) {
  constexpr int CH = HD / 8, RS = HD + TILE_PAD;
  for (int c = threadIdx.x; c < 64 * CH; c += NTHREADS) {
    const int r = c / CH, col = c % CH * 8, row = row0 + r;
    const bool in = row < s;
    cp_async16_zfill(dst + r * RS + col, src + base + (size_t)(in ? row : 0) * HD + col, in);
  }
}

// The A fragment of the 16 rows from row0 at k-step kd, from a row-major
// tile of row stride RS.
template <int RS>
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                           int row0, int kd) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * RS + kd * 16 + (lane >> 4) * 8);
}

// B fragments {r[0], r[1]} and {r[2], r[3]} of the n-tiles at n0 and n0 + 8,
// k-step kd, from a tile stored [n][k] (the col-major B operand).
template <int RS>
__device__ __forceinline__ void ldmatrix_b_nk(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                              int n0, int kd) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * RS + kd * 16 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments {r[0], r[1]} and {r[2], r[3]} of n-tiles nd and nd + 1, the
// k-step of rows k0 .. k0 + 15, from a tile stored [k][n] (the row-major B
// operand, by ldmatrix.trans).
template <int RS>
__device__ __forceinline__ void ldmatrix_b_kn(uint32_t (&r)[4], const __nv_bfloat16* tile,
                                              int k0, int nd) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + nd * 8 +
                           (lane >> 4) * 8);
}

// Two floats as one bf16x2 register, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace valle2
