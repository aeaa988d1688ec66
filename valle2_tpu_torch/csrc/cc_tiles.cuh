// Register-tiled f32 products on the CUDA cores, shared by the flash
// forward's CUDA-core route (flash_attention.cu: f32, and bf16 for timing)
// and the f32 flash backward (flash_attention_bwd.cu).
//
// Operands live in shared memory as f32 tiles of row stride HD + 4 (16-byte
// rows whose stride is 4 mod 32 banks, so the 8 rows a quarter warp reads as
// float4 fall in distinct banks and one row broadcasts), staged by cp.async
// 16 bytes a thread.  Every product is a micro-tile a thread holds in
// registers, fed by float4 shared reads: an 8 x 8 tile does 256 FFMAs per 16
// float4 reads, about what the SM's 128 bytes of shared memory a cycle feed
// its 128 FFMA lanes.  Each sum runs in a fixed order (explicit fmaf chains),
// so a result does not depend on how the caller is scheduled.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace valle2 {

constexpr int CC_KEYS = 64;               // keys per kv tile
constexpr int PS = CC_KEYS + 4;           // row stride of a [row][key] f32 tile (p, ds)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void put4(float* d, float4 v) {
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ROWS rows of an (s, HD) matrix from row0 into a shared f32 tile of row
// stride HD + 4, over NT threads; rows past s are zero.  f32 by cp.async, 16
// bytes a thread (zero-filled past s; the caller commits); bf16 8 values a
// thread, converted to f32 through registers.
template <typename T, int HD, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src, int row0,
                                           int s) {
  constexpr int RS = HD + 4;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int CH = HD / 4;
    for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
      const int r = c / CH, col = c % CH * 4, row = row0 + r;
      const bool in = row < s;
      cp_async16_zfill(dst + r * RS + col, src + (size_t)(in ? row : 0) * HD + col, in);
    }
  } else {
    constexpr int CH = HD / 8;
    for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
      const int r = c / CH, col = c % CH * 8, row = row0 + r;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (row < s) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)row * HD + col);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
        const float2 c2 = __bfloat1622float2(h2[2]), d = __bfloat1622float2(h2[3]);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(c2.x, c2.y, d.x, d.y);
      }
      *reinterpret_cast<float4*>(dst + r * RS + col) = lo;
      *reinterpret_cast<float4*>(dst + r * RS + col + 4) = hi;
    }
  }
}

// acc[i][j] += sum_d A[tm + MS i][d] B[tn + 8 j][d] over d < HD, for
// row-major [row][HD] tiles of stride HD + 4 (S = Q K^T; in the backward
// also S^T = K Q^T, dP = dO V^T and dP^T = V dO^T).  Per 4 d a thread reads
// TM + 8 float4 and does 32 TM FMAs; each sum runs over d in order.
template <int HD, int TM, int MS>
__device__ __forceinline__ void rows_dot(const float* A, const float* B, int tm, int tn,
                                         float (&acc)[TM][8]) {
  constexpr int RS = HD + 4;
  const float* a = A + tm * RS;
  const float* b = B + tn * RS;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = ld4(a + MS * i * RS + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = ld4(b + 8 * j * RS + d);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_c P[tm + RSTEP i][c] X[c][dim_j] over a tile's CC_KEYS
// keys c in order (O += P V in the forward; dQ += dS K in the backward):
// dims 4 tn + DSTEP (j / 4) + j % 4; P of stride PS, X of stride HD + 4.
template <int HD, int TM, int TN, int RSTEP, int DSTEP>
__device__ __forceinline__ void rows_times(const float* P, const float* X, int tm, int tn,
                                           float (&acc)[TM][TN]) {
  constexpr int RS = HD + 4;
#pragma unroll 2
  for (int c = 0; c < CC_KEYS; c += 4) {
    float a[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) put4(a[i], ld4(P + (tm + RSTEP * i) * PS + c));
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float xv[TN];
#pragma unroll
      for (int jb = 0; jb < TN / 4; ++jb)
        put4(xv + 4 * jb, ld4(X + (c + cc) * RS + 4 * tn + DSTEP * jb));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][cc], xv[j], acc[i][j]);
    }
  }
}

// Four values of a row to global memory as T (16 bytes f32, 8 bytes bf16).
template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c, float d);
template <>
__device__ __forceinline__ void store4<float>(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float a, float b,
                                                      float c, float d) {
  uint2 v;
  v.x = pack_bf16(a, b);
  v.y = pack_bf16(c, d);
  *reinterpret_cast<uint2*>(dst) = v;
}

}  // namespace valle2
