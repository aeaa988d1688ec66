// Residual vector quantization encode for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel valle2_tpu/kernels/rvq.py (rvq_encode_fused
// -> _rvq_kernel): for every latent frame x (D = 128 floats) and each of the
// n_q stages in turn, code = argmax over the V codewords c of 2 x.c - |c|^2
// (the first index on ties), then x -= c[code].  Input latents (rows, 128) f32
// with rows = B*T, codebooks (n_q, V, 128) f32; output codes (B, n_q, T) int32.
//
// What bounds it: 2 * rows * n_q * V * 128 FLOPs of f32 products against a few
// MB of bytes -- at B=16, T=300 that is 10 GFLOP against 6.7 MB, so the card's
// f32 rate on the CUDA cores (67 TFLOP/s) bounds it, not its memory.  The
// products stay in full f32 FMAs, not TF32 tensor cores: TF32 keeps ~3
// decimal digits and would flip argmax winners that the plain version picks.
//
// Design: frames are independent, so one block takes a tile of 32 frames
// (the ragged tail masked here, not padded by the caller) and keeps their
// residuals in shared memory for all n_q stages.  The 4 MB codebook stack does
// not fit in shared memory but stays in the 50 MB L2; it streams through
// shared memory in tiles of 128 codewords with coalesced 16-byte loads.  Each
// warp owns 8 frames and each lane 4 codewords of a tile (lane + 32 j, so the
// lanes' 16-byte reads fall in distinct banks, and the frame reads broadcast):
// 32 f32 dot products per thread, each summed in k order by FMAs.  |c|^2 is
// computed once per call by a first kernel into an (n_q, V) scratch.  Each
// thread keeps a running (best score, index) per frame, replaced only on a
// strictly greater score while it walks its codewords in increasing order;
// the warp then reduces with shuffles, the lower index winning equal scores,
// which is argmax's first-index rule.  The chosen codeword row is gathered
// from L2 and subtracted from the residual in place (the Pallas kernel's
// one-hot matmul exists only because Mosaic has no row gather).  A frame's
// residual is read and written only by its own warp, so stages need no block
// barrier, only the codeword tiles do.
//
// The sums run in another order than cuBLAS or the CPU, so two codewords
// whose scores lie within f32 rounding of each other can swap; the caller's
// check holds the kernel to the plain version under that tie rule.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace valle2;

constexpr int D = 128;             // latent width (EnCodec)
constexpr int FPW = 8;             // frames per warp
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;     // 128 threads
constexpr int BT = FPW * WARPS;    // 32 frames per block
constexpr int CPL = 4;             // codewords per lane per tile
constexpr int BV = 32 * CPL;       // 128 codewords per tile
constexpr int ST = D + 4;          // padded row stride (floats), 16-byte aligned
constexpr size_t SMEM = sizeof(float) * (BT + BV) * ST;

// |c|^2 of every codeword: one warp per row.
__global__ void code_sq_norm_kernel(const float* __restrict__ cb, float* __restrict__ csq,
                                    int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float4 c = __ldg(reinterpret_cast<const float4*>(cb + (size_t)row * D) + lane);
  float s = c.x * c.x;
  s = fmaf(c.y, c.y, s);
  s = fmaf(c.z, c.z, s);
  s = fmaf(c.w, c.w, s);
  s = warp_sum(s);
  if (lane == 0) csq[row] = s;
}

__global__ void __launch_bounds__(NT)
rvq_encode_kernel(const float* __restrict__ cb, const float* __restrict__ csq,
                  const float* __restrict__ lat, int* __restrict__ codes, int rows,
                  int t_len, int n_q, int V) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [BT][ST] residuals
  float* cs = xs + BT * ST;                       // [BV][ST] codeword tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BT;

  for (int i = tid; i < BT * (D / 4); i += NT) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) v = __ldg(reinterpret_cast<const float4*>(lat + (size_t)(row0 + r) * D) + c4);
    reinterpret_cast<float4*>(xs + r * ST)[c4] = v;
  }
  float* xw = xs + warp * FPW * ST;               // this warp's frames

  for (int q = 0; q < n_q; ++q) {
    const float* cbq = cb + (size_t)q * V * D;
    float best[FPW];
    int bidx[FPW];
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      best[f] = -__int_as_float(0x7f800000);     // -inf
      bidx[f] = 0;
    }
    for (int v0 = 0; v0 < V; v0 += BV) {
      __syncthreads();                            // the previous tile is read
      for (int i = tid; i < BV * (D / 4); i += NT) {
        const int r = i / (D / 4), c4 = i % (D / 4);
        reinterpret_cast<float4*>(cs + r * ST)[c4] =
            __ldg(reinterpret_cast<const float4*>(cbq + (size_t)(v0 + r) * D) + c4);
      }
      __syncthreads();
      float acc[FPW][CPL];
#pragma unroll
      for (int f = 0; f < FPW; ++f)
#pragma unroll
        for (int j = 0; j < CPL; ++j) acc[f][j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < D; k += 4) {
        float4 c[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          c[j] = *reinterpret_cast<const float4*>(cs + (lane + 32 * j) * ST + k);
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          const float4 x = *reinterpret_cast<const float4*>(xw + f * ST + k);
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            acc[f][j] = fmaf(x.x, c[j].x, acc[f][j]);
            acc[f][j] = fmaf(x.y, c[j].y, acc[f][j]);
            acc[f][j] = fmaf(x.z, c[j].z, acc[f][j]);
            acc[f][j] = fmaf(x.w, c[j].w, acc[f][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int v = v0 + lane + 32 * j;
        const float n = __ldg(csq + (size_t)q * V + v);
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          const float s = __fsub_rn(__fmul_rn(2.0f, acc[f][j]), n);
          if (s > best[f]) {
            best[f] = s;
            bidx[f] = v;
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best[f], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[f], off);
        if (os > best[f] || (os == best[f] && oi < bidx[f])) {
          best[f] = os;
          bidx[f] = oi;
        }
      }
      const int r = row0 + warp * FPW + f;
      if (lane == 0 && r < rows)
        codes[(size_t)(r / t_len) * n_q * t_len + (size_t)q * t_len + r % t_len] = bidx[f];
      const float4 c = __ldg(reinterpret_cast<const float4*>(cbq + (size_t)bidx[f] * D) + lane);
      float4* xp = reinterpret_cast<float4*>(xw + f * ST) + lane;
      float4 x = *xp;
      x.x = __fsub_rn(x.x, c.x);
      x.y = __fsub_rn(x.y, c.y);
      x.z = __fsub_rn(x.z, c.z);
      x.w = __fsub_rn(x.w, c.w);
      *xp = x;
    }
    __syncwarp();
  }
}

}  // namespace

// codebooks (n_q, V, 128) and latents (rows, 128) f32, contiguous; csq an
// (n_q, V) f32 scratch; codes (rows / t_len, n_q, t_len) int32.  V must be a
// multiple of 128.  Returns the first non-zero cudaGetLastError() of the two
// launches.
extern "C" int valle2_rvq_encode(const float* codebooks, const float* latents, float* csq,
                                 int* codes, int rows, int t_len, int n_q, int V,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || t_len <= 0 || n_q <= 0 || V <= 0 || V % BV != 0)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(rvq_encode_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int norm_rows = n_q * V;
  code_sq_norm_kernel<<<(norm_rows + 7) / 8, 256, 0, st>>>(codebooks, csq, norm_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rvq_encode_kernel<<<(rows + BT - 1) / BT, NT, SMEM, st>>>(codebooks, csq, latents, codes,
                                                            rows, t_len, n_q, V);
  return (int)cudaGetLastError();
}
