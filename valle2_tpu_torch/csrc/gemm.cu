// bf16 GEMM with f32 accumulation on the tensor cores for Hopper (sm_90a),
// CUDA C++: C (M, N) bf16 = A (M, K) bf16 @ B (K, N) bf16, all row-major.
//
// Replaces the Pallas TPU kernels of the repo's roofline probe,
// probes/_gemm_pallas_roofline.py: matmul_fullk -> _fullk_kernel (#9, one
// program per output tile holding all of K) and matmul_ksplit ->
// _ksplit_kernel (#10, K carried over an f32 accumulator in a sequential grid
// axis).
//
// What bounds it on this card: operations.  At the probe's shapes (4096^3 and
// the 204M training step's 10240 x 1024 x 4096 and 10240 x 1024 x 1024) a
// GEMM does 488-1365 operations per byte it must move, above the H100's ~295
// bf16 operations a byte at all three, and the tensor cores are the only unit
// that can reach the 989 TFLOP/s bf16 peak.  So the products are
// mma.sync m16n8k16 bf16 -> f32 (warp-level tensor-core instructions; wgmma,
// TMA and a persistent warp-specialised schedule are later work).
//
// Design, both kernels: a block of 256 threads (8 warps, 2 x 4) owns a BM x
// BN output tile (128 x 128 or 128 x 256; each warp a 64 x BN/4 sub-tile of
// 16 x 8 mma fragments).  K is walked in 32-wide stages through a 3-deep ring
// of shared-memory tiles filled by cp.async (16 bytes a thread), so the next
// stages' loads are in flight while the tensor cores work on the current one.
// Fragments come from shared memory by ldmatrix (B with .trans, as B is
// stored K-major; the fragment helpers are common.cuh's, shared with #1); rows are padded by 16 bytes so the 8 rows of an ldmatrix
// fall in distinct banks.
//
// #9 walks all of K in the block, keeps the sums in registers and writes bf16
// once.  #10: the TPU's K axis is a sequential grid loop, and Hopper's blocks
// run in no order, so the K split is a grid axis of its own: block (m, n, z)
// sums the z-th K slice and writes its f32 partial to a workspace the wrapper
// allocates; a second kernel sums the slices in the order z = 0, 1, ... and
// rounds to bf16.  The result is deterministic, with no atomics.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace valle2;
using bf16 = __nv_bfloat16;

constexpr int BK = 32;       // K per shared-memory stage
constexpr int STAGES = 3;    // depth of the cp.async ring
constexpr int PAD = 8;       // bf16 elements (16 bytes) of padding per smem row
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;

template <int BM, int BN>
struct Tile {
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // warp sub-tile
  static constexpr int MI = WTM / 16, NI = WTN / 8;             // mma fragments
  static constexpr int AS = BK + PAD, BS = BN + PAD;            // smem row strides
  static constexpr int A_ELEMS = BM * AS, B_ELEMS = BK * BS;
  static constexpr size_t SMEM = sizeof(bf16) * STAGES * (A_ELEMS + B_ELEMS);
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tile must hold whole fragments");
};

// Issue the cp.async copies of one K stage: A[m0:m0+BM, k0:k0+BK] and
// B[k0:k0+BK, n0:n0+BN].
template <int BM, int BN>
__device__ __forceinline__ void load_stage(const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, bf16* As, bf16* Bs,
                                           int m0, int n0, int k0, int K, int N) {
  using T = Tile<BM, BN>;
  constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BK * BN / 8;
  for (int c = threadIdx.x; c < A_CHUNKS; c += THREADS) {
    const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
    cp_async16(As + row * T::AS + col, A + (size_t)(m0 + row) * K + k0 + col);
  }
  for (int c = threadIdx.x; c < B_CHUNKS; c += THREADS) {
    const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
    cp_async16(Bs + row * T::BS + col, B + (size_t)(k0 + row) * N + n0 + col);
  }
}

// acc = A[m0:, k_begin : k_begin + n_k * BK] @ B[k_begin : ..., n0:] for this
// thread's fragments.
template <int BM, int BN>
__device__ __forceinline__ void mainloop(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                         int K, int N, int m0, int n0, int k_begin, int n_k,
                                         float (&acc)[Tile<BM, BN>::MI][Tile<BM, BN>::NI][4],
                                         bf16* smem) {
  using T = Tile<BM, BN>;
  bf16* As = smem;
  bf16* Bs = smem + STAGES * T::A_ELEMS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_k)
      load_stage<BM, BN>(A, B, As + st * T::A_ELEMS, Bs + st * T::B_ELEMS, m0, n0,
                         k_begin + st * BK, K, N);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();   // stage kt has landed (for this thread) ...
    __syncthreads();               // ... for every thread; stage kt - 1 is no longer read
    const int pf = kt + STAGES - 1;
    if (pf < n_k)
      load_stage<BM, BN>(A, B, As + (pf % STAGES) * T::A_ELEMS, Bs + (pf % STAGES) * T::B_ELEMS,
                         m0, n0, k_begin + pf * BK, K, N);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * T::A_ELEMS;
    const bf16* bs = Bs + (kt % STAGES) * T::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[T::MI][4], bfr[T::NI][2];
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
        ldmatrix_x4(af[mi], as + (wm * T::WTM + mi * 16 + (lane & 15)) * T::AS + kk +
                                (lane >> 4) * 8);
#pragma unroll
      for (int ni = 0; ni < T::NI; ni += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * T::BS +
                                 wn * T::WTN + ni * 8 + (lane >> 4) * 8);
        bfr[ni][0] = r[0];
        bfr[ni][1] = r[1];
        bfr[ni + 1][0] = r[2];
        bfr[ni + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();
}

// #9: grid (N / BN, M / BM).
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
gemm_fullk_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
                  int N, int K) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[T::MI][T::NI][4];
  mainloop<BM, BN>(A, B, K, N, m0, n0, 0, K / BK, acc, reinterpret_cast<bf16*>(smem_raw));

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int row = m0 + wm * T::WTM + mi * 16 + gid;
      const int col = n0 + wn * T::WTN + ni * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
          __floats2bfloat162_rn(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<__nv_bfloat162*>(C + (size_t)(row + 8) * N + col) =
          __floats2bfloat162_rn(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// #10, first pass: grid (N / BN, M / BM, splits); block z writes the f32
// partial of K slice z to ws[z].
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
gemm_ksplit_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                   float* __restrict__ ws, int M, int N, int K, int k_slice) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  float acc[T::MI][T::NI][4];
  mainloop<BM, BN>(A, B, K, N, m0, n0, z * k_slice, k_slice / BK, acc,
                   reinterpret_cast<bf16*>(smem_raw));

  float* part = ws + (size_t)z * M * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int row = m0 + wm * T::WTM + mi * 16 + gid;
      const int col = n0 + wn * T::WTN + ni * 8 + tig * 2;
      *reinterpret_cast<float2*>(part + (size_t)row * N + col) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(part + (size_t)(row + 8) * N + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// #10, second pass: C = bf16(sum_z ws[z]) in the order z = 0, 1, ..., four
// elements a thread.
__global__ void __launch_bounds__(256)
ksplit_reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ C, size_t mn,
                     int splits) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 s = *reinterpret_cast<const float4*>(ws + i);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(ws + (size_t)z * mn + i);
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(C + i);
  out[0] = __floats2bfloat162_rn(s.x, s.y);
  out[1] = __floats2bfloat162_rn(s.z, s.w);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  configured = err == cudaSuccess;
  return err;
}

template <int BM, int BN>
int launch_fullk(const bf16* a, const bf16* b, bf16* c, int m, int n, int k,
                 cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t smem = Tile<BM, BN>::SMEM;
  cudaError_t err = allow_smem(gemm_fullk_kernel<BM, BN>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  gemm_fullk_kernel<BM, BN><<<dim3(n / BN, m / BM), THREADS, smem, stream>>>(a, b, c, n, k);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_ksplit(const bf16* a, const bf16* b, float* ws, bf16* c, int m, int n, int k,
                  int splits, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t smem = Tile<BM, BN>::SMEM;
  cudaError_t err = allow_smem(gemm_ksplit_kernel<BM, BN>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  gemm_ksplit_kernel<BM, BN><<<dim3(n / BN, m / BM, splits), THREADS, smem, stream>>>(
      a, b, ws, m, n, k, k / splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t mn = (size_t)m * n;
  const unsigned blocks = (unsigned)((mn / 4 + 255) / 256);
  ksplit_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, c, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrappers check dtype, shape, tile divisibility (m % bm, n % bn, k % 32,
// and for #10 k % (32 * splits)), contiguity and 16-byte alignment.  Tiles
// (bm, bn): (128, 128) or (128, 256).  Each returns cudaGetLastError() after
// its launches.
extern "C" int valle2_gemm_fullk(const void* a, const void* b, void* c, int m, int n, int k,
                                 int bm, int bn, void* stream) {
  auto A = static_cast<const bf16*>(a);
  auto B = static_cast<const bf16*>(b);
  auto C = static_cast<bf16*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) return launch_fullk<128, 128>(A, B, C, m, n, k, st);
  if (bm == 128 && bn == 256) return launch_fullk<128, 256>(A, B, C, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

// ws: (splits, m, n) float32 scratch.
extern "C" int valle2_gemm_ksplit(const void* a, const void* b, float* ws, void* c, int m,
                                  int n, int k, int splits, int bm, int bn, void* stream) {
  auto A = static_cast<const bf16*>(a);
  auto B = static_cast<const bf16*>(b);
  auto C = static_cast<bf16*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) return launch_ksplit<128, 128>(A, B, ws, C, m, n, k, splits, st);
  if (bm == 128 && bn == 256) return launch_ksplit<128, 256>(A, B, ws, C, m, n, k, splits, st);
  return (int)cudaErrorInvalidValue;
}
