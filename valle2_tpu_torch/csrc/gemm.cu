// bf16 GEMM with f32 accumulation on Hopper's tensor cores (sm_90a), CUDA
// C++: C (M, N) bf16 = A (M, K) bf16 @ B (K, N) bf16, all row-major.
//
// Replaces the Pallas TPU kernels of the repo's roofline probe,
// probes/_gemm_pallas_roofline.py: matmul_fullk (:46) -> _fullk_kernel (#9,
// one program per output tile holding all of K) and matmul_ksplit (:84) ->
// _ksplit_kernel (#10, K carried over an f32 accumulator in a sequential grid
// axis).
//
// What bounds it on this card: operations.  At the probe's shapes (4096^3 and
// the 204M training step's 10240 x 1024 x 4096 and 10240 x 1024 x 1024) a
// GEMM does 488-1365 operations per byte it must move, above the H100's ~295
// bf16 operations a byte at all three, and only wgmma reaches the tensor
// cores' 989 TFLOP/s bf16 peak.
//
// Design, one mainloop for both kernels.  A block of three warpgroups owns a
// 128 x BN output tile (BN 128 or 256).  The producer warpgroup gives up its
// registers (setmaxnreg.dec to 40) and one of its threads keeps TMA loads in
// flight: per 64-deep K stage, A (128 x 64, one box) and B (64 x BN, BN / 64
// boxes of 64 x 64), both with the 128-byte swizzle, into a ring of STAGES
// stages (6 x 32 KB at BN 128, 4 x 48 KB at BN 256), each with a "full"
// mbarrier (TMA bytes) and an "empty" one (the eight consumer warps).  The
// two consumer warpgroups (setmaxnreg.inc to 232) own 64 rows each and issue
// one wgmma m64n{BN}k16 per k16 from shared memory (A K-major, B MN-major by
// the transpose bit), keeping one stage's group in flight: a stage is
// released only after wait_group<1> has retired the wgmmas that read it.
// K is taken in multiples of 32: where a slice's last stage holds 32 of its
// 64 values, the consumers issue only its first two k16 steps.
//
// #9 is persistent: one block per SM walks output tiles in a grouped raster
// order (8 tile rows a group, so that the blocks in flight share A and B
// panels in L2), and the producer loads the next tile's stages while the
// consumers round theirs to bf16 and store them: each consumer warpgroup
// writes its rows into a swizzled staging tile in shared memory, from which
// TMA stores them, 128 columns at a time, while the warpgroup goes on to the
// next tile (direct bf16x2 stores from the registers, eight rows of 16 bytes
// a warp instruction, kept the consumers from the tensor cores far longer).
//
// #10: the TPU's K axis is a sequential grid loop, and Hopper's blocks run in
// no order, so the K split is a grid axis of its own, and the splits of one
// output tile are one thread-block cluster (cluster dims (1, 1, splits),
// splits <= 8, the portable cluster size).  Block z runs the mainloop over K
// slice z (one tile a block, not persistent), writes its f32 partial into its
// own shared memory (the ring is free by then), and after a cluster barrier
// all 384 of its threads sum its share of the tile's rows over every block's
// partial through distributed shared memory, in the order z' = 0, 1, ...,
// splits - 1, round to bf16 and write C once; a last cluster barrier keeps
// each block's partial alive until its peers have read it.  No workspace in
// device memory, no atomics: the result repeats bit for bit, and at splits =
// 1 it is #9's.  While a block reduces, its SM's tensor cores wait: that and
// each block's start (its first stages' load latency) are #10's cost over #9
// (probes/gemm_ablate.py times the parts).
//
// A block holds 168 registers a thread and up to 225 KB of shared memory, so
// one block runs on an SM.  Two would need 80 registers a thread at launch,
// and ptxas holds the whole kernel to that, under the 90 a wgmma m64n128k16
// takes, whatever setmaxnreg gives the consumers later.

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace valle2;
using namespace valle2::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;        // rows of an output tile: two consumer warpgroups of 64
constexpr int BK = 64;         // K of a stage: one 128-byte swizzled row of A
constexpr int THREADS = 384;   // producer warpgroup, then two consumer warpgroups
constexpr int GROUP_M = 8;     // tile rows of one raster group (#9)
constexpr int CONSUMER_WARPS = 8;
// setmaxnreg: 168 registers a thread at launch (65536 / 384), then the
// producer warpgroup gives its registers to the consumers: 128 x 40 + 256 x
// 232 = 64512.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr uint32_t BOX_BYTES = 64 * 64 * 2;   // one 64 x 64 bf16 box (B's, and C's for #9)
// A consumer warpgroup's staging tile of C: 64 rows x 128 columns, two boxes.
constexpr uint32_t STAGING_BYTES = 2 * BOX_BYTES;

// The shape of a block of #9 (SPLIT false) or #10 (SPLIT true) at tile
// width BN.
template <int BN_, bool SPLIT>
struct Cfg {
  static constexpr int BN = BN_;
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr uint32_t A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
  static constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int ACC = BN / 2;            // f32 accumulators a consumer thread holds
  static constexpr int PART_STRIDE = BN + 8;    // f32 row stride of #10's partial tile
  static constexpr size_t RING = (size_t)STAGES * STAGE_BYTES;
  static constexpr size_t STAGING = SPLIT ? 0 : 2 * STAGING_BYTES;
  // 1024 bytes of slack to align the ring to the swizzle's period, then the
  // ring, #9's staging tiles of C, then STAGES full and STAGES empty barriers.
  static constexpr size_t SMEM = 1024 + RING + STAGING + 2 * STAGES * sizeof(uint64_t);
  static_assert(!SPLIT || (size_t)BM * PART_STRIDE * sizeof(float) <= RING,
                "#10's partial must fit the ring");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

template <class C>
struct Ring {
  uint8_t* base;      // stage s at base + s * STAGE_BYTES: A, then B's boxes
  uint8_t* staging;   // #9: [2][STAGING_BYTES], consumer warpgroup w's staging tile of C
  uint64_t* full;     // [STAGES]: the producer's arrival and the TMA bytes
  uint64_t* empty;    // [STAGES]: one arrival per consumer warp

  __device__ __forceinline__ explicit Ring(unsigned char* raw) {
    base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    staging = base + C::RING;
    full = reinterpret_cast<uint64_t*>(staging + C::STAGING);
    empty = full + C::STAGES;
  }

  // By one thread, before the block's other threads use the barriers.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
};

// The producer's side of the mainloop, one thread: the n_st stages of A[m0:
// m0 + BM, k0:] and B[k0:, n0: n0 + BN] into the ring.  `it` counts the
// stages this block has loaded, so the stage is it % STAGES and its fill the
// (it / STAGES)-th (the parity of the phases waited on).
template <class C>
__device__ __forceinline__ void produce(const CUtensorMap* ta, const CUtensorMap* tb,
                                        const Ring<C>& r, int m0, int n0, int k0, int n_st,
                                        uint32_t& it) {
  for (int s = 0; s < n_st; ++s, ++it) {
    const uint32_t st = it % C::STAGES, parity = (it / C::STAGES) & 1;
    mbar_wait(&r.empty[st], parity ^ 1);
    mbar_arrive_expect_tx(&r.full[st], C::STAGE_BYTES);
    uint8_t* a = r.base + st * C::STAGE_BYTES;
    const int k = k0 + s * BK;
    tma_load_2d(a, ta, &r.full[st], k, m0);
#pragma unroll
    for (int j = 0; j < C::BN / 64; ++j)
      tma_load_2d(a + C::A_BYTES + j * BOX_BYTES, tb, &r.full[st], n0 + 64 * j, k);
  }
}

// The consumers' side: acc = this warpgroup's 64 rows (wg = 0 or 1) of the
// tile's product over its n_st stages; the last stage holds last_k16 (2 or
// 4) k16 steps.  Each warp releases a stage once the wgmmas that read it
// have retired.
template <class C>
__device__ __forceinline__ void consume(const Ring<C>& r, int wg, int n_st, int last_k16,
                                        float (&acc)[C::ACC], uint32_t& it) {
  const bool lane0 = threadIdx.x % 32 == 0;
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
  fence_regs(acc);
  uint32_t prev = 0;
  for (int s = 0; s < n_st; ++s, ++it) {
    const uint32_t st = it % C::STAGES, parity = (it / C::STAGES) & 1;
    mbar_wait(&r.full[st], parity);
    const uint32_t stage = smem_addr(r.base + st * C::STAGE_BYTES);
    // A: K-major, this warpgroup's 64 rows, 8-row groups 1024 bytes apart; a
    // k16 step is 32 bytes on.  B: MN-major, 64-wide column blocks (boxes) 8 KB
    // apart, 8-row k groups 1024 bytes apart; a k16 step is 16 rows (2048
    // bytes) on.
    const uint64_t da = smem_desc_sw128(stage + wg * 64 * BK * 2, 16, 1024);
    const uint64_t db = smem_desc_sw128(stage + C::A_BYTES, BOX_BYTES, 1024);
    const auto mma = [&](int kk) {   // k16 step kk of the stage
      if constexpr (C::BN == 256) wgmma_m64n256k16<1>(acc, da + 2 * kk, db + 128 * kk);
      else wgmma_m64n128k16<1>(acc, da + 2 * kk, db + 128 * kk);
    };
    wgmma_fence();
    // Each case is one straight run of wgmmas (steps 2 and 3 in a branch of
    // their own made #9 slower).
    if (s + 1 < n_st || last_k16 == 4) {
      mma(0);
      mma(1);
      mma(2);
      mma(3);
    } else {
      mma(0);
      mma(1);
    }
    wgmma_commit();
    wgmma_wait<1>();   // this stage's group may still run; the one before has retired
    if (s > 0 && lane0) mbar_arrive(&r.empty[prev]);
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (lane0) mbar_arrive(&r.empty[prev]);
}

// (stages, k16 steps of the last stage) of a K slice (a multiple of 32).
__device__ __forceinline__ void stages_of(int k_slice, int& n_st, int& last_k16) {
  n_st = (k_slice + BK - 1) / BK;
  last_k16 = (k_slice - (n_st - 1) * BK) / 16;
}

// This thread's accumulator (row, column) in the tile: d[4j + 2i + c] is
// row row0 + 8i, column col0 + 8j + c.
__device__ __forceinline__ void acc_origin(int wg, int& row0, int& col0) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  row0 = wg * 64 + warp * 16 + lane / 4;
  col0 = 2 * (lane % 4);
}

// Rounds this consumer warpgroup's 64 x BN accumulators to bf16 and stores
// them at C (m0 + 64 wg, n0) by TMA, 128 columns at a time through the
// warpgroup's staging tile (two 64 x 64 boxes with the 128-byte swizzle, so
// that the eight rows of a fragment write fall in distinct banks).  The
// warpgroup's thread 0 issues the stores, and the tile is written again only
// once the stores before it have read it.
template <class C>
__device__ __forceinline__ void store_tile(const CUtensorMap* tc, uint8_t* staging,
                                           const float (&acc)[C::ACC], int wg, int m0, int n0) {
  const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
  const int bar = 2 + wg;                    // the warpgroup's named barrier
  const int sw = lane / 4;                   // row % 8 of both of this thread's rows
#pragma unroll
  for (int pass = 0; pass < C::BN / 128; ++pass) {
    if (t == 0) bulk_wait_read<0>();
    named_barrier_sync(bar, 128);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {        // the pass's 8-column chunks
      const int j = pass * 16 + jj;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = warp * 16 + lane / 4 + 8 * i;
        *reinterpret_cast<uint32_t*>(staging + jj / 8 * BOX_BYTES + row * 128 +
                                     (jj % 8 ^ sw) * 16 + lane % 4 * 4) =
            pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    fence_proxy_async_smem();
    named_barrier_sync(bar, 128);
    if (t == 0) {
      tma_store_2d(tc, staging, n0 + pass * 128, m0 + 64 * wg);
      tma_store_2d(tc, staging + BOX_BYTES, n0 + pass * 128 + 64, m0 + 64 * wg);
      bulk_commit();
    }
  }
}

// #9: grid min(tiles, SMs), persistent.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_fullk_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tc, int M, int N, int K) {
  using Cf = Cfg<BN, false>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<Cf> r(smem_raw);
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  const int tiles_m = M / BM, tiles_n = N / BN, tiles = tiles_m * tiles_n;
  const int per_group = GROUP_M * tiles_n;
  int n_st, last_k16;
  stages_of(K, n_st, last_k16);
  uint32_t it = 0;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&ta);
      prefetch_tensormap(&tb);
      prefetch_tensormap(&tc);
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int first = t / per_group * GROUP_M, rows = min(tiles_m - first, GROUP_M);
        const int tm = first + t % per_group % rows, tn = t % per_group / rows;
        produce<Cf>(&ta, &tb, r, tm * BM, tn * BN, 0, n_st, it);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    float acc[Cf::ACC];
    uint8_t* staging = r.staging + (wg - 1) * STAGING_BYTES;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int first = t / per_group * GROUP_M, rows = min(tiles_m - first, GROUP_M);
      const int tm = first + t % per_group % rows, tn = t % per_group / rows;
      consume<Cf>(r, wg - 1, n_st, last_k16, acc, it);
      store_tile<Cf>(&tc, staging, acc, wg - 1, tm * BM, tn * BN);
    }
    if (threadIdx.x % 128 == 0) bulk_wait<0>();   // C is written before the block ends
  }
}

// #10's reduction, by all the block's threads: C rows [r0, r1) of the tile
// at (m0, n0), this block's share, = bf16 of the sum over the cluster's
// blocks of their f32 partials (at `part` in each block's shared memory), in
// the order z' = 0, 1, ..., splits - 1, four columns a step.
template <class C>
__device__ __forceinline__ void reduce_rows(bf16* __restrict__ out, int N, int m0, int n0,
                                            uint32_t z, int splits, uint32_t part) {
  const int r0 = (int)z * BM / splits, r1 = ((int)z + 1) * BM / splits;
  constexpr int QUADS = C::BN / 4;
  for (int i = threadIdx.x; i < (r1 - r0) * QUADS; i += THREADS) {
    const int row = r0 + i / QUADS, col = i % QUADS * 4;
    const uint32_t at = part + (uint32_t)(row * C::PART_STRIDE + col) * sizeof(float);
    float4 s = ld_cluster_f4(map_to_rank(at, 0));
    for (int q = 1; q < splits; ++q) {
      const float4 p = ld_cluster_f4(map_to_rank(at, q));
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + row) * N + n0 + col);
    o[0] = __floats2bfloat162_rn(s.x, s.y);
    o[1] = __floats2bfloat162_rn(s.z, s.w);
  }
}

// #10: grid (N / BN, M / BM, splits), one cluster per output tile.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gemm_ksplit_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   bf16* __restrict__ C, int N, int k_slice) {
  using Cf = Cfg<BN, true>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<Cf> r(smem_raw);
  if (threadIdx.x == 0) r.init();
  __syncthreads();
  const int splits = gridDim.z;
  const uint32_t z = cluster_ctarank();   // == blockIdx.z: the cluster spans z
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int n_st, last_k16;
  stages_of(k_slice, n_st, last_k16);
  uint32_t it = 0;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&ta);
      prefetch_tensormap(&tb);
      produce<Cf>(&ta, &tb, r, m0, n0, z * k_slice, n_st, it);
    }
    __syncwarp();
    cluster_sync();   // the partials are written
    reduce_rows<Cf>(C, N, m0, n0, z, splits, smem_addr(r.base));
    cluster_sync();   // and read
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    float acc[Cf::ACC];
    consume<Cf>(r, wg - 1, n_st, last_k16, acc, it);
    // Both consumer warpgroups are past their last wgmma, and every stage has
    // been waited on: the ring is free.
    named_barrier_sync(1, 256);
    float* part = reinterpret_cast<float*>(r.base);
    int row0, col0;
    acc_origin(wg - 1, row0, col0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(part + row0 * Cf::PART_STRIDE + col0 + 8 * j) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(part + (row0 + 8) * Cf::PART_STRIDE + col0 + 8 * j) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    cluster_sync();   // the partials are written
    reduce_rows<Cf>(C, N, m0, n0, z, splits, smem_addr(part));
    cluster_sync();   // and read
  }
}

// ---- host side ----

// A (rows, cols) row-major bf16 matrix at ptr, read in boxes of box_rows x 64
// columns (128 bytes: the 128-byte swizzle's row).
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor maps are encoded on the host at every call, beside the launch
// (their time is in the probe's one-call times, not in its back-to-back ones).
cudaError_t operand_maps(CUtensorMap* ta, CUtensorMap* tb, const bf16* a, const bf16* b, int m,
                         int n, int k) {
  cudaError_t err = tensor_map(ta, a, m, k, BM);
  return err != cudaSuccess ? err : tensor_map(tb, b, k, n, BK);
}

template <typename Kernel>
cudaError_t allow_smem(unsigned& done, Kernel kernel, size_t bytes) {
  return once_per_device(done, [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  });
}

template <int BN>
int launch_fullk(const bf16* a, const bf16* b, bf16* c, int m, int n, int k,
                 cudaStream_t stream) {
  static unsigned configured = 0;
  constexpr size_t smem = Cfg<BN, false>::SMEM;
  cudaError_t err = allow_smem(configured, gemm_fullk_kernel<BN>, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  CUtensorMap ta, tb, tc;
  if (err == cudaSuccess) err = operand_maps(&ta, &tb, a, b, m, n, k);
  if (err == cudaSuccess) err = tensor_map(&tc, c, m, n, 64);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (m / BM) * (n / BN);
  gemm_fullk_kernel<BN><<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(ta, tb, tc, m, n, k);
  return (int)cudaGetLastError();
}

constexpr int MAX_SPLITS = 8;   // the portable cluster size

template <int BN>
int launch_ksplit(const bf16* a, const bf16* b, bf16* c, int m, int n, int k, int splits,
                  cudaStream_t stream) {
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  static unsigned configured = 0;
  // Per card and cluster size: 0 not asked yet, 1 schedulable, -1 not.
  static signed char fits[32][MAX_SPLITS + 1];
  constexpr size_t smem = Cfg<BN, true>::SMEM;
  cudaError_t err = allow_smem(configured, gemm_ksplit_kernel<BN>, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  CUtensorMap ta, tb;
  if (err == cudaSuccess) err = operand_maps(&ta, &tb, a, b, m, n, k);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / BN, m / BM, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  signed char* fit = dev < 32 ? &fits[dev][splits] : nullptr;
  if (fit == nullptr || *fit == 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, gemm_ksplit_kernel<BN>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit != nullptr) *fit = clusters > 0 ? 1 : -1;
    if (clusters <= 0) return (int)cudaErrorLaunchOutOfResources;
  } else if (*fit < 0) {
    return (int)cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&cfg, gemm_ksplit_kernel<BN>, ta, tb, c, n, k / splits);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// The wrappers (kernels/gemm.py) check dtype, shape, tile divisibility (m %
// bm, n % bn, k % 32, and for #10 k % (32 * splits), 1 <= splits <= 8),
// contiguity and 16-byte alignment.  Tiles (bm, bn): (128, 128) or (128,
// 256).  Each returns a cudaError_t: a refused argument, a tensor map
// libcuda would not encode, a cluster that cannot be scheduled
// (cudaErrorLaunchOutOfResources), or cudaGetLastError() after the launch.
extern "C" int valle2_gemm_fullk(const void* a, const void* b, void* c, int m, int n, int k,
                                 int bm, int bn, void* stream) {
  auto A = static_cast<const bf16*>(a);
  auto B = static_cast<const bf16*>(b);
  auto C = static_cast<bf16*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) return launch_fullk<128>(A, B, C, m, n, k, st);
  if (bm == 128 && bn == 256) return launch_fullk<256>(A, B, C, m, n, k, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int valle2_gemm_ksplit(const void* a, const void* b, void* c, int m, int n, int k,
                                  int splits, int bm, int bn, void* stream) {
  auto A = static_cast<const bf16*>(a);
  auto B = static_cast<const bf16*>(b);
  auto C = static_cast<bf16*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) return launch_ksplit<128>(A, B, C, m, n, k, splits, st);
  if (bm == 128 && bn == 256) return launch_ksplit<256>(A, B, C, m, n, k, splits, st);
  return (int)cudaErrorInvalidValue;
}
