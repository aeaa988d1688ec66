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
// At a voice prompt (B=1, T=150) the work is 1/32 of that and the limit is
// how many SMs it reaches and the latency of the 8 serial stages.
//
// Design.  The stages are serial in the residual, but within a stage the V
// codewords are independent, and the frames are independent throughout.  A
// thread-block cluster of C CTAs (C in 1, 2, 4, 8, 16; 16 is a non-portable
// size) takes one tile of BT frames; CTA r of the cluster scores the
// codeword slice [r V / C, (r + 1) V / C) of every stage.  The host picks
// the tile and C from the shape so that the grid covers the SMs
// (kernels/rvq.py rvq_plan, a cost model fitted to this kernel's times): a
// prompt of 150 frames runs 10 tiles x 8 CTAs, where one CTA a 32-frame
// tile reached 5 SMs.  Each CTA keeps its own copy of the tile's residuals
// in shared memory.
//
// The codewords do not depend on the residual, so the CTA streams its slice
// of stage after stage, in chunks of BV codewords x 32 of the 128 columns,
// through a ring of NS = 4 chunks filled by cp.async: three chunks are in
// flight while one is scored, across tile and stage boundaries alike.  A
// thread scores TF frames x TJ codewords in registers; a warp's lanes are
// LG rows (frames) x 32 / LG columns (codewords), so a 16-byte shared read
// feeds 4 TJ or 4 TF FMAs: the lanes of a row read consecutive codeword
// rows (a stride of 36 floats puts 8 of them in distinct banks) and a frame
// read is a broadcast to the row.  The CTA's warps tile BT frames x BV
// codewords; the tiles (TILE_DIMS) run from 16 x 128 at 4 x 4 a thread,
// one lane row (a prompt: short stages, many CTAs), to 64 x 256 at 8 x 8 in
// four lane rows (a large batch: fewer shared reads a FMA).  A step's
// operands are all loaded before its FMAs.  Every dot product sums its 128
// terms in k order with fmaf.  |c|^2 is folded in: while a chunk sits in
// shared memory, NT / BV threads a codeword square-sum its 8 column quads
// as one pairwise tree (their blocks joined by a butterfly of shuffles in
// the tree's order, so every tile gets the same bits, as accurate as a
// pairwise sum), and the tile's four chunks add pairwise; so a call is one
// launch and nothing is cached between calls.
//
// The argmax: each thread keeps a running (best score, index) per frame,
// replaced only on a strictly greater score as it walks its codewords in
// increasing order; at the end of a stage a lane row's lanes, then
// the CTA's codeword warps, then the cluster's CTAs merge, the higher score
// winning and the lower index winning equal scores -- a total order, so the
// merge is argmax's first index whatever the order it runs in.  The CTAs
// exchange their per-frame bests through distributed shared memory (mapa +
// ld.shared::cluster after barrier.cluster; the exchange buffer alternates
// by stage parity, so one cluster barrier a stage suffices); every CTA then
// computes the same winner and subtracts that codeword (gathered from L2)
// from its own residual copy with the same __fsub_rn, so the copies stay
// identical.  The CTAs' bests are read from every peer at once, then merged
// in rank order.  CTA 0 of the cluster writes the codes.  A last cluster
// barrier keeps every CTA's shared memory alive until its peers have read
// it.
//
// The sums run in another order than cuBLAS or the CPU, so two codewords
// whose scores lie within f32 rounding of each other can swap; the caller's
// check holds the kernel to the plain version under that tie rule.  Two
// equal codewords get bit-equal scores wherever they sit (the same
// arithmetic), so an exact tie across CTAs goes to the lower index.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace valle2;
using namespace valle2::hopper;

constexpr int D = 128;             // latent width (EnCodec)
constexpr int XS = D + 4;          // residual row stride (floats), 16-byte aligned
constexpr int KC = 32;             // codeword columns of one streamed chunk
constexpr int CS = KC + 4;         // chunk row stride: 8 consecutive rows hit distinct banks
constexpr int KCHUNKS = D / KC;    // chunks of a codeword tile
constexpr int NS = 4;              // chunks in the cp.async ring
static_assert(KCHUNKS == 4, "|c|^2 adds a tile's chunks as (0 + 1) + (2 + 3)");
constexpr int MAX_CLUSTER = 16;

// A CTA's tile: BT frames x BV codewords; a thread's TF frames x TJ
// codewords; a warp's lanes LG x (32 / LG), frames down LG and codewords
// across, so a warp holds LG TF frames x LC TJ codewords.
template <int BT, int BV, int TF, int TJ, int LG>
struct Tile {
  static constexpr int LC = 32 / LG;
  static constexpr int WF = BT / (LG * TF), WC = BV / (LC * TJ), WARPS = WF * WC;
  static constexpr int NT = 32 * WARPS;
  static constexpr int TPR = NT / BV;            // threads square-summing one codeword
  static_assert(WF * LG * TF == BT && WC * LC * TJ == BV && NT % BV == 0 && TPR <= 8 &&
                    TPR * BV == NT, "tile");
  // residuals, the ring, |c|^2 of the tile, the warps' and the CTA's bests
  // (the latter by stage parity), the winners
  static constexpr size_t SMEM = sizeof(float) * ((size_t)BT * XS + (size_t)NS * BV * CS + BV +
                                                  2 * (size_t)WC * BT + 4 * (size_t)BT + BT);
};

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int ld_cluster_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// (s, i) replaces (best, idx) if it scores higher, or the same with a lower
// index: argmax's first index under any merge order.
__device__ __forceinline__ void take_better(float& best, int& idx, float s, int i) {
  if (s > best || (s == best && i < idx)) {
    best = s;
    idx = i;
  }
}

template <int BT, int BV, int TF, int TJ, int LG>
__global__ void __launch_bounds__(Tile<BT, BV, TF, TJ, LG>::NT)
rvq_cluster_kernel(const float* __restrict__ cb, const float* __restrict__ lat,
                   int* __restrict__ codes, int rows, int t_len, int n_q, int V, int C) {
  using K = Tile<BT, BV, TF, TJ, LG>;
  constexpr int LC = K::LC;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // [BT][XS] residuals
  float* ring = xs + BT * XS;                         // [NS][BV][CS] codeword chunks
  float* nrm = ring + NS * BV * CS;                   // [BV] |c|^2 of the current tile
  float* wsc = nrm + BV;                              // [WC][BT] the warps' best scores
  int* wix = reinterpret_cast<int*>(wsc + K::WC * BT);   // [WC][BT] and indices
  float* csc = reinterpret_cast<float*>(wix + K::WC * BT);   // [2][BT] the CTA's best
  int* cix = reinterpret_cast<int*>(csc + 2 * BT);          // [2][BT]
  int* win = cix + 2 * BT;                            // [BT] the cluster's winners

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wf = warp / K::WC, wc = warp % K::WC, lg = lane / LC, lc = lane % LC;
  const int crank = (int)cluster_ctarank();
  const int row0 = (blockIdx.x / C) * BT;
  const int slice = V / C, v_lo = crank * slice;
  const int tiles = slice / BV;                       // codeword tiles a stage
  const int per_stage = tiles * KCHUNKS, total = n_q * per_stage;

  // Chunk g of the CTA's stream: stage g / per_stage, tile, column chunk.
  auto load_chunk = [&](int g) {
    if (g < total) {
      const int q = g / per_stage, rem = g % per_stage;
      const float* src = cb + ((size_t)q * V + v_lo + (rem / KCHUNKS) * BV) * D +
                         (rem % KCHUNKS) * KC;
      float* dst = ring + (g % NS) * BV * CS;
      for (int i = tid; i < BV * (KC / 4); i += K::NT) {
        const int r = i / (KC / 4), c4 = i % (KC / 4);
        cp_async16(dst + r * CS + 4 * c4, src + (size_t)r * D + 4 * c4);
      }
    }
    cp_async_commit();                                // an empty group past the end
  };
  for (int g = 0; g < NS - 1; ++g) load_chunk(g);

  for (int i = tid; i < BT * (D / 4); i += K::NT) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);       // a ragged tail scores zeros
    if (row0 + r < rows)
      v = __ldg(reinterpret_cast<const float4*>(lat + (size_t)(row0 + r) * D) + c4);
    *reinterpret_cast<float4*>(xs + r * XS + 4 * c4) = v;
  }

  const int f0 = wf * LG * TF + lg;                   // frame i of the thread: f0 + LG i
  const float* xw = xs + f0 * XS;
  const int cw = wc * LC * TJ + lc;                   // codeword j of the thread: cw + LC j
  constexpr int QPT = KC / 4 / K::TPR;                // |c|^2: quads a thread squares a chunk
  const int nr = tid / K::TPR, np = tid % K::TPR;     // ... of row nr, from quad np QPT
  float acc[TF][TJ], best[TF], n01 = 0.f, n23 = 0.f;
  int bidx[TF];
#pragma unroll
  for (int i = 0; i < TF; ++i) {
    best[i] = -__int_as_float(0x7f800000);            // -inf
    bidx[i] = 0;
  }

  for (int g = 0; g < total; ++g) {
    cp_async_wait<NS - 2>();                          // chunk g has landed (this thread's part)
    __syncthreads();                                  // ... every part; chunk g - 1 is consumed
    load_chunk(g + NS - 1);                           // into chunk g - 1's slot
    const int q = g / per_stage, rem = g % per_stage, t = rem / KCHUNKS, kc = rem % KCHUNKS;
    const float* cbuf = ring + (g % NS) * BV * CS;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < TF; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {     // every operand of a step loaded first
      float4 c[TJ], x[TF];
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        c[j] = *reinterpret_cast<const float4*>(cbuf + (cw + LC * j) * CS + kk);
#pragma unroll
      for (int i = 0; i < TF; ++i)
        x[i] = *reinterpret_cast<const float4*>(xw + LG * i * XS + kc * KC + kk);
#pragma unroll
      for (int i = 0; i < TF; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          acc[i][j] = fmaf(x[i].x, c[j].x, acc[i][j]);
          acc[i][j] = fmaf(x[i].y, c[j].y, acc[i][j]);
          acc[i][j] = fmaf(x[i].z, c[j].z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, c[j].w, acc[i][j]);
        }
    }
    {
      // |c|^2 of the chunk's 8 column quads as one pairwise tree, whatever
      // the threads a row (TPR): each thread sums its QPT adjacent quads as
      // the tree's lower levels, the butterfly adds the blocks in the
      // tree's order; the tile's four chunks add as (0 + 1) + (2 + 3).
      float q[QPT];
#pragma unroll
      for (int m = 0; m < QPT; ++m) {
        const float4 c = *reinterpret_cast<const float4*>(cbuf + nr * CS + 4 * (np * QPT + m));
        q[m] = fmaf(c.w, c.w, fmaf(c.z, c.z, fmaf(c.y, c.y, __fmul_rn(c.x, c.x))));
      }
#pragma unroll
      for (int w = 1; w < QPT; w <<= 1)
#pragma unroll
        for (int m = 0; m < QPT; m += 2 * w) q[m] = __fadd_rn(q[m], q[m + w]);
      float part = q[0];
#pragma unroll
      for (int off = 1; off < K::TPR; off <<= 1)
        part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
      if (kc == 0) n01 = part;
      else if (kc == 1) n01 = __fadd_rn(n01, part);
      else if (kc == 2) n23 = part;
      else n23 = __fadd_rn(n23, part);
    }
    if (kc != KCHUNKS - 1) continue;

    // The tile's last chunk: |c|^2, then the scores.
    if (np == 0) nrm[nr] = __fadd_rn(n01, n23);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int v = cw + LC * j;
      const float n = nrm[v];
#pragma unroll
      for (int i = 0; i < TF; ++i) {
        const float s = __fsub_rn(__fmul_rn(2.0f, acc[i][j]), n);
        if (s > best[i]) {
          best[i] = s;
          bidx[i] = v_lo + t * BV + v;
        }
      }
    }
    if (t != tiles - 1) continue;

    // The stage's end: merge over a lane row's lanes, the CTA's
    // codeword warps, then the cluster's CTAs.
    const int par = q & 1;
#pragma unroll
    for (int i = 0; i < TF; ++i) {
#pragma unroll
      for (int off = 1; off < LC; off <<= 1)
        take_better(best[i], bidx[i], __shfl_xor_sync(0xffffffffu, best[i], off),
                    __shfl_xor_sync(0xffffffffu, bidx[i], off));
      if (lc == 0) {
        wsc[wc * BT + f0 + LG * i] = best[i];
        wix[wc * BT + f0 + LG * i] = bidx[i];
      }
      best[i] = -__int_as_float(0x7f800000);
      bidx[i] = 0;
    }
    __syncthreads();
    if (tid < BT) {
      float s = wsc[tid];
      int ix = wix[tid];
      for (int w = 1; w < K::WC; ++w) take_better(s, ix, wsc[w * BT + tid], wix[w * BT + tid]);
      csc[par * BT + tid] = s;
      cix[par * BT + tid] = ix;
    }
    cluster_sync();                                   // every CTA's bests are written
    if (tid < BT) {
      // every CTA's best at once (the remote reads in flight together),
      // then the merge in rank order
      const uint32_t as = smem_addr(csc + par * BT + tid), ai = smem_addr(cix + par * BT + tid);
      float sr[MAX_CLUSTER];
      int ir[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < C) {
          sr[r] = ld_cluster_f32(map_to_rank(as, r));
          ir[r] = ld_cluster_s32(map_to_rank(ai, r));
        }
      float s = sr[0];
      int ix = ir[0];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r)
        if (r < C) take_better(s, ix, sr[r], ir[r]);
      win[tid] = ix;
      const int row = row0 + tid;
      if (crank == 0 && row < rows)
        codes[(size_t)(row / t_len) * n_q * t_len + (size_t)q * t_len + row % t_len] = ix;
    }
    __syncthreads();
    const float* cbq = cb + (size_t)q * V * D;
    for (int e = tid; e < BT * (D / 4); e += K::NT) {
      const int f = e / (D / 4), c4 = e % (D / 4);
      const float4 c = __ldg(reinterpret_cast<const float4*>(cbq + (size_t)win[f] * D) + c4);
      float4* xp = reinterpret_cast<float4*>(xs + f * XS) + c4;
      float4 x = *xp;
      x.x = __fsub_rn(x.x, c.x);
      x.y = __fsub_rn(x.y, c.y);
      x.z = __fsub_rn(x.z, c.z);
      x.w = __fsub_rn(x.w, c.w);
      *xp = x;
    }
    // the next chunk's __syncthreads orders these writes before the products
  }
  cluster_sync();                                     // no CTA leaves while a peer reads it
}

// The tiles this build has, in kernels/rvq.py TILES order: (frames,
// codewords, a thread's frames, a thread's codewords).
constexpr int N_TILES = 6;
constexpr int TILE_DIMS[N_TILES][5] = {{16, 128, 4, 4, 1}, {32, 128, 8, 4, 1},
                                       {32, 256, 8, 4, 1}, {64, 128, 8, 4, 1},
                                       {64, 256, 8, 8, 4}, {128, 128, 8, 8, 4}};

// Per card, tile and cluster size: whether such a cluster can be scheduled
// (0 not asked, 1 yes, -1 no).
constexpr int MAX_CARDS = 32;
signed char g_fits[MAX_CARDS][N_TILES][5];

int cluster_slot(int c) {
  for (int i = 0, s = 1; i < 5; ++i, s <<= 1)
    if (c == s) return i;
  return -1;
}

template <int BT, int BV, int TF, int TJ, int LG>
int launch(int tile_id, const float* cb, const float* lat, int* codes, int rows, int t_len,
           int n_q, int V, int C, cudaStream_t st) {
  using K = Tile<BT, BV, TF, TJ, LG>;
  auto kernel = rvq_cluster_kernel<BT, BV, TF, TJ, LG>;
  const int slot = cluster_slot(C);
  if (slot < 0 || V % (C * BV) != 0) return (int)cudaErrorInvalidValue;
  static unsigned configured = 0;
  cudaError_t err = once_per_device(configured, [&] {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  });
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_CARDS) return (int)cudaErrorInvalidDevice;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((rows + BT - 1) / BT) * C));
  cfg.blockDim = dim3(K::NT);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  signed char& fit = g_fits[dev][tile_id][slot];
  if (fit == 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    fit = clusters > 0 ? 1 : -1;
  }
  if (fit < 0) return (int)cudaErrorLaunchOutOfResources;   // a refused cluster size
  err = cudaLaunchKernelEx(&cfg, kernel, cb, lat, codes, rows, t_len, n_q, V, C);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename F>
int with_tile(int tile, F&& f) {
  switch (tile) {
    case 0: return f(Tile<16, 128, 4, 4, 1>{});
    case 1: return f(Tile<32, 128, 8, 4, 1>{});
    case 2: return f(Tile<32, 256, 8, 4, 1>{});
    case 3: return f(Tile<64, 128, 8, 4, 1>{});
    case 4: return f(Tile<64, 256, 8, 8, 4>{});
    case 5: return f(Tile<128, 128, 8, 8, 4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T> struct Dims;
template <int BT, int BV, int TF, int TJ, int LG> struct Dims<Tile<BT, BV, TF, TJ, LG>> {
  static constexpr int bt = BT, bv = BV, tf = TF, tj = TJ, lg = LG;
};

}  // namespace

// codebooks (n_q_all >= n_q, V, 128) and latents (rows, 128) f32, contiguous;
// codes (rows / t_len, n_q, t_len) int32.  The plan (kernels/rvq.py
// rvq_plan): `tile`, an index into TILE_DIMS (a CTA's frames x codewords, a
// thread's frames x codewords), and `cluster` (1, 2, 4, 8, 16) CTAs a frame
// tile; V must be a multiple of cluster x the tile's codewords.  One
// launch.  Returns cudaErrorInvalidValue for arguments it does not take,
// cudaErrorLaunchOutOfResources for a cluster the card cannot schedule,
// else the launch's cudaError_t.
extern "C" int valle2_rvq_encode(const float* codebooks, const float* latents, int* codes,
                                 int rows, int t_len, int n_q, int V, int tile, int cluster,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || t_len <= 0 || n_q <= 0 || V <= 0 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  return with_tile(tile, [&](auto k) {
    using D_ = Dims<decltype(k)>;
    return launch<D_::bt, D_::bv, D_::tf, D_::tj, D_::lg>(tile, codebooks, latents, codes,
                                                          rows, t_len, n_q, V, cluster, st);
  });
}

// A tile's dimensions (frames, codewords, thread frames, thread codewords, lane rows)
// and its CTA's dynamic shared memory in bytes, for the host's plan check;
// 0 for a tile this build does not have.
extern "C" long valle2_rvq_tile(int tile, int what) {
  if (tile < 0 || tile >= N_TILES || what < 0 || what > 5) return 0;
  if (what < 5) return TILE_DIMS[tile][what];
  return with_tile(tile, [](auto k) { return (int)decltype(k)::SMEM; });
}
