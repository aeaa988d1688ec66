// Prefix-LM flash attention forward for Hopper (sm_90a), CUDA C++: kernel #1
// (one block per q-tile and head) and kernel #2 (one block per q-tile and
// batch row, carrying every head).
//
// Replaces the Pallas TPU kernels valle2_tpu/kernels/flash_attention.py
// _flash_fwd -> _fwd_kernel (#1) and _flash_fwd_folded -> _fwd_kernel_folded
// (#2): o = softmax(q k^T / sqrt(hd) + mask) v and the per-row logsumexp, for
// q, k, v of shape (b, h, s, hd), with the VALL-E mask built in-kernel from
// meta (b, 2) = [tokens_valid, kv_end]:
//
//   attend(q, k) = (k < tokens_valid | (k >= tokens_total & (!causal | k <= q)))
//                  & k < kv_end
//
// which, for one query row, is the union of two key ranges, [0, min(tokens_valid,
// kv_end)) and [tokens_total, causal ? min(kv_end, q + 1) : kv_end) (RowRanges).
//
// #1: one block per (q-tile of 64 rows, batch*head).  The f32 route: K/V
// tiles of 64 keys stream through shared memory (K stored transposed so the score loop reads
// it without bank conflicts); each q row is owned by 4 threads, which hold 16
// scores and 16 output dims each, and the online softmax (running max, running
// sum, rescaled accumulator) stays in f32 registers.  Masked scores take the
// finite -1e30 sentinel and l is clamped at 1e-30, as in the Pallas kernel;
// keys past s (the ragged edge, which the TPU wrapper pads instead) contribute
// exactly zero.  kv tiles past the last key a q-tile can see are skipped (the
// Pallas _kv_block_bound), which is exact; a batch row with tokens_valid == 0
// walks every tile so that its fully masked query rows come out as the plain
// version's uniform average.
//
// #2, head-folded: one block per (q-tile of 64 rows, batch row) walks the
// heads in order.  What the TPU program computes once and broadcasts over
// heads is computed once per block here too: tokens_valid and kv_end, the kv
// tile bound, and each thread's query-row key ranges (three registers that
// stand for the row's visibility of every key).  The heads cannot be live at
// once (64 rows x 16 heads x 64 dims of f32 accumulators are 256 KB, more
// than a block's registers and shared memory together), so each head runs
// #1's online softmax through the same device function, attend_head: the
// same 64-key tiles and the same per-row summation order, so #2's output is
// bit-equal to #1's on the same inputs.  What bounds it on this card is the
// same as #1, plus occupancy: the grid has h
// times fewer blocks (21 at the serving prefill b=3, s=385, on 132 SMs; 160
// at the 204M training step b=16, s=640), each h times longer.
//
// Two routes, chosen by dtype at dispatch:
//
// bf16, on the tensor cores (FlashAttention-2 on mma.sync).  What bounds it
// on this card: at the serving prefill (b=3, h=4, s=385, hd=64) and the
// serving-width training shape (b=32, h=4, s=640) the kernel does about 40
// products per byte it must move, so the bound is bytes; but each block walks
// its kv tiles in turn, and with the products on the CUDA cores (the first
// design, kept as the f32 route) the f32 FMAs were the time (0.706 ms against
// SDPA's 0.137 at b=32, s=640 on an H100 80GB HBM3 at 700 W, chip_smoke.py).
// So: 4 warps a block, each owning 16 query rows of the 64-row q-tile.
// S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> f32 (common.cuh, the
// helpers #9 / #10 use), their operands loaded by ldmatrix
// (V with .trans) from shared tiles whose rows are padded by 16 bytes, so the
// 8 rows of an ldmatrix fall in distinct banks.  Q is loaded once; the K and
// V tiles stream through a 2-stage cp.async ring, tile kb + 1 in flight while
// tile kb is multiplied, and the ragged edge (keys or rows past s) is
// zero-filled by cp.async with src-size 0, then masked.  The mask is applied
// per accumulator element: a thread holds two query rows (gid and gid + 8 of
// its warp's 16) and knows the key of every element.  P never leaves
// registers: the S accumulator fragments, after the mask, the scale and exp,
// are rounded to bf16 (as the Pallas kernel casts p to v's dtype) and packed
// into the A operand of the PV product.  The online softmax (running max,
// sum, the rescaled accumulator) stays in f32, l sums the unrounded p, and the
// -1e30 sentinel, the 1e-30 clamp on l and the -inf past s are as in the f32
// route.  If #1 still trails SDPA, wgmma (a warpgroup of 4 warps on a 64-row
// tile, operands from shared memory) fed by TMA loads and a warp-specialised
// producer is the next step.
//
// f32, on the CUDA cores, as the first design above: products in f32 FMAs with
// f32 accumulation, p rounded to the input dtype (a no-op in f32).  The tensor
// cores have no full-f32 product (TF32 keeps 10 mantissa bits), and f32 with
// TF32 off is the parity setting.
//
// #2 runs the same per-head device function (attend_head) of each route, so it
// stays bit-equal to #1 in both dtypes.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace valle2;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per kv tile
// f32 route (CUDA cores)
constexpr int TPR = 4;         // threads per q row
constexpr int NT = BQ * TPR;   // 256 threads
constexpr int KPT = BK / TPR;  // scores per thread
// Padded row strides (floats) of the shared tiles, chosen so that the 8 rows
// a warp touches fall in distinct banks.
constexpr int PS = BK + 4;
constexpr int KTS = BK + 1;
// bf16 route (tensor cores)
constexpr int TC_WARPS = BQ / 16;      // one warp per 16 query rows
constexpr int NT_TC = 32 * TC_WARPS;   // 128 threads

// TCR: the tensor-core route (bf16); else the CUDA-core one.
template <bool TCR>
constexpr int block_threads() {
  return TCR ? NT_TC : NT;
}

template <int HD, bool TCR>
constexpr size_t smem_bytes() {
  if constexpr (TCR)   // Q, and two stages each of K and V
    return sizeof(bf16) * (BQ + 4 * BK) * (HD + TILE_PAD);
  else
    return sizeof(float) * (BQ * (HD + 4) + HD * KTS + BK * HD + BQ * PS);
}

// The keys one query row sees: [0, src_end) and [aud_lo, aud_hi).
struct RowRanges {
  int src_end, aud_lo, aud_hi;
};

__device__ __forceinline__ RowRanges row_ranges(int qi, int tokens_valid, int kv_end,
                                                int tokens_total, int causal) {
  return {min(tokens_valid, kv_end), tokens_total, causal ? min(kv_end, qi + 1) : kv_end};
}

__device__ __forceinline__ bool sees(const RowRanges& r, int key) {
  return key < r.src_end || (key >= r.aud_lo && key < r.aud_hi);
}

// kv tiles a q-tile walks: up to the last key any of its rows can see, or
// every tile when the batch row has no visible source key.
__device__ __forceinline__ int kv_tile_bound(int q_blk, int s, int tokens_valid, int kv_end,
                                             int causal) {
  const int all_tiles = (s + BK - 1) / BK;
  if (tokens_valid <= 0) return all_tiles;
  const int vis_end = causal ? max(tokens_valid, min((q_blk + 1) * BQ, kv_end)) : kv_end;
  return min(all_tiles, (vis_end + BK - 1) / BK);
}

// The key ranges of the query rows whose values a thread holds: one row in the
// CUDA-core route (threadIdx / TPR), two in the tensor-core route (rows gid
// and gid + 8 of the warp's 16).
template <bool TCR>
struct ThreadRows {
  RowRanges r[TCR ? 2 : 1];
};

template <bool TCR>
__device__ __forceinline__ ThreadRows<TCR> thread_rows(int q_blk, int tokens_valid, int kv_end,
                                                       int tokens_total, int causal) {
  ThreadRows<TCR> tr;
  if constexpr (!TCR) {
    tr.r[0] = row_ranges(q_blk * BQ + threadIdx.x / TPR, tokens_valid, kv_end, tokens_total,
                         causal);
  } else {
    const int row = q_blk * BQ + threadIdx.x / 32 * 16 + threadIdx.x % 32 / 4;
    tr.r[0] = row_ranges(row, tokens_valid, kv_end, tokens_total, causal);
    tr.r[1] = row_ranges(row + 8, tokens_valid, kv_end, tokens_total, causal);
  }
  return tr;
}

// CUDA-core route: one head of one q-tile, the online softmax over n_tiles kv
// tiles.  bh is the (batch*head) index of q, k, v, o and lse.
template <typename T, int HD>
__device__ __forceinline__ void attend_head_cc(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, T* __restrict__ o,
                                            float* __restrict__ lse, int bh, int s,
                                            int q_blk, int n_tiles, const RowRanges& rr,
                                            float sm_scale, float* smem) {
  static_assert(HD % TPR == 0, "head dim must split over the row's threads");
  constexpr int DPT = HD / TPR;        // output dims per thread
  constexpr int QST = HD + 4;
  float* Qs = smem;                    // [BQ][QST]
  float* Kt = Qs + BQ * QST;           // [HD][KTS]  (transposed K tile)
  float* Vs = Kt + HD * KTS;           // [BK][HD]
  float* Ps = Vs + BK * HD;            // [BQ][PS]

  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;
  const size_t base = (size_t)bh * s * HD;
  const int qi = q_blk * BQ + r;

  __syncthreads();   // a previous head's last tile no longer reads Qs
  for (int i = tid; i < BQ * HD; i += NT) {
    const int rr_ = i / HD, dd = i % HD, row = q_blk * BQ + rr_;
    Qs[rr_ * QST + dd] = row < s ? to_f<T>(q[base + (size_t)row * HD + dd]) : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    __syncthreads();   // the previous tile's Kt/Vs/Ps are no longer read
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, dd = i % HD, key = kb * BK + c;
      const bool in = key < s;
      Kt[dd * KTS + c] = in ? to_f<T>(k[base + (size_t)key * HD + dd]) : 0.f;
      Vs[c * HD + dd] = in ? to_f<T>(v[base + (size_t)key * HD + dd]) : 0.f;
    }
    __syncthreads();

    float sc[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) sc[j] = 0.f;
    for (int dd = 0; dd < HD; ++dd) {
      const float qv = Qs[r * QST + dd];
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[j] = fmaf(qv, Kt[dd * KTS + sub + TPR * j], sc[j]);
    }
    float mloc = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = kb * BK + sub + TPR * j;
      sc[j] = key >= s ? -INFINITY : (sees(rr, key) ? sc[j] * sm_scale : NEG_INF);
      mloc = fmaxf(mloc, sc[j]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float m_new = fmaxf(m, mloc);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(sc[j] - m_new);
      psum += p;
      Ps[r * PS + sub + TPR * j] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();

    float pv[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) pv[i] = 0.f;
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PS + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) pv[i] = fmaf(p, Vs[c * HD + sub + TPR * i], pv[i]);
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = acc[i] * alpha + pv[i];
  }

  if (qi < s) {
    const float l_safe = fmaxf(l, 1e-30f);
    const size_t orow = base + (size_t)qi * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[orow + sub + TPR * i] = from_f<T>(acc[i] / l_safe);
    if (sub == 0) lse[(size_t)bh * s + qi] = m + logf(l_safe);
  }
}

// bf16 route: one head of one q-tile on the tensor cores (the design is in
// the header).  Same arguments as attend_head_cc.
template <int HD>
__device__ __forceinline__ void attend_head_tc(const bf16* __restrict__ q,
                                               const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, bf16* __restrict__ o,
                                               float* __restrict__ lse, int bh, int s,
                                               int q_blk, int n_tiles,
                                               const ThreadRows<true>& rr, float sm_scale,
                                               bf16* smem) {
  constexpr int RS = HD + TILE_PAD;
  constexpr int KD = HD / 16;    // k-steps of Q K^T
  constexpr int ND = HD / 8;     // n-tiles of O
  constexpr int NK = BK / 8;     // n-tiles of S
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  bf16* Qs = smem;                 // [BQ][RS]
  bf16* Ks = Qs + BQ * RS;         // [2][BK][RS]
  bf16* Vs = Ks + 2 * BK * RS;     // [2][BK][RS]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t base = (size_t)bh * s * HD;

  __syncthreads();   // a previous head's last tile is no longer read
  cp_async_rows64<HD, NT_TC>(q, Qs, base, q_blk * BQ, s);
  if (n_tiles > 0) {
    cp_async_rows64<HD, NT_TC>(k, Ks, base, 0, s);
    cp_async_rows64<HD, NT_TC>(v, Vs, base, 0, s);
  }
  cp_async_commit();

  uint32_t qf[KD][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    cp_async_wait<0>();
    __syncthreads();   // tile kb (and Q) landed for every thread; tile kb - 1 is no longer read
    if (kb == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_a<RS>(qf[kd], Qs, warp * 16, kd);
    }
    if (kb + 1 < n_tiles) {
      const int st = (kb + 1) & 1;
      cp_async_rows64<HD, NT_TC>(k, Ks + st * BK * RS, base, (kb + 1) * BK, s);
      cp_async_rows64<HD, NT_TC>(v, Vs + st * BK * RS, base, (kb + 1) * BK, s);
    }
    cp_async_commit();
    const bf16* ks = Ks + (kb & 1) * BK * RS;
    const bf16* vs = Vs + (kb & 1) * BK * RS;

    // S = Q K^T: K stored [key][dim] is the col-major B operand.
    float sc[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int nt = 0; nt < NK; nt += 2) {
        uint32_t r[4];
        ldmatrix_b_nk<RS>(r, ks, nt * 8, kd);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(sc[nt], qf[kd], b0);
        mma_bf16(sc[nt + 1], qf[kd], b1);
      }
    }

    // Mask and scale per element (element e: row gid + 8 (e / 2), key 2 tig +
    // e % 2 of its n-tile), then the rows' max over the quad.
    float mloc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * BK + nt * 8 + tig * 2 + (e & 1);
        const float x = key >= s ? -INFINITY
                                 : (sees(rr.r[e >> 1], key) ? sc[nt][e] * sm_scale : NEG_INF);
        sc[nt][e] = x;
        mloc[e >> 1] = fmaxf(mloc[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mloc[ri] = fmaxf(mloc[ri], __shfl_xor_sync(0xffffffffu, mloc[ri], 1));
      mloc[ri] = fmaxf(mloc[ri], __shfl_xor_sync(0xffffffffu, mloc[ri], 2));
      const float m_new = fmaxf(m[ri], mloc[ri]);
      alpha[ri] = expf(m[ri] - m_new);
      m[ri] = m_new;
    }

    // p = exp(s - m): summed unrounded into l, rounded to bf16 into the A
    // operand of P V (k-step kk of 16 keys is n-tiles 2 kk and 2 kk + 1).
    float psum[2] = {0.f, 0.f};
    uint32_t pa[NK / 2][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const float p0 = expf(sc[nt][0] - m[0]), p1 = expf(sc[nt][1] - m[0]);
      const float p2 = expf(sc[nt][2] - m[1]), p3 = expf(sc[nt][3] - m[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      psum[ri] += __shfl_xor_sync(0xffffffffu, psum[ri], 1);
      psum[ri] += __shfl_xor_sync(0xffffffffu, psum[ri], 2);
      l[ri] = l[ri] * alpha[ri] + psum[ri];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }

    // O += P V: V stored [key][dim] is the row-major B operand (.trans).
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t r[4];
        ldmatrix_b_kn<RS>(r, vs, kk * 16, nd);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16(acc[nd], pa[kk], b0);
        mma_bf16(acc[nd + 1], pa[kk], b1);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int qi = q_blk * BQ + warp * 16 + gid + 8 * ri;
    if (qi >= s) continue;
    const float l_safe = fmaxf(l[ri], 1e-30f);
    bf16* orow = o + base + (size_t)qi * HD;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(orow + nd * 8 + tig * 2) = __floats2bfloat162_rn(
          acc[nd][2 * ri] / l_safe, acc[nd][2 * ri + 1] / l_safe);
    if (tig == 0) lse[(size_t)bh * s + qi] = m[ri] + logf(l_safe);
  }
}

// One head of one q-tile on route TCR: #1 and #2 both run this.
template <typename T, int HD, bool TCR>
__device__ __forceinline__ void attend_head(const T* q, const T* k, const T* v, T* o,
                                            float* lse, int bh, int s, int q_blk, int n_tiles,
                                            const ThreadRows<TCR>& rr, float sm_scale,
                                            unsigned char* smem) {
  if constexpr (!TCR)
    attend_head_cc<T, HD>(q, k, v, o, lse, bh, s, q_blk, n_tiles, rr.r[0], sm_scale,
                          reinterpret_cast<float*>(smem));
  else
    attend_head_tc<HD>(q, k, v, o, lse, bh, s, q_blk, n_tiles, rr, sm_scale,
                       reinterpret_cast<bf16*>(smem));
}

// #1: grid (q-tiles, b*h).
template <typename T, int HD, bool TCR>
__global__ void __launch_bounds__(block_threads<TCR>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ meta, T* __restrict__ o, float* __restrict__ lse,
                 int h, int s, int tokens_total, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_blk = blockIdx.x, bh = blockIdx.y, b = bh / h;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int n_tiles = kv_tile_bound(q_blk, s, tokens_valid, kv_end, causal);
  const ThreadRows<TCR> rr = thread_rows<TCR>(q_blk, tokens_valid, kv_end, tokens_total, causal);
  attend_head<T, HD, TCR>(q, k, v, o, lse, bh, s, q_blk, n_tiles, rr, sm_scale, smem);
}

// #2: grid (q-tiles, b); the block walks the heads.
template <typename T, int HD, bool TCR>
__global__ void __launch_bounds__(block_threads<TCR>())
flash_fwd_folded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ meta,
                        T* __restrict__ o, float* __restrict__ lse, int h, int s,
                        int tokens_total, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_blk = blockIdx.x, b = blockIdx.y;
  // Once per block, for every head: the row's meta, the tile bound, the
  // query rows' key ranges.
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int n_tiles = kv_tile_bound(q_blk, s, tokens_valid, kv_end, causal);
  const ThreadRows<TCR> rr = thread_rows<TCR>(q_blk, tokens_valid, kv_end, tokens_total, causal);
  for (int hh = 0; hh < h; ++hh)
    attend_head<T, HD, TCR>(q, k, v, o, lse, b * h + hh, s, q_blk, n_tiles, rr, sm_scale,
                            smem);
}

template <typename T, int HD, bool TCR>
int launch(bool folded, const void* q, const void* k, const void* v, const int* meta,
           void* o, float* lse, int b, int h, int s, int tokens_total, int causal,
           float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, TCR>();
  auto kernel = folded ? flash_fwd_folded_kernel<T, HD, TCR> : flash_fwd_kernel<T, HD, TCR>;
  static unsigned configured[2] = {0, 0};   // one bit per card
  cudaError_t err = once_per_device(configured[folded], [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + BQ - 1) / BQ, folded ? b : b * h);
  kernel<<<grid, block_threads<TCR>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), meta,
      static_cast<T*>(o), lse, h, s, tokens_total, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, bool TCR>
int dispatch_hd(bool folded, int hd, const void* q, const void* k, const void* v,
                const int* meta, void* o, float* lse, int b, int h, int s, int tokens_total,
                int causal, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32, TCR>(folded, q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    case 64: return launch<T, 64, TCR>(folded, q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    case 128: return launch<T, 128, TCR>(folded, q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// f32 on the CUDA cores; bf16 on the tensor cores, or with `cuda_cores` on
// the CUDA cores (the first design's route, which only chip_smoke.py's timing
// calls).
int dispatch(bool folded, bool cuda_cores, const void* q, const void* k, const void* v,
             const int* meta, void* o, float* lse, int b, int h, int s, int hd,
             int tokens_total, int causal, int dtype, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float, false>(folded, hd, q, k, v, meta, o, lse, b, h, s, tokens_total,
                                     causal, sm_scale, st);
  if (dtype == 1 && cuda_cores)
    return dispatch_hd<bf16, false>(folded, hd, q, k, v, meta, o, lse, b, h, s, tokens_total,
                                    causal, sm_scale, st);
  if (dtype == 1)
    return dispatch_hd<bf16, true>(folded, hd, q, k, v, meta, o, lse, b, h, s, tokens_total,
                                   causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// the launch.  #1:
extern "C" int valle2_flash_attention_fwd(const void* q, const void* k, const void* v,
                                          const int* meta, void* o, float* lse, int b,
                                          int h, int s, int hd, int tokens_total,
                                          int causal, int dtype, float sm_scale,
                                          void* stream) {
  return dispatch(false, false, q, k, v, meta, o, lse, b, h, s, hd, tokens_total, causal,
                  dtype, sm_scale, stream);
}

// #1 with bf16 on the CUDA cores (the first design's route), for timing beside the
// tensor-core route; no path of the port calls it.
extern "C" int valle2_flash_attention_fwd_cuda_cores(const void* q, const void* k,
                                                     const void* v, const int* meta, void* o,
                                                     float* lse, int b, int h, int s, int hd,
                                                     int tokens_total, int causal, int dtype,
                                                     float sm_scale, void* stream) {
  return dispatch(false, true, q, k, v, meta, o, lse, b, h, s, hd, tokens_total, causal,
                  dtype, sm_scale, stream);
}

// #2, the head-folded forward (same arguments and outputs):
extern "C" int valle2_flash_attention_fwd_folded(const void* q, const void* k, const void* v,
                                                 const int* meta, void* o, float* lse,
                                                 int b, int h, int s, int hd,
                                                 int tokens_total, int causal, int dtype,
                                                 float sm_scale, void* stream) {
  return dispatch(true, false, q, k, v, meta, o, lse, b, h, s, hd, tokens_total, causal,
                  dtype, sm_scale, stream);
}
