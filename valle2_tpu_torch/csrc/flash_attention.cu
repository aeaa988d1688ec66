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
// #1: one block per (q-tile of 64 rows, batch*head).  K/V tiles of 64 keys
// stream through shared memory (K stored transposed so the score loop reads
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
// same as #1 (products on the CUDA cores), plus occupancy: the grid has h
// times fewer blocks (21 at the serving prefill b=3, s=385, on 132 SMs; 160
// at the 204M training step b=16, s=640), each h times longer.
//
// Precision: products take the input dtype's values (bf16 or f32) in f32 FMAs
// with f32 accumulation; p rounds to the input dtype before the PV product, as
// the Pallas kernel casts p to v's dtype.  What bounds it on this card: the
// products run on the CUDA cores, not the tensor cores (s = 385, hd = 64 at the
// slice's shapes, a few hundred MFLOP per layer) -- a wgmma/mma.sync version is
// later work.  f32 inputs stay in full f32 (no TF32), the parity setting.

#include <stdint.h>

#include "common.cuh"

namespace {

using namespace valle2;

constexpr int BQ = 64;         // q rows per block
constexpr int BK = 64;         // keys per kv tile
constexpr int TPR = 4;         // threads per q row
constexpr int NT = BQ * TPR;   // 256 threads
constexpr int KPT = BK / TPR;  // scores per thread
// Padded row strides (floats) of the shared tiles, chosen so that the 8 rows
// a warp touches fall in distinct banks.
constexpr int PS = BK + 4;
constexpr int KTS = BK + 1;

template <int HD>
constexpr size_t smem_bytes() {
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

// One head of one q-tile: the online softmax over n_tiles kv tiles.  bh is
// the (batch*head) index of q, k, v, o and lse.
template <typename T, int HD>
__device__ __forceinline__ void attend_head(const T* __restrict__ q, const T* __restrict__ k,
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

// #1: grid (q-tiles, b*h).
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ meta, T* __restrict__ o, float* __restrict__ lse,
                 int h, int s, int tokens_total, int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int q_blk = blockIdx.x, bh = blockIdx.y, b = bh / h;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int n_tiles = kv_tile_bound(q_blk, s, tokens_valid, kv_end, causal);
  const RowRanges rr = row_ranges(q_blk * BQ + threadIdx.x / TPR, tokens_valid, kv_end,
                                  tokens_total, causal);
  attend_head<T, HD>(q, k, v, o, lse, bh, s, q_blk, n_tiles, rr, sm_scale, smem);
}

// #2: grid (q-tiles, b); the block walks the heads.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_folded_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ meta,
                        T* __restrict__ o, float* __restrict__ lse, int h, int s,
                        int tokens_total, int causal, float sm_scale) {
  extern __shared__ float smem[];
  const int q_blk = blockIdx.x, b = blockIdx.y;
  // Once per block, for every head: the row's meta, the tile bound, the
  // query row's key ranges.
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int n_tiles = kv_tile_bound(q_blk, s, tokens_valid, kv_end, causal);
  const RowRanges rr = row_ranges(q_blk * BQ + threadIdx.x / TPR, tokens_valid, kv_end,
                                  tokens_total, causal);
  for (int hh = 0; hh < h; ++hh)
    attend_head<T, HD>(q, k, v, o, lse, b * h + hh, s, q_blk, n_tiles, rr, sm_scale, smem);
}

template <typename T, int HD>
int launch(bool folded, const void* q, const void* k, const void* v, const int* meta,
           void* o, float* lse, int b, int h, int s, int tokens_total, int causal,
           float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = folded ? flash_fwd_folded_kernel<T, HD> : flash_fwd_kernel<T, HD>;
  static unsigned configured[2] = {0, 0};   // one bit per card
  cudaError_t err = once_per_device(configured[folded], [&] {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + BQ - 1) / BQ, folded ? b : b * h);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), meta,
      static_cast<T*>(o), lse, h, s, tokens_total, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(bool folded, int hd, const void* q, const void* k, const void* v,
                const int* meta, void* o, float* lse, int b, int h, int s, int tokens_total,
                int causal, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(folded, q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    case 64: return launch<T, 64>(folded, q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    case 128: return launch<T, 128>(folded, q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(bool folded, const void* q, const void* k, const void* v, const int* meta,
             void* o, float* lse, int b, int h, int s, int hd, int tokens_total, int causal,
             int dtype, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(folded, hd, q, k, v, meta, o, lse, b, h, s, tokens_total,
                              causal, sm_scale, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(folded, hd, q, k, v, meta, o, lse, b, h, s,
                                      tokens_total, causal, sm_scale, st);
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
  return dispatch(false, q, k, v, meta, o, lse, b, h, s, hd, tokens_total, causal, dtype,
                  sm_scale, stream);
}

// #2, the head-folded forward (same arguments and outputs):
extern "C" int valle2_flash_attention_fwd_folded(const void* q, const void* k, const void* v,
                                                 const int* meta, void* o, float* lse,
                                                 int b, int h, int s, int hd,
                                                 int tokens_total, int causal, int dtype,
                                                 float sm_scale, void* stream) {
  return dispatch(true, q, k, v, meta, o, lse, b, h, s, hd, tokens_total, causal, dtype,
                  sm_scale, stream);
}
