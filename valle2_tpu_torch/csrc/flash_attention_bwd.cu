// Prefix-LM flash attention backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the three Pallas TPU backward kernels of
// valle2_tpu/kernels/flash_attention.py (_flash_bwd):
//
//   flash_bwd_fused  <- _bwd_fused_kernel  (#3, one pass, s_pad <= 768)
//   flash_bwd_dq     <- _bwd_dq_kernel     (#4, dq per q tile)
//   flash_bwd_dkv    <- _bwd_dkv_kernel    (#5, dk, dv per kv tile)
//
// All three compute, for q, k, v, o, dO of shape (b, h, s, hd) and the
// forward's per-row logsumexp lse and delta = rowsum(dO * o) (b, h, s) f32:
//
//   p  = attend(q, k) ? exp(q.k * scale - lse) : 0        (f32)
//   dp = dO . v                                           (f32)
//   ds = round_T(p * (dp - delta))
//   dv = sum_q round_T(p) dO;  dk = scale * sum_q ds q;  dq = scale * sum_k ds k
//
// with the mask of the forward kernel, attend = (k < tokens_valid |
// (k >= tokens_total & (!causal | k <= q))) & k < kv_end, and the rounding
// points of the Pallas kernels: p rounds to dO's dtype before p^T dO, ds to
// q's dtype before ds k and ds^T q.  Rows with no visible key get p = 0 and so
// zero gradient (the Pallas kernels' rule, not autograd of the forward's
// uniform average).  Keys and rows past s (the ragged edge, which the TPU
// wrapper pads) are masked here and no byte past s is read or written.
//
// Design.  Tiles of 64 q rows by 64 keys; 256 threads; every operand of a tile
// pair is staged in shared memory as f32 (row stride HD + 1 so the threads of
// a warp hit distinct banks).  Per tile pair one phase computes p and ds (each
// q row owned by 4 threads, 16 keys each, scores and dp in registers) into
// shared tiles, and a second phase accumulates the products that need them.
//
// - flash_bwd_dkv: one block per (64-key tile, b*h).  It loops over q tiles
//   from the lower bound of the Pallas kernel (a tile of pure audio keys is
//   invisible to earlier rows when causal; a tile of padded keys to all) and
//   keeps dk, dv in registers (each key owned by 4 threads).
// - flash_bwd_dq: one block per (64-row q tile, b*h), looping over kv tiles up
//   to _kv_block_bound; dq in registers.
// - flash_bwd_fused: the dkv loop that also adds ds k into an f32 dq scratch
//   with atomicAdd, then flash_bwd_dq_finish scales and casts it.  A GPU block
//   cannot hold the whole (s, s) row as the TPU kernel does (640^2 f32 is 1.6
//   MB against 227 KB of shared memory), so p and ds are recomputed once per
//   tile pair and shared by all three gradients: 5 products per tile pair
//   against 7 for dq + dkv.  The atomics make dq's summation order vary from
//   run to run; everything else is deterministic.
//
// What bounds it on this card: products run as f32 FMAs on the CUDA cores
// reading shared memory (about one shared load per FMA), not on the tensor
// cores; at the training shapes (b=32, h=4, s=640, hd=64) that is ~20 GFLOP a
// layer after the block skip against a tensor-core bound of ~25 us (bytes).
// mma.sync / wgmma with TMA-fed tile rings are later speed work.

#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace valle2;

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int TPR = 4;         // threads per row (phase A) or per key (dk, dv)
constexpr int NT = BQ * TPR;   // 256 threads
constexpr int KPT = BK / TPR;  // keys per thread in phase A
constexpr int PS = BK + 1;     // row stride of the p / ds tiles

template <int HD>
constexpr size_t smem_bytes() {
  // Ks, Vs [BK][HD+1]; Qs, dOs [BQ][HD+1]; Ps, dSs [BQ][PS]; lse, delta [BQ]
  return sizeof(float) * (2 * BK * (HD + 1) + 2 * BQ * (HD + 1) + 2 * BQ * PS + 2 * BQ);
}

__device__ __forceinline__ bool attends(int qi, int key, int tokens_valid, int tokens_total,
                                        int kv_end, int causal) {
  return (key < tokens_valid || (key >= tokens_total && (!causal || key <= qi))) &&
         key < kv_end;
}

// 64 rows of an (s, HD) matrix from row0 into dst [64][HD+1] as f32; rows past s are 0.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int row0,
                                          int s) {
  for (int i = threadIdx.x; i < 64 * HD; i += NT) {
    const int rr = i / HD, dd = i % HD, row = row0 + rr;
    dst[rr * (HD + 1) + dd] = row < s ? to_f<T>(src[(size_t)row * HD + dd]) : 0.f;
  }
}

__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta, int row0,
                                               int s) {
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const int row = row0 + i;
    lse_s[i] = row < s ? lse[row] : 0.f;
    delta_s[i] = row < s ? delta[row] : 0.f;
  }
}

struct Mask {
  int s, tokens_valid, tokens_total, kv_end, causal;
};

// Phase A of one tile pair: Ps = round_T(p), dSs = round_T(p * (dp - delta)).
template <typename T, int HD>
__device__ __forceinline__ void tile_p_ds(const float* Qs, const float* dOs, const float* Ks,
                                          const float* Vs, const float* lse_s,
                                          const float* delta_s, float* Ps, float* dSs, int q0,
                                          int k0, const Mask& m, float scale) {
  const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
  float sc[KPT], dp[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) sc[j] = dp[j] = 0.f;
  for (int dd = 0; dd < HD; ++dd) {
    const float qv = Qs[r * (HD + 1) + dd], gv = dOs[r * (HD + 1) + dd];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int c = sub + TPR * j;
      sc[j] = fmaf(qv, Ks[c * (HD + 1) + dd], sc[j]);
      dp[j] = fmaf(gv, Vs[c * (HD + 1) + dd], dp[j]);
    }
  }
  const int qi = q0 + r;
  const float l = lse_s[r], dl = delta_s[r];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int c = sub + TPR * j, key = k0 + c;
    const bool on = qi < m.s && key < m.s &&
                    attends(qi, key, m.tokens_valid, m.tokens_total, m.kv_end, m.causal);
    const float p = on ? expf(sc[j] * scale - l) : 0.f;
    Ps[r * PS + c] = round_to<T>(p);
    dSs[r * PS + c] = round_to<T>(p * (dp[j] - dl));
  }
}

// dk, dv per 64-key tile (#5); with FUSED also dq into the f32 scratch (#3).
template <typename T, int HD, bool FUSED>
__global__ void __launch_bounds__(NT)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ meta,
                    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int h,
                    int s, int tokens_total, int causal, float scale) {
  constexpr int DPT = HD / TPR;
  constexpr int RS = HD + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * RS;
  float* Qs = Vs + BK * RS;
  float* dOs = Qs + BQ * RS;
  float* Ps = dOs + BQ * RS;
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, own = tid / TPR, sub = tid % TPR;
  const int k_blk = blockIdx.x, bh = blockIdx.y, b = bh / h;
  const size_t base = (size_t)bh * s * HD;
  const Mask m{s, meta[2 * b], tokens_total, meta[2 * b + 1], causal};
  const int k0 = k_blk * BK;

  load_rows<T, HD>(Ks, k + base, k0, s);
  load_rows<T, HD>(Vs, v + base, k0, s);

  const int n_q = (s + BQ - 1) / BQ;
  int lower = (causal && k0 >= m.tokens_valid) ? k0 / BQ : 0;
  if (k0 >= m.kv_end) lower = n_q;

  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int qb = lower; qb < n_q; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();   // the previous tile's Qs/dOs/Ps/dSs are no longer read
    load_rows<T, HD>(Qs, q + base, q0, s);
    load_rows<T, HD>(dOs, dout + base, q0, s);
    load_row_stats(lse_s, delta_s, lse + (size_t)bh * s, delta + (size_t)bh * s, q0, s);
    __syncthreads();
    tile_p_ds<T, HD>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, m, scale);
    __syncthreads();
    // dv += p^T dO, dk += ds^T Q for the key this thread owns.
    for (int rr = 0; rr < BQ; ++rr) {
      const float p = Ps[rr * PS + own], ds = dSs[rr * PS + own];
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dv_acc[i] = fmaf(p, dOs[rr * RS + sub + TPR * i], dv_acc[i]);
        dk_acc[i] = fmaf(ds, Qs[rr * RS + sub + TPR * i], dk_acc[i]);
      }
    }
    if (FUSED) {
      // dq[q0 + own] += ds K for the row this thread owns.
      float acc[DPT];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
      for (int c = 0; c < BK; ++c) {
        const float ds = dSs[own * PS + c];
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(ds, Ks[c * RS + sub + TPR * i], acc[i]);
      }
      const int qi = q0 + own;
      if (qi < s) {
        float* row = dq_acc + base + (size_t)qi * HD;
#pragma unroll
        for (int i = 0; i < DPT; ++i) atomicAdd(row + sub + TPR * i, acc[i]);
      }
    }
  }

  const int key = k0 + own;
  if (key < s) {
    const size_t off = base + (size_t)key * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[off + sub + TPR * i] = from_f<T>(dk_acc[i] * scale);
      dv[off + sub + TPR * i] = from_f<T>(dv_acc[i]);
    }
  }
}

// dq per 64-row q tile (#4), over kv tiles up to _kv_block_bound.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ meta,
                    T* __restrict__ dq, int h, int s, int tokens_total, int causal,
                    float scale) {
  constexpr int DPT = HD / TPR;
  constexpr int RS = HD + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * RS;
  float* Qs = Vs + BK * RS;
  float* dOs = Qs + BQ * RS;
  float* Ps = dOs + BQ * RS;
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, own = tid / TPR, sub = tid % TPR;
  const int q_blk = blockIdx.x, bh = blockIdx.y, b = bh / h;
  const size_t base = (size_t)bh * s * HD;
  const Mask m{s, meta[2 * b], tokens_total, meta[2 * b + 1], causal};
  const int q0 = q_blk * BQ;

  load_rows<T, HD>(Qs, q + base, q0, s);
  load_rows<T, HD>(dOs, dout + base, q0, s);
  load_row_stats(lse_s, delta_s, lse + (size_t)bh * s, delta + (size_t)bh * s, q0, s);

  const int all_tiles = (s + BK - 1) / BK;
  const int vis_end =
      causal ? max(m.tokens_valid, min(q0 + BQ, m.kv_end)) : m.kv_end;
  const int n_tiles = min(all_tiles, (vis_end + BK - 1) / BK);

  float dq_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dq_acc[i] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();   // the previous tile's Ks/Vs/dSs are no longer read
    load_rows<T, HD>(Ks, k + base, k0, s);
    load_rows<T, HD>(Vs, v + base, k0, s);
    __syncthreads();
    tile_p_ds<T, HD>(Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, m, scale);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      const float ds = dSs[own * PS + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) dq_acc[i] = fmaf(ds, Ks[c * RS + sub + TPR * i], dq_acc[i]);
    }
  }

  const int qi = q0 + own;
  if (qi < s) {
    const size_t off = base + (size_t)qi * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) dq[off + sub + TPR * i] = from_f<T>(dq_acc[i] * scale);
  }
}

// The fused kernel's last pass: dq = round_T(scale * dq_acc).
template <typename T>
__global__ void flash_bwd_dq_finish(const float* __restrict__ acc, T* __restrict__ dq,
                                    size_t n, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dq[i] = from_f<T>(acc[i] * scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* meta;
  void *dq, *dk, *dv;
  float* dq_acc;
  int b, h, s, tokens_total, causal;
  float scale;
  cudaStream_t stream;
};

// which: 0 = fused, 1 = dq, 2 = dkv.
template <typename T, int HD>
int launch(int which, const Args& a) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(flash_bwd_kv_kernel<T, HD, true>, smem);
    if (err == cudaSuccess) err = allow_smem(flash_bwd_kv_kernel<T, HD, false>, smem);
    if (err == cudaSuccess) err = allow_smem(flash_bwd_dq_kernel<T, HD>, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 kv_grid((a.s + BK - 1) / BK, a.b * a.h);
  if (which == 1) {
    const dim3 q_grid((a.s + BQ - 1) / BQ, a.b * a.h);
    flash_bwd_dq_kernel<T, HD><<<q_grid, NT, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<T*>(a.dq), a.h, a.s,
        a.tokens_total, a.causal, a.scale);
  } else if (which == 2) {
    flash_bwd_kv_kernel<T, HD, false><<<kv_grid, NT, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        nullptr, a.h, a.s, a.tokens_total, a.causal, a.scale);
  } else {
    flash_bwd_kv_kernel<T, HD, true><<<kv_grid, NT, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.dq_acc, a.h, a.s, a.tokens_total, a.causal, a.scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t n = (size_t)a.b * a.h * a.s * HD;
    const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
    flash_bwd_dq_finish<T><<<blocks, 256, 0, a.stream>>>(a.dq_acc, static_cast<T*>(a.dq), n,
                                                         a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int which, int hd, const Args& a) {
  switch (hd) {
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, int dtype, int hd, const Args& a) {
  if (dtype == 0) return dispatch_hd<float>(which, hd, a);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(which, hd, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after its
// launches.  dq_acc: a zeroed f32 (b, h, s, hd) scratch (fused only).
extern "C" int valle2_flash_bwd_fused(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      const int* meta, void* dq, void* dk, void* dv,
                                      float* dq_acc, int b, int h, int s, int hd,
                                      int tokens_total, int causal, int dtype, float scale,
                                      void* stream) {
  const Args a{q, k, v, dout, lse, delta, meta, dq, dk, dv, dq_acc, b, h, s, tokens_total,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(0, dtype, hd, a);
}

extern "C" int valle2_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   const int* meta, void* dq, int b, int h, int s, int hd,
                                   int tokens_total, int causal, int dtype, float scale,
                                   void* stream) {
  const Args a{q, k, v, dout, lse, delta, meta, dq, nullptr, nullptr, nullptr, b, h, s,
               tokens_total, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(1, dtype, hd, a);
}

extern "C" int valle2_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    const int* meta, void* dk, void* dv, int b, int h, int s,
                                    int hd, int tokens_total, int causal, int dtype,
                                    float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, meta, nullptr, dk, dv, nullptr, b, h, s,
               tokens_total, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(2, dtype, hd, a);
}
