// The fused decode step's device code and launchers, shared by the phased
// kernels (csrc/fused_decode.cu: the phased twin, the phased TP step, 5c
// alone) and the persistent #6, #7 and TP step (csrc/fused_step.cu, built
// once per weight format).  The design is in fused_decode.cu's header.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace valle2;

constexpr int NCOL = 32;     // output columns per projection block (one per lane)
constexpr int KSPLIT = 16;   // warps per projection block, each a slice of K
constexpr int PNT = NCOL * KSPLIT;
constexpr int KUNR = 8;      // weight loads in flight per warp
constexpr int ANW = 16;      // warps per attention item
constexpr int UNR = 8;       // slots per warp iteration in the attention loop
constexpr int KVQ_WARPS = 4; // warps per block of the int8 cache write
constexpr float LN_EPS = 1e-5f;
// Phases a layer of the persistent step: QKV, attention, OUT, FFN1, FFN2;
// with an int8 cache and a block of more than one token a row (#7) the cache
// write is a phase of its own between QKV and the attention.
constexpr int STEP_PHASES = 5;
constexpr int STEP_PHASES_KVQ = 6;

enum Mode { QKV = 0, OUT = 1, FFN1 = 2, FFN2 = 3 };
enum WFmt { DENSE = 0, W8 = 1, W4 = 2 };

// Widest projection input of a tile of 16 and of 8 rows: the rows (f32, and
// int8 codes for W8) and the reduction scratch fill the 227 KB of shared
// memory a block can opt into.
__host__ __device__ constexpr int max_k16(int wf) { return wf == W8 ? 2048 : 3072; }
__host__ __device__ constexpr int max_k8(int wf) { return wf == W8 ? 5120 : 6144; }

template <typename T>
struct ProjArgs {
  const T* x;          // (rows, d) hidden state entering the layer
  const float* a32;    // f32 operand: attention (OUT), mid state (FFN1), hidden (FFN2)
  const T* ln_s;       // LayerNorm scale/bias of this layer (QKV, FFN1)
  const T* ln_b;
  const void* w;       // this layer's weight: T (K, N), int8 (K, N) or packed int8 (K/2, N)
  const T* wscale;     // W8: (N,) channel scales; W4: (K / group, N) group scales
  const T* bias;       // (N,) or null
  float* q;            // QKV: (rows, d) pre-scaled queries
  void* ck;            // QKV: this layer's (rows, S, d) cache, or with an int8
  void* cv;            //      cache the (rows, 2d) f32 k/v scratch (ck only)
  float* out32;        // OUT: (rows, d) mid state; FFN1: (rows, N) GELU output
  const float* res32;  // FFN2: (rows, d) mid state
  T* y;                // FFN2: (rows, d) hidden state leaving the layer
  float* partial;      // OUT, FFN2 under tensor parallelism: (rows, N) raw f32 sums,
                       // the epilogue left to the all-reduce (null: fused here)
  const int* idx;      // QKV: (rows / qblk,) start slot of each cache row, or null
  const float* apart;  // OUT in the persistent step with a chunked cache: the
                       // chunks' partial softmaxes, merged into the operand (null: a32)
  int rows, K, N, d, S, index, group, qblk;   // rows: query rows; qblk per cache row;
  int n_chunks, hd;                           // d: the attention (cache) width
  float scale;
};

size_t proj_smem(int K, int wf, int mr) {
  size_t bytes = sizeof(float) * ((size_t)mr * K + KSPLIT * mr * NCOL);
  if (wf == W8) bytes += sizeof(float) * mr + (size_t)mr * K;
  return bytes;
}

// The cache slot of query row `row`: qblk query rows per cache row, the i-th
// at the row's start slot + i (the per-row `idx`, or the scalar `index`).
__device__ __forceinline__ int query_slot(const int* idx, int index, int qblk, int row) {
  return (idx ? idx[row / qblk] : index) + row % qblk;
}

__device__ __forceinline__ int sext4(int b) {   // low nibble of b, sign-extended
  return (int)((unsigned)b << 28) >> 28;
}

// A barrier of the n threads (whole warps) that use barrier `id` (1..15; 0
// is __syncthreads'), with the memory ordering of __syncthreads among them.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The normalized attention output of one element of a (query row, head) from
// its chunks' partial softmaxes (max, sum, acc[hd]) at `rec`, `stride` floats
// apart, merged in chunk order.  Empty partials (NEG_INF, 0, 0) add nothing;
// every query has at least its own slot, so the sum is positive.
__device__ __forceinline__ float merge_chunks(const float* rec, int n_chunks, int stride,
                                              int e) {
  float mt = NEG_INF;
  for (int c = 0; c < n_chunks; ++c) mt = fmaxf(mt, rec[c * stride]);
  float lt = 0.f, at = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float f = expf(rec[c * stride] - mt);
    lt += rec[c * stride + 1] * f;
    at += rec[c * stride + 2 + e] * f;
  }
  return at / fmaxf(lt, 1e-30f);
}

// out[r, j] = epilogue(sum_k A[r, k] W[k, j]) for the tile (bx, by) of MAXR
// rows x NCOL columns, by PNT threads; the A operand (with its LayerNorm
// prologue) sits in shared memory `sm`, rounded to the compute dtype, or
// quantized to int8 codes for W8.  Warp w sums the w-th K slice of kper
// (KSPLIT slices), and the slices' partials add in slice order.  The phased
// proj_kernel runs one tile a block; the persistent step walks the tiles.
template <typename T, typename TC, int MODE, int WF, int MAXR>
__device__ __forceinline__ void proj_block(const ProjArgs<T>& a, int bx, int by, float* sm) {
  float* As = sm;                    // [MAXR][K]
  float* red = sm + MAXR * a.K;      // [KSPLIT][MAXR][NCOL]
  float* sxs = red + KSPLIT * MAXR * NCOL;                 // W8: [MAXR] row scales
  int8_t* Aq = reinterpret_cast<int8_t*>(sxs + MAXR);      // W8: [MAXR][K] codes
  const int K = a.K, N = a.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = by * MAXR;
  const int nr = min(MAXR, a.rows - r0);
  __syncthreads();   // the block's previous tile no longer reads sm
  // W8 quantizes the f32 operand; the other formats round it to T first.
  auto operand = [](float v) { return WF == W8 ? v : round_to<T>(v); };

  if constexpr (MODE == QKV || MODE == FFN1) {
    // LayerNorm of each row by one warp, each lane over k = lane, lane + 32,
    // ...: a row's arithmetic does not depend on how many rows share the
    // step (joint == solo).
    for (int r = warp; r < MAXR; r += KSPLIT) {
      float* dst = As + r * K;
      if (r >= nr) {
        for (int kk = lane; kk < K; kk += 32) dst[kk] = 0.f;
        continue;
      }
      const size_t row = (size_t)(r0 + r) * K;
      float sum = 0.f;
#pragma unroll 4
      for (int kk = lane; kk < K; kk += 32) {
        const float xv = MODE == QKV ? to_f<T>(a.x[row + kk]) : a.a32[row + kk];
        dst[kk] = xv;
        sum += xv;
      }
      const float mean = warp_sum(sum) / K;
      float sq = 0.f;
      for (int kk = lane; kk < K; kk += 32) {
        const float dv = dst[kk] - mean;
        sq += dv * dv;
      }
      const float inv = 1.f / sqrtf(warp_sum(sq) / K + LN_EPS);
#pragma unroll 4
      for (int kk = lane; kk < K; kk += 32)
        dst[kk] = operand((dst[kk] - mean) * inv * to_f<T>(a.ln_s[kk]) +
                          to_f<T>(a.ln_b[kk]));
    }
  } else if (MODE == OUT && a.apart) {
    // The split attention's chunks merged here (merge_kernel's arithmetic).
    const int heads = K / a.hd;
    for (int i = tid; i < MAXR * K; i += PNT) {
      const int c = i % K;
      As[i] = i < nr * K
                  ? operand(merge_chunks(a.apart + ((size_t)(r0 + i / K) * heads + c / a.hd) *
                                                       a.n_chunks * (a.hd + 2),
                                         a.n_chunks, a.hd + 2, c % a.hd))
                  : 0.f;
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < MAXR * K; i += PNT)
      As[i] = i < nr * K ? operand(a.a32[(size_t)r0 * K + i]) : 0.f;
  }
  __syncthreads();

  if constexpr (WF == W8) {
    // Dynamic per-row activation quantization (_q8_dot): one warp per row.
    for (int r = warp; r < MAXR; r += KSPLIT) {
      const float* src = As + r * K;
      float amax = 0.f;
      for (int kk = lane; kk < K; kk += 32) amax = fmaxf(amax, fabsf(src[kk]));
      const float sx = fmaxf(warp_max(amax), 1e-8f) / 127.f;
      for (int kk = lane; kk < K; kk += 32)
        Aq[r * K + kk] = (int8_t)fminf(fmaxf(rintf(src[kk] / sx), -127.f), 127.f);
      if (lane == 0) sxs[r] = sx;
    }
    __syncthreads();
  }

  const int col = bx * NCOL + lane;
  float acc[MAXR];
  int iacc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    acc[r] = 0.f;
    iacc[r] = 0;
  }
  if constexpr (WF == DENSE) {
    const T* w = static_cast<const T*>(a.w);
    const int kper = (K + KSPLIT - 1) / KSPLIT;
    const int k0 = warp * kper, k1 = min(K, k0 + kper);
    if (col < N) {
      // KUNR weight loads are issued before their FMAs, so each warp keeps that
      // many in flight instead of waiting out one load latency per k.
      int kk = k0;
      for (; kk + KUNR <= k1; kk += KUNR) {
        float wv[KUNR];
#pragma unroll
        for (int u = 0; u < KUNR; ++u) wv[u] = to_f<T>(w[(size_t)(kk + u) * N + col]);
#pragma unroll
        for (int u = 0; u < KUNR; ++u)
#pragma unroll
          for (int r = 0; r < MAXR; ++r) acc[r] = fmaf(As[r * K + kk + u], wv[u], acc[r]);
      }
      for (; kk < k1; ++kk) {
        const float wv = to_f<T>(w[(size_t)kk * N + col]);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) acc[r] = fmaf(As[r * K + kk], wv, acc[r]);
      }
    }
  } else if constexpr (WF == W8) {
    // K slices of a multiple of 4 (K % 8 == 0): 4 codes of a row are one int.
    const int8_t* w = static_cast<const int8_t*>(a.w);
    const int kper = (K + 4 * KSPLIT - 1) / (4 * KSPLIT) * 4;
    const int k0 = warp * kper, k1 = min(K, k0 + kper);
    if (col < N) {
      for (int kk = k0; kk < k1; kk += KUNR) {
        const int n4 = min(KUNR, k1 - kk) / 4;   // fewer at a slice's tail
        int wv[KUNR];
#pragma unroll
        for (int u = 0; u < KUNR; ++u)
          wv[u] = u < 4 * n4 ? (int)w[(size_t)(kk + u) * N + col] : 0;
#pragma unroll
        for (int g = 0; g < KUNR / 4; ++g) {
          if (g >= n4) break;
          const int w4 = (wv[4 * g] & 0xff) | (wv[4 * g + 1] & 0xff) << 8 |
                         (wv[4 * g + 2] & 0xff) << 16 | (int)((unsigned)wv[4 * g + 3] << 24);
#pragma unroll
          for (int r = 0; r < MAXR; ++r)
            iacc[r] = __dp4a(*reinterpret_cast<const int*>(Aq + r * K + kk + 4 * g), w4,
                             iacc[r]);
        }
      }
    }
  } else {
    // W4: byte kb of the packed weight holds rows kb (low) and kb + K/2 (high).
    const int8_t* w = static_cast<const int8_t*>(a.w);
    const int half = K / 2, g = a.group;
    const int kper = (half + KSPLIT - 1) / KSPLIT;
    const int k0 = warp * kper, k1 = min(half, k0 + kper);
    if (col < N) {
      int kb = k0;
      for (; kb + KUNR <= k1; kb += KUNR) {
        int bv[KUNR];
        float slo[KUNR], shi[KUNR];
#pragma unroll
        for (int u = 0; u < KUNR; ++u) {
          bv[u] = w[(size_t)(kb + u) * N + col];
          slo[u] = to_f<T>(a.wscale[(size_t)((kb + u) / g) * N + col]);
          shi[u] = to_f<T>(a.wscale[(size_t)((kb + u + half) / g) * N + col]);
        }
#pragma unroll
        for (int u = 0; u < KUNR; ++u) {
          const float wlo = round_to<T>((float)sext4(bv[u]) * slo[u]);
          const float whi = round_to<T>((float)(bv[u] >> 4) * shi[u]);
#pragma unroll
          for (int r = 0; r < MAXR; ++r) {
            acc[r] = fmaf(As[r * K + kb + u], wlo, acc[r]);
            acc[r] = fmaf(As[r * K + kb + u + half], whi, acc[r]);
          }
        }
      }
      for (; kb < k1; ++kb) {
        const int b = w[(size_t)kb * N + col];
        const float slo = to_f<T>(a.wscale[(size_t)(kb / g) * N + col]);
        const float shi = to_f<T>(a.wscale[(size_t)((kb + half) / g) * N + col]);
        const float wlo = round_to<T>((float)sext4(b) * slo);
        const float whi = round_to<T>((float)(b >> 4) * shi);
#pragma unroll
        for (int r = 0; r < MAXR; ++r) {
          acc[r] = fmaf(As[r * K + kb], wlo, acc[r]);
          acc[r] = fmaf(As[r * K + kb + half], whi, acc[r]);
        }
      }
    }
  }
  int* ired = reinterpret_cast<int*>(red);
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if constexpr (WF == W8) {
      ired[(warp * MAXR + r) * NCOL + lane] = iacc[r];
    } else {
      red[(warp * MAXR + r) * NCOL + lane] = acc[r];
    }
  }
  __syncthreads();

  for (int i = tid; i < nr * NCOL; i += PNT) {
    const int r = i / NCOL, j = bx * NCOL + i % NCOL;
    if (j >= N) continue;
    float s;
    if constexpr (WF == W8) {
      int is = 0;   // exact: the int32 sum of the warps' int32 partials
#pragma unroll
      for (int w = 0; w < KSPLIT; ++w) is += ired[(w * MAXR + r) * NCOL + i % NCOL];
      s = (float)is * sxs[r] * to_f<T>(a.wscale[j]);
    } else {
      s = 0.f;
#pragma unroll
      for (int w = 0; w < KSPLIT; ++w) s += red[(w * MAXR + r) * NCOL + i % NCOL];
    }
    const int row = r0 + r, d = a.d;
    if ((MODE == OUT || MODE == FFN2) && a.partial) {
      a.partial[(size_t)row * N + j] = s;
    } else if constexpr (MODE == QKV) {
      if (j < d) {
        a.q[(size_t)row * d + j] = s * a.scale;
      } else if constexpr (std::is_same<TC, int8_t>::value) {
        static_cast<float*>(a.ck)[(size_t)row * 2 * d + (j - d)] = round_to<T>(s);
      } else {
        const int slot = query_slot(a.idx, a.index, a.qblk, row);
        if (slot < a.S) {
          TC* cache = static_cast<TC*>(j < 2 * d ? a.ck : a.cv);
          cache[((size_t)(row / a.qblk) * a.S + slot) * d + (j % d)] = from_f<TC>(s);
        }
      }
    } else if constexpr (MODE == OUT) {
      a.out32[(size_t)row * N + j] = to_f<T>(a.x[(size_t)row * N + j]) +
                                     (s + to_f<T>(a.bias[j]));
    } else if constexpr (MODE == FFN1) {
      const float t = s + to_f<T>(a.bias[j]);
      a.out32[(size_t)row * N + j] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
    } else {
      a.y[(size_t)row * N + j] = from_f<T>(a.res32[(size_t)row * N + j] +
                                           (s + to_f<T>(a.bias[j])));
    }
  }
}

template <typename T, typename TC, int MODE, int WF, int MAXR>
__global__ void __launch_bounds__(PNT) proj_kernel(ProjArgs<T> a) {
  extern __shared__ __align__(16) float sm[];
  proj_block<T, TC, MODE, WF, MAXR>(a, blockIdx.x, blockIdx.y, sm);
}

// int8 cache write of a new token (quantize_kv_rowmajor) by one warp: the
// (query row, head, k|v) slice of the (rows, 2d) f32 scratch, into the query
// row's slot (query_slot).  The phased kv_quant_kernel runs one warp per
// slice; the persistent #6, the attention item of that (query row, head);
// the persistent #7 (K > 1), a phase of its own (run_kv_quant).
template <int HD>
__device__ __forceinline__ void kv_quant_warp(const float* kvnew, int8_t* ck, int8_t* cv,
                                              __nv_bfloat16* ks, __nv_bfloat16* vs,
                                              const int* idx, int row, int kv, int hh, int h,
                                              int S, int d, int index, int qblk, int lane) {
  constexpr int DPL = HD / 32;
  const int slot_in_row = query_slot(idx, index, qblk, row);
  if (slot_in_row >= S) return;                 // the whole warp: a skipped write
  const float* src = kvnew + (size_t)row * 2 * d + kv * d + hh * HD + lane * DPL;
  float xv[DPL], amax = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    xv[i] = src[i];
    amax = fmaxf(amax, fabsf(xv[i]));
  }
  const float sc = fmaxf(warp_max(amax), 1e-8f) / 127.f;
  const size_t slot = (size_t)(row / qblk) * S + slot_in_row;
  int8_t* dst = (kv ? cv : ck) + slot * d + hh * HD + lane * DPL;
#pragma unroll
  for (int i = 0; i < DPL; ++i) dst[i] = (int8_t)fminf(fmaxf(rintf(xv[i] / sc), -127.f), 127.f);
  if (lane == 0) (kv ? vs : ks)[slot * h + hh] = __float2bfloat16_rn(sc);
}

template <int HD>
__global__ void __launch_bounds__(KVQ_WARPS * 32)
kv_quant_kernel(const float* __restrict__ kvnew, int8_t* __restrict__ ck,
                int8_t* __restrict__ cv, __nv_bfloat16* __restrict__ ks,
                __nv_bfloat16* __restrict__ vs, const int* __restrict__ idx, int rows, int h,
                int S, int d, int index, int qblk) {
  const int wid = blockIdx.x * KVQ_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= rows * 2 * h) return;
  kv_quant_warp<HD>(kvnew, ck, cv, ks, vs, idx, wid / (2 * h), wid / h % 2, wid % h, h, S, d,
                    index, qblk, lane);
}

// One attention item, by ANW warps (threads t = 0 .. ANW*32-1 of the item,
// synchronised by named barrier `bar`): query row rq = bx / h, head bx % h,
// and with SPLIT chunk `by` of n_chunks.  softmax(q . k_s) v_s over the valid
// slots of the query's cache row (of its chunk), online in f32.  Each warp
// walks its own share of the slots UNR at a time (each lane holds HD/32
// dims), then the warps' partial (max, sum, acc) merge through m_w, l_w and
// acc_w ([ANW][HD]) in shared memory.  An int8 cache (TC = int8_t)
// dequantizes each slot by its head's bf16 scale.  Unsplit, the item writes
// the normalized output; split, its chunk's partial (max, sum, unnormalized
// acc) to `part`, and merge_chunks combines a query's chunks.  A chunk with no
// valid slot (past the query's own slot, or in the padding between the
// ranges) writes the empty partial (NEG_INF, 0, 0).  With `kvnew` (the
// persistent #6, int8 cache) the item that holds the query's own slot first
// quantizes its head's new k and v into it (kv_quant_warp, warps 0 and 1):
// a block of one token reads no other new slot.  Query i of a K-token block
// also reads the slots of queries 0 .. i-1, which other items write, so #7
// passes no `kvnew` and writes them in a phase before (run_kv_quant).
// The phased attend_kernel runs one item a block, and so does the persistent
// step.
template <typename TC, int HD, bool SPLIT>
__device__ __forceinline__ void attend_item(
    const float* q, TC* ck, TC* cv, __nv_bfloat16* ks, __nv_bfloat16* vs,
    const int* tokens_lens, const int* codes_lens, const int* idx, float* out, float* part,
    const float* kvnew, int h, int S, int d, int index, int qblk, int ttm, int pm, int chunk,
    int bx, int by, int n_chunks, int t, int bar, float* m_w, float* l_w, float* acc_w) {
  static_assert(HD % 32 == 0, "head dim must be a multiple of 32");
  constexpr int DPL = HD / 32;
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  const int rq = bx / h, hh = bx % h;                   // query row, head
  const int row = rq / qblk;                            // its cache row
  const int warp = t / 32, lane = t % 32;
  const int dim0 = hh * HD + lane * DPL;
  const size_t row_base = (size_t)row * S * d;
  // Valid slots: the three ranges of the Pallas kernel's attend formula, which
  // are disjoint because tokens_len <= ttm and codes_len <= pm; the generated
  // range ends at the query's own slot (past S: at S - 1).  Split, each range
  // is cut to this item's chunk [lo, hi).
  const int lo = SPLIT ? by * chunk : 0, hi = SPLIT ? min(lo + chunk, S) : S;
  const int own = query_slot(idx, index, qblk, rq);
  if constexpr (QUANT) {
    if (kvnew != nullptr) {
      if (warp < 2 && own >= lo && own < hi)
        kv_quant_warp<HD>(kvnew, ck, cv, ks, vs, idx, rq, warp, hh, h, S, d, index, qblk, lane);
      named_sync(bar, ANW * 32);   // the slot's codes and scale are written
    }
  }

  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] = q[(size_t)rq * d + dim0 + i];
  const int last = min(own, S - 1);
  const int s1 = lo, e1 = min(min(max(tokens_lens[row], 0), ttm), hi);
  const int s2 = max(ttm, lo), e2 = min(ttm + min(max(codes_lens[row], 0), pm), hi);
  const int s3 = max(ttm + pm, lo), e3 = min(last + 1, hi);
  const int n1 = max(0, e1 - s1), n2 = max(0, e2 - s2);
  const int n_valid = n1 + n2 + max(0, e3 - s3);

  float m = NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;

  for (int j0 = warp * UNR; j0 < n_valid; j0 += ANW * UNR) {
    // All UNR slots' k and v are loaded before any is used, so one memory
    // latency covers the iteration.
    float kr[UNR][DPL], vr[UNR][DPL];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int j = j0 + u;
      const int slot = j < n1 ? s1 + j : (j < n1 + n2 ? s2 + (j - n1) : s3 + (j - n1 - n2));
      const size_t off = row_base + (size_t)slot * d + dim0;
      const bool in = j < n_valid;
      float ksc = 1.f, vsc = 1.f;
      if constexpr (QUANT) {
        const size_t soff = ((size_t)row * S + slot) * h + hh;
        ksc = in ? __bfloat162float(ks[soff]) : 0.f;
        vsc = in ? __bfloat162float(vs[soff]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[u][i] = in ? to_f<TC>(ck[off + i]) * ksc : 0.f;
        vr[u][i] = in ? to_f<TC>(cv[off + i]) * vsc : 0.f;
      }
    }
    float sc[UNR];
    float mloc = m;
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      float part_ = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part_ = fmaf(qv[i], kr[u][i], part_);
      sc[u] = j0 + u < n_valid ? warp_sum(part_) : -INFINITY;
      mloc = fmaxf(mloc, sc[u]);
    }
    const float alpha = expf(m - mloc);
    float p[UNR], psum = 0.f;
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      p[u] = expf(sc[u] - mloc);
      psum += p[u];
    }
    l = l * alpha + psum;
    m = mloc;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      float pv = 0.f;
#pragma unroll
      for (int u = 0; u < UNR; ++u) pv = fmaf(p[u], vr[u][i], pv);
      acc[i] = acc[i] * alpha + pv;
    }
  }

  if (lane == 0) {
    m_w[warp] = m;
    l_w[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc_w[warp * HD + lane * DPL + i] = acc[i];
  named_sync(bar, ANW * 32);
  // A warp with no slot holds (NEG_INF, 0, 0): exp(NEG_INF - mt) is 0 beside a
  // warp that had slots, and 1 (times zeros) when none had.
  float* rec = SPLIT ? part + ((size_t)bx * n_chunks + by) * (HD + 2) : nullptr;
  for (int e = t; e < HD; e += ANW * 32) {
    float mt = NEG_INF;
    for (int w = 0; w < ANW; ++w) mt = fmaxf(mt, m_w[w]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < ANW; ++w) {
      const float f = expf(m_w[w] - mt);
      lt += l_w[w] * f;
      at += acc_w[w * HD + e] * f;
    }
    if constexpr (SPLIT) {
      if (e == 0) {
        rec[0] = mt;
        rec[1] = lt;
      }
      rec[2 + e] = at;
    } else {
      out[(size_t)rq * d + hh * HD + e] = at / fmaxf(lt, 1e-30f);
    }
  }
  named_sync(bar, ANW * 32);   // m_w, l_w, acc_w are free for the next item
}

// The phased attention: one item a block, grid (query rows * h, n_chunks).
template <typename TC, int HD, bool SPLIT>
__global__ void __launch_bounds__(ANW * 32)
attend_kernel(const float* __restrict__ q, TC* ck, TC* cv, __nv_bfloat16* ks,
              __nv_bfloat16* vs, const int* __restrict__ tokens_lens,
              const int* __restrict__ codes_lens, const int* __restrict__ idx,
              float* __restrict__ out, float* __restrict__ part, int h, int S, int d,
              int index, int qblk, int ttm, int pm, int chunk) {
  __shared__ float m_w[ANW], l_w[ANW], acc_w[ANW * HD];
  attend_item<TC, HD, SPLIT>(q, ck, cv, ks, vs, tokens_lens, codes_lens, idx, out, part,
                             nullptr, h, S, d, index, qblk, ttm, pm, chunk, blockIdx.x,
                             blockIdx.y, gridDim.y, threadIdx.x, 1, m_w, l_w, acc_w);
}

// The second pass of the phased split attention: one block per (query row,
// head) merges its n_chunks partials (merge_chunks) into the output.
template <int HD>
__global__ void __launch_bounds__(HD)
merge_kernel(const float* __restrict__ part, float* __restrict__ out, int h, int d,
             int n_chunks) {
  const int rq = blockIdx.x / h, hh = blockIdx.x % h, e = threadIdx.x;
  out[(size_t)rq * d + hh * HD + e] =
      merge_chunks(part + (size_t)blockIdx.x * n_chunks * (HD + 2), n_chunks, HD + 2, e);
}

template <typename T, typename TC, int MODE, int WF, int MR>
int launch_proj_tile(const ProjArgs<T>& a, cudaStream_t stream) {
  static unsigned configured = 0;   // one bit per card: the attribute is per device
  cudaError_t err = once_per_device(configured, [] {
    const int kmax = MR == 16 ? max_k16(WF) : max_k8(WF);
    return cudaFuncSetAttribute(proj_kernel<T, TC, MODE, WF, MR>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)proj_smem(kmax, WF, MR));
  });
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.N + NCOL - 1) / NCOL, (a.rows + MR - 1) / MR);
  proj_kernel<T, TC, MODE, WF, MR><<<grid, PNT, proj_smem(a.K, WF, MR), stream>>>(a);
  return (int)cudaGetLastError();
}

// A tile of 16 rows where its operand fits shared memory, else of 8.
template <typename T, typename TC, int MODE, int WF>
int launch_proj(const ProjArgs<T>& a, cudaStream_t stream) {
  if (a.K <= max_k16(WF)) return launch_proj_tile<T, TC, MODE, WF, 16>(a, stream);
  if (a.K <= max_k8(WF)) return launch_proj_tile<T, TC, MODE, WF, 8>(a, stream);
  return (int)cudaErrorInvalidValue;
}

struct StepArgs {
  const void *x, *n1s, *n1b, *wqkv, *wout, *bout, *n2s, *n2b, *w1, *b1, *w2, *b2;
  void *y, *ck, *cv;
  const void *sqkv, *sout, *s1, *s2;   // weight scales (W8, W4) or null
  void *ks, *vs;                       // int8 cache scales (L, rows, S, h) or null
  const int *tokens_lens, *codes_lens;
  const int* idx;                      // (rows,) start slots, or null: `index`
  float *qbuf, *abuf, *xmid, *hmid, *kvnew;
  float* part;                         // chunk < S: (rows * qblk * h * S / chunk, HD + 2)
  float *part_out, *part_ffn;          // TP: this rank's (rows * qblk, d) f32 partials
  int L, rows, S, d, da, h, dff, index, qblk, ttm, pm, groups_d, groups_att, groups_ff, chunk;
  float scale;                         // da: the attention (cache) width, d unless TP
  unsigned long long* trace;           // persistent step: phase timestamps, or null
};

// The weight of layer l of a stacked (L, K, N) weight in format WF, and its
// bytes.
template <typename T, int WF>
__host__ __device__ const void* layer_weight(const void* w, int l, int K, int N) {
  const size_t n = (size_t)K * N;
  if (WF == DENSE) return static_cast<const T*>(w) + l * n;
  return static_cast<const int8_t*>(w) + l * (WF == W4 ? n / 2 : n);
}

template <typename T, int WF>
__host__ __device__ size_t weight_bytes(int K, int N) {
  const size_t n = (size_t)K * N;
  return WF == DENSE ? n * sizeof(T) : (WF == W4 ? n / 2 : n);
}

// This layer's scales of a stacked (L, K, N) weight: (L, N) or (L, groups, N).
template <typename T, int WF>
__host__ __device__ const T* layer_scale(const void* s, int l, int N, int groups) {
  if (WF == DENSE) return nullptr;
  return static_cast<const T*>(s) + (size_t)l * (WF == W4 ? groups : 1) * N;
}

// The projection arguments every phase of layer l shares.
template <typename T>
__host__ __device__ ProjArgs<T> layer_args(const StepArgs& s, int l) {
  ProjArgs<T> a{};
  a.x = l == 0 ? static_cast<const T*>(s.x) : static_cast<const T*>(s.y);
  a.rows = s.rows * s.qblk;   // query rows through the projections
  a.d = s.da;
  a.S = s.S;
  a.index = s.index;
  a.idx = s.idx;
  a.qblk = s.qblk;
  a.scale = s.scale;
  return a;
}

// Layer l's cache (and int8 scales), k or v.
template <typename TC>
__host__ __device__ TC* layer_cache(const StepArgs& s, void* c, int l) {
  return static_cast<TC*>(c) + l * ((size_t)s.rows * s.S * s.da);
}

__host__ __device__ inline __nv_bfloat16* layer_kv_scale(const StepArgs& s, void* c, int l) {
  return c ? static_cast<__nv_bfloat16*>(c) + l * ((size_t)s.rows * s.S * s.h) : nullptr;
}

// The four projections of layer l: one definition for the phased launchers
// and the persistent step, so that both compute every element alike.
// LN1 + QKV: q to qbuf, k / v into the cache (int8 cache: to the kvnew scratch).
template <typename T, typename TC, int WF>
__host__ __device__ ProjArgs<T> qkv_args(const StepArgs& s, int l) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  ProjArgs<T> a = layer_args<T>(s, l);
  a.ln_s = static_cast<const T*>(s.n1s) + (size_t)l * s.d;
  a.ln_b = static_cast<const T*>(s.n1b) + (size_t)l * s.d;
  a.w = layer_weight<T, WF>(s.wqkv, l, s.d, 3 * s.da);
  a.wscale = layer_scale<T, WF>(s.sqkv, l, 3 * s.da, s.groups_d);
  a.group = s.d / s.groups_d;
  a.K = s.d;
  a.N = 3 * s.da;
  a.q = s.qbuf;
  a.ck = QUANT ? static_cast<void*>(s.kvnew) : static_cast<void*>(layer_cache<TC>(s, s.ck, l));
  a.cv = layer_cache<TC>(s, s.cv, l);
  return a;
}

// The out-projection, fused with its bias and residual into the f32 mid
// state, or under TP (`partial`) its raw partial sum.
template <typename T, int WF>
__host__ __device__ ProjArgs<T> out_args(const StepArgs& s, int l, float* partial) {
  ProjArgs<T> a = layer_args<T>(s, l);
  a.a32 = s.abuf;
  a.w = layer_weight<T, WF>(s.wout, l, s.da, s.d);
  a.wscale = layer_scale<T, WF>(s.sout, l, s.d, s.groups_att);
  a.group = s.da / s.groups_att;
  a.bias = static_cast<const T*>(s.bout) + (size_t)l * s.d;
  a.K = s.da;
  a.N = s.d;
  a.out32 = s.xmid;
  a.partial = partial;
  return a;
}

// LN2 (of the f32 mid state) + FFN1 + GELU.
template <typename T, int WF>
__host__ __device__ ProjArgs<T> ffn1_args(const StepArgs& s, int l) {
  ProjArgs<T> a = layer_args<T>(s, l);
  a.a32 = s.xmid;
  a.ln_s = static_cast<const T*>(s.n2s) + (size_t)l * s.d;
  a.ln_b = static_cast<const T*>(s.n2b) + (size_t)l * s.d;
  a.w = layer_weight<T, WF>(s.w1, l, s.d, s.dff);
  a.wscale = layer_scale<T, WF>(s.s1, l, s.dff, s.groups_d);
  a.group = s.d / s.groups_d;
  a.bias = static_cast<const T*>(s.b1) + (size_t)l * s.dff;
  a.K = s.d;
  a.N = s.dff;
  a.out32 = s.hmid;
  return a;
}

// FFN2, fused with its bias and residual into the hidden state, or under TP
// (`partial`) its raw partial sum.
template <typename T, int WF>
__host__ __device__ ProjArgs<T> ffn2_args(const StepArgs& s, int l, float* partial) {
  ProjArgs<T> a = layer_args<T>(s, l);
  a.a32 = s.hmid;
  a.w = layer_weight<T, WF>(s.w2, l, s.dff, s.d);
  a.wscale = layer_scale<T, WF>(s.s2, l, s.d, s.groups_ff);
  a.group = s.dff / s.groups_ff;
  a.bias = static_cast<const T*>(s.b2) + (size_t)l * s.d;
  a.K = s.dff;
  a.N = s.d;
  a.res32 = s.xmid;
  a.y = static_cast<T*>(s.y);
  a.partial = partial;
  return a;
}

// Layer l up to the out-projection: LN1 + QKV (+ the int8 cache write), the
// attention, and the out-projection, fused with its bias and residual into
// the f32 mid state, or under TP (`partial`) its raw partial sum.
template <typename T, typename TC, int HD, int WF>
int attn_phase(const StepArgs& s, int l, float* partial, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  const int da = s.da;
  const int rows_q = s.rows * s.qblk;
  TC* ck = layer_cache<TC>(s, s.ck, l);
  TC* cv = layer_cache<TC>(s, s.cv, l);
  __nv_bfloat16* ks = QUANT ? layer_kv_scale(s, s.ks, l) : nullptr;
  __nv_bfloat16* vs = QUANT ? layer_kv_scale(s, s.vs, l) : nullptr;
  int err;
  if ((err = launch_proj<T, TC, QKV, WF>(qkv_args<T, TC, WF>(s, l), stream))) return err;
  if constexpr (QUANT) {
    const int warps = rows_q * 2 * s.h;
    kv_quant_kernel<HD><<<(warps + KVQ_WARPS - 1) / KVQ_WARPS, KVQ_WARPS * 32, 0, stream>>>(
        s.kvnew, ck, cv, ks, vs, s.idx, rows_q, s.h, s.S, da, s.index, s.qblk);
    if ((err = (int)cudaGetLastError())) return err;
  }

  if (s.chunk < s.S) {
    const int n_chunks = s.S / s.chunk;
    attend_kernel<TC, HD, true><<<dim3(rows_q * s.h, n_chunks), ANW * 32, 0, stream>>>(
        s.qbuf, ck, cv, ks, vs, s.tokens_lens, s.codes_lens, s.idx, nullptr, s.part, s.h,
        s.S, da, s.index, s.qblk, s.ttm, s.pm, s.chunk);
    if ((err = (int)cudaGetLastError())) return err;
    merge_kernel<HD><<<rows_q * s.h, HD, 0, stream>>>(s.part, s.abuf, s.h, da, n_chunks);
  } else {
    attend_kernel<TC, HD, false><<<rows_q * s.h, ANW * 32, 0, stream>>>(
        s.qbuf, ck, cv, ks, vs, s.tokens_lens, s.codes_lens, s.idx, s.abuf, nullptr, s.h,
        s.S, da, s.index, s.qblk, s.ttm, s.pm, s.S);
  }
  if ((err = (int)cudaGetLastError())) return err;
  return launch_proj<T, T, OUT, WF>(out_args<T, WF>(s, l, partial), stream);
}

// The rest of layer l: LN2 + FFN1 + GELU, and FFN2.
template <typename T, typename TC, int HD, int WF>
int ffn_phase(const StepArgs& s, int l, float* partial, cudaStream_t stream) {
  int err;
  if ((err = launch_proj<T, T, FFN1, WF>(ffn1_args<T, WF>(s, l), stream))) return err;
  return launch_proj<T, T, FFN2, WF>(ffn2_args<T, WF>(s, l, partial), stream);
}

// The phased step: 5-7 kernels a layer on one stream (the phased twin of #6
// and #7, and the ranks of the TP step).
template <typename T, typename TC, int HD, int WF>
int step(const StepArgs& s, cudaStream_t stream) {
  int err;
  for (int l = 0; l < s.L; ++l) {
    if ((err = attn_phase<T, TC, HD, WF>(s, l, nullptr, stream))) return err;
    if ((err = ffn_phase<T, TC, HD, WF>(s, l, nullptr, stream))) return err;
  }
  return 0;
}

// ---- #6 and #7 as one persistent launch a step (launched by fused_step.cu) ----

// A projection's tiles walked by the persistent blocks, over n_ranks stacks
// (the TP step's ranks on this card; one otherwise): args(r) is rank r's
// ProjArgs, and the tiles of the ranks are concatenated rank-major, tile v =
// blockIdx.x + j * gridDim.x being rank v / n's tile v % n, the phased
// proj_kernel's block (bx, by) = (v % nx, v / nx): the 16- or 8-row tile
// that launch_proj would pick.
template <typename T, typename TC, int MODE, int WF, typename A>
__device__ __forceinline__ void run_proj(A&& args, int n_ranks, float* sm) {
  const ProjArgs<T> a0 = args(0);
  const int nx = (a0.N + NCOL - 1) / NCOL;
  if (a0.K <= max_k16(WF)) {
    const int n = nx * ((a0.rows + 15) / 16);
    for (int g = blockIdx.x; g < n_ranks * n; g += gridDim.x) {
      const int v = g % n;
      proj_block<T, TC, MODE, WF, 16>(args(g / n), v % nx, v / nx, sm);
    }
  } else {
    const int n = nx * ((a0.rows + 7) / 8);
    for (int g = blockIdx.x; g < n_ranks * n; g += gridDim.x) {
      const int v = g % n;
      proj_block<T, TC, MODE, WF, 8>(args(g / n), v % nx, v / nx, sm);
    }
  }
}

// Issues an L2 prefetch of every 128-byte line of [p, p + bytes), the lines
// spread over every thread of the grid.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  const size_t stride = (size_t)gridDim.x * blockDim.x * 128;
  for (size_t off = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 128; off < bytes;
       off += stride)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
}

// The attention items of layer l (query rows * h * n_chunks), one at a time
// a block (ANW warps are the whole block): item blockIdx.x + j * gridDim.x.
// With an int8 cache a block of one token (#6) folds its cache write into
// the items; #7's was written by run_kv_quant.
static_assert(ANW * 32 == PNT, "an attention item takes the persistent block");

template <typename TC, int HD, bool SPLIT, typename R>
__device__ __forceinline__ void run_attention(R&& rank, int n_ranks, int l, int n_chunks,
                                              float* sm) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  float* m_w = sm;
  float* l_w = m_w + ANW;
  float* acc_w = l_w + ANW;
  const StepArgs& s0 = rank(0);
  const int n_items = s0.rows * s0.qblk * s0.h * n_chunks;
  for (int g = blockIdx.x; g < n_ranks * n_items; g += gridDim.x) {
    const StepArgs& s = rank(g / n_items);
    const int it = g % n_items;
    TC* ck = layer_cache<TC>(s, s.ck, l);
    TC* cv = layer_cache<TC>(s, s.cv, l);
    __nv_bfloat16* ks = QUANT ? layer_kv_scale(s, s.ks, l) : nullptr;
    __nv_bfloat16* vs = QUANT ? layer_kv_scale(s, s.vs, l) : nullptr;
    attend_item<TC, HD, SPLIT>(s.qbuf, ck, cv, ks, vs, s.tokens_lens, s.codes_lens, s.idx,
                               s.abuf, s.part, QUANT && s.qblk == 1 ? s.kvnew : nullptr,
                               s.h, s.S, s.da, s.index, s.qblk, s.ttm, s.pm,
                               SPLIT ? s.chunk : s.S, it / n_chunks, it % n_chunks, n_chunks,
                               threadIdx.x, 1, m_w, l_w, acc_w);
  }
}

// run_attention at the stack's head dim (the launcher takes 32, 64, 96, 128).
template <typename TC, bool SPLIT, typename R>
__device__ __forceinline__ void run_attention_hd(R&& rank, int n_ranks, int l, int n_chunks,
                                                 float* sm) {
  switch (rank(0).da / rank(0).h) {
    case 32: run_attention<TC, 32, SPLIT>(rank, n_ranks, l, n_chunks, sm); break;
    case 64: run_attention<TC, 64, SPLIT>(rank, n_ranks, l, n_chunks, sm); break;
    case 96: run_attention<TC, 96, SPLIT>(rank, n_ranks, l, n_chunks, sm); break;
    default: run_attention<TC, 128, SPLIT>(rank, n_ranks, l, n_chunks, sm); break;
  }
}

// The int8 cache write of layer l as a phase (#7 with an int8 cache): one
// warp per (query row, head, k|v), kv_quant_kernel's warps, PNT / 32 of them
// a block, warp w + j * (grid warps), the ranks' warps concatenated rank-major.
template <int HD, typename R>
__device__ __forceinline__ void run_kv_quant(R&& rank, int n_ranks, int l) {
  constexpr int WARPS = PNT / 32;
  const StepArgs& s0 = rank(0);
  const int n = s0.rows * s0.qblk * 2 * s0.h;
  for (int g = blockIdx.x * WARPS + threadIdx.x / 32; g < n_ranks * n;
       g += gridDim.x * WARPS) {
    const StepArgs& s = rank(g / n);
    const int w = g % n;
    kv_quant_warp<HD>(s.kvnew, layer_cache<int8_t>(s, s.ck, l), layer_cache<int8_t>(s, s.cv, l),
                      layer_kv_scale(s, s.ks, l), layer_kv_scale(s, s.vs, l), s.idx,
                      w / (2 * s.h), w / s.h % 2, w % s.h, s.h, s.S, s.da, s.index, s.qblk,
                      threadIdx.x % 32);
  }
}

template <typename R>
__device__ __forceinline__ void run_kv_quant_hd(R&& rank, int n_ranks, int l) {
  switch (rank(0).da / rank(0).h) {
    case 32: run_kv_quant<32>(rank, n_ranks, l); break;
    case 64: run_kv_quant<64>(rank, n_ranks, l); break;
    case 96: run_kv_quant<96>(rank, n_ranks, l); break;
    default: run_kv_quant<128>(rank, n_ranks, l); break;
  }
}

// The L2 prefetches of a layer, issued while its attention runs: its OUT,
// FFN1 and FFN2 weights and the next layer's QKV weights.
template <typename T, int WF>
__device__ __forceinline__ void prefetch_layer(const StepArgs& s, int l) {
  prefetch_l2(layer_weight<T, WF>(s.wout, l, s.da, s.d), weight_bytes<T, WF>(s.da, s.d));
  prefetch_l2(layer_weight<T, WF>(s.w1, l, s.d, s.dff), weight_bytes<T, WF>(s.d, s.dff));
  prefetch_l2(layer_weight<T, WF>(s.w2, l, s.dff, s.d), weight_bytes<T, WF>(s.dff, s.d));
  if (l + 1 < s.L)
    prefetch_l2(layer_weight<T, WF>(s.wqkv, l + 1, s.d, 3 * s.da),
                weight_bytes<T, WF>(s.d, 3 * s.da));
}

// #6 and #7 in one cooperative launch: every block walks the layers, and
// each phase of a layer spreads its items over every block, with a grid-wide
// barrier between phases: QKV; the attention (#6: folding in the int8 cache
// write; with a chunked cache writing the chunks' partials); OUT (folding in
// the chunks' merge); FFN1; FFN2.  5 barriers a layer, 5 L - 1 a step.  #7
// with an int8 cache (qblk > 1) writes the cache in a phase of its own
// between QKV and the attention (run_kv_quant): 6 a layer, 6 L - 1 a step.
// Every item runs the phased route's device code on the same arguments, so
// each output element is computed alike: the persistent step is bit-equal to
// the phased one.  While a layer's attention runs, its OUT / FFN1 / FFN2
// weights and the next layer's QKV weights are prefetched into L2.
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The barrier after phase k of a persistent step of np phases a layer and
// L layers: sync() (a grid barrier, and under TP the wait for the other
// cards).  With a trace buffer (1 + 2 x np L x grid u64), each block b
// records when all its threads finished the phase (trace[1 + k * grid + b])
// and when the barrier let it go (trace[1 + (np L + k) * grid + b]); trace[0]
// is block 0's start.
template <typename Sync>
__device__ __forceinline__ void traced_barrier(unsigned long long* trace, int L, int k, int np,
                                               Sync&& sync) {
  if (trace) {
    __syncthreads();
    if (threadIdx.x == 0) trace[1 + (size_t)k * gridDim.x + blockIdx.x] = globaltimer();
  }
  sync();
  if (trace && threadIdx.x == 0)
    trace[1 + (size_t)(np * L + k) * gridDim.x + blockIdx.x] = globaltimer();
}

// OUT's arguments in the persistent steps: with a chunked cache its operand
// prologue merges the chunks' partial softmaxes (merge_chunks); `partial`
// as in out_args.
template <typename T, int WF>
__device__ __forceinline__ ProjArgs<T> out_args_merged(const StepArgs& s, int l, int n_chunks,
                                                       float* partial) {
  ProjArgs<T> a = out_args<T, WF>(s, l, partial);
  if (s.chunk < s.S) {
    a.apart = s.part;
    a.n_chunks = n_chunks;
    a.hd = s.da / s.h;
  }
  return a;
}

template <typename T, typename TC, int WF>
__global__ void __launch_bounds__(PNT, 1) step_persistent_kernel(StepArgs s) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const bool split = s.chunk < s.S;
  const int n_chunks = split ? s.S / s.chunk : 1;
  const bool kvq = QUANT && s.qblk > 1;   // the int8 cache write as a phase
  const int np = kvq ? STEP_PHASES_KVQ : STEP_PHASES;
  auto rank = [&](int) -> const StepArgs& { return s; };
  auto barrier = [&](int k) { traced_barrier(s.trace, s.L, k, np, [&] { grid.sync(); }); };
  if (s.trace && threadIdx.x == 0 && blockIdx.x == 0) s.trace[0] = globaltimer();
  for (int l = 0; l < s.L; ++l) {
    int k = np * l;
    run_proj<T, TC, QKV, WF>([&](int) { return qkv_args<T, TC, WF>(s, l); }, 1, sm);
    barrier(k++);
    prefetch_layer<T, WF>(s, l);
    if constexpr (QUANT) {
      if (kvq) {
        run_kv_quant_hd(rank, 1, l);
        barrier(k++);
      }
    }
    if (split)
      run_attention_hd<TC, true>(rank, 1, l, n_chunks, sm);
    else
      run_attention_hd<TC, false>(rank, 1, l, 1, sm);
    barrier(k++);
    run_proj<T, T, OUT, WF>([&](int) { return out_args_merged<T, WF>(s, l, n_chunks, nullptr); },
                            1, sm);
    barrier(k++);
    run_proj<T, T, FFN1, WF>([&](int) { return ffn1_args<T, WF>(s, l); }, 1, sm);
    barrier(k++);
    run_proj<T, T, FFN2, WF>([&](int) { return ffn2_args<T, WF>(s, l, nullptr); }, 1, sm);
    if (l + 1 < s.L || s.trace) barrier(k);
  }
}

// ---- Tensor parallelism: the all-reduce 5c and the persistent TP step ----

constexpr int MAX_MP = 8;      // ranks of one TP step
constexpr int TP_PTRS = 32;    // device pointers per rank of the TP launchers
// 5c's epilogues: the sum alone (f32), the OUT one (the f32 mid state) and
// the FFN2 one (the hidden state in the compute dtype).
enum Epilogue { EPI_SUM = 0, EPI_OUT = 1, EPI_FFN2 = 2 };

struct Partials {
  const float* p[MAX_MP];      // rank r's partial: local, or a peer's over NVLink
};

// 5c's element i, one definition for tp_allreduce_kernel and the persistent
// TP step's reduce phases (so the two are bit-equal by construction): the sum
// over ranks in rank order, ((0 + p_0) + p_1) + ..., in f32, the same bits on
// every rank; then EPI_SUM writes it (f32), EPI_OUT the f32 mid state x +
// (sum + bias) (x the layer's input, compute dtype), EPI_FFN2 the hidden
// state res32 + (sum + bias) in the compute dtype (the one-rank OUT and FFN2
// epilogues, after the sum).  The partials are read through L2 (ld.cg): a
// line of a peer's plane that L1 kept from the previous layer is stale.
template <typename T, int EPI>
__device__ __forceinline__ void reduce_element(const Partials& src, int mp, long i, int d,
                                               const T* bias, const T* x, const float* res32,
                                               float* out32, T* y) {
  float s = 0.f;
  for (int r = 0; r < mp; ++r) s += __ldcg(src.p[r] + i);
  if constexpr (EPI == EPI_SUM) {
    out32[i] = s;
  } else if constexpr (EPI == EPI_OUT) {
    out32[i] = to_f<T>(x[i]) + (s + to_f<T>(bias[i % d]));
  } else {
    y[i] = from_f<T>(res32[i] + (s + to_f<T>(bias[i % d])));
  }
}

// The persistent TP step (#6 and #7 under tensor parallelism): one
// cooperative launch per card a step, holding that card's ranks (all mp of
// them with virtual ranks on one card, one each on mp cards).  Its phases a
// layer: QKV; (#7 over an int8 cache: the cache write); the attention; OUT
// into the rank's raw f32 partial plane part_out; a barrier across ranks;
// reduce-OUT (5c's element with EPI_OUT, over every rank's part_out, into
// the rank's mid state); FFN1; FFN2 into part_ffn; a barrier across ranks;
// reduce-FFN2 (EPI_FFN2, into the hidden state).  7 phases a layer (8), a
// grid barrier after each but the last, 2 of them a layer across ranks.
// Every phase's items are its ranks' items concatenated rank-major, so at mp
// 2 on one card each phase spreads two ranks' tiles over the grid.
constexpr int STEP_PHASES_TP = 7;
constexpr int STEP_PHASES_TP_KVQ = 8;
// A wait for the other cards that sees no arrival for this long traps: a
// missing peer ends the run with an error, never hangs it.
constexpr unsigned long long CARD_WAIT_NS = 10000000000ull;

struct TpStepArgs {
  StepArgs s[MAX_MP];          // this launch's ranks (its card's), in rank order
  Partials out, ffn;           // every rank's part_out / part_ffn plane, in rank order
  // The step's card groups: each one's flag array (MAX_CARDS u64 on its card,
  // written by the other cards over peer pointers) and its slot in every
  // array (its card's index); a step on one card uses none.
  unsigned long long* flags[MAX_MP];
  int slot[MAX_MP];
  unsigned long long epoch;    // the value the step's first barrier across cards waits for
  unsigned long long* trace;   // phase timestamps (traced_barrier), or null
  int* error;                  // host-mapped: 1 where a wait across cards timed out
  int n_local, mp, n_cards, me;   // me: this launch's card group
};

__device__ __forceinline__ void st_release_sys(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire_sys(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// The wait across cards of the TP step's barrier across ranks number kc
// (after the grid barrier that ends the card's phase): one thread stores the
// barrier's epoch into this card's slot of every other card's flag array
// (a system-scope release, after the grid barrier: every block's partial is
// written), then spins with system-scope acquires on its own array until
// every other card's slot reaches the epoch, or traps after CARD_WAIT_NS.
// A grid barrier after it lets the other blocks read the peers' planes.
__device__ __forceinline__ void wait_cards(const TpStepArgs& p, int kc) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long want = p.epoch + kc;
    __threadfence_system();
    for (int c = 0; c < p.n_cards; ++c)
      if (c != p.me) st_release_sys(p.flags[c] + p.slot[p.me], want);
    const unsigned long long t0 = globaltimer();
    for (int c = 0; c < p.n_cards; ++c) {
      if (c == p.me) continue;
      while (ld_acquire_sys(p.flags[p.me] + p.slot[c]) < want) {
        if (globaltimer() - t0 > CARD_WAIT_NS) {
          atomicExch_system(p.error, 1);
          __threadfence_system();
          __trap();
        }
      }
    }
  }
}

// A reduce phase over the launch's ranks: element i of rank r's (rows *
// qblk, d) plane for every (r, i), spread over every thread of the grid.
template <typename T, int EPI>
__device__ __forceinline__ void run_reduce(const TpStepArgs& p, const Partials& src, int l) {
  const StepArgs& s0 = p.s[0];
  const long n = (long)s0.rows * s0.qblk * s0.d;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long t = (long)blockIdx.x * blockDim.x + threadIdx.x; t < p.n_local * n; t += stride) {
    const StepArgs& s = p.s[t / n];
    const long i = t % n;
    const int d = s.d;
    if constexpr (EPI == EPI_OUT)
      reduce_element<T, EPI_OUT>(src, p.mp, i, d, static_cast<const T*>(s.bout) + (size_t)l * d,
                                 static_cast<const T*>(l == 0 ? s.x : s.y), nullptr, s.xmid,
                                 nullptr);
    else
      reduce_element<T, EPI_FFN2>(src, p.mp, i, d, static_cast<const T*>(s.b2) + (size_t)l * d,
                                  nullptr, s.xmid, nullptr, static_cast<T*>(s.y));
  }
}

template <typename T, typename TC, int WF>
__global__ void __launch_bounds__(PNT, 1) step_tp_persistent_kernel(TpStepArgs p) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const StepArgs& s0 = p.s[0];
  const int nr = p.n_local, L = s0.L;
  const bool split = s0.chunk < s0.S;
  const int n_chunks = split ? s0.S / s0.chunk : 1;
  const bool kvq = QUANT && s0.qblk > 1;
  const int np = kvq ? STEP_PHASES_TP_KVQ : STEP_PHASES_TP;
  auto rank = [&](int r) -> const StepArgs& { return p.s[r]; };
  auto barrier = [&](int k) { traced_barrier(p.trace, L, k, np, [&] { grid.sync(); }); };
  int kc = 0;   // barriers across ranks passed
  auto rank_barrier = [&](int k) {
    traced_barrier(p.trace, L, k, np, [&] {
      grid.sync();
      if (p.n_cards > 1) {
        wait_cards(p, kc);
        grid.sync();
      }
    });
    ++kc;
  };
  if (p.trace && threadIdx.x == 0 && blockIdx.x == 0) p.trace[0] = globaltimer();
  for (int l = 0; l < L; ++l) {
    int k = np * l;
    run_proj<T, TC, QKV, WF>([&](int r) { return qkv_args<T, TC, WF>(p.s[r], l); }, nr, sm);
    barrier(k++);
    for (int r = 0; r < nr; ++r) prefetch_layer<T, WF>(p.s[r], l);
    if constexpr (QUANT) {
      if (kvq) {
        run_kv_quant_hd(rank, nr, l);
        barrier(k++);
      }
    }
    if (split)
      run_attention_hd<TC, true>(rank, nr, l, n_chunks, sm);
    else
      run_attention_hd<TC, false>(rank, nr, l, 1, sm);
    barrier(k++);
    run_proj<T, T, OUT, WF>(
        [&](int r) { return out_args_merged<T, WF>(p.s[r], l, n_chunks, p.s[r].part_out); }, nr,
        sm);
    rank_barrier(k++);
    run_reduce<T, EPI_OUT>(p, p.out, l);
    barrier(k++);
    run_proj<T, T, FFN1, WF>([&](int r) { return ffn1_args<T, WF>(p.s[r], l); }, nr, sm);
    barrier(k++);
    run_proj<T, T, FFN2, WF>([&](int r) { return ffn2_args<T, WF>(p.s[r], l, p.s[r].part_ffn); },
                             nr, sm);
    rank_barrier(k++);
    run_reduce<T, EPI_FFN2>(p, p.ffn, l);
    if (l + 1 < L || p.trace) barrier(k);
  }
}

template <typename T> struct Tag { using type = T; };
template <int V> using Int = std::integral_constant<int, V>;

// f(Tag<T>, Tag<TC>, Int<HD>, Int<WF>) for the formats' template arguments:
// T the compute dtype, TC the cache's, HD the head dim, WF the weight format.
template <typename T, typename TC, int WF, typename F>
int with_hd(int hd, F&& f) {
  switch (hd) {
    case 32: return f(Tag<T>{}, Tag<TC>{}, Int<32>{}, Int<WF>{});
    case 64: return f(Tag<T>{}, Tag<TC>{}, Int<64>{}, Int<WF>{});
    case 96: return f(Tag<T>{}, Tag<TC>{}, Int<96>{}, Int<WF>{});
    case 128: return f(Tag<T>{}, Tag<TC>{}, Int<128>{}, Int<WF>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TC, typename F>
int with_wf(int wfmt, int hd, F&& f) {
  switch (wfmt) {
    case DENSE: return with_hd<T, TC, DENSE>(hd, f);
    case W8: return with_hd<T, TC, W8>(hd, f);
    case W4: return with_hd<T, TC, W4>(hd, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_formats(int dtype, int cache_dtype, int wfmt, int hd, F&& f) {
  if (dtype == 0 && cache_dtype == 0) return with_wf<float, float>(wfmt, hd, f);
  if (dtype == 0 && cache_dtype == 1) return with_wf<float, __nv_bfloat16>(wfmt, hd, f);
  if (dtype == 0 && cache_dtype == 2) return with_wf<float, int8_t>(wfmt, hd, f);
  if (dtype == 1 && cache_dtype == 1) return with_wf<__nv_bfloat16, __nv_bfloat16>(wfmt, hd, f);
  if (dtype == 1 && cache_dtype == 2) return with_wf<__nv_bfloat16, int8_t>(wfmt, hd, f);
  return (int)cudaErrorInvalidValue;
}

bool bad_args(const StepArgs& s) {
  return s.groups_d < 1 || s.groups_att < 1 || s.groups_ff < 1 || s.qblk < 1 ||
         s.chunk < 1 || s.S % s.chunk || (s.chunk < s.S && s.part == nullptr) || s.h < 1 ||
         s.da % s.h;
}

struct DeviceRestore {        // puts the caller's current card back
  int dev = 0;
  DeviceRestore() { cudaGetDevice(&dev); }
  ~DeviceRestore() { cudaSetDevice(dev); }
};

// The TP launchers' rank arguments (one definition for the phased and the
// persistent step): ptrs holds TP_PTRS device pointers per rank, rank-major
// (x, y, the 11 weights, ck, cv, the 4 weight scales, ks, vs, tokens_lens,
// codes_lens, idx, qbuf, abuf, xmid, hmid, kvnew, part, then the rank's
// part_out and part_ffn planes).  verify = 1: index_or_qblk is qblk (idx
// required); else the scalar index (idx null) or 0.  Returns
// cudaErrorInvalidValue for arguments no TP step takes, else 0.
int tp_rank_args(int verify, int mp, void* const* ptrs, int L, int rows, int S, int d, int da,
                 int h, int dff, int index_or_qblk, int ttm, int pm, int groups_d,
                 int groups_att, int groups_ff, int chunk, float scale, StepArgs* s) {
  if (mp < 1 || mp > MAX_MP) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < mp; ++r) {
    void* const* P = ptrs + (size_t)r * TP_PTRS;
    StepArgs& a = s[r];
    a = StepArgs{};
    a.x = P[0], a.y = P[1], a.n1s = P[2], a.n1b = P[3], a.wqkv = P[4], a.wout = P[5];
    a.bout = P[6], a.n2s = P[7], a.n2b = P[8], a.w1 = P[9], a.b1 = P[10], a.w2 = P[11];
    a.b2 = P[12], a.ck = P[13], a.cv = P[14], a.sqkv = P[15], a.sout = P[16], a.s1 = P[17];
    a.s2 = P[18], a.ks = P[19], a.vs = P[20];
    a.tokens_lens = static_cast<const int*>(P[21]);
    a.codes_lens = static_cast<const int*>(P[22]);
    a.idx = static_cast<const int*>(P[23]);
    a.qbuf = static_cast<float*>(P[24]), a.abuf = static_cast<float*>(P[25]);
    a.xmid = static_cast<float*>(P[26]), a.hmid = static_cast<float*>(P[27]);
    a.kvnew = static_cast<float*>(P[28]), a.part = static_cast<float*>(P[29]);
    a.part_out = static_cast<float*>(P[30]), a.part_ffn = static_cast<float*>(P[31]);
    a.L = L, a.rows = rows, a.S = S, a.d = d, a.da = da, a.h = h, a.dff = dff;
    a.index = verify ? 0 : index_or_qblk, a.qblk = verify ? index_or_qblk : 1;
    a.ttm = ttm, a.pm = pm, a.groups_d = groups_d, a.groups_att = groups_att;
    a.groups_ff = groups_ff, a.chunk = chunk, a.scale = scale;
    if (bad_args(a) || a.part_out == nullptr || a.part_ffn == nullptr ||
        (verify && a.idx == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace
