// Fused AR decode step for Hopper (sm_90a), CUDA C++: one token through every
// layer of the transformer stack, over the head-major (L, rows, S, d) KV cache.
//
// Replaces the Pallas TPU kernel valle2_tpu/kernels/fused_decode.py
// (fused_decode_step -> _kernel), base variant: dense weights, a float32 or
// bfloat16 cache, one scalar write index for every row, no tensor parallelism.
//
// The TPU kernel carries the hidden state across a sequential (layer, chunk)
// grid; blocks of a GPU grid run in no order, so the step is five hand-written
// kernels per layer, launched in turn on one stream by one host call:
//
//   1. proj<QKV>:  LN1 -> fused QKV.  q (pre-scaled by 1/sqrt(hd), f32) goes to
//                  scratch; k_new / v_new are rounded to the cache dtype and
//                  written into cache slot `index` IN PLACE.  The TPU kernel
//                  never writes the cache: it merges the new token's k/v in
//                  register after the same rounding, so attending over the
//                  written slot gives the same numbers (the caller's cache
//                  update is then done, too).
//   2. attend:     one block per (row, head): online softmax in f32 over the
//                  valid slots only -- [0, tokens_len), [ttm, ttm + codes_len)
//                  and [ttm + pm, index] -- so masked slots are never read.
//   3. proj<OUT>:  out-projection + bias + residual -> f32 mid state.
//   4. proj<FFN1>: LN2 (of the f32 mid state) -> FFN1 + bias -> erf-GELU.
//   5. proj<FFN2>: FFN2 + bias + residual -> hidden state in the compute dtype.
//
// The rounding points are the Pallas kernel's: the hidden state is stored in
// the compute dtype between layers, LayerNorm statistics are f32, every matrix
// operand rounds to the compute dtype before its product and products
// accumulate in f32, the mid-layer residual stays f32.  GELU uses erff (the
// Pallas kernel's polynomial exists only because Mosaic lacks erf).
//
// What bounds it on this card: at rows = 12 a step streams the weights (about
// 1.5 MB per layer in bf16) and the valid cache prefix, and does far too little
// arithmetic to need the tensor cores, so the products are f32 FMAs on the CUDA
// cores; launch latency of the 5 * L kernels is the other cost.  With so few
// blocks in flight, memory latency bounds each kernel, so the loops issue
// their loads in batches: the projections read each weight once for up to 16
// rows (rows in registers, K split over 16 warps, 8 loads in flight per
// warp), and the attention loads 8 slots' k and v before using any.  A
// persistent kernel or a CUDA graph is later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace valle2;

constexpr int MAXR = 16;     // rows per projection block (held in registers)
constexpr int NCOL = 32;     // output columns per projection block (one per lane)
constexpr int KSPLIT = 16;   // warps per projection block, each a slice of K
constexpr int PNT = NCOL * KSPLIT;
constexpr int KUNR = 8;      // weight loads in flight per warp
constexpr int MAX_K = 3072;  // widest projection input: MAXR rows of it fill shared memory
constexpr int ANW = 8;       // warps per attention block
constexpr int UNR = 8;       // slots per warp iteration in the attention loop
constexpr float LN_EPS = 1e-5f;

enum Mode { QKV = 0, OUT = 1, FFN1 = 2, FFN2 = 3 };

template <typename T, typename TC>
struct ProjArgs {
  const T* x;          // (rows, d) hidden state entering the layer
  const float* a32;    // f32 operand: attention (OUT), mid state (FFN1), hidden (FFN2)
  const T* ln_s;       // LayerNorm scale/bias of this layer (QKV, FFN1)
  const T* ln_b;
  const T* w;          // (K, N) weight of this layer
  const T* bias;       // (N,) or null
  float* q;            // QKV: (rows, d) pre-scaled queries
  TC* ck;              // QKV: this layer's (rows, S, d) cache
  TC* cv;
  float* out32;        // OUT: (rows, d) mid state; FFN1: (rows, N) GELU output
  const float* res32;  // FFN2: (rows, d) mid state
  T* y;                // FFN2: (rows, d) hidden state leaving the layer
  int rows, K, N, d, S, index;
  float scale;
};

size_t proj_smem(int K) { return sizeof(float) * ((size_t)MAXR * K + KSPLIT * MAXR * NCOL); }

// out[r, j] = epilogue(sum_k A[r, k] W[k, j]) for a tile of MAXR rows x NCOL
// columns; the A operand (with its LayerNorm prologue) sits in shared memory,
// already rounded to the compute dtype.
template <typename T, typename TC, int MODE>
__global__ void __launch_bounds__(PNT) proj_kernel(ProjArgs<T, TC> a) {
  extern __shared__ float sm[];
  float* As = sm;                    // [MAXR][K]
  float* red = sm + MAXR * a.K;      // [KSPLIT][MAXR][NCOL]
  const int K = a.K, N = a.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.y * MAXR;
  const int nr = min(MAXR, a.rows - r0);

  if constexpr (MODE == QKV || MODE == FFN1) {
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
        dst[kk] = round_to<T>((dst[kk] - mean) * inv * to_f<T>(a.ln_s[kk]) +
                              to_f<T>(a.ln_b[kk]));
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < MAXR * K; i += PNT)
      As[i] = i < nr * K ? round_to<T>(a.a32[(size_t)r0 * K + i]) : 0.f;
  }
  __syncthreads();

  const int col = blockIdx.x * NCOL + lane;
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  const int kper = (K + KSPLIT - 1) / KSPLIT;
  const int k0 = warp * kper, k1 = min(K, k0 + kper);
  if (col < N) {
    // KUNR weight loads are issued before their FMAs, so each warp keeps that
    // many in flight instead of waiting out one load latency per k.
    int kk = k0;
    for (; kk + KUNR <= k1; kk += KUNR) {
      float wv[KUNR];
#pragma unroll
      for (int u = 0; u < KUNR; ++u) wv[u] = to_f<T>(a.w[(size_t)(kk + u) * N + col]);
#pragma unroll
      for (int u = 0; u < KUNR; ++u)
#pragma unroll
        for (int r = 0; r < MAXR; ++r) acc[r] = fmaf(As[r * K + kk + u], wv[u], acc[r]);
    }
    for (; kk < k1; ++kk) {
      const float wv = to_f<T>(a.w[(size_t)kk * N + col]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) acc[r] = fmaf(As[r * K + kk], wv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) red[(warp * MAXR + r) * NCOL + lane] = acc[r];
  __syncthreads();

  for (int i = tid; i < nr * NCOL; i += PNT) {
    const int r = i / NCOL, j = blockIdx.x * NCOL + i % NCOL;
    if (j >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < KSPLIT; ++w) s += red[(w * MAXR + r) * NCOL + i % NCOL];
    const int row = r0 + r, d = a.d;
    if constexpr (MODE == QKV) {
      if (j < d) {
        a.q[(size_t)row * d + j] = s * a.scale;
      } else {
        TC* cache = j < 2 * d ? a.ck : a.cv;
        cache[((size_t)row * a.S + a.index) * d + (j % d)] = from_f<TC>(s);
      }
    } else if constexpr (MODE == OUT) {
      a.out32[(size_t)row * d + j] = to_f<T>(a.x[(size_t)row * d + j]) +
                                     (s + to_f<T>(a.bias[j]));
    } else if constexpr (MODE == FFN1) {
      const float t = s + to_f<T>(a.bias[j]);
      a.out32[(size_t)row * N + j] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
    } else {
      a.y[(size_t)row * d + j] = from_f<T>(a.res32[(size_t)row * d + j] +
                                           (s + to_f<T>(a.bias[j])));
    }
  }
}

// One block per (row, head): softmax(q . k_s) v_s over the valid slots of the
// row, online in f32.  Each warp walks its own share of the slots UNR at a time
// (each lane holds HD/32 dims), then the warps' partial (max, sum, acc) merge.
template <typename TC, int HD>
__global__ void __launch_bounds__(ANW * 32)
attend_kernel(const float* __restrict__ q, const TC* __restrict__ ck,
              const TC* __restrict__ cv, const int* __restrict__ tokens_lens,
              const int* __restrict__ codes_lens, float* __restrict__ out, int h, int S,
              int d, int index, int ttm, int pm) {
  static_assert(HD % 32 == 0, "head dim must be a multiple of 32");
  constexpr int DPL = HD / 32;
  __shared__ float m_w[ANW], l_w[ANW], acc_w[ANW][HD];
  const int row = blockIdx.x / h, hh = blockIdx.x % h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dim0 = hh * HD + lane * DPL;
  const size_t row_base = (size_t)row * S * d;

  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] = q[(size_t)row * d + dim0 + i];
  // Valid slots: the three ranges of the Pallas kernel's attend formula, which
  // are disjoint because tokens_len <= ttm and codes_len <= pm.
  const int n1 = min(max(tokens_lens[row], 0), ttm);
  const int n2 = min(max(codes_lens[row], 0), pm);
  const int n_valid = n1 + n2 + (index - ttm - pm + 1);

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
      const int slot = j < n1 ? j : (j < n1 + n2 ? ttm + (j - n1) : ttm + pm + (j - n1 - n2));
      const size_t off = row_base + (size_t)slot * d + dim0;
      const bool in = j < n_valid;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kr[u][i] = in ? to_f<TC>(ck[off + i]) : 0.f;
        vr[u][i] = in ? to_f<TC>(cv[off + i]) : 0.f;
      }
    }
    float sc[UNR];
    float mloc = m;
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) part = fmaf(qv[i], kr[u][i], part);
      sc[u] = j0 + u < n_valid ? warp_sum(part) : -INFINITY;
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
  for (int i = 0; i < DPL; ++i) acc_w[warp][lane * DPL + i] = acc[i];
  __syncthreads();
  for (int e = threadIdx.x; e < HD; e += ANW * 32) {
    float mt = NEG_INF;
    for (int w = 0; w < ANW; ++w) mt = fmaxf(mt, m_w[w]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < ANW; ++w) {
      const float f = expf(m_w[w] - mt);
      lt += l_w[w] * f;
      at += acc_w[w][e] * f;
    }
    out[(size_t)row * d + hh * HD + e] = at / fmaxf(lt, 1e-30f);
  }
}

template <typename T, typename TC, int MODE>
int launch_proj(const ProjArgs<T, TC>& a, cudaStream_t stream) {
  if (a.K > MAX_K) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(proj_kernel<T, TC, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)proj_smem(MAX_K));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((a.N + NCOL - 1) / NCOL, (a.rows + MAXR - 1) / MAXR);
  proj_kernel<T, TC, MODE><<<grid, PNT, proj_smem(a.K), stream>>>(a);
  return (int)cudaGetLastError();
}

struct StepArgs {
  const void *x, *n1s, *n1b, *wqkv, *wout, *bout, *n2s, *n2b, *w1, *b1, *w2, *b2;
  void *y, *ck, *cv;
  const int *tokens_lens, *codes_lens;
  float *qbuf, *abuf, *xmid, *hmid;
  int L, rows, S, d, h, dff, index, ttm, pm;
  float scale;
};

template <typename T, typename TC, int HD>
int step(const StepArgs& s, cudaStream_t stream) {
  const int d = s.d, dff = s.dff;
  const size_t cache_layer = (size_t)s.rows * s.S * d;
  int err;
  for (int l = 0; l < s.L; ++l) {
    const T* x = l == 0 ? static_cast<const T*>(s.x) : static_cast<const T*>(s.y);
    TC* ck = static_cast<TC*>(s.ck) + l * cache_layer;
    TC* cv = static_cast<TC*>(s.cv) + l * cache_layer;
    ProjArgs<T, TC> a{};
    a.x = x;
    a.rows = s.rows;
    a.d = d;
    a.S = s.S;
    a.index = s.index;
    a.scale = s.scale;

    a.ln_s = static_cast<const T*>(s.n1s) + (size_t)l * d;
    a.ln_b = static_cast<const T*>(s.n1b) + (size_t)l * d;
    a.w = static_cast<const T*>(s.wqkv) + (size_t)l * d * 3 * d;
    a.K = d;
    a.N = 3 * d;
    a.q = s.qbuf;
    a.ck = ck;
    a.cv = cv;
    if ((err = launch_proj<T, TC, QKV>(a, stream))) return err;

    attend_kernel<TC, HD><<<s.rows * s.h, ANW * 32, 0, stream>>>(
        s.qbuf, ck, cv, s.tokens_lens, s.codes_lens, s.abuf, s.h, s.S, d, s.index, s.ttm,
        s.pm);
    if ((err = (int)cudaGetLastError())) return err;

    a.a32 = s.abuf;
    a.w = static_cast<const T*>(s.wout) + (size_t)l * d * d;
    a.bias = static_cast<const T*>(s.bout) + (size_t)l * d;
    a.N = d;
    a.out32 = s.xmid;
    if ((err = launch_proj<T, TC, OUT>(a, stream))) return err;

    a.a32 = s.xmid;
    a.ln_s = static_cast<const T*>(s.n2s) + (size_t)l * d;
    a.ln_b = static_cast<const T*>(s.n2b) + (size_t)l * d;
    a.w = static_cast<const T*>(s.w1) + (size_t)l * d * dff;
    a.bias = static_cast<const T*>(s.b1) + (size_t)l * dff;
    a.N = dff;
    a.out32 = s.hmid;
    if ((err = launch_proj<T, TC, FFN1>(a, stream))) return err;

    a.a32 = s.hmid;
    a.w = static_cast<const T*>(s.w2) + (size_t)l * dff * d;
    a.bias = static_cast<const T*>(s.b2) + (size_t)l * d;
    a.K = dff;
    a.N = d;
    a.res32 = s.xmid;
    a.y = static_cast<T*>(s.y);
    if ((err = launch_proj<T, TC, FFN2>(a, stream))) return err;
  }
  return 0;
}

template <typename T, typename TC>
int dispatch_hd(const StepArgs& s, cudaStream_t stream) {
  switch (s.d / s.h) {
    case 32: return step<T, TC, 32>(s, stream);
    case 64: return step<T, TC, 64>(s, stream);
    case 128: return step<T, TC, 128>(s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype / cache_dtype: 0 = float32, 1 = bfloat16 (bf16 compute needs a bf16
// cache).  Weights are the stacked (L, ...) tensors of the JAX layout: qkv
// (L, d, 3d), out (L, d, d), lin1 (L, d, dff), lin2 (L, dff, d); norms and
// biases (L, width).  Scratch: qbuf/abuf/xmid (rows, d) f32, hmid (rows, dff)
// f32.  Returns the first non-zero cudaGetLastError() of the 5 * L launches.
extern "C" int valle2_fused_decode_step(
    int dtype, int cache_dtype, const void* x, void* y, const void* n1s, const void* n1b,
    const void* wqkv, const void* wout, const void* bout, const void* n2s,
    const void* n2b, const void* w1, const void* b1, const void* w2, const void* b2,
    void* ck, void* cv, const int* tokens_lens, const int* codes_lens, float* qbuf,
    float* abuf, float* xmid, float* hmid, int L, int rows, int S, int d, int h, int dff,
    int index, int ttm, int pm, float scale, void* stream) {
  StepArgs s{x, n1s, n1b, wqkv, wout, bout, n2s, n2b, w1, b1, w2, b2, y, ck, cv,
             tokens_lens, codes_lens, qbuf, abuf, xmid, hmid, L, rows, S, d, h, dff,
             index, ttm, pm, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && cache_dtype == 0) return dispatch_hd<float, float>(s, st);
  if (dtype == 0 && cache_dtype == 1) return dispatch_hd<float, __nv_bfloat16>(s, st);
  if (dtype == 1 && cache_dtype == 1) return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(s, st);
  return (int)cudaErrorInvalidValue;
}
