// Fused AR decode step (#6) and speculative verify step (#7) for Hopper
// (sm_90a), CUDA C++: one token (decode) or a block of K tokens per row
// (verify) through every layer of the transformer stack, over the head-major
// (L, rows, S, d) KV cache.
//
// Replaces the Pallas TPU kernels of valle2_tpu/kernels/fused_decode.py:
//   fused_decode_step -> _kernel (#6): one write index for every row, or a
//                        (rows,) vector of per-row indices (the per-row
//                        branch: meta[1 + 2*rows + r], the attention's own
//                        row slot, the write of _write_rows_per_slot), rows
//                        at their own depths under continuous batching;
//   fused_verify_step -> _verify_kernel (#7): K query tokens per row written
//                        from each row's own start slot (the per-row write of
//                        _write_rows_per_slot), in-block causal attention;
//   both with the chunked cache (pick_chunk/chunk_for, the online softmax over
//   chunks of _kernel and _verify_kernel, the clamped chunk index map);
// in the serving path's formats:
//   weights  dense (#6); int8 W8A8 (_q8_dot) and int4 W4A16 (_q4_dot) (#6a);
//   cache    float32 or bfloat16 (#6); int8 with per-(slot, head) bfloat16
//            scales (#6a: quantize_kv_rowmajor, _fake_quant_row, the dequant);
// and both under tensor parallelism (their `tp` argument, with 5c below).
// The formats are template parameters of the same kernels, and #7 is the same
// launcher as #6 with rows * K query rows and a device pointer to the per-row
// start slots: the projections, the cache write and the FFN take every query
// row alike; only the attention kernel differs.  #6 with a per-row index is
// #6 with that pointer (a block of one token): every block of the attention
// cuts its ranges to its own row's slot, so no row walks past its own depth
// (the TPU kernel clamps its chunk walk at the deepest row, max(index)).
//
// The TPU kernel carries the hidden state across a sequential (layer, chunk)
// grid; blocks of a GPU grid run in no order, so the step is five hand-written
// kernels per layer (six with an int8 cache, one more with a chunked cache),
// launched in turn on one stream by one host call:
//
//   1. proj<QKV>:  LN1 -> fused QKV.  q (pre-scaled by 1/sqrt(hd), f32) goes to
//                  scratch; k_new / v_new are rounded to the cache dtype and
//                  written into the cache IN PLACE: query row (r, i) at slot
//                  index_r + i (decode: index + 0).  The TPU kernels never
//                  write the cache: they merge the new tokens' k/v in register
//                  after the same rounding, so attending over the written
//                  slots gives the same numbers (the caller's cache update is
//                  then done, too).  A write at a slot >= S is skipped, where
//                  JAX's dynamic_update_slice would clamp the block's start
//                  and overwrite earlier slots; the callers keep K slots of
//                  slack so neither happens.  With an int8 cache k_new / v_new
//                  go, rounded to the compute dtype, to an f32 scratch instead:
//   1b. kv_quant:  one warp per (query row, head, k|v), because a head spans
//                  hd/32 projection column blocks: scale32 = max(amax, 1e-8) /
//                  127, codes clamp(rint(x / scale32), +-127) into the query
//                  row's slot, and bf16(scale32) into the scale tensor.
//                  Attention then reads the slot back like any other, which is
//                  _fake_quant_row's round trip (quantize with the f32 scale,
//                  dequantize with the stored bf16 one).
//   2. attend:     one block per (query row, head): online softmax in f32
//                  over the valid slots only -- query i of row r sees [0,
//                  tl_r), [ttm, ttm + pl_r) and [ttm + pm, index_r + i] --
//                  so masked slots are never read.  The block's own k/v are
//                  in the cache already, so the in-block causal mask is the
//                  end of that range, and a decode token is query 0 of a
//                  block of one: #6 and #7 share the kernel.  An int8 slot is
//                  code * f32(bf16 scale).
//   2'. attend split + merge, when the cache is chunked (chunk < S): the TPU
//                  kernel walks the chunks in turn, carrying the online
//                  softmax in scratch, and its clamped index map stops the
//                  reads at the last occupied chunk.  Here blocks run in no
//                  order, so the chunk is a grid axis: one block per (query
//                  row, head, chunk) walks the valid slots of its chunk (the
//                  three ranges cut to it) and writes a partial (max, sum,
//                  acc[hd]) in f32; a chunk past the query's own slot reads
//                  nothing and writes the empty partial.  A second kernel per
//                  (query row, head) merges the partials in chunk order.  At
//                  one row and 4 heads (a stream) that is 4 * S / chunk
//                  blocks a layer instead of 4: the split is the latency
//                  cure the few blocks of a small batch need.
//   3. proj<OUT>:  out-projection + bias + residual -> f32 mid state.
//   4. proj<FFN1>: LN2 (of the f32 mid state) -> FFN1 + bias -> erf-GELU.
//   5. proj<FFN2>: FFN2 + bias + residual -> hidden state in the compute dtype.
//
// The rounding points are the Pallas kernel's: the hidden state is stored in
// the compute dtype between layers, LayerNorm statistics are f32, the
// mid-layer residual stays f32, GELU uses erff (the Pallas kernel's polynomial
// exists only because Mosaic lacks erf).  Per weight format, the A operand of
// a projection (the LN output, the attention output, the GELU output) is
//   dense, int4: rounded to the compute dtype; products accumulate in f32.
//                int4 weights are (nibble * group scale) in f32 rounded to the
//                compute dtype; byte k of the packed (K/2, N) weight holds
//                row k in its low nibble and row k + K/2 in its high one.
//   int8:        kept in f32 and quantized per row, sx = max(amax, 1e-8) / 127,
//                codes clamp(rint(x / sx), +-127) (rint: half to even, as
//                jnp.round; true division, no fast math); int8 x int8 products
//                accumulate exactly in int32 (__dp4a), and y = acc * sx *
//                scale[col] in f32.
//
// Tensor parallelism (valle2_fused_step_tp; 5c replaces _ring_allreduce,
// fused_decode.py:252-295, and the reduce sites of _kernel :480-490 and
// _verify_kernel :786-792).  Rank r holds the Megatron split of the stack
// (its h local heads, a (L, rows, S, da) cache with da = d / mp, its share of
// dff; the hidden state stays d wide), and the OUT and FFN2 projections write
// raw f32 partial sums instead of their epilogues.  5c, tp_allreduce_kernel,
// then gives every rank the sum over ranks s = 0..mp-1 in rank order,
// ((0 + p_0) + p_1) + ..., so every rank holds the same bits, with the bias
// added once after the sum and then the residual (the one-rank epilogues,
// moved after the sum).  Each rank's 5c reads the mp partials directly: its
// own locally, its peers' over NVLink through peer pointers (the launcher
// enables peer access; a pair without it is refused, never worked around).
// On an NVSwitch H100 host every peer is one hop away, so no ring is needed;
// the ring was the TPU torus's answer.  This departs from the usual mapping
// of in-kernel remote copies to NCCL collectives outside the kernel, for
// three reasons: NCCL refuses two ranks on one GPU (virtual ranks, how one
// card checks the protocol); one process keeps ValleTTS(mesh=) a single
// object, as under JAX's single controller; and a peer read needs no staging.
//
// The ordering protocol (one host thread, CUDA events; rank r's kernels run
// on its own stream, virtual ranks on one card included): the TP step first
// makes every rank's stream wait for every caller stream's queued work; then
// per layer, each rank queues its attention phase, ending in its OUT partial
// into its plane part_out; a barrier (each rank records its event, each rank's
// stream waits for every rank's event); each rank's 5c over the mp part_out
// planes into its f32 mid state, and its FFN phase, ending in its FFN2
// partial into its plane part_ffn; a barrier; each rank's 5c over the part_ffn
// planes into its hidden state.  Two planes suffice: rank r writes part_out
// again only in the next layer, after the FFN barrier, which every rank
// reaches only after its 5c has read the part_out planes (and part_ffn after
// the next layer's OUT barrier, likewise).  At the end every caller stream
// waits for every rank's last event, so no partial is freed, or reused by
// PyTorch's allocator, while a peer still reads it.  A TP launch holds one
// lock (the event pool: one event per (card, rank)).  5c alone
// (valle2_tp_allreduce) serves the prefill's and the NAR's row-parallel
// sums on the callers' streams, between the same two barriers.  What bounds
// 5c: each rank reads mp partials of rows * d f32 and writes one, a few KB at
// the serving shape, so its time is launch and synchronisation latency.
//
// What bounds it on this card: at 12 query rows a step streams the weights
// (about 1.5 MB per layer in bf16, half that in int8, a quarter in int4) and
// the valid cache prefix (half the bytes in int8), and does far too little
// arithmetic to need the tensor cores, so the products run on the CUDA cores
// (f32 FMAs; __dp4a for int8); launch latency of the 5-6 * L kernels is the
// other cost.  With so few blocks in flight, memory latency bounds each
// kernel, so the loops issue their loads in batches: the projections read
// each weight once for a tile of up to 16 rows (rows in registers, K split
// over 16 warps, 8 loads in flight per warp), and the attention loads 8
// slots' k and v before using any.  A verify block's K queries read their
// row's slots K times, from L2 after the first: a block per (row, head, 8
// queries) that staged each 32-slot tile once in shared memory for all its
// queries, one warp per query, took 0.067 ms a layer at 3 rows x K = 4 on an
// H100 (torch.profiler), where the decode step's attention at 12 rows took
// 0.014: its 12 blocks each walked every slot in turn.  The
// tile's rows of the A operand sit in shared memory, so a projection input
// wider than 3072 (2048 under W8A8, whose int8 codes sit beside it) takes a
// tile of 8 rows, up to 6144 (5120): more than 8 query rows then read each
// weight once per 8-row tile.  A persistent kernel, tensor-core products or a
// CUDA graph is later work.

#include <math.h>
#include <stdint.h>

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
constexpr int ANW = 8;       // warps per attention block
constexpr int UNR = 8;       // slots per warp iteration in the attention loop
constexpr int KVQ_WARPS = 4; // warps per block of the int8 cache write
constexpr float LN_EPS = 1e-5f;

enum Mode { QKV = 0, OUT = 1, FFN1 = 2, FFN2 = 3 };
enum WFmt { DENSE = 0, W8 = 1, W4 = 2 };

// Widest projection input of a tile of 16 and of 8 rows: the rows (f32, and
// int8 codes for W8) and the reduction scratch fill the 227 KB of shared
// memory a block can opt into.
constexpr int max_k16(int wf) { return wf == W8 ? 2048 : 3072; }
constexpr int max_k8(int wf) { return wf == W8 ? 5120 : 6144; }

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
  int rows, K, N, d, S, index, group, qblk;   // rows: query rows; qblk per cache row;
  float scale;                                // d: the attention (cache) width
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

// out[r, j] = epilogue(sum_k A[r, k] W[k, j]) for a tile of MAXR rows x NCOL
// columns; the A operand (with its LayerNorm prologue) sits in shared memory,
// rounded to the compute dtype, or quantized to int8 codes for W8.
template <typename T, typename TC, int MODE, int WF, int MAXR>
__global__ void __launch_bounds__(PNT) proj_kernel(ProjArgs<T> a) {
  extern __shared__ __align__(16) float sm[];
  float* As = sm;                    // [MAXR][K]
  float* red = sm + MAXR * a.K;      // [KSPLIT][MAXR][NCOL]
  float* sxs = red + KSPLIT * MAXR * NCOL;                 // W8: [MAXR] row scales
  int8_t* Aq = reinterpret_cast<int8_t*>(sxs + MAXR);      // W8: [MAXR][K] codes
  const int K = a.K, N = a.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.y * MAXR;
  const int nr = min(MAXR, a.rows - r0);
  // W8 quantizes the f32 operand; the other formats round it to T first.
  auto operand = [](float v) { return WF == W8 ? v : round_to<T>(v); };

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
        dst[kk] = operand((dst[kk] - mean) * inv * to_f<T>(a.ln_s[kk]) +
                          to_f<T>(a.ln_b[kk]));
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

  const int col = blockIdx.x * NCOL + lane;
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
        const int n4 = min(KUNR, k1 - kk) / 4;   // 2, or 1 at a slice's tail
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
    const int r = i / NCOL, j = blockIdx.x * NCOL + i % NCOL;
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

// int8 cache write of the new tokens (quantize_kv_rowmajor): one warp per
// (query row, head, k|v) of the (rows, 2d) f32 scratch, into the query row's
// slot (query_slot).
template <int HD>
__global__ void __launch_bounds__(KVQ_WARPS * 32)
kv_quant_kernel(const float* __restrict__ kvnew, int8_t* __restrict__ ck,
                int8_t* __restrict__ cv, __nv_bfloat16* __restrict__ ks,
                __nv_bfloat16* __restrict__ vs, const int* __restrict__ idx, int rows, int h,
                int S, int d, int index, int qblk) {
  constexpr int DPL = HD / 32;
  const int wid = blockIdx.x * KVQ_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= rows * 2 * h) return;
  const int row = wid / (2 * h), kv = wid / h % 2, hh = wid % h;
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

// One block per (query row, head), or per (query row, head, chunk) when the
// cache is split (SPLIT): softmax(q . k_s) v_s over the valid slots of the
// query's cache row (of its chunk), online in f32.  Each warp walks its own
// share of the slots UNR at a time (each lane holds HD/32 dims), then the
// warps' partial (max, sum, acc) merge.  An int8 cache (TC = int8_t)
// dequantizes each slot by its head's bf16 scale.  Unsplit, the block writes
// the normalized output; split, it writes its chunk's partial (max, sum,
// unnormalized acc) to `part`, and merge_kernel combines a query's chunks.  A
// chunk with no valid slot (past the query's own slot, or in the padding
// between the ranges) writes the empty partial (NEG_INF, 0, 0).
template <typename TC, int HD, bool SPLIT>
__global__ void __launch_bounds__(ANW * 32)
attend_kernel(const float* __restrict__ q, const TC* __restrict__ ck,
              const TC* __restrict__ cv, const __nv_bfloat16* __restrict__ ks,
              const __nv_bfloat16* __restrict__ vs, const int* __restrict__ tokens_lens,
              const int* __restrict__ codes_lens, const int* __restrict__ idx,
              float* __restrict__ out, float* __restrict__ part, int h, int S, int d,
              int index, int qblk, int ttm, int pm, int chunk) {
  static_assert(HD % 32 == 0, "head dim must be a multiple of 32");
  constexpr int DPL = HD / 32;
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  __shared__ float m_w[ANW], l_w[ANW], acc_w[ANW][HD];
  const int rq = blockIdx.x / h, hh = blockIdx.x % h;   // query row, head
  const int row = rq / qblk;                            // its cache row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dim0 = hh * HD + lane * DPL;
  const size_t row_base = (size_t)row * S * d;

  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) qv[i] = q[(size_t)rq * d + dim0 + i];
  // Valid slots: the three ranges of the Pallas kernel's attend formula, which
  // are disjoint because tokens_len <= ttm and codes_len <= pm; the generated
  // range ends at the query's own slot (past S: at S - 1).  Split, each range
  // is cut to this block's chunk [lo, hi).
  const int lo = SPLIT ? blockIdx.y * chunk : 0, hi = SPLIT ? min(lo + chunk, S) : S;
  const int last = min(query_slot(idx, index, qblk, rq), S - 1);
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
  // A warp with no slot holds (NEG_INF, 0, 0): exp(NEG_INF - mt) is 0 beside a
  // warp that had slots, and 1 (times zeros) when none had.
  float* rec = SPLIT ? part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * (HD + 2)
                     : nullptr;
  for (int e = threadIdx.x; e < HD; e += ANW * 32) {
    float mt = NEG_INF;
    for (int w = 0; w < ANW; ++w) mt = fmaxf(mt, m_w[w]);
    float lt = 0.f, at = 0.f;
    for (int w = 0; w < ANW; ++w) {
      const float f = expf(m_w[w] - mt);
      lt += l_w[w] * f;
      at += acc_w[w][e] * f;
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
}

// The second pass of the split attention: one block per (query row, head)
// combines its n_chunks partials in chunk order, rescaled to their common
// max, and writes the normalized output.  Empty partials (NEG_INF, 0, 0) add
// nothing; every query has at least its own slot, so the sum is positive.
template <int HD>
__global__ void __launch_bounds__(HD)
merge_kernel(const float* __restrict__ part, float* __restrict__ out, int h, int d,
             int n_chunks) {
  const int rq = blockIdx.x / h, hh = blockIdx.x % h, e = threadIdx.x;
  const float* rec = part + (size_t)blockIdx.x * n_chunks * (HD + 2);
  float mt = NEG_INF;
  for (int c = 0; c < n_chunks; ++c) mt = fmaxf(mt, rec[c * (HD + 2)]);
  float lt = 0.f, at = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const float f = expf(rec[c * (HD + 2)] - mt);
    lt += rec[c * (HD + 2) + 1] * f;
    at += rec[c * (HD + 2) + 2 + e] * f;
  }
  out[(size_t)rq * d + hh * HD + e] = at / fmaxf(lt, 1e-30f);
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
};

// The weight of layer l of a stacked (L, K, N) weight in format WF.
template <typename T, int WF>
const void* layer_weight(const void* w, int l, int K, int N) {
  const size_t n = (size_t)K * N;
  if (WF == DENSE) return static_cast<const T*>(w) + l * n;
  return static_cast<const int8_t*>(w) + l * (WF == W4 ? n / 2 : n);
}

// This layer's scales of a stacked (L, K, N) weight: (L, N) or (L, groups, N).
template <typename T, int WF>
const T* layer_scale(const void* s, int l, int N, int groups) {
  if (WF == DENSE) return nullptr;
  return static_cast<const T*>(s) + (size_t)l * (WF == W4 ? groups : 1) * N;
}

// The projection arguments every phase of layer l shares.
template <typename T>
ProjArgs<T> layer_args(const StepArgs& s, int l) {
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

// Layer l up to the out-projection: LN1 + QKV (+ the int8 cache write), the
// attention, and the out-projection, fused with its bias and residual into
// the f32 mid state, or under TP (`partial`) its raw partial sum.
template <typename T, typename TC, int HD, int WF>
int attn_phase(const StepArgs& s, int l, float* partial, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<TC, int8_t>::value;
  const int d = s.d, da = s.da;
  const int rows_q = s.rows * s.qblk;
  const size_t cache_layer = (size_t)s.rows * s.S * da;
  const size_t scale_layer = (size_t)s.rows * s.S * s.h;
  TC* ck = static_cast<TC*>(s.ck) + l * cache_layer;
  TC* cv = static_cast<TC*>(s.cv) + l * cache_layer;
  __nv_bfloat16* ks = QUANT ? static_cast<__nv_bfloat16*>(s.ks) + l * scale_layer : nullptr;
  __nv_bfloat16* vs = QUANT ? static_cast<__nv_bfloat16*>(s.vs) + l * scale_layer : nullptr;
  ProjArgs<T> a = layer_args<T>(s, l);
  int err;
  a.ln_s = static_cast<const T*>(s.n1s) + (size_t)l * d;
  a.ln_b = static_cast<const T*>(s.n1b) + (size_t)l * d;
  a.w = layer_weight<T, WF>(s.wqkv, l, d, 3 * da);
  a.wscale = layer_scale<T, WF>(s.sqkv, l, 3 * da, s.groups_d);
  a.group = d / s.groups_d;
  a.K = d;
  a.N = 3 * da;
  a.q = s.qbuf;
  a.ck = QUANT ? static_cast<void*>(s.kvnew) : static_cast<void*>(ck);
  a.cv = cv;
  if ((err = launch_proj<T, TC, QKV, WF>(a, stream))) return err;
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

  a.a32 = s.abuf;
  a.w = layer_weight<T, WF>(s.wout, l, da, d);
  a.wscale = layer_scale<T, WF>(s.sout, l, d, s.groups_att);
  a.group = da / s.groups_att;
  a.bias = static_cast<const T*>(s.bout) + (size_t)l * d;
  a.K = da;
  a.N = d;
  a.out32 = s.xmid;
  a.partial = partial;
  return launch_proj<T, T, OUT, WF>(a, stream);
}

// The rest of layer l: LN2 (of the f32 mid state) + FFN1 + GELU, and FFN2,
// fused with its bias and residual into the hidden state, or under TP
// (`partial`) its raw partial sum.
template <typename T, typename TC, int HD, int WF>
int ffn_phase(const StepArgs& s, int l, float* partial, cudaStream_t stream) {
  const int d = s.d, dff = s.dff;
  ProjArgs<T> a = layer_args<T>(s, l);
  int err;
  a.a32 = s.xmid;
  a.ln_s = static_cast<const T*>(s.n2s) + (size_t)l * d;
  a.ln_b = static_cast<const T*>(s.n2b) + (size_t)l * d;
  a.w = layer_weight<T, WF>(s.w1, l, d, dff);
  a.wscale = layer_scale<T, WF>(s.s1, l, dff, s.groups_d);
  a.group = d / s.groups_d;
  a.bias = static_cast<const T*>(s.b1) + (size_t)l * dff;
  a.K = d;
  a.N = dff;
  a.out32 = s.hmid;
  if ((err = launch_proj<T, T, FFN1, WF>(a, stream))) return err;

  a.a32 = s.hmid;
  a.w = layer_weight<T, WF>(s.w2, l, dff, d);
  a.wscale = layer_scale<T, WF>(s.s2, l, d, s.groups_ff);
  a.group = dff / s.groups_ff;
  a.bias = static_cast<const T*>(s.b2) + (size_t)l * d;
  a.K = dff;
  a.N = d;
  a.res32 = s.xmid;
  a.y = static_cast<T*>(s.y);
  a.partial = partial;
  return launch_proj<T, T, FFN2, WF>(a, stream);
}

template <typename T, typename TC, int HD, int WF>
int step(const StepArgs& s, cudaStream_t stream) {
  int err;
  for (int l = 0; l < s.L; ++l) {
    if ((err = attn_phase<T, TC, HD, WF>(s, l, nullptr, stream))) return err;
    if ((err = ffn_phase<T, TC, HD, WF>(s, l, nullptr, stream))) return err;
  }
  return 0;
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

int dispatch(int dtype, int cache_dtype, int wfmt, const StepArgs& s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(s)) return (int)cudaErrorInvalidValue;
  return with_formats(dtype, cache_dtype, wfmt, s.da / s.h,
                      [&](auto t, auto tc, auto hd, auto wf) {
    return step<typename decltype(t)::type, typename decltype(tc)::type, decltype(hd)::value,
                decltype(wf)::value>(s, st);
  });
}

// ---- Tensor parallelism: 5c and the TP step ----

constexpr int MAX_MP = 8;      // ranks of one launch
constexpr int MAX_CARDS = 32;  // cards of the event pool
constexpr int RED_THREADS = 256;
constexpr int TP_PTRS = 32;    // device pointers per rank of valle2_fused_step_tp

enum Epilogue { EPI_SUM = 0, EPI_OUT = 1, EPI_FFN2 = 2 };

struct Partials {
  const float* p[MAX_MP];      // rank r's partial: local, or a peer's over NVLink
};

// 5c: out[i] = sum over ranks in rank order of partial_r[i], f32, the same
// bits on every rank.  EPI_SUM writes the sum (f32); EPI_OUT the f32 mid
// state x + (sum + bias) (x the layer's input, compute dtype); EPI_FFN2 the
// hidden state res32 + (sum + bias) in the compute dtype (the one-rank OUT and
// FFN2 epilogues, after the sum).
template <typename T, int EPI>
__global__ void __launch_bounds__(RED_THREADS)
tp_allreduce_kernel(Partials src, int mp, long n, int d, const T* __restrict__ bias,
                    const T* __restrict__ x, const float* __restrict__ res32,
                    float* __restrict__ out32, T* __restrict__ y) {
  for (long i = blockIdx.x * (long)RED_THREADS + threadIdx.x; i < n;
       i += (long)gridDim.x * RED_THREADS) {
    float s = 0.f;
    for (int r = 0; r < mp; ++r) s += src.p[r][i];
    if constexpr (EPI == EPI_SUM) {
      out32[i] = s;
    } else if constexpr (EPI == EPI_OUT) {
      out32[i] = to_f<T>(x[i]) + (s + to_f<T>(bias[i % d]));
    } else {
      y[i] = from_f<T>(res32[i] + (s + to_f<T>(bias[i % d])));
    }
  }
}

template <typename T, int EPI>
int launch_reduce(const Partials& src, int mp, long n, int d, const T* bias, const T* x,
                  const float* res32, float* out32, T* y, cudaStream_t stream) {
  const int blocks = (int)std::min<long>((n + RED_THREADS - 1) / RED_THREADS, 1024);
  tp_allreduce_kernel<T, EPI><<<blocks, RED_THREADS, 0, stream>>>(src, mp, n, d, bias, x,
                                                                  res32, out32, y);
  return (int)cudaGetLastError();
}

// The single host thread orders the ranks with one event per rank (made at
// first use, per card), under one lock: a TP launch at a time.
std::mutex tp_mutex;
cudaEvent_t tp_events[MAX_CARDS][MAX_MP];

struct DeviceRestore {        // puts the caller's current card back
  int dev = 0;
  DeviceRestore() { cudaGetDevice(&dev); }
  ~DeviceRestore() { cudaSetDevice(dev); }
};

struct Ranks {
  int mp;
  int card[MAX_MP];
  cudaStream_t stream[MAX_MP];   // where rank r's kernels run
  cudaEvent_t ev[MAX_MP];

  int init(int n, const int* cards, void* const* streams) {
    mp = n;
    if (mp < 1 || mp > MAX_MP) return (int)cudaErrorInvalidValue;
    for (int r = 0; r < mp; ++r) {
      card[r] = cards[r];
      stream[r] = static_cast<cudaStream_t>(streams[r]);
      if (card[r] < 0 || card[r] >= MAX_CARDS) return (int)cudaErrorInvalidDevice;
      cudaEvent_t& e = tp_events[card[r]][r];
      if (e == nullptr) {
        cudaError_t err = cudaSetDevice(card[r]);
        if (err == cudaSuccess) err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
        if (err != cudaSuccess) return (int)err;
      }
      ev[r] = e;
    }
    return 0;
  }

  // Every stream in `waiters` waits for all the work queued so far on every
  // rank's `from` stream.
  int barrier(cudaStream_t const* from, cudaStream_t const* waiters) {
    cudaError_t err;
    for (int r = 0; r < mp; ++r) {
      if ((err = cudaSetDevice(card[r])) || (err = cudaEventRecord(ev[r], from[r])))
        return (int)err;
    }
    for (int r = 0; r < mp; ++r) {
      if ((err = cudaSetDevice(card[r]))) return (int)err;
      for (int q = 0; q < mp; ++q)
        if ((err = cudaStreamWaitEvent(waiters[r], ev[q], 0))) return (int)err;
    }
    return 0;
  }
};

// The TP step: layer by layer, every rank's attention phase (its partial of
// the out-projection into its plane part_out), a barrier, every rank's 5c over
// the mp part_out planes into its mid state, every rank's FFN phase (its FFN2
// partial into part_ffn), a barrier, every rank's 5c into its hidden state.
template <typename T, typename TC, int HD, int WF>
int step_tp(Ranks& k, const StepArgs* s, cudaStream_t const* caller) {
  const long n = (long)s[0].rows * s[0].qblk * s[0].d;
  const int d = s[0].d;
  Partials out_p{}, ffn_p{};
  for (int r = 0; r < k.mp; ++r) {
    out_p.p[r] = s[r].part_out;
    ffn_p.p[r] = s[r].part_ffn;
  }
  int err;
  if ((err = k.barrier(caller, k.stream))) return err;          // fork
  for (int l = 0; l < s[0].L; ++l) {
    for (int r = 0; r < k.mp; ++r) {
      cudaSetDevice(k.card[r]);
      if ((err = attn_phase<T, TC, HD, WF>(s[r], l, s[r].part_out, k.stream[r]))) return err;
    }
    if ((err = k.barrier(k.stream, k.stream))) return err;
    for (int r = 0; r < k.mp; ++r) {
      cudaSetDevice(k.card[r]);
      const T* x = static_cast<const T*>(l == 0 ? s[r].x : s[r].y);
      if ((err = launch_reduce<T, EPI_OUT>(out_p, k.mp, n, d,
                                           static_cast<const T*>(s[r].bout) + (size_t)l * d,
                                           x, nullptr, s[r].xmid, nullptr, k.stream[r])))
        return err;
      if ((err = ffn_phase<T, TC, HD, WF>(s[r], l, s[r].part_ffn, k.stream[r]))) return err;
    }
    if ((err = k.barrier(k.stream, k.stream))) return err;
    for (int r = 0; r < k.mp; ++r) {
      cudaSetDevice(k.card[r]);
      if ((err = launch_reduce<T, EPI_FFN2>(ffn_p, k.mp, n, d,
                                            static_cast<const T*>(s[r].b2) + (size_t)l * d,
                                            nullptr, s[r].xmid, nullptr,
                                            static_cast<T*>(s[r].y), k.stream[r])))
        return err;
    }
  }
  return k.barrier(k.stream, caller);                            // join
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cache_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (bf16 compute needs a bf16 or int8 cache); wfmt: 0 = dense, 1 =
// int8 W8A8, 2 = int4 W4A16.  Weights are the stacked (L, ...) tensors of the
// JAX layout: qkv (L, d, 3d), out (L, d, d), lin1 (L, d, dff), lin2 (L, dff,
// d), int8 in formats 1 and 2 (packed (L, K/2, N) in 2); norms and biases (L,
// width).  Weight scales (compute dtype): (L, N) in format 1, (L, groups, N)
// in format 2 with groups_d / groups_ff groups over the d- / dff-wide inputs;
// null in format 0.  An int8 cache has (L, rows, S, h) bf16 scales ks / vs.
// Scratch, per query row (rows for the decode step, rows * qblk for the
// verify step): qbuf/abuf/xmid (., d) f32, hmid (., dff) f32, kvnew (., 2d)
// f32 (int8 cache only), and with chunk < S (S a multiple of chunk) part
// (., h, S / chunk, hd + 2) f32, the chunks' partial softmaxes; chunk == S
// takes the one-block-per-(query row, head) attention.  Returns the first
// non-zero cudaGetLastError() of the launches.

// #6: one token per row, x and y (rows, d).  Row r's token sits at slot
// idx[r] (a device pointer, never read by the host: the per-row index of
// continuous batching, rows at their own depths) or, with idx null, at the
// scalar `index` for every row.  A row at slot S (a frozen row that reached
// its budget) skips its write, where JAX's dynamic_update_slice clamps it to
// S - 1, and attends up to S - 1: only that row reads those slots, and its
// output is discarded.
extern "C" int valle2_fused_decode_step(
    int dtype, int cache_dtype, int wfmt, const void* x, void* y, const void* n1s,
    const void* n1b, const void* wqkv, const void* wout, const void* bout, const void* n2s,
    const void* n2b, const void* w1, const void* b1, const void* w2, const void* b2,
    void* ck, void* cv, const void* sqkv, const void* sout, const void* s1, const void* s2,
    void* ks, void* vs, const int* tokens_lens, const int* codes_lens, const int* idx,
    float* qbuf, float* abuf, float* xmid, float* hmid, float* kvnew, float* part, int L,
    int rows, int S, int d, int h, int dff, int index, int ttm, int pm, int groups_d,
    int groups_ff, int chunk, float scale, void* stream) {
  StepArgs s{x, n1s, n1b, wqkv, wout, bout, n2s, n2b, w1, b1, w2, b2, y, ck, cv, sqkv,
             sout, s1, s2, ks, vs, tokens_lens, codes_lens, idx, qbuf, abuf, xmid,
             hmid, kvnew, part, nullptr, nullptr, L, rows, S, d, d, h, dff, index, 1, ttm,
             pm, groups_d, groups_d, groups_ff, chunk, scale};
  return dispatch(dtype, cache_dtype, wfmt, s, stream);
}

// #7: qblk tokens per row, x and y (rows, qblk, d); row r's block is written
// at slots idx[r] .. idx[r] + qblk - 1 (a device pointer, never read by the
// host), each slot >= S skipped.
extern "C" int valle2_fused_verify_step(
    int dtype, int cache_dtype, int wfmt, const void* x, void* y, const void* n1s,
    const void* n1b, const void* wqkv, const void* wout, const void* bout, const void* n2s,
    const void* n2b, const void* w1, const void* b1, const void* w2, const void* b2,
    void* ck, void* cv, const void* sqkv, const void* sout, const void* s1, const void* s2,
    void* ks, void* vs, const int* tokens_lens, const int* codes_lens, const int* idx,
    float* qbuf, float* abuf, float* xmid, float* hmid, float* kvnew, float* part, int L,
    int rows, int S, int d, int h, int dff, int qblk, int ttm, int pm, int groups_d,
    int groups_ff, int chunk, float scale, void* stream) {
  if (idx == nullptr) return (int)cudaErrorInvalidValue;
  StepArgs s{x, n1s, n1b, wqkv, wout, bout, n2s, n2b, w1, b1, w2, b2, y, ck, cv, sqkv,
             sout, s1, s2, ks, vs, tokens_lens, codes_lens, idx, qbuf, abuf, xmid,
             hmid, kvnew, part, nullptr, nullptr, L, rows, S, d, d, h, dff, 0, qblk, ttm,
             pm, groups_d, groups_d, groups_ff, chunk, scale};
  return dispatch(dtype, cache_dtype, wfmt, s, stream);
}

// Tensor parallelism over mp ranks (one host call for all of them).  ptrs:
// TP_PTRS device pointers per rank, rank-major: those of the launchers above
// in their order (x, y, the 11 weights, ck, cv, the 4 weight scales, ks, vs,
// tokens_lens, codes_lens, idx, qbuf, abuf, xmid, hmid, kvnew, part), then the
// rank's two (rows * qblk, d) f32 partial planes.  A rank's stack is its
// Megatron split: qkv (L, d, 3 da), out (L, da, d), lin1 (L, d, dff), lin2
// (L, dff, d), with da = d / mp and dff the rank's share; its cache (L,
// rows, S, da) holds its h local heads; qbuf/abuf (., da), kvnew (., 2 da),
// xmid (., d), hmid (., dff).  groups_att: the int4 groups of out's da-wide
// input (the ranked packing).  cards[r]: rank r's card; streams[r]: the
// stream its kernels run on; callers[r]: the caller's stream on that card,
// which the step waits for first and which waits for the step at the end.
// verify = 1: the verify step, index_or_qblk = qblk (idx required); else the
// decode step with index_or_qblk the scalar index (idx null) or 0.  W8A8
// weights are refused (cudaErrorInvalidValue).
extern "C" int valle2_fused_step_tp(int verify, int dtype, int cache_dtype, int wfmt, int mp,
                                    void* const* ptrs, const int* cards, void* const* streams,
                                    void* const* callers, int L, int rows, int S, int d,
                                    int da, int h, int dff, int index_or_qblk, int ttm, int pm,
                                    int groups_d, int groups_att, int groups_ff, int chunk,
                                    float scale) {
  if (wfmt == W8 || mp < 1 || mp > MAX_MP) return (int)cudaErrorInvalidValue;
  StepArgs s[MAX_MP];
  cudaStream_t caller[MAX_MP];
  for (int r = 0; r < mp; ++r) {
    void* const* P = ptrs + (size_t)r * TP_PTRS;
    StepArgs& a = s[r];
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
    caller[r] = static_cast<cudaStream_t>(callers[r]);
  }
  std::lock_guard<std::mutex> lock(tp_mutex);
  DeviceRestore restore;
  Ranks k;
  int err = k.init(mp, cards, streams);
  if (err) return err;
  return with_formats(dtype, cache_dtype, wfmt, da / h, [&](auto t, auto tc, auto hd, auto wf) {
    return step_tp<typename decltype(t)::type, typename decltype(tc)::type,
                   decltype(hd)::value, decltype(wf)::value>(k, s, caller);
  });
}

// 5c alone (EPI_SUM): rank r's out[r] (n f32) = the rank-ordered sum of the
// mp partials, launched on streams[r] (the caller's current stream on card
// cards[r]) after every rank's queued work, which then waits for every rank's
// reads before it goes on.
extern "C" int valle2_tp_allreduce(int mp, void* const* partials, void* const* outs,
                                   const int* cards, void* const* streams, long n) {
  if (mp < 1 || mp > MAX_MP || n < 0) return (int)cudaErrorInvalidValue;
  Partials src{};
  cudaStream_t st[MAX_MP];
  for (int r = 0; r < mp; ++r) {
    src.p[r] = static_cast<const float*>(partials[r]);
    st[r] = static_cast<cudaStream_t>(streams[r]);
  }
  std::lock_guard<std::mutex> lock(tp_mutex);
  DeviceRestore restore;
  Ranks k;
  int err = k.init(mp, cards, streams);
  if (err || (err = k.barrier(st, st))) return err;
  for (int r = 0; r < mp; ++r) {
    cudaSetDevice(cards[r]);
    if ((err = launch_reduce<float, EPI_SUM>(src, mp, n, 1, nullptr, nullptr, nullptr,
                                             static_cast<float*>(outs[r]), nullptr, st[r])))
      return err;
  }
  return k.barrier(st, st);
}

// Lets card `card`'s kernels read card `peer`'s memory (already enabled
// counts as done).
extern "C" int valle2_tp_enable_peer(int card, int peer) {
  DeviceRestore restore;
  cudaError_t err = cudaSetDevice(card);
  if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  return (int)err;
}
