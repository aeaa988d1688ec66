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
// grid; blocks of a GPU grid run in no order.  The step is five phases per
// layer (six with an int8 cache, one more with a chunked cache), each one
// grid of blocks.  The phased route (the phased twins
// valle2_fused_verify_step_phased and valle2_fused_step_tp_phased, the
// bit-exact references of the persistent steps) launches each phase as its
// own kernel, in turn on one stream, from one host call; #6 and #7 run them
// all in ONE cooperative launch, the persistent step (below), on one card,
// and under TP in one cooperative launch per card.  The phases:
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
// Tensor parallelism (5c replaces _ring_allreduce, fused_decode.py:252-295,
// and the reduce sites of _kernel :480-490 and _verify_kernel :786-792).
// Rank r holds the Megatron split of the stack (its h local heads, a (L,
// rows, S, da) cache with da = d / mp, its share of dff; the hidden state
// stays d wide), and the OUT and FFN2 projections write raw f32 partial sums
// instead of their epilogues.  5c's element (reduce_element in
// fused_decode.cuh) then gives every rank the sum over ranks s = 0..mp-1 in
// rank order, ((0 + p_0) + p_1) + ..., so every rank holds the same bits,
// with the bias added once after the sum and then the residual (the one-rank
// epilogues, moved after the sum).  Each rank reads the mp partials
// directly: its own locally, its peers' over NVLink through peer pointers
// (the caller enables peer access; a pair without it is refused, never
// worked around).  On an NVSwitch H100 host every peer is one hop away, so
// no ring is needed; the ring was the TPU torus's answer.  This departs from
// the usual mapping of in-kernel remote copies to NCCL collectives outside
// the kernel, for three reasons: NCCL refuses two ranks on one GPU (virtual
// ranks, how one card checks the protocol); one process keeps
// ValleTTS(mesh=) a single object, as under JAX's single controller; and a
// peer read needs no staging.
//
// The TP step the serving path runs is the persistent one (csrc/fused_step.cu
// valle2_fused_step_tp, step_tp_persistent_kernel in fused_decode.cuh): ONE
// cooperative launch per card a step, holding that card's ranks (all mp with
// virtual ranks on one card), each phase's items its ranks' items
// concatenated rank-major.  Its phases a layer: QKV; (#7 over an int8 cache:
// the cache write); the attention; OUT into the rank's plane part_out; a
// barrier across ranks; reduce-OUT (5c's element over every rank's part_out
// into the rank's f32 mid state); FFN1; FFN2 into part_ffn; a barrier across
// ranks; reduce-FFN2 (into the hidden state) -- 7 (8) phases, a grid barrier
// after each but the last.  On one card a barrier across ranks is a grid
// barrier.  Across cards it is a grid barrier, then one thread of block 0
// stores the barrier's epoch into this card's slot of every other card's
// flag array (a system-scope release) and spins with system-scope acquires
// on its own array until every other card's slot holds the epoch, then a
// second grid barrier; the epoch is a host counter under a lock, never
// reset, so no flag is; a wait that sees nothing for 10 s traps (a missing
// peer ends the run with an error, never hangs it), and the launcher
// reports it on its next call.  The partials are read through L2 (ld.cg):
// the same planes are re-read every layer, and a line of a peer's plane
// that L1 kept would be stale.  Two planes suffice: rank r writes part_out
// again only in the next layer, after the FFN barrier, which every rank
// reaches only after its reduce has read the part_out planes (and part_ffn
// after the next layer's OUT barrier, likewise).  Across cards the
// launches' streams first wait for each other's queued work, and at the end
// for each other's launch, so no partial is freed, or reused by PyTorch's
// allocator, while a peer still reads it.
//
// The phased TP step (valle2_fused_step_tp_phased, step_tp below) is the
// bit-exact reference of the persistent one, for tests and chip_smoke.py:
// one host thread, CUDA events, rank r's kernels on its own stream, virtual
// ranks on one card included.  It first makes every rank's stream wait for
// every caller stream's queued work; then per layer, each rank queues its
// attention phase, ending in its OUT partial into part_out; a barrier (each
// rank records its event, each rank's stream waits for every rank's event);
// each rank's 5c (tp_allreduce_kernel) over the part_out planes into its
// mid state, and its FFN phase, ending in its FFN2 partial into part_ffn; a
// barrier; each rank's 5c over the part_ffn planes into its hidden state;
// at the end every caller stream waits for every rank's last event.  A TP
// launch holds one lock (the event pool: one event per (card, rank)).
//
// 5c alone (valle2_tp_row_reduce, tp_row_reduce_kernel) serves the
// prefill's and the NAR's row-parallel sums, with the row-parallel epilogue
// inside: round(x + round(s + b)), the bias once after the sum, the cast to
// the compute dtype and the caller's residual add, which were three more
// kernels a rank.  ONE launch a card a sum, on the caller's stream there,
// holds all of that card's ranks: it reads the mp partials once (16-byte
// ld.global.cg loads, a peer's plane over NVLink) and writes each local
// rank's output.  Its grid is the card's SMs x the blocks that fit one.
// What bounds it: bytes, 3 mp planes of rows * d f32 at mp virtual ranks
// (partials, residuals, outputs), 7 MB at the prefill's 3 x 385 x 256 and
// mp 2: about 2 us at 3.35 TB/s, where the launches and host calls of the
// old per-rank route took about 0.1 ms.  Ordering: virtual ranks share
// one card and one stream, whose order is all the sum needs, so the call
// makes no event or device call then.  Across cards a partial must not be
// read before its card's GEMM wrote it, and no card's stream may go on (nor
// its allocator reuse a partial) before every peer has read it: flags in
// peer memory inside a cooperative launch a card (a ready and a done epoch
// a call, each card's slot in every other card's array; a wait bounded at
// CARD_WAIT_NS, then a trap), no event.  Host events (one record a card and
// n - 1 waits on each stream, before the launches and after) were measured
// beside them on four H100s and were slower: 0.147-0.180 ms a sum against
// 0.098-0.128 (probes/rvq_allreduce_ab.py --cards 4).
//
// What bounds it on this card: at 12 query rows a step streams the weights
// (about 1.5 MB per layer in bf16, half that in int8, a quarter in int4) and
// the valid cache prefix (half the bytes in int8), and does far too little
// arithmetic to need the tensor cores, so the products run on the CUDA cores
// (f32 FMAs; __dp4a for int8).  The bytes bound is about 0.014 ms at the
// serving shape (12 rows, S 1280, bf16) and 0.13 ms at the 204M one (1 row);
// the phased route took 0.578 and 2.136 ms (H100 80GB HBM3, 700 W,
// chip_smoke.py): latency, not
// bytes, is the time.  Three latencies, by the code: 40-48 launches a step,
// each enqueued by the host inside the token loop (the device was 41% busy in
// the plain loop); projection grids of ceil(N / 32) x ceil(rows / 16) blocks,
// which leave most of the 132 SMs idle (24 / 8 / 32 / 8 blocks at the serving
// width); and no overlap between a layer's phases and the next layer's
// weight reads.  Inside each block, memory latency is met by batching loads:
// the projections read each weight once for a tile of up to 16 rows (rows in
// registers, K split over 16 warps, 8 loads in flight per warp), and the
// attention loads 8 slots' k and v before using any.  A verify block's K
// queries read their row's slots K times, from L2 after the first: a block
// per (row, head, 8 queries) that staged each 32-slot tile once in shared
// memory for all its queries, one warp per query, took 0.067 ms a layer at 3
// rows x K = 4 on an H100 (torch.profiler), where the decode step's attention
// at 12 rows took 0.014: its 12 blocks each walked every slot in turn.  The
// tile's rows of the A operand sit in shared memory, so a projection input
// wider than 3072 (2048 under W8A8, whose int8 codes sit beside it) takes a
// tile of 8 rows, up to 6144 (5120): more than 8 query rows then read each
// weight once per 8-row tile.
//
// The persistent step (#6 and #7 on one card, step_persistent_kernel,
// launched by csrc/fused_step.cu; the device code of both routes is
// fused_decode.cuh): one cooperative launch a step, its grid the card's
// co-resident capacity (SM
// count x blocks per SM at the step's shared memory; a card that takes no
// cooperative launch, or no block, is refused), every block of PNT = 512
// threads.  The blocks walk the layers together; in each layer every phase
// spreads its items over all the blocks, in turn (block b takes items b, b +
// grid, ...), and a grid-wide barrier (cooperative_groups' grid sync)
// separates the phases: QKV; the attention; OUT; FFN1; FFN2 -- 5 barriers a
// layer, 5 L - 1 a step, at any weight or cache format but one.  Two of the
// phased route's kernels fold into their consumers: #6's int8 cache write
// into the attention item that holds the query's own slot (its warps 0 and
// 1 quantize the head's k and v, a named barrier, then the walk reads them
// back), and the chunks' merge into the OUT tile's operand prologue
// (merge_chunks).  #7 (qblk = K > 1 query rows a cache row, from per-row
// start slots) runs the same phases over rows * K query rows: QKV writes a
// float cache's K new slots in place before the barrier, so every query
// reads its block's earlier slots after it.  Its int8 cache write cannot
// fold: query i also reads the slots of queries 0 .. i-1, quantized by
// other items, on other blocks, in the same phase.  So with an int8 cache
// #7 runs the write as a phase of its own between QKV and the attention
// (run_kv_quant: kv_quant_kernel's warps, one per (query row, head, k|v),
// 16 a block), 6 barriers a layer, 6 L - 1 a step; the codes are those of
// the phased kv_quant_kernel.  An item is the phased route's block on the
// same device code (proj_block, attend_item, kv_quant_warp, merge_chunks):
// a projection tile of up to 16 rows x 32 columns summing the same 16 K
// slices in slice order in shared memory, the same LayerNorm prologue, the
// same rounding points.  So every output element is computed alike and the
// persistent step is bit-equal to the phased twin
// (valle2_fused_verify_step_phased; with a block of one token it runs #6's
// phases).  An attention item (query row, head[, chunk]) takes ANW = 16
// warps, the whole block, synchronised by a named barrier.  The block length
// is a runtime argument: #7 adds no instantiation to the build, and its
// grid and shared memory are #6's.
// While a layer's attention runs, every thread issues L2 prefetches of that
// layer's OUT / FFN1 / FFN2 weights and the next layer's QKV weights, so the
// projections that follow read L2 rather than device memory (at 204M a layer
// is 24 MB of bf16 weights, inside the 50 MB L2).  What bounds it now: the
// barriers (~1-2 us each, 39 a serving step, 79 at 204M) and, inside each
// phase, the per-warp chain of K slice loads (kper / 8 batches of one memory
// latency); the projection tiles still number ceil(N / 32) x ceil(rows / 16),
// so a phase with few tiles (OUT, FFN2: 8 at the serving width, 32 at 204M)
// runs on that many blocks while the others wait at the barrier.  Splitting
// a tile's K slices over blocks, with the partials summed in slice order by
// the consuming phase, would spread them further at the same arithmetic; a
// CUDA graph of the token loop and the tensor cores at larger row counts are
// later work.

#include "fused_decode.cuh"

namespace {

// The phased step: 5-7 launches a layer on one stream (the phased twin; one
// rank of the TP step is attn_phase / ffn_phase with 5c between them).
int dispatch(int dtype, int cache_dtype, int wfmt, const StepArgs& s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(s)) return (int)cudaErrorInvalidValue;
  return with_formats(dtype, cache_dtype, wfmt, s.da / s.h,
                      [&](auto t, auto tc, auto hd, auto wf) {
    return step<typename decltype(t)::type, typename decltype(tc)::type, decltype(hd)::value,
                decltype(wf)::value>(s, st);
  });
}

// ---- Tensor parallelism: the phased TP step (5c between its phases) ----

constexpr int MAX_CARDS = 32;  // cards of the event pool
constexpr int RED_THREADS = 256;

// 5c of the phased TP step (reduce_element over every element): out[i] =
// the rank-ordered f32 sum of the mp partials, with epilogue EPI.
template <typename T, int EPI>
__global__ void __launch_bounds__(RED_THREADS)
tp_allreduce_kernel(Partials src, int mp, long n, int d, const T* __restrict__ bias,
                    const T* __restrict__ x, const float* __restrict__ res32,
                    float* __restrict__ out32, T* __restrict__ y) {
  for (long i = blockIdx.x * (long)RED_THREADS + threadIdx.x; i < n;
       i += (long)gridDim.x * RED_THREADS)
    reduce_element<T, EPI>(src, mp, i, d, bias, x, res32, out32, y);
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

// The phased TP step: layer by layer, every rank's attention phase (its partial of
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

// ---- 5c alone: the row-parallel sum with its epilogue, one launch a card ----

constexpr int RR_THREADS = 256;
constexpr int RR_COUNTERS = 64;   // arrival counters a card, by epoch: concurrent calls part

// One launch's arguments: the card's ranks (its group), every rank's partial.
struct RowReduceArgs {
  Partials src;                   // every rank's f32 partial, in rank order
  void* out[MAX_MP];              // the group's outputs (T), in rank order
  const void* bias[MAX_MP];       // their biases (B, d long), or null
  const void* res[MAX_MP];        // their residuals (T), or null
  long n;                         // elements of a partial
  int d, mp, n_local;
  int vec;                        // 1: 4 elements a thread (every pointer aligned, d % 4 == 0)
  // across cards: each card's flag array, this card's slot in every array,
  // the epoch (ready; done is epoch + 1), this card's arrival counters, the
  // host-mapped error word
  unsigned long long* flags[MAX_MP];
  int slot[MAX_MP];
  unsigned long long epoch;
  unsigned* arrived;
  int* error;
  int n_cards, me;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The row-parallel epilogue of one element, after the rank-ordered sum s:
// round_T(s + b), then round_T(x + that) with a residual x -- the plain
// composition (linear_row_parallel's (y + b).to(T), then the caller's x +
// o); a missing bias or residual is skipped, not added as 0 (0 + -0 = +0).
template <typename T, typename B>
__device__ __forceinline__ float row_epilogue(float s, const B* bias, const T* res, long i,
                                              int d) {
  float y = s;
  if (bias != nullptr) y = y + to_f<B>(bias[i % d]);
  if (res != nullptr) return to_f<T>(res[i]) + round_to<T>(y);
  return y;
}

// Card `me` tells every other card that its value reached `want` and waits
// until every other card's value in its own array has (a system-scope
// release after a system fence; acquires; traps after CARD_WAIT_NS).
__device__ __forceinline__ void signal_and_wait(const RowReduceArgs& a, unsigned long long want,
                                                bool signal) {
  if (signal) {
    __threadfence_system();
    for (int c = 0; c < a.n_cards; ++c)
      if (c != a.me) st_release_sys(a.flags[c] + a.slot[a.me], want);
  }
  const unsigned long long t0 = globaltimer();
  for (int c = 0; c < a.n_cards; ++c) {
    if (c == a.me) continue;
    while (ld_acquire_sys(a.flags[a.me] + a.slot[c]) < want) {
      if (globaltimer() - t0 > CARD_WAIT_NS) {
        atomicExch_system(a.error, 1);
        __threadfence_system();
        __trap();
      }
    }
  }
}

// 5c alone: every element's rank-ordered f32 sum over the mp partials (read
// once, 16 bytes a load through L2), then each of the card's ranks' epilogue
// into its own output.  The grid is the card's co-resident capacity, or
// fewer blocks where the elements need fewer.  With
// flags across cards (FLAGS): block 0 announces this card's partial (written
// by the work before the launch on its stream) and every block waits for
// every card's before it reads; after its reads each block counts itself,
// and the card's last block announces that the card has read and waits for
// every card's, so no card's launch ends -- and no partial is freed or
// reused -- while a peer still reads it.
template <typename T, typename B, bool FLAGS>
__global__ void __launch_bounds__(RR_THREADS) tp_row_reduce_kernel(RowReduceArgs a) {
  if constexpr (FLAGS) {
    if (threadIdx.x == 0) signal_and_wait(a, a.epoch, blockIdx.x == 0);
    __syncthreads();
  }
  const long stride = (long)gridDim.x * RR_THREADS;
  const long first = (long)blockIdx.x * RR_THREADS + threadIdx.x;
  if (a.vec) {
    for (long j = first; j < a.n / 4; j += stride) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < a.mp; ++r) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(a.src.p[r]) + j);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const long i = 4 * j;
      for (int l = 0; l < a.n_local; ++l) {
        float4 y = s;
        if (a.bias[l] != nullptr) {
          const float4 b = load4(static_cast<const B*>(a.bias[l]) + i % a.d);
          y = make_float4(y.x + b.x, y.y + b.y, y.z + b.z, y.w + b.w);
        }
        if (a.res[l] != nullptr) {
          const float4 x = load4(static_cast<const T*>(a.res[l]) + i);
          y = make_float4(x.x + round_to<T>(y.x), x.y + round_to<T>(y.y),
                          x.z + round_to<T>(y.z), x.w + round_to<T>(y.w));
        }
        store4(static_cast<T*>(a.out[l]) + i, y);
      }
    }
  } else {
    for (long i = first; i < a.n; i += stride) {
      float s = 0.f;
      for (int r = 0; r < a.mp; ++r) s += __ldcg(a.src.p[r] + i);
      for (int l = 0; l < a.n_local; ++l)
        static_cast<T*>(a.out[l])[i] = from_f<T>(row_epilogue<T, B>(
            s, static_cast<const B*>(a.bias[l]), static_cast<const T*>(a.res[l]), i, a.d));
    }
  }
  if constexpr (FLAGS) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      unsigned* count = a.arrived + a.epoch % RR_COUNTERS;
      if (atomicAdd(count, 1u) == gridDim.x - 1) {
        *count = 0;
        signal_and_wait(a, a.epoch + 1, true);
      }
    }
  }
}

// 5c's host state, under tp_mutex: the epoch of its flags (a counter never
// reset), each card's flag array (MAX_CARDS u64) and arrival counters, the
// host-mapped error word, and the count of ordering calls (cudaSetDevice;
// it makes no event call) 5c alone has made.
unsigned long long rr_epoch = 0;
unsigned long long* rr_flags[MAX_CARDS] = {};
unsigned* rr_arrived[MAX_CARDS] = {};
int* rr_error = nullptr;
long rr_ordering_calls = 0;

// The card's grid: its SMs x the blocks of one launch that fit an SM
// (co-resident, as a cooperative launch needs).  Asked once a card.
template <typename T, typename B, bool FLAGS>
cudaError_t rr_grid_of(int card, int* grid) {
  static int blocks[MAX_CARDS] = {};
  if (blocks[card] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tp_row_reduce_kernel<T, B, FLAGS>, RR_THREADS, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    blocks[card] = sms * per_sm;
  }
  *grid = blocks[card];
  return cudaSuccess;
}

// Card c's 5c state across cards: flags and counters (zeroed before any
// launch uses them), the error word; made once.
cudaError_t rr_card_state(int c) {
  cudaError_t err = cudaSuccess;
  if (rr_flags[c] == nullptr) {
    unsigned long long* f = nullptr;
    unsigned* a = nullptr;
    err = cudaMalloc(&f, MAX_CARDS * sizeof(unsigned long long));
    if (err == cudaSuccess) err = cudaMalloc(&a, RR_COUNTERS * sizeof(unsigned));
    if (err == cudaSuccess) err = cudaMemset(f, 0, MAX_CARDS * sizeof(unsigned long long));
    if (err == cudaSuccess) err = cudaMemset(a, 0, RR_COUNTERS * sizeof(unsigned));
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (err != cudaSuccess) return err;
    rr_flags[c] = f;
    rr_arrived[c] = a;
  }
  if (rr_error == nullptr) {
    int* e = nullptr;
    err = cudaHostAlloc(&e, sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable);
    if (err == cudaSuccess) {
      *e = 0;
      rr_error = e;
    }
  }
  return err;
}

template <typename T, typename B>
int row_reduce(int mp, void* const* partials, void* const* outs, void* const* biases,
               void* const* residuals, const int* cards, void* const* streams, long n, int d) {
  // The card groups: ranks by card in the order each card first appears,
  // one stream a card.
  int n_cards = 0, card[MAX_MP], size[MAX_MP], rank[MAX_MP][MAX_MP];
  cudaStream_t st[MAX_MP];
  for (int r = 0; r < mp; ++r) {
    if (cards[r] < 0 || cards[r] >= MAX_CARDS) return (int)cudaErrorInvalidDevice;
    int g = 0;
    while (g < n_cards && card[g] != cards[r]) ++g;
    if (g == n_cards) {
      card[g] = cards[r];
      size[g] = 0;
      st[n_cards++] = static_cast<cudaStream_t>(streams[r]);
    } else if (st[g] != static_cast<cudaStream_t>(streams[r])) {
      return (int)cudaErrorInvalidValue;   // one stream a card
    }
    rank[g][size[g]++] = r;
  }
  auto aligned = [](const void* p, int bytes) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  bool vec = n % 4 == 0 && d % 4 == 0;
  for (int r = 0; r < mp; ++r)
    vec = vec && aligned(partials[r], 16) && aligned(outs[r], 4 * sizeof(T)) &&
          aligned(biases[r], 4 * sizeof(B)) && aligned(residuals[r], 4 * sizeof(T));
  const bool flags = n_cards > 1;
  static RowReduceArgs args[MAX_MP];   // under tp_mutex
  int grid[MAX_MP];
  // The caller's current card, put back on return where a call moved it.
  struct Current {
    int dev = 0, caller = 0;
    cudaError_t to(int c) {
      if (c == dev) return cudaSuccess;
      ++rr_ordering_calls;
      dev = c;
      return cudaSetDevice(c);
    }
    ~Current() {
      if (dev != caller) {
        ++rr_ordering_calls;
        cudaSetDevice(caller);
      }
    }
  } cur;
  cudaError_t err = cudaGetDevice(&cur.caller);
  cur.dev = cur.caller;
  for (int g = 0; g < n_cards && err == cudaSuccess; ++g) {
    if (flags && (rr_flags[card[g]] == nullptr || rr_error == nullptr)) {
      err = cur.to(card[g]);
      if (err == cudaSuccess) err = rr_card_state(card[g]);
    }
    if (err == cudaSuccess)
      err = flags ? rr_grid_of<T, B, true>(card[g], &grid[g])
                  : rr_grid_of<T, B, false>(card[g], &grid[g]);
  }
  if (err != cudaSuccess) return (int)err;
  const long items = vec ? n / 4 : n;        // no block without an element
  for (int g = 0; g < n_cards; ++g)
    grid[g] = (int)std::max<long>(
        1, std::min<long>(grid[g], (items + RR_THREADS - 1) / RR_THREADS));
  if (flags && *rr_error) return (int)cudaErrorTimeout;   // a wait timed out before
  const unsigned long long epoch = rr_epoch + 1;
  if (flags) rr_epoch += 2;
  for (int g = 0; g < n_cards; ++g) {
    RowReduceArgs& a = args[g];
    a = RowReduceArgs{};
    for (int r = 0; r < mp; ++r) a.src.p[r] = static_cast<const float*>(partials[r]);
    for (int j = 0; j < size[g]; ++j) {
      a.out[j] = outs[rank[g][j]];
      a.bias[j] = biases[rank[g][j]];
      a.res[j] = residuals[rank[g][j]];
    }
    a.n = n, a.d = d, a.mp = mp, a.n_local = size[g], a.vec = vec;
    if (flags) {
      for (int c = 0; c < n_cards; ++c) {
        a.flags[c] = rr_flags[card[c]];
        a.slot[c] = card[c];
      }
      a.epoch = epoch;
      a.arrived = rr_arrived[card[g]];
      if (cudaHostGetDevicePointer(reinterpret_cast<void**>(&a.error), rr_error, 0))
        return (int)cudaErrorInvalidValue;
      a.n_cards = n_cards, a.me = g;
    }
  }
  for (int g = 0; g < n_cards; ++g) {
    if ((err = cur.to(card[g]))) return (int)err;   // no call for the current card
    if (flags) {
      void* params[] = {&args[g]};
      err = cudaLaunchCooperativeKernel(tp_row_reduce_kernel<T, B, true>, dim3(grid[g]),
                                        dim3(RR_THREADS), params, 0, st[g]);
    } else {
      tp_row_reduce_kernel<T, B, false><<<grid[g], RR_THREADS, 0, st[g]>>>(args[g]);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;   // launched peers trap after CARD_WAIT_NS
  }
  return 0;
}

}  // namespace


// dtype: 0 = float32, 1 = bfloat16; cache_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (every pair of the two); wfmt: 0 = dense, 1 =
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
// non-zero cudaGetLastError() of the launches.  #6 and #7 are
// csrc/fused_step.cu's valle2_fused_decode_step and valle2_fused_verify_step
// (one persistent launch each, the same arguments).

// The phased twin of #7 (and, with qblk 1, of #6): qblk tokens per row, x
// and y (rows, qblk, d); row r's block is written at slots idx[r] .. idx[r]
// + qblk - 1 (a device pointer, never read by the host), each slot >= S
// skipped.  One kernel per phase, 5-7 a layer: the bit-exact reference the
// persistent steps are held to (tests, chip_smoke.py); no serving path
// launches it.
extern "C" int valle2_fused_verify_step_phased(
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

// The phased TP step, the bit-exact reference of the persistent one
// (csrc/fused_step.cu valle2_fused_step_tp, which takes the same arguments
// but `streams`; see tp_rank_args for `ptrs`): mp ranks from one host call,
// one kernel per phase on each rank's own stream, 5c between the layers.  A
// rank's stack is its Megatron split: qkv (L, d, 3 da), out (L, da, d), lin1
// (L, d, dff), lin2 (L, dff, d), with da = d / mp and dff the rank's share;
// its cache (L, rows, S, da) holds its h local heads; qbuf/abuf (., da),
// kvnew (., 2 da), xmid (., d), hmid (., dff).  groups_att: the int4 groups
// of out's da-wide input (the ranked packing).  cards[r]: rank r's card;
// streams[r]: the stream its kernels run on; callers[r]: the caller's stream
// on that card, which the step waits for first and which waits for the step
// at the end.  W8A8 weights are refused (cudaErrorInvalidValue).  For tests
// and chip_smoke.py; no serving path launches it.
extern "C" int valle2_fused_step_tp_phased(int verify, int dtype, int cache_dtype, int wfmt,
                                           int mp, void* const* ptrs, const int* cards,
                                           void* const* streams, void* const* callers, int L,
                                           int rows, int S, int d, int da, int h, int dff,
                                           int index_or_qblk, int ttm, int pm, int groups_d,
                                           int groups_att, int groups_ff, int chunk,
                                           float scale) {
  if (wfmt == W8 || mp < 1 || mp > MAX_MP) return (int)cudaErrorInvalidValue;
  StepArgs s[MAX_MP];
  int err = tp_rank_args(verify, mp, ptrs, L, rows, S, d, da, h, dff, index_or_qblk, ttm, pm,
                         groups_d, groups_att, groups_ff, chunk, scale, s);
  if (err) return err;
  cudaStream_t caller[MAX_MP];
  for (int r = 0; r < mp; ++r) caller[r] = static_cast<cudaStream_t>(callers[r]);
  std::lock_guard<std::mutex> lock(tp_mutex);
  DeviceRestore restore;
  Ranks k;
  if ((err = k.init(mp, cards, streams))) return err;
  return with_formats(dtype, cache_dtype, wfmt, da / h, [&](auto t, auto tc, auto hd, auto wf) {
    return step_tp<typename decltype(t)::type, typename decltype(tc)::type,
                   decltype(hd)::value, decltype(wf)::value>(k, s, caller);
  });
}

// 5c alone, with the row-parallel epilogue: rank r's outs[r] (n elements
// of dtype: 0 = float32, 1 = bfloat16) = round(x_r + round(s + b_r)), s the
// rank-ordered f32 sum of the mp f32 partials, b_r = biases[r] (d long, of
// bias_dtype, 0 or 1) and x_r = residuals[r] (of dtype), each null to skip
// it (float32 with neither: the bare sum).  cards[r]: rank r's card;
// streams[r]: the caller's current stream there (one a card).  One launch a
// card on that stream, holding the card's ranks (one launch for every
// virtual rank of one card, with no ordering call: its stream orders it).
// Across cards, flags in peer memory inside a cooperative launch a card
// (tp_row_reduce_kernel) keep every card from reading a partial before its
// card's work has written it, and from going on before every card has read
// its.  Returns the first non-zero cudaError_t; cudaErrorTimeout once a wait
// across cards has timed out.
extern "C" int valle2_tp_row_reduce(int dtype, int bias_dtype, int mp, void* const* partials,
                                    void* const* outs, void* const* biases,
                                    void* const* residuals, const int* cards,
                                    void* const* streams, long n, int d) {
  if (mp < 1 || mp > MAX_MP || n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(tp_mutex);
  auto go = [&](auto t, auto b) {
    return row_reduce<typename decltype(t)::type, typename decltype(b)::type>(
        mp, partials, outs, biases, residuals, cards, streams, n, d);
  };
  if (dtype == 0 && bias_dtype == 0) return go(Tag<float>{}, Tag<float>{});
  if (dtype == 0 && bias_dtype == 1) return go(Tag<float>{}, Tag<__nv_bfloat16>{});
  if (dtype == 1 && bias_dtype == 0) return go(Tag<__nv_bfloat16>{}, Tag<float>{});
  if (dtype == 1 && bias_dtype == 1) return go(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  return (int)cudaErrorInvalidValue;
}

// The ordering calls (cudaSetDevice) 5c alone has made since the library
// was loaded.
extern "C" long valle2_tp_row_reduce_ordering_calls() { return rr_ordering_calls; }

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
