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
// launch holds one lock (the event pool: one event per (card, rank)).  5c
// alone (valle2_tp_allreduce) serves the prefill's and the NAR's
// row-parallel sums on the callers' streams, between the same two barriers.
// What bounds 5c: each rank reads mp partials of rows * d f32 and writes
// one, a few KB at the serving shape, so its time is launch and
// synchronisation latency -- which the persistent TP step's reduce phases
// (about 1.4 us a layer each at the serving width) do not pay.
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

// ---- Tensor parallelism: 5c alone and the phased TP step ----

constexpr int MAX_CARDS = 32;  // cards of the event pool
constexpr int RED_THREADS = 256;

// 5c (reduce_element over every element): out[i] = the rank-ordered f32 sum
// of the mp partials, with epilogue EPI.
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
