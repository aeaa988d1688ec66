// #6, the fused decode step, and #7, the speculative verify step, each as
// ONE cooperative launch a step on one card (step_persistent_kernel in
// fused_decode.cuh; the design is in fused_decode.cu's header), and both
// under tensor parallelism as one cooperative launch per card a step, the
// all-reduce 5c folded in as two reduce phases a layer
// (step_tp_persistent_kernel, valle2_fused_step_tp).  Built once per weight
// format, VALLE2_STEP_WF = 0 dense, 1 int8 W8A8, 2 int4 W4A16, and with
// VALLE2_STEP_TP = 1 the TP step alone, once per format it takes (dense,
// int4: W8A8 has no TP step) (kernels/_build.py), so that the five compile
// in parallel; each build instantiates its step for every compute and cache
// dtype, the head dim chosen in the kernel and the block length (qblk: 1
// for #6, K for #7) a runtime argument, so #7 adds no instantiation, and the
// TP step's local rank count a runtime argument too: one instantiation per
// dtype pair and build.

#include "fused_decode.cuh"

#ifndef VALLE2_STEP_WF
#error "fused_step.cu is built with -DVALLE2_STEP_WF=0, 1 or 2"
#endif
#ifndef VALLE2_STEP_TP
#define VALLE2_STEP_TP 0
#endif

namespace {

constexpr int STEP_WF = VALLE2_STEP_WF;
constexpr int MAX_GRID_CARDS = 32;       // cards whose grid size is cached

bool hd_taken(int hd) { return hd == 32 || hd == 64 || hd == 96 || hd == 128; }

// The persistent step's dynamic shared memory: the largest of its four
// projections' tiles and the attention's items (the int8 cache write takes
// none).  It does not depend on the block length.
size_t persistent_smem(const StepArgs& s, int hd) {
  auto proj = [](int K) {
    return K <= max_k16(STEP_WF) ? proj_smem(K, STEP_WF, 16) : proj_smem(K, STEP_WF, 8);
  };
  const size_t att = sizeof(float) * (2 * ANW + ANW * hd);
  return std::max({proj(s.d), proj(s.da), proj(s.dff), att});
}

// The persistent step's kernel: the one-card step, or (TP) the TP step.
template <typename T, typename TC, bool TP>
const void* step_kernel() {
  if constexpr (TP && STEP_WF != W8) {   // the W8A8 build has no TP step
    return reinterpret_cast<const void*>(step_tp_persistent_kernel<T, TC, STEP_WF>);
  } else {
    return reinterpret_cast<const void*>(step_persistent_kernel<T, TC, STEP_WF>);
  }
}

// The grid of the persistent step (TP: the TP step) on the current card:
// every block it can hold at once at `smem` bytes a block (SM count x blocks
// per SM), or an error when the card takes no cooperative launch or no such
// block.
template <typename T, typename TC, bool TP = false>
cudaError_t persistent_grid(size_t smem, int* blocks) {
  const void* kernel = step_kernel<T, TC, TP>();
  static unsigned configured = 0;   // one bit per card
  cudaError_t err = once_per_device(configured, [&] {
    const size_t cap = std::max(proj_smem(max_k16(STEP_WF), STEP_WF, 16),
                                proj_smem(max_k8(STEP_WF), STEP_WF, 8));
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cap);
  });
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  // The last answer, per card and shared memory size: the queries cost the
  // host more than the launch.
  static std::mutex cache_mutex;
  static int cached[MAX_GRID_CARDS][2] = {};   // (smem + 1, blocks) per card
  if (err == cudaSuccess && dev < MAX_GRID_CARDS) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    if (cached[dev][0] == (int)smem + 1) {
      *blocks = cached[dev][1];
      return cudaSuccess;
    }
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PNT, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (err == cudaSuccess && dev < MAX_GRID_CARDS) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    cached[dev][0] = (int)smem + 1;
    cached[dev][1] = *blocks;
  }
  return err;
}

#if !VALLE2_STEP_TP
unsigned long long* g_trace = nullptr;   // valle2_fused_step_trace: the next launch's
                                         // (#6 or #7)
std::mutex g_trace_mutex;

template <typename T, typename TC>
int step_persistent(const StepArgs& s, cudaStream_t stream) {
  const size_t smem = persistent_smem(s, s.da / s.h);
  int blocks = 0;
  cudaError_t err = persistent_grid<T, TC>(smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  StepArgs arg = s;
  {
    std::lock_guard<std::mutex> lock(g_trace_mutex);
    arg.trace = g_trace;
    g_trace = nullptr;
  }
  void* params[] = {&arg};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(step_persistent_kernel<T, TC, STEP_WF>), dim3(blocks),
      dim3(PNT), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif

// f(Tag<T>, Tag<TC>) for the compute and cache dtypes the step takes.
template <typename F>
int with_types(int dtype, int cache_dtype, F&& f) {
  if (dtype == 0 && cache_dtype == 0) return f(Tag<float>{}, Tag<float>{});
  if (dtype == 0 && cache_dtype == 1) return f(Tag<float>{}, Tag<__nv_bfloat16>{});
  if (dtype == 0 && cache_dtype == 2) return f(Tag<float>{}, Tag<int8_t>{});
  if (dtype == 1 && cache_dtype == 0) return f(Tag<__nv_bfloat16>{}, Tag<float>{});
  if (dtype == 1 && cache_dtype == 1) return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  if (dtype == 1 && cache_dtype == 2) return f(Tag<__nv_bfloat16>{}, Tag<int8_t>{});
  return (int)cudaErrorInvalidValue;
}

// The widths the persistent steps take: any block length, an attention width
// da of d (one card) or d / mp (a TP rank), a head dim they instantiate,
// inputs up to max_k8.
bool persistent_fits(const StepArgs& s) {
  return !bad_args(s) && s.da >= 1 && s.da <= s.d && s.d % s.da == 0 &&
         hd_taken(s.da / s.h) && s.d <= max_k8(STEP_WF) && s.dff <= max_k8(STEP_WF);
}

#if !VALLE2_STEP_TP
// One persistent launch of the step s (#6 or #7) on `stream`.
int launch(int dtype, int cache_dtype, int wfmt, const StepArgs& s, void* stream) {
  if (wfmt != STEP_WF || !persistent_fits(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, cache_dtype, [&](auto t, auto tc) {
    return step_persistent<typename decltype(t)::type, typename decltype(tc)::type>(s, st);
  });
}

#else
// ---- The persistent TP step ----

// TP launches, one at a time in this build: the epoch of the barriers
// across cards (a counter never reset, so no flag ever is), each card's flag
// array (MAX_GRID_CARDS u64, made at first use), the host-mapped error word
// of a wait that timed out, the events of the fork and the join across
// cards, and the trace hook of the next launch.
std::mutex g_tp_mutex;
unsigned long long g_epoch = 0;
unsigned long long* g_flags[MAX_GRID_CARDS] = {};
int* g_error = nullptr;
cudaEvent_t g_ready[MAX_GRID_CARDS] = {}, g_done[MAX_GRID_CARDS] = {};
unsigned long long* g_tp_trace[MAX_MP] = {};

// Card c's flag array and events, made once (zeroed before any launch uses it).
cudaError_t card_state(int c) {
  cudaError_t err = cudaSetDevice(c);
  if (err == cudaSuccess && g_flags[c] == nullptr) {
    unsigned long long* f = nullptr;
    err = cudaMalloc(&f, MAX_GRID_CARDS * sizeof(unsigned long long));
    if (err == cudaSuccess) err = cudaMemset(f, 0, MAX_GRID_CARDS * sizeof(unsigned long long));
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (err == cudaSuccess) g_flags[c] = f;
  }
  if (err == cudaSuccess && g_ready[c] == nullptr)
    err = cudaEventCreateWithFlags(&g_ready[c], cudaEventDisableTiming);
  if (err == cudaSuccess && g_done[c] == nullptr)
    err = cudaEventCreateWithFlags(&g_done[c], cudaEventDisableTiming);
  if (err == cudaSuccess && g_error == nullptr) {
    int* e = nullptr;
    err = cudaHostAlloc(&e, sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable);
    if (err == cudaSuccess) {
      *e = 0;
      g_error = e;
    }
  }
  return err;
}

// The card groups of a TP step: ranks grouped by card in the order each
// card first appears, each group's ranks in rank order.
struct Groups {
  int n = 0;
  int card[MAX_MP], size[MAX_MP], rank[MAX_MP][MAX_MP];
  cudaStream_t stream[MAX_MP];

  int init(int mp, const int* cards, void* const* callers) {
    for (int r = 0; r < mp; ++r) {
      if (cards[r] < 0 || cards[r] >= MAX_GRID_CARDS) return (int)cudaErrorInvalidDevice;
      int g = 0;
      while (g < n && card[g] != cards[r]) ++g;
      if (g == n) {
        card[n] = cards[r];
        size[n] = 0;
        stream[n++] = static_cast<cudaStream_t>(callers[r]);
      } else if (stream[g] != static_cast<cudaStream_t>(callers[r])) {
        return (int)cudaErrorInvalidValue;   // one caller stream a card
      }
      rank[g][size[g]++] = r;
    }
    return 0;
  }
};

// Every group's stream waits for the events `ev` recorded just now on every
// other group's stream.
int cross_wait(const Groups& g, cudaEvent_t* ev) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < g.n && err == cudaSuccess; ++i) {
    err = cudaSetDevice(g.card[i]);
    if (err == cudaSuccess) err = cudaEventRecord(ev[g.card[i]], g.stream[i]);
  }
  for (int i = 0; i < g.n && err == cudaSuccess; ++i) {
    err = cudaSetDevice(g.card[i]);
    for (int j = 0; j < g.n && err == cudaSuccess; ++j)
      if (j != i) err = cudaStreamWaitEvent(g.stream[i], ev[g.card[j]], 0);
  }
  return (int)err;
}

// One cooperative launch per card group, every card's grid and arguments
// checked before the first launch.  Across cards, the launches' streams
// first wait for each other's queued work (fork) and at the end for each
// other's launch (join: no partial plane is freed, or reused by PyTorch's
// allocator, while a peer still reads it).
template <typename T, typename TC>
int step_tp_persistent(const StepArgs* s, int mp, const Groups& g) {
  if constexpr (STEP_WF == W8) {
    return (int)cudaErrorInvalidValue;
  } else {
    const size_t smem = persistent_smem(s[0], s[0].da / s[0].h);
    static TpStepArgs args[MAX_MP];   // under g_tp_mutex
    int blocks[MAX_MP];
    cudaError_t err = cudaSuccess;
    for (int i = 0; i < g.n && err == cudaSuccess; ++i) {
      err = cudaSetDevice(g.card[i]);
      if (err == cudaSuccess) err = persistent_grid<T, TC, true>(smem, &blocks[i]);
      if (err == cudaSuccess && g.n > 1) err = card_state(g.card[i]);
    }
    if (err != cudaSuccess) return (int)err;
    if (g.n > 1 && *g_error) return (int)cudaErrorTimeout;   // a wait timed out before
    const unsigned long long epoch = g_epoch + 1;
    if (g.n > 1) g_epoch += 2ull * s[0].L;   // the step's 2 L barriers across ranks
    for (int i = 0; i < g.n; ++i) {
      TpStepArgs& a = args[i];
      a = TpStepArgs{};
      for (int j = 0; j < g.size[i]; ++j) a.s[j] = s[g.rank[i][j]];
      for (int r = 0; r < mp; ++r) {
        a.out.p[r] = s[r].part_out;
        a.ffn.p[r] = s[r].part_ffn;
      }
      for (int j = 0; j < g.n; ++j) {
        a.flags[j] = g.n > 1 ? g_flags[g.card[j]] : nullptr;
        a.slot[j] = g.card[j];
      }
      a.epoch = epoch;
      a.error = nullptr;
      if (g.n > 1 && cudaHostGetDevicePointer(reinterpret_cast<void**>(&a.error), g_error, 0))
        return (int)cudaErrorInvalidValue;
      a.n_local = g.size[i], a.mp = mp, a.n_cards = g.n, a.me = i;
      a.trace = g_tp_trace[i];
    }
    for (int i = 0; i < MAX_MP; ++i) g_tp_trace[i] = nullptr;
    int e;
    if (g.n > 1 && (e = cross_wait(g, g_ready))) return e;   // fork
    for (int i = 0; i < g.n; ++i) {
      if ((err = cudaSetDevice(g.card[i]))) return (int)err;
      void* params[] = {&args[i]};
      err = cudaLaunchCooperativeKernel(step_kernel<T, TC, true>(), dim3(blocks[i]), dim3(PNT),
                                        params, smem, g.stream[i]);
      if (err != cudaSuccess) return (int)err;   // launched peers trap after CARD_WAIT_NS
    }
    if ((err = cudaGetLastError())) return (int)err;
    return g.n > 1 ? cross_wait(g, g_done) : 0;   // join
  }
}

// The wait across cards alone, for the test that it is bounded: block 0's
// thread waits at barrier 0 for a second card that never arrives.
__global__ void wait_probe_kernel(TpStepArgs p) { wait_cards(p, 0); }
#endif  // VALLE2_STEP_TP

}  // namespace

#if !VALLE2_STEP_TP
// dtype: 0 = float32, 1 = bfloat16; cache_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (every pair of the two); wfmt must be this
// build's weight format (else cudaErrorInvalidValue).  The arguments are
// those of the phased twin (fused_decode.cu, which says what each holds).
//
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
  return launch(dtype, cache_dtype, wfmt, s, stream);
}

// #7: qblk tokens per row, x and y (rows, qblk, d); row r's block is written
// at slots idx[r] .. idx[r] + qblk - 1 (a device pointer, never read by the
// host; required), each slot >= S skipped, and query i of the block attends
// up to slot idx[r] + i.  The same launch as #6 with rows * qblk query rows
// through the projections and the attention; with an int8 cache its write is
// a phase of its own (6 barriers a layer).
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
  return launch(dtype, cache_dtype, wfmt, s, stream);
}

// The launch of the persistent step (#6 or #7, any block length) on the
// current card for a stack of these formats and widths: its grid (*blocks:
// SM count x the blocks an SM holds at once) and its dynamic shared memory
// (*smem bytes a block).
// Returns the error the launch would give (no cooperative launch, no block
// fits, widths it does not take), else 0.
extern "C" int valle2_fused_step_grid(int dtype, int cache_dtype, int wfmt, int hd, int d,
                                      int dff, int* blocks, long* smem) {
  StepArgs s{};
  s.d = s.da = d;
  s.dff = dff;
  s.h = hd > 0 ? d / hd : 0;
  s.qblk = s.chunk = s.S = s.groups_d = s.groups_att = s.groups_ff = 1;
  if (wfmt != STEP_WF || hd < 1 || d % hd || !persistent_fits(s))
    return (int)cudaErrorInvalidValue;
  return with_types(dtype, cache_dtype, [&](auto t, auto tc) {
    const size_t bytes = persistent_smem(s, hd);
    *smem = (long)bytes;
    return (int)persistent_grid<typename decltype(t)::type, typename decltype(tc)::type>(
        bytes, blocks);
  });
}

// The next persistent launch of this build (#6 or #7, of any thread) records
// its phase timestamps (%globaltimer, ns) into `buf`, 1 + 2 * np L * grid u64
// with np its phases a layer, 5 or 6 (phase_barrier); a measurement hook, off
// (null) by default and again after that launch.
extern "C" void valle2_fused_step_trace(void* buf) {
  std::lock_guard<std::mutex> lock(g_trace_mutex);
  g_trace = static_cast<unsigned long long*>(buf);
}

#else
// #6 (verify = 0) and #7 (verify = 1) under tensor parallelism over mp ranks,
// one host call for all of them: the arguments of the phased TP step
// (csrc/fused_decode.cu valle2_fused_step_tp_phased, and tp_rank_args for
// `ptrs`) but its `streams`.  The ranks are grouped by card (cards[r]: rank
// r's card), and each card runs ONE cooperative launch of the TP step on
// its caller stream (callers[r], the same for every rank of a card) holding
// that card's ranks: every rank's partial planes are read by every rank (a
// peer's over NVLink: the caller enables peer access), and the barriers
// across ranks are grid barriers on one card and, across cards, flags in
// peer memory (wait_cards).  dense and int4 weights; the W8A8 build and
// W8A8 weights are refused (cudaErrorInvalidValue); so are arguments or a
// grid some card cannot take, before any card launches.  A wait across
// cards that timed out (a card whose launch never came) traps its kernel;
// later calls of this build return cudaErrorTimeout.
extern "C" int valle2_fused_step_tp(int verify, int dtype, int cache_dtype, int wfmt, int mp,
                                    void* const* ptrs, const int* cards, void* const* callers,
                                    int L, int rows, int S, int d, int da, int h, int dff,
                                    int index_or_qblk, int ttm, int pm, int groups_d,
                                    int groups_att, int groups_ff, int chunk, float scale) {
  if (wfmt != STEP_WF || STEP_WF == W8) return (int)cudaErrorInvalidValue;
  StepArgs s[MAX_MP];
  int err = tp_rank_args(verify, mp, ptrs, L, rows, S, d, da, h, dff, index_or_qblk, ttm, pm,
                         groups_d, groups_att, groups_ff, chunk, scale, s);
  if (err) return err;
  for (int r = 0; r < mp; ++r)
    if (!persistent_fits(s[r])) return (int)cudaErrorInvalidValue;
  Groups g;
  if ((err = g.init(mp, cards, callers))) return err;
  std::lock_guard<std::mutex> lock(g_tp_mutex);
  DeviceRestore restore;
  return with_types(dtype, cache_dtype, [&](auto t, auto tc) {
    return step_tp_persistent<typename decltype(t)::type, typename decltype(tc)::type>(s, mp,
                                                                                        g);
  });
}

// The TP step's launch on the current card for a rank of these widths (d
// the model's, da = d / mp and dff the rank's): its grid and dynamic shared
// memory, as valle2_fused_step_grid.
extern "C" int valle2_fused_step_tp_grid(int dtype, int cache_dtype, int wfmt, int hd, int d,
                                         int da, int dff, int* blocks, long* smem) {
  StepArgs s{};
  s.d = d;
  s.da = da;
  s.dff = dff;
  s.h = hd > 0 ? da / hd : 0;
  s.qblk = s.chunk = s.S = s.groups_d = s.groups_att = s.groups_ff = 1;
  if (wfmt != STEP_WF || STEP_WF == W8 || hd < 1 || da % hd || !persistent_fits(s))
    return (int)cudaErrorInvalidValue;
  return with_types(dtype, cache_dtype, [&](auto t, auto tc) {
    if constexpr (STEP_WF == W8) {
      return (int)cudaErrorInvalidValue;
    } else {
      const size_t bytes = persistent_smem(s, hd);
      *smem = (long)bytes;
      return (int)persistent_grid<typename decltype(t)::type, typename decltype(tc)::type,
                                  true>(bytes, blocks);
    }
  });
}

// The next TP launch of this build records its phase timestamps, card group
// i into bufs[i] (i < n; the groups in the order their cards first appear
// among the ranks), each 1 + 2 * np L * grid u64 with np its phases a
// layer, 7 or 8 (traced_barrier); a measurement hook, off by default and
// again after that launch (n = 0 turns it off).
extern "C" void valle2_fused_step_tp_trace(void* const* bufs, int n) {
  std::lock_guard<std::mutex> lock(g_tp_mutex);
  for (int i = 0; i < MAX_MP; ++i)
    g_tp_trace[i] = i < n ? static_cast<unsigned long long*>(bufs[i]) : nullptr;
}

// A test of the bound on the wait across cards (no path of the port calls
// it): on the current card, one thread waits at a barrier across cards for
// a second card that never launches, over two fresh flag arrays on this
// card; after CARD_WAIT_NS it sets the error word and traps, which loses
// this process's CUDA context: call it from a process of its own.  Returns
// the launch's error.
extern "C" int valle2_tp_wait_probe(void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = card_state(dev);
  TpStepArgs a{};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = cudaMalloc(&a.flags[i], MAX_GRID_CARDS * sizeof(unsigned long long));
    if (err == cudaSuccess)
      err = cudaMemset(a.flags[i], 0, MAX_GRID_CARDS * sizeof(unsigned long long));
    a.slot[i] = i;
  }
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&a.error), g_error, 0);
  if (err != cudaSuccess) return (int)err;
  a.epoch = 1, a.n_cards = 2, a.me = 0, a.mp = 2, a.n_local = 1;
  wait_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// 1 once a wait across cards of this build timed out (the host-mapped
// error word), else 0.
extern "C" int valle2_tp_timed_out() { return g_error ? *g_error : 0; }
#endif  // VALLE2_STEP_TP
