// #6, the fused decode step, and #7, the speculative verify step, each as
// ONE cooperative launch a step on one card (step_persistent_kernel in
// fused_decode.cuh; the design is in fused_decode.cu's header).  Built once
// per weight format, VALLE2_STEP_WF = 0 dense, 1 int8 W8A8, 2 int4 W4A16
// (kernels/_build.py), so that the three compile in parallel; each build
// instantiates the step for every compute and cache dtype, the head dim
// chosen in the kernel and the block length (qblk: 1 for #6, K for #7) a
// runtime argument, so #7 adds no instantiation.

#include "fused_decode.cuh"

#ifndef VALLE2_STEP_WF
#error "fused_step.cu is built with -DVALLE2_STEP_WF=0, 1 or 2"
#endif

namespace {

constexpr int STEP_WF = VALLE2_STEP_WF;
constexpr int MAX_GRID_CARDS = 32;       // cards whose grid size is cached
unsigned long long* g_trace = nullptr;   // valle2_fused_step_trace: the next launch's
                                         // (#6 or #7)
std::mutex g_trace_mutex;

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

// The grid of the persistent step on the current card: every block it can
// hold at once at `smem` bytes a block (SM count x blocks per SM), or an error
// when the card takes no cooperative launch or no such block.
template <typename T, typename TC>
cudaError_t persistent_grid(size_t smem, int* blocks) {
  auto kernel = step_persistent_kernel<T, TC, STEP_WF>;
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

// f(Tag<T>, Tag<TC>) for the compute and cache dtypes the step takes.
template <typename F>
int with_types(int dtype, int cache_dtype, F&& f) {
  if (dtype == 0 && cache_dtype == 0) return f(Tag<float>{}, Tag<float>{});
  if (dtype == 0 && cache_dtype == 1) return f(Tag<float>{}, Tag<__nv_bfloat16>{});
  if (dtype == 0 && cache_dtype == 2) return f(Tag<float>{}, Tag<int8_t>{});
  if (dtype == 1 && cache_dtype == 1) return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  if (dtype == 1 && cache_dtype == 2) return f(Tag<__nv_bfloat16>{}, Tag<int8_t>{});
  return (int)cudaErrorInvalidValue;
}

// The widths the persistent step takes: any block length on one card (da ==
// d), a head dim it instantiates, inputs up to max_k8.
bool persistent_fits(const StepArgs& s) {
  return !bad_args(s) && s.da == s.d && hd_taken(s.da / s.h) && s.d <= max_k8(STEP_WF) &&
         s.dff <= max_k8(STEP_WF);
}

// One persistent launch of the step s (#6 or #7) on `stream`.
int launch(int dtype, int cache_dtype, int wfmt, const StepArgs& s, void* stream) {
  if (wfmt != STEP_WF || !persistent_fits(s)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_types(dtype, cache_dtype, [&](auto t, auto tc) {
    return step_persistent<typename decltype(t)::type, typename decltype(tc)::type>(s, st);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cache_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8 (bf16 compute needs a bf16 or int8 cache); wfmt must be this
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
