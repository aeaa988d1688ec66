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
// #1: one block per (q-tile of 64 rows, batch*head); K/V tiles of 64 keys
// stream through shared memory, and the online softmax (running max,
// running sum, rescaled accumulator) stays in f32 registers.  Masked scores
// take the finite -1e30 sentinel and l is clamped at 1e-30, as in the
// Pallas kernel; keys past s (the ragged edge, which the TPU wrapper pads
// instead) contribute exactly zero.  kv tiles past the last key a q-tile can see are skipped (the
// Pallas _kv_block_bound), which is exact; a batch row with tokens_valid == 0
// walks every tile so that its fully masked query rows come out as the plain
// version's uniform average.
//
// #2, head-folded.  The TPU program batches every head of a (batch row,
// q-block) into one program, which pays off on a 128 x 128 MXU with a large
// VMEM.  On the H100 the same idea is spread over warpgroups and SMs: a
// work item is a (batch row, 64-row q-tile, group of heads), and a
// persistent grid of min(items, SMs x blocks an SM) blocks walks the items,
// heaviest first (a causal item's work is its kv-tile count).  The host
// chooses the group size (kernels/flash_attention.py fold_plan: the heads
// are split into groups only as far as needed to fill the card) and passes
// it with the grid; item i is q-tile q_tiles - 1 - i / (b groups), batch row
// i % (b groups) / groups, group i % groups, and a block takes the next
// item from a counter in device memory (zero at launch) whenever it is done
// with one, so the items go out in that order to whichever block is free:
// the work of an item also depends on its row's meta (a row with
// tokens_valid == 0 walks every tile), which the host does not read; a
// fixed assignment (block j: items j, j + grid, ...) kept the busiest
// block's consumers 1.4 times as long as the mean at the 204M shape on an
// H100 (clock64 counters).  What the TPU program computes once and
// broadcasts over heads is computed once per item here too: tokens_valid
// and kv_end, the kv tile bound, and each thread's query-row key ranges
// (RowRanges).
//
// bf16, on wgmma fed by TMA (flash_fold_tc_kernel).  A block of three
// warpgroups: a producer (setmaxnreg.dec to 40) and two consumers
// (setmaxnreg.inc to 232) that take the group's heads in turns, each a
// 64-row tile of its own head, so that while one does its softmax on the
// CUDA cores the other's products run on the tensor cores.  Each consumer
// has its own ring in shared memory, fed by its own producer thread (warp c
// of the producer warpgroup, lane 0), which walks (item, head, kv tile)
// without a break: Q once a head into one of two Q buffers, then K and V
// tiles of 64 keys into a ring of STAGES stages (4, or 2 at hd 128), with
// full mbarriers (the TMA bytes; K and V apart, so that S = Q K^T starts
// before V has landed) and an empty one (the consumer's four warps).  So a
// head boundary never drains the ring: the next head's Q and first tiles
// are in flight while the last tiles of this head are multiplied.  The TMA
// tensor maps are 3-D over (hd, s, b h), so rows past s arrive as zeros and
// the store clips them; the tiles carry the 128-byte swizzle (hd 64, 128:
// 64-column boxes, two at hd 128) or the 64-byte one (hd 32).  S = Q K^T is
// wgmma m64n64k16 with both operands in shared memory (K K-major); the mask
// is applied per accumulator element (skipped on a tile that both of a
// thread's rows see whole); P is rounded to bf16 and repacked from the S
// accumulators into the A operand of O += P V, wgmma m64n{hd}k16 with A in
// registers and V MN-major through the transpose bit.  Inside a consumer
// a tile's P V is left running while the next tile's S = Q K^T is issued
// behind it.  The online softmax, its rounding points and its order are
// #1's tensor-core route's (the same 64-key tiles, the same element
// ownership: wgmma's accumulator layout is mma.sync's, warp by warp, and O
// sees *= a tile's alpha, += its P V in turn): f32 running max and sum,
// l over the unrounded p, the -1e30
// sentinel, the 1e-30 clamp on l, -inf past s, and a batch row with
// tokens_valid == 0 walks every tile.  So #2 in bf16 is bit-equal to #1
// (chip_smoke.py, tests/test_torch_cuda.py).  O goes through a swizzled
// staging tile and a TMA store; lse by plain stores.
// What bounds it on this card: at the 204M training shape (b=16, h=16,
// s=640, hd 64, causal) it does about 165 operations per byte it must move,
// under the bf16 ridge (~295), so bytes (0.025 ms); but every q-tile of a
// head reads its K and V again (from L2), and each consumer walks its tiles
// in turn, so what it reaches is set by how well the two consumers keep the
// tensor cores fed.
//
// f32, on the CUDA cores (flash_fold_cc_kernel): the same item schedule,
// each head through #1's CUDA-core device function (attend_head_cc: the
// same tiles and per-row order), so #2 in f32 is bit-equal to #1.

// Two routes, chosen by dtype at dispatch:
//
// bf16, on the tensor cores (FlashAttention-2 on mma.sync).  What bounds it
// on this card: at the serving prefill (b=3, h=4, s=385, hd=64) and the
// serving-width training shape (b=32, h=4, s=640) the kernel does about 40
// products per byte it must move, so the bound is bytes; but each block walks
// its kv tiles in turn, and with the products on the CUDA cores (the first
// design, since redesigned as the f32 route) the f32 FMAs were the time
// (0.706 ms against SDPA's 0.137 at b=32, s=640 on an H100 80GB HBM3 at
// 700 W, chip_smoke.py).
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
// f32, on the CUDA cores (attend_head_cc; bf16 takes it too, for timing
// only): products in f32 FFMAs with f32 accumulation, p rounded to the input
// dtype before P V (a no-op in f32).  The tensor cores have no full-f32
// product (TF32 keeps 10 mantissa bits), and f32 with TF32 off is the parity
// setting.  The products are register micro-tiles fed by float4 shared reads
// (csrc/cc_tiles.cuh, shared with the f32 backward): a block of 4 warps
// (8 at hd 128) takes a q-tile of 64 rows; a thread holds 4 x 8 of S = Q K^T
// and 4 x HD / 8 of O (2 x 8 and 2 x 16 at hd 128), so an FFMA of S or of
// P V costs 0.375 floats read from shared memory, where the first design
// read one a FFMA and ran at the shared-memory pipe's rate.  Q, K and V are
// f32 tiles of row stride HD + 4, staged by cp.async 16 bytes a thread and
// zero-filled past s (the wrapper refuses inputs that are not 16-byte
// aligned).  One buffer each of K and V: V of tile kb loads while S and the
// softmax run, K of tile kb + 1 while P V does, two barriers a tile; at hd
// 64 a block takes 70 KB and three share an SM (two stages of both would
// take 104 KB, two blocks).  A row's 64 keys are 8 lanes of one warp: its
// max and sum are shuffles, and its p row ([64][68] f32 tile) is written
// and read by that warp alone.  The softmax runs in the log2 domain (x = S
// scale log2e, p = exp2f(x - m): one MUFU.EX2 where expf adds a range
// reduction), the mask is selected, not branched, and skipped where every
// row of a thread sees every key of its 8; the last q-tiles start first.
// What bounds it on this card: FFMA at 67 TFLOP/s (at b=32, h=4, s=640, hd
// 64 bidirectional its products take 0.177 ms at that rate, the bytes it
// must move 0.025 ms).  Measured on an H100 80GB HBM3 at 700 W
// (probes/train_ab.py, in turns with the first design in one call): at
// b=32, h=4, s=640 0.248-0.257 ms causal and 0.396-0.415 bidirectional, at
// b=8, s=1280 causal 0.244-0.248, 38-45% of the FFMA bound, 2.3-3.4x the
// first design and 1.45-2.54x faster than scaled_dot_product_attention's
// f32 forward (0.58-0.62 ms); #2 at b=16, h=16, s=640 0.526-0.536 ms
// against 1.28-1.31.  On the device (probes/fwd_ablate.py) P V takes
// 28-33% of the time, the softmax 4-6%, the loads of the next tiles 1-6%,
// the mask 0-1%; q-tiles of 128 rows (8 x 8 a thread, two blocks an SM) were 3-23%
// slower: fewer, larger blocks leave the last wave of a causal grid part
// empty.
//
#include <stdint.h>

#include <type_traits>

#include "cc_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace valle2;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;         // q rows per block (bf16 routes)
constexpr int BK = 64;         // keys per kv tile
// bf16 route (tensor cores)
constexpr int TC_WARPS = BQ / 16;      // one warp per 16 query rows
constexpr int NT_TC = 32 * TC_WARPS;   // 128 threads

template <int HD>
constexpr size_t tc_smem_bytes() {   // Q, and two stages each of K and V
  return sizeof(bf16) * (BQ + 4 * BK) * (HD + TILE_PAD);
}

// f32 route (CUDA cores): q rows per tile, at every head dim (#2's f32 item
// schedule takes the same tile: kernels/flash_attention.py FOLD_BQ).
constexpr int BQ_CC = 64;

// The CUDA-core route's block at head dim HD.  Thread t of warp w holds the
// q rows tm + MS i (tm = 4 w + lane % 4, i < TM) and, of a 64-key tile, the
// keys tn + 8 j (tn = lane / 4, j < 8): a row's 64 keys are the 8 lanes of
// one warp that share lane % 4, so its max and sum are three shuffles, and
// its p row is written and read by that warp alone.  Its outputs are the
// same rows at dims 4 tn + 32 jb + (0..3).  Up to hd 64: 4 warps, 4 x 8 of S
// and 4 x HD / 8 of O a thread, three blocks an SM; at hd 128: 8 warps, 2 x 8
// and 2 x 16, one block an SM.
template <int HD>
struct CcFwd {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head dim 32, 64 or 128");
  static constexpr int W = HD <= 64 ? 4 : 8;
  static constexpr int NT = 32 * W;
  static constexpr int MINB = HD <= 64 ? 3 : 1;
  static constexpr int RS = HD + 4;        // row stride of Q, K, V (cc_tiles.cuh)
  static constexpr int MS = 4 * W;         // row step of a thread's rows
  static constexpr int TM = BQ_CC / MS;    // q rows a thread holds
  static constexpr int TN = HD / 8;        // output dims a thread holds
  // Q [BQ_CC][RS], K and V [64][RS] (one buffer each), p [BQ_CC][PS]
  static constexpr size_t SMEM = sizeof(float) * ((BQ_CC + 2 * CC_KEYS) * RS + BQ_CC * PS);
  static_assert(SMEM * MINB + 1024 * MINB <= 233472, "MINB blocks must fit an SM");
};

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

// kv tiles a q-tile of TQ rows walks: up to the last key any of its rows can
// see, or every tile when the batch row has no visible source key.
template <int TQ = BQ>
__device__ __forceinline__ int kv_tile_bound(int q_blk, int s, int tokens_valid, int kv_end,
                                             int causal) {
  const int all_tiles = (s + BK - 1) / BK;
  if (tokens_valid <= 0) return all_tiles;
  const int vis_end = causal ? max(tokens_valid, min((q_blk + 1) * TQ, kv_end)) : kv_end;
  return min(all_tiles, (vis_end + BK - 1) / BK);
}

// The key ranges of the query rows whose values a thread of the tensor-core
// route holds: rows gid and gid + 8 of the warp's 16.
struct ThreadRows {
  RowRanges r[2];
};

__device__ __forceinline__ ThreadRows thread_rows(int q_blk, int tokens_valid, int kv_end,
                                                  int tokens_total, int causal) {
  ThreadRows tr;
  const int row = q_blk * BQ + threadIdx.x / 32 * 16 + threadIdx.x % 32 / 4;
  tr.r[0] = row_ranges(row, tokens_valid, kv_end, tokens_total, causal);
  tr.r[1] = row_ranges(row + 8, tokens_valid, kv_end, tokens_total, causal);
  return tr;
}

// What the CUDA-core route's mask needs of a batch row: a row qi sees the
// keys [0, src_end) and [aud_lo, causal ? min(kv_end, qi + 1) : kv_end).
struct CcMask {
  int src_end, aud_lo, kv_end, causal;
};

__device__ __forceinline__ CcMask cc_mask(int tokens_valid, int kv_end, int tokens_total,
                                          int causal) {
  return {min(tokens_valid, kv_end), tokens_total, kv_end, causal};
}

// The online softmax of one 64-key S tile in the log2 domain.  sc[i][j]
// (row q0 + tm + MS i, key k0 + tn + 8 j) becomes x = S scale log2e where the
// row sees the key, the -1e30 sentinel where it does not and -inf past s
// (selected, no branch an element; no mask at all where every row of the
// thread sees every key of its 8); each row's m and l are updated over the 8
// lanes that hold it, alpha = 2^(m_old - m_new) is the rescale of O, and p =
// 2^(x - m_new), summed unrounded into l and rounded to T, goes to
// P[row][key].  Every product here and in attend_head_cc is __fmul_rn or
// fmaf: #1 and #2 inline the body in other kernels, and no multiply-add may
// be contracted in one and not in the other.
template <typename T, int TM, int MS>
__device__ __forceinline__ void cc_softmax(float (&sc)[TM][8], float (&m)[TM], float (&l)[TM],
                                           float (&alpha)[TM], float* P, int tm, int tn, int q0,
                                           int k0, int s, const CcMask& mk, float scale_log2) {
  const int kmin = k0 + tn, kmax = kmin + 56, row0 = q0 + tm;
  const int hi0 = mk.causal ? min(mk.kv_end, row0 + 1) : mk.kv_end;   // rows rise with i
  const bool whole =
      (kmax < s) & ((kmax < mk.src_end) | ((kmin >= mk.aud_lo) & (kmax < hi0)));
  if (whole) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = __fmul_rn(sc[i][j], scale_log2);
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qi = row0 + MS * i;
      const int hi = mk.causal ? min(mk.kv_end, qi + 1) : mk.kv_end;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = kmin + 8 * j;
        const bool seen = (key < mk.src_end) | ((key >= mk.aud_lo) & (key < hi));
        const float x = __fmul_rn(sc[i][j], scale_log2);
        sc[i][j] = key >= s ? -INFINITY : (seen ? x : NEG_INF);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float mloc = sc[i][0];
#pragma unroll
    for (int j = 1; j < 8; ++j) mloc = fmaxf(mloc, sc[i][j]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, off));
    const float m_new = fmaxf(m[i], mloc);
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = exp2f(sc[i][j] - m_new);
      psum += p;
      P[(tm + MS * i) * PS + tn + 8 * j] = round_to<T>(p);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l[i] = fmaf(l[i], alpha[i], psum);
  }
}

// CUDA-core route: one head of one q-tile of BQ_CC rows, the online softmax
// over n_tiles kv tiles (the design is in the header).  bh is the
// (batch*head) index of q, k, v, o and lse.  #1 and #2 both run it.
template <typename T, int HD>
__device__ __forceinline__ void attend_head_cc(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, T* __restrict__ o,
                                               float* __restrict__ lse, int bh, int s,
                                               int q_blk, int n_tiles, const CcMask& mk,
                                               float scale_log2, float* smem) {
  using C = CcFwd<HD>;
  constexpr int RS = C::RS, NT = C::NT, TM = C::TM, MS = C::MS, TN = C::TN;
  float* Qs = smem;                  // [BQ_CC][RS]
  float* Ks = Qs + BQ_CC * RS;       // [64][RS]
  float* Vs = Ks + CC_KEYS * RS;     // [64][RS]
  float* Ps = Vs + CC_KEYS * RS;     // [BQ_CC][PS]: p of the tile, [q][key]
  const int lane = threadIdx.x % 32;
  const int tm = (lane & 3) + 4 * (threadIdx.x / 32), tn = lane >> 2;
  const size_t base = (size_t)bh * s * HD;
  const int q0 = q_blk * BQ_CC;

  __syncthreads();   // a previous head's last tile is no longer read
  stage_rows<T, HD, BQ_CC, NT>(Qs, q + base, q0, s);
  if (n_tiles > 0) stage_rows<T, HD, CC_KEYS, NT>(Ks, k + base, 0, s);
  cp_async_commit();

  float m[TM], l[TM], acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF, l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  // One buffer each of K and V: V of tile kb loads while S = Q K^T and the
  // softmax run, K of tile kb + 1 while O += P V does.
  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * CC_KEYS;
    cp_async_wait<0>();
    __syncthreads();   // K of tile kb (and Q) landed; V of tile kb - 1 is no longer read
    stage_rows<T, HD, CC_KEYS, NT>(Vs, v + base, k0, s);
    cp_async_commit();
    float sc[TM][8];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    rows_dot<HD, TM, MS>(Qs, Ks, tm, tn, sc);
    float alpha[TM];
    cc_softmax<T, TM, MS>(sc, m, l, alpha, Ps, tm, tn, q0, k0, s, mk, scale_log2);
    cp_async_wait<0>();
    __syncthreads();   // V of tile kb landed and p written; K of tile kb is no longer read
    if (kb + 1 < n_tiles) stage_rows<T, HD, CC_KEYS, NT>(Ks, k + base, k0 + CC_KEYS, s);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha[i]);
    rows_times<HD, TM, TN, MS, 32>(Ps, Vs, tm, tn, acc);
  }
  cp_async_wait<0>();

  // o = acc / l, 16 bytes a thread (f32; 8 in bf16); lse in natural units
  // (a row that sees no key keeps the -1e30 sentinel as its max).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qi = q0 + tm + MS * i;
    if (qi >= s) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + base + (size_t)qi * HD + 4 * tn;
#pragma unroll
    for (int jb = 0; jb < TN / 4; ++jb)
      store4<T>(orow + 32 * jb, acc[i][4 * jb] / l_safe, acc[i][4 * jb + 1] / l_safe,
                acc[i][4 * jb + 2] / l_safe, acc[i][4 * jb + 3] / l_safe);
    if (tn == 0)
      lse[(size_t)bh * s + qi] =
          m[i] == NEG_INF ? NEG_INF + logf(l_safe) : fmaf(m[i], LN2, logf(l_safe));
  }
}

// bf16 route: one head of one q-tile on the tensor cores (the design is in
// the header).
template <int HD>
__device__ __forceinline__ void attend_head_tc(const bf16* __restrict__ q,
                                               const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, bf16* __restrict__ o,
                                               float* __restrict__ lse, int bh, int s,
                                               int q_blk, int n_tiles,
                                               const ThreadRows& rr, float sm_scale,
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

// #1 on the tensor cores (bf16): grid (q-tiles, b*h).
template <int HD>
__global__ void __launch_bounds__(NT_TC)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ meta, bf16* __restrict__ o,
                 float* __restrict__ lse, int h, int s, int tokens_total, int causal,
                 float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_blk = blockIdx.x, bh = blockIdx.y, b = bh / h;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int n_tiles = kv_tile_bound(q_blk, s, tokens_valid, kv_end, causal);
  const ThreadRows rr = thread_rows(q_blk, tokens_valid, kv_end, tokens_total, causal);
  attend_head_tc<HD>(q, k, v, o, lse, bh, s, q_blk, n_tiles, rr, sm_scale,
                     reinterpret_cast<bf16*>(smem));
}

// #1 on the CUDA cores: grid (b*h, q-tiles), the last q-tiles (when causal
// the heaviest) first.
template <typename T, int HD>
__global__ void __launch_bounds__(CcFwd<HD>::NT, CcFwd<HD>::MINB)
flash_fwd_cc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ meta, T* __restrict__ o, float* __restrict__ lse,
                    int h, int s, int tokens_total, int causal, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_blk = gridDim.y - 1 - blockIdx.y, bh = blockIdx.x, b = bh / h;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int n_tiles = kv_tile_bound<BQ_CC>(q_blk, s, tokens_valid, kv_end, causal);
  attend_head_cc<T, HD>(q, k, v, o, lse, bh, s, q_blk, n_tiles,
                        cc_mask(tokens_valid, kv_end, tokens_total, causal), sm_scale * LOG2E,
                        reinterpret_cast<float*>(smem));
}

// ---- #2 ----

// Item i of #2's schedule (heaviest first: the last q-tiles first).
struct FoldItem {
  int b, q_blk, g;
};

__device__ __forceinline__ FoldItem fold_item(int i, int b, int groups, int q_tiles) {
  const int per_tile = b * groups, r = i % per_tile;
  return {r / groups, q_tiles - 1 - i / per_tile, r % groups};
}

// #2 in f32: a persistent grid over the items (q-tiles of BQ_CC rows),
// taken in order from `counter` (zero at launch), each head through
// attend_head_cc.
template <int HD>
__global__ void __launch_bounds__(CcFwd<HD>::NT, CcFwd<HD>::MINB)
flash_fold_cc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ meta,
                     float* __restrict__ o, float* __restrict__ lse, int b, int h, int s,
                     int tokens_total, int causal, float sm_scale, int groups, int n_items,
                     int* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next;
  const int q_tiles = (s + BQ_CC - 1) / BQ_CC, gsize = h / groups;
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(counter, 1);
    __syncthreads();
    const int i = next;
    __syncthreads();   // every thread has read it before thread 0 takes the next
    if (i >= n_items) break;
    const FoldItem it = fold_item(i, b, groups, q_tiles);
    // Once per item, for every head of its group.
    const int tokens_valid = meta[2 * it.b], kv_end = meta[2 * it.b + 1];
    const int n_tiles = kv_tile_bound<BQ_CC>(it.q_blk, s, tokens_valid, kv_end, causal);
    const CcMask mk = cc_mask(tokens_valid, kv_end, tokens_total, causal);
    for (int hh = 0; hh < gsize; ++hh)
      attend_head_cc<float, HD>(q, k, v, o, lse, it.b * h + it.g * gsize + hh, s, it.q_blk,
                                n_tiles, mk, sm_scale * LOG2E, reinterpret_cast<float*>(smem));
  }
}

namespace fold {

using namespace valle2::hopper;

constexpr int THREADS = 384;   // the producer warpgroup, then two consumer warpgroups
// setmaxnreg: 168 registers a thread at launch (65536 / 384), then 128 x 40
// + 256 x 232 = 64512.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// The shared memory of a block at head dim HD.  Each consumer has Q[2],
// K[STAGES], V[STAGES] and its staging tile of O, every tile 64 rows x HD
// bf16 in TMA boxes of BOX_COLS columns (one swizzle row), then its
// barriers.
template <int HD>
struct Cfg {
  static constexpr int STAGES = HD == 128 ? 2 : 4;
  static constexpr int BOX_COLS = HD < 64 ? HD : 64;
  static constexpr int ROW_BYTES = BOX_COLS * 2;
  static constexpr uint32_t BOX_BYTES = 64 * ROW_BYTES;
  static constexpr uint32_t TILE = 64 * HD * 2;
  static constexpr int TILES = 3 + 2 * STAGES;
  static constexpr int BARS = 4 + 3 * STAGES;
  // ... and the item ring shared by the block: [2] item indices, their full
  // and empty barriers.
  static constexpr size_t SMEM =
      1024 + 2 * ((size_t)TILES * TILE + BARS * sizeof(uint64_t)) + 4 * sizeof(uint64_t) +
      2 * sizeof(int);
  static_assert(HD == 32 || HD == 64 || HD == 128, "head dims 32, 64, 128");
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// One consumer's ring: its tiles and barriers.
template <int HD>
struct Ring {
  using C = Cfg<HD>;
  uint8_t* q;         // [2][TILE]
  uint8_t* k;         // [STAGES][TILE]
  uint8_t* v;         // [STAGES][TILE]
  uint8_t* staging;   // [TILE], O on its way out
  uint64_t* full_q;   // [2]: the producer's arrival and the TMA bytes
  uint64_t* empty_q;  // [2]: one arrival per consumer warp
  uint64_t* full_k;   // [STAGES]
  uint64_t* full_v;   // [STAGES]
  uint64_t* empty;    // [STAGES]: one arrival per consumer warp

  // base: the block's 1024-aligned shared memory; c: the consumer.
  __device__ __forceinline__ Ring(uint8_t* base, int c) {
    q = base + (size_t)c * C::TILES * C::TILE;
    k = q + 2 * C::TILE;
    v = k + C::STAGES * C::TILE;
    staging = v + C::STAGES * C::TILE;
    full_q = reinterpret_cast<uint64_t*>(base + 2 * (size_t)C::TILES * C::TILE) + c * C::BARS;
    empty_q = full_q + 2;
    full_k = empty_q + 2;
    full_v = full_k + C::STAGES;
    empty = full_v + C::STAGES;
  }

  __device__ __forceinline__ void init() const {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_q[i], 1);
      mbar_init(&empty_q[i], 4);
    }
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty[i], 4);
    }
  }
};

// The 64 rows from row0 of head bh of `map` into the tile at dst, one box
// per BOX_COLS columns.
template <int HD>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, uint8_t* dst, uint64_t* bar,
                                          int row0, int bh) {
  using C = Cfg<HD>;
#pragma unroll
  for (int j = 0; j < HD / C::BOX_COLS; ++j)
    tma_load_3d(dst + j * C::BOX_BYTES, map, bar, j * C::BOX_COLS, row0, bh);
}

// Descriptor of k16 step kd of a K-major tile (Q as A, K as B): 32 bytes on
// inside a swizzle row, the next box after BOX_COLS columns.
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kd) {
  using C = Cfg<HD>;
  const uint32_t a = tile + (kd * 16 / C::BOX_COLS) * C::BOX_BYTES + (kd * 16 % C::BOX_COLS) * 2;
  return HD == 32 ? smem_desc_sw64(a, 16, 512) : smem_desc_sw128(a, 16, 1024);
}

// Descriptor of k16 step kk (keys 16 kk ..) of the MN-major V tile: 16 rows
// on; column boxes BOX_BYTES apart, 8-row k groups 8 rows apart.
template <int HD>
__device__ __forceinline__ uint64_t vmajor_desc(uint32_t tile, int kk) {
  using C = Cfg<HD>;
  const uint32_t a = tile + kk * 16 * C::ROW_BYTES;
  return HD == 32 ? smem_desc_sw64(a, C::BOX_BYTES, 8 * C::ROW_BYTES)
                  : smem_desc_sw128(a, C::BOX_BYTES, 8 * C::ROW_BYTES);
}

// The byte offset of (row, column pair at col) in a swizzled tile: the
// layout a TMA load with the tile's swizzle writes.
template <int HD>
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  using C = Cfg<HD>;
  const int box = col / C::BOX_COLS, cb = col % C::BOX_COLS;
  const int chunk = cb / 8, sw = HD == 32 ? (row >> 1) & 3 : row & 7;
  return box * C::BOX_BYTES + row * C::ROW_BYTES + ((chunk ^ sw) * 16) + cb % 8 * 2;
}

}  // namespace fold

// The online softmax of one 64-key S tile, #1's tensor-core route's
// arithmetic in its order: sc (sc[4 nt + e] is #1's sc[nt][e]: row gid + 8
// (e / 2), key 2 tig + e % 2 of n-tile nt) is masked and scaled in place;
// m and l are updated, alpha is the rescale of O, and pa the bf16 A operand
// of P V (k16 step kk is n-tiles 2 kk and 2 kk + 1).  A tile that every
// key of both rows sees skips the per-element mask (the same values).
__device__ __forceinline__ void fold_softmax(float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             int kb, int s, const RowRanges (&rr)[2],
                                             float sm_scale, int tig) {
  constexpr int NK = BK / 8;
  const int k0 = kb * BK, k1 = k0 + BK;
  const auto sees_all = [&](const RowRanges& r) {
    return k1 <= s && (k1 <= r.src_end || (k0 >= r.aud_lo && k1 <= r.aud_hi));
  };
  float mloc[2] = {NEG_INF, NEG_INF};
  if (sees_all(rr[0]) && sees_all(rr[1])) {
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * nt + e] *= sm_scale;
        mloc[e >> 1] = fmaxf(mloc[e >> 1], sc[4 * nt + e]);
      }
  } else {
    // sees() without its short-circuit: the same values, selected, where
    // the || and && of #1's form compile to a branch an element.
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const RowRanges& r = rr[e >> 1];
        const int key = k0 + nt * 8 + tig * 2 + (e & 1);
        const bool seen = (key < r.src_end) | ((key >= r.aud_lo) & (key < r.aud_hi));
        const float scaled = sc[4 * nt + e] * sm_scale;
        const float x = key >= s ? -INFINITY : (seen ? scaled : NEG_INF);
        sc[4 * nt + e] = x;
        mloc[e >> 1] = fmaxf(mloc[e >> 1], x);
      }
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    mloc[ri] = fmaxf(mloc[ri], __shfl_xor_sync(0xffffffffu, mloc[ri], 1));
    mloc[ri] = fmaxf(mloc[ri], __shfl_xor_sync(0xffffffffu, mloc[ri], 2));
    const float m_new = fmaxf(m[ri], mloc[ri]);
    alpha[ri] = expf(m[ri] - m_new);
    m[ri] = m_new;
  }
  // p = exp(s - m): summed unrounded into l, rounded to bf16 into pa.
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NK; ++nt) {
    const float p0 = expf(sc[4 * nt] - m[0]), p1 = expf(sc[4 * nt + 1] - m[0]);
    const float p2 = expf(sc[4 * nt + 2] - m[1]), p3 = expf(sc[4 * nt + 3] - m[1]);
    psum[0] += p0 + p1;
    psum[1] += p2 + p3;
    pa[nt / 2][(nt & 1) * 2] = pack_bf16(p0, p1);
    pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    psum[ri] += __shfl_xor_sync(0xffffffffu, psum[ri], 1);
    psum[ri] += __shfl_xor_sync(0xffffffffu, psum[ri], 2);
    // An explicit FMA, as #1's compiled l * alpha + psum is.
    l[ri] = fmaf(l[ri], alpha[ri], psum[ri]);
  }
}

// #2 in bf16: the persistent, warp-specialised kernel (the design is in the
// header).  Maps over (hd, s, b h) of q, k, v and o.
template <int HD>
__global__ void __launch_bounds__(fold::THREADS, 1)
flash_fold_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                     const int* __restrict__ meta, float* __restrict__ lse, int b, int h, int s,
                     int tokens_total, int causal, float sm_scale, int groups, int n_items,
                     int* __restrict__ counter) {
  using namespace fold;
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // The item ring: producer 0 takes the next item from `counter` (zero at
  // launch, so items go out in the schedule's order, heaviest first, to
  // whichever block is free) and publishes it; producer 1 and the consumers
  // read it.  An index past the last item ends every role.
  uint64_t* item_full = reinterpret_cast<uint64_t*>(
      base + 2 * ((size_t)C::TILES * C::TILE + C::BARS * sizeof(uint64_t)));
  uint64_t* item_empty = item_full + 2;
  volatile int* items = reinterpret_cast<volatile int*>(item_empty + 2);
  if (threadIdx.x == 0) {
    Ring<HD>(base, 0).init();
    Ring<HD>(base, 1).init();
    for (int d = 0; d < 2; ++d) {
      mbar_init(&item_full[d], 1);
      mbar_init(&item_empty[d], 9);   // producer 1 and the eight consumer warps
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int q_tiles = (s + BQ - 1) / BQ, gsize = h / groups;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // The producer: lane 0 of warp c feeds consumer c.
    setmaxnreg_dec<PRODUCER_REGS>();
    const int c = threadIdx.x / 32;
    if (c < 2 && threadIdx.x % 32 == 0) {
      const Ring<HD> r(base, c);
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      uint32_t it = 0, qn = 0;
      for (uint32_t n = 0;; ++n) {
        const uint32_t d = n & 1, use = (n >> 1) & 1;
        int i;
        if (c == 0) {
          mbar_wait(&item_empty[d], use ^ 1);
          i = atomicAdd(counter, 1);
          items[d] = i;
          mbar_arrive(&item_full[d]);
        } else {
          mbar_wait(&item_full[d], use);
          i = items[d];
          mbar_arrive(&item_empty[d]);
        }
        if (i >= n_items) break;
        const FoldItem fi = fold_item(i, b, groups, q_tiles);
        const int n_tiles =
            kv_tile_bound(fi.q_blk, s, meta[2 * fi.b], meta[2 * fi.b + 1], causal);
        for (int hh = c; hh < gsize; hh += 2, ++qn) {
          const int bh = fi.b * h + fi.g * gsize + hh;
          const uint32_t qs = qn & 1;
          mbar_wait(&r.empty_q[qs], ((qn >> 1) & 1) ^ 1);
          mbar_arrive_expect_tx(&r.full_q[qs], C::TILE);
          load_tile<HD>(&tq, r.q + qs * C::TILE, &r.full_q[qs], fi.q_blk * BQ, bh);
          for (int kb = 0; kb < n_tiles; ++kb, ++it) {
            const uint32_t st = it % C::STAGES, parity = (it / C::STAGES) & 1;
            mbar_wait(&r.empty[st], parity ^ 1);
            mbar_arrive_expect_tx(&r.full_k[st], C::TILE);
            load_tile<HD>(&tk, r.k + st * C::TILE, &r.full_k[st], kb * BK, bh);
            mbar_arrive_expect_tx(&r.full_v[st], C::TILE);
            load_tile<HD>(&tv, r.v + st * C::TILE, &r.full_v[st], kb * BK, bh);
          }
        }
      }
    }
    return;
  }

  // A consumer: heads c, c + 2, ... of each item's group.
  setmaxnreg_inc<CONSUMER_REGS>();
  constexpr int ND = HD / 8;   // n-tiles of O
  const int c = wg - 1, t = threadIdx.x % 128;
  const int lane = t % 32, warp = t / 32, gid = lane / 4, tig = lane % 4;
  const Ring<HD> r(base, c);
  if (t == 0) prefetch_tensormap(&to);
  uint32_t it = 0, qn = 0;
  for (uint32_t n = 0;; ++n) {
    const uint32_t d = n & 1;
    mbar_wait(&item_full[d], (n >> 1) & 1);
    const int i = items[d];
    __syncwarp();
    if (lane == 0) mbar_arrive(&item_empty[d]);
    if (i >= n_items) break;
    const FoldItem fi = fold_item(i, b, groups, q_tiles);
    // Once per item, for every head of its group: the row's meta, the tile
    // bound, this thread's two query rows' key ranges.
    const int tokens_valid = meta[2 * fi.b], kv_end = meta[2 * fi.b + 1];
    const int n_tiles = kv_tile_bound(fi.q_blk, s, tokens_valid, kv_end, causal);
    const int row = fi.q_blk * BQ + warp * 16 + gid;
    const RowRanges rr[2] = {row_ranges(row, tokens_valid, kv_end, tokens_total, causal),
                             row_ranges(row + 8, tokens_valid, kv_end, tokens_total, causal)};
    for (int hh = c; hh < gsize; hh += 2, ++qn) {
      const int bh = fi.b * h + fi.g * gsize + hh;
      const uint32_t qs = qn & 1;
      const uint32_t q_tile = smem_addr(r.q + qs * C::TILE);
      mbar_wait(&r.full_q[qs], (qn >> 1) & 1);
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      float acc[HD / 2];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
      // O += P V of tile kb is left running: the next tile's S = Q K^T is
      // issued behind it, and both are waited on together before that
      // tile's softmax.  Every wgmma of the loop is on its straight path (a
      // wgmma under a branch makes the compiler serialise them all).  O sees
      // #1's order of operations: *= a tile's alpha, += its P V, in turn.
      uint32_t pa[BK / 16][4];
      for (int kb = 0; kb < n_tiles; ++kb, ++it) {
        const uint32_t st = it % C::STAGES, parity = (it / C::STAGES) & 1;
        float sc[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
        fence_regs(sc);
        mbar_wait(&r.full_k[st], parity);
        wgmma_fence();
        const uint32_t k_tile = smem_addr(r.k + st * C::TILE);
#pragma unroll
        for (int kd = 0; kd < HD / 16; ++kd)
          wgmma_m64n64k16<0>(sc, kmajor_desc<HD>(q_tile, kd), kmajor_desc<HD>(k_tile, kd));
        wgmma_commit();
        wgmma_wait<0>();   // S_kb, and the previous tile's P V
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pa);
        if (kb > 0 && lane == 0) mbar_arrive(&r.empty[(it - 1) % C::STAGES]);
        float alpha[2];
        fold_softmax(sc, pa, m, l, alpha, kb, s, rr, sm_scale, tig);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          acc[4 * nd] *= alpha[0];
          acc[4 * nd + 1] *= alpha[0];
          acc[4 * nd + 2] *= alpha[1];
          acc[4 * nd + 3] *= alpha[1];
        }
        mbar_wait(&r.full_v[st], parity);
        fence_regs(acc);
        fence_regs(pa);
        wgmma_fence();
        const uint32_t v_tile = smem_addr(r.v + st * C::TILE);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<HD, 1>(acc, pa[kk], vmajor_desc<HD>(v_tile, kk));
        wgmma_commit();
      }
      wgmma_wait<0>();   // the last tile's P V
      fence_regs(acc);
      fence_regs(pa);
      if (n_tiles > 0 && lane == 0) mbar_arrive(&r.empty[(it - 1) % C::STAGES]);
      if (lane == 0) mbar_arrive(&r.empty_q[qs]);   // this warp's products have read Q

      // Epilogue: O = acc / l as bf16 through the staging tile (written again
      // only once the previous head's store has read it), lse by plain
      // stores.
      const int bar = 1 + c;
      if (t == 0) bulk_wait_read<0>();
      named_barrier_sync(bar, 128);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const float l_safe = fmaxf(l[ri], 1e-30f);
        const int tr = warp * 16 + gid + 8 * ri;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
          *reinterpret_cast<uint32_t*>(r.staging + swizzled<HD>(tr, nd * 8 + tig * 2)) =
              pack_bf16(acc[4 * nd + 2 * ri] / l_safe, acc[4 * nd + 2 * ri + 1] / l_safe);
        const int qi = fi.q_blk * BQ + tr;
        if (tig == 0 && qi < s) lse[(size_t)bh * s + qi] = m[ri] + logf(l_safe);
      }
      fence_proxy_async_smem();
      named_barrier_sync(bar, 128);
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < HD / C::BOX_COLS; ++j)
          tma_store_3d(&to, r.staging + j * C::BOX_BYTES, j * C::BOX_COLS, fi.q_blk * BQ, bh);
        bulk_commit();
      }
    }
  }
  if (t == 0) bulk_wait<0>();   // O is written before the block ends
}

// A (b h, s, hd) bf16 tensor at ptr, read and written in boxes of 64 rows x
// BOX_COLS columns with the tile's swizzle.
template <int HD>
cudaError_t fold_map(CUtensorMap* map, const void* ptr, int bh, int s) {
  using C = fold::Cfg<HD>;
  hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * sizeof(bf16), (cuuint64_t)s * HD * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)C::BOX_COLS, 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      HD == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// #2's kernel at dtype (0 f32, 1 bf16) and HD, its shared memory bytes.
template <int HD>
size_t fold_smem(int dtype) {
  return dtype == 0 ? CcFwd<HD>::SMEM : fold::Cfg<HD>::SMEM;
}

template <int HD>
cudaError_t fold_configure(int dtype) {
  static unsigned configured[2] = {0, 0};   // one bit per card, per dtype
  return once_per_device(configured[dtype], [&] {
    return dtype == 0 ? cudaFuncSetAttribute(flash_fold_cc_kernel<HD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)fold_smem<HD>(0))
                      : cudaFuncSetAttribute(flash_fold_tc_kernel<HD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)fold_smem<HD>(1));
  });
}

template <int HD>
int fold_blocks_per_sm(int dtype, int* blocks) {
  cudaError_t err = fold_configure<HD>(dtype);
  if (err != cudaSuccess) return (int)err;
  return dtype == 0 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, flash_fold_cc_kernel<HD>, CcFwd<HD>::NT, fold_smem<HD>(0))
                    : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          blocks, flash_fold_tc_kernel<HD>, fold::THREADS, fold_smem<HD>(1));
}

template <int HD>
int launch_fold(const void* q, const void* k, const void* v, const int* meta, void* o,
                float* lse, int b, int h, int s, int tokens_total, int causal, int dtype,
                float sm_scale, int groups, int grid, int* counter, cudaStream_t stream) {
  if (groups < 1 || h % groups != 0 || grid < 1) return (int)cudaErrorInvalidValue;
  const int tile_q = dtype == 0 ? BQ_CC : BQ;   // the q rows of an item
  const int n_items = b * ((s + tile_q - 1) / tile_q) * groups;
  cudaError_t err = fold_configure<HD>(dtype);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    flash_fold_cc_kernel<HD><<<grid, CcFwd<HD>::NT, fold_smem<HD>(0), stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), meta, static_cast<float*>(o), lse, b, h, s,
        tokens_total, causal, sm_scale, groups, n_items, counter);
    return (int)cudaGetLastError();
  }
  CUtensorMap tq, tk, tv, to;
  err = fold_map<HD>(&tq, q, b * h, s);
  if (err == cudaSuccess) err = fold_map<HD>(&tk, k, b * h, s);
  if (err == cudaSuccess) err = fold_map<HD>(&tv, v, b * h, s);
  if (err == cudaSuccess) err = fold_map<HD>(&to, o, b * h, s);
  if (err != cudaSuccess) return (int)err;
  flash_fold_tc_kernel<HD><<<grid, fold::THREADS, fold_smem<HD>(1), stream>>>(
      tq, tk, tv, to, meta, lse, b, h, s, tokens_total, causal, sm_scale, groups, n_items,
      counter);
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool TCR>
int launch(const void* q, const void* k, const void* v, const int* meta, void* o, float* lse,
           int b, int h, int s, int tokens_total, int causal, float sm_scale,
           cudaStream_t stream) {
  static unsigned configured = 0;   // one bit per card
  if constexpr (TCR) {
    constexpr size_t smem = tc_smem_bytes<HD>();
    cudaError_t err = once_per_device(configured, [&] {
      return cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    });
    if (err != cudaSuccess) return (int)err;
    dim3 grid((s + BQ - 1) / BQ, b * h);
    flash_fwd_kernel<HD><<<grid, NT_TC, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        meta, static_cast<bf16*>(o), lse, h, s, tokens_total, causal, sm_scale);
  } else {
    constexpr size_t smem = CcFwd<HD>::SMEM;
    cudaError_t err = once_per_device(configured, [&] {
      return cudaFuncSetAttribute(flash_fwd_cc_kernel<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    });
    if (err != cudaSuccess) return (int)err;
    dim3 grid(b * h, (s + BQ_CC - 1) / BQ_CC);
    flash_fwd_cc_kernel<T, HD><<<grid, CcFwd<HD>::NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), meta,
        static_cast<T*>(o), lse, h, s, tokens_total, causal, sm_scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool TCR>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* meta, void* o,
                float* lse, int b, int h, int s, int tokens_total, int causal, float sm_scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32, TCR>(q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    case 64: return launch<T, 64, TCR>(q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    case 128: return launch<T, 128, TCR>(q, k, v, meta, o, lse, b, h, s, tokens_total, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// #1: f32 on the CUDA cores; bf16 on the tensor cores, or with `cuda_cores`
// on the CUDA cores (the f32 route's kernel with bf16 operands, which only
// timing calls take).
int dispatch(bool cuda_cores, const void* q, const void* k, const void* v, const int* meta,
             void* o, float* lse, int b, int h, int s, int hd, int tokens_total, int causal,
             int dtype, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float, false>(hd, q, k, v, meta, o, lse, b, h, s, tokens_total, causal,
                                     sm_scale, st);
  if (dtype == 1 && cuda_cores)
    return dispatch_hd<bf16, false>(hd, q, k, v, meta, o, lse, b, h, s, tokens_total, causal,
                                    sm_scale, st);
  if (dtype == 1)
    return dispatch_hd<bf16, true>(hd, q, k, v, meta, o, lse, b, h, s, tokens_total, causal,
                                   sm_scale, st);
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

// #1 with bf16 on the CUDA cores (the f32 route's kernel with bf16 operands), for
// timing beside the tensor-core route; no path of the port calls it.
extern "C" int valle2_flash_attention_fwd_cuda_cores(const void* q, const void* k,
                                                     const void* v, const int* meta, void* o,
                                                     float* lse, int b, int h, int s, int hd,
                                                     int tokens_total, int causal, int dtype,
                                                     float sm_scale, void* stream) {
  return dispatch(true, q, k, v, meta, o, lse, b, h, s, hd, tokens_total, causal, dtype,
                  sm_scale, stream);
}

// #2, the head-folded forward (the same arguments and outputs as #1), on the
// host's item schedule: `groups` groups of h / groups heads per (batch row,
// q-tile), a grid of `grid` persistent blocks that take the items in order
// from `counter`, one int32 zeroed here on the stream.  The wrapper checks 16-byte
// alignment of q, k, v and o (the TMA maps need it); a refused argument, a
// tensor map libcuda would not encode, or the launch's error comes back.
extern "C" int valle2_flash_attention_fwd_folded(const void* q, const void* k, const void* v,
                                                 const int* meta, void* o, float* lse,
                                                 int b, int h, int s, int hd,
                                                 int tokens_total, int causal, int dtype,
                                                 float sm_scale, int groups, int grid,
                                                 int* counter, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_fold<32>(q, k, v, meta, o, lse, b, h, s, tokens_total, causal, dtype, sm_scale, groups, grid, counter, st);
    case 64: return launch_fold<64>(q, k, v, meta, o, lse, b, h, s, tokens_total, causal, dtype, sm_scale, groups, grid, counter, st);
    case 128: return launch_fold<128>(q, k, v, meta, o, lse, b, h, s, tokens_total, causal, dtype, sm_scale, groups, grid, counter, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of #2 one SM holds at (hd, dtype), into *blocks: the host's item
// schedule fills SMs x blocks.
extern "C" int valle2_flash_fold_blocks_per_sm(int hd, int dtype, int* blocks) {
  switch (dtype == 0 || dtype == 1 ? hd : 0) {
    case 32: return fold_blocks_per_sm<32>(dtype, blocks);
    case 64: return fold_blocks_per_sm<64>(dtype, blocks);
    case 128: return fold_blocks_per_sm<128>(dtype, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
