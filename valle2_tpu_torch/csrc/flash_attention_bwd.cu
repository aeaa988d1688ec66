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
// Two routes, chosen by dtype at dispatch.
//
// bf16, on the tensor cores (mma.sync m16n8k16 bf16 -> f32, the fragment
// helpers of common.cuh).  Four warps a block; every operand tile is bf16 in
// shared memory with rows padded by 16 bytes, so the 8 rows of an ldmatrix
// fall in distinct banks, and the ragged edge is zero-filled by cp.async
// (src-size 0), then masked.  The mask is applied per accumulator element (a
// thread knows the q row and the key of each), and p is 0 where it is false,
// so a row that sees no key gets zero gradient whatever its lse.  p and ds
// round to bf16 exactly where the accumulators are repacked as the A operand
// of the next product, which are the Pallas kernels' rounding points.
//
// - flash_bwd_dkv (#5): one block per (64-key tile, b*h); each warp owns 16
//   keys as the M dimension.  K and V are loaded once (their A fragments stay
//   in registers up to hd 64); the q tiles from the Pallas lower bound stream
//   Q, dO, lse and delta through a 2-stage cp.async ring.  Per q tile:
//   S^T = K Q^T and dP^T = V dO^T (B from Q, dO by ldmatrix), P^T and
//   dS^T = P^T (dP^T - delta) in registers, then dV += bf16(P^T) dO and
//   dK += bf16(dS^T) Q with the repacked accumulators as A and B from dO, Q
//   by ldmatrix.trans.
// - flash_bwd_fused (#3): the same device body with FUSED, so its dk, dv are
//   bit-equal to flash_bwd_dkv's.  It also writes bf16(dS^T) to a 64 x 64
//   shared tile; each warp then computes 16 q rows of dS K (A by
//   ldmatrix.trans from that tile, B = K by ldmatrix.trans) and adds them to
//   the f32 dq scratch with float2 atomics; flash_bwd_dq_finish scales and
//   casts it.  A GPU block cannot hold the whole (s, s) row as the TPU
//   kernel does (640^2 f32 is 1.6 MB against 227 KB of shared memory), so p
//   and ds are recomputed once per tile pair and shared by the three
//   gradients: 5 products per tile pair against 7 for dq + dkv.  The atomics
//   make dq's summation order vary from run to run.
// - flash_bwd_dq (#4): #1's structure with the PV product replaced.  One
//   block per (64-row q tile, b*h), each warp 16 q rows; Q and dO A fragments
//   in registers (up to hd 64); the kv tiles up to _kv_block_bound stream K
//   and V through a 2-stage cp.async ring.  Per kv tile: S = Q K^T, dP =
//   dO V^T, P and dS in registers, dQ += bf16(dS) K with dS repacked as A (no
//   shared-memory round trip) and B = K by ldmatrix.trans.  No atomics: dq is
//   the same bits from call to call.
// - Registers: S^T and dP^T (S and dP in #4) are computed 32 columns of the
//   64-wide tile at a time (at hd 64 that measured as fast as 64 columns or
//   faster, with fewer registers).  At hd 128 the dK and dV accumulators alone
//   take 128 floats a thread, so there the K, V (in #4 Q, dO) A fragments are
//   read from shared memory at each k-step instead of held in registers.
// - p = 2^(x scale log2e - lse log2e) by exp2f (one MUFU.EX2 after the FMA,
//   where expf adds a range reduction), and #4 starts its heaviest q tiles
//   (the last, when causal) first: together 20-25% off the kernels' time.
// - Epilogues (dk * scale, dv; dq * scale) are staged through shared memory
//   as bf16 so that the stores are 16 bytes a thread on consecutive addresses.
//
// What bounds it on this card: at the training shapes (b=32, h=4, s=640,
// hd=64, causal: about 26M attended pairs; #4 + #5 at b=8, s=1280 about the
// same) the five products come to ~16 GFLOP, 0.017 ms at the bf16 peak, and
// the bytes to move ~0.025 ms, so the bound is bytes.  Measured on an H100
// at 700 W (chip_smoke.py), #3 takes about ten times that: neither bytes nor
// the tensor cores' rate bound it, but the instruction throughput of
// mma.sync, ldmatrix and the per-element mask, exp2 and repacking from 4
// warps a block (registers hold it to a few blocks an SM), and in #3 the dq
// atomics.  wgmma (a warpgroup on a 64-row tile, operands from shared memory)
// fed by TMA loads and a warp-specialised producer is the next step.
//
// f32, on the CUDA cores (FFMA in full f32: the tensor cores have no full-f32
// product, TF32 keeps 10 mantissa bits, and f32 with TF32 off is the parity
// setting), and the bf16 route that flash_attention_bwd_cuda_cores times:
// the same kernels with T = bf16, whose staging converts to f32 through
// registers.  Register-tiled (the staging, the S-type and the dQ-type
// products in cc_tiles.cuh, which the forward's CUDA-core route shares): a
// block is two groups of threads, and every product is a micro-tile a
// thread holds in registers, fed by float4 shared reads from f32 tiles of
// row stride HD + 4 (16-byte rows whose stride is 4 mod 32 banks, so the 8
// rows a quarter warp reads fall in distinct banks and one row
// broadcasts).  Up to hd 64 a block is 128 threads (two groups of two
// warps) and two blocks share an SM; at hd 128, 256 threads (two groups of
// four warps), one block an SM.  Per tile pair (64 keys x 64 q rows):
//
// - Phase A: group 0 computes S^T = K Q^T (#5, #3) or S = Q K^T (#4), group
//   1 dP^T = V dO^T or dP = dO V^T, 8 x 8 of each a thread (4 x 8 at hd
//   128): 16 float4 reads per 256 FFMAs.  Group 0 writes p = 2^(S scale
//   log2e - lse log2e), selected against 0 by the mask (no branch an
//   element), unrounded into a [q][key] tile; a thread whose rows all see
//   all its keys skips the mask.  After a barrier group 1 writes ds =
//   round_T(p (dP - delta)) beside it (and rounds p in place to T for dV's
//   product).
// - Phase B (#5, #3): group 0 dV += round_T(p)^T dO, group 1 dK += ds^T Q,
//   outer products over the tile's 64 q rows, 8 x 8 a thread (4 x 8 at hd
//   32); dK and dV stay in registers across the streamed q tiles.  #4 (and
//   #3's dq) computes dQ += ds K over the tile's 64 keys on the whole block,
//   4 x 8 a thread (4 x 4 at hd 32): #4 keeps dQ in registers across the kv
//   tiles; #3 adds each tile pair's to the f32 scratch with one 16-byte
//   atomicAdd per 4 values (red.global.add.v4.f32), and flash_bwd_dq_finish
//   scales and casts it.
// - Staging: f32 operands go straight to shared memory by cp.async, 16 bytes
//   a thread, zero-filled past s, with lse and delta.  Shared memory a block:
//   hd 32 91,136 B, two stages (the next Q, dO or K, V tile loads while the
//   current one is multiplied); hd 64 104,960 B and hd 128 170,496 B, one
//   stage (a second would pass the 113 KB of two blocks an SM at hd 64, and
//   the 227 KB of one at hd 128, where K and V alone take 67,584 B): there
//   the SM's other block, or its other warps, compute while a tile loads.
// - #3 and #5 are one templated body, so #3's dk, dv equal #5's bit for
//   bit; #4 and #5 use no atomics and repeat bit for bit.  #4 starts its
//   heaviest q tiles first; the kv body keeps the Pallas causal lower bound
//   and #4 its last visible kv tile.
//
// What bounds it on this card: FFMA at 67 TFLOP/s (#3's products at b=32,
// h=4, s=640, hd 64 bidirectional take 0.44 ms at that rate, its bytes a
// tenth of that).  A thread's 8 x 8 tiles read one float of shared memory
// per 4 FFMAs, which is as fast as the SM's 128 bytes a cycle feeds its
// 128 FFMA lanes, so the shared-memory pipe and the FFMA pipe are about
// equally busy, with little slack at 255 registers a thread and 8 warps an
// SM to hide their latencies.  Measured on an H100 at 700 W at the training
// shapes (probes/train_ab.py, probes/bwd_ablate.py): 29-46% of the FFMA
// bound, 2.2-2.5x the speed of the design before it, and faster than
// scaled_dot_product_attention's f32 backward at every shape; phase A and
// phase B take time in proportion to their FFMAs, the mask 4-12% of it and
// the single stage's tile loads 4-11%.

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "cc_tiles.cuh"

namespace {

using namespace valle2;

constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // keys per tile

// ---- f32 route (and the timing-only bf16 one), on the CUDA cores ----

template <int HD>
struct Cc {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head dim 32, 64 or 128");
  // Up to hd 64 a block is 128 threads, two groups of two warps, and two
  // blocks share an SM (MINB), each thread holding 8 x 8 of S (or dP) beside
  // its dK (or dV) tile.  At hd 128 those would not fit its registers: 256
  // threads, two groups of four warps, 4 x 8 of S, one block an SM.
  static constexpr int NT = HD <= 64 ? 128 : 256, NG = NT / 2;
  static constexpr int MINB = HD <= 64 ? 2 : 1;
  // Row stride of an f32 operand tile: rows of 16-byte multiples, and
  // RS % 32 == 4, so that 8 consecutive rows read as float4 fill the 32 banks.
  static constexpr int RS = HD + 4;
  // Micro-tiles of a thread: S / dP (64 x 64 a group), TMA x 8; dK / dV
  // (64 x HD a group), TMB x TNB; dQ (64 x HD a block), TMQ x TNQ.
  static constexpr int TMA = 64 * 64 / NG / 8;
  static constexpr int TMB = 64 * HD / NG >= 64 ? 8 : 4, TNB = 64 * HD / NG / TMB;
  static constexpr int TMQ = 64 * HD / NT >= 16 ? 4 : 2, TNQ = 64 * HD / NT / TMQ;
  // Stages of the streamed tiles (Q, dO in the kv body; K, V in #4): two
  // where they fit beside the rest of the shared memory of MINB blocks
  // (hd 32), else one.
  static constexpr int NST = HD == 32 ? 2 : 1;
};

template <int HD>
constexpr size_t cc_smem() {
  // two fixed [64][RS] tiles, NST stages of two streamed [64][RS] tiles,
  // p and ds [BQ][PS], NST stages of lse and delta [BQ]
  using C = Cc<HD>;
  return sizeof(float) *
         (2 * 64 * C::RS + C::NST * 2 * 64 * C::RS + 2 * BQ * PS + C::NST * 2 * BQ);
}

// Position (tm, tn) of thread t in a grid of MT x (threads / MT) (MT a
// multiple of 8): the 8 lanes of a quarter warp take 8 consecutive tm and one
// tn, so that their reads of 8 consecutive rows fall in distinct banks and
// their reads of one row broadcast.
template <int MT>
__device__ __forceinline__ void grid_pos(int t, int& tm, int& tn) {
  constexpr int WM = MT / 8;   // warps along m
  tm = (t & 7) + 8 * ((t >> 5) % WM);
  tn = ((t >> 3) & 3) + 4 * ((t >> 5) / WM);
}

// lse and delta of 64 rows from row0 (rows past s read as 0), by cp.async
// (every block has at least 2 * BQ threads).
__device__ __forceinline__ void stage_stats(float* lse_s, float* delta_s, const float* lse_row,
                                            const float* delta_row, int row0, int s) {
  if (threadIdx.x < 2 * BQ) {
    const int i = threadIdx.x % BQ, row = row0 + i;
    const bool in = row < s;
    if (threadIdx.x < BQ)
      cp_async4_zfill(lse_s + i, lse_row + (in ? row : 0), in);
    else
      cp_async4_zfill(delta_s + i, delta_row + (in ? row : 0), in);
  }
}

// acc[i][j] += sum_r P[r][key_i] X[r][dim_j] over the tile's BQ rows r in
// order (dV += P^T dO, dK += dS^T Q): keys 4 tm + 32 (i / 4) + i % 4, dims
// 4 tn + (HD / 2)(j / 4) + j % 4; P of stride PS, X of stride RS.
template <int HD>
__device__ __forceinline__ void cols_outer(const float* P, const float* X, int tm, int tn,
                                           float (&acc)[Cc<HD>::TMB][Cc<HD>::TNB]) {
  using C = Cc<HD>;
  constexpr int RS = C::RS, TMB = C::TMB, TNB = C::TNB;
#pragma unroll 4
  for (int r = 0; r < BQ; ++r) {
    float pv[TMB], xv[TNB];
#pragma unroll
    for (int ib = 0; ib < TMB / 4; ++ib) put4(pv + 4 * ib, ld4(P + r * PS + 4 * tm + 32 * ib));
#pragma unroll
    for (int jb = 0; jb < TNB / 4; ++jb)
      put4(xv + 4 * jb, ld4(X + r * RS + 4 * tn + (HD / 2) * jb));
#pragma unroll
    for (int i = 0; i < TMB; ++i)
#pragma unroll
      for (int j = 0; j < TNB; ++j) acc[i][j] = fmaf(pv[i], xv[j], acc[i][j]);
  }
}

// dk, dv per 64-key tile (#5); with FUSED also dq into the f32 scratch (#3).
template <typename T, int HD, bool FUSED>
__global__ void __launch_bounds__(Cc<HD>::NT, Cc<HD>::MINB)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ meta,
                    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_acc, int h,
                    int s, int tokens_total, int causal, float scale) {
  using C = Cc<HD>;
  constexpr int RS = C::RS, NST = C::NST, NG = C::NG, TMA = C::TMA, MS = 64 / TMA;
  constexpr int TMB = C::TMB, TNB = C::TNB, TMQ = C::TMQ, TNQ = C::TNQ;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [BK][RS]
  float* Vs = Ks + BK * RS;            // [BK][RS]
  float* Qs = Vs + BK * RS;            // [NST][BQ][RS]
  float* dOs = Qs + NST * BQ * RS;     // [NST][BQ][RS]
  float* Ps = dOs + NST * BQ * RS;     // [BQ][PS]: p of the tile pair, [q][key]
  float* dSs = Ps + BQ * PS;           // [BQ][PS]: round_T(ds)
  float* lse_s = dSs + BQ * PS;        // [NST][BQ]
  float* delta_s = lse_s + NST * BQ;   // [NST][BQ]

  const int grp = threadIdx.x / NG, gt = threadIdx.x % NG;
  const int k_blk = blockIdx.x, bh = blockIdx.y, b = bh / h;
  const size_t base = (size_t)bh * s * HD;
  const float* lse_bh = lse + (size_t)bh * s;
  const float* delta_bh = delta + (size_t)bh * s;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int k0 = k_blk * BK;
  const int n_q = (s + BQ - 1) / BQ;
  int lower = (causal && k0 >= tokens_valid) ? k0 / BQ : 0;
  if (k0 >= kv_end) lower = n_q;
  const float scale_log2 = scale * LOG2E;   // exp(x scale - l) = 2^(x scale_log2 - l log2e)

  // Products S^T, dP^T: keys k0 + tm + MS i, q rows q0 + tn + 8 j.  Each key
  // is seen by every row (a source key), by the rows at or past it when
  // causal (an audio key), or by none.
  int tm, tn;
  grid_pos<MS>(gt, tm, tn);
  const int src_end = min(tokens_valid, kv_end);
  bool src[TMA], aud[TMA];
#pragma unroll
  for (int i = 0; i < TMA; ++i) {
    const int key = k0 + tm + MS * i;
    src[i] = (key < s) & (key < src_end);
    aud[i] = (key < s) & (key >= tokens_total) & (key < kv_end);
  }
  // dV (group 0) or dK (group 1): keys 4 bm + 32 (i / 4) + i % 4, dims
  // 4 bn + (HD / 2)(j / 4) + j % 4.
  int bm, bn;
  grid_pos<BK / TMB>(gt, bm, bn);
  float acc_b[TMB][TNB];
#pragma unroll
  for (int i = 0; i < TMB; ++i)
#pragma unroll
    for (int j = 0; j < TNB; ++j) acc_b[i][j] = 0.f;

  auto stage_q_tile = [&](int st, int qb) {
    stage_rows<T, HD, 64, C::NT>(Qs + st * BQ * RS, q + base, qb * BQ, s);
    stage_rows<T, HD, 64, C::NT>(dOs + st * BQ * RS, dout + base, qb * BQ, s);
    stage_stats(lse_s + st * BQ, delta_s + st * BQ, lse_bh, delta_bh, qb * BQ, s);
  };
  stage_rows<T, HD, 64, C::NT>(Ks, k + base, k0, s);
  stage_rows<T, HD, 64, C::NT>(Vs, v + base, k0, s);
  if (lower < n_q) stage_q_tile(NST == 2 ? lower & 1 : 0, lower);
  cp_async_commit();

  for (int qb = lower; qb < n_q; ++qb) {
    const int st = NST == 2 ? qb & 1 : 0, q0 = qb * BQ;
    cp_async_wait<0>();
    __syncthreads();   // tile qb (and K, V) landed; tile qb - 1, p and ds are no longer read
    if constexpr (NST == 2) {
      if (qb + 1 < n_q) stage_q_tile(st ^ 1, qb + 1);
      cp_async_commit();
    }
    const float* qs = Qs + st * BQ * RS;
    const float* dos = dOs + st * BQ * RS;
    {
      float acc[TMA][8];
#pragma unroll
      for (int i = 0; i < TMA; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      // Group 0: S^T = K Q^T; group 1: dP^T = V dO^T.
      rows_dot<HD, TMA, MS>(grp == 0 ? Ks : Vs, grp == 0 ? qs : dos, tm, tn, acc);
      if (grp == 0) {
        // p = attend ? 2^(S^T scale_log2 - lse log2e) : 0, unrounded, into
        // Ps[q][key].  Where every key of the thread is seen by all its rows,
        // no mask.
        const float* ls = lse_s + st * BQ;
        const int qmin = q0 + tn;
        bool whole = qmin + 8 * 7 < s;
#pragma unroll
        for (int i = 0; i < TMA; ++i)
          whole &= src[i] | (aud[i] & (!causal | (k0 + tm + MS * i <= qmin)));
        if (whole) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float l2 = ls[tn + 8 * j] * LOG2E;
#pragma unroll
            for (int i = 0; i < TMA; ++i)
              Ps[(tn + 8 * j) * PS + tm + MS * i] = exp2f(fmaf(acc[i][j], scale_log2, -l2));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int qi = q0 + tn + 8 * j;
            const float l2 = ls[tn + 8 * j] * LOG2E;
#pragma unroll
            for (int i = 0; i < TMA; ++i) {
              const bool on =
                  (qi < s) & (src[i] | (aud[i] & (!causal | (k0 + tm + MS * i <= qi))));
              const float e = exp2f(fmaf(acc[i][j], scale_log2, -l2));
              Ps[(tn + 8 * j) * PS + tm + MS * i] = on ? e : 0.f;
            }
          }
        }
      }
      __syncthreads();   // p is in Ps
      if (grp == 1) {
        // ds = round_T(p (dP - delta)); p itself rounds to T in place (the
        // same thread position of group 0 wrote it) for dV's product.
        const float* dls = delta_s + st * BQ;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dl = dls[tn + 8 * j];
#pragma unroll
          for (int i = 0; i < TMA; ++i) {
            const int at = (tn + 8 * j) * PS + tm + MS * i;
            const float p = Ps[at];
            dSs[at] = round_to<T>(p * (acc[i][j] - dl));
            if constexpr (!std::is_same<T, float>::value) Ps[at] = round_to<T>(p);
          }
        }
      }
    }
    __syncthreads();   // ds is in dSs, p rounded
    // Group 0: dV += P^T dO; group 1: dK += dS^T Q.
    cols_outer<HD>(grp == 0 ? Ps : dSs, grp == 0 ? dos : qs, bm, bn, acc_b);
    if constexpr (FUSED) {
      // dQ of the tile's q rows += dS K over its keys, added to the f32
      // scratch once per tile pair by 16-byte atomics.
      int qm, qn;
      grid_pos<BQ / TMQ>(threadIdx.x, qm, qn);
      float acc_q[TMQ][TNQ];
#pragma unroll
      for (int i = 0; i < TMQ; ++i)
#pragma unroll
        for (int j = 0; j < TNQ; ++j) acc_q[i][j] = 0.f;
      rows_times<HD, TMQ, TNQ, BQ / TMQ, HD / 2>(dSs, Ks, qm, qn, acc_q);
#pragma unroll
      for (int i = 0; i < TMQ; ++i) {
        const int qi = q0 + qm + (BQ / TMQ) * i;
        if (qi < s) {
          float* row = dq_acc + base + (size_t)qi * HD + 4 * qn;
#pragma unroll
          for (int jb = 0; jb < TNQ / 4; ++jb)
            atomicAdd(reinterpret_cast<float4*>(row + (HD / 2) * jb),
                      make_float4(acc_q[i][4 * jb], acc_q[i][4 * jb + 1], acc_q[i][4 * jb + 2],
                                  acc_q[i][4 * jb + 3]));
        }
      }
    }
    if constexpr (NST == 1) {
      __syncthreads();   // the stage is no longer read
      if (qb + 1 < n_q) stage_q_tile(0, qb + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // Group 0 writes dv, group 1 dk * scale.
  T* out = grp == 0 ? dv : dk;
  const float mul = grp == 0 ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < TMB; ++i) {
    const int key = k0 + 4 * bm + 32 * (i / 4) + i % 4;
    if (key < s) {
#pragma unroll
      for (int jb = 0; jb < TNB / 4; ++jb)
        store4<T>(out + base + (size_t)key * HD + 4 * bn + (HD / 2) * jb,
                  acc_b[i][4 * jb] * mul, acc_b[i][4 * jb + 1] * mul,
                  acc_b[i][4 * jb + 2] * mul, acc_b[i][4 * jb + 3] * mul);
    }
  }
}

// dq per 64-row q tile (#4), over kv tiles up to _kv_block_bound.
template <typename T, int HD>
__global__ void __launch_bounds__(Cc<HD>::NT, Cc<HD>::MINB)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ meta,
                    T* __restrict__ dq, int h, int s, int tokens_total, int causal,
                    float scale) {
  using C = Cc<HD>;
  constexpr int RS = C::RS, NST = C::NST, NG = C::NG, TMA = C::TMA, MS = 64 / TMA;
  constexpr int TMQ = C::TMQ, TNQ = C::TNQ;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [BQ][RS]
  float* dOs = Qs + BQ * RS;           // [BQ][RS]
  float* Ks = dOs + BQ * RS;           // [NST][BK][RS]
  float* Vs = Ks + NST * BK * RS;      // [NST][BK][RS]
  float* Ps = Vs + NST * BK * RS;      // [BQ][PS]: p of the tile pair, [q][key]
  float* dSs = Ps + BQ * PS;           // [BQ][PS]: round_T(ds)

  const int grp = threadIdx.x / NG, gt = threadIdx.x % NG;
  // The last q tiles see the most keys when causal: they start first.
  const int q_blk = gridDim.x - 1 - blockIdx.x, bh = blockIdx.y, b = bh / h;
  const size_t base = (size_t)bh * s * HD;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int q0 = q_blk * BQ;
  const float scale_log2 = scale * LOG2E;

  // Products S, dP: q rows q0 + tm + MS i, keys k0 + tn + 8 j.  Row i sees
  // the keys [0, src_end) and [tokens_total, aud_hi[i]); group 0 holds its
  // lse (in log2 units), group 1 its delta.
  int tm, tn;
  grid_pos<MS>(gt, tm, tn);
  const int src_end = min(tokens_valid, kv_end);
  bool qin[TMA];
  int aud_hi[TMA];
  float stat[TMA];
#pragma unroll
  for (int i = 0; i < TMA; ++i) {
    const int qi = q0 + tm + MS * i;
    qin[i] = qi < s;
    aud_hi[i] = causal ? min(kv_end, qi + 1) : kv_end;
    stat[i] = !qin[i] ? 0.f
              : grp == 0 ? lse[(size_t)bh * s + qi] * LOG2E
                         : delta[(size_t)bh * s + qi];
  }
  const bool rows_in = qin[TMA - 1];   // the thread's last row, so all of them

  const int all_tiles = (s + BK - 1) / BK;
  const int vis_end = causal ? max(tokens_valid, min(q0 + BQ, kv_end)) : kv_end;
  const int n_tiles = min(all_tiles, (vis_end + BK - 1) / BK);

  // dQ: rows q0 + qm + (BQ / TMQ) i, dims 4 qn + (HD / 2)(j / 4) + j % 4.
  int qm, qn;
  grid_pos<BQ / TMQ>(threadIdx.x, qm, qn);
  float acc_q[TMQ][TNQ];
#pragma unroll
  for (int i = 0; i < TMQ; ++i)
#pragma unroll
    for (int j = 0; j < TNQ; ++j) acc_q[i][j] = 0.f;

  auto stage_kv_tile = [&](int st, int kb) {
    stage_rows<T, HD, 64, C::NT>(Ks + st * BK * RS, k + base, kb * BK, s);
    stage_rows<T, HD, 64, C::NT>(Vs + st * BK * RS, v + base, kb * BK, s);
  };
  stage_rows<T, HD, 64, C::NT>(Qs, q + base, q0, s);
  stage_rows<T, HD, 64, C::NT>(dOs, dout + base, q0, s);
  if (n_tiles > 0) stage_kv_tile(0, 0);
  cp_async_commit();

  for (int kb = 0; kb < n_tiles; ++kb) {
    const int st = NST == 2 ? kb & 1 : 0, k0 = kb * BK;
    cp_async_wait<0>();
    __syncthreads();   // tile kb (and Q, dO) landed; tile kb - 1, p and ds are no longer read
    if constexpr (NST == 2) {
      if (kb + 1 < n_tiles) stage_kv_tile(st ^ 1, kb + 1);
      cp_async_commit();
    }
    const float* ks = Ks + st * BK * RS;
    const float* vs = Vs + st * BK * RS;
    {
      float acc[TMA][8];
#pragma unroll
      for (int i = 0; i < TMA; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      // Group 0: S = Q K^T; group 1: dP = dO V^T.
      rows_dot<HD, TMA, MS>(grp == 0 ? Qs : dOs, grp == 0 ? ks : vs, tm, tn, acc);
      if (grp == 0) {
        // p = attend ? 2^(S scale_log2 - lse log2e) : 0 into Ps[q][key];
        // where all the thread's rows see all its keys, no mask.
        const int kmin = k0 + tn, kmax = kmin + 8 * 7;
        const bool whole = rows_in & (kmax < s) &
                           ((kmax < src_end) | ((kmin >= tokens_total) & (kmax < aud_hi[0])));
        if (whole) {
#pragma unroll
          for (int i = 0; i < TMA; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              Ps[(tm + MS * i) * PS + tn + 8 * j] = exp2f(fmaf(acc[i][j], scale_log2, -stat[i]));
        } else {
#pragma unroll
          for (int i = 0; i < TMA; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int key = k0 + tn + 8 * j;
              const bool on = qin[i] & (key < s) &
                              ((key < src_end) | ((key >= tokens_total) & (key < aud_hi[i])));
              const float e = exp2f(fmaf(acc[i][j], scale_log2, -stat[i]));
              Ps[(tm + MS * i) * PS + tn + 8 * j] = on ? e : 0.f;
            }
        }
      }
      __syncthreads();   // p is in Ps
      if (grp == 1) {
#pragma unroll
        for (int i = 0; i < TMA; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int at = (tm + MS * i) * PS + tn + 8 * j;
            dSs[at] = round_to<T>(Ps[at] * (acc[i][j] - stat[i]));
          }
      }
    }
    __syncthreads();   // ds is in dSs
    rows_times<HD, TMQ, TNQ, BQ / TMQ, HD / 2>(dSs, ks, qm, qn, acc_q);
    if constexpr (NST == 1) {
      __syncthreads();   // the stage is no longer read
      if (kb + 1 < n_tiles) stage_kv_tile(0, kb + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TMQ; ++i) {
    const int qi = q0 + qm + (BQ / TMQ) * i;
    if (qi < s) {
#pragma unroll
      for (int jb = 0; jb < TNQ / 4; ++jb)
        store4<T>(dq + base + (size_t)qi * HD + 4 * qn + (HD / 2) * jb,
                  acc_q[i][4 * jb] * scale, acc_q[i][4 * jb + 1] * scale,
                  acc_q[i][4 * jb + 2] * scale, acc_q[i][4 * jb + 3] * scale);
    }
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

// ---- bf16 route, on the tensor cores (the design is in the header) ----

using bf16 = __nv_bfloat16;

constexpr int NT_TC = 128;              // 4 warps
constexpr int DS_RS = BQ + TILE_PAD;    // row stride of the fused kernel's dS^T tile

template <int HD>
struct Tc {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int RS = HD + TILE_PAD;   // shared row stride of an operand tile
  static constexpr int KD = HD / 16;       // k-steps over the head dim
  static constexpr int ND = HD / 8;        // n-tiles over the head dim
  // Up to hd 64 the fixed operand's A fragments stay in registers; at hd 128
  // the accumulators need the room.
  static constexpr bool REG_A = HD <= 64;
  // Columns of S^T (S in #4) computed at a time: the other half of a 64-wide
  // tile waits, so that S and dP take 32 registers a thread, not 64.
  static constexpr int NC = 32;
};

template <int HD, bool FUSED>
constexpr size_t tc_kv_smem() {
  // K, V [BK][RS]; Q, dO [2][BQ][RS]; dS^T [BK][DS_RS] (fused); lse, delta [2][BQ]
  return sizeof(bf16) * (6 * 64 * Tc<HD>::RS + (FUSED ? BK * DS_RS : 0)) +
         sizeof(float) * 4 * BQ;
}

template <int HD>
constexpr size_t tc_dq_smem() {
  // Q, dO [BQ][RS]; K, V [2][BK][RS]
  return sizeof(bf16) * 6 * 64 * Tc<HD>::RS;
}

// lse and delta of 64 rows from row0 (rows past s read as 0), by cp.async.
__device__ __forceinline__ void load_stats_tc(float* lse_s, float* delta_s,
                                              const float* lse_row, const float* delta_row,
                                              int row0, int s) {
  const int i = threadIdx.x % BQ, row = row0 + i;
  const bool in = row < s;
  if (threadIdx.x < BQ)
    cp_async4_zfill(lse_s + i, lse_row + (in ? row : 0), in);
  else
    cp_async4_zfill(delta_s + i, delta_row + (in ? row : 0), in);
}

// A padded shared tile of 64 bf16 rows out to rows row0.. of the head at
// `base`, 16 bytes a thread; rows past s are not written.
template <int HD>
__device__ __forceinline__ void store_rows_tc(const bf16* src, bf16* dst, size_t base, int row0,
                                              int s) {
  constexpr int CH = HD / 8, RS = Tc<HD>::RS;
  for (int c = threadIdx.x; c < 64 * CH; c += NT_TC) {
    const int r = c / CH, col = c % CH * 8, row = row0 + r;
    if (row < s)
      *reinterpret_cast<uint4*>(dst + base + (size_t)row * HD + col) =
          *reinterpret_cast<const uint4*>(src + r * RS + col);
  }
}

// dk, dv per 64-key tile (#5); with FUSED also dq into the f32 scratch (#3).
template <int HD, bool FUSED>
__global__ void __launch_bounds__(NT_TC)
flash_bwd_kv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ meta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, float* __restrict__ dq_acc, int h, int s,
                       int tokens_total, int causal, float scale) {
  using S = Tc<HD>;
  constexpr int RS = S::RS, KD = S::KD, ND = S::ND, NC = S::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * RS;
  bf16* Qs = Vs + BK * RS;          // [2][BQ][RS]
  bf16* dOs = Qs + 2 * BQ * RS;     // [2][BQ][RS]
  bf16* DSt = dOs + 2 * BQ * RS;    // [BK][DS_RS], dS^T of the tile (fused)
  float* lse_s = reinterpret_cast<float*>(DSt + (FUSED ? BK * DS_RS : 0));   // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                                           // [2][BQ]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int k_blk = blockIdx.x, bh = blockIdx.y, b = bh / h;
  const size_t base = (size_t)bh * s * HD;
  const float* lse_bh = lse + (size_t)bh * s;
  const float* delta_bh = delta + (size_t)bh * s;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int k0 = k_blk * BK;
  const int n_q = (s + BQ - 1) / BQ;
  int lower = (causal && k0 >= tokens_valid) ? k0 / BQ : 0;
  if (k0 >= kv_end) lower = n_q;
  const float scale_log2 = scale * LOG2E;   // exp(x scale - l) = 2^(x scale_log2 - l log2e)

  // The two keys whose rows this thread holds (gid, gid + 8 of the warp's
  // 16): seen by every row (a source key), or by the rows at or past the
  // key when causal (an audio key), or by none.
  int key[2];
  bool always[2], audio[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    key[ri] = k0 + warp * 16 + gid + 8 * ri;
    const bool in = key[ri] < s && key[ri] < kv_end;
    always[ri] = in && key[ri] < tokens_valid;
    audio[ri] = in && key[ri] >= tokens_total;
  }

  cp_async_rows64<HD, NT_TC>(k, Ks, base, k0, s);
  cp_async_rows64<HD, NT_TC>(v, Vs, base, k0, s);
  if (lower < n_q) {
    const int st = lower & 1;
    cp_async_rows64<HD, NT_TC>(q, Qs + st * BQ * RS, base, lower * BQ, s);
    cp_async_rows64<HD, NT_TC>(dout, dOs + st * BQ * RS, base, lower * BQ, s);
    load_stats_tc(lse_s + st * BQ, delta_s + st * BQ, lse_bh, delta_bh, lower * BQ, s);
  }
  cp_async_commit();

  uint32_t kf[S::REG_A ? KD : 1][4], vf[S::REG_A ? KD : 1][4];
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int qb = lower; qb < n_q; ++qb) {
    cp_async_wait<0>();
    __syncthreads();   // tile qb (and K, V) landed; tile qb - 1 and dS^T are no longer read
    if constexpr (S::REG_A) {
      if (qb == lower) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldmatrix_a<RS>(kf[kd], Ks, warp * 16, kd);
          ldmatrix_a<RS>(vf[kd], Vs, warp * 16, kd);
        }
      }
    }
    if (qb + 1 < n_q) {
      const int st = (qb + 1) & 1;
      cp_async_rows64<HD, NT_TC>(q, Qs + st * BQ * RS, base, (qb + 1) * BQ, s);
      cp_async_rows64<HD, NT_TC>(dout, dOs + st * BQ * RS, base, (qb + 1) * BQ, s);
      load_stats_tc(lse_s + st * BQ, delta_s + st * BQ, lse_bh, delta_bh, (qb + 1) * BQ, s);
    }
    cp_async_commit();
    const int st = qb & 1, q0 = qb * BQ;
    const bf16* qs = Qs + st * BQ * RS;
    const bf16* dos = dOs + st * BQ * RS;
    const float* ls = lse_s + st * BQ;
    const float* dls = delta_s + st * BQ;

#pragma unroll
    for (int c0 = 0; c0 < BQ; c0 += NC) {
      // S^T = K Q^T and dP^T = V dO^T over the chunk's NC q rows: Q and dO
      // stored [q][dim] are the col-major B operands.
      float sT[NC / 8][4], dpT[NC / 8][4];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[nt][e] = dpT[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        if constexpr (S::REG_A) {
#pragma unroll
          for (int i = 0; i < 4; ++i) ka[i] = kf[kd][i], va[i] = vf[kd][i];
        } else {
          ldmatrix_a<RS>(ka, Ks, warp * 16, kd);
          ldmatrix_a<RS>(va, Vs, warp * 16, kd);
        }
#pragma unroll
        for (int nt = 0; nt < NC / 8; nt += 2) {
          uint32_t r[4];
          ldmatrix_b_nk<RS>(r, qs, c0 + nt * 8, kd);
          const uint32_t q0b[2] = {r[0], r[1]}, q1b[2] = {r[2], r[3]};
          mma_bf16(sT[nt], ka, q0b);
          mma_bf16(sT[nt + 1], ka, q1b);
          ldmatrix_b_nk<RS>(r, dos, c0 + nt * 8, kd);
          const uint32_t d0b[2] = {r[0], r[1]}, d1b[2] = {r[2], r[3]};
          mma_bf16(dpT[nt], va, d0b);
          mma_bf16(dpT[nt + 1], va, d1b);
        }
      }

      // P^T = mask ? exp(S^T scale - lse) : 0 and dS^T = P^T (dP^T - delta)
      // per element (element e: key row gid + 8 (e / 2), q column 2 tig +
      // e % 2 of its n-tile), rounded to bf16 into A fragments (k-step kk of
      // 16 q rows is n-tiles 2 kk and 2 kk + 1).
      uint32_t pa[NC / 16][4], dsa[NC / 16][4];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt) {
        const int qc = c0 + nt * 8 + tig * 2;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + qc);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1, qi = q0 + qc + (e & 1);
          const bool on =
              qi < s && (always[ri] || (audio[ri] && (!causal || key[ri] <= qi)));
          const float l = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
          p[e] = on ? exp2f(fmaf(sT[nt][e], scale_log2, -l * LOG2E)) : 0.f;
          ds[e] = p[e] * (dpT[nt][e] - dl);
        }
        pa[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[nt / 2][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q: dO and Q stored [q][dim] are the
      // row-major B operands (.trans).
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t r[4];
          ldmatrix_b_kn<RS>(r, dos, c0 + kk * 16, nd);
          const uint32_t d0b[2] = {r[0], r[1]}, d1b[2] = {r[2], r[3]};
          mma_bf16(dv_acc[nd], pa[kk], d0b);
          mma_bf16(dv_acc[nd + 1], pa[kk], d1b);
          ldmatrix_b_kn<RS>(r, qs, c0 + kk * 16, nd);
          const uint32_t q0b[2] = {r[0], r[1]}, q1b[2] = {r[2], r[3]};
          mma_bf16(dk_acc[nd], dsa[kk], q0b);
          mma_bf16(dk_acc[nd + 1], dsa[kk], q1b);
        }
      }

      if constexpr (FUSED) {
        // bf16(dS^T) of the warp's 16 keys into the shared [key][q] tile.
#pragma unroll
        for (int kk = 0; kk < NC / 16; ++kk)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int col = c0 + (2 * kk + half) * 8 + tig * 2;
            bf16* row = DSt + (warp * 16 + gid) * DS_RS + col;
            *reinterpret_cast<uint32_t*>(row) = dsa[kk][half * 2];
            *reinterpret_cast<uint32_t*>(row + 8 * DS_RS) = dsa[kk][half * 2 + 1];
          }
      }
    }

    if constexpr (FUSED) {
      __syncthreads();   // every warp's dS^T rows are in the tile
      // dQ rows q0 + 16 warp .. + 15 += dS K over the tile's 64 keys, at most
      // 64 dims at a time: A = dS from the [key][q] tile by ldmatrix.trans,
      // B = K stored [key][dim] by ldmatrix.trans; then float2 atomics.
      constexpr int NDC = ND < 8 ? ND : 8;
#pragma unroll
      for (int nd0 = 0; nd0 < ND; nd0 += NDC) {
        float acc[NDC][4];
#pragma unroll
        for (int j = 0; j < NDC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, DSt + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * DS_RS +
                                   warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int j = 0; j < NDC; j += 2) {
            uint32_t r[4];
            ldmatrix_b_kn<RS>(r, Ks, kk * 16, nd0 + j);
            const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
            mma_bf16(acc[j], a, b0);
            mma_bf16(acc[j + 1], a, b1);
          }
        }
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const int qi = q0 + warp * 16 + gid + 8 * ri;
          if (qi >= s) continue;
          float* row = dq_acc + base + (size_t)qi * HD + nd0 * 8 + tig * 2;
#pragma unroll
          for (int j = 0; j < NDC; ++j)
            atomicAdd(reinterpret_cast<float2*>(row + j * 8),
                      make_float2(acc[j][2 * ri], acc[j][2 * ri + 1]));
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are no longer read: they stage the epilogue

  bf16* dks = Qs;
  bf16* dvs = dOs;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = warp * 16 + gid + 8 * ri, col = nd * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(dks + r * RS + col) = __floats2bfloat162_rn(
          dk_acc[nd][2 * ri] * scale, dk_acc[nd][2 * ri + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvs + r * RS + col) =
          __floats2bfloat162_rn(dv_acc[nd][2 * ri], dv_acc[nd][2 * ri + 1]);
    }
  __syncthreads();
  store_rows_tc<HD>(dks, dk, base, k0, s);
  store_rows_tc<HD>(dvs, dv, base, k0, s);
}

// dq per 64-row q tile (#4), over kv tiles up to _kv_block_bound.
template <int HD>
__global__ void __launch_bounds__(NT_TC)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ meta, bf16* __restrict__ dq, int h, int s,
                       int tokens_total, int causal, float scale) {
  using S = Tc<HD>;
  constexpr int RS = S::RS, KD = S::KD, ND = S::ND, NC = S::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][RS]
  bf16* dOs = Qs + BQ * RS;                        // [BQ][RS]
  bf16* Ks = dOs + BQ * RS;                        // [2][BK][RS]
  bf16* Vs = Ks + 2 * BK * RS;                     // [2][BK][RS]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;
  // The last q tiles see the most keys when causal: they start first.
  const int q_blk = gridDim.x - 1 - blockIdx.x, bh = blockIdx.y, b = bh / h;
  const size_t base = (size_t)bh * s * HD;
  const int tokens_valid = meta[2 * b], kv_end = meta[2 * b + 1];
  const int q0 = q_blk * BQ;
  const float scale_log2 = scale * LOG2E;

  // The two q rows this thread holds (gid, gid + 8 of the warp's 16): their
  // lse, delta and visible keys, [0, src_end) and [tokens_total, aud_hi).
  const int src_end = min(tokens_valid, kv_end);
  int qi[2], aud_hi[2];
  float lr[2], dr[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    qi[ri] = q0 + warp * 16 + gid + 8 * ri;
    const bool in = qi[ri] < s;
    lr[ri] = in ? lse[(size_t)bh * s + qi[ri]] * LOG2E : 0.f;   // in log2 units
    dr[ri] = in ? delta[(size_t)bh * s + qi[ri]] : 0.f;
    aud_hi[ri] = causal ? min(kv_end, qi[ri] + 1) : kv_end;
  }

  const int all_tiles = (s + BK - 1) / BK;
  const int vis_end = causal ? max(tokens_valid, min(q0 + BQ, kv_end)) : kv_end;
  const int n_tiles = min(all_tiles, (vis_end + BK - 1) / BK);

  cp_async_rows64<HD, NT_TC>(q, Qs, base, q0, s);
  cp_async_rows64<HD, NT_TC>(dout, dOs, base, q0, s);
  if (n_tiles > 0) {
    cp_async_rows64<HD, NT_TC>(k, Ks, base, 0, s);
    cp_async_rows64<HD, NT_TC>(v, Vs, base, 0, s);
  }
  cp_async_commit();

  uint32_t qf[S::REG_A ? KD : 1][4], df[S::REG_A ? KD : 1][4];
  float dq_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[i][e] = 0.f;

  for (int kb = 0; kb < n_tiles; ++kb) {
    cp_async_wait<0>();
    __syncthreads();   // tile kb (and Q, dO) landed; tile kb - 1 is no longer read
    if constexpr (S::REG_A) {
      if (kb == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldmatrix_a<RS>(qf[kd], Qs, warp * 16, kd);
          ldmatrix_a<RS>(df[kd], dOs, warp * 16, kd);
        }
      }
    }
    if (kb + 1 < n_tiles) {
      const int st = (kb + 1) & 1;
      cp_async_rows64<HD, NT_TC>(k, Ks + st * BK * RS, base, (kb + 1) * BK, s);
      cp_async_rows64<HD, NT_TC>(v, Vs + st * BK * RS, base, (kb + 1) * BK, s);
    }
    cp_async_commit();
    const bf16* ks = Ks + (kb & 1) * BK * RS;
    const bf16* vs = Vs + (kb & 1) * BK * RS;
    const int k0 = kb * BK;

#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += NC) {
      // S = Q K^T and dP = dO V^T over the chunk's NC keys: K and V stored
      // [key][dim] are the col-major B operands.
      float sc[NC / 8][4], dp[NC / 8][4];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4], da[4];
        if constexpr (S::REG_A) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[kd][i], da[i] = df[kd][i];
        } else {
          ldmatrix_a<RS>(qa, Qs, warp * 16, kd);
          ldmatrix_a<RS>(da, dOs, warp * 16, kd);
        }
#pragma unroll
        for (int nt = 0; nt < NC / 8; nt += 2) {
          uint32_t r[4];
          ldmatrix_b_nk<RS>(r, ks, c0 + nt * 8, kd);
          const uint32_t k0b[2] = {r[0], r[1]}, k1b[2] = {r[2], r[3]};
          mma_bf16(sc[nt], qa, k0b);
          mma_bf16(sc[nt + 1], qa, k1b);
          ldmatrix_b_nk<RS>(r, vs, c0 + nt * 8, kd);
          const uint32_t v0b[2] = {r[0], r[1]}, v1b[2] = {r[2], r[3]};
          mma_bf16(dp[nt], da, v0b);
          mma_bf16(dp[nt + 1], da, v1b);
        }
      }

      // P = mask ? exp(S scale - lse) : 0, dS = P (dP - delta) per element
      // (element e: row gid + 8 (e / 2), key 2 tig + e % 2 of its n-tile),
      // rounded to bf16 into the A operand of dS K.
      uint32_t dsa[NC / 16][4];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ri = e >> 1, key = k0 + c0 + nt * 8 + tig * 2 + (e & 1);
          const bool on = qi[ri] < s && key < s &&
                          (key < src_end || (key >= tokens_total && key < aud_hi[ri]));
          const float p = on ? exp2f(fmaf(sc[nt][e], scale_log2, -lr[ri])) : 0.f;
          ds[e] = p * (dp[nt][e] - dr[ri]);
        }
        dsa[nt / 2][(nt & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K: K stored [key][dim] is the row-major B operand (.trans).
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
          uint32_t r[4];
          ldmatrix_b_kn<RS>(r, ks, c0 + kk * 16, nd);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(dq_acc[nd], dsa[kk], b0);
          mma_bf16(dq_acc[nd + 1], dsa[kk], b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // Q is no longer read: it stages the epilogue

#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = warp * 16 + gid + 8 * ri, col = nd * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(Qs + r * RS + col) = __floats2bfloat162_rn(
          dq_acc[nd][2 * ri] * scale, dq_acc[nd][2 * ri + 1] * scale);
    }
  __syncthreads();
  store_rows_tc<HD>(Qs, dq, base, q0, s);
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

// The fused kernel's last pass over the f32 scratch.
template <typename T>
int finish_dq(const Args& a, int hd) {
  const size_t n = (size_t)a.b * a.h * a.s * hd;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  flash_bwd_dq_finish<T><<<blocks, 256, 0, a.stream>>>(a.dq_acc, static_cast<T*>(a.dq), n,
                                                       a.scale);
  return (int)cudaGetLastError();
}

// which: 0 = fused, 1 = dq, 2 = dkv.  CUDA-core route.
template <typename T, int HD>
int launch(int which, const Args& a) {
  constexpr size_t smem = cc_smem<HD>();
  static unsigned configured = 0;   // one bit per card
  cudaError_t err = once_per_device(configured, [&] {
    cudaError_t e = allow_smem(flash_bwd_kv_kernel<T, HD, true>, smem);
    if (e == cudaSuccess) e = allow_smem(flash_bwd_kv_kernel<T, HD, false>, smem);
    if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_kernel<T, HD>, smem);
    return e;
  });
  if (err != cudaSuccess) return (int)err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const dim3 grid((a.s + 63) / 64, a.b * a.h);
  if (which == 1) {
    flash_bwd_dq_kernel<T, HD><<<grid, Cc<HD>::NT, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<T*>(a.dq), a.h, a.s,
        a.tokens_total, a.causal, a.scale);
  } else if (which == 2) {
    flash_bwd_kv_kernel<T, HD, false><<<grid, Cc<HD>::NT, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        nullptr, a.h, a.s, a.tokens_total, a.causal, a.scale);
  } else {
    flash_bwd_kv_kernel<T, HD, true><<<grid, Cc<HD>::NT, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.dq_acc, a.h, a.s, a.tokens_total, a.causal, a.scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return finish_dq<T>(a, HD);
  }
  return (int)cudaGetLastError();
}

// The tensor-core route (bf16).
template <int HD>
int launch_tc(int which, const Args& a) {
  static unsigned configured = 0;   // one bit per card
  cudaError_t err = once_per_device(configured, [] {
    cudaError_t e = allow_smem(flash_bwd_kv_tc_kernel<HD, true>, tc_kv_smem<HD, true>());
    if (e == cudaSuccess)
      e = allow_smem(flash_bwd_kv_tc_kernel<HD, false>, tc_kv_smem<HD, false>());
    if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_tc_kernel<HD>, tc_dq_smem<HD>());
    return e;
  });
  if (err != cudaSuccess) return (int)err;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const dim3 grid((a.s + 63) / 64, a.b * a.h);
  if (which == 1) {
    flash_bwd_dq_tc_kernel<HD><<<grid, NT_TC, tc_dq_smem<HD>(), a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<bf16*>(a.dq), a.h, a.s,
        a.tokens_total, a.causal, a.scale);
  } else if (which == 2) {
    flash_bwd_kv_tc_kernel<HD, false><<<grid, NT_TC, tc_kv_smem<HD, false>(), a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), nullptr, a.h, a.s, a.tokens_total, a.causal, a.scale);
  } else {
    flash_bwd_kv_tc_kernel<HD, true><<<grid, NT_TC, tc_kv_smem<HD, true>(), a.stream>>>(
        q, k, v, dout, a.lse, a.delta, a.meta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.dq_acc, a.h, a.s, a.tokens_total, a.causal, a.scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return finish_dq<bf16>(a, HD);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool TCR>
int dispatch_hd(int which, int hd, const Args& a) {
  if constexpr (TCR) {
    switch (hd) {
      case 32: return launch_tc<32>(which, a);
      case 64: return launch_tc<64>(which, a);
      case 128: return launch_tc<128>(which, a);
    }
  } else {
    switch (hd) {
      case 32: return launch<T, 32>(which, a);
      case 64: return launch<T, 64>(which, a);
      case 128: return launch<T, 128>(which, a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// f32 on the CUDA cores; bf16 on the tensor cores, or with `cuda_cores` on
// the CUDA cores (the f32 route's kernels, which only timing calls take).
int dispatch(int which, int dtype, int hd, int cuda_cores, const Args& a) {
  if (dtype == 0) return dispatch_hd<float, false>(which, hd, a);
  if (dtype == 1 && cuda_cores) return dispatch_hd<bf16, false>(which, hd, a);
  if (dtype == 1) return dispatch_hd<bf16, true>(which, hd, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cuda_cores: 1 runs bf16 on the CUDA cores
// (f32 runs there in either case).  Each returns cudaGetLastError() after its
// launches.  dq_acc: a zeroed f32 (b, h, s, hd) scratch (fused only).
extern "C" int valle2_flash_bwd_fused(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      const int* meta, void* dq, void* dk, void* dv,
                                      float* dq_acc, int b, int h, int s, int hd,
                                      int tokens_total, int causal, int dtype, int cuda_cores,
                                      float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, meta, dq, dk, dv, dq_acc, b, h, s, tokens_total,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(0, dtype, hd, cuda_cores, a);
}

extern "C" int valle2_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   const int* meta, void* dq, int b, int h, int s, int hd,
                                   int tokens_total, int causal, int dtype, int cuda_cores,
                                   float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, meta, dq, nullptr, nullptr, nullptr, b, h, s,
               tokens_total, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(1, dtype, hd, cuda_cores, a);
}

extern "C" int valle2_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    const int* meta, void* dk, void* dv, int b, int h, int s,
                                    int hd, int tokens_total, int causal, int dtype,
                                    int cuda_cores, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, meta, nullptr, dk, dv, nullptr, b, h, s,
               tokens_total, causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(2, dtype, hd, cuda_cores, a);
}
