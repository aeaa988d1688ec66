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
// f32, on the CUDA cores (the first design, kept as the f32 route, and for
// bf16 as the route that flash_attention_bwd_cuda_cores times beside the
// tensor cores').  Tiles of 64 q rows by 64 keys; 256 threads; every operand
// of a tile pair is staged in shared memory as f32 (row stride HD + 1 so the
// threads of a warp hit distinct banks).  Per tile pair one phase computes p
// and ds (each q row owned by 4 threads, 16 keys each, scores and dp in
// registers) into shared tiles, and a second phase accumulates the products
// that need them; dkv keeps dk, dv in registers (each key owned by 4
// threads), dq keeps dq in registers, and fused adds ds k into the f32 dq
// scratch with atomicAdd.  The tensor cores have no full-f32 product (TF32
// keeps 10 mantissa bits), and f32 with TF32 off is the parity setting.

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

// ---- bf16 route, on the tensor cores (the design is in the header) ----

using bf16 = __nv_bfloat16;

constexpr int NT_TC = 128;              // 4 warps
constexpr int DS_RS = BQ + TILE_PAD;    // row stride of the fused kernel's dS^T tile
constexpr float LOG2E = 1.4426950408889634f;

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
  constexpr size_t smem = smem_bytes<HD>();
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
// the CUDA cores (the first design's route, which only timing calls take).
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
