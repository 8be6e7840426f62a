// Flash-attention backward for NVIDIA Hopper (sm_90a): K5a (dq) and K5b
// (dk, dv).
//
// Replaces the Pallas TPU kernels of oryx_tpu/ops/pallas/flash_attention.py
// launched by `_mha_backward`: `_dq_kernel` (K5a) and `_dkv_kernel` (K5b).
// They compute the gradient of the forward in flash_attention.cu from the
// saved per-row logsumexp `lse` and Delta = rowsum(dO * O), both fp32
// [B, Hq, Tq], with the forward's mask (causal on explicit positions AND
// segment equality AND kv validity; masked logits are NEG, not -inf):
//   p  = exp(s - lse)                       s = q.k * scale, masked to NEG
//   dq = sum over kv of (p * (dO.v - Delta) * scale) . k
//   dv = sum over q heads of the group and q rows of p^T . dO
//   dk = sum over the same of ds^T . q,     ds = p * (dO.v - Delta) * scale
// The Pallas rounding points are kept: p is rounded to dO's dtype before
// p^T.dO, ds to k's (q's) dtype before ds.k (ds^T.q); every product
// accumulates in fp32. The outputs are written in the input dtype, which is
// the value of JAX's fp32 result cast once. A masked p is exactly 0, as
// exp(NEG - lse) is for every finite or FLT_MAX lse.
//
// What bounds it on an H100: five matrix products per live (q, kv) pair of
// rows (s and dp recomputed in each kernel, then dq, or dv and dk), 6 D and
// 8 D flops, ~2.5x the forward's work and far above the ~295 flop/byte
// ridge: tensor-core operations. The bf16 kernels are built for that:
//   * every product is a `wgmma` (m64n64k16, or m64n16k16 for a 16-column
//     tail), fp32 accumulators in registers. s and dp (s^T and dp^T in K5b)
//     read both operands from shared memory; p and ds are rounded to bf16 in
//     registers and feed dq += ds.k, dv += p^T.dO and dk += ds^T.q as the
//     register A operand (the m64n64 accumulator of 16 columns is the m64k16
//     A fragment), with no trip through shared memory;
//   * no transposed copies: the second use of a tile (k in dq, dO and q in
//     dv/dk) reads the same swizzled tile MN-major;
//   * warp specialisation: one producer warp streams tiles with TMA
//     (`cp.async.bulk.tensor`, 128-byte swizzle; 32-byte swizzle for a
//     16-column tail) through a three-stage ring of `mbarrier`s, and stages
//     the streamed rows' positions, segments, validity (and lse, Delta in
//     K5b) beside them; two consumer warpgroups share every streamed tile.
//     K5a's dq += ds.k of a tile runs while the next tile's s and dp are
//     issued, its stage released after the next wait;
//   * skipping without per-tile syncs: two small kernels (csrc/tile_map.cuh,
//     shared with the forward) compute, once per call, which 64 x 64 (q, kv)
//     cells are dead, partial or fully visible (the rules of `_tile_flags`
//     in ops/cuda/flash_attention.py), and each
//     block copies its cells into shared memory. Dead tiles are never
//     loaded (with arange or slot positions this is the causal clamp), and
//     a fully visible cell skips the per-element mask;
//   * K5a: one block per (128 q rows, q head, batch row), streaming 64-row
//     K and V tiles; the causally heaviest (last) q tiles launch first.
//   * K5b: one block per (64 kv rows, kv head, batch row), streaming
//     64-row q and dO tiles of the G q heads; the heaviest (first) kv
//     tiles launch first. dk and dv with s and dp (2 x 64 x 128 fp32 each
//     at D = 128) do not fit one warpgroup in the 168 registers a 9-warp
//     block allows (registers are split per SM quarter; `setmaxnreg` did
//     not move ptxas's allocation past the launch bound), so the two
//     warpgroups split the outputs over the same rows: one sums dv, the
//     other dk, and both recompute s^T (2 D more of 8 D flops a pair).
//   * No atomics and no split over blocks: every dq, dk, dv element is
//     summed by one thread in a fixed order, so gradients are identical
//     from run to run.
//   * D: a tile is 64-column sub-tiles plus at most one 16-column tail, so
//     the widths are 16 (D <= 16), 80 (64 + 16: the ViT's 72) and 128. D = 72
//     loads two TMA boxes, 64 columns and 16 (the last 8 past D read as
//     zero), into two swizzled sub-tiles.
//   * fp32: the FMA kernels of the first port (lane j owns column j of a
//     32-wide tile) for the small test heads; a TF32 path would change their
//     numbers.
//
// Layouts: q/dO/dq are [B, Hq, Tq, D] and k/v/dk/dv [B, Hk, Tk, D] given by
// element strides (batch, head, token) with the feature dim contiguous; kv
// head of q head h is h / (Hq / Hk). bf16 operands must have 16-byte
// aligned bases and strides (TMA): the wrapper copies any other operand into
// storage whose rows are padded to 8 elements. Rows past Tq/Tk are
// handled in the kernel: kv rows past Tk are invalid, q rows past Tq add
// nothing and are never stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile_map.cuh"

namespace {

constexpr float NEG = -0.7f * FLT_MAX;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long do_sb, do_sh, do_st;
  long long dq_sb, dq_sh, dq_st;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
  const int* q_pos;
  const int* kv_pos;
  const int* q_seg;
  const int* kv_seg;
  const int* kv_valid;
  // [B, nqt, nkt] int8 over 64 x 64 (q, kv) cells: 0 dead, 1 partial,
  // 2 every pair visible (bf16 kernels).
  const signed char* tiles;
  int nqt, nkt;
  int B, Hq, Hk, Tq, Tk, D;
  float scale;
  int causal, has_segments, kv_arange;
};

// Position max and segment range over the live rows of a tile.
struct Stats {
  int any, pos_min, pos_max, seg_min, seg_max;
};

// Scalar fill of a [nrows][DP] slab with row stride `ds` (an odd stride
// rules out vector stores).
__device__ void load_rows_f32(float* dst, int ds, const float* src,
                              long long rs, int row0, int nrows, int nT,
                              int D, int DP) {
  for (int i = threadIdx.x; i < nrows * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP, row = row0 + r;
    dst[r * ds + c] = (row < nT && c < D) ? src[row * rs + c] : 0.f;
  }
}

// Stage the int arrays of rows [row0, row0 + n) of one side: positions,
// segments and a live flag (kv: valid and < Tk; q: < Tq). Returns the
// tile's stats, reduced by warp 0 (block-uniform). Pad conventions follow
// Pallas: kv rows past Tk have segment -2 and are invalid, q rows past Tq
// segment -1.
__device__ Stats stage_ints(const int* pos, const int* seg, const int* valid,
                            int b, int T, int row0, int n, int* sPos,
                            int* sSeg, int* sLive, int* red) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = row0 + i;
    const bool in = row < T;
    const long long at = (long long)b * T + row;
    sPos[i] = in ? pos[at] : 0;
    sSeg[i] = in ? seg[at] : (valid != nullptr ? -2 : -1);
    sLive[i] = in && (valid == nullptr || valid[at] > 0) ? 1 : 0;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int any = 0, pmin = INT_MAX, pmax = INT_MIN, smin = INT_MAX,
        smax = INT_MIN;
    for (int i = threadIdx.x; i < n; i += 32) {
      if (sLive[i]) {
        any = 1;
        pmin = min(pmin, sPos[i]);
        pmax = max(pmax, sPos[i]);
        smin = min(smin, sSeg[i]);
        smax = max(smax, sSeg[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      any |= __shfl_xor_sync(0xffffffffu, any, off);
      pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
      pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
      smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
      smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
    }
    if (threadIdx.x == 0) {
      red[0] = any;
      red[1] = pmin;
      red[2] = pmax;
      red[3] = smin;
      red[4] = smax;
    }
  }
  __syncthreads();
  Stats s{red[0], red[1], red[2], red[3], red[4]};
  __syncthreads();
  return s;
}

// Whether some (q, kv) pair of a q tile and a kv tile can be unmasked.
__device__ __forceinline__ bool tiles_meet(const Params& p, Stats qs,
                                           Stats ks) {
  if (!qs.any || !ks.any) return false;
  if (p.causal && ks.pos_min > qs.pos_max) return false;
  if (p.has_segments && (ks.seg_max < qs.seg_min || ks.seg_min > qs.seg_max))
    return false;
  return true;
}

__device__ __forceinline__ bool unmasked(const Params& p, int qpos, int qseg,
                                         int kpos, int kseg, int klive) {
  return klive && (!p.causal || qpos >= kpos) &&
         (!p.has_segments || qseg == kseg);
}

// Number of kv tiles K5a visits: with a causal mask over arange kv
// positions, tiles that start after the q tile's largest position are dead.
__device__ __forceinline__ int kv_tiles(const Params& p, Stats qs, int BK) {
  int nk = (p.Tk + BK - 1) / BK;
  if (p.causal && p.kv_arange) {
    if (!qs.any || qs.pos_max < 0) return 0;
    nk = min(nk, qs.pos_max / BK + 1);
  }
  return nk;
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, one producer warp and two consumer warpgroups.
// ---------------------------------------------------------------------------

constexpr int WGS = 2;                    // consumer warpgroups of 64 rows
// + the producer warp. Registers are split per SM quarter: 9 warps put 3
// on one quarter and cap a thread at 168 registers.
constexpr int NTHREADS = WGS * 128 + 32;
constexpr int PRODUCER = WGS * 4;  // the producer's warp index
constexpr int NST = 3;                    // ring stages
constexpr int SROWS = 64;                 // rows of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;

// Tensor maps of the four bf16 operands: 64-column boxes (128-byte swizzle)
// and 16-column tail boxes (32-byte swizzle), each with the box rows of
// that operand's tile in this kernel.
struct Maps {
  CUtensorMap q, q_tail, k, k_tail, v, v_tail, dout, dout_tail;
};

struct BwdArgs {
  Maps m;
  Params p;
};

// The tile helpers of csrc/hopper.cuh, shared with the forward.
using hopper::align1024;
using hopper::fence_acc;
using hopper::load_tile;
using hopper::mma_acc;
using hopper::mma_rows;
using hopper::store_acc;
using hopper::Tile;

// ---- K5a bf16: dq. 128 q rows a block, 64-row K/V tiles streamed. ---------

template <int NS, int TL>
constexpr int smem_dq_bf16() {
  return 1024 + 2 * Tile<NS, TL, WGS * 64>::BYTES +
         NST * (2 * Tile<NS, TL, SROWS>::BYTES + 1024) + 64;
}

template <int NS, int TL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_bf16(const __grid_constant__ BwdArgs args) {
  using QT = Tile<NS, TL, WGS * 64>;
  using KT = Tile<NS, TL, SROWS>;
  constexpr int STAGE = 2 * KT::BYTES + 1024;  // K, V, then 3 x 64 ints
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sdO = sQ + QT::BYTES;
  unsigned char* ring = sdO + QT::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * STAGE);
  uint64_t* empty = full + NST;
  uint64_t* fixed = empty + NST;

  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hk);
  const int qb = gridDim.y - 1 - blockIdx.y;  // causally heaviest first
  const int q0 = qb * WGS * 64;
  // This block's cells of the map, [kv tile][warpgroup], in shared memory:
  // the walk over kv tiles reads no device memory.
  signed char* sflag = reinterpret_cast<signed char*>(fixed + 1);
  const signed char* tf = p.tiles + (long long)b * p.nqt * p.nkt;
  for (int i = threadIdx.x; i < p.nkt * WGS; i += blockDim.x) {
    const int qt = WGS * qb + i % WGS;
    sflag[i] = qt < p.nqt ? tf[qt * p.nkt + i / WGS] : 0;
  }
  auto flag = [&](int w, int kt) -> int { return sflag[kt * WGS + w]; };
  auto live = [&](int kt) {
    int any = 0;
#pragma unroll
    for (int w = 0; w < WGS; ++w) any |= flag(w, kt);
    return any != 0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], WGS * 4);
    }
    hopper::mbar_init(fixed, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == PRODUCER) {
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(fixed, 2 * QT::BYTES);
      load_tile<NS, TL, WGS * 64>(sQ, &args.m.q, &args.m.q_tail, fixed, q0,
                                  h, b);
      load_tile<NS, TL, WGS * 64>(sdO, &args.m.dout, &args.m.dout_tail,
                                  fixed, q0, h, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < p.nkt; ++kt) {
      if (!live(kt)) continue;
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* st = ring + stage * STAGE;
      int* ints = reinterpret_cast<int*>(st + 2 * KT::BYTES);
      for (int r = lane; r < SROWS; r += 32) {
        const int row = kt * SROWS + r;
        const bool in = row < p.Tk;
        const long long at = (long long)b * p.Tk + row;
        ints[r] = in ? p.kv_pos[at] : 0;
        ints[SROWS + r] = in ? p.kv_seg[at] : -2;
        ints[2 * SROWS + r] = in && p.kv_valid[at] > 0;
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * KT::BYTES);
        load_tile<NS, TL, SROWS>(st, &args.m.k, &args.m.k_tail, &full[stage],
                                 kt * SROWS, hk, b);
        load_tile<NS, TL, SROWS>(st + KT::BYTES, &args.m.v, &args.m.v_tail,
                                 &full[stage], kt * SROWS, hk, b);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8 of them (the accumulator layout).
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int qt = WGS * qb + wg;
  const int r0 = q0 + 64 * wg + 16 * (warp & 3) + g;
  const long long rowbase = ((long long)b * p.Hq + h) * p.Tq;
  const float sl2 = p.scale * LOG2E;
  int qpos[2], qseg[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const bool in = row < p.Tq;
    qpos[i] = in ? p.q_pos[(long long)b * p.Tq + row] : 0;
    qseg[i] = in ? p.q_seg[(long long)b * p.Tq + row] : -1;
    lse2[i] = in ? p.lse[rowbase + row] * LOG2E : FLT_MAX;
    dlt[i] = in ? p.delta[rowbase + row] : 0.f;
  }
  float am[NS > 0 ? NS : 1][32], at[8];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) am[j][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) at[e] = 0.f;

  hopper::mbar_wait(fixed, 0);
  const uint32_t aQ = hopper::smem_addr(sQ), adO = hopper::smem_addr(sdO);
  // dq += ds.k of a tile runs while the next tile's s and dp are issued:
  // its stage (K) is released only after the next wait.
  int held = -1;
  uint32_t ds[4][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < p.nkt; ++kt) {
    if (!live(kt)) continue;
    hopper::mbar_wait(&full[stage], phase);
    const int f = flag(wg, kt);  // uniform over the warpgroup
    unsigned char* st = ring + stage * STAGE;
    const uint32_t aK = hopper::smem_addr(st), aV = aK + KT::BYTES;
    float s[32], dp[32];  // written by wgmma (scale-d 0) before use
    if (f) {
      hopper::wg_fence();
      mma_rows<NS, TL>(s, aQ, WGS * 64, 64 * wg, aK, SROWS, 0);
      mma_rows<NS, TL>(dp, adO, WGS * 64, 64 * wg, aV, SROWS, 0);
      hopper::wg_commit();
    }
    hopper::wg_wait0();  // s, dp and the previous tile's dq
    if (held >= 0) {
      fence_acc<NS, TL>(am, at);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[held]);
      held = -1;
    }
    if (f) {
      const int* kpos = reinterpret_cast<const int*>(st + 2 * KT::BYTES);
      const int* kseg = kpos + SROWS;
      const int* klive = kseg + SROWS;
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      // p = exp(masked s - lse); ds = p (dp - Delta) scale, into dp.
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e >> 2) + 2 * t + (e & 1), i = (e >> 1) & 1;
        const bool vis =
            f == 2 ||
            (klive[c] && (!p.causal || qpos[i] >= kpos[c]) &&
             (!p.has_segments || qseg[i] == kseg[c]));
        const float pr = vis ? exp2f(s[e] * sl2 - lse2[i]) : 0.f;
        dp[e] = pr * (dp[e] - dlt[i]) * p.scale;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(ds[kk], dp, kk);
      // dq += ds (bf16) . k, waited on at the next tile
      fence_acc<NS, TL>(am, at);
      hopper::wg_fence();
      mma_acc<NS, TL>(am, at, ds, aK, SROWS, 0);
      hopper::wg_commit();
      held = stage;
    } else {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    }
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
  hopper::wg_wait0();
  fence_acc<NS, TL>(am, at);

  __nv_bfloat16* dqb =
      static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  store_acc<NS, TL>(dqb, p.dq_st, am, at, r0, p.Tq, p.D, t);
}

// ---- K5b bf16: dk, dv. 64 kv rows a block, 64-row q/dO tiles streamed. ----
// The two consumer warpgroups share the block's 64 kv rows and split the
// outputs: warpgroup 0 holds dv (s^T, then dv += p^T.dO), warpgroup 1 dk
// (s^T and dp^T, then dk += ds^T.q). Recomputing s^T in both costs 2 D of
// the 8 D flops a pair, and keeps each warpgroup within the 168 registers
// of a 9-warp block (one accumulator of 64 x D, not two).

template <int NS, int TL>
constexpr int smem_dkv_bf16() {
  return 1024 + 2 * Tile<NS, TL, SROWS>::BYTES +
         NST * (2 * Tile<NS, TL, SROWS>::BYTES + 1024) + 64;
}

template <int NS, int TL>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ BwdArgs args) {
  using T = Tile<NS, TL, SROWS>;
  // q, dO, then q positions, segments, lse * log2(e), Delta (4 x 64 x 4 B).
  constexpr int STAGE = 2 * T::BYTES + 1024;
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + T::BYTES;
  unsigned char* ring = sV + T::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * STAGE);
  uint64_t* empty = full + NST;
  uint64_t* fixed = empty + NST;

  const int b = blockIdx.x / p.Hk, hk = blockIdx.x % p.Hk;
  const int G = p.Hq / p.Hk;
  const int kt = blockIdx.y;  // causally heaviest (first) tiles first
  const int kv0 = kt * SROWS;
  const int nq = (p.Tq + SROWS - 1) / SROWS;
  // This block's column of the map, one cell per q tile, in shared memory.
  signed char* sflag = reinterpret_cast<signed char*>(fixed + 1);
  const signed char* tf = p.tiles + (long long)b * p.nqt * p.nkt;
  for (int i = threadIdx.x; i < p.nqt; i += blockDim.x)
    sflag[i] = tf[i * p.nkt + kt];

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], WGS * 4);
    }
    hopper::mbar_init(fixed, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == PRODUCER) {
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(fixed, 2 * T::BYTES);
      load_tile<NS, TL, SROWS>(sK, &args.m.k, &args.m.k_tail, fixed, kv0, hk,
                               b);
      load_tile<NS, TL, SROWS>(sV, &args.m.v, &args.m.v_tail, fixed, kv0, hk,
                               b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int gi = 0; gi < G; ++gi) {
      const int h = hk * G + gi;
      const long long rowbase = ((long long)b * p.Hq + h) * p.Tq;
      for (int qt = 0; qt < nq; ++qt) {
        if (!sflag[qt]) continue;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * STAGE;
        int* ints = reinterpret_cast<int*>(st + 2 * T::BYTES);
        float* rows = reinterpret_cast<float*>(ints + 2 * SROWS);
        for (int r = lane; r < SROWS; r += 32) {
          const int row = qt * SROWS + r;
          const bool in = row < p.Tq;
          const long long at = (long long)b * p.Tq + row;
          ints[r] = in ? p.q_pos[at] : 0;
          ints[SROWS + r] = in ? p.q_seg[at] : -1;
          rows[r] = in ? p.lse[rowbase + row] * LOG2E : FLT_MAX;
          rows[SROWS + r] = in ? p.delta[rowbase + row] : 0.f;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[stage], 2 * T::BYTES);
          load_tile<NS, TL, SROWS>(st, &args.m.q, &args.m.q_tail,
                                   &full[stage], qt * SROWS, h, b);
          load_tile<NS, TL, SROWS>(st + T::BYTES, &args.m.dout,
                                   &args.m.dout_tail, &full[stage],
                                   qt * SROWS, h, b);
        } else {
          hopper::mbar_arrive(&full[stage]);
        }
        if (++stage == NST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumers: both warpgroups own kv rows kv0 .. kv0 + 63; this thread
  // rows r0 and r0 + 8 of them. Warpgroup 0 sums dv, warpgroup 1 dk.
  const bool is_dk = warp >= 4;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = kv0 + 16 * (warp & 3) + g;
  const float sl2 = p.scale * LOG2E;
  int kpos[2], kseg[2], klive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const bool in = row < p.Tk;
    const long long at = (long long)b * p.Tk + row;
    kpos[i] = in ? p.kv_pos[at] : 0;
    kseg[i] = in ? p.kv_seg[at] : -2;
    klive[i] = in && p.kv_valid[at] > 0;
  }
  float am[NS > 0 ? NS : 1][32], at[8];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) am[j][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) at[e] = 0.f;

  hopper::mbar_wait(fixed, 0);
  const uint32_t aK = hopper::smem_addr(sK), aV = hopper::smem_addr(sV);
  int stage = 0;
  uint32_t phase = 0;
  for (int gi = 0; gi < G; ++gi) {
    for (int qt = 0; qt < nq; ++qt) {
      const int f = sflag[qt];  // uniform over the block
      if (!f) continue;
      hopper::mbar_wait(&full[stage], phase);
      unsigned char* st = ring + stage * STAGE;
      const uint32_t aQ = hopper::smem_addr(st), adO = aQ + T::BYTES;
      const int* qpos = reinterpret_cast<const int*>(st + 2 * T::BYTES);
      const int* qseg = qpos + SROWS;
      const float* lse2 = reinterpret_cast<const float*>(qseg + SROWS);
      const float* dlt = lse2 + SROWS;
      // p^T = exp(masked s^T - lse) in place: rows are kv, columns q.
      auto probs = [&](float (&x)[32]) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e >> 2) + 2 * t + (e & 1), i = (e >> 1) & 1;
          const bool vis =
              f == 2 ||
              (klive[i] && (!p.causal || qpos[c] >= kpos[i]) &&
               (!p.has_segments || qseg[c] == kseg[i]));
          x[e] = vis ? exp2f(x[e] * sl2 - lse2[c]) : 0.f;
        }
      };
      uint32_t x[4][4];  // p^T (dv) or ds^T (dk) in bf16, the A operand
      float s[32];       // written by wgmma (scale-d 0) before use
      if (!is_dk) {
        hopper::wg_fence();
        mma_rows<NS, TL>(s, aK, SROWS, 0, aQ, SROWS, 0);
        hopper::wg_commit();
        hopper::wg_wait0();
        hopper::fence_regs(s);
        probs(s);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(x[kk], s, kk);
      } else {
        float dp[32];
        hopper::wg_fence();
        mma_rows<NS, TL>(s, aK, SROWS, 0, aQ, SROWS, 0);
        mma_rows<NS, TL>(dp, aV, SROWS, 0, adO, SROWS, 0);
        hopper::wg_commit();
        hopper::wg_wait0();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        probs(s);
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e >> 2) + 2 * t + (e & 1);
          dp[e] = s[e] * (dp[e] - dlt[c]) * p.scale;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(x[kk], dp, kk);
      }
      // dv += p^T (bf16) . dO, or dk += ds^T (bf16) . q
      fence_acc<NS, TL>(am, at);
      hopper::wg_fence();
      mma_acc<NS, TL>(am, at, x, is_dk ? aQ : adO, SROWS, 0);
      hopper::wg_commit();
      hopper::wg_wait0();
      fence_acc<NS, TL>(am, at);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  using bf = __nv_bfloat16;
  bf* out = is_dk ? static_cast<bf*>(p.dk) + b * p.dk_sb + hk * p.dk_sh
                  : static_cast<bf*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
  store_acc<NS, TL>(out, is_dk ? p.dk_st : p.dv_st, am, at, r0, p.Tk, p.D,
                    t);
}

// ---------------------------------------------------------------------------
// fp32: 4 warps, plain FMA. Lane j owns column j of a 32-wide tile for the
// logits and feature columns lane + 32 c of the accumulators.
// ---------------------------------------------------------------------------

constexpr int F_BQ = 16;  // K5a: q rows per block (4 per warp)
constexpr int F_BK = 32;  // K5a: kv rows per tile; K5b: kv rows per block
constexpr int F_TQ = 32;  // K5b: q rows per tile

template <int DP>
constexpr int smem_dq_f32() {
  return (2 * F_BQ * DP + 2 * F_BK * (DP + 1)) * 4 + 3 * F_BK * 4;
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_f32(const Params p) {
  constexpr int RW = F_BQ / 4;
  constexpr int SK = DP + 1;  // lane j reads row j
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + F_BQ * DP;
  float* sK = sdO + F_BQ * DP;
  float* sV = sK + F_BK * SK;
  int* sKpos = reinterpret_cast<int*>(sV + F_BK * SK);
  int* sKseg = sKpos + F_BK;
  int* sKlive = sKseg + F_BK;
  __shared__ int sQpos[F_BQ], sQseg[F_BQ], sQlive[F_BQ], red[5];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * F_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dob =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long rowbase = ((long long)b * p.Hq + h) * p.Tq;

  const Stats qs = stage_ints(p.q_pos, p.q_seg, nullptr, b, p.Tq, q0, F_BQ,
                              sQpos, sQseg, sQlive, red);
  load_rows_f32(sQ, DP, qb, p.q_st, q0, F_BQ, p.Tq, p.D, DP);
  load_rows_f32(sdO, DP, dob, p.do_st, q0, F_BQ, p.Tq, p.D, DP);

  float lse[RW], dlt[RW], acc[RW][DP / 32];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    const bool in = row < p.Tq;
    lse[r] = in ? p.lse[rowbase + row] : FLT_MAX;
    dlt[r] = in ? p.delta[rowbase + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) acc[r][c] = 0.f;
  }

  const int nk = kv_tiles(p, qs, F_BK);
  for (int it = 0; it < nk; ++it) {
    const int kv0 = it * F_BK;
    __syncthreads();
    const Stats ks = stage_ints(p.kv_pos, p.kv_seg, p.kv_valid, b, p.Tk, kv0,
                                F_BK, sKpos, sKseg, sKlive, red);
    if (!tiles_meet(p, qs, ks)) continue;
    load_rows_f32(sK, SK, kb, p.k_st, kv0, F_BK, p.Tk, p.D, DP);
    load_rows_f32(sV, SK, vb, p.v_st, kv0, F_BK, p.Tk, p.D, DP);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int lr = warp * RW + r;
      const float* qr = sQ + lr * DP;
      const float* dor = sdO + lr * DP;
      const float* kr = sK + lane * SK;
      const float* vr = sV + lane * SK;
      float dot = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        dot = fmaf(qr[d], kr[d], dot);
        dpv = fmaf(dor[d], vr[d], dpv);
      }
      const float s = unmasked(p, sQpos[lr], sQseg[lr], sKpos[lane],
                               sKseg[lane], sKlive[lane])
                          ? dot * p.scale
                          : NEG;
      const float ds = expf(s - lse[r]) * (dpv - dlt[r]) * p.scale;
      for (int j = 0; j < F_BK; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < DP / 32; ++c)
          acc[r][c] = fmaf(dsj, sK[j * SK + lane + 32 * c], acc[r][c]);
      }
    }
  }

  float* dqb = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) {
      const int col = lane + 32 * c;
      if (col < p.D) dqb[row * p.dq_st + col] = acc[r][c];
    }
  }
}

template <int DP>
constexpr int smem_dkv_f32() {
  return (2 * F_BK * DP + 2 * F_TQ * (DP + 1)) * 4 + 3 * F_BK * 4;
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dkv_f32(const Params p) {
  constexpr int RW = F_BK / 4;  // kv rows per warp
  constexpr int SQS = DP + 1;   // lane j reads row j
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + F_BK * DP;
  float* sQ = sV + F_BK * DP;
  float* sdO = sQ + F_TQ * SQS;
  int* sKpos = reinterpret_cast<int*>(sdO + F_TQ * SQS);
  int* sKseg = sKpos + F_BK;
  int* sKlive = sKseg + F_BK;
  __shared__ int sQpos[F_TQ], sQseg[F_TQ], sQlive[F_TQ], red[5];
  __shared__ float sLse[F_TQ], sDlt[F_TQ];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv0 = blockIdx.x * F_BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hk;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const Stats ks = stage_ints(p.kv_pos, p.kv_seg, p.kv_valid, b, p.Tk, kv0,
                              F_BK, sKpos, sKseg, sKlive, red);
  load_rows_f32(sK, DP, kb, p.k_st, kv0, F_BK, p.Tk, p.D, DP);
  load_rows_f32(sV, DP, vb, p.v_st, kv0, F_BK, p.Tk, p.D, DP);

  float dk[RW][DP / 32], dv[RW][DP / 32];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) dk[r][c] = dv[r][c] = 0.f;

  const int nq = (p.Tq + F_TQ - 1) / F_TQ;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const float* qb =
        static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dob =
        static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long rowbase = ((long long)b * p.Hq + h) * p.Tq;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * F_TQ;
      __syncthreads();
      const Stats qs = stage_ints(p.q_pos, p.q_seg, nullptr, b, p.Tq, q0,
                                  F_TQ, sQpos, sQseg, sQlive, red);
      if (!tiles_meet(p, qs, ks)) continue;
      for (int i = threadIdx.x; i < F_TQ; i += blockDim.x) {
        const int row = q0 + i;
        const bool in = row < p.Tq;
        sLse[i] = in ? p.lse[rowbase + row] : FLT_MAX;
        sDlt[i] = in ? p.delta[rowbase + row] : 0.f;
      }
      load_rows_f32(sQ, SQS, qb, p.q_st, q0, F_TQ, p.Tq, p.D, DP);
      load_rows_f32(sdO, SQS, dob, p.do_st, q0, F_TQ, p.Tq, p.D, DP);
      __syncthreads();

#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int lr = warp * RW + r;
        const float* kr = sK + lr * DP;
        const float* vr = sV + lr * DP;
        const float* qc = sQ + lane * SQS;
        const float* doc = sdO + lane * SQS;
        float dot = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) {
          dot = fmaf(kr[d], qc[d], dot);
          dpv = fmaf(vr[d], doc[d], dpv);
        }
        const float s =
            sQlive[lane] && unmasked(p, sQpos[lane], sQseg[lane], sKpos[lr],
                                     sKseg[lr], sKlive[lr])
                ? dot * p.scale
                : NEG;
        const float pr = expf(s - sLse[lane]);
        const float ds = pr * (dpv - sDlt[lane]) * p.scale;
        for (int j = 0; j < F_TQ; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pr, j);
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int c = 0; c < DP / 32; ++c) {
            dv[r][c] = fmaf(pj, sdO[j * SQS + lane + 32 * c], dv[r][c]);
            dk[r][c] = fmaf(dsj, sQ[j * SQS + lane + 32 * c], dk[r][c]);
          }
        }
      }
    }
  }

  float* dkb = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  float* dvb = static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = kv0 + warp * RW + r;
    if (row >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) {
      const int col = lane + 32 * c;
      if (col < p.D) {
        dkb[row * p.dk_st + col] = dk[r][c];
        dvb[row * p.dv_st + col] = dv[r][c];
      }
    }
  }
}

template <typename Kernel, typename Arg>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   const Arg& arg, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(arg);
  return cudaGetLastError();
}

// The tensor maps of one bf16 kernel: `qrows` / `kvrows` are the box rows
// of the q-side (q, dO) and kv-side (k, v) tiles. False when TMA cannot
// take a layout.
bool make_maps(Maps* m, const Params& p, int qrows, int kvrows, bool main,
               bool tail) {
  struct Op {
    CUtensorMap *mm, *mt;
    const void* base;
    long long sb, sh, st;
    int H, T, rows;
  } ops[4] = {
      {&m->q, &m->q_tail, p.q, p.q_sb, p.q_sh, p.q_st, p.Hq, p.Tq, qrows},
      {&m->dout, &m->dout_tail, p.dout, p.do_sb, p.do_sh, p.do_st, p.Hq,
       p.Tq, qrows},
      {&m->k, &m->k_tail, p.k, p.k_sb, p.k_sh, p.k_st, p.Hk, p.Tk, kvrows},
      {&m->v, &m->v_tail, p.v, p.v_sb, p.v_sh, p.v_st, p.Hk, p.Tk, kvrows},
  };
  for (const Op& o : ops) {
    if (main && !hopper::make_map(o.mm, o.base, o.sb, o.sh, o.st, p.B, o.H,
                                  o.T, p.D, 64, o.rows))
      return false;
    if (tail && !hopper::make_map(o.mt, o.base, o.sb, o.sh, o.st, p.B, o.H,
                                  o.T, p.D, 16, o.rows))
      return false;
  }
  return true;
}

// Shared bytes of a block's cells of the map: one per warpgroup and
// streamed tile.
int flag_bytes(int n, int wgs) { return (wgs * n + 15) / 16 * 16; }

// Widths: 16 (D <= 16: one 16-column tail), 80 (64 + 16, the ViT's 72), 128
// (two 64-column sub-tiles).
template <int NS, int TL>
cudaError_t dq_bf16_w(const Params& p, cudaStream_t s) {
  BwdArgs a;
  a.p = p;
  if (!make_maps(&a.m, p, WGS * 64, SROWS, NS > 0, TL > 0))
    return cudaErrorInvalidValue;
  dim3 grid(p.B * p.Hq, (p.Tq + WGS * 64 - 1) / (WGS * 64));
  return launch(flash_bwd_dq_bf16<NS, TL>, grid, NTHREADS,
                smem_dq_bf16<NS, TL>() + flag_bytes(p.nkt, WGS), a, s);
}

template <int NS, int TL>
cudaError_t dkv_bf16_w(const Params& p, cudaStream_t s) {
  BwdArgs a;
  a.p = p;
  if (!make_maps(&a.m, p, SROWS, SROWS, NS > 0, TL > 0))
    return cudaErrorInvalidValue;
  dim3 grid(p.B * p.Hk, (p.Tk + SROWS - 1) / SROWS);
  return launch(flash_bwd_dkv_bf16<NS, TL>, grid, NTHREADS,
                smem_dkv_bf16<NS, TL>() + flag_bytes(p.nqt, 1), a, s);
}

cudaError_t dq_bf16(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return dq_bf16_w<0, 1>(p, s);
  if (p.D <= 80) return dq_bf16_w<1, 1>(p, s);
  return dq_bf16_w<2, 0>(p, s);
}

cudaError_t dkv_bf16(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return dkv_bf16_w<0, 1>(p, s);
  if (p.D <= 80) return dkv_bf16_w<1, 1>(p, s);
  return dkv_bf16_w<2, 0>(p, s);
}

cudaError_t dq_f32(const Params& p, cudaStream_t s) {
  dim3 grid((p.Tq + F_BQ - 1) / F_BQ, p.Hq, p.B);
  if (p.D <= 32)
    return launch(flash_bwd_dq_f32<32>, grid, 128, smem_dq_f32<32>(), p, s);
  if (p.D <= 96)
    return launch(flash_bwd_dq_f32<96>, grid, 128, smem_dq_f32<96>(), p, s);
  return launch(flash_bwd_dq_f32<128>, grid, 128, smem_dq_f32<128>(), p, s);
}

cudaError_t dkv_f32(const Params& p, cudaStream_t s) {
  dim3 grid((p.Tk + F_BK - 1) / F_BK, p.Hk, p.B);
  if (p.D <= 32)
    return launch(flash_bwd_dkv_f32<32>, grid, 128, smem_dkv_f32<32>(), p, s);
  if (p.D <= 96)
    return launch(flash_bwd_dkv_f32<96>, grid, 128, smem_dkv_f32<96>(), p, s);
  return launch(flash_bwd_dkv_f32<128>, grid, 128, smem_dkv_f32<128>(), p,
                s);
}

bool valid_shape(int B, int Hq, int Hk, int Tq, int Tk, int D) {
  return B > 0 && Hq > 0 && Hk > 0 && Hq % Hk == 0 && Tq > 0 && Tk > 0 &&
         D > 0 && D <= 128 && B <= 65535 && Hq <= 65535;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, const long long* st,
                   const void* q_pos, const void* kv_pos, const void* q_seg,
                   const void* kv_seg, const void* kv_valid, int B, int Hq,
                   int Hk, int Tq, int Tk, int D, float scale, int causal,
                   int has_segments, int kv_arange, const void* tiles,
                   int nqt, int nkt) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_sb = st[0], p.q_sh = st[1], p.q_st = st[2];
  p.k_sb = st[3], p.k_sh = st[4], p.k_st = st[5];
  p.v_sb = st[6], p.v_sh = st[7], p.v_st = st[8];
  p.do_sb = st[9], p.do_sh = st[10], p.do_st = st[11];
  p.dq_sb = st[12], p.dq_sh = st[13], p.dq_st = st[14];
  p.dk_sb = st[15], p.dk_sh = st[16], p.dk_st = st[17];
  p.dv_sb = st[18], p.dv_sh = st[19], p.dv_st = st[20];
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.kv_valid = static_cast<const int*>(kv_valid);
  p.tiles = static_cast<const signed char*>(tiles);
  p.nqt = nqt, p.nkt = nkt;
  p.B = B, p.Hq = Hq, p.Hk = Hk, p.Tq = Tq, p.Tk = Tk, p.D = D;
  p.scale = scale;
  p.causal = causal, p.has_segments = has_segments, p.kv_arange = kv_arange;
  return p;
}

}  // namespace

// Plain C entry points (bound with ctypes), one per kernel and dtype.
// `strides` holds 21 element strides: (batch, head, token) for q, k, v, dO,
// dq, dk and dv; lse and delta are contiguous fp32 [B, Hq, Tq]. `tiles` is
// the int8 [B, nqt, nkt] cell map of the bf16 kernels (64 x 64 cells; the
// fp32 kernels ignore it). `dq` (resp. `dk`, `dv`) is written in q's dtype.
// Each returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a shape, or a bf16 layout TMA cannot take);
// nothing is synchronised.
#define ORYX_BWD_ENTRY(NAME, FN)                                             \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* delta, void* dq, void* dk, void* dv,      \
      const long long* strides, const void* q_pos, const void* kv_pos,       \
      const void* q_seg, const void* kv_seg, const void* kv_valid,           \
      const void* tiles, int B, int Hq, int Hk, int Tq, int Tk, int D,       \
      float scale, int causal, int has_segments, int kv_arange, int nqt,     \
      int nkt, void* stream) {                                               \
    if (!valid_shape(B, Hq, Hk, Tq, Tk, D)) return cudaErrorInvalidValue;    \
    const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv,      \
                                 strides, q_pos, kv_pos, q_seg, kv_seg,      \
                                 kv_valid, B, Hq, Hk, Tq, Tk, D, scale,      \
                                 causal, has_segments, kv_arange, tiles,     \
                                 nqt, nkt);                                  \
    return FN(p, static_cast<cudaStream_t>(stream));                         \
  }

// The cell map of the bf16 kernels (csrc/tile_map.cuh).
extern "C" int oryx_flash_bwd_tiles(const void* q_pos, const void* kv_pos,
                                    const void* q_seg, const void* kv_seg,
                                    const void* kv_valid, void* scratch,
                                    int B, int Tq, int Tk, int causal,
                                    int has_segments, void* stream) {
  return tile_map::build(q_pos, kv_pos, q_seg, kv_seg, kv_valid, scratch, B,
                         Tq, Tk, causal, has_segments,
                         static_cast<cudaStream_t>(stream));
}

ORYX_BWD_ENTRY(oryx_flash_bwd_dq_bf16, dq_bf16)
ORYX_BWD_ENTRY(oryx_flash_bwd_dkv_bf16, dkv_bf16)
ORYX_BWD_ENTRY(oryx_flash_bwd_dq_f32, dq_f32)
ORYX_BWD_ENTRY(oryx_flash_bwd_dkv_f32, dkv_f32)
