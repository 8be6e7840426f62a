// Flash-attention forward for NVIDIA Hopper (sm_90a): K1.
//
// Replaces the Pallas TPU kernel oryx_tpu/ops/pallas/flash_attention.py
// (`_kernel`, launched by `_mha_forward`). It computes the same function:
// masked GQA attention with an online softmax over kv tiles, where the mask
// is the AND of
//   * causal on explicit positions      (q_pos >= kv_pos),
//   * segment equality                  (q_seg == kv_seg, when has_segments),
//   * kv validity                       (kv_valid > 0).
// Masked logits are set to NEG = -0.7 * FLT_MAX (not -inf), the online state
// (m, l) is fp32, p is rounded to the value dtype before P.V, P.V accumulates
// in fp32, and the output is acc / (l == 0 ? 1 : l) cast to q's dtype.
// Given an `lse` buffer (the training forward, Pallas `with_lse=True`), each
// row's logsumexp m + log(l) is written too, FLT_MAX where l == 0 (Pallas
// `_finalize`). In the bf16 routes a masked key's p is 0, so a row that sees
// no key has l == 0: its output is zero and its lse FLT_MAX, where Pallas,
// which gives masked keys p = 1 while a row's max is NEG, has the mean of
// the values it visited and NEG + log n (the fp32 kernel keeps m = NEG over
// the tiles it visits, and l == 0 only where it skipped them all). The
// backward's p is then 0 there where Pallas has 1/n; no gradient of the
// models differs, since every such row's cotangent is zero.
//
// Three routes, chosen by the entry points:
//
// * bf16, Tq == 1 (the dense-cache decode step): split-KV over the G q heads
//   of a kv head. Decode moves 2 * Tk * D bytes per (row, kv head) for
//   4 * G * D flops per visible key, ~2 G flops a byte: bound by bytes and,
//   at a few thousand keys, by latency. A block per (split, kv head, batch
//   row) holds the group's G <= 16 q heads as the rows of one m16
//   `mma.sync` tile (zero rows past G), so each kv head streams once, and
//   walks its split's contiguous range of 64-row kv tiles (clipped at the
//   causal end with arange kv positions) through a three-stage `cp.async`
//   ring; each of its 4 warps takes 16 rows of every tile with its own
//   (m, l, acc), V is read with `ldmatrix.trans` (no transposed copy), and
//   the warps' partials are merged in shared memory in warp order. A second
//   small kernel merges the splits' partials in split order in fp32, so the
//   output is the same bits run to run (no atomics). A split whose range
//   holds no visible key writes an empty partial (m = NEG, l = 0).
// * bf16, Tq > 1: a wgmma/TMA body. At the path's shapes the work is two
//   matrix products per live 64 x 64 cell (4 D flops per live (q, kv) pair),
//   far above the ~295 flop/byte ridge, so it is bound by tensor-core
//   operations. One producer warp streams the K and V tiles of the live
//   cells with TMA (128-byte swizzle; 32-byte for a 16-column tail, D = 72
//   being a 64- and a 16-column box) through a three-stage `mbarrier` ring,
//   with the streamed rows' positions, segments and validity beside them;
//   two consumer warpgroups own 64 q rows each (one, two blocks an SM, where
//   a grid of two would not fill the card four times over). S = Q K^T is
//   `wgmma` with both operands K-major from shared memory; p is rounded to
//   bf16 in registers and is the A operand of O += P V, with V read
//   MN-major from the same tile (no transposed copy). A tile's O += P V is
//   issued behind the next tile's S and runs while that S goes through the
//   softmax (the accumulator is rescaled once it completes). Which cells are
//   live comes from the
//   per-call cell map of csrc/tile_map.cuh (the backward's): a dead cell is
//   never loaded and costs no barrier, a fully visible one skips the
//   per-element mask.
// * fp32 (the tiny test heads): plain FMA, 16 q rows and 32-row kv tiles a
//   block, tiles passed over by per-tile stats.
//
// Layouts: q/o are [B, Hq, Tq, D] and k/v [B, Hk, Tk, D] given by element
// strides (batch, head, token) with the feature dim contiguous; kv head of q
// head h is h / (Hq / Hk). The int arrays are contiguous int32 [B, T]. bf16
// operands need 16-byte aligned bases and strides (TMA, `cp.async`): the
// wrapper copies any other operand into storage whose rows are padded to 8
// elements. Rows past Tq/Tk are handled in the kernel: kv rows past Tk are
// invalid (read as zero), q rows past Tq are never stored.

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
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, Hq, Tq] contiguous, or null
  long long q_sb, q_sh, q_st;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_st;
  const int* q_pos;
  const int* kv_pos;
  const int* q_seg;
  const int* kv_seg;
  const int* kv_valid;
  int B, Hq, Hk, Tq, Tk, D;
  float scale;
  int causal, has_segments, kv_arange, vec;
  // bf16, Tq > 1: the int8 [B, nqt, nkt] cell map.
  const signed char* tiles;
  int nqt, nkt;
  // bf16, Tq == 1: fp32 split partials, (m, l) [B, Hk * ng, splits, gr, 2]
  // then acc [B, Hk * ng, splits, gr, D]; `tps` kv tiles a split, `ng`
  // chunks of 16 q heads per kv head, `gr` = min(G, 16) rows a chunk.
  float* part;
  int splits, tps, ng, gr;
};

struct QStats {
  int pos_max, seg_min, seg_max;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16(x);
}

// fp32 helpers.

// Copy rows [row0, row0 + nrows) of a [T, D] slab (row stride `rs`) into
// shared memory as [nrows][DP] with row stride `ds`, zero-filling rows past
// T and columns past D. `vec` says 16-byte loads are aligned.
template <typename T, int DP>
__device__ void load_rows(T* dst, int ds, const T* src, long long rs,
                          int row0, int nrows, int nT, int D, int vec) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = DP / E;
  for (int i = threadIdx.x; i < nrows * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * E, row = row0 + r;
    T* d = dst + r * ds + c;
    const T* s = src + row * rs + c;
    if (vec && row < nT && c + E <= D) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j)
        d[j] = (row < nT && c + j < D) ? s[j] : from_float<T>(0.f);
    }
  }
}


// Block-wide max q position and segment range over the tile's real rows.
__device__ QStats q_tile_stats(const Params& p, int b, int q0, int BQ,
                               int* scratch) {
  if (threadIdx.x == 0) {
    scratch[0] = INT_MIN;
    scratch[1] = INT_MAX;
    scratch[2] = INT_MIN;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
    const int row = q0 + r;
    if (row < p.Tq) {
      atomicMax(&scratch[0], p.q_pos[(long long)b * p.Tq + row]);
      const int sg = p.q_seg[(long long)b * p.Tq + row];
      atomicMin(&scratch[1], sg);
      atomicMax(&scratch[2], sg);
    }
  }
  __syncthreads();
  QStats s{scratch[0], scratch[1], scratch[2]};
  __syncthreads();
  return s;
}

// Stage one kv tile's int arrays and decide whether any (q, kv) pair of the
// block can be unmasked in it. Rows past Tk are invalid. Returns the
// block-uniform liveness flag.
template <int BK>
__device__ bool stage_kv_ints(const Params& p, int b, int kv0, QStats qs,
                              int* sKpos, int* sKseg, int* sKval,
                              int* flag) {
  for (int i = threadIdx.x; i < BK; i += blockDim.x) {
    const int row = kv0 + i;
    const bool in = row < p.Tk;
    const long long at = (long long)b * p.Tk + row;
    sKpos[i] = in ? p.kv_pos[at] : 0;
    sKseg[i] = in ? p.kv_seg[at] : -2;
    sKval[i] = in ? p.kv_valid[at] : 0;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int any = 0, pmin = INT_MAX, smin = INT_MAX, smax = INT_MIN;
    for (int i = threadIdx.x; i < BK; i += 32) {
      if (sKval[i] > 0) {
        any = 1;
        pmin = min(pmin, sKpos[i]);
        smin = min(smin, sKseg[i]);
        smax = max(smax, sKseg[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      any |= __shfl_xor_sync(0xffffffffu, any, off);
      pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
      smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
      smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
    }
    if (threadIdx.x == 0) {
      bool live = any != 0;
      if (p.causal && pmin > qs.pos_max) live = false;
      if (p.has_segments && (smax < qs.seg_min || smin > qs.seg_max))
        live = false;
      *flag = live ? 1 : 0;
    }
  }
  __syncthreads();
  return *flag != 0;
}

// Number of kv tiles to visit: with a causal mask over arange kv positions,
// tiles that start after the block's largest q position are dead.
__device__ __forceinline__ int kv_tiles(const Params& p, QStats qs, int BK) {
  int nk = (p.Tk + BK - 1) / BK;
  if (p.causal && p.kv_arange) {
    if (qs.pos_max < 0) return 0;
    nk = min(nk, qs.pos_max / BK + 1);
  }
  return nk;
}

__device__ __forceinline__ bool unmasked(const Params& p, int qpos, int qseg,
                                         int kpos, int kseg, int kval) {
  return kval > 0 && (!p.causal || qpos >= kpos) &&
         (!p.has_segments || qseg == kseg);
}

// The mma.sync / cp.async / ldmatrix helpers of the decode route live in
// hopper.cuh (the paged kernels share them).
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ldsm_x4_t;
using hopper::mma_bf16;

// ---------------------------------------------------------------------------
// bf16, Tq == 1: split-KV decode, then the merge of the splits.
// ---------------------------------------------------------------------------

constexpr int DEC_ROWS = 64;  // kv rows of a tile
constexpr int DEC_NST = 3;    // cp.async ring stages
constexpr int DEC_PAD = 8;    // row padding (elements): conflict-free reads
constexpr int DEC_WARPS = 4;  // each takes 16 kv rows of every tile
constexpr int GMAX = 16;      // q heads of a kv head in one m16 tile

template <int DP>
constexpr int smem_decode() {
  constexpr int ring = DEC_NST * 2 * DEC_ROWS * (DP + DEC_PAD) * 2;
  constexpr int merge = DEC_WARPS * GMAX * (DP + 2) * 4;
  return GMAX * (DP + DEC_PAD) * 2 + (ring > merge ? ring : merge);
}

template <int DP>
__global__ void __launch_bounds__(DEC_WARPS * 32)
    flash_decode_bf16(const Params p) {
  using bf = __nv_bfloat16;
  constexpr int SR = DP + DEC_PAD;     // row stride of sQ, sK, sV
  constexpr int TILE = DEC_ROWS * SR;  // elements of a K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  bf* sQ = reinterpret_cast<bf*>(smem);
  unsigned char* work = smem + GMAX * SR * 2;
  bf* ring = reinterpret_cast<bf*>(work);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, hkj = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hk, hk = hkj / p.ng;
  const int h0 = hk * G + GMAX * (hkj % p.ng);
  const int rows = min(GMAX, hk * G + G - h0);
  const long long part = ((long long)b * p.Hk * p.ng + hkj) * p.splits + split;
  float* pml = p.part + part * p.gr * 2;
  float* pacc = p.part + (long long)p.B * p.Hk * p.ng * p.splits * p.gr * 2 +
                part * p.gr * p.D;

  // This split's kv tiles, clipped at the causal end with arange kv
  // positions (the single q row sees slots <= its position).
  const int qpos = p.q_pos[b], qseg = p.q_seg[b];
  int lim = (p.Tk + DEC_ROWS - 1) / DEC_ROWS;
  if (p.causal && p.kv_arange)
    lim = qpos < 0 ? 0 : min(lim, qpos / DEC_ROWS + 1);
  const int t0 = split * p.tps, t1 = min(t0 + p.tps, lim);
  if (t0 >= t1) {
    if (threadIdx.x < rows) {
      pml[2 * threadIdx.x] = NEG;
      pml[2 * threadIdx.x + 1] = 0.f;
    }
    return;
  }

  const bf* kb = static_cast<const bf*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf* vb = static_cast<const bf*>(p.v) + b * p.v_sb + hk * p.v_sh;
  auto load = [&](int kt, int stage) {
    bf* sK = ring + stage * 2 * TILE;
    bf* sV = sK + TILE;
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < DEC_ROWS * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8, row = kt * DEC_ROWS + r;
      const int n = row < p.Tk ? 2 * max(0, min(8, p.D - c)) : 0;
      cp_async16(sK + r * SR + c, n ? kb + row * p.k_st + c : kb, n);
      cp_async16(sV + r * SR + c, n ? vb + row * p.v_st + c : vb, n);
    }
  };
  for (int i = 0; i < DEC_NST - 1; ++i) {
    if (t0 + i < t1) load(t0 + i, i);
    cp_async_commit();
  }

  // The group's q heads -> rows 0..rows-1 of the tile; the rest are zero.
  const bf* qb = static_cast<const bf*>(p.q) + b * p.q_sb;
  for (int i = threadIdx.x; i < GMAX * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    sQ[r * SR + c] = (r < rows && c < p.D) ? qb[(h0 + r) * p.q_sh + c]
                                           : __float2bfloat16(0.f);
  }
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf* base = sQ + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + g * SR);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * SR);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + g * SR + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * SR + 8);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // ldmatrix.trans row of this lane: matrices (kv 0-7 | 8-15) x (d 0-7 |
  // 8-15) of a 16 x 16 block are the B fragments of two n8 column blocks.
  const int mi = lane >> 3;
  const int vrow = 16 * warp + (lane & 7) + 8 * (mi & 1), vcol = 8 * (mi >> 1);

  for (int kt = t0; kt < t1; ++kt) {
    const int it = kt - t0;
    // This thread's four kv columns of the warp's 16 rows, before the wait.
    bool vis[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row =
          kt * DEC_ROWS + 16 * warp + 8 * (x >> 1) + 2 * t + (x & 1);
      const long long at = (long long)b * p.Tk + row;
      vis[x] = row < p.Tk && p.kv_valid[at] > 0 &&
               (!p.causal || qpos >= p.kv_pos[at]) &&
               (!p.has_segments || qseg == p.kv_seg[at]);
    }
    cp_async_wait<DEC_NST - 2>();
    __syncthreads();  // tile kt landed; every warp is done with kt - 1
    if (kt + DEC_NST - 1 < t1)
      load(kt + DEC_NST - 1, (it + DEC_NST - 1) % DEC_NST);
    cp_async_commit();
    const bf* sK = ring + (it % DEC_NST) * 2 * TILE + 16 * warp * SR;
    const bf* sV = ring + (it % DEC_NST) * 2 * TILE + TILE;

    // S = Q K^T: 16 rows (the group's heads) x the warp's 16 kv rows.
    float s[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const bf* kp = sK + (nb * 8 + g) * SR + kk * 16 + 2 * t;
        mma_bf16(s[nb], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = vis[2 * nb + (e & 1)] ? s[nb][e] * p.scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * LOG2E);
      m[i] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f((s[nb][e] - m[e >> 1]) * LOG2E);
        sum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];

    // acc += P V: p (rounded to bf16) is the A operand straight from the S
    // accumulators; V's B fragments come transposed by ldmatrix.
    const uint32_t a[4] = {hopper::pack_bf16(s[0][0], s[0][1]),
                           hopper::pack_bf16(s[0][2], s[0][3]),
                           hopper::pack_bf16(s[1][0], s[1][1]),
                           hopper::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int jj = 0; jj < DP / 16; ++jj) {
      uint32_t bv[4];
      ldsm_x4_t(bv, sV + vrow * SR + 16 * jj + vcol);
      mma_bf16(acc[2 * jj], a, bv[0], bv[1]);
      mma_bf16(acc[2 * jj + 1], a, bv[2], bv[3]);
    }
  }

  // Merge the warps' states in warp order (the ring is reused).
  cp_async_wait<0>();
  __syncthreads();
  float* sM = reinterpret_cast<float*>(work);
  float* sL = sM + DEC_WARPS * GMAX;
  float* sAcc = sL + DEC_WARPS * GMAX;
  if (t == 0) {
    sM[warp * GMAX + g] = m[0];
    sM[warp * GMAX + g + 8] = m[1];
    sL[warp * GMAX + g] = l[0];
    sL[warp * GMAX + g + 8] = l[1];
  }
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), c = dn * 8 + 2 * t + (e & 1);
      sAcc[(warp * GMAX + row) * DP + c] = acc[dn][e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * p.D; i += blockDim.x) {
    const int r = i / p.D, c = i % p.D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, sM[w * GMAX + r]);
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w)
      A += sAcc[(w * GMAX + r) * DP + c] * expf(sM[w * GMAX + r] - M);
    pacc[r * p.D + c] = A;
  }
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float M = NEG, L = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) M = fmaxf(M, sM[w * GMAX + r]);
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w)
      L += sL[w * GMAX + r] * expf(sM[w * GMAX + r] - M);
    pml[2 * r] = M;
    pml[2 * r + 1] = M == NEG ? 0.f : L;  // no visible key: an empty partial
  }
}

// One block per (q head, batch row): the splits' partials merged in split
// order, o = sum acc_s e^(m_s - m) / l, l = sum l_s e^(m_s - m), m = max m_s
// over the non-empty partials.
__global__ void __launch_bounds__(128) flash_decode_merge(const Params p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hk, hk = h / G, gi = h % G;
  const int hkj = hk * p.ng + gi / GMAX, r = gi % GMAX;
  const long long base = ((long long)b * p.Hk * p.ng + hkj) * p.splits;
  const float* ml = p.part + base * p.gr * 2 + 2 * r;
  const float* accp = p.part +
                      (long long)p.B * p.Hk * p.ng * p.splits * p.gr * 2 +
                      base * p.gr * p.D + r * p.D;
  const long long sml = 2LL * p.gr, sacc = (long long)p.gr * p.D;
  float M = NEG;
  for (int s = 0; s < p.splits; ++s)
    if (ml[s * sml + 1] > 0.f) M = fmaxf(M, ml[s * sml]);
  float L = 0.f;
  for (int s = 0; s < p.splits; ++s)
    if (ml[s * sml + 1] > 0.f) L += ml[s * sml + 1] * expf(ml[s * sml] - M);
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int c = threadIdx.x; c < p.D; c += blockDim.x) {
    float A = 0.f;
    for (int s = 0; s < p.splits; ++s)
      if (ml[s * sml + 1] > 0.f)
        A += accp[s * sacc + c] * expf(ml[s * sml] - M);
    ob[c] = __float2bfloat16(A / (L == 0.f ? 1.f : L));
  }
  if (p.lse != nullptr && threadIdx.x == 0)
    p.lse[(long long)b * p.Hq + h] = L == 0.f ? FLT_MAX : M + logf(L);
}

// ---------------------------------------------------------------------------
// bf16, Tq > 1: wgmma + TMA over the cell map; one producer warp and WG
// consumer warpgroups of 64 q rows (two, or one where the grid of two
// would not fill the card a few times over).
// ---------------------------------------------------------------------------

// Ring stages: a warpgroup holds two (the tile whose O += P V is in flight
// and the tile under the softmax), so four keep two loads ahead.
constexpr int NST = 4;
constexpr int SROWS = 64;  // rows of a streamed K/V tile

// Tensor maps of q, k, v: 64-column boxes (128-byte swizzle) and 16-column
// tail boxes (32-byte swizzle).
struct Maps {
  CUtensorMap q, q_tail, k, k_tail, v, v_tail;
};

struct FwdArgs {
  Maps m;
  Params p;
};

template <int NS, int TL, int WG>
constexpr int smem_fwd_bf16() {
  return 1024 + hopper::Tile<NS, TL, WG * 64>::BYTES +
         NST * (2 * hopper::Tile<NS, TL, SROWS>::BYTES + 1024) + 64;
}

// + the producer warp. With two warpgroups (9 warps) a thread gets at most
// 168 registers; one warpgroup runs two blocks an SM.
template <int NS, int TL, int WG>
__global__ void __launch_bounds__(WG * 128 + 32, WG == 1 ? 2 : 1)
    flash_fwd_bf16(const __grid_constant__ FwdArgs args) {
  using QT = hopper::Tile<NS, TL, WG * 64>;
  using KT = hopper::Tile<NS, TL, SROWS>;
  constexpr int PRODUCER = WG * 4;             // the producer's warp index
  constexpr int STAGE = 2 * KT::BYTES + 1024;  // K, V, then 3 x 64 ints
  const Params& p = args.p;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = hopper::align1024(smem_raw);
  unsigned char* ring = sQ + QT::BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NST * STAGE);
  uint64_t* empty = full + NST;
  uint64_t* fixed = empty + NST;

  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hk);
  const int qb = gridDim.y - 1 - blockIdx.y;  // causally heaviest first
  const int q0 = qb * WG * 64;
  // This block's cells of the map, [kv tile][warpgroup], in shared memory:
  // the walk over kv tiles reads no device memory.
  signed char* sflag = reinterpret_cast<signed char*>(fixed + 1);
  const signed char* tf = p.tiles + (long long)b * p.nqt * p.nkt;
  for (int i = threadIdx.x; i < p.nkt * WG; i += blockDim.x) {
    const int qt = WG * qb + i % WG;
    sflag[i] = qt < p.nqt ? tf[qt * p.nkt + i / WG] : 0;
  }
  auto flag = [&](int w, int kt) -> int { return sflag[kt * WG + w]; };
  auto live = [&](int kt) {
    int any = 0;
#pragma unroll
    for (int w = 0; w < WG; ++w) any |= flag(w, kt);
    return any != 0;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], WG * 4);
    }
    hopper::mbar_init(fixed, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == PRODUCER) {
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(fixed, QT::BYTES);
      hopper::load_tile<NS, TL, WG * 64>(sQ, &args.m.q, &args.m.q_tail, fixed,
                                         q0, h, b);
    }
    // The streamed rows' ints are needed only where some warpgroup's cell
    // is partial (flag 1); they are loaded into registers one live tile
    // ahead, while the producer waits for that tile's stage.
    auto partial = [&](int kt) {
      int any = 0;
#pragma unroll
      for (int w = 0; w < WG; ++w) any |= flag(w, kt) == 1;
      return any != 0;
    };
    auto next_live = [&](int kt) {
      while (kt < p.nkt && !live(kt)) ++kt;
      return kt;
    };
    int ipos[2], iseg[2], ival[2];
    auto fetch = [&](int kt) {
      if (kt >= p.nkt || !partial(kt)) return;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = kt * SROWS + lane + 32 * i;
        const bool in = row < p.Tk;
        const long long at = (long long)b * p.Tk + row;
        ipos[i] = in ? p.kv_pos[at] : 0;
        iseg[i] = in ? p.kv_seg[at] : -2;
        ival[i] = in && p.kv_valid[at] > 0;
      }
    };
    int stage = 0;
    uint32_t phase = 0;
    int kt = next_live(0);
    fetch(kt);
    while (kt < p.nkt) {
      hopper::mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* st = ring + stage * STAGE;
      if (partial(kt)) {
        int* ints = reinterpret_cast<int*>(st + 2 * KT::BYTES);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ints[lane + 32 * i] = ipos[i];
          ints[SROWS + lane + 32 * i] = iseg[i];
          ints[2 * SROWS + lane + 32 * i] = ival[i];
        }
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&full[stage], 2 * KT::BYTES);
        hopper::load_tile<NS, TL, SROWS>(st, &args.m.k, &args.m.k_tail,
                                         &full[stage], kt * SROWS, hk, b);
        hopper::load_tile<NS, TL, SROWS>(st + KT::BYTES, &args.m.v,
                                         &args.m.v_tail, &full[stage],
                                         kt * SROWS, hk, b);
      } else {
        hopper::mbar_arrive(&full[stage]);
      }
      if (++stage == NST) {
        stage = 0;
        phase ^= 1;
      }
      kt = next_live(kt + 1);
      fetch(kt);
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63; this thread
  // rows r0 and r0 + 8 of them (the accumulator layout).
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * (warp & 3) + g;
  int qpos[2], qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const bool in = row < p.Tq;
    qpos[i] = in ? p.q_pos[(long long)b * p.Tq + row] : 0;
    qseg[i] = in ? p.q_seg[(long long)b * p.Tq + row] : -1;
  }
  const float sl2 = p.scale * LOG2E;
  float m[2] = {NEG, NEG}, mb[2], l[2] = {0.f, 0.f};
  mb[0] = mb[1] = fmaxf(__fmul_rn(NEG, sl2), -FLT_MAX);
  float am[NS > 0 ? NS : 1][32], at[8];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) am[j][e] = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) at[e] = 0.f;
  auto rescale = [&](const float (&f)[2]) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) am[j][e] *= f[(e >> 1) & 1];
#pragma unroll
    for (int e = 0; e < 8; ++e) at[e] *= f[(e >> 1) & 1];
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  };
  hopper::mbar_wait(fixed, 0);
  const uint32_t aQ = hopper::smem_addr(sQ);
  // The tile's O += P V is issued with the next tile's S = Q K^T and runs
  // while that S goes through the softmax; its stage (V) is released after
  // it completes. `held` is that stage, `pa` its P (bf16 A fragments).
  int held = -1;
  uint32_t pa[4][4];
  auto issue_pv = [&]() {
    hopper::mma_acc<NS, TL>(am, at, pa,
                            hopper::smem_addr(ring + held * STAGE) +
                                KT::BYTES,
                            SROWS, 0);
    hopper::wg_commit();
  };
  auto retire_pv = [&]() {  // after the wait that covers it
    hopper::fence_acc<NS, TL>(am, at);
    release(held);
    held = -1;
  };
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < p.nkt; ++kt) {
    if (!live(kt)) continue;
    hopper::mbar_wait(&full[stage], phase);
    const int f = flag(wg, kt);  // uniform over the warpgroup
    unsigned char* st = ring + stage * STAGE;
    const uint32_t aK = hopper::smem_addr(st);
    const bool had = held >= 0;
    float s[32];  // written by wgmma (scale-d 0) before use
    if (f || had) hopper::wg_fence();
    if (f) {
      hopper::mma_rows<NS, TL>(s, aQ, WG * 64, 64 * wg, aK, SROWS, 0);
      hopper::wg_commit();
    }
    if (had) issue_pv();
    if (!f) {
      // A dead cell of this warpgroup (live for the other): the pending
      // product completes here, so that no run of such cells finds every
      // stage held.
      if (had) {
        hopper::wg_wait0();
        retire_pv();
      }
      release(stage);
    } else {
      if (had) {
        hopper::wg_wait1();  // S; the previous tile's O += P V may run on
      } else {
        hopper::wg_wait0();
      }
      hopper::fence_regs(s);
      const int* kpos = reinterpret_cast<const int*>(st + 2 * KT::BYTES);
      const int* kseg = kpos + SROWS;
      const int* klive = kseg + SROWS;
      // The online softmax on the raw logits s = q.k (rows r0 and r0 + 8):
      // m is a row's running max over its visible keys, mb = m * scale *
      // log2(e), and p = 2^(s * scale * log2(e) - mb) is one FFMA and one
      // MUFU an element. A partial cell masks element by element (bit e of
      // vm: visible); a masked p is 0.
      uint32_t vm = 0xffffffffu;
      if (f == 1) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int c = 8 * (e >> 2) + 2 * t + (e & 1), i = (e >> 1) & 1;
          const bool vis = klive[c] &&
                           (!p.causal || qpos[i] >= kpos[c]) &&
                           (!p.has_segments || qseg[i] == kseg[c]);
          if (!vis) {
            vm &= ~(1u << e);
            s[e] = NEG;
          }
        }
      }
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        m[i] = fmaxf(m[i], mx[i]);
        // Rounded once and clamped, so that a row that has seen no visible
        // key keeps alpha = 2^0 (a NEG max times the scale may overflow).
        const float mb_new = fmaxf(__fmul_rn(m[i], sl2), -FLT_MAX);
        alpha[i] = exp2f(mb[i] - mb_new);
        mb[i] = mb_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int i = (e >> 1) & 1;
        const float pe = exp2f(fmaf(s[e], sl2, -mb[i]));
        s[e] = (vm >> e) & 1 ? pe : 0.f;
        sum[i] += s[e];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
      // p rounded to bf16: the A operand of this tile's O += P V.
      uint32_t pn[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) hopper::acc_to_a(pn[kk], s, kk);
      if (had) {
        hopper::wg_wait0();
        retire_pv();
      }
      rescale(alpha);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) pa[kk][x] = pn[kk][x];
      held = stage;
    }
    if (++stage == NST) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (held >= 0) {
    hopper::wg_fence();
    issue_pv();
    hopper::wg_wait0();
    retire_pv();
  }

  const float inv[2] = {1.f / (l[0] == 0.f ? 1.f : l[0]),
                        1.f / (l[1] == 0.f ? 1.f : l[1])};
  rescale(inv);
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  hopper::store_acc<NS, TL>(ob, p.o_st, am, at, r0, p.Tq, p.D, t);
  if (p.lse != nullptr && t == 0) {
    const long long rowbase = ((long long)b * p.Hq + h) * p.Tq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row < p.Tq)
        p.lse[rowbase + row] =
            l[i] == 0.f ? FLT_MAX : m[i] * p.scale + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: 4 warps, 4 q rows per warp, 32 kv rows per tile, plain FMA. Lane j
// owns kv column j of the tile for the logits and feature columns
// lane + 32 c of the accumulator.
// ---------------------------------------------------------------------------

constexpr int BQ32 = 16;
constexpr int BK32 = 32;

template <int DP>
constexpr int smem_f32() {
  return (BQ32 * DP + BK32 * (DP + 1) + BK32 * DP) * 4 + 3 * BK32 * 4;
}

template <int DP>
__global__ void __launch_bounds__(128) flash_fwd_f32(const Params p) {
  constexpr int RW = BQ32 / 4;  // rows per warp
  constexpr int SK = DP + 1;    // sK row stride: lane j reads row j
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ32 * DP;
  float* sV = sK + BK32 * SK;
  int* sKpos = reinterpret_cast<int*>(sV + BK32 * DP);
  int* sKseg = sKpos + BK32;
  int* sKval = sKseg + BK32;
  __shared__ int scratch[4];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ32, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const QStats qs = q_tile_stats(p, b, q0, BQ32, scratch);
  load_rows<float, DP>(sQ, DP, qb, p.q_st, q0, BQ32, p.Tq, p.D, p.vec);

  int qpos[RW], qseg[RW];
  float m[RW], l[RW], acc[RW][DP / 32];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    const bool in = row < p.Tq;
    qpos[r] = in ? p.q_pos[(long long)b * p.Tq + row] : 0;
    qseg[r] = in ? p.q_seg[(long long)b * p.Tq + row] : -1;
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) acc[r][c] = 0.f;
  }

  const int nk = kv_tiles(p, qs, BK32);
  for (int it = 0; it < nk; ++it) {
    const int kv0 = it * BK32;
    __syncthreads();
    if (!stage_kv_ints<BK32>(p, b, kv0, qs, sKpos, sKseg, sKval,
                             &scratch[3]))
      continue;
    // sK has an odd row stride, so it is filled without vector stores.
    load_rows<float, DP>(sV, DP, vb, p.v_st, kv0, BK32, p.Tk, p.D, p.vec);
    for (int i = threadIdx.x; i < BK32 * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP, row = kv0 + r;
      sK[r * SK + c] = (row < p.Tk && c < p.D) ? kb[row * p.k_st + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float* qr = sQ + (warp * RW + r) * DP;
      const float* kr = sK + lane * SK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float s =
          unmasked(p, qpos[r], qseg[r], sKpos[lane], sKseg[lane],
                   sKval[lane])
              ? dot * p.scale
              : NEG;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float pj = expf(s - m_new);
      float sum = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      float pv[DP / 32];
#pragma unroll
      for (int c = 0; c < DP / 32; ++c) pv[c] = 0.f;
      for (int j = 0; j < BK32; ++j) {
        const float pjj = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
        for (int c = 0; c < DP / 32; ++c)
          pv[c] = fmaf(pjj, sV[j * DP + lane + 32 * c], pv[c]);
      }
#pragma unroll
      for (int c = 0; c < DP / 32; ++c) acc[r][c] = acc[r][c] * alpha + pv[c];
    }
  }

  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = q0 + warp * RW + r;
    if (row >= p.Tq) continue;
    if (p.lse != nullptr && lane == 0)
      p.lse[((long long)b * p.Hq + h) * p.Tq + row] =
          l[r] == 0.f ? FLT_MAX : m[r] + logf(l[r]);
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) {
      const int col = lane + 32 * c;
      if (col < p.D) ob[row * p.o_st + col] = acc[r][c] * inv;
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

// Decode widths: 16 (the small test heads) and 128 (the decoder); the
// columns past D of a row are zero-filled chunks.
template <int DP>
cudaError_t decode_w(const Params& p, cudaStream_t s) {
  dim3 grid(p.splits, p.Hk * p.ng, p.B);
  cudaError_t err = launch(flash_decode_bf16<DP>, grid, DEC_WARPS * 32,
                           smem_decode<DP>(), p, s);
  if (err != cudaSuccess) return err;
  flash_decode_merge<<<dim3(p.Hq, p.B), 128, 0, s>>>(p);
  return cudaGetLastError();
}

cudaError_t decode_bf16(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return decode_w<16>(p, s);
  return decode_w<128>(p, s);
}

// The tensor maps of q (boxes of the block's qrows rows) and k, v (64
// rows). False when TMA cannot take a layout.
bool make_maps(Maps* m, const Params& p, int qrows, bool main, bool tail) {
  struct Op {
    CUtensorMap *mm, *mt;
    const void* base;
    long long sb, sh, st;
    int H, T, rows;
  } ops[3] = {
      {&m->q, &m->q_tail, p.q, p.q_sb, p.q_sh, p.q_st, p.Hq, p.Tq, qrows},
      {&m->k, &m->k_tail, p.k, p.k_sb, p.k_sh, p.k_st, p.Hk, p.Tk, SROWS},
      {&m->v, &m->v_tail, p.v, p.v_sb, p.v_sh, p.v_st, p.Hk, p.Tk, SROWS},
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

// The wgmma body: NS 64-column sub-tiles and TL 16-column tails, WG
// consumer warpgroups.
template <int NS, int TL, int WG>
cudaError_t fwd_w(const Params& p, cudaStream_t s) {
  FwdArgs a;
  a.p = p;
  if (!make_maps(&a.m, p, WG * 64, NS > 0, TL > 0))
    return cudaErrorInvalidValue;
  dim3 grid(p.B * p.Hq, (p.Tq + WG * 64 - 1) / (WG * 64));
  // + the block's cells of the map, one byte per warpgroup and kv tile.
  const int flags = (WG * p.nkt + 15) / 16 * 16;
  return launch(flash_fwd_bf16<NS, TL, WG>, grid, WG * 128 + 32,
                smem_fwd_bf16<NS, TL, WG>() + flags, a, s);
}

template <int WG>
cudaError_t fwd_wg(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return fwd_w<0, 1, WG>(p, s);
  if (p.D <= 64) return fwd_w<1, 0, WG>(p, s);
  if (p.D <= 80) return fwd_w<1, 1, WG>(p, s);
  return fwd_w<2, 0, WG>(p, s);
}

// Widths 16 (D <= 16: one tail), 64, 80 (64 + 16: the ViT's 72), 128.
cudaError_t fwd_bf16(const Params& p, int wgs, cudaStream_t s) {
  return wgs == 1 ? fwd_wg<1>(p, s) : fwd_wg<2>(p, s);
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  dim3 grid((p.Tq + BQ32 - 1) / BQ32, p.Hq, p.B);
  return launch(flash_fwd_f32<DP>, grid, 128, smem_f32<DP>(), p, stream);
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* strides, const void* q_pos,
                   const void* kv_pos, const void* q_seg, const void* kv_seg,
                   const void* kv_valid, int B, int Hq, int Hk, int Tq,
                   int Tk, int D, float scale, int causal, int has_segments,
                   int kv_arange) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_sb = strides[0], p.q_sh = strides[1], p.q_st = strides[2];
  p.k_sb = strides[3], p.k_sh = strides[4], p.k_st = strides[5];
  p.v_sb = strides[6], p.v_sh = strides[7], p.v_st = strides[8];
  p.o_sb = strides[9], p.o_sh = strides[10], p.o_st = strides[11];
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.kv_valid = static_cast<const int*>(kv_valid);
  p.B = B, p.Hq = Hq, p.Hk = Hk, p.Tq = Tq, p.Tk = Tk, p.D = D;
  p.scale = scale;
  p.causal = causal, p.has_segments = has_segments, p.kv_arange = kv_arange;
  return p;
}

bool valid_shape(int B, int Hq, int Hk, int Tq, int Tk, int D) {
  return B > 0 && Hq > 0 && Hk > 0 && Hq % Hk == 0 && Tq > 0 && Tk > 0 &&
         D > 0 && D <= 128 && B <= 65535 && Hq <= 65535;
}

}  // namespace

// Plain C entry points (bound with ctypes). `strides` holds 12 element
// strides: (batch, head, token) for q, k, v and o; `lse` is a contiguous fp32
// [B, Hq, Tq] buffer or null. Each returns the cudaError_t of its launches
// (0 on success; cudaErrorInvalidValue for a shape, or a bf16 layout TMA
// cannot take); nothing is synchronised.
//
// bf16: Tq == 1 runs the split-KV decode (`splits` splits of `tps` kv tiles
// each, its partials in `scratch`: see Params) and its merge; Tq > 1 builds
// the cell map into `scratch` (csrc/tile_map.cuh, the backward's
// oryx_flash_bwd_tiles) and runs the wgmma body with `wgs` (1 or 2)
// consumer warpgroups over it.
extern "C" int oryx_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, const void* q_pos, const void* kv_pos,
    const void* q_seg, const void* kv_seg, const void* kv_valid,
    void* scratch, int B, int Hq, int Hk, int Tq, int Tk, int D,
    float scale, int causal, int has_segments, int kv_arange, int splits,
    int tps, int wgs, void* stream) {
  if (!valid_shape(B, Hq, Hk, Tq, Tk, D)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, lse, strides, q_pos, kv_pos, q_seg,
                         kv_seg, kv_valid, B, Hq, Hk, Tq, Tk, D, scale,
                         causal, has_segments, kv_arange);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tq == 1) {
    const int G = Hq / Hk;
    p.part = static_cast<float*>(scratch);
    p.splits = splits, p.tps = tps;
    p.ng = (G + GMAX - 1) / GMAX;
    p.gr = G < GMAX ? G : GMAX;
    if (splits <= 0 || tps <= 0 || (long long)splits * tps * DEC_ROWS < Tk ||
        splits > 65535 || (long long)Hk * p.ng > 65535)
      return cudaErrorInvalidValue;
    return decode_bf16(p, s);
  }
  if (wgs != 1 && wgs != 2) return cudaErrorInvalidValue;
  p.nqt = (Tq + 63) / 64, p.nkt = (Tk + 63) / 64;
  const cudaError_t err =
      tile_map::build(q_pos, kv_pos, q_seg, kv_seg, kv_valid, scratch, B, Tq,
                      Tk, causal, has_segments, s);
  if (err != cudaSuccess) return err;
  p.tiles = static_cast<const signed char*>(scratch) +
            (long long)B * (p.nqt + p.nkt) * tile_map::NSTAT * 4;
  return fwd_bf16(p, wgs, s);
}

// fp32: `vec` says 16-byte vector loads are aligned.
extern "C" int oryx_flash_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, const void* q_pos, const void* kv_pos,
    const void* q_seg, const void* kv_seg, const void* kv_valid, int B,
    int Hq, int Hk, int Tq, int Tk, int D, float scale, int causal,
    int has_segments, int kv_arange, int vec, void* stream) {
  if (!valid_shape(B, Hq, Hk, Tq, Tk, D)) return cudaErrorInvalidValue;
  Params p = make_params(q, k, v, o, lse, strides, q_pos, kv_pos, q_seg,
                         kv_seg, kv_valid, B, Hq, Hk, Tq, Tk, D, scale,
                         causal, has_segments, kv_arange);
  p.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_f32<32>(p, s);
  if (D <= 96) return launch_f32<96>(p, s);
  return launch_f32<128>(p, s);
}
