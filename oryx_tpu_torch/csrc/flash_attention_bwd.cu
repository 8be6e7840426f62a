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
// the value of JAX's fp32 result cast once.
//
// What bounds it on an H100: five matrix products per live (q, kv) tile
// pair (s and dp recomputed in each kernel, then dq, or dv and dk), ~2.5x
// the forward's work, far above the ~295 flop/byte ridge: tensor-core
// operations. The design is the simple one, right before fast:
//   * K5a: one block per (64-row q tile, q head, batch), 4 warps of 16 q
//     rows; a loop over kv tiles of 64 rows with the forward's skips (the
//     causal end with arange kv positions, tiles with no visible key); K, V
//     and K^T staged in shared memory; bf16 `mma.sync.m16n8k16`, dq in fp32
//     registers.
//   * K5b: one block per (64-row kv tile, kv head, batch), 4 warps of 16 kv
//     rows; loops over the G q heads of the kv head and over q tiles of 32
//     rows (the Pallas grid (B, Hk, nk, G, nq)), skipping q tiles none of
//     whose rows sees a key of the kv tile; dk and dv in fp32 registers. No
//     atomics: every dk/dv element is summed by one thread in a fixed order,
//     so gradients are identical from run to run.
//   * fp32: the same loops with plain FMA (lane j owns column j of a
//     32-wide tile), for the small test heads.
// No wgmma, TMA or split over kv for dq yet.
//
// Layouts: q/dO/dq are [B, Hq, Tq, D] and k/v/dk/dv [B, Hk, Tk, D] given by
// element strides (batch, head, token) with the feature dim contiguous; kv
// head of q head h is h / (Hq / Hk). Rows past Tq/Tk are handled in the
// kernel: kv rows past Tk are invalid, q rows past Tq add nothing and are
// never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

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
  int B, Hq, Hk, Tq, Tk, D;
  float scale;
  int causal, has_segments, kv_arange, vec;
};

// Position max and segment range over the live rows of a tile.
struct Stats {
  int any, pos_min, pos_max, seg_min, seg_max;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16(x);
}

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

// Same as load_rows, but stores the slab transposed: dst[col][row].
template <typename T, int DP>
__device__ void load_rows_t(T* dst, int ds, const T* src, long long rs,
                            int row0, int nrows, int nT, int D, int vec) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = DP / E;
  for (int i = threadIdx.x; i < nrows * CH; i += blockDim.x) {
    const int r = i % nrows, c = (i / nrows) * E, row = row0 + r;
    const T* s = src + row * rs + c;
    T vals[E];
    if (vec && row < nT && c + E <= D) {
      *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(s);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j)
        vals[j] = (row < nT && c + j < D) ? s[j] : from_float<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) dst[(c + j) * ds + r] = vals[j];
  }
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 16, row-major) of rows r0.. of a [rows][stride] slab at
// column k0: the m16n8k16 layout.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s,
                                       int stride, int r0, int k0, int g,
                                       int t) {
  const __nv_bfloat16* base = s + r0 * stride + k0 + 2 * t;
  a[0] = ld32(base + g * stride);
  a[1] = ld32(base + (g + 8) * stride);
  a[2] = ld32(base + g * stride + 8);
  a[3] = ld32(base + (g + 8) * stride + 8);
}

// C[16 x 8n] += A(rows of slab `a`) . B^T where B's rows are the n index:
// for each of N n-tiles of 8, B operand column n = row (n0 + g) of slab `b`.
template <int N, int KD>
__device__ __forceinline__ void mma_rows(float (*c)[4],
                                         const __nv_bfloat16* a, int sa,
                                         int ar0, const __nv_bfloat16* b,
                                         int sb, int g, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t af[4];
    load_a(af, a, sa, ar0, kk * 16, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const __nv_bfloat16* bp = b + (n * 8 + g) * sb + kk * 16 + 2 * t;
      mma_bf16(c[n], af, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[DP/8] += X . Y where X [16 x 8N] is held in accumulator layout (rounded
// to bf16 here) and Y^T is a [DP][stride] slab in shared memory (the B
// operand: column d = row d of the slab).
template <int N, int DP>
__device__ __forceinline__ void mma_acc_a(float (*acc)[4], float (*x)[4],
                                          const __nv_bfloat16* yt, int sy,
                                          int g, int t) {
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const __nv_bfloat16* bp = yt + (dn * 8 + g) * sy + kk * 16 + 2 * t;
      mma_bf16(acc[dn], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// Store a warp's 16-row accumulator tile to rows r0.. of a [T, D] slab.
template <int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, long long rs,
                                          float (*acc)[4], int r0, int nT,
                                          int D, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= nT) continue;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = dn * 8 + 2 * t + j;
        if (c < D) out[row * rs + c] = __float2bfloat16(acc[dn][2 * i + j]);
      }
  }
}

constexpr int PAD = 8;  // row padding (elements): conflict-free fragments

// ---------------------------------------------------------------------------
// K5a bf16: dq. 4 warps x 16 q rows, 64 kv rows per tile.
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 64;
constexpr int DQ_BK = 64;

template <int DP>
constexpr int smem_dq_bf16() {
  return (2 * DQ_BQ * (DP + PAD) + 2 * DQ_BK * (DP + PAD) +
          DP * (DQ_BK + PAD)) * 2 + 3 * DQ_BK * 4;
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dq_bf16(const Params p) {
  constexpr int SQ = DP + PAD;     // row stride of sQ, sdO, sK, sV
  constexpr int SKT = DQ_BK + PAD;  // row stride of sKt ([DP][BK])
  constexpr int NK = DQ_BK / 8;     // n-tiles of 8 kv columns
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + DQ_BQ * SQ;
  __nv_bfloat16* sK = sdO + DQ_BQ * SQ;
  __nv_bfloat16* sV = sK + DQ_BK * SQ;
  __nv_bfloat16* sKt = sV + DQ_BK * SQ;
  int* sKpos = reinterpret_cast<int*>(sKt + DP * SKT);
  int* sKseg = sKpos + DQ_BK;
  int* sKlive = sKseg + DQ_BK;
  __shared__ int sQpos[DQ_BQ], sQseg[DQ_BQ], sQlive[DQ_BQ], red[5];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * DQ_BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf* dob = static_cast<const bf*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf* kb = static_cast<const bf*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf* vb = static_cast<const bf*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long rowbase = ((long long)b * p.Hq + h) * p.Tq;

  const Stats qs = stage_ints(p.q_pos, p.q_seg, nullptr, b, p.Tq, q0, DQ_BQ,
                              sQpos, sQseg, sQlive, red);
  load_rows<bf, DP>(sQ, SQ, qb, p.q_st, q0, DQ_BQ, p.Tq, p.D, p.vec);
  load_rows<bf, DP>(sdO, SQ, dob, p.do_st, q0, DQ_BQ, p.Tq, p.D, p.vec);

  // This thread's two q rows within the warp's 16: g and g + 8.
  const int wr = warp * 16;
  int qpos[2], qseg[2];
  float lse[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i, row = q0 + r;
    const bool in = row < p.Tq;
    qpos[i] = sQpos[r];
    qseg[i] = sQseg[r];
    lse[i] = in ? p.lse[rowbase + row] : FLT_MAX;
    dlt[i] = in ? p.delta[rowbase + row] : 0.f;
  }
  const bool warp_live = q0 + wr < p.Tq;

  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int nk = kv_tiles(p, qs, DQ_BK);
  for (int it = 0; it < nk; ++it) {
    const int kv0 = it * DQ_BK;
    __syncthreads();  // every warp is done with the previous tile
    const Stats ks = stage_ints(p.kv_pos, p.kv_seg, p.kv_valid, b, p.Tk, kv0,
                                DQ_BK, sKpos, sKseg, sKlive, red);
    if (!tiles_meet(p, qs, ks)) continue;
    load_rows<bf, DP>(sK, SQ, kb, p.k_st, kv0, DQ_BK, p.Tk, p.D, p.vec);
    load_rows<bf, DP>(sV, SQ, vb, p.v_st, kv0, DQ_BK, p.Tk, p.D, p.vec);
    load_rows_t<bf, DP>(sKt, SKT, kb, p.k_st, kv0, DQ_BK, p.Tk, p.D, p.vec);
    __syncthreads();
    if (!warp_live) continue;

    // s = q k^T (16 x 64), dp = dO v^T (16 x 64).
    float s[NK][4], dp[NK][4];
    mma_rows<NK, DP>(s, sQ, SQ, wr, sK, SQ, g, t);
    mma_rows<NK, DP>(dp, sdO, SQ, wr, sV, SQ, g, t);
    // p = exp(masked s - lse); ds = p (dp - Delta) scale, into s.
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), i = e >> 1;
        const float sv =
            unmasked(p, qpos[i], qseg[i], sKpos[c], sKseg[c], sKlive[c])
                ? s[n][e] * p.scale
                : NEG;
        const float pr = expf(sv - lse[i]);
        s[n][e] = pr * (dp[n][e] - dlt[i]) * p.scale;
      }
    // dq += ds (rounded to bf16) . k
    mma_acc_a<NK, DP>(acc, s, sKt, SKT, g, t);
  }

  bf* dqb = static_cast<bf*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
  if (warp_live) store_acc<DP>(dqb, p.dq_st, acc, q0 + wr, p.Tq, p.D, g, t);
}

// ---------------------------------------------------------------------------
// K5b bf16: dk, dv. 4 warps x 16 kv rows, q tiles of 32 rows.
// ---------------------------------------------------------------------------

constexpr int DKV_BK = 64;
constexpr int DKV_BQ = 32;

template <int DP>
constexpr int smem_dkv_bf16() {
  return (2 * DKV_BK * (DP + PAD) + 2 * DKV_BQ * (DP + PAD) +
          2 * DP * (DKV_BQ + PAD)) * 2 + 3 * DKV_BK * 4;
}

template <int DP>
__global__ void __launch_bounds__(128) flash_bwd_dkv_bf16(const Params p) {
  constexpr int SQ = DP + PAD;      // row stride of sK, sV, sQ, sdO
  constexpr int SQT = DKV_BQ + PAD;  // row stride of sQt, sdOt ([DP][BQ])
  constexpr int NQ = DKV_BQ / 8;     // n-tiles of 8 q columns
  extern __shared__ __align__(16) unsigned char smem[];
  using bf = __nv_bfloat16;
  bf* sK = reinterpret_cast<bf*>(smem);
  bf* sV = sK + DKV_BK * SQ;
  bf* sQ = sV + DKV_BK * SQ;
  bf* sdO = sQ + DKV_BQ * SQ;
  bf* sQt = sdO + DKV_BQ * SQ;
  bf* sdOt = sQt + DP * SQT;
  int* sKpos = reinterpret_cast<int*>(sdOt + DP * SQT);
  int* sKseg = sKpos + DKV_BK;
  int* sKlive = sKseg + DKV_BK;
  __shared__ int sQpos[DKV_BQ], sQseg[DKV_BQ], sQlive[DKV_BQ], red[5];
  __shared__ float sLse[DKV_BQ], sDlt[DKV_BQ];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * DKV_BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hk;
  const bf* kb = static_cast<const bf*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf* vb = static_cast<const bf*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const Stats ks = stage_ints(p.kv_pos, p.kv_seg, p.kv_valid, b, p.Tk, kv0,
                              DKV_BK, sKpos, sKseg, sKlive, red);
  load_rows<bf, DP>(sK, SQ, kb, p.k_st, kv0, DKV_BK, p.Tk, p.D, p.vec);
  load_rows<bf, DP>(sV, SQ, vb, p.v_st, kv0, DKV_BK, p.Tk, p.D, p.vec);

  // This thread's two kv rows within the warp's 16: g and g + 8.
  const int wr = warp * 16;
  int kpos[2], kseg[2], klive[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    kpos[i] = sKpos[r];
    kseg[i] = sKseg[r];
    klive[i] = sKlive[r];
  }

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  const int nq = (p.Tq + DKV_BQ - 1) / DKV_BQ;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const bf* qb = static_cast<const bf*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf* dob =
        static_cast<const bf*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long rowbase = ((long long)b * p.Hq + h) * p.Tq;
    for (int iq = 0; iq < nq; ++iq) {
      const int q0 = iq * DKV_BQ;
      __syncthreads();  // every warp is done with the previous q tile
      const Stats qs = stage_ints(p.q_pos, p.q_seg, nullptr, b, p.Tq, q0,
                                  DKV_BQ, sQpos, sQseg, sQlive, red);
      if (!tiles_meet(p, qs, ks)) continue;
      for (int i = threadIdx.x; i < DKV_BQ; i += blockDim.x) {
        const int row = q0 + i;
        const bool in = row < p.Tq;
        sLse[i] = in ? p.lse[rowbase + row] : FLT_MAX;
        sDlt[i] = in ? p.delta[rowbase + row] : 0.f;
      }
      load_rows<bf, DP>(sQ, SQ, qb, p.q_st, q0, DKV_BQ, p.Tq, p.D, p.vec);
      load_rows<bf, DP>(sdO, SQ, dob, p.do_st, q0, DKV_BQ, p.Tq, p.D,
                        p.vec);
      load_rows_t<bf, DP>(sQt, SQT, qb, p.q_st, q0, DKV_BQ, p.Tq, p.D,
                          p.vec);
      load_rows_t<bf, DP>(sdOt, SQT, dob, p.do_st, q0, DKV_BQ, p.Tq, p.D,
                          p.vec);
      __syncthreads();

      // s^T = k q^T (16 kv x 32 q), dp^T = v dO^T.
      float st[NQ][4], dpt[NQ][4];
      mma_rows<NQ, DP>(st, sK, SQ, wr, sQ, SQ, g, t);
      mma_rows<NQ, DP>(dpt, sV, SQ, wr, sdO, SQ, g, t);
      // p^T into st, ds^T into dpt.
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1), i = e >> 1;
          const float sv =
              sQlive[c] && unmasked(p, sQpos[c], sQseg[c], kpos[i], kseg[i],
                                    klive[i])
                  ? st[n][e] * p.scale
                  : NEG;
          const float pr = expf(sv - sLse[c]);
          st[n][e] = pr;
          dpt[n][e] = pr * (dpt[n][e] - sDlt[c]) * p.scale;
        }
      // dv += p^T (bf16) . dO ; dk += ds^T (bf16) . q
      mma_acc_a<NQ, DP>(dv, st, sdOt, SQT, g, t);
      mma_acc_a<NQ, DP>(dk, dpt, sQt, SQT, g, t);
    }
  }

  bf* dkb = static_cast<bf*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  bf* dvb = static_cast<bf*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
  store_acc<DP>(dkb, p.dk_st, dk, kv0 + wr, p.Tk, p.D, g, t);
  store_acc<DP>(dvb, p.dv_st, dv, kv0 + wr, p.Tk, p.D, g, t);
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// Padded widths: 16 for the small test heads, 80 for the ViT's 72, 128 for
// the decoder's 128 (bf16); 32/96/128 (fp32). Any other D takes the next.
cudaError_t dq_bf16(const Params& p, cudaStream_t s) {
  dim3 grid((p.Tq + DQ_BQ - 1) / DQ_BQ, p.Hq, p.B);
  if (p.D <= 16)
    return launch(flash_bwd_dq_bf16<16>, grid, smem_dq_bf16<16>(), p, s);
  if (p.D <= 80)
    return launch(flash_bwd_dq_bf16<80>, grid, smem_dq_bf16<80>(), p, s);
  return launch(flash_bwd_dq_bf16<128>, grid, smem_dq_bf16<128>(), p, s);
}

cudaError_t dkv_bf16(const Params& p, cudaStream_t s) {
  dim3 grid((p.Tk + DKV_BK - 1) / DKV_BK, p.Hk, p.B);
  if (p.D <= 16)
    return launch(flash_bwd_dkv_bf16<16>, grid, smem_dkv_bf16<16>(), p, s);
  if (p.D <= 80)
    return launch(flash_bwd_dkv_bf16<80>, grid, smem_dkv_bf16<80>(), p, s);
  return launch(flash_bwd_dkv_bf16<128>, grid, smem_dkv_bf16<128>(), p, s);
}

cudaError_t dq_f32(const Params& p, cudaStream_t s) {
  dim3 grid((p.Tq + F_BQ - 1) / F_BQ, p.Hq, p.B);
  if (p.D <= 32)
    return launch(flash_bwd_dq_f32<32>, grid, smem_dq_f32<32>(), p, s);
  if (p.D <= 96)
    return launch(flash_bwd_dq_f32<96>, grid, smem_dq_f32<96>(), p, s);
  return launch(flash_bwd_dq_f32<128>, grid, smem_dq_f32<128>(), p, s);
}

cudaError_t dkv_f32(const Params& p, cudaStream_t s) {
  dim3 grid((p.Tk + F_BK - 1) / F_BK, p.Hk, p.B);
  if (p.D <= 32)
    return launch(flash_bwd_dkv_f32<32>, grid, smem_dkv_f32<32>(), p, s);
  if (p.D <= 96)
    return launch(flash_bwd_dkv_f32<96>, grid, smem_dkv_f32<96>(), p, s);
  return launch(flash_bwd_dkv_f32<128>, grid, smem_dkv_f32<128>(), p, s);
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
                   int has_segments, int kv_arange, int vec) {
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
  p.B = B, p.Hq = Hq, p.Hk = Hk, p.Tq = Tq, p.Tk = Tk, p.D = D;
  p.scale = scale;
  p.causal = causal, p.has_segments = has_segments, p.kv_arange = kv_arange;
  p.vec = vec;
  return p;
}

}  // namespace

// Plain C entry points (bound with ctypes), one per kernel and dtype.
// `strides` holds 21 element strides: (batch, head, token) for q, k, v, dO,
// dq, dk and dv; lse and delta are contiguous fp32 [B, Hq, Tq]. `dq`
// (resp. `dk`, `dv`) is written in q's dtype. Each returns the cudaError_t
// of the launch (0 on success); nothing is synchronised.
#define ORYX_BWD_ENTRY(NAME, FN)                                             \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* delta, void* dq, void* dk, void* dv,      \
      const long long* strides, const void* q_pos, const void* kv_pos,       \
      const void* q_seg, const void* kv_seg, const void* kv_valid, int B,    \
      int Hq, int Hk, int Tq, int Tk, int D, float scale, int causal,        \
      int has_segments, int kv_arange, int vec, void* stream) {              \
    if (!valid_shape(B, Hq, Hk, Tq, Tk, D)) return cudaErrorInvalidValue;    \
    const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv,      \
                                 strides, q_pos, kv_pos, q_seg, kv_seg,      \
                                 kv_valid, B, Hq, Hk, Tq, Tk, D, scale,      \
                                 causal, has_segments, kv_arange, vec);      \
    return FN(p, static_cast<cudaStream_t>(stream));                         \
  }

ORYX_BWD_ENTRY(oryx_flash_bwd_dq_bf16, dq_bf16)
ORYX_BWD_ENTRY(oryx_flash_bwd_dkv_bf16, dkv_bf16)
ORYX_BWD_ENTRY(oryx_flash_bwd_dq_f32, dq_f32)
ORYX_BWD_ENTRY(oryx_flash_bwd_dkv_f32, dkv_f32)
