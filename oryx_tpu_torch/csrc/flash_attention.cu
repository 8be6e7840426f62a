// Flash-attention forward for NVIDIA Hopper (sm_90a).
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
// `_finalize`). A row none of whose visited tiles holds a visible key keeps
// m = NEG; a row all of whose tiles were skipped has l == 0 and gets FLT_MAX,
// where Pallas, which skips no tile of a non-causal call, gets NEG + log n.
// The backward's p is then 0 there where Pallas has 1/n; no gradient of the
// models differs, since every such row's cotangent is zero.
//
// What bounds it on an H100: at the path's shapes the work is two matrix
// products per kv tile (4 * D flops per live (q, kv) pair), far above the
// ~295 flop/byte ridge, so it is bound by tensor-core operations. The design
// keeps it right and simple: one block per (q tile, q head, batch), K and V
// tiles staged in shared memory, bf16 `mma.sync.m16n8k16` with fp32
// accumulators (the fp32 variant uses plain FMA). Tiles that no (q, kv) pair
// of the block can see are skipped before K/V are loaded: with arange kv
// positions and a causal mask the loop ends after the block's largest q
// position, and a tile whose valid kv entries have no segment or causal
// overlap with the block's q rows is passed over. No wgmma, TMA or split-KV
// yet.
//
// Layouts: q/o are [B, Hq, Tq, D] and k/v [B, Hk, Tk, D] given by element
// strides (batch, head, token) with the feature dim contiguous; kv head of q
// head h is h / (Hq / Hk). The int arrays are contiguous int32 [B, T]. Rows
// past Tq/Tk are handled in the kernel: kv rows past Tk are invalid, q rows
// past Tq are never stored.

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: NW warps, 16 q rows per warp, 64 kv rows per tile, mma.sync.
// ---------------------------------------------------------------------------

constexpr int BK16 = 64;
constexpr int PAD16 = 8;  // row padding (elements): conflict-free fragments

template <int NW, int DP>
constexpr int smem_bf16() {
  return ((16 * NW) * (DP + PAD16) + BK16 * (DP + PAD16) +
          DP * (BK16 + PAD16)) * 2 + 3 * BK16 * 4;
}

template <int NW, int DP>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_bf16(const Params p) {
  constexpr int BQ = 16 * NW;
  constexpr int SQ = DP + PAD16;   // row stride of sQ and sK
  constexpr int SV = BK16 + PAD16;  // row stride of sVt ([DP][BK])
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * SQ;
  __nv_bfloat16* sVt = sK + BK16 * SQ;
  int* sKpos = reinterpret_cast<int*>(sVt + DP * SV);
  int* sKseg = sKpos + BK16;
  int* sKval = sKseg + BK16;
  __shared__ int scratch[4];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hk);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + hk * p.v_sh;

  const QStats qs = q_tile_stats(p, b, q0, BQ, scratch);
  load_rows<__nv_bfloat16, DP>(sQ, SQ, qb, p.q_st, q0, BQ, p.Tq, p.D,
                                p.vec);
  __syncthreads();

  // This thread's two q rows within the warp's 16: g and g + 8.
  const int wr = q0 + warp * 16;
  int qpos[2], qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    const bool in = row < p.Tq;
    qpos[i] = in ? p.q_pos[(long long)b * p.Tq + row] : 0;
    qseg[i] = in ? p.q_seg[(long long)b * p.Tq + row] : -1;
  }
  const bool warp_live = wr < p.Tq;

  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* base = sQ + (warp * 16) * SQ + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + g * SQ);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * SQ);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + g * SQ + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * SQ + 8);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int nk = kv_tiles(p, qs, BK16);
  for (int it = 0; it < nk; ++it) {
    const int kv0 = it * BK16;
    __syncthreads();  // every warp is done with the previous tile
    if (!stage_kv_ints<BK16>(p, b, kv0, qs, sKpos, sKseg, sKval,
                             &scratch[3]))
      continue;
    load_rows<__nv_bfloat16, DP>(sK, SQ, kb, p.k_st, kv0, BK16, p.Tk, p.D,
                                  p.vec);
    load_rows_t<__nv_bfloat16, DP>(sVt, SV, vb, p.v_st, kv0, BK16, p.Tk,
                                    p.D, p.vec);
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T for the warp's 16 rows x 64 kv columns (8 n-tiles).
    float s[BK16 / 8][4];
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* kp = sK + (n * 8 + g) * SQ + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Scale, mask, and the online-softmax update (rows g and g + 8).
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1), i = e >> 1;
        s[n][e] = unmasked(p, qpos[i], qseg[i], sKpos[c], sKseg[c], sKval[c])
                      ? s[n][e] * p.scale
                      : NEG;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
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

    // acc += P V: p (rounded to bf16) is the A operand straight from the
    // S accumulators; V^T in shared memory is the B operand.
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const __nv_bfloat16* vp = sVt + (dn * 8 + g) * SV + kk * 16 + 2 * t;
        mma_bf16(acc[dn], a, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wr + g + 8 * i;
    if (row >= p.Tq) continue;
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.Hq + h) * p.Tq + row] =
          l[i] == 0.f ? FLT_MAX : m[i] + logf(l[i]);
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = dn * 8 + 2 * t + j;
        if (c < p.D)
          ob[row * p.o_st + c] = __float2bfloat16(acc[dn][2 * i + j] * inv);
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NW, int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  dim3 grid((p.Tq + 16 * NW - 1) / (16 * NW), p.Hq, p.B);
  return launch(flash_fwd_bf16<NW, DP>, grid, NW * 32, smem_bf16<NW, DP>(),
                p, stream);
}

// Padded widths: 16 for the small test heads, 80 for the ViT's 72, 128 for
// the decoder's 128. Any other D takes the next of them.
template <int NW>
cudaError_t dispatch_bf16(const Params& p, cudaStream_t stream) {
  if (p.D <= 16) return launch_bf16<NW, 16>(p, stream);
  if (p.D <= 80) return launch_bf16<NW, 80>(p, stream);
  return launch_bf16<NW, 128>(p, stream);
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
                   int kv_arange, int vec) {
  Params p;
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
  p.vec = vec;
  return p;
}

bool valid_shape(int B, int Hq, int Hk, int Tq, int Tk, int D) {
  return B > 0 && Hq > 0 && Hk > 0 && Hq % Hk == 0 && Tq > 0 && Tk > 0 &&
         D > 0 && D <= 128 && B <= 65535 && Hq <= 65535;
}

}  // namespace

// Plain C entry points (bound with ctypes). `strides` holds 12 element
// strides: (batch, head, token) for q, k, v and o; `lse` is a contiguous fp32
// [B, Hq, Tq] buffer or null. Each returns the cudaError_t of the launch (0
// on success); nothing is synchronised.
extern "C" int oryx_flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, const void* q_pos, const void* kv_pos,
    const void* q_seg, const void* kv_seg, const void* kv_valid, int B,
    int Hq, int Hk, int Tq, int Tk, int D, float scale, int causal,
    int has_segments, int kv_arange, int vec, void* stream) {
  if (!valid_shape(B, Hq, Hk, Tq, Tk, D)) return cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, lse, strides, q_pos, kv_pos, q_seg,
                               kv_seg, kv_valid, B, Hq, Hk, Tq, Tk, D, scale,
                               causal, has_segments, kv_arange, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Tq <= 16 ? dispatch_bf16<1>(p, s) : dispatch_bf16<4>(p, s);
}

extern "C" int oryx_flash_fwd_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, const void* q_pos, const void* kv_pos,
    const void* q_seg, const void* kv_seg, const void* kv_valid, int B,
    int Hq, int Hk, int Tq, int Tk, int D, float scale, int causal,
    int has_segments, int kv_arange, int vec, void* stream) {
  if (!valid_shape(B, Hq, Hk, Tq, Tk, D)) return cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, lse, strides, q_pos, kv_pos, q_seg,
                               kv_seg, kv_valid, B, Hq, Hk, Tq, Tk, D, scale,
                               causal, has_segments, kv_arange, vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_f32<32>(p, s);
  if (D <= 96) return launch_f32<96>(p, s);
  return launch_f32<128>(p, s);
}
