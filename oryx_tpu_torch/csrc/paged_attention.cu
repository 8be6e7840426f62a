// Paged attention for NVIDIA Hopper (sm_90a): the ragged-paged kernel K4 and
// its single-token decode front end K3.
//
// Replaces the Pallas TPU kernels of oryx_tpu/ops/pallas/paged_attention.py:
//   * `_ragged_paged` (K4, body `_ragged_kernel`): R packed query rows drawn
//     from many sequences; row r walks the block table of its segment
//     q_segments[r] (clamped into [0, S - 1]) and sees logical slots
//     j <= q_positions[r];
//   * `_paged_decode` (K3, body `_decode_kernel`): one query per batch row b,
//     walking table row b up to kv_lengths[b].
// Both are one kernel here: K3 is K4 with segment = r and
// length = kv_lengths[r] (K4's length is q_positions[r] + 1), so the masks
// and clamps are the same code. Semantics kept from the Pallas bodies:
// logits are fp32 and scaled, slots at or past the row's length are set to
// NEG = -0.7 * FLT_MAX, the online state (m, l, acc) is fp32, p is rounded to
// the value dtype before P.V, the output is acc / (l == 0 ? 1 : l), and a
// table entry at or past P (the sentinel) is clamped to page P - 1. A row
// with no visible slot writes zeros.
//
// Quantized pools (the Pallas kernels' `dequant_dtype` branch,
// `_decode_kernel` and `_ragged_kernel` with their scale BlockSpecs): the
// pages hold int8 or fp8-e4m3 codes plus one fp32 scale per token row
// ([P, page_size], shared by the Hk heads, read through the same clamped
// block-table entry as the codes). Each K/V row is dequantized on its way
// into shared memory with the Pallas body's rounding points,
// k = k.astype(dq) * scale.astype(dq): in bf16 the scale is rounded to bf16
// first and the product rounded once more to bf16 (one fp32 product
// code * scale rounded once gives other bits); in fp32 one fp32 product.
// Every int8 and e4m3 code is exact in bf16, so the code converts by value
// (e4m3 by its bits). Everything after the staging is the dense kernel's.
//
// Layout: one block per (packed row, kv head). The G = Hq / Hk query heads
// of the group (head h = hk * G + g) are the rows of one 16-row
// `mma.sync.m16n8k16` tile, so each kv head's pages are streamed once, not G
// times. Four warps split the row's kv slots: warp w takes slot tiles
// w, w + 4, ... (64 slots a tile for bf16, 32 for fp32; at page_size 64 a
// bf16 tile is one page), each slot read from its page through the block
// table, tiles past the row's last visible slot never visited. Each warp
// keeps its own online-softmax state; the four are merged at the end in
// shared memory.
//
// What bounds it on an H100: per row and kv head it moves 2 * len * D value
// bytes and does 4 * G * D flops per visible slot, about 2 * G = 14 flops a
// byte at oryx_7b, far below the ~295 flop/byte ridge: it is bound by the
// bytes it reads (on a quantized pool len * D code bytes and len * 4 scale
// bytes a plane, about half). This first version reads each page row once
// into shared memory with 16-byte loads (8 bf16 values or 16 codes; the
// pools are 16-byte aligned and D is a multiple of 8, of 16 for codes; the
// wrapper checks both) and stops at the row's length;
// with one block per (row, kv head) a decode step of few slots fills few
// SMs, which split-KV across blocks, TMA and wgmma address in a later
// version.
//
// Inputs: q [R, Hq, D] (row stride given, heads and features contiguous);
// k_pages/v_pages [P, page_size, Hk, D] contiguous (codes when quantized,
// with k_scale/v_scale [P, page_size] fp32); block_tables [S, maxp] int32; ints [R] int32 (kv_lengths for K3, q_segments and q_positions for
// K4); o [R, Hq, D] contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float NEG = -0.7f * FLT_MAX;
constexpr int NW = 4;     // warps a block
constexpr int GMAX = 16;  // q heads per kv head the tile holds

// Page formats: dense pages in the compute dtype, or codes.
enum Code { DENSE = 0, INT8 = 1, FP8 = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // per-row scales [P, ps] (quantized pools)
  const float* vs;
  void* o;
  long long q_sr;  // q row stride (elements)
  const int* bt;
  const int* seg;   // K4 only
  const int* ints;  // kv_lengths (K3) or q_positions (K4)
  int R, Hk, G, D, P, ps, S, maxp;
  float scale;
  int decode;
};

// The row's table row and the number of visible logical slots, capped at the
// table's width.
__device__ __forceinline__ void row_extent(const Params& p, int r, int* seg,
                                           int* len) {
  if (p.decode) {
    *seg = r;
    *len = p.ints[r];
  } else {
    *seg = min(max(p.seg[r], 0), p.S - 1);
    *len = p.ints[r] + 1;
  }
  *len = max(0, min(*len, p.maxp * p.ps));
}

// Pool row (page * ps + offset) of logical slot `slot` of table row `seg`:
// the index of its scale, and of its codes or values with `row_offset`. The
// sentinel (and anything outside the pool) clamps into it.
__device__ __forceinline__ long long slot_row(const Params& p, int seg,
                                              int slot) {
  int page = p.bt[(long long)seg * p.maxp + slot / p.ps];
  page = min(max(page, 0), p.P - 1);
  return (long long)page * p.ps + slot % p.ps;
}

__device__ __forceinline__ long long row_offset(const Params& p,
                                                long long row, int hk) {
  return (row * p.Hk + hk) * p.D;
}

// A code's value: int8 as itself, e4m3 (sign, 4 exponent bits of bias 7, 3
// mantissa bits, no infinities) by its bits. Codes are clipped to +-448 on
// write, so the NaN pattern never occurs.
template <int CODE>
__device__ __forceinline__ float code_value(uint8_t b) {
  if constexpr (CODE == INT8) {
    return static_cast<float>(static_cast<int8_t>(b));
  } else {
    const uint32_t sign = static_cast<uint32_t>(b & 0x80u) << 24;
    const uint32_t e = (b >> 3) & 15u, m = b & 7u;
    if (e == 0) {  // subnormal: m * 2^-9
      const float v = static_cast<float>(m) * 0.001953125f;
      return sign ? -v : v;
    }
    return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
  }
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

// Merge the NW warps' online-softmax states of the tile's first G rows and
// store o = acc / l. sM/sL: [NW][GMAX]; sAcc: [NW][GMAX][DP] (fp32).
template <typename T, int DP>
__device__ void merge_and_store(const Params& p, int r, int hk,
                                const float* sM, const float* sL,
                                const float* sAcc) {
  T* ob = static_cast<T*>(p.o) + ((long long)r * p.Hk + hk) * p.G * p.D;
  for (int i = threadIdx.x; i < p.G * p.D; i += blockDim.x) {
    const int g = i / p.D, c = i % p.D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sM[w * GMAX + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sM[w * GMAX + g] - M);
      L += sL[w * GMAX + g] * f;
      A += sAcc[(w * GMAX + g) * DP + c] * f;
    }
    const float out = A / (L == 0.f ? 1.f : L);
    if constexpr (sizeof(T) == 2) {
      ob[g * p.D + c] = __float2bfloat16(out);
    } else {
      ob[g * p.D + c] = out;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, 64-slot tiles, K and V^T staged per warp.
// ---------------------------------------------------------------------------

constexpr int BK16 = 64;
constexpr int PAD16 = 8;  // row padding (elements): conflict-free fragments

template <int DP>
__host__ __device__ constexpr int tile_bytes_bf16() {
  return (BK16 * (DP + PAD16) + DP * (BK16 + PAD16)) * 2;
}

template <int DP>
__host__ __device__ constexpr int smem_bf16() {
  constexpr int tiles = NW * tile_bytes_bf16<DP>();
  constexpr int merge = NW * GMAX * (DP + 2) * 4;
  return GMAX * (DP + PAD16) * 2 + (tiles > merge ? tiles : merge);
}

template <int DP, int CODE>
__global__ void __launch_bounds__(NW * 32) paged_bf16(const Params p) {
  constexpr int SQ = DP + PAD16;   // row stride of sQ and sK
  constexpr int SV = BK16 + PAD16;  // row stride of sVt ([DP][BK])
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* work = smem + GMAX * SQ * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = blockIdx.x, hk = blockIdx.y;
  __nv_bfloat16* sK =
      reinterpret_cast<__nv_bfloat16*>(work + warp * tile_bytes_bf16<DP>());
  __nv_bfloat16* sVt = sK + BK16 * SQ;

  int seg, len;
  row_extent(p, r, &seg, &len);

  // The group's G q heads -> rows 0..G-1 of the tile; the rest are zero.
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            r * p.q_sr + (long long)hk * p.G * p.D;
  for (int i = threadIdx.x; i < GMAX * DP; i += blockDim.x) {
    const int row = i / DP, c = i % DP;
    sQ[row * SQ + c] = (row < p.G && c < p.D) ? qb[row * p.D + c]
                                              : __float2bfloat16(0.f);
  }
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* base = sQ + kk * 16 + 2 * t;
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

  const int ntiles = (len + BK16 - 1) / BK16;
  // Elements per 16-byte chunk: 8 bf16 values or 16 codes.
  constexpr int E = CODE == DENSE ? 8 : 16;
  constexpr int CH = DP / E;
  for (int it = warp; it < ntiles; it += NW) {
    const int s0 = it * BK16;
    __syncwarp();  // the warp is done with its previous tile
    for (int i = lane; i < BK16 * CH; i += 32) {
      const int j = i / CH, c = (i % CH) * E, slot = s0 + j;
      __align__(16) __nv_bfloat16 kv[E];
      __align__(16) __nv_bfloat16 vv[E];
      if (slot < len && c < p.D) {  // D % E == 0: the chunk is in the row
        const long long row = slot_row(p, seg, slot);
        const long long off = row_offset(p, row, hk) + c;
        if constexpr (CODE == DENSE) {
          *reinterpret_cast<uint4*>(kv) =
              *reinterpret_cast<const uint4*>(
                  static_cast<const __nv_bfloat16*>(p.k) + off);
          *reinterpret_cast<uint4*>(vv) =
              *reinterpret_cast<const uint4*>(
                  static_cast<const __nv_bfloat16*>(p.v) + off);
        } else {
          __align__(16) uint8_t kc[16];
          __align__(16) uint8_t vc[16];
          *reinterpret_cast<uint4*>(kc) = *reinterpret_cast<const uint4*>(
              static_cast<const uint8_t*>(p.k) + off);
          *reinterpret_cast<uint4*>(vc) = *reinterpret_cast<const uint4*>(
              static_cast<const uint8_t*>(p.v) + off);
          // The scale rounds to bf16, then each product rounds to bf16
          // (the product of two bf16 values is exact in fp32).
          const float ksc = __bfloat162float(__float2bfloat16(p.ks[row]));
          const float vsc = __bfloat162float(__float2bfloat16(p.vs[row]));
#pragma unroll
          for (int e = 0; e < E; ++e) {
            kv[e] = __float2bfloat16(code_value<CODE>(kc[e]) * ksc);
            vv[e] = __float2bfloat16(code_value<CODE>(vc[e]) * vsc);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kv[e] = __float2bfloat16(0.f);
          vv[e] = __float2bfloat16(0.f);
        }
      }
#pragma unroll
      for (int e = 0; e < E; e += 8)
        *reinterpret_cast<uint4*>(sK + j * SQ + c + e) =
            *reinterpret_cast<const uint4*>(kv + e);
#pragma unroll
      for (int e = 0; e < E; ++e) sVt[(c + e) * SV + j] = vv[e];
    }
    __syncwarp();

    // S = Q K^T: 16 rows (the group's heads) x 64 slots.
    float s[BK16 / 8][4];
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const __nv_bfloat16* kr = sK + (n * 8 + g) * SQ + kk * 16 + 2 * t;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int n = 0; n < BK16 / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = s0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = c < len ? s[n][e] * p.scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
    // acc += P V, p rounded to bf16 straight from the S accumulators.
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        const __nv_bfloat16* vr = sVt + (dn * 8 + g) * SV + kk * 16 + 2 * t;
        mma_bf16(acc[dn], a, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  // Merge the warps' states (the tile area is reused).
  __syncthreads();
  float* sM = reinterpret_cast<float*>(work);
  float* sL = sM + NW * GMAX;
  float* sAcc = sL + NW * GMAX;
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
  merge_and_store<__nv_bfloat16, DP>(p, r, hk, sM, sL, sAcc);
}

// ---------------------------------------------------------------------------
// fp32: plain FMA, 32-slot tiles. Lane j owns slot j of the tile for the
// logits and feature columns lane + 32 c of the accumulators.
// ---------------------------------------------------------------------------

constexpr int BK32 = 32;

template <int DP>
__host__ __device__ constexpr int tile_bytes_f32() {
  return (BK32 * (DP + 1) + BK32 * DP) * 4;
}

template <int DP>
__host__ __device__ constexpr int smem_f32() {
  constexpr int tiles = NW * tile_bytes_f32<DP>();
  constexpr int merge = NW * GMAX * (DP + 2) * 4;
  return GMAX * DP * 4 + (tiles > merge ? tiles : merge);
}

template <int DP, int CODE>
__global__ void __launch_bounds__(NW * 32) paged_f32(const Params p) {
  constexpr int SK = DP + 1;  // sK row stride: lane j reads row j
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + GMAX * DP * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x, hk = blockIdx.y;
  float* sK = reinterpret_cast<float*>(work + warp * tile_bytes_f32<DP>());
  float* sV = sK + BK32 * SK;

  int seg, len;
  row_extent(p, r, &seg, &len);

  const float* qb = static_cast<const float*>(p.q) + r * p.q_sr +
                    (long long)hk * p.G * p.D;
  for (int i = threadIdx.x; i < GMAX * DP; i += blockDim.x) {
    const int row = i / DP, c = i % DP;
    sQ[i] = (row < p.G && c < p.D) ? qb[row * p.D + c] : 0.f;
  }
  __syncthreads();

  float m[GMAX], l[GMAX], acc[GMAX][DP / 32];
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 32; ++c) acc[i][c] = 0.f;
  }

  const int ntiles = (len + BK32 - 1) / BK32;
  for (int it = warp; it < ntiles; it += NW) {
    const int s0 = it * BK32;
    __syncwarp();
    for (int i = lane; i < BK32 * DP; i += 32) {
      const int j = i / DP, c = i % DP, slot = s0 + j;
      float kv = 0.f, vv = 0.f;
      if (slot < len && c < p.D) {
        const long long row = slot_row(p, seg, slot);
        const long long off = row_offset(p, row, hk) + c;
        if constexpr (CODE == DENSE) {
          kv = static_cast<const float*>(p.k)[off];
          vv = static_cast<const float*>(p.v)[off];
        } else {  // one fp32 product, as k.astype(f32) * scale
          kv = code_value<CODE>(static_cast<const uint8_t*>(p.k)[off]) *
               p.ks[row];
          vv = code_value<CODE>(static_cast<const uint8_t*>(p.v)[off]) *
               p.vs[row];
        }
      }
      sK[j * SK + c] = kv;
      sV[j * DP + c] = vv;
    }
    __syncwarp();
    const bool live = s0 + lane < len;
#pragma unroll
    for (int i = 0; i < GMAX; ++i) {
      if (i >= p.G) break;
      const float* qr = sQ + i * DP;
      const float* kr = sK + lane * SK;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float s = live ? dot * p.scale : NEG;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float pj = expf(s - m_new);
      float sum = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
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
      for (int c = 0; c < DP / 32; ++c) acc[i][c] = acc[i][c] * alpha + pv[c];
    }
  }

  __syncthreads();
  float* sM = reinterpret_cast<float*>(work);
  float* sL = sM + NW * GMAX;
  float* sAcc = sL + NW * GMAX;
#pragma unroll
  for (int i = 0; i < GMAX; ++i) {
    if (lane == 0) {
      sM[warp * GMAX + i] = m[i];
      sL[warp * GMAX + i] = l[i];
    }
#pragma unroll
    for (int c = 0; c < DP / 32; ++c)
      sAcc[(warp * GMAX + i) * DP + lane + 32 * c] = acc[i][c];
  }
  __syncthreads();
  merge_and_store<float, DP>(p, r, hk, sM, sL, sAcc);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.R, p.Hk), NW * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int CODE>
cudaError_t dispatch_code(const Params& p, int bf16, cudaStream_t s) {
  if (bf16) {
    if (p.D <= 16)
      return launch(paged_bf16<16, CODE>, smem_bf16<16>(), p, s);
    return launch(paged_bf16<128, CODE>, smem_bf16<128>(), p, s);
  }
  if (p.D <= 32) return launch(paged_f32<32, CODE>, smem_f32<32>(), p, s);
  return launch(paged_f32<128, CODE>, smem_f32<128>(), p, s);
}

// Padded widths: bf16 16 (test heads) and 128 (the decoder); fp32 32 and
// 128. Any other D takes the next of them.
cudaError_t dispatch(const Params& p, int bf16, int code, cudaStream_t s) {
  if (code == INT8) return dispatch_code<INT8>(p, bf16, s);
  if (code == FP8) return dispatch_code<FP8>(p, bf16, s);
  return dispatch_code<DENSE>(p, bf16, s);
}

int run(const void* q, const void* k, const void* v, const void* ks,
        const void* vs, void* o, long long q_sr, const void* bt,
        const void* seg, const void* ints, int R, int Hk, int G, int D,
        int P, int ps, int S, int maxp, float scale, int decode, int bf16,
        int code, void* stream) {
  if (R <= 0 || Hk <= 0 || Hk > 65535 || G <= 0 || G > GMAX || D <= 0 ||
      D > 128 || P <= 0 || ps <= 0 || S <= 0 || maxp <= 0 || code < DENSE ||
      code > FP8 || (code != DENSE && (ks == nullptr || vs == nullptr)))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.o = o;
  p.q_sr = q_sr;
  p.bt = static_cast<const int*>(bt);
  p.seg = static_cast<const int*>(seg);
  p.ints = static_cast<const int*>(ints);
  p.R = R, p.Hk = Hk, p.G = G, p.D = D, p.P = P, p.ps = ps, p.S = S;
  p.maxp = maxp;
  p.scale = scale;
  p.decode = decode;
  return dispatch(p, bf16, code, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the cudaError_t of
// the launch (0 on success); nothing is synchronised. `bf16` selects the
// dtype of q and o, and of dense pages (1: bfloat16, 0: float32); `code`
// the page format (0 dense, 1 int8 codes, 2 fp8-e4m3 codes), with the
// per-row scale planes k_scale/v_scale [P, ps] fp32 for codes (else null).
//
// K3: one query row per table row; kv_lengths [R] int32 counts the visible
// slots (the current token included).
extern "C" int oryx_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, void* o, long long q_sr,
                                 const void* block_tables,
                                 const void* kv_lengths, int R, int Hk, int G,
                                 int D, int P, int ps, int maxp, float scale,
                                 int bf16, int code, void* stream) {
  return run(q, k_pages, v_pages, k_scale, v_scale, o, q_sr, block_tables,
             nullptr, kv_lengths, R, Hk, G, D, P, ps, R, maxp, scale, 1, bf16,
             code, stream);
}

// K4: R packed rows over S table rows; q_segments/q_positions [R] int32.
extern "C" int oryx_ragged_paged(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, void* o, long long q_sr,
                                 const void* block_tables,
                                 const void* q_segments,
                                 const void* q_positions, int R, int Hk,
                                 int G, int D, int P, int ps, int S, int maxp,
                                 float scale, int bf16, int code,
                                 void* stream) {
  return run(q, k_pages, v_pages, k_scale, v_scale, o, q_sr, block_tables,
             q_segments, q_positions, R, Hk, G, D, P, ps, S, maxp, scale, 0,
             bf16, code, stream);
}
