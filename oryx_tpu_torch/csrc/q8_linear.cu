// The int8-weight product for NVIDIA Hopper (sm_90a), at every row count:
//   y[M, N] = x[M, K] . deq(q[N, K], scale[N])^T (+ bias[N]),
// or, for a tied head (the int8 embedding table [V, H] with one scale per
// column), deq(q[N, K], scale[K]): the scale of column k, not of channel n.
// One launch serves up to MAXG products that share x (q/k/v, gate/up): a
// grouped launch whose blocks walk the members' channel tiles in turn.
//
// Replaces no Pallas kernel: the JAX package computes this product in XLA,
// which fuses `Q8Weight.astype(dt)` (oryx_tpu/utils/quant.py:68,
// q.astype(dt) * scale.astype(dt)) into the matmul's operand read, so int8
// is what crosses HBM (oryx_tpu/models/qwen2.py:147, :543). Eager PyTorch
// would run the cast, the multiply and the GEMM as three kernels, about 9
// bytes a weight against bf16's 2; these kernels read the codes directly.
//
// Semantics, kept from the plain twin's operand
// (ops/cuda/q8_linear.py::q8_linear_reference):
//   * bf16 x: deq = bf16(bf16(q) * bf16(scale)). Every code is exact in
//     bf16, so one bf16x2 multiply (rounded to nearest even) of a code pair
//     and the scale (a pair of them, per column) gives the twin's weight.
//     The product runs on the tensor cores with fp32 accumulation and is
//     rounded once to bf16 with the bias (bf16, added in fp32).
//   * fp32 x: deq = float(q) * scale in fp32 and fp32 FMA sums (no TF32).
//
// What bounds it on an H100: N K code bytes read once against 2 M N K
// flops. Up to ~150 rows that is below the bf16 ridge (~295 flops a byte):
// the bytes bound it; above, the tensor cores. Five routes, chosen by the
// wrapper from M and the dtype (constant boundaries: SMALL_ROWS = 64 and
// WIDE_ROWS = 256 rows):
//
// Route 0, bf16, M <= 64 (bytes): `q8_small`. A block of 4 warps owns 64
// output channels, all M rows (a bucket of 8, 16, 32 or 64) and one
// range of k blocks (64 columns). The codes and x of each k block stream
// into a ring of SSTAGES stages in shared memory by cp.async, three blocks
// ahead, so each SM keeps tens of KB in flight. A warp reads its 16-channel
// tiles' codes from the ring (thread (g, t): bytes 16 t .. 16 t + 15 of
// channels g and g + 8) and the x rows' same columns, and runs mma.sync
// m16n8k16 with the weight as A and the x rows as B ("swap AB": x rows are
// the mma's n8 columns). The k slots of the four k16 mmas of a block are a
// fixed permutation of its columns (slot 2 t + e of mma j is column
// 16 t + 4 j + e, slot 2 t + 8 + e column 16 t + 4 j + 2 + e), the same for
// A and B, so each thread's 16-byte reads are its fragments as they are.
// Split-K: the k blocks are cut into `splits` ranges (1, 2, 4 or 8, from K
// and the route alone), and the splits of one channel tile form a
// thread-block cluster.
// Each block leaves its fp32 partial tile in its shared memory; after a
// cluster barrier, block r sums slice r of the tile over the cluster's
// blocks in split order through distributed shared memory, adds the bias
// and stores bf16. One launch, no atomics, no scratch in device memory.
//
// Routes 1 (bf16, 64 < M <= 256) and 4 (bf16, M > 256; operations from
// ~150 rows): `q8_large`, the two with their own split plans (fewer splits
// past 256 rows, where row tiles fill the card). A block of two
// warpgroups owns a 128-row x 128-channel tile and one k range (the same
// cluster merge); the row tiles of a channel tile are launched side by
// side, so they read its codes from L2. Per k block, cp.async brings x (each
// warpgroup its 64 rows, in the 128-byte swizzled layout of hopper.cuh)
// and the codes into a ring of LSTAGES stages; the block dequantizes the
// codes into a bf16 [128][64] swizzled tile (double-buffered), and each
// warpgroup issues four wgmma m64n128k16 (x its A, the weight tile its B,
// both K-major from shared memory). The dequantization of block i runs
// while the tensor cores work on block i - 1. Each code byte crosses HBM
// once per 128-row tile.
//
// Route 2, fp32, M <= 64: `q8_f32_small` (SIMT): a warp owns one output
// channel, lane l takes its 16-code chunks l, l + 32, ..., and a butterfly
// over the lanes sums each row's products.
// Route 3, fp32, M > 64: `q8_f32_tiled` (SIMT): a block computes a 64 x 64
// tile, x and the dequantized weight staged through shared memory 16
// columns at a time, each thread a 4 x 4 block of fp32 FMA chains.
//
// Determinism: every output's sum runs over its k blocks in order inside
// its split, then the fixed split-order merge (or the fixed butterfly); an
// mma or wgmma computes each output from its own row and channel only.
// Nothing depends on M, the row bucket, the tile, the group or the other
// rows' values, so within a route a row gets the same bits at any M, in a
// group or alone, and two launches give the same bits. The routes sum in
// different orders, so a row's bits may differ between routes.
// Tails: K not a multiple of 16 (or an operand not 16-byte aligned) takes
// scalar loads with zeros past K in the same order; rows past M and
// channels past N are zeros in shared memory and stored nowhere. The
// launches allocate nothing, run on the caller's stream and never
// synchronize, so they can be captured in a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

constexpr int Q8_MAXG = 4;  // products of one grouped launch

// One grouped product's operands, built once per weight group by the
// wrapper (ops/cuda/q8_linear.py::_Weights mirrors this layout).
struct OryxQ8Weights {
  const void* q[Q8_MAXG];
  const void* scale[Q8_MAXG];
  const void* bias[Q8_MAXG];
  int n[Q8_MAXG];
  int count;
  int K;
  int col;      // one scale per input column (the tied head)
  int aligned;  // K % 16 == 0 and q (and a column scale) 16-byte aligned
};

namespace {

constexpr int KB = 64;  // columns of a k block (one ring stage)
constexpr int MAXG = Q8_MAXG;

struct Member {
  const int8_t* q;
  const float* scale;
  const void* bias;
  void* y;
  int N;
  int tile0;  // the member's first tile in the launch
};

struct Params {
  Member m[MAXG];
  const void* x;
  int count, M, K, nkb, splits, kps, vec;
};

// The member that owns launch tile `tile` (tiles are numbered member after
// member). Unrolled, so only constant offsets into the parameters are read.
__device__ __forceinline__ Member member_of(const Params& p, int tile) {
  Member s = p.m[0];
#pragma unroll
  for (int j = 1; j < MAXG; ++j)
    if (j < p.count && tile >= p.m[j].tile0) s = p.m[j];
  return s;
}

// Four codes of `w` (int8, little-endian) as exact fp32 integers: the byte
// biased by 128 is placed in the mantissa of 2^23, and 2^23 + 128 taken off.
__device__ __forceinline__ void codes4(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// bf16(bf16(q) * s) of four codes as two bf16x2: codes (0, 1) times s01
// and codes (2, 3) times s23 (the same pair twice for a channel's scale).
__device__ __forceinline__ void deq_bf16(uint32_t w, __nv_bfloat162 s01,
                                         __nv_bfloat162 s23, uint32_t& lo,
                                         uint32_t& hi) {
  float f[4];
  codes4(w, f);
  // Exact integers: their bf16 bits are the high halves of the fp32 bits.
  uint32_t p01 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                             0x7632);
  uint32_t p23 = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]),
                             0x7632);
  __nv_bfloat162 v01 =
      __hmul2(*reinterpret_cast<__nv_bfloat162*>(&p01), s01);
  __nv_bfloat162 v23 =
      __hmul2(*reinterpret_cast<__nv_bfloat162*>(&p23), s23);
  lo = *reinterpret_cast<uint32_t*>(&v01);
  hi = *reinterpret_cast<uint32_t*>(&v23);
}

// 16 codes of a row from column k: one 16-byte load on the vector path,
// else bytes with zeros past K.
__device__ __forceinline__ uint4 load_codes(const int8_t* row, int k, int K,
                                            bool vec) {
  if (vec && k + 16 <= K) return __ldg(reinterpret_cast<const uint4*>(row + k));
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int kk = k + 4 * i + b;
      const uint32_t byte =
          kk < K ? static_cast<uint32_t>(static_cast<uint8_t>(row[kk])) : 0u;
      v |= byte << (8 * b);
    }
    w[i] = v;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& c, int i) {
  return i == 0 ? c.x : i == 1 ? c.y : i == 2 ? c.z : c.w;
}

// `n` per-column scales from column k (zeros past K): 16-byte loads on the
// vector path.
template <int n>
__device__ __forceinline__ void load_scales(const float* scale, int k, int K,
                                            bool vec, float f[n]) {
  if (vec && k + n <= K) {
#pragma unroll
    for (int i = 0; i < n / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(scale + k) + i);
      f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z,
      f[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < n; ++i) f[i] = k + i < K ? scale[k + i] : 0.f;
}

// 16 codes global -> shared: channel row `row` (valid when `in`) from
// column k, by cp.async on the vector path (K % 16 == 0, so a chunk is
// all in or all past K), else by bytes with zeros past K.
__device__ __forceinline__ void copy_codes16(unsigned char* dst,
                                             const int8_t* row, int k, int K,
                                             bool in, bool vec) {
  if (vec) {
    hopper::cp_async16(dst, row + (in && k < K ? k : 0),
                       in && k < K ? 16 : 0);
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int kk = k + 4 * i + b;
      const uint32_t byte =
          in && kk < K ? static_cast<uint32_t>(static_cast<uint8_t>(row[kk]))
                       : 0u;
      v |= byte << (8 * b);
    }
    w[i] = v;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 bf16 of an x row global -> shared from column k, as copy_codes16.
__device__ __forceinline__ void copy_x8(unsigned char* dst,
                                        const __nv_bfloat16* row, int k,
                                        int K, bool in, bool vec) {
  if (vec) {
    hopper::cp_async16(dst, row + (in && k < K ? k : 0),
                       in && k < K ? 16 : 0);
    return;
  }
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k0 = k + 2 * i;
    const uint32_t a = in && k0 < K ? r[k0] : 0u;
    const uint32_t b = in && k0 + 1 < K ? r[k0 + 1] : 0u;
    w[i] = a | (b << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bias_at(const void* bias, int n) {
  return bias == nullptr
             ? 0.f
             : __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
}

// ---- route 0: bf16, M <= 64 -------------------------------------------------

constexpr int SWARPS = 4;
constexpr int SSTAGES = 4;

template <int MT>
struct SmallCfg {
  static constexpr int BN = SWARPS * 16;  // channels of a tile
  static constexpr int ROWS = 8 * MT;     // x rows a block holds
  static constexpr int XS = KB * 2 + 16;  // bytes of an x row (padded)
  static constexpr int CODES = BN * KB;   // a stage's code bytes
  static constexpr int STAGE = CODES + ROWS * XS;
  static constexpr int RING = SSTAGES * STAGE;
  static constexpr int RED = BN * ROWS * 4;    // the fp32 partial tile
  static constexpr int SMEM = RING > RED ? RING : RED;
};

template <int MT, bool COL>
__global__ void __launch_bounds__(SWARPS * 32)
    q8_small(const __grid_constant__ Params p) {
  using C = SmallCfg<MT>;
  constexpr int T = SWARPS * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / p.splits, split = blockIdx.x % p.splits;
  const Member mb = member_of(p, tile);
  const int N = mb.N, K = p.K, M = p.M;
  const int n0 = (tile - mb.tile0) * C::BN;
  const bool vec = p.vec != 0;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const int kb0 = split * p.kps;
  const int nk = max(0, min(p.nkb, kb0 + p.kps) - kb0);

  auto load = [&](int s, int kb) {
    unsigned char* st = smem + s * C::STAGE;
    const int k0 = kb * KB;
#pragma unroll
    for (int i = 0; i < C::BN * 4 / T; ++i) {
      const int c = tid + T * i, r = c >> 2, n = n0 + r;
      copy_codes16(st + r * KB + 16 * (c & 3),
                   mb.q + static_cast<size_t>(min(n, N - 1)) * K,
                   k0 + 16 * (c & 3), K, n < N, vec);
    }
#pragma unroll
    for (int i = 0; i < (C::ROWS * 8 + T - 1) / T; ++i) {
      const int c = tid + T * i;
      if (c < C::ROWS * 8) {
        const int r = c >> 3;
        copy_x8(st + C::CODES + r * C::XS + 16 * (c & 7),
                x + static_cast<size_t>(min(r, M - 1)) * K, k0 + 8 * (c & 7),
                K, r < M, vec);
      }
    }
  };

  // This warp's 16 channels: g and g + 8 of them for this thread.
  const int wn = w * 16;
  __nv_bfloat162 s[2];
  if (!COL) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      s[h] = __bfloat162bfloat162(__float2bfloat16_rn(
          mb.scale[min(n0 + wn + 8 * h + g, N - 1)]));
  }
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  auto compute = [&](int st_i, int kb) {
    const unsigned char* st = smem + st_i * C::STAGE;
    uint4 cw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cw[h] = *reinterpret_cast<const uint4*>(st + (wn + 8 * h + g) * KB +
                                              16 * t);
    // Per-column scales: pairs (k + 2 q, k + 2 q + 1) of this thread's 16
    // columns, as bf16x2.
    __nv_bfloat162 cs[8];
    if (COL) {
      float f[16];
      load_scales<16>(mb.scale, kb * KB + 16 * t, K, vec, f);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        cs[q] = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    }
    const unsigned char* xs = st + C::CODES;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 xv[MT];  // columns 16 t + 8 half .. + 7 of rows 8 mt + g
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        xv[mt] = *reinterpret_cast<const uint4*>(
            xs + (8 * mt + g) * C::XS + 32 * t + 16 * half);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * half + jj;
        uint32_t a0, a1, a2, a3;  // (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), ..
        if (COL) {
          deq_bf16(word(cw[0], j), cs[2 * j], cs[2 * j + 1], a0, a2);
          deq_bf16(word(cw[1], j), cs[2 * j], cs[2 * j + 1], a1, a3);
        } else {
          deq_bf16(word(cw[0], j), s[0], s[0], a0, a2);
          deq_bf16(word(cw[1], j), s[1], s[1], a1, a3);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(acc[mt], a0, a1, a2, a3, jj ? xv[mt].z : xv[mt].x,
                   jj ? xv[mt].w : xv[mt].y);
      }
    }
  };

  // The ring: SSTAGES - 1 stages in flight ahead of the one consumed. One
  // commit group per stage (empty past the range), so the wait counts hold.
#pragma unroll
  for (int s0 = 0; s0 < SSTAGES - 1; ++s0) {
    if (s0 < nk) load(s0, kb0 + s0);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    hopper::cp_async_wait<SSTAGES - 2>();
    __syncthreads();  // stage i landed; every thread is done with i - 1
    const int nx = i + SSTAGES - 1;
    if (nx < nk) load(nx % SSTAGES, kb0 + nx);
    hopper::cp_async_commit();
    compute(i % SSTAGES, kb0 + i);
  }

  // c0, c1: channel g, rows 2t, 2t + 1 of the n8 tile; c2, c3: channel g + 8.
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(mb.y);
  if (p.splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + wn + g + 8 * (e >> 1);
        const int m = 8 * mt + 2 * t + (e & 1);
        if (n < N && m < M)
          y[static_cast<size_t>(m) * N + n] =
              __float2bfloat16_rn(acc[mt][e] + bias_at(mb.bias, n));
      }
    return;
  }
  // The cluster merge: partials [ROWS][BN] in each block's shared memory.
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(8 * mt + 2 * t + (e & 1)) * C::BN + wn + g + 8 * (e >> 1)] =
          acc[mt][e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int outs = min(M, C::ROWS) * C::BN;
  for (int o = split * T + tid; o < outs; o += p.splits * T) {
    const int m = o / C::BN, n = n0 + o % C::BN;
    if (n >= N) continue;
    float v = 0.f;
    for (int r = 0; r < p.splits; ++r) v += cluster.map_shared_rank(red, r)[o];
    y[static_cast<size_t>(m) * N + n] =
        __float2bfloat16_rn(v + bias_at(mb.bias, n));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// ---- route 1: bf16, M > 64 --------------------------------------------------

constexpr int LT = 128;                  // rows and channels of a tile
constexpr int LSTAGES = 3;
constexpr int LX = LT * KB * 2;          // a stage's x: two [64][64] halves
constexpr int LC = LT * KB;              // a stage's codes [128][64]
constexpr int LW = LT * KB * 2;          // a dequantized [128][64] tile
constexpr int LSTAGE = LX + LC;
constexpr int LRED = LT + 8;             // floats of a partial row
constexpr int LSMEM = LSTAGES * LSTAGE + 2 * LW + 1024;
static_assert(LT * LRED * 4 <= LSTAGES * LSTAGE, "partials fit the ring");

#define Q8_D8(o)                                                           \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// D[64 x 128] (+)= A . B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n"
      "}\n"
      : Q8_D8(0), Q8_D8(8), Q8_D8(16), Q8_D8(24), Q8_D8(32), Q8_D8(40),
        Q8_D8(48), Q8_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef Q8_D8

template <bool COL>
__global__ void __launch_bounds__(256, 2)
    q8_large(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  unsigned char* wbuf = sm + LSTAGES * LSTAGE;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  // Row tiles vary fastest: the row tiles of one channel tile run side by
  // side and read its codes from L2, not once each from device memory.
  const int tile = blockIdx.y / p.splits, split = blockIdx.y % p.splits;
  const Member mb = member_of(p, tile);
  const int N = mb.N, K = p.K, M = p.M;
  const int n0 = (tile - mb.tile0) * LT, m0 = blockIdx.x * LT;
  const bool vec = p.vec != 0;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const int kb0 = split * p.kps;
  const int nk = max(0, min(p.nkb, kb0 + p.kps) - kb0);

  auto load = [&](int s, int kb) {
    unsigned char* st = sm + s * LSTAGE;
    const int k0 = kb * KB;
    // This warpgroup's 64 x rows: chunk ch of row r at 16 (ch ^ (r % 8)).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = wt + 128 * i, r = c >> 3, ch = c & 7;
      const int row = m0 + 64 * wg + r;
      copy_x8(st + wg * (LX / 2) + r * 128 + ((ch ^ (r & 7)) << 4),
              x + static_cast<size_t>(min(row, M - 1)) * K, k0 + 8 * ch, K,
              row < M, vec);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + 256 * i, r = c >> 2, ch = c & 3, n = n0 + r;
      copy_codes16(st + LX + r * KB + 16 * ch,
                   mb.q + static_cast<size_t>(min(n, N - 1)) * K,
                   k0 + 16 * ch, K, n < N, vec);
    }
  };

  // Dequantization: thread tid writes 8-column chunk c8 of channel rows
  // tid / 8 + 32 j of the tile.
  const int c8 = tid & 7;
  __nv_bfloat162 s2[4];
  if (!COL) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s2[j] = __bfloat162bfloat162(__float2bfloat16_rn(
          mb.scale[min(n0 + (tid >> 3) + 32 * j, N - 1)]));
  }
  auto dequant = [&](int s, int kb, unsigned char* wb) {
    const unsigned char* cs = sm + s * LSTAGE + LX;
    __nv_bfloat162 col2[4];
    if (COL) {
      float f[8];
      load_scales<8>(mb.scale, kb * KB + 8 * c8, K, vec, f);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        col2[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (tid >> 3) + 32 * j;
      const uint2 v = *reinterpret_cast<const uint2*>(cs + r * KB + 8 * c8);
      uint32_t o[4];
      if (COL) {
        deq_bf16(v.x, col2[0], col2[1], o[0], o[1]);
        deq_bf16(v.y, col2[2], col2[3], o[2], o[3]);
      } else {
        deq_bf16(v.x, s2[j], s2[j], o[0], o[1]);
        deq_bf16(v.y, s2[j], s2[j], o[2], o[3]);
      }
      *reinterpret_cast<uint4*>(wb + r * 128 + ((c8 ^ (r & 7)) << 4)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  };

  float d[64];  // written first by a wgmma with scale-d 0
  const uint32_t sa = hopper::smem_addr(sm), wa = hopper::smem_addr(wbuf);
#pragma unroll
  for (int s0 = 0; s0 < LSTAGES - 1; ++s0) {
    if (s0 < nk) load(s0, kb0 + s0);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int s = i % LSTAGES;
    hopper::cp_async_wait<LSTAGES - 2>();
    fence_async_smem();
    __syncthreads();  // stage i landed; every wgmma of i - 2 is complete
    dequant(s, kb0 + i, wbuf + (i & 1) * LW);
    fence_async_smem();
    __syncthreads();  // the dequantized tile is visible to both warpgroups
    hopper::fence_regs(d);
    hopper::wg_fence();
    const uint32_t a = sa + s * LSTAGE + wg * (LX / 2);
    const uint32_t b = wa + (i & 1) * LW;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_n128(d, hopper::desc(a + 32 * kk, 1024, hopper::SW128),
                 hopper::desc(b + 32 * kk, 1024, hopper::SW128),
                 i > 0 || kk > 0);
    hopper::wg_commit();
    hopper::wg_wait1();  // this warpgroup's wgmmas of i - 1 are complete
    hopper::fence_regs(d);
    // The next stage goes into i - 1's slot: its codes were dequantized
    // before this iteration's barrier, and its x rows are this warpgroup's
    // own, read by wgmmas now complete.
    const int nx = i + LSTAGES - 1;
    if (nx < nk) load(nx % LSTAGES, kb0 + nx);
    hopper::cp_async_commit();
  }
  hopper::wg_wait0();
  hopper::fence_regs(d);
  if (nk == 0) {  // an empty split adds zeros to the merge
#pragma unroll
    for (int e = 0; e < 64; ++e) d[e] = 0.f;
  }

  // d[4 j + 2 h + e]: row 16 warp + g + 8 h of this warpgroup's 64, channel
  // 8 j + 2 t + e of the tile.
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = 64 * wg + 16 * warp + g;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(mb.y);
  if (p.splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + rw + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* yr = y + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        const float v0 = d[4 * j + 2 * h] + (n < N ? bias_at(mb.bias, n) : 0.f);
        const float v1 =
            d[4 * j + 2 * h + 1] + (n + 1 < N ? bias_at(mb.bias, n + 1) : 0.f);
        if (n + 1 < N && (reinterpret_cast<uintptr_t>(yr + n) & 3) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < N) yr[n] = __float2bfloat16_rn(v0);
          if (n + 1 < N) yr[n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
    return;
  }
  // The cluster merge: partials [128][LRED] in each block's ring.
  hopper::cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();
  float* red = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(red + (rw + 8 * h) * LRED + 8 * j + 2 * t) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = LT / p.splits, r0 = split * rows;
  for (int o = tid; o < rows * LT; o += 256) {
    const int r = r0 + o / LT, c = o % LT, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = 0.f;
    for (int q = 0; q < p.splits; ++q)
      v += cluster.map_shared_rank(red, q)[r * LRED + c];
    y[static_cast<size_t>(m) * N + n] =
        __float2bfloat16_rn(v + bias_at(mb.bias, n));
  }
  cluster.sync();
}

// ---- route 2: fp32, M <= 64 -------------------------------------------------

constexpr int FWARPS = 4;

template <int MB, bool COL>
__global__ void __launch_bounds__(FWARPS * 32)
    q8_f32_small(const __grid_constant__ Params p) {
  const int lane = threadIdx.x & 31;
  const int gc = blockIdx.x * FWARPS + (threadIdx.x >> 5);  // launch channel
  const Member mb = member_of(p, gc);
  const int n = gc - mb.tile0, N = mb.N, K = p.K, M = p.M;
  if (n >= N) return;  // the whole warp: past the last member
  const bool v = p.vec != 0;
  const float* x = static_cast<const float*>(p.x);
  const int8_t* row = mb.q + static_cast<size_t>(n) * K;
  const float s = COL ? 0.f : mb.scale[n];
  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;

  const int nchunks = (K + 15) / 16;
  for (int c = lane; c < nchunks; c += 32) {
    const int k0 = c * 16;
    const uint4 codes = load_codes(row, k0, K, v);
#pragma unroll
    for (int sub = 0; sub < 4; ++sub) {
      float dq[4];
      codes4(word(codes, sub), dq);
      const int k = k0 + 4 * sub;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dq[j] *= COL ? (k + j < K ? mb.scale[k + j] : 0.f) : s;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (m < M) {
          const float* xr = x + static_cast<size_t>(m) * K;
          float xv[4];
          if (v) {
            const float4 raw = __ldg(reinterpret_cast<const float4*>(xr + k));
            xv[0] = raw.x, xv[1] = raw.y, xv[2] = raw.z, xv[3] = raw.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = k + j < K ? xr[k + j] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m] = fmaf(xv[j], dq[j], acc[m]);
        }
      }
    }
  }
  float* y = static_cast<float*>(mb.y);
  const float* bias = static_cast<const float*>(mb.bias);
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m < M) {
      float val = acc[m];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        val += __shfl_xor_sync(0xFFFFFFFFu, val, off);
      if (lane == m % 32) {
        if (bias != nullptr) val += bias[n];
        y[static_cast<size_t>(m) * N + n] = val;
      }
    }
  }
}

// ---- route 3: fp32, M > 64 --------------------------------------------------

constexpr int FT = 64;  // rows and channels of a tile
constexpr int FK = 16;  // columns a shared-memory step

template <bool COL>
__global__ void __launch_bounds__(256)
    q8_f32_tiled(const __grid_constant__ Params p) {
  __shared__ float xs[FK][FT + 4];
  __shared__ float ws[FK][FT + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const Member mb = member_of(p, blockIdx.y);  // row tiles vary fastest
  const int N = mb.N, K = p.K, M = p.M;
  const int n0 = (blockIdx.y - mb.tile0) * FT, m0 = blockIdx.x * FT;
  const float* x = static_cast<const float*>(p.x);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < FT * FK / 256; ++i) {
      const int e = tid + 256 * i, r = e >> 4, kk = e & 15, k = k0 + kk;
      const int m = m0 + r, n = n0 + r;
      xs[kk][r] = m < M && k < K ? x[static_cast<size_t>(m) * K + k] : 0.f;
      ws[kk][r] = n < N && k < K
                      ? static_cast<float>(mb.q[static_cast<size_t>(n) * K + k]) *
                            mb.scale[COL ? k : n]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* y = static_cast<float*>(mb.y);
  const float* bias = static_cast<const float*>(mb.bias);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N)
        y[static_cast<size_t>(m) * N + n] =
            acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

// ---- host ------------------------------------------------------------------

// One launch of `kernel`, in clusters of `cluster` blocks (none when it
// is one block). The dynamic shared-memory limit is raised once per kernel
// and device.
template <auto kernel>
cudaError_t launch(dim3 grid, int threads, int smem, dim3 cluster,
                   const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    static bool raised[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      raised[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster.x * cluster.y > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MT, bool COL>
cudaError_t small(const Params& p, int tiles, cudaStream_t st) {
  return launch<q8_small<MT, COL>>(dim3(tiles * p.splits), SWARPS * 32,
                                   SmallCfg<MT>::SMEM, dim3(p.splits), p, st);
}

template <bool COL>
cudaError_t dispatch(const Params& p, int route, int rows, int tile,
                     int tiles, cudaStream_t st) {
  switch (route) {
    case 0:
      if (p.M > rows || tile != SmallCfg<1>::BN) return cudaErrorInvalidValue;
      switch (rows) {
        case 8: return small<1, COL>(p, tiles, st);
        case 16: return small<2, COL>(p, tiles, st);
        case 32: return small<4, COL>(p, tiles, st);
        case 64: return small<8, COL>(p, tiles, st);
      }
      return cudaErrorInvalidValue;
    case 1:
    case 4:  // the same kernel past WIDE_ROWS rows, with its own splits
      if (tile != LT) return cudaErrorInvalidValue;
      return launch<q8_large<COL>>(dim3((p.M + LT - 1) / LT, tiles * p.splits),
                                   256, LSMEM, dim3(1, p.splits), p, st);
    case 2: {
      if (tile != 1 || p.splits != 1 || p.M > rows) return cudaErrorInvalidValue;
      const dim3 grid((tiles + FWARPS - 1) / FWARPS);
      if (rows == 4)
        return launch<q8_f32_small<4, COL>>(grid, FWARPS * 32, 0, dim3(), p,
                                            st);
      if (rows == 16)
        return launch<q8_f32_small<16, COL>>(grid, FWARPS * 32, 0, dim3(), p,
                                             st);
      if (rows == 64)
        return launch<q8_f32_small<64, COL>>(grid, FWARPS * 32, 0, dim3(), p,
                                             st);
      return cudaErrorInvalidValue;
    }
    case 3:
      if (tile != FT || p.splits != 1) return cudaErrorInvalidValue;
      return launch<q8_f32_tiled<COL>>(dim3((p.M + FT - 1) / FT, tiles), 256,
                                       0, dim3(), p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One (grouped) product: x [M, K] (bf16 on routes 0, 1, 4; fp32 on 2, 3) times
// each member of `w` (q int8 [n, K], scale fp32 [n] or, with w->col, [K],
// bias [n] in x's dtype or null), written to y: member i's [M, n_i] output,
// contiguous, at y + M (n_0 + .. + n_{i-1}) elements. The plan (route, the
// small routes' row bucket `rows`, channels a tile, splits of the k blocks
// and k blocks a split) is the wrapper's (ops/cuda/q8_linear.py::plan).
// vec: x is 16-byte aligned (w->aligned covers the rest). Returns the
// launch's cudaError_t.
extern "C" int oryx_q8_linear(const OryxQ8Weights* w, const void* x, void* y,
                              int M, int route, int rows, int tile,
                              int splits, int kps, int vec, void* stream) {
  if (w == nullptr || M < 1 || w->count < 1 || w->count > MAXG ||
      w->K < 1 || tile < 1 || kps < 1)
    return cudaErrorInvalidValue;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8)
    return cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.count = w->count;
  p.M = M;
  p.K = w->K;
  p.nkb = (w->K + KB - 1) / KB;
  p.splits = splits;
  p.kps = kps;
  p.vec = vec != 0 && w->aligned != 0;
  if (static_cast<long long>(splits) * kps < p.nkb) return cudaErrorInvalidValue;
  const size_t elt = route == 2 || route == 3 ? 4 : 2;  // fp32 or bf16 y
  int tiles = 0;
  size_t off = 0;
  for (int i = 0; i < w->count; ++i) {
    if (w->n[i] < 1) return cudaErrorInvalidValue;
    p.m[i].q = static_cast<const int8_t*>(w->q[i]);
    p.m[i].scale = static_cast<const float*>(w->scale[i]);
    p.m[i].bias = w->bias[i];
    p.m[i].y = static_cast<char*>(y) + off * elt;
    p.m[i].N = w->n[i];
    p.m[i].tile0 = tiles;
    tiles += (w->n[i] + tile - 1) / tile;
    off += static_cast<size_t>(M) * w->n[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w->col ? dispatch<true>(p, route, rows, tile, tiles, st)
                : dispatch<false>(p, route, rows, tile, tiles, st);
}
