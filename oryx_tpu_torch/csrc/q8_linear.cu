// The int8-weight product for NVIDIA Hopper (sm_90a) at the decode shapes:
//   y[M, N] = x[M, K] . deq(q[N, K], scale[N])^T (+ bias[N]),  M <= 64 a
//   launch (the wrapper cuts more rows into launches),
// or, for a tied head (the int8 embedding table [V, H] with one scale per
// column), deq(q[N, K], scale[K]): the scale of column k, not of channel n.
//
// Replaces no Pallas kernel: the JAX package computes this product in XLA,
// which fuses `Q8Weight.astype(dt)` (oryx_tpu/utils/quant.py:68,
// q.astype(dt) * scale.astype(dt)) into the matmul's operand read, so int8
// is what crosses HBM (oryx_tpu/models/qwen2.py:147, :543). Eager PyTorch
// would run the cast, the multiply and the GEMM as three kernels, about 9
// bytes a weight against bf16's 2; this kernel reads the codes directly.
//
// Semantics, kept bit for bit from the plain twin's operand
// (ops/cuda/q8_linear.py::q8_linear_reference):
//   * bf16 x: deq = bf16(bf16(q) * bf16(scale)). Every code is exact in
//     bf16, so one bf16x2 multiply (rounded to nearest even) of the code
//     pair and the scale (a pair of them, per column) gives the twin's
//     weight. The product runs on the tensor cores (mma.sync m16n8k16,
//     fp32 accumulation) and is rounded once to bf16 with the bias (bf16,
//     added in fp32), as cuBLAS does.
//   * fp32 x: deq = float(q) * scale in fp32 and an fp32 FMA sum (no TF32:
//     the fp32 path serves the small fp32 configurations).
//
// What bounds it on an H100: at M <= 64 rows it reads N * K code bytes once
// and does 2 * M * N * K flops, at most 128 flops a byte, below the ~295
// flop/byte bf16 ridge: the bound is the bytes (codes, scales, x and y) over
// 3.35 TB/s. The design streams every code once per launch for all M rows,
// 16 bytes a load with the next k block's loads in flight.
//
// bf16 layout ("swap AB": the weight is the mma's A operand, x its B):
//   * A warp owns NT tiles of 16 output channels; thread (g = lane / 4,
//     t = lane % 4) loads the 16 codes [16 t, 16 t + 16) of a 64-column k
//     block of channels g and g + 8 of each tile (16 bytes each) and the 16
//     x values of the same columns of rows m = g + 8 i (two 16-byte loads).
//     The k slots of the four k16 mmas of the block are a fixed permutation
//     of the block's columns (slot 2 t + e of mma j is column
//     16 t + 4 j + e, slot 2 t + 8 + e column 16 t + 4 j + 2 + e), the same
//     for A and B, so each thread's loads are its fragments as they are.
//   * Rows of x are the mma's n8 columns: MT tiles of 8 rows (MT = M / 8
//     rounded up to 1, 2, 4 or 8); rows past M are zeros and stored
//     nowhere.
//   * Split-K for few output channels: the k blocks are cut into `splits`
//     contiguous ranges (blockIdx.y), each writing fp32 partials; a second
//     launch sums them in split order and adds the bias. The plan is host
//     numbers of N, K and the SM count, never of M.
//   * Per-column scales (the tied head): a thread loads the 16 scales of
//     its columns of the k block (4 K bytes in all, cache-resident) and
//     pairs them as bf16x2, one pair for each code pair.
// fp32 layout (SIMT): a warp owns one output channel, lane l takes its
// 16-code chunks l, l + 32, ..., and a butterfly over the lanes sums each
// row's products.
// Determinism: every output's sum runs over its k blocks (or chunks) in
// order, then the fixed split merge or butterfly; an mma computes each
// output column from its own B column only. Nothing depends on M, the row
// bucket or the other rows' values, so a row gets the same bits at M = 1,
// 4 and 20, and two launches give the same bits. No atomics.
// Tails: K not a multiple of 16 (or an operand not 16-byte aligned) takes
// byte-wise loads with zeros past K, in the same order; channels past N
// read channel N - 1 and store nothing. The launches allocate nothing, run
// on the caller's stream and never synchronize, so they can be captured in
// a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int KB = 64;  // columns of a k block of the bf16 kernel

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

// 16 per-column scales from column k (zeros past K): four 16-byte loads on
// the vector path.
__device__ __forceinline__ void load_scales16(const float* scale, int k,
                                              int K, bool vec, float f[16]) {
  if (vec && k + 16 <= K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(scale + k) + i);
      f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z,
      f[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = k + i < K ? scale[k + i] : 0.f;
}

// ---- bf16: tensor cores ----------------------------------------------------

// 8 bf16 of an x row from column k (zeros past K on the byte path).
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* row, int k,
                                         int K, bool vec) {
  if (vec && k + 8 <= K) return __ldg(reinterpret_cast<const uint4*>(row + k));
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = k + 2 * i < K ? r[k + 2 * i] : 0u;
    const uint32_t b = k + 2 * i + 1 < K ? r[k + 2 * i + 1] : 0u;
    w[i] = a | (b << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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

template <int MT, int NT, bool COL>
__global__ void __launch_bounds__(WARPS * 32)
    q8_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                  int M, int N, int K, int kps, int vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = ((blockIdx.x * WARPS + (threadIdx.x >> 5)) * NT) * 16;
  if (n0 >= N) return;  // the whole warp
  const bool v = vec != 0;
  const int nkb = (K + KB - 1) / KB;
  const int kb0 = blockIdx.y * kps, kb1 = min(nkb, kb0 + kps);

  const int8_t* rows[NT][2];
  __nv_bfloat162 s[NT][2];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = min(n0 + 16 * i + 8 * h + g, N - 1);
      rows[i][h] = q + static_cast<size_t>(n) * K;
      if (!COL) s[i][h] = __bfloat162bfloat162(__float2bfloat16_rn(scale[n]));
    }
  const __nv_bfloat16* xr[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    xr[mt] = x + static_cast<size_t>(min(mt * 8 + g, M - 1)) * K;
  float acc[NT][MT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][mt][e] = 0.f;

  uint4 cur[NT][2];
  if (kb0 < kb1) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cur[i][h] = load_codes(rows[i][h], kb0 * KB + 16 * t, K, v);
  }
  for (int kb = kb0; kb < kb1; ++kb) {
    const int k = kb * KB + 16 * t;
    // The next block's codes go out before this one is consumed.
    uint4 nxt[NT][2];
    if (kb + 1 < kb1) {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          nxt[i][h] = load_codes(rows[i][h], k + KB, K, v);
    }
    // Per-column scales: pairs (k + 2 p, k + 2 p + 1) of this thread's 16
    // columns, as bf16x2.
    __nv_bfloat162 cs[8];
    if (COL) {
      float f[16];
      load_scales16(scale, k, K, v, f);
#pragma unroll
      for (int p = 0; p < 8; ++p)
        cs[p] = __floats2bfloat162_rn(f[2 * p], f[2 * p + 1]);
    }
    uint4 xv[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt * 8 + g < M) {
        xv[mt][0] = load_x8(xr[mt], k, K, v);
        xv[mt][1] = load_x8(xr[mt], k + 8, K, v);
      } else {
        xv[mt][0] = xv[mt][1] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        uint32_t a0, a1, a2, a3;  // (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), ..
        if (COL) {
          deq_bf16(word(cur[i][0], j), cs[2 * j], cs[2 * j + 1], a0, a2);
          deq_bf16(word(cur[i][1], j), cs[2 * j], cs[2 * j + 1], a1, a3);
        } else {
          deq_bf16(word(cur[i][0], j), s[i][0], s[i][0], a0, a2);
          deq_bf16(word(cur[i][1], j), s[i][1], s[i][1], a1, a3);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4& lo = xv[mt][j >> 1];
          const uint32_t b0 = (j & 1) ? lo.z : lo.x;
          const uint32_t b1 = (j & 1) ? lo.w : lo.y;
          mma_bf16(acc[i][mt], a0, a1, a2, a3, b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      cur[i][0] = nxt[i][0];
      cur[i][1] = nxt[i][1];
    }
  }

  // c0, c1: channel g, rows 2t, 2t + 1 of the tile; c2, c3: channel g + 8.
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 16 * i + g + 8 * (e >> 1);
        const int m = mt * 8 + 2 * t + (e & 1);
        if (n >= N || m >= M) continue;
        float val = acc[i][mt][e];
        if (direct) {
          if (bias != nullptr) val += __bfloat162float(bias[n]);
          y[static_cast<size_t>(m) * N + n] = __float2bfloat16_rn(val);
        } else {
          part[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = val;
        }
      }
}

// y = bf16(sum of the splits' partials in split order (+ bias)).
__global__ void q8_merge_kernel(const float* __restrict__ part,
                                const __nv_bfloat16* __restrict__ bias,
                                __nv_bfloat16* __restrict__ y, int M, int N,
                                int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float val = 0.f;
  for (int sp = 0; sp < splits; ++sp) val += part[sp * total + i];
  if (bias != nullptr) val += __bfloat162float(bias[i % N]);
  y[i] = __float2bfloat16_rn(val);
}

template <int MT, int NT, bool COL>
cudaError_t launch_bf16(const void* x, const void* q, const void* scale,
                        const void* bias, void* y, float* part, int M, int N,
                        int K, int splits, int kps, int vec,
                        cudaStream_t stream) {
  const int per_block = WARPS * NT * 16;
  const dim3 grid((N + per_block - 1) / per_block, splits);
  q8_mma_kernel<MT, NT, COL><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(y), part, M, N, K, kps, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(M) * N;
  q8_merge_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                    stream>>>(part, static_cast<const __nv_bfloat16*>(bias),
                              static_cast<__nv_bfloat16*>(y), M, N, splits);
  return cudaGetLastError();
}

template <int NT, bool COL>
cudaError_t bf16_by_rows(const void* x, const void* q, const void* scale,
                         const void* bias, void* y, float* part, int M, int N,
                         int K, int splits, int kps, int vec,
                         cudaStream_t st) {
  if (M <= 8)
    return launch_bf16<1, NT, COL>(x, q, scale, bias, y, part, M, N, K, splits,
                              kps, vec, st);
  if (M <= 16)
    return launch_bf16<2, NT, COL>(x, q, scale, bias, y, part, M, N, K, splits,
                              kps, vec, st);
  if (M <= 32)
    return launch_bf16<4, NT, COL>(x, q, scale, bias, y, part, M, N, K, splits,
                              kps, vec, st);
  return launch_bf16<8, NT, COL>(x, q, scale, bias, y, part, M, N, K, splits, kps,
                            vec, st);
}

// ---- fp32: SIMT ------------------------------------------------------------

template <int MB, bool COL>
__global__ void __launch_bounds__(WARPS * 32)
    q8_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int M, int N, int K, int vec) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;  // the whole warp
  const bool v = vec != 0;
  const int8_t* row = q + static_cast<size_t>(n) * K;
  const float s = COL ? 0.f : scale[n];
  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;

  const int nchunks = (K + 15) / 16;
  for (int c = lane; c < nchunks; c += 32) {
    const int k0 = c * 16;
    const uint4 codes = load_codes(row, k0, K, v);
#pragma unroll
    for (int sub = 0; sub < 4; ++sub) {
      float d[4];
      codes4(word(codes, sub), d);
      const int k = k0 + 4 * sub;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] *= COL ? (k + j < K ? scale[k + j] : 0.f) : s;
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
          for (int j = 0; j < 4; ++j) acc[m] = fmaf(xv[j], d[j], acc[m]);
        }
      }
    }
  }
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

template <int MB, bool COL>
cudaError_t launch_f32(const void* x, const void* q, const void* scale,
                       const void* bias, void* y, int M, int N, int K,
                       int vec, cudaStream_t stream) {
  const int grid = (N + WARPS - 1) / WARPS;
  q8_f32_kernel<MB, COL><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K, vec);
  return cudaGetLastError();
}

template <bool COL>
cudaError_t dispatch(const void* x, const void* q, const void* scale,
                     const void* bias, void* y, float* part, int M, int N,
                     int K, int bf16, int nt, int splits, int kps, int vec,
                     cudaStream_t st) {
  if (bf16) {
    if (nt == 1)
      return bf16_by_rows<1, COL>(x, q, scale, bias, y, part, M, N, K,
                                  splits, kps, vec, st);
    if (nt == 2)
      return bf16_by_rows<2, COL>(x, q, scale, bias, y, part, M, N, K,
                                  splits, kps, vec, st);
    return cudaErrorInvalidValue;
  }
  if (M <= 4)
    return launch_f32<4, COL>(x, q, scale, bias, y, M, N, K, vec, st);
  if (M <= 16)
    return launch_f32<16, COL>(x, q, scale, bias, y, M, N, K, vec, st);
  return launch_f32<64, COL>(x, q, scale, bias, y, M, N, K, vec, st);
}

}  // namespace

// x [M, K] (bf16 when bf16 != 0, else fp32), q int8 [N, K], scale fp32 [N]
// (col == 0) or [K] (col != 0: one scale per column, the tied head), bias
// [N] in x's dtype or null, y [M, N] in x's dtype; all contiguous.
// bf16: nt output-channel tiles of 16 a warp (1 or 2), the k blocks cut
// into `splits` ranges of `kps` blocks, `part` fp32 [splits, M, N] scratch
// when splits > 1. vec: the operands are 16-byte aligned and K a multiple
// of 16. Returns the launches' cudaError_t.
extern "C" int oryx_q8_linear(const void* x, const void* q, const void* scale,
                              const void* bias, void* y, void* part, int M,
                              int N, int K, int bf16, int nt, int splits,
                              int kps, int vec, int col, void* stream) {
  if (M < 1 || M > 64 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (bf16 && (splits < 1 || kps < 1 || (splits > 1 && part == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  return col ? dispatch<true>(x, q, scale, bias, y, p, M, N, K, bf16, nt,
                              splits, kps, vec, st)
             : dispatch<false>(x, q, scale, bias, y, p, M, N, K, bf16, nt,
                               splits, kps, vec, st);
}
