// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tile loads, wgmma shared-memory descriptors and the bf16 wgmma
// instructions, and the host-side tensor-map encoder.
//
// Shared-memory tiles follow one layout, the one TMA writes and wgmma reads:
// a [rows][width] bf16 tile is cut into column sub-tiles of 64 (128-byte
// rows, 128-byte swizzle) and at most one tail of 16 columns (32-byte rows,
// 32-byte swizzle), each sub-tile [rows][64] or [rows][16] dense and
// 1024-byte aligned. Such a sub-tile is read
//   * K-major (rows are the M or N dim, columns the K dim): one k16 step is
//     32 bytes of every row, so the descriptor starts 32 bytes further per
//     step inside a 128-byte row (the swizzle is a function of the address
//     bits, so the hardware finds the step's chunks);
//   * MN-major (rows are the K dim, columns N): one k16 step is 16 rows, so
//     the descriptor starts 16 rows further per step.
// Every instruction below reads at most one sub-tile along N (n64 or n16),
// so the descriptor's leading and stride byte offsets are both the 8-row
// group stride (1024 or 256 bytes): the other field's stride is never used.
//
// The tensor map is encoded through the driver entry point that the runtime
// hands out (cudaGetDriverEntryPoint), so the library needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed. A wait that has
// not completed after ~2^35 cycles (~20 s) traps: a fault in the protocol
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1LL << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

constexpr int SW128 = 1;  // descriptor layout types
constexpr int SW32 = 3;

// Descriptor of a swizzled sub-tile starting at shared address `addr`;
// `group` is the 8-row group stride in bytes (1024 for SW128, 256 for SW32).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t group,
                                         int layout) {
  const uint64_t g = (group >> 4) & 0x3FFF;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (g << 16) |
         (g << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// All but the most recently committed group complete.
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma boundaries.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HOPPER_D8(o)                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// D[64 x 64] (+)= A . B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A . B, A (bf16 pairs, the m64k16 A fragment) from
// registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 16] += A . B as wgmma_rs_n64.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n"
      "}\n"
      : HOPPER_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mma.sync and cp.async (the split-KV decode bodies) --------------------

// c += a b, one m16n8k16 bf16 tile with fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, of which the first `bytes` are copied and the
// rest zero-filled (0: a zero chunk; `src` is then never read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared (0: a zero word; `src` is then never read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8 i .. 8 i
// + 7 give the row addresses of matrix i, register i receives it.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The m64k16 A fragment of k-chunk `kk` (columns 16 kk .. 16 kk + 15) of an
// m64n64 fp32 accumulator, rounded to bf16: the accumulator's n8 blocks
// 2 kk and 2 kk + 1 are the A fragment's two column halves.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&d)[32], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---- tiles -----------------------------------------------------------------
// A [ROWS][width] bf16 tile in the layout above, loaded by TMA boxes and
// multiplied by wgmma a warpgroup at a time (the flash forward and the
// backward kernels share these).

// Bytes of a [ROWS][64 NS + 16 TL] tile: NS sub-tiles of 64 columns, then
// TL tails of 16.
template <int NS, int TL, int ROWS>
struct Tile {
  static constexpr int MAIN = ROWS * 128;
  static constexpr int BYTES = NS * MAIN + TL * ROWS * 32;
};

template <int NS, int TL, int ROWS>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* main,
                                          const CUtensorMap* tail,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
    tma_load_4d(dst + j * Tile<NS, TL, ROWS>::MAIN, main, bar,
                        64 * j, row0, h, b);
  if (TL)
    tma_load_4d(dst + NS * Tile<NS, TL, ROWS>::MAIN, tail, bar,
                        64 * NS, row0, h, b);
}

// d[64 x 64] = A . B^T over the full width, A = rows a0.. of a tile of
// `arows` rows at shared address `a`, B = rows b0.. of a tile of `brows`
// rows at `b`: both K-major. Issues the wgmmas; the caller fences, commits
// and waits.
template <int NS, int TL>
__device__ __forceinline__ void mma_rows(float (&d)[32], uint32_t a,
                                         int arows, int a0, uint32_t b,
                                         int brows, int b0) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(
          d,
          desc(a + j * arows * 128 + a0 * 128 + 32 * kk, 1024,
                       SW128),
          desc(b + j * brows * 128 + b0 * 128 + 32 * kk, 1024,
                       SW128),
          j | kk);
  if (TL)
    wgmma_ss_n64(
        d, desc(a + NS * arows * 128 + a0 * 32, 256, SW32),
        desc(b + NS * brows * 128 + b0 * 32, 256, SW32), NS);
}

// acc[64 x width] += X . Y, X [64 x 64] given as four m64k16 A fragments,
// Y = rows y0 .. y0 + 63 of a tile of `yrows` rows at `y`, read MN-major.
template <int NS, int TL>
__device__ __forceinline__ void mma_acc(float (&am)[NS > 0 ? NS : 1][32],
                                        float (&at)[8],
                                        const uint32_t (&x)[4][4], uint32_t y,
                                        int yrows, int y0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      wgmma_rs_n64(
          am[j], x[kk],
          desc(y + j * yrows * 128 + (y0 + 16 * kk) * 128, 1024,
                       SW128));
    if (TL)
      wgmma_rs_n16(
          at, x[kk],
          desc(y + NS * yrows * 128 + (y0 + 16 * kk) * 32, 256,
                       SW32));
  }
}

template <int NS, int TL>
__device__ __forceinline__ void fence_acc(float (&am)[NS > 0 ? NS : 1][32],
                                          float (&at)[8]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) fence_regs(am[j]);
  if (TL) fence_regs(at);
}

__device__ __forceinline__ void store2(__nv_bfloat16* row, int c, float x,
                                       float y, int D) {
  if (c + 1 < D && (D & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else {
    if (c < D) row[c] = __float2bfloat16(x);
    if (c + 1 < D) row[c + 1] = __float2bfloat16(y);
  }
}

// Store a warpgroup's [64 x width] accumulator: this thread's rows r0 and
// r0 + 8 (when < T) of a [T, D] slab with row stride `rs`.
template <int NS, int TL>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, long long rs,
                                          float (&am)[NS > 0 ? NS : 1][32],
                                          float (&at)[8], int r0, int T,
                                          int D, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= T) continue;
    __nv_bfloat16* o = out + row * rs;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(o, 64 * j + 8 * n + 2 * t, am[j][4 * n + 2 * i],
               am[j][4 * n + 2 * i + 1], D);
    if (TL)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        store2(o, 64 * NS + 8 * n + 2 * t, at[4 * n + 2 * i],
               at[4 * n + 2 * i + 1], D);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}


// ---- host: tensor maps -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map over the [B, H, T, D] view at `base` (element strides
// sb, sh, st; the feature dim contiguous), boxes of `cols` x `rows` (one
// head, one batch row). `cols` is 64 (128-byte swizzle) or 16 (32-byte
// swizzle). Coordinates past D or T read as zero. Returns false when the
// layout is one TMA cannot take (a stride that is not a multiple of 16
// bytes, a misaligned base).
inline bool make_map(CUtensorMap* map, const void* base, long long sb,
                     long long sh, long long st, int B, int H, int T, int D,
                     int cols, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const long long ext[3] = {T, H, B};
  long long str[3] = {st * 2, sh * 2, sb * 2};
  // A dim of extent 1 is only ever read at coordinate 0: give it a stride
  // past everything else, so its (free) stride can never be misaligned.
  long long span = 16LL * ((D * 2 + 15) / 16);
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && str[i] * ext[i] > span) span = str[i] * ext[i];
  span = 16LL * ((span + 15) / 16);
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) str[i] = span;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)str[0], (cuuint64_t)str[1],
                           (cuuint64_t)str[2]};
  cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  cuuint32_t es[4] = {1, 1, 1, 1};
  const CUresult r =
      enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
          dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
          cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

}  // namespace hopper
