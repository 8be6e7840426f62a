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
// block-table entry as the codes). Each K/V row is dequantized with the
// Pallas body's rounding points, k = k.astype(dq) * scale.astype(dq): in
// bf16 the scale is rounded to bf16 first and the product rounded once more
// to bf16 (one fp32 product code * scale rounded once gives other bits); in
// fp32 one fp32 product. Every int8 and e4m3 code is exact in bf16, so the
// code converts by value (e4m3 by its bits).
//
// What bounds it on an H100: per (row, kv head) the walk reads 2 * len * D
// value bytes and does 4 * G * D flops per visible slot, about 2 * G = 14
// flops a byte at oryx_7b, far below the ~295 flop/byte ridge: it is bound
// by the bytes it reads (on a quantized pool len * D code bytes and len * 4
// scale bytes a plane, about half), and at a decode step's few rows by
// latency: only many blocks in flight, each with loads in flight, reach the
// card's memory rate.
//
// bf16 layout (split-KV, then a merge):
//   * A block takes (row tile, split, kv head). A row tile is consecutive
//     packed rows: one for K3 and for a K4 dispatch of decode rows only;
//     when prefill lanes are packed behind the S decode rows, one for each
//     of those rows (each its own segment) and floor(64 / G) for the lanes
//     behind them. Its
//     rt * G (row, q head) pairs are the A rows of the mma.sync tiles (A row
//     i: packed row r0 + i / G, head hk * G + i % G), so a kv head's pages
//     are streamed once for the G heads and, for the 64 lanes of one
//     prefilling slot, once for the whole tile instead of once a lane.
//   * Split s owns the 64-slot kv tiles [s * tps, (s + 1) * tps) of the
//     table (the plan is host numbers of the table only: its width and
//     rows, Hk, the SM count). The block walks each distinct segment of its
//     row tile once over that range, clipped at the largest visible end
//     among the tile's rows of the segment; every A row keeps its own
//     (m, l, acc), and a slot another segment's row, or a slot past a row's
//     position, contributes p = 0 exactly (not exp(NEG - NEG) = 1 while the
//     row's max is still NEG).
//   * The walk's tiles stream through a three-stage `cp.async` ring, each
//     16-byte chunk fetched from the page the block table names (a 64-slot
//     tile is 4 pages at page_size 16, one at 64; a thread reads all its
//     chunks' table entries before it issues their copies). Dense pages
//     land as bf16 K and V tiles; codes land raw with their per-row scales
//     and are dequantized into one bf16 K/V tile in shared memory. V is
//     read with `ldmatrix.trans` (no transposed copy).
//   * Every warp runs the online softmax of its 16 A rows over all 64 slots
//     of a tile. A row tile's four m16 tiles are the four warps'; one row's
//     m16 tile is shared by the four warps, which split the D columns of
//     P V. A row's arithmetic is the same either way and the plan does not
//     depend on R, so a row's output bits do not depend on the dispatch it
//     is packed in.
//   * Each block writes fp32 partials (m, l, acc) for its split, an empty
//     one (m = NEG, l = 0) where nothing was visible; a second small kernel
//     merges them in split order, o = sum acc_s e^(m_s - m) / sum l_s
//     e^(m_s - m), so the output is the same bits run to run (no atomics).
// fp32 (the tiny test engines): one block per (packed row, kv head), plain
// FMA over 32-slot tiles.
//
// Inputs: q [R, Hq, D] (row stride given, heads and features contiguous);
// k_pages/v_pages [P, page_size, Hk, D] contiguous (codes when quantized,
// with k_scale/v_scale [P, page_size] fp32); block_tables [S, maxp] int32;
// ints [R] int32 (kv_lengths for K3, q_segments and q_positions for K4);
// o [R, Hq, D] contiguous; bf16: fp32 scratch for the partials. The bf16
// route reads q and pages in 16-byte chunks: q's base and row stride, and
// the pools, are 16-byte aligned and D is a multiple of 8 (16 for codes);
// the wrapper checks the pools and D and copies a q that is not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NW = 4;     // warps a block
constexpr int GMAX = 16;  // q heads per kv head
constexpr int AMAX = 64;  // A rows of a row tile: four m16 tiles
constexpr int MAX_SPLITS = 256;  // splits of the table the merge takes

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
  // bf16: fp32 partials, (m, l) [Hk, nrt, splits, ar, 2] then acc
  // [Hk, nrt, splits, ar, D]; `tps` kv tiles a split; `nrt` row tiles:
  // the first `lead` rows one a tile, the rest `rt` a tile; `ar` = rt * G
  // A rows a tile.
  float* part;
  int splits, tps, rt, lead, nrt, ar;
};

// Row tile `tile`: its first packed row and its number of rows.
__device__ __forceinline__ void tile_rows(const Params& p, int tile, int* r0,
                                          int* n) {
  if (tile < p.lead) {
    *r0 = tile;
    *n = 1;
  } else {
    *r0 = p.lead + (tile - p.lead) * p.rt;
    *n = min(p.rt, p.R - *r0);
  }
}

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

// ---------------------------------------------------------------------------
// bf16: split-KV over fixed slot ranges, row tiles sharing one page stream,
// then the merge of the splits.
// ---------------------------------------------------------------------------

constexpr int BK = 64;   // kv slots of a tile
constexpr int NST = 3;   // cp.async ring stages
constexpr int PAD = 8;   // bf16 row padding (elements): conflict-free reads

// Shared memory of the split kernel: the ring of NST stages (dense: the bf16
// K and V tiles; codes: the K and V code tiles and their per-row scales),
// then for codes the dequantized bf16 K and V tile. The q tile is staged in
// the last ring stage (dense) or the dequantized tile (codes), both first
// written after every thread has read its q fragments.
template <int DP, int CODE>
struct SplitSmem {
  static constexpr int SR = DP + PAD;     // bf16 row stride of q, K, V
  static constexpr int TILE = BK * SR * 2;  // bytes of a bf16 K or V tile
  static constexpr int CODES = BK * DP;     // bytes of a code tile
  static constexpr int STAGE =
      CODE == DENSE ? 2 * TILE : 2 * CODES + 2 * BK * 4;
  static constexpr int RING = NST * STAGE;
  static constexpr int BYTES = RING + (CODE == DENSE ? 0 : 2 * TILE);
  static constexpr int Q_AT = CODE == DENSE ? (NST - 1) * STAGE : RING;
  static_assert(AMAX * SR * 2 <= (CODE == DENSE ? STAGE : 2 * TILE),
                "the q tile fits where it is staged");
  static_assert(STAGE % 16 == 0 && TILE % 16 == 0, "16-byte aligned tiles");
};

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

// One ring stage of codes -> the bf16 K and V tiles: each value is
// code * bf16(scale), rounded to bf16 (the product of two bf16 values is
// exact in fp32, so it rounds once).
template <int DP, int CODE>
__device__ __forceinline__ void dequant(const unsigned char* stage,
                                        __nv_bfloat16* kv) {
  using L = SplitSmem<DP, CODE>;
  constexpr int CH = DP / 16;  // 16-code chunks a row
  const float* scales = reinterpret_cast<const float*>(stage + 2 * L::CODES);
  for (int i = threadIdx.x; i < 2 * BK * CH; i += NW * 32) {
    const int plane = i / (BK * CH), j = (i / CH) % BK, c = (i % CH) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        stage + plane * L::CODES + j * DP + c);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    const float sc = __bfloat162float(__float2bfloat16(scales[plane * BK + j]));
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = hopper::pack_bf16(code_value<CODE>(b[2 * e]) * sc,
                               code_value<CODE>(b[2 * e + 1]) * sc);
    uint4* dst = reinterpret_cast<uint4*>(kv + (plane * BK + j) * L::SR + c);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// WM m16 tiles of A rows: WM = 1 (one row, G <= 16 heads) or 4 (a row tile
// of up to 64 A rows). Every warp runs the softmax of its 16 A rows over all
// 64 slots of a tile: with WM = 4 each warp owns one m16 tile and all D
// columns of P V; with WM = 1 the 4 warps share the m16 tile (S and the
// softmax computed alike in each) and split the D columns of P V. A row's
// arithmetic is therefore the same in both layouts, so its output bits do
// not depend on the dispatch it is packed in (the plan does not either).
template <int DP, int CODE, int WM>
__global__ void __launch_bounds__(NW * 32) paged_split(const Params p) {
  using bf = __nv_bfloat16;
  using L = SplitSmem<DP, CODE>;
  constexpr int SR = L::SR;
  // Column groups of P V: 4 with one m16 tile (at DP = 16 one, every warp
  // computing the same and warp 0 storing it).
  constexpr int WN = WM == 1 && DP >= 64 ? NW : 1;
  constexpr int DC = DP / WN;  // P V columns a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sSeg[AMAX], sLen[AMAX], sEnd[AMAX];
  __shared__ int pSeg[AMAX], pT0[AMAX], pEnd[AMAX], pCum[AMAX + 1];
  unsigned char* ring = smem;
  bf* sKV = reinterpret_cast<bf*>(smem + L::RING);  // codes: dequantized
  bf* sQ = reinterpret_cast<bf*>(smem + L::Q_AT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rt = blockIdx.x, split = blockIdx.y, hk = blockIdx.z;
  int r0, nrows;
  tile_rows(p, rt, &r0, &nrows);
  const long long blk = ((long long)hk * p.nrt + rt) * p.splits + split;
  float* pml = p.part + blk * p.ar * 2;
  float* pacc = p.part + (long long)p.Hk * p.nrt * p.splits * p.ar * 2 +
                blk * p.ar * p.D;

  // The tile's rows: segment and visible length (none past R).
  if (tid < p.rt) {
    int seg = -1, len = 0;
    if (tid < nrows) row_extent(p, r0 + tid, &seg, &len);
    sSeg[tid] = seg;
    sLen[tid] = len;
  }
  __syncthreads();
  // A segment's first row with a visible slot opens its pass, which walks
  // to the largest visible end among the segment's rows of the tile.
  if (tid < p.rt) {
    const int seg = sSeg[tid];
    int end = sLen[tid];
    bool first = end > 0;
    for (int j = 0; j < p.rt; ++j) {
      if (sSeg[j] == seg && sLen[j] > 0) {
        first = first && j >= tid;
        end = max(end, sLen[j]);
      }
    }
    sEnd[tid] = first ? end : 0;
  }
  __syncthreads();
  // The passes clipped to this split's tiles [split * tps, + tps), in row
  // order; pCum[i] is the first step of pass i.
  if (tid == 0) {
    int n = 0, cum = 0;
    const int a = split * p.tps;
    for (int i = 0; i < p.rt; ++i) {
      const int end = sEnd[i];
      const int b = min(a + p.tps, (end + BK - 1) / BK);
      if (end == 0 || a >= b) continue;
      pSeg[n] = sSeg[i];
      pT0[n] = a;
      pEnd[n] = end;
      pCum[n] = cum;
      cum += b - a;
      ++n;
    }
    for (int i = n; i <= AMAX; ++i) pCum[i] = cum;
  }
  __syncthreads();
  const int nsteps = pCum[AMAX];
  if (nsteps == 0) {  // nothing visible in this split's range
    for (int i = tid; i < p.ar; i += blockDim.x) {
      pml[2 * i] = NEG;
      pml[2 * i + 1] = 0.f;
    }
    return;
  }

  // Step st of the walk -> ring stage: its pass's segment, clipped at the
  // pass's end (later slots are zero chunks, never read from the pool).
  // Each thread looks up all its chunks' pages first, so the table reads
  // are in flight together, then issues the copies.
  auto load = [&](int st, int stage) {
    int ps = 0;
    while (st >= pCum[ps + 1]) ++ps;
    const int end = pEnd[ps];
    const int s0 = (pT0[ps] + st - pCum[ps]) * BK;
    const int* btr = p.bt + (long long)pSeg[ps] * p.maxp;
    constexpr int E = CODE == DENSE ? 8 : 16;  // elements of a chunk
    constexpr int CH = DP / E;
    constexpr int PER = (BK * CH + NW * 32 - 1) / (NW * 32);
    constexpr int JS = NW * 32 / CH;  // slots between a thread's chunks
    static_assert(NW * 32 % CH == 0, "a thread keeps one column");
    const int c = (tid % CH) * E;
    // Logical page and offset of the thread's first slot, then stepped.
    int pg = (s0 + tid / CH) / p.ps, at = (s0 + tid / CH) % p.ps;
    long long off[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NW * 32, slot = s0 + i / CH;
      off[u] = -1;
      if (i < BK * CH && slot < end && c < p.D) {
        const int page = min(max(__ldg(btr + pg), 0), p.P - 1);
        off[u] = ((long long)page * p.ps + at) * p.Hk * p.D +
                 (long long)hk * p.D + c;
      }
      for (at += JS; at >= p.ps; at -= p.ps) ++pg;
    }
    long long srow = -1;  // codes: this thread's scale row
    if constexpr (CODE != DENSE) {
      const int slot = s0 + tid % BK;
      if (slot < end) {
        const int page = min(max(__ldg(btr + slot / p.ps), 0), p.P - 1);
        srow = (long long)page * p.ps + slot % p.ps;
      }
    }
    unsigned char* base = ring + stage * L::STAGE;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NW * 32;
      if (i >= BK * CH) break;
      const int j = i / CH;
      const bool in = off[u] >= 0;
      const long long o = in ? off[u] : 0;
      if constexpr (CODE == DENSE) {
        bf* sK = reinterpret_cast<bf*>(base);
        hopper::cp_async16(sK + j * SR + c, static_cast<const bf*>(p.k) + o,
                           in ? 16 : 0);
        hopper::cp_async16(sK + BK * SR + j * SR + c,
                           static_cast<const bf*>(p.v) + o, in ? 16 : 0);
      } else {
        hopper::cp_async16(base + j * DP + c,
                           static_cast<const uint8_t*>(p.k) + o, in ? 16 : 0);
        hopper::cp_async16(base + L::CODES + j * DP + c,
                           static_cast<const uint8_t*>(p.v) + o, in ? 16 : 0);
      }
    }
    if constexpr (CODE != DENSE) {  // thread i: K (i < 64) or V scale row
      float* scales = reinterpret_cast<float*>(base + 2 * L::CODES);
      hopper::cp_async4(scales + tid, (tid < BK ? p.ks : p.vs) + max(srow, 0LL),
                        srow >= 0 ? 4 : 0);
    }
  };
  // The q tile, its own cp.async group ahead of the ring's first stages: A
  // row a is head hk G + a % G of packed row r0 + a / G; rows past the
  // tile's (row, head) pairs are zero (q's rows are 16-byte aligned: the
  // wrapper copies any other q).
  constexpr int QR = 16 * WM;
  const bf* qb = static_cast<const bf*>(p.q);
  for (int i = tid; i < QR * DP / 8; i += NW * 32) {
    const int a = i / (DP / 8), c = (i % (DP / 8)) * 8, r = r0 + a / p.G;
    const bool in = a < p.ar && a / p.G < nrows && c < p.D;
    hopper::cp_async16(
        sQ + a * SR + c,
        qb + (in ? r * p.q_sr + (long long)(hk * p.G + a % p.G) * p.D + c : 0),
        in ? 16 : 0);
  }
  hopper::cp_async_commit();
  for (int i = 0; i < NST - 1; ++i) {
    if (i < nsteps) load(i, i);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<NST - 1>();  // the q tile landed
  __syncthreads();
  const int mt = WM == 1 ? 0 : warp;       // the warp's m16 tile
  const int c0 = WN == 1 ? 0 : warp * DC;  // its first P V column
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const bf* q0 = sQ + (16 * mt + g) * SR + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(q0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(q0 + 8 * SR);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(q0 + 8 * SR + 8);
  }
  // This thread's two A rows (g and g + 8 of the m16 tile): segment and
  // visible length of their packed row.
  int rseg[2], rlen[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = 16 * mt + g + 8 * h;
    const bool live = a < p.ar;
    rseg[h] = live ? sSeg[a / p.G] : -1;
    rlen[h] = live ? sLen[a / p.G] : 0;
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[DC / 8][4];
#pragma unroll
  for (int dn = 0; dn < DC / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // ldmatrix.trans row of this lane: matrices (kv 0-7 | 8-15) x (d 0-7 |
  // 8-15) of a 16 x 16 block are the B fragments of two n8 column blocks.
  const int mi = lane >> 3;
  const int vrow = (lane & 7) + 8 * (mi & 1), vcol = c0 + 8 * (mi >> 1);

  int pass = 0;
  for (int st = 0; st < nsteps; ++st) {
    while (st >= pCum[pass + 1]) ++pass;
    const int pseg = pSeg[pass];
    const int s0 = (pT0[pass] + st - pCum[pass]) * BK;
    hopper::cp_async_wait<NST - 2>();
    __syncthreads();  // step st landed; every warp is done with st - 1
    if (st + NST - 1 < nsteps) load(st + NST - 1, (st + NST - 1) % NST);
    hopper::cp_async_commit();
    const bf* sK;
    if constexpr (CODE == DENSE) {
      sK = reinterpret_cast<const bf*>(ring + (st % NST) * L::STAGE);
    } else {
      dequant<DP, CODE>(ring + (st % NST) * L::STAGE, sKV);
      __syncthreads();
      sK = sKV;
    }
    const bf* sV = sK + BK * SR;

    // S = Q K^T: the warp's 16 A rows x the tile's 64 slots.
    float s[BK / 8][4];
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const bf* kp = sK + (nb * 8 + g) * SR + kk * 16 + 2 * t;
        hopper::mma_bf16(s[nb], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                         *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    // A slot is visible to an A row of the pass's segment below the row's
    // length; every other (row, slot) pair has p = 0.
    uint32_t vis = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, slot = s0 + nb * 8 + 2 * t + (e & 1);
        const bool v = rseg[h] == pseg && slot < rlen[h];
        vis |= static_cast<uint32_t>(v) << (nb * 4 + e);
        s[nb][e] = v ? s[nb][e] * p.scale : NEG;
        mx[h] = fmaxf(mx[h], s[nb][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f((m[h] - m_new) * LOG2E);
      m[h] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = (vis >> (nb * 4 + e)) & 1u
                       ? exp2f((s[nb][e] - m[e >> 1]) * LOG2E)
                       : 0.f;
        sum[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];

    // acc += P V over the warp's columns: p (rounded to bf16) is the A
    // operand straight from the S accumulators; V's B fragments come
    // transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             hopper::pack_bf16(s[2 * kk + 1][0],
                                               s[2 * kk + 1][1]),
                             hopper::pack_bf16(s[2 * kk + 1][2],
                                               s[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < DC / 16; ++jj) {
        uint32_t bv[4];
        hopper::ldsm_x4_t(bv, sV + (vrow + 16 * kk) * SR + 16 * jj + vcol);
        hopper::mma_bf16(acc[2 * jj], a, bv[0], bv[1]);
        hopper::mma_bf16(acc[2 * jj + 1], a, bv[2], bv[3]);
      }
    }
  }
  hopper::cp_async_wait<0>();

  // The partials of the warp's rows and columns (at WN = 1 and WM = 1 the
  // warps hold the same values: warp 0 stores them).
  if (WN == 1 && WM == 1 && warp != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int a = 16 * mt + g + 8 * h;
    if (a >= p.ar) continue;
    if (t == 0 && c0 == 0) {
      pml[2 * a] = m[h];
      pml[2 * a + 1] = l[h];
    }
    if (l[h] == 0.f) continue;  // the merge never reads an empty acc
#pragma unroll
    for (int dn = 0; dn < DC / 8; ++dn)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int c = c0 + dn * 8 + 2 * t + (e & 1);
        if (c < p.D) pacc[(long long)a * p.D + c] = acc[dn][e];
      }
  }
}

// One block per (packed row, q head): the splits' partials merged in split
// order, o = sum acc_s e^(m_s - m) / l, l = sum l_s e^(m_s - m), m = max m_s
// over the non-empty partials; zeros where every partial is empty. The
// block gathers the (m, l) pairs, one thread lists the non-empty splits
// with their weights, and every thread sums its columns over that list.
__global__ void __launch_bounds__(128) paged_merge(const Params p) {
  __shared__ float sM[MAX_SPLITS], sL[MAX_SPLITS], sW[MAX_SPLITS];
  __shared__ int sIdx[MAX_SPLITS], sN;
  __shared__ float sLsum;
  const int r = blockIdx.x, h = blockIdx.y;
  const int tile = r < p.lead ? r : p.lead + (r - p.lead) / p.rt;
  const int hk = h / p.G;
  const int a = (r < p.lead ? 0 : (r - p.lead) % p.rt) * p.G + h % p.G;
  const long long base = ((long long)hk * p.nrt + tile) * p.splits;
  const float* ml = p.part + base * p.ar * 2 + 2 * a;
  const float* accp = p.part +
                      (long long)p.Hk * p.nrt * p.splits * p.ar * 2 +
                      base * p.ar * p.D + (long long)a * p.D;
  const long long sml = 2LL * p.ar, sacc = (long long)p.ar * p.D;
  for (int s = threadIdx.x; s < p.splits; s += blockDim.x) {
    sM[s] = ml[s * sml];
    sL[s] = ml[s * sml + 1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = NEG;
    for (int s = 0; s < p.splits; ++s)
      if (sL[s] > 0.f) M = fmaxf(M, sM[s]);
    float Lsum = 0.f;
    int n = 0;
    for (int s = 0; s < p.splits; ++s) {
      if (sL[s] > 0.f) {
        const float w = expf(sM[s] - M);
        Lsum += sL[s] * w;
        sIdx[n] = s;
        sW[n] = w;
        ++n;
      }
    }
    sN = n;
    sLsum = Lsum;
  }
  __syncthreads();
  const int n = sN;
  const float Ld = sLsum == 0.f ? 1.f : sLsum;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) +
                      ((long long)r * p.Hk * p.G + h) * p.D;
  for (int c = threadIdx.x; c < p.D; c += blockDim.x) {
    float A = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) A += accp[sIdx[i] * sacc + c] * sW[i];
    ob[c] = __float2bfloat16(A / Ld);
  }
}

// fp32: merge the NW warps' online-softmax states of the tile's first G rows
// and store o = acc / l. sM/sL: [NW][GMAX]; sAcc: [NW][GMAX][DP].
template <int DP>
__device__ void merge_and_store(const Params& p, int r, int hk,
                                const float* sM, const float* sL,
                                const float* sAcc) {
  float* ob = static_cast<float*>(p.o) + ((long long)r * p.Hk + hk) * p.G * p.D;
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
    ob[g * p.D + c] = A / (L == 0.f ? 1.f : L);
  }
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
  merge_and_store<DP>(p, r, hk, sM, sL, sAcc);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NW * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// bf16: the split kernel over (row tiles, splits, kv heads), then the merge
// over (packed rows, q heads).
template <int DP, int CODE>
cudaError_t launch_split(const Params& p, cudaStream_t s) {
  const dim3 grid(p.nrt, p.splits, p.Hk);
  constexpr int smem = SplitSmem<DP, CODE>::BYTES;
  cudaError_t err = p.rt == 1
                        ? launch(paged_split<DP, CODE, 1>, grid, smem, p, s)
                        : launch(paged_split<DP, CODE, 4>, grid, smem, p, s);
  if (err != cudaSuccess) return err;
  paged_merge<<<dim3(p.R, p.Hk * p.G), 128, 0, s>>>(p);
  return cudaGetLastError();
}

template <int CODE>
cudaError_t dispatch_code(const Params& p, int bf16, cudaStream_t s) {
  if (bf16) {
    if (p.D <= 16) return launch_split<16, CODE>(p, s);
    return launch_split<128, CODE>(p, s);
  }
  const dim3 grid(p.R, p.Hk);
  if (p.D <= 32) return launch(paged_f32<32, CODE>, grid, smem_f32<32>(), p, s);
  return launch(paged_f32<128, CODE>, grid, smem_f32<128>(), p, s);
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
        int code, void* part, int splits, int tps, int rt, int lead,
        void* stream) {
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
  p.part = static_cast<float*>(part);
  p.splits = splits, p.tps = tps, p.rt = rt, p.lead = lead;
  p.nrt = rt > 0 && lead >= 0 && lead <= R ? lead + (R - lead + rt - 1) / rt
                                            : 0;
  p.ar = rt * G;
  // The bf16 plan must cover every 64-slot tile of the table, a row tile
  // at most 64 A rows (one row for the one-row layout), within the grid.
  const long long tiles = ((long long)maxp * ps + BK - 1) / BK;
  if (bf16 && (part == nullptr || splits <= 0 || splits > MAX_SPLITS ||
               tps <= 0 || (long long)splits * tps < tiles || rt <= 0 ||
               lead < 0 || lead > R || (rt == 1 && lead != 0) ||
               p.ar > AMAX || Hk * G > 65535))
    return cudaErrorInvalidValue;
  return dispatch(p, bf16, code, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the cudaError_t of
// the launch (0 on success); nothing is synchronised. `bf16` selects the
// dtype of q and o, and of dense pages (1: bfloat16, 0: float32); `code`
// the page format (0 dense, 1 int8 codes, 2 fp8-e4m3 codes), with the
// per-row scale planes k_scale/v_scale [P, ps] fp32 for codes (else null).
// bf16 takes the split plan: `splits` ranges of `tps` 64-slot tiles, row
// tiles of one row for the first `lead` rows and of `rt` rows after them
// (rt 1, or up to 64 / G with lead >= 0; nrt = lead + ceil((R - lead) /
// rt) tiles), and fp32 scratch `part` of 4 * Hk * nrt * splits * rt * G *
// (2 + D) bytes; fp32 ignores them.
//
// K3: one query row per table row; kv_lengths [R] int32 counts the visible
// slots (the current token included).
extern "C" int oryx_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, void* o, long long q_sr,
                                 const void* block_tables,
                                 const void* kv_lengths, int R, int Hk, int G,
                                 int D, int P, int ps, int maxp, float scale,
                                 int bf16, int code, void* part, int splits,
                                 int tps, int rt, int lead, void* stream) {
  return run(q, k_pages, v_pages, k_scale, v_scale, o, q_sr, block_tables,
             nullptr, kv_lengths, R, Hk, G, D, P, ps, R, maxp, scale, 1, bf16,
             code, part, splits, tps, rt, lead, stream);
}

// K4: R packed rows over S table rows; q_segments/q_positions [R] int32.
extern "C" int oryx_ragged_paged(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scale,
                                 const void* v_scale, void* o, long long q_sr,
                                 const void* block_tables,
                                 const void* q_segments,
                                 const void* q_positions, int R, int Hk,
                                 int G, int D, int P, int ps, int S, int maxp,
                                 float scale, int bf16, int code, void* part,
                                 int splits, int tps, int rt, int lead,
                                 void* stream) {
  return run(q, k_pages, v_pages, k_scale, v_scale, o, q_sr, block_tables,
             q_segments, q_positions, R, Hk, G, D, P, ps, S, maxp, scale, 0,
             bf16, code, part, splits, tps, rt, lead, stream);
}
