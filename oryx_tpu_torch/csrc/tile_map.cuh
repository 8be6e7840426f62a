// The flash kernels' per-call cell map, on the card: int8 [B, nqt, nkt] over
// 64 x 64 (q, kv) cells, 0 where no pair of the cell is visible (the kernels
// never load or visit the cell), 2 where every pair is (they skip the
// per-element mask), 1 otherwise. The rules are those of `_tile_flags` in
// ops/cuda/flash_attention.py, which the CPU tests hold against the dense
// mask. One warp per 64-row tile writes its stats (any live, all live,
// position min/max, segment min, the smallest segment above it, segment max
// over the live rows), then one thread per cell reads two. A tile's
// segments lie in {min} and [second, max], so the pad id 0 beside real
// segments does not widen the range to every segment between.
//
// Included by the forward (csrc/flash_attention.cu) and the backward
// (csrc/flash_attention_bwd.cu); each library exports its own entry.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>

namespace tile_map {

constexpr int ROWS = 64;
constexpr int NSTAT = 7;

struct Args {
  const int* q_pos;
  const int* kv_pos;
  const int* q_seg;
  const int* kv_seg;
  const int* kv_valid;
  int B, Tq, Tk, nqt, nkt, causal, has_segments;
};

__global__ void tile_stats(const Args p, int* stats) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, per = p.nqt + p.nkt;
  if (w >= p.B * per) return;
  const int b = w / per, tile = w % per;
  const bool kv = tile >= p.nqt;
  const int T = kv ? p.Tk : p.Tq, row0 = (kv ? tile - p.nqt : tile) * ROWS;
  const int* pos = kv ? p.kv_pos : p.q_pos;
  const int* seg = kv ? p.kv_seg : p.q_seg;
  int any = 0, all = 1, pmin = INT_MAX, pmax = INT_MIN, smin = INT_MAX,
      smax = INT_MIN;
  for (int r = lane; r < ROWS; r += 32) {
    const int row = row0 + r;
    const long long at = (long long)b * T + row;
    if (row < T && (!kv || p.kv_valid[at] > 0)) {
      any = 1;
      pmin = min(pmin, pos[at]);
      pmax = max(pmax, pos[at]);
      smin = min(smin, seg[at]);
      smax = max(smax, seg[at]);
    } else {
      all = 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    any |= __shfl_xor_sync(0xffffffffu, any, off);
    all &= __shfl_xor_sync(0xffffffffu, all, off);
    pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
    pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    smin = min(smin, __shfl_xor_sync(0xffffffffu, smin, off));
    smax = max(smax, __shfl_xor_sync(0xffffffffu, smax, off));
  }
  // The smallest segment above the minimum, over the same rows.
  int smin2 = INT_MAX;
  for (int r = lane; r < ROWS; r += 32) {
    const int row = row0 + r;
    const long long at = (long long)b * T + row;
    if (row < T && (!kv || p.kv_valid[at] > 0) && seg[at] > smin)
      smin2 = min(smin2, seg[at]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    smin2 = min(smin2, __shfl_xor_sync(0xffffffffu, smin2, off));
  if (lane == 0) {
    int* o = stats + (long long)w * NSTAT;
    o[0] = any, o[1] = all, o[2] = pmin, o[3] = pmax, o[4] = smin,
    o[5] = smin2, o[6] = smax;
  }
}

__global__ void tile_flags(const Args p, const int* stats,
                           signed char* flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long cells = (long long)p.nqt * p.nkt;
  if (i >= p.B * cells) return;
  const int b = i / cells, qt = (i % cells) / p.nkt, kt = i % p.nkt;
  const int* qs = stats + ((long long)b * (p.nqt + p.nkt) + qt) * NSTAT;
  const int* ks =
      stats + ((long long)b * (p.nqt + p.nkt) + p.nqt + kt) * NSTAT;
  bool meet = qs[0] && ks[0], full = qs[1] && ks[1];
  if (p.causal) {
    meet = meet && ks[2] <= qs[3];
    full = full && ks[3] <= qs[2];
  }
  if (p.has_segments) {
    // {a} + [a2, A] meets {b} + [b2, B] (an empty interval when a2 > A).
    const int a = qs[4], a2 = qs[5], A = qs[6], b = ks[4], b2 = ks[5],
              B = ks[6];
    meet = meet && (a == b || (a >= b2 && a <= B) || (b >= a2 && b <= A) ||
                    (a2 <= B && b2 <= A && a2 <= A && b2 <= B));
    full = full && a == A && b == B && a == b;
  }
  flags[i] = meet ? (full ? 2 : 1) : 0;
}

// The map of one call into `scratch`: int32 stats of B * (nqt + nkt) tiles,
// 7 each, then the int8 [B, nqt, nkt] map. Two launches; returns the
// cudaError_t of the launches.
inline cudaError_t build(const void* q_pos, const void* kv_pos,
                         const void* q_seg, const void* kv_seg,
                         const void* kv_valid, void* scratch, int B, int Tq,
                         int Tk, int causal, int has_segments,
                         cudaStream_t s) {
  if (B <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  Args a;
  a.q_pos = static_cast<const int*>(q_pos);
  a.kv_pos = static_cast<const int*>(kv_pos);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  a.kv_valid = static_cast<const int*>(kv_valid);
  a.B = B, a.Tq = Tq, a.Tk = Tk;
  a.nqt = (Tq + ROWS - 1) / ROWS, a.nkt = (Tk + ROWS - 1) / ROWS;
  a.causal = causal, a.has_segments = has_segments;
  int* stats = static_cast<int*>(scratch);
  const long long tiles_n = (long long)B * (a.nqt + a.nkt);
  const long long cells = (long long)B * a.nqt * a.nkt;
  tile_stats<<<(tiles_n + 7) / 8, 256, 0, s>>>(a, stats);
  tile_flags<<<(cells + 255) / 256, 256, 0, s>>>(
      a, stats, reinterpret_cast<signed char*>(stats + tiles_n * NSTAT));
  return cudaGetLastError();
}

}  // namespace tile_map
