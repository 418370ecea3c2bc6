// Separator FM gains (pulled weights) over a bucket of FM lanes.
//
// Replaces: src/repro/kernels/band_batch.py:88, sep_gain_multi (_gain_kernel),
// the TPU kernel that keeps one lane's part and vwgt vectors resident in VMEM
// and gathers them for a block of ELL rows per grid step.
//
// pulled0[l, v] = sum of vwgt[l, u] over the slots of row v whose neighbour u
// has part[l, u] == 1; pulled1 the same over part == 0.  The sum is per slot
// (a duplicate id counts twice) and -1 slots are skipped.
//
// What bounds it on an H100: bytes.  Each real slot is one id read and one
// compare-and-add; the ids dominate the traffic (4 bytes a slot against 1 of
// part and 4 of vwgt, which are gathered from L2 for most graphs).  The least
// time is the tile's real ids once per tile plus each lane's part, vwgt and
// outputs once.
//
// Design: one launch over a grid of (row blocks, L).  Lanes name their ELL
// tile through `lane_work`, so a work's lanes share one tile and no lane
// copies it.  A row is read by a group of neighbouring threads (a power of
// two, at most 32), so slot reads are coalesced; the group's partial sums
// are combined with shuffles.  The row body is `gain_row` (gain_row.cuh),
// which the fused FM kernel calls too: padding slots and ids outside
// [0, n) are skipped, and every sum is over integer-valued float32 weights,
// so any order of the adds gives the reference's value exactly.  n is taken
// unpadded.
//
// Row extents: a tile's width d is its widest row's, and in a band tile the
// two anchors (degree 900 on grid3d(30^3)) make d = 1024 while the other
// rows hold about 6 ids.  So the kernel takes `row_len` (W, n), 1 + the last
// slot of each row that holds an id, and a group reads only its row's
// extent; the caller picks the group width from the mean extent, computed
// on the host where the extents are made (most band rows fit one 32-byte
// sector; the anchors loop), so each lane reads about the real ids instead
// of n * d slots.  A row longer than kLongLoops loops of its group (an
// anchor) is left to the whole block after the group pass: each warp sums
// a contiguous share of it with gain_row, and the warps' sums meet in
// shared memory (exact in any order, as above).  An extent outside [0, d]
// is clamped and a lane_work outside [0, W) reads as an empty tile, so no
// read leaves the tiles; the wrapper does not read them back to check.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gain_row.cuh"

namespace {

constexpr int kThreads = 256;
// A row longer than this many loops of its group is left to the whole
// block after the group pass.
constexpr int kLongLoops = 4;

__global__ void sep_gain_kernel(const int* __restrict__ nbr,
                                const int* __restrict__ lane_work,
                                const int* __restrict__ row_len,
                                const float* __restrict__ vwgt,
                                const int8_t* __restrict__ part,
                                float* __restrict__ pulled0,
                                float* __restrict__ pulled1, int W, int n,
                                int d, int group) {
  __shared__ int long_rows[kThreads];
  __shared__ int n_long;
  __shared__ float block_sum[2];
  const int lane = blockIdx.y;
  const int work = lane_work[lane];
  const bool has_tile = (unsigned)work < (unsigned)W;
  const int64_t tile = has_tile ? (int64_t)work * n : 0;
  const int8_t* pt = part + (int64_t)lane * n;
  const float* vw = vwgt + (int64_t)lane * n;
  float* out0 = pulled0 + (int64_t)lane * n;
  float* out1 = pulled1 + (int64_t)lane * n;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int64_t v =
      (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const int* row = nullptr;
  int len = 0;
  if (v < n) {
    row = nbr + (tile + v) * d;
    len = has_tile ? min(max(row_len[tile + v], 0), d) : 0;
    if (len > kLongLoops * group) {
      if (threadIdx.x % group == 0) long_rows[atomicAdd(&n_long, 1)] = (int)v;
      row = nullptr;  // deferred to the block
    }
  }
  float a0, a1;
  gain_row(row, len, n, group, pt, vw, a0, a1);
  if (row != nullptr && threadIdx.x % group == 0) {
    out0[v] = a0;
    out1[v] = a1;
  }
  // the block's long rows (a band's anchors), each read by all its warps:
  // warp w sums a contiguous share of the row with gain_row
  __syncthreads();
  const int warps = kThreads / 32;
  const int w = threadIdx.x / 32;
  for (int i = 0; i < n_long; ++i) {
    const int u = long_rows[i];
    const int extent = min(max(row_len[tile + u], 0), d);
    const int share = (extent + warps - 1) / warps;
    const int first = min(w * share, extent);
    if (threadIdx.x < 2) block_sum[threadIdx.x] = 0.f;
    __syncthreads();
    gain_row(nbr + (tile + u) * d + first, min(share, extent - first), n, 32,
             pt, vw, a0, a1);
    if (threadIdx.x % 32 == 0) {
      atomicAdd(&block_sum[0], a0);
      atomicAdd(&block_sum[1], a1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      out0[u] = block_sum[0];
      out1[u] = block_sum[1];
    }
    __syncthreads();
  }
}

}  // namespace

// nbr (W, n, d) int32 tiles, lane_work (L,) int32, row_len (W, n) int32,
// vwgt (L, n) float32, part (L, n) int8  ->  pulled0, pulled1 (L, n)
// float32.  W: tiles; group: threads a row, a power of two <= 32.
extern "C" int sep_gain_launch(const void* nbr, const void* lane_work,
                               const void* row_len, const void* vwgt,
                               const void* part, void* pulled0,
                               void* pulled1, int L, int W, int n, int d,
                               int group, void* stream) {
  if (L == 0 || n == 0) return (int)cudaGetLastError();
  if (group <= 0 || group > 32 || (group & (group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int rows = kThreads / group;
  dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)L);
  sep_gain_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)nbr, (const int*)lane_work, (const int*)row_len,
      (const float*)vwgt, (const int8_t*)part, (float*)pulled0,
      (float*)pulled1, W, n, d, group);
  return (int)cudaGetLastError();
}
