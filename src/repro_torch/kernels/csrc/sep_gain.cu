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
// copies it.  A row is read by a group of min(d, 32) neighbouring threads
// (a power of two), so slot reads are coalesced; the group's partial sums
// are combined with shuffles.  The row body is `gain_row` (gain_row.cuh),
// which the fused FM kernel calls too: padding slots and ids outside
// [0, n) are skipped, and every sum is over integer-valued float32 weights,
// so any order of the adds gives the reference's value exactly.  n is taken
// unpadded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gain_row.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void sep_gain_kernel(const int* __restrict__ nbr,
                                const int* __restrict__ lane_work,
                                const float* __restrict__ vwgt,
                                const int8_t* __restrict__ part,
                                float* __restrict__ pulled0,
                                float* __restrict__ pulled1, int n, int d,
                                int group) {
  const int lane = blockIdx.y;
  const int64_t v =
      (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const int* row =
      v < n ? nbr + ((int64_t)lane_work[lane] * n + v) * d : nullptr;
  float a0, a1;
  gain_row(row, d, n, group, part + (int64_t)lane * n,
           vwgt + (int64_t)lane * n, a0, a1);
  if (v < n && threadIdx.x % group == 0) {
    pulled0[(int64_t)lane * n + v] = a0;
    pulled1[(int64_t)lane * n + v] = a1;
  }
}

}  // namespace

// nbr (W, n, d) int32 tiles, lane_work (L,) int32, vwgt (L, n) float32,
// part (L, n) int8  ->  pulled0, pulled1 (L, n) float32.
extern "C" int sep_gain_launch(const void* nbr, const void* lane_work,
                               const void* vwgt, const void* part,
                               void* pulled0, void* pulled1, int L, int n,
                               int d, void* stream) {
  if (L == 0 || n == 0) return (int)cudaGetLastError();
  const int group = gain_group(d);
  const int rows = kThreads / group;
  dim3 grid((unsigned)((n + rows - 1) / rows), (unsigned)L);
  sep_gain_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)nbr, (const int*)lane_work, (const float*)vwgt,
      (const int8_t*)part, (float*)pulled0, (float*)pulled1, n, d, group);
  return (int)cudaGetLastError();
}
