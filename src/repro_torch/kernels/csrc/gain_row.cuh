// The per-row gain recompute shared by sep_gain.cu (the hoisted path's gain
// kernel) and fm_fused.cu (the fused kernel's pass start), so that the two
// FM paths compute their gains with one body.
//
// Row v's pulled weights: pulled0 = sum of vwgt[u] over the slots whose
// neighbour u has part[u] == 1, pulled1 the same over part == 0.  The sum is
// per slot (a duplicate id counts twice); padding slots (-1) are skipped
// wherever they sit in a row, and so is any id outside [0, n), which no valid
// tile holds, so no read leaves the lane's vectors.  Every sum is over
// integer-valued float32 weights, so any order of the adds is exact.
#pragma once

#include <stdint.h>

// Threads that read one row: a power of two, at most 32 and at most d.
__host__ __device__ inline int gain_group(int d) {
  int group = 1;
  while (group < 32 && group * 2 <= d) group *= 2;
  return group;
}

// One group's share of one row.  `row` is the row's slots, or nullptr for a
// group past the last row (it still takes part in the shuffles); `len` is
// how many of them to read: the tile's width d, or the row's extent (1 + its
// last slot that holds an id), past which a row holds only padding.  Groups
// are aligned inside a warp and every thread of the warp calls this
// together.  The group's first thread (threadIdx.x % group == 0) gets the
// row's sums in p0 / p1.  Returns the number of valid slots this thread read.
__device__ __forceinline__ int gain_row(const int* row, int len, int n,
                                        int group, const int8_t* part,
                                        const float* vw, float& p0,
                                        float& p1) {
  float a0 = 0.f, a1 = 0.f;
  int slots = 0;
  if (row != nullptr) {
    for (int j = threadIdx.x % group; j < len; j += group) {
      const int u = row[j];
      if ((unsigned)u >= (unsigned)n) continue;  // padding, or not an id
      ++slots;
      const int p = part[u];
      if (p == 1) a0 += vw[u];
      else if (p == 0) a1 += vw[u];
    }
  }
  for (int off = group / 2; off > 0; off /= 2) {
    a0 += __shfl_down_sync(0xffffffffu, a0, off, group);
    a1 += __shfl_down_sync(0xffffffffu, a1, off, group);
  }
  p0 = a0;
  p1 = a1;
  return slots;
}
