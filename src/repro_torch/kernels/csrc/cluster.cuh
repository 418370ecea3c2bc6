// One launch a call for the lane kernels (matching.cu, bfs_multi.cu):
// each lane runs on a thread-block cluster of C CTAs on neighbouring SMs,
// and its phases are separated by the cluster's hardware barrier, whose
// arrive and wait have release and acquire semantics at cluster scope.  A
// lane of one CTA (C == 1) is launched without a cluster and uses the
// CTA's barrier.
//
// A lane's state (lane_ld / lane_st) lives in the CTA's shared memory when
// the lane has one CTA and the state fits (kShared), since each phase is a
// chain of dependent loads and shared memory answers in tens of cycles
// where L2 takes hundreds.  Otherwise it lives in device memory and goes
// through L2 (__ldcg, __stcg), so that no CTA reads a stale line from its
// own SM's L1.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Threads of a CTA in the cluster designs.
constexpr int kLaneThreads = 1024;
// The most dynamic shared memory a lane's CTA takes: 225 KB of the 227 KB
// a CTA may have on Hopper, leaving room for the kernels' static arrays.
constexpr size_t kMaxLaneSmem = 225 * 1024;

template <bool kShared, typename T>
__device__ __forceinline__ T lane_ld(const T* p) {
  if constexpr (kShared) {
    return *p;
  } else {
    return __ldcg(p);
  }
}

template <bool kShared, typename T>
__device__ __forceinline__ void lane_st(T* p, T v) {
  if constexpr (kShared) {
    *p = v;
  } else {
    __stcg(p, v);
  }
}

// Threads that read one row: a power of two, at most 32, so that each
// thread reads at most 8 slots of a row up to 256 wide.  A CTA holds few
// threads for a lane, so a thread takes several slots of a row, whose
// loads are in flight together, rather than one.
__host__ __device__ inline int lane_group(int d) {
  int group = 1;
  while (group < 32 && group * 8 < d) group *= 2;
  return group;
}

// Slots 4c .. 4c + 3 of a row of d, `pad` past its end: one 16-byte load
// when `vec` (the row 16-byte aligned, d % 4 == 0), else four.
__device__ __forceinline__ int4 load4(const int* __restrict__ row, int c,
                                      int d, bool vec, int pad) {
  if (vec) return __ldg(reinterpret_cast<const int4*>(row) + c);
  const int j = 4 * c;
  return make_int4(j < d ? row[j] : pad, j + 1 < d ? row[j + 1] : pad,
                   j + 2 < d ? row[j + 2] : pad, j + 3 < d ? row[j + 3] : pad);
}

// Whether rows of d slots at `a` (and `b`) can be read in 16-byte loads.
inline bool rows_vec(const void* a, const void* b, int d) {
  return d % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

// The barrier between two phases of a lane.
__device__ __forceinline__ void lane_sync(int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cooperative_groups::this_cluster().sync();
  }
}

// The rows [lo, hi) of an n-row lane that CTA `rank` of C takes.
__device__ __forceinline__ void lane_rows(int n, int C, int rank, int& lo,
                                          int& hi) {
  const int chunk = (n + C - 1) / C;
  lo = min(n, rank * chunk);
  hi = min(n, lo + chunk);
}

// Launch `kernel` over L lanes of C CTAs each (grid L * C, cluster C),
// with `smem` bytes of dynamic shared memory a CTA: lane = blockIdx.x / C,
// rank in the cluster = blockIdx.x % C.  Clusters of more than 8 CTAs are
// allowed explicitly (non-portable sizes, up to 16 on Hopper).
template <typename... Params, typename... Args>
cudaError_t launch_lanes(void (*kernel)(Params...), int L, int C,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaSuccess;
  if (C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)L * (unsigned)C);
  cfg.blockDim = dim3(kLaneThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}
