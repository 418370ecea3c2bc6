// Band distance sweep over a bucket of ELL graphs (Jacobi min-plus BFS).
//
// Replaces: src/repro/kernels/band_batch.py, bfs_multi (_bfs_kernel), the
// TPU kernel that keeps one graph's (n, d) ELL tile and distance vector
// resident in VMEM and runs all `width` relaxations in one grid step.
//
// What bounds it on an H100: bytes.  Each relaxation reads the whole ELL
// tile (L*n*d int32) and does one compare per slot, so the work is a
// stream over device memory; the least time is the tile read once.
//
// The step is Jacobi: an in-place (Gauss-Seidel) update would propagate
// several hops per step and give finite distances past `width`, where the
// reference leaves UNREACH.  So each step reads the previous step's
// distances and writes the next (ping-pong buffers in device memory).  A
// row is read by a group of neighbouring threads, whose minimum is taken
// with shuffles: min(d, 32) threads in the grid design, so that slot reads
// are coalesced, and in the cluster design as many as give each thread at
// most 8 slots (lane_group), read 4 at a time with their distances loaded
// together, since a cluster has few threads for a lane and the dependent
// loads set a step's time.  Padding slots (-1) are skipped wherever they
// sit in the row.
//
// Two designs, chosen by the lane's size in kernels/band_batch.py
// (`lane_plan`):
//
// cluster (one launch a call): one thread-block cluster of C CTAs a lane
// (cluster.cuh); the start and the `width` steps run as phases a lane
// barrier apart, `width` barriers in all.
//
// grid (width + 1 launches): one launch per step over a grid of (row
// blocks, L), for lanes larger than a cluster can take, where the launches
// cost little beside the work and the whole card is used.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "gain_row.cuh"  // gain_group: threads a row, min(d, 32)

namespace {

constexpr int kUnreach = 1 << 30;
constexpr int kThreads = 256;  // the grid design's block

__global__ void bfs_init(const int* __restrict__ src, int* __restrict__ dist,
                         int64_t total) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) dist[i] = src[i] != 0 ? 0 : kUnreach;
}

// One relaxation: out[l, v] = min(in[l, v], min over valid slots of in[l, u] + 1).
__global__ void bfs_relax(const int* __restrict__ nbr,
                          const int* __restrict__ din, int* __restrict__ dout,
                          int n, int d, int group) {
  const int lane = blockIdx.y;
  const int sub = threadIdx.x % group;               // position in the row group
  const int64_t v = (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const int* dl = din + (int64_t)lane * n;
  int best = kUnreach;
  if (v < n) {
    const int* row = nbr + ((int64_t)lane * n + v) * d;
    for (int j = sub; j < d; j += group) {
      int u = row[j];
      if (u >= 0) best = min(best, dl[u]);
    }
  }
  // groups are aligned inside a warp: reduce over `group` neighbouring lanes
  for (int off = group / 2; off > 0; off /= 2)
    best = min(best, __shfl_down_sync(0xffffffffu, best, off, group));
  if (v < n && sub == 0) {
    int cur = dl[v];
    dout[(int64_t)lane * n + v] = min(cur, best + 1);
  }
}


// The cluster design: one lane a cluster (grid L * C, lane blockIdx.x / C).
// The two distance buffers are (dist, scratch) in device memory; or, with
// kShared (C == 1), two (n,) buffers in the CTA's shared memory, and the
// last step writes dist.
template <bool kShared>
__global__ void __launch_bounds__(kLaneThreads, 1)
    bfs_lanes(const int* __restrict__ nbr, const int* __restrict__ src,
              int* dist, int* scratch, int n, int d, int group, bool vec,
              int width, int C) {
  extern __shared__ __align__(16) int lane_dist[];
  const int lane = blockIdx.x / C;
  int lo, hi;
  lane_rows(n, C, blockIdx.x % C, lo, hi);
  const int64_t base = (int64_t)lane * n;
  int* out = dist + base;
  // the ping-pong pair; a step reads one and writes the other, and with
  // start = width % 2 the last step of the device-memory pair lands in dist
  int* a;
  int* b;
  if constexpr (kShared) {
    a = lane_dist;
    b = lane_dist + n;
  } else {
    const int start = width % 2;
    a = start ? scratch + base : out;
    b = start ? out : scratch + base;
  }
  int* first = (kShared && width == 0) ? out : a;
  for (int v = lo + threadIdx.x; v < hi; v += blockDim.x)
    lane_st<kShared>(first + v, src[base + v] != 0 ? 0 : kUnreach);
  const int rows = blockDim.x / group;
  const int sub = threadIdx.x % group;
  for (int k = 0; k < width; ++k) {
    lane_sync(C);
    const int* din = k % 2 == 0 ? a : b;
    int* dout = (kShared && k == width - 1) ? out : (k % 2 == 0 ? b : a);
    for (int v0 = lo; v0 < hi; v0 += rows) {
      const int v = v0 + threadIdx.x / group;
      int best = kUnreach;
      const int* row = nbr + (base + v) * d;
      for (int c = sub; v < hi && 4 * c < d; c += group) {
        const int4 q = load4(row, c, d, vec, -1);
        const int ids[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ids[e] >= 0) best = min(best, lane_ld<kShared>(din + ids[e]));
      }
      for (int off = group / 2; off > 0; off /= 2)
        best = min(best, __shfl_down_sync(0xffffffffu, best, off, group));
      if (v < hi && sub == 0)  // a plain store reaches dist, too
        lane_st<kShared>(dout + v, min(lane_ld<kShared>(din + v), best + 1));
    }
  }
}

}  // namespace

// dist (L, n) <- distances from src within `width` hops, UNREACH beyond.
// scratch is a second (L, n) int32 buffer for the ping-pong.

// The grid design: width + 1 launches.
extern "C" int bfs_multi_launch(const void* nbr, const void* src, void* dist,
                                void* scratch, int L, int n, int d, int width,
                                void* stream) {
  if (L == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* bufs[2] = {(int*)dist, (int*)scratch};
  const int start = width % 2;        // the last step lands in `dist`
  const int64_t total = (int64_t)L * n;
  bfs_init<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const int*)src, bufs[start], total);
  const int group = gain_group(d);
  dim3 grid((unsigned)((n + kThreads / group - 1) / (kThreads / group)),
            (unsigned)L);
  for (int k = 0; k < width; ++k) {
    bfs_relax<<<grid, kThreads, 0, s>>>((const int*)nbr, bufs[(start + k) % 2],
                                        bufs[(start + k + 1) % 2], n, d, group);
  }
  return (int)cudaGetLastError();
}

// The cluster design: one launch, one cluster of C CTAs (1-16) a lane.
extern "C" int bfs_cluster_launch(const void* nbr, const void* src,
                                  void* dist, void* scratch, int L, int n,
                                  int d, int width, int C, void* stream) {
  if (L == 0 || n == 0) return (int)cudaGetLastError();
  // a lane of one CTA keeps its two buffers in shared memory where they fit
  const size_t smem = 8 * (size_t)n;
  const bool shared = C == 1 && smem <= kMaxLaneSmem;
  const cudaError_t err = launch_lanes(
      shared ? bfs_lanes<true> : bfs_lanes<false>, L, C, shared ? smem : 0,
      (cudaStream_t)stream, (const int*)nbr, (const int*)src, (int*)dist,
      (int*)scratch, n, d, lane_group(d), rows_vec(nbr, nbr, d), width, C);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
