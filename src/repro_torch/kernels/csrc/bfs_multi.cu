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
// Design: one launch per relaxation step over a grid of (row blocks, L),
// reading the previous step's distances and writing the next (ping-pong
// buffers in device memory).  There is no shared-memory limit on n, and
// the card fills even for one lane.  The step is Jacobi: an in-place
// (Gauss-Seidel) update would propagate several hops per step and give
// finite distances past `width`, where the reference leaves UNREACH.
// A row is read by a group of min(d, 32) neighbouring threads, so slot
// reads are coalesced; the group's minimum is taken with shuffles.
// Padding slots (-1) are skipped wherever they sit in the row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnreach = 1 << 30;
constexpr int kThreads = 256;

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

}  // namespace

// dist (L, n) <- distances from src within `width` hops, UNREACH beyond.
// scratch is a second (L, n) int32 buffer for the ping-pong.
extern "C" int bfs_multi_launch(const void* nbr, const void* src, void* dist,
                                void* scratch, int L, int n, int d, int width,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int* bufs[2] = {(int*)dist, (int*)scratch};
  const int start = width % 2;        // the last step lands in `dist`
  const int64_t total = (int64_t)L * n;
  bfs_init<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const int*)src, bufs[start], total);
  int group = 1;                      // threads per row: a power of two <= 32
  while (group < 32 && group * 2 <= d) group *= 2;
  dim3 grid((unsigned)((n + kThreads / group - 1) / (kThreads / group)),
            (unsigned)L);
  for (int k = 0; k < width; ++k) {
    bfs_relax<<<grid, kThreads, 0, s>>>((const int*)nbr, bufs[(start + k) % 2],
                                        bufs[(start + k + 1) % 2], n, d, group);
  }
  return (int)cudaGetLastError();
}
