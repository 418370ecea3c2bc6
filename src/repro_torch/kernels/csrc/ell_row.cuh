// The vector path's row reader, shared by ell_spmv.cu and diffusion.cu so
// that the two ELL readers cannot drift: one thread reads a whole row of D
// slots (D % 4 == 0, the row on 16 bytes) with 16-byte loads streamed with
// evict-first loads (__ldcs), so that x keeps L1 and L2, and issues every
// gather of x before its caller sums.  Padding slots (-1) and any id
// outside [0, n) gather 0 and are skipped by the callers' sums, wherever
// they sit in a row, so a malformed tile cannot read outside x.  Also the
// grid of that path: a few waves of the blocks the card holds at once,
// walking the rows with a grid stride.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// A slot's id names a vertex of [0, n).
__device__ __forceinline__ bool valid_id(int u, int n) {
  return (unsigned)u < (unsigned)n;
}

// The row's D ids: D / 4 int4 loads.
template <int D>
__device__ __forceinline__ void load_ids(const int* ids, int (&u)[D]) {
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(ids) + q);
    u[4 * q] = a.x, u[4 * q + 1] = a.y, u[4 * q + 2] = a.z, u[4 * q + 3] = a.w;
  }
}

// A float32 row: its ids, its values (D / 4 float4 loads) and x at every
// id (0 for a slot that holds none).
template <int D>
__device__ __forceinline__ void load_row(const int* ids, const float* vals,
                                         const float* __restrict__ x, int n,
                                         int (&u)[D], float (&v)[D],
                                         float (&xv)[D]) {
  load_ids<D>(ids, u);
#pragma unroll
  for (int q = 0; q < D / 4; ++q) {
    const float4 b = __ldcs(reinterpret_cast<const float4*>(vals) + q);
    v[4 * q] = b.x, v[4 * q + 1] = b.y, v[4 * q + 2] = b.z, v[4 * q + 3] = b.w;
  }
#pragma unroll
  for (int j = 0; j < D; ++j) xv[j] = valid_id(u[j], n) ? __ldg(x + u[j]) : 0.f;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Blocks the card holds at once of `kernel` at `threads` threads a block.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Blocks of a grid-stride pass over `rows` rows, one a thread: `waves`
// waves of the `resident` blocks, and no more than there are rows for.
inline unsigned wave_blocks(int64_t rows, int threads, int waves,
                            int resident) {
  const int64_t need = (rows + threads - 1) / threads;
  const int64_t most = (int64_t)waves * resident;
  return (unsigned)(need < most ? need : most);
}
