// The FM passes' tiebreak noise of every lane, in one launch.
//
// Replaces the plain draw that feeds src/repro/kernels/fm_fused.py:209
// (fm_noise, jax.random outside the TPU kernel, which cannot run it inside
// a Mosaic kernel): per pass, split each lane's key in two, carry the first
// half and draw uniform((2, n)) from the second.  So pass p's subkey is
// split(k_p)[1], with k_0 the lane's key and k_{q+1} = split(k_q)[0], and
// noise[l, p, s, v] = uniform(subkey, s * n + v), bit for bit the draws of
// prng.py (threefry.cuh).
//
// What bounds it on an H100: one threefry2x32 draw (about 100 integer
// operations) and one 4-byte store an entry; at the band bucket's (8, 3, 2,
// 8192) both are well under a microsecond, so the launch is what it costs.
//
// Design: a grid of (entry blocks, L * passes); the block's first thread
// derives its (lane, pass) subkey into shared memory, and every thread then
// draws its entries.  The plain version in torch takes about 70 small
// launches a draw, two draws a pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__global__ void __launch_bounds__(kThreads)
fm_noise_kernel(const int64_t* __restrict__ keys, float* __restrict__ noise,
                int n, int passes) {
  __shared__ Key2x32 sub;
  const int lp = blockIdx.y;  // lane * passes + pass
  const int l = lp / passes, p = lp % passes;
  if (threadIdx.x == 0) {
    Key2x32 k = key_of(keys + 2 * (int64_t)l);
    for (int q = 0; q < p; ++q) k = threefry_split(k, 0u);
    sub = threefry_split(k, 1u);
  }
  __syncthreads();
  const int64_t size = 2LL * n;
  float* out = noise + (int64_t)lp * size;
  const int64_t first = (int64_t)blockIdx.x * kThreads * kPerThread;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int64_t idx = first + (int64_t)r * kThreads + threadIdx.x;
    if (idx < size) out[idx] = threefry_uniform(sub, (uint64_t)idx);
  }
}

}  // namespace

// keys (L, 2) int64 words  ->  noise (L, passes, 2, n) float32.
extern "C" int fm_noise_launch(const void* keys, void* noise, int L, int n,
                               int passes, void* stream) {
  if (L == 0 || n == 0 || passes == 0) return (int)cudaGetLastError();
  const int64_t size = 2LL * n;
  const int64_t per_block = (int64_t)kThreads * kPerThread;
  dim3 grid((unsigned)((size + per_block - 1) / per_block),
            (unsigned)(L * passes));
  fm_noise_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (float*)noise, n, passes);
  return (int)cudaGetLastError();
}
