// One fused step of the banded diffusion smoother, float32.
//
// Replaces: src/repro/kernels/diffusion.py:44, diffusion_step
// (_diffusion_kernel), the TPU kernel that fuses the ELL SpMV, the AXPY and
// the evaporation into one VMEM pass over (block_rows, d) tiles with x
// resident.
//
//   y[i] = x[i] + dt * (flow[i] - deg[i] * x[i]) - dt_mu * sign(x[i]) + inj[i]
//
// with flow[i] = sum of val[i, j] * x[nbr[i, j]] and deg[i] = sum of
// val[i, j] over the valid slots, sign(0) = 0, and dt_mu the product dt * mu
// formed by the caller, as the reference forms it (a Python product).
//
// What bounds it on an H100: bytes.  Per slot an id and a value are read
// once, with three operations; per row x, inj and y once.  The least time is
// those bytes moved once: at (10^6, 8) the real slots give 0.0178 ms, and
// the ELL layout's floor (its whole arrays, 76 MB, moved once) 0.0227 ms.
//
// Design: as ell_spmv.cu, the card reaches its memory rate only with enough
// bytes in flight, so the kernel is shaped by bytes per load.
// * The vector path, for d % 4 == 0 and d <= 16 (every shape the repo runs:
//   (4096, 8), (16384, 16), (27000, 8), (10^6, 8)) with nbr and val on 16
//   bytes: one thread reads a whole row with ell_row.cuh's reader (the one
//   ell_spmv.cu uses: int4 ids and float4 values streamed with __ldcs, every
//   x gather issued before the sums), loads its own x[i] and inj[i] first,
//   and sums flow and deg in slot order and writes y[i]: no shuffles.  A
//   grid of a few waves of resident blocks walks the rows with a grid
//   stride.
// * Other widths, or arrays not on 16 bytes, take the group path: a row is
//   read by min(d, 32) neighbouring threads (a power of two) whose partial
//   sums meet in shuffles, and the group's first thread does the update.
//   That is a choice by shape, not a fallback.
// The two paths sum in other orders (the reference's 1e-4 holds).  Padding
// slots (-1) and ids outside [0, n) are skipped wherever they sit.  Steps
// are separate launches into a second buffer (Jacobi: every row reads the
// previous x).
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 4;  // resident-block waves of the vector path's grid

// The update of row i from its flow and degree.
__device__ __forceinline__ float update(float xi, float inj, float flow,
                                        float deg, float dt, float dt_mu) {
  const float sgn = (float)((xi > 0.f) - (xi < 0.f));
  const float axpy =
      __fadd_rn(xi, __fmul_rn(dt, __fsub_rn(flow, __fmul_rn(deg, xi))));
  return __fadd_rn(__fsub_rn(axpy, __fmul_rn(dt_mu, sgn)), inj);
}

__global__ void __launch_bounds__(kThreads)
diffusion_group_kernel(const int* __restrict__ nbr,
                       const float* __restrict__ val,
                       const float* __restrict__ x,
                       const float* __restrict__ inj, float* __restrict__ y,
                       int n, int d, int group, float dt, float dt_mu) {
  const int sub = threadIdx.x % group;
  const int64_t i =
      (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  float flow = 0.f, deg = 0.f;
  if (i < n) {
    const int64_t row = i * d;
    for (int j = sub; j < d; j += group) {
      const int u = nbr[row + j];
      if (!valid_id(u, n)) continue;  // padding, or not an id
      const float w = val[row + j];
      flow = __fadd_rn(flow, __fmul_rn(w, x[u]));
      deg = __fadd_rn(deg, w);
    }
  }
  for (int off = group / 2; off > 0; off /= 2) {
    flow = __fadd_rn(flow, __shfl_down_sync(0xffffffffu, flow, off, group));
    deg = __fadd_rn(deg, __shfl_down_sync(0xffffffffu, deg, off, group));
  }
  if (i < n && sub == 0) y[i] = update(x[i], inj[i], flow, deg, dt, dt_mu);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
diffusion_vector_kernel(const int* __restrict__ nbr,
                        const float* __restrict__ val,
                        const float* __restrict__ x,
                        const float* __restrict__ inj, float* __restrict__ y,
                        int n, float dt, float dt_mu) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float xi = __ldg(x + i), ii = __ldcs(inj + i);
    int u[D];
    float v[D], xv[D];
    load_row<D>(nbr + i * D, val + i * D, x, n, u, v, xv);
    float flow = 0.f, deg = 0.f;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (!valid_id(u[j], n)) continue;
      flow = __fadd_rn(flow, __fmul_rn(v[j], xv[j]));
      deg = __fadd_rn(deg, v[j]);
    }
    y[i] = update(xi, ii, flow, deg, dt, dt_mu);
  }
}

template <int D>
void launch_vector(const int* nbr, const float* val, const float* x,
                   const float* inj, float* y, int n, float dt, float dt_mu,
                   cudaStream_t s) {
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0)
    resident = resident_blocks(diffusion_vector_kernel<D>, kThreads);
  diffusion_vector_kernel<D>
      <<<wave_blocks(n, kThreads, kWaves, resident), kThreads, 0, s>>>(
          nbr, val, x, inj, y, n, dt, dt_mu);
}

// The vector path for one of its widths; false if d is not one of them.
bool try_vector(const int* nbr, const float* val, const float* x,
                const float* inj, float* y, int n, int d, float dt,
                float dt_mu, cudaStream_t s) {
  switch (d) {
    case 4: launch_vector<4>(nbr, val, x, inj, y, n, dt, dt_mu, s); return true;
    case 8: launch_vector<8>(nbr, val, x, inj, y, n, dt, dt_mu, s); return true;
    case 12:
      launch_vector<12>(nbr, val, x, inj, y, n, dt, dt_mu, s);
      return true;
    case 16:
      launch_vector<16>(nbr, val, x, inj, y, n, dt, dt_mu, s);
      return true;
    default: return false;
  }
}

}  // namespace

// nbr (n, d) int32, val (n, d), x (n,), inj (n,) float32 -> y (n,) float32.
extern "C" int diffusion_launch(const void* nbr, const void* val,
                                const void* x, const void* inj, void* y,
                                int n, int d, float dt, float dt_mu,
                                void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int* ids = (const int*)nbr;
  const float* vals = (const float*)val;
  if (aligned16(ids) && aligned16(vals) &&
      try_vector(ids, vals, (const float*)x, (const float*)inj, (float*)y, n,
                 d, dt, dt_mu, s))
    return (int)cudaGetLastError();
  int group = 1;  // threads per row: a power of two <= 32
  while (group < 32 && group * 2 <= d) group *= 2;
  const int rows = kThreads / group;
  diffusion_group_kernel<<<(unsigned)((n + rows - 1) / rows), kThreads, 0,
                           s>>>(ids, vals, (const float*)x,
                                (const float*)inj, (float*)y, n, d, group, dt,
                                dt_mu);
  return (int)cudaGetLastError();
}
