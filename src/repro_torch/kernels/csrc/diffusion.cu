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
// those bytes moved once.
//
// Design: as ell_spmv.cu, one launch over row blocks with a group of
// min(d, 32) threads per row and shuffle sums of flow and deg; the row's
// own x, its injection and the update are fused into the group's first
// thread, so the step is one pass over the tile.  Steps are separate
// launches into a second buffer (Jacobi: every row reads the previous x).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void diffusion_kernel(const int* __restrict__ nbr,
                                 const float* __restrict__ val,
                                 const float* __restrict__ x,
                                 const float* __restrict__ inj,
                                 float* __restrict__ y, int n, int d,
                                 int group, float dt, float dt_mu) {
  const int sub = threadIdx.x % group;
  const int64_t i =
      (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  float flow = 0.f, deg = 0.f;
  if (i < n) {
    const int64_t row = i * d;
    for (int j = sub; j < d; j += group) {
      const int u = nbr[row + j];
      if ((unsigned)u >= (unsigned)n) continue;  // padding, or not an id
      const float w = val[row + j];
      flow = __fadd_rn(flow, __fmul_rn(w, x[u]));
      deg = __fadd_rn(deg, w);
    }
  }
  for (int off = group / 2; off > 0; off /= 2) {
    flow = __fadd_rn(flow, __shfl_down_sync(0xffffffffu, flow, off, group));
    deg = __fadd_rn(deg, __shfl_down_sync(0xffffffffu, deg, off, group));
  }
  if (i < n && sub == 0) {
    const float xi = x[i];
    const float sgn = (float)((xi > 0.f) - (xi < 0.f));
    const float axpy =
        __fadd_rn(xi, __fmul_rn(dt, __fsub_rn(flow, __fmul_rn(deg, xi))));
    y[i] = __fadd_rn(__fsub_rn(axpy, __fmul_rn(dt_mu, sgn)), inj[i]);
  }
}

}  // namespace

// nbr (n, d) int32, val (n, d), x (n,), inj (n,) float32 -> y (n,) float32.
extern "C" int diffusion_launch(const void* nbr, const void* val,
                                const void* x, const void* inj, void* y,
                                int n, int d, float dt, float dt_mu,
                                void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  int group = 1;  // threads per row: a power of two <= 32
  while (group < 32 && group * 2 <= d) group *= 2;
  const int rows = kThreads / group;
  diffusion_kernel<<<(unsigned)((n + rows - 1) / rows), kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)nbr, (const float*)val, (const float*)x,
      (const float*)inj, (float*)y, n, d, group, dt, dt_mu);
  return (int)cudaGetLastError();
}
