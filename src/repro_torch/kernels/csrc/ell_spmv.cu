// ELL sparse matrix-vector product, float32 or bfloat16.
//
// Replaces: src/repro/kernels/ell_spmv.py:36, ell_spmv (_spmv_kernel), the
// TPU kernel that streams (block_rows, d) tiles of ids and values through
// VMEM with the whole vector x resident there.
//
// y[i] = sum over the valid slots j of val[i, j] * x[nbr[i, j]], summed in
// float32 and written in x's type.  In bfloat16 the product is rounded to
// bfloat16 before it is summed, as the reference forms `val * xv` in the
// input type and casts afterwards.
//
// What bounds it on an H100: bytes.  Each slot is a 4-byte id and a value
// read once, one multiply and one add; x is gathered (from L2 for graphs
// whose x fits in its 50 MB).  The ELL layout's floor is its whole arrays
// moved once: at (10^6, 8) float32, 32 MB of ids, 32 MB of values, x and y,
// 72 MB over 3.35 TB/s = 0.0215 ms; the bound that counts only the real
// slots (0.01657 ms on grid3d(100^3)) is below what any ELL reader can
// reach, since padding slots sit inside the rows.
//
// Design: the card reaches its memory rate only with enough bytes in flight,
// so the kernel is shaped by bytes per load, not by threads per row.
// * The vector path, for d % 4 == 0 and d <= 16 (every shape the repo runs:
//   (4096, 8), (16384, 16), (27000, 8), (10^6, 8)): one thread reads a
//   whole row with 16-byte loads: int4 ids, float4 values, and in bfloat16
//   uint4 for eight values (so the bfloat16 vector path needs d % 8 == 0,
//   for each row to start on 16 bytes).  The ids and values are streamed
//   with evict-first loads (__ldcs), so that x keeps L1 and L2; all of the
//   row's x gathers are issued before the sum; no shuffles.  The grid is a
//   few waves of resident blocks that walk the rows with a grid stride.
//   The float32 row reader and the grid are ell_row.cuh's, shared with
//   diffusion.cu.
// * Other widths, or arrays not on 16 bytes, take the group path: a row is
//   read by min(d, 32) neighbouring threads (a power of two) whose partial
//   sums meet in shuffles.  That is a choice by shape, not a fallback.
// The order of the sum differs between the paths (the reference's
// tolerances hold: 1e-5 float32, 5e-2 bfloat16).  n is taken unpadded;
// padding slots (-1) are skipped wherever they sit, as is any id outside
// [0, n), so a malformed tile cannot read outside x.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 4;  // resident-block waves of the vector path's grid

__device__ __forceinline__ float product(float v, float x) {
  return __fmul_rn(v, x);
}
__device__ __forceinline__ float product(__nv_bfloat16 v, __nv_bfloat16 x) {
  // exact in float32 (8-bit significands), then rounded to bfloat16
  return __bfloat162float(
      __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), __bfloat162float(x))));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_spmv_group_kernel(const int* __restrict__ nbr, const T* __restrict__ val,
                      const T* __restrict__ x, T* __restrict__ y, int n, int d,
                      int group) {
  const int sub = threadIdx.x % group;
  const int64_t i =
      (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  float acc = 0.f;
  if (i < n) {
    const int64_t row = i * d;
    for (int j = sub; j < d; j += group) {
      const int u = nbr[row + j];
      if ((unsigned)u < (unsigned)n)  // skip padding (and any non-id)
        acc = __fadd_rn(acc, product(val[row + j], x[u]));
    }
  }
  for (int off = group / 2; off > 0; off /= 2)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off, group));
  if (i < n && sub == 0) store(&y[i], acc);
}

// One row of D slots by one thread (ell_row.cuh's reader), then the sum in
// slot order.
template <int D>
__device__ __forceinline__ float row_sum(const int* ids, const float* vals,
                                         const float* __restrict__ x, int n) {
  int u[D];
  float v[D], xv[D];
  load_row<D>(ids, vals, x, n, u, v, xv);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (valid_id(u[j], n)) acc = __fadd_rn(acc, product(v[j], xv[j]));
  return acc;
}

template <int D>
__device__ __forceinline__ float row_sum(const int* ids,
                                         const __nv_bfloat16* vals,
                                         const __nv_bfloat16* __restrict__ x,
                                         int n) {
  int u[D];
  __nv_bfloat16 v[D], xv[D];
  load_ids<D>(ids, u);
#pragma unroll
  for (int q = 0; q < D / 8; ++q) {
    const uint4 b = __ldcs(reinterpret_cast<const uint4*>(vals) + q);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[8 * q + k] = h[k];
  }
#pragma unroll
  for (int j = 0; j < D; ++j)
    xv[j] = valid_id(u[j], n) ? x[u[j]] : __float2bfloat16_rn(0.f);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (valid_id(u[j], n)) acc = __fadd_rn(acc, product(v[j], xv[j]));
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ell_spmv_vector_kernel(const int* __restrict__ nbr, const T* __restrict__ val,
                       const T* __restrict__ x, T* __restrict__ y, int n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    store(&y[i], row_sum<D>(nbr + i * D, val + i * D, x, n));
}

// Blocks of the vector path: kWaves waves of the blocks the card holds at
// once, and no more than there are rows for.
template <typename T, int D>
unsigned vector_blocks(int n) {
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0)
    resident = resident_blocks(ell_spmv_vector_kernel<T, D>, kThreads);
  return wave_blocks(n, kThreads, kWaves, resident);
}

template <typename T, int D>
void launch_vector(const int* nbr, const T* val, const T* x, T* y, int n,
                   cudaStream_t s) {
  ell_spmv_vector_kernel<T, D>
      <<<vector_blocks<T, D>(n), kThreads, 0, s>>>(nbr, val, x, y, n);
}

// The vector path for one of its widths; false if d is not one of them.
template <typename T>
bool try_vector(const int* nbr, const T* val, const T* x, T* y, int n, int d,
                cudaStream_t s);

template <>
bool try_vector<float>(const int* nbr, const float* val, const float* x,
                       float* y, int n, int d, cudaStream_t s) {
  switch (d) {
    case 4: launch_vector<float, 4>(nbr, val, x, y, n, s); return true;
    case 8: launch_vector<float, 8>(nbr, val, x, y, n, s); return true;
    case 12: launch_vector<float, 12>(nbr, val, x, y, n, s); return true;
    case 16: launch_vector<float, 16>(nbr, val, x, y, n, s); return true;
    default: return false;
  }
}

template <>
bool try_vector<__nv_bfloat16>(const int* nbr, const __nv_bfloat16* val,
                               const __nv_bfloat16* x, __nv_bfloat16* y,
                               int n, int d, cudaStream_t s) {
  switch (d) {
    case 8: launch_vector<__nv_bfloat16, 8>(nbr, val, x, y, n, s); return true;
    case 16:
      launch_vector<__nv_bfloat16, 16>(nbr, val, x, y, n, s);
      return true;
    default: return false;
  }
}

template <typename T>
void launch(const int* nbr, const T* val, const T* x, T* y, int n, int d,
            cudaStream_t s) {
  if (aligned16(nbr) && aligned16(val) && try_vector<T>(nbr, val, x, y, n, d, s))
    return;
  int group = 1;  // threads per row: a power of two <= 32
  while (group < 32 && group * 2 <= d) group *= 2;
  const int rows = kThreads / group;
  const unsigned blocks = (unsigned)((n + rows - 1) / rows);
  ell_spmv_group_kernel<T><<<blocks, kThreads, 0, s>>>(nbr, val, x, y, n, d,
                                                       group);
}

}  // namespace

// nbr (n, d) int32, val (n, d) and x (n,) of one type, y (n,) of that type.
// dtype: 0 float32, 1 bfloat16.
extern "C" int ell_spmv_launch(const void* nbr, const void* val,
                               const void* x, void* y, int n, int d,
                               int dtype, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch<float>((const int*)nbr, (const float*)val, (const float*)x,
                  (float*)y, n, d, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>((const int*)nbr, (const __nv_bfloat16*)val,
                          (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, d,
                          s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

