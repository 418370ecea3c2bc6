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
// What bounds it on an H100: bytes.  Each slot is an id and a value read
// once, one multiply and one add; x is gathered (from L2 for graphs whose x
// fits in its 50 MB).  The least time is ids, values, x and y moved once.
//
// Design: one launch over row blocks; a row is read by a group of
// min(d, 32) neighbouring threads (a power of two), so id and value reads
// are coalesced, and the group's partial sums are combined with shuffles.
// x needs no residency on this card: the gather goes through L1 and L2.
// n is taken unpadded; padding slots (-1) are skipped wherever they sit, as
// is any id outside [0, n), so a malformed tile cannot read outside x.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
__global__ void ell_spmv_kernel(const int* __restrict__ nbr,
                                const T* __restrict__ val,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n, int d, int group) {
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

}  // namespace

// nbr (n, d) int32, val (n, d) and x (n,) of one type, y (n,) of that type.
// dtype: 0 float32, 1 bfloat16.
extern "C" int ell_spmv_launch(const void* nbr, const void* val,
                               const void* x, void* y, int n, int d,
                               int dtype, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  int group = 1;  // threads per row: a power of two <= 32
  while (group < 32 && group * 2 <= d) group *= 2;
  const int rows = kThreads / group;
  const unsigned blocks = (unsigned)((n + rows - 1) / rows);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    ell_spmv_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const int*)nbr, (const float*)val, (const float*)x, (float*)y, n, d,
        group);
  } else if (dtype == 1) {
    ell_spmv_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const int*)nbr, (const __nv_bfloat16*)val,
        (const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, d, group);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
