// Vertex-separator FM, one CTA per lane: the fused pass loop and the
// hoisted path's one-pass move loop.
//
// Replaces: src/repro/kernels/fm_fused.py:209, fm_fused_multi
// (_fm_fused_kernel with the per-lane fm_move_loop), the TPU kernel that
// keeps one lane's state resident in VMEM across all passes and moves.
// The move loop is one __device__ function, `move_loop`, called by both
// kernels here, as the reference shares fm_move_loop between its fused
// kernel and its hoisted path (src/repro/core/fm.py:104):
// * fm_fused_kernel runs every pass: gain recompute, moves, revert;
// * fm_move_loop_kernel runs one pass with the gains given (from
//   sep_gain.cu) and bws / bimb carried in, so that a pass loop on the host
//   that alternates the two kernels gives the fused kernel's results.
//
// What bounds it on an H100: latency, not bytes or operations.  A move is
// an argmax over the movable separator vertices followed by an O(d) and
// O(pulled * d) update, and every move depends on the one before; the
// per-lane work is a chain of block-wide reductions.  The roofline bound
// counts only the work the moves need: the kernel tallies, per lane, the
// arithmetic on the candidates it scores (not the vertices it skips), on
// the slots the moves update and on each pass's recompute, and the noise
// entries it reads (each once).  chip_smoke.py turns that tally into the
// bound; it is operations, far below the time the chain takes.
//
// Design:
// * one CTA of 1024 threads per lane; passes and moves loop inside it;
// * the mutable state (pulled0/1 f32, part, best part, moved i8, and the
//   pulled-slot list, 11n + 4d bytes) lives in a per-lane device-memory
//   scratch at every n, so no n the caller pads to is too large; at the
//   altr4-scale band (n 8192, d 1024) shared memory was not clearly
//   faster (PERF.md);
// * the ELL tile is read from device memory: one tile per work, shared by
//   the work's lanes through `lane_work`, so lanes do not copy it;
// * padding slots (-1) are skipped wherever they sit in a row: the
//   reference adds +-0.0 there, which leaves every sum unchanged;
// * every float sum is over integer-valued float32 weights, so atomics and
//   reductions in any order give the reference's values exactly;
// * score = gain + noise * amp is rounded twice, as the reference does:
//   __fmul_rn / __fadd_rn, and the file is built with -fmad=false;
// * the argmax is the first maximal index over [side 0 | side 1], with
//   -inf for infeasible entries: ties go to the lower index.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gain_row.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Reduce {
  float s[kWarps];
  int i[kWarps];
};

__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float os = __shfl_xor_sync(kFull, s, off);
    int oi = __shfl_xor_sync(kFull, i, off);
    if (beats(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Block-wide argmax; every thread gets the result.
__device__ void block_argmax(float& s, int& i, Reduce& r) {
  __syncthreads();  // the previous reduction's readers are done
  warp_argmax(s, i);
  if ((threadIdx.x & 31) == 0) {
    r.s[threadIdx.x >> 5] = s;
    r.i[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  s = r.s[threadIdx.x & 31];
  i = r.i[threadIdx.x & 31];
  warp_argmax(s, i);
}

// Block-wide float sum; every thread gets the same value.
__device__ float block_sum(float x, Reduce& r) {
  __syncthreads();
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) r.s[threadIdx.x >> 5] = x;
  __syncthreads();
  return warp_sum(r.s[threadIdx.x & 31]);
}

__device__ void part_sums(const int8_t* part, const float* vw, int n,
                          Reduce& r, float& w0, float& w1, float& ws) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int v = threadIdx.x; v < n; v += kThreads) {
    int p = part[v];
    float x = vw[v];
    if (p == 0) a0 += x;
    else if (p == 1) a1 += x;
    else if (p == 2) a2 += x;
  }
  w0 = block_sum(a0, r);
  w1 = block_sum(a1, r);
  ws = block_sum(a2, r);
}

// pulled0[v] = weight of v's neighbours on side 1, pulled1[v] on side 0:
// the row body of sep_gain.cu (gain_row.cuh) over every row of the lane.
// Returns the number of valid slots this thread read.
__device__ int recompute_pulled(const int* tile, const int8_t* part,
                                const float* vw, float* pulled0,
                                float* pulled1, int n, int d) {
  const int group = gain_group(d);
  const int rows = kThreads / group;
  int slots = 0;
  for (int base = 0; base < n; base += rows) {
    const int v = base + threadIdx.x / group;
    float a0, a1;
    slots += gain_row(v < n ? tile + (int64_t)v * d : nullptr, d, n, group,
                      part, vw, a0, a1);
    if (v < n && threadIdx.x % group == 0) {
      pulled0[v] = a0;
      pulled1[v] = a1;
    }
  }
  return slots;
}

// Per-lane mutable state, in a device-memory scratch slice of the lane.
struct LaneState {
  float* pulled0;
  float* pulled1;
  int* pull_list;  // d entries
  int8_t* part;
  int8_t* bpart;
  uint8_t* moved;  // bit 0 moved, bits 1-2 noise read
};

__device__ LaneState lane_state(uint8_t* base, int n, int d) {
  LaneState st;
  st.pulled0 = reinterpret_cast<float*>(base);
  st.pulled1 = st.pulled0 + n;
  st.pull_list = reinterpret_cast<int*>(st.pulled1 + n);
  st.part = reinterpret_cast<int8_t*>(st.pull_list + d);
  st.bpart = st.part + n;
  st.moved = reinterpret_cast<uint8_t*>(st.bpart + n);
  return st;
}

// Counts of the work the moves need (the roofline's tally): move-loop
// steps, arithmetic on scored candidates, updated slots and pass
// recomputes, and distinct (pass, vertex, side) noise entries read.
struct Tally {
  int steps;
  long long ops;
  long long noise_reads;
};

// One pass of moves on one lane: the reference's per-lane fm_move_loop
// (src/repro/kernels/fm_fused.py:48).  On entry part == bpart, pulled0/1
// hold the gains of part and w0, w1, ws its side and separator weights.
// Runs up to max_moves moves; bpart, bws and bimb track the best feasible
// state.  Every thread of the block calls it and gets the same scalars.
__device__ void move_loop(const int* tile, const float* vw, const uint8_t* lk,
                          const float* nz0, const float* nz1, LaneState st,
                          int n, int d, float eps_abs, int max_moves,
                          int pert, int pos_only, float& w0, float& w1,
                          float& ws, float& bws, float& bimb, Reduce& red,
                          int& n_pull, Tally& t) {
  const int tid = threadIdx.x;
  float* pulled0 = st.pulled0;
  float* pulled1 = st.pulled1;
  int* pull_list = st.pull_list;
  int8_t* part = st.part;
  int8_t* bpart = st.bpart;
  uint8_t* moved = st.moved;
  for (int v = tid; v < n; v += kThreads) moved[v] = 0;
  bool alive = true;
  for (int i = 0; i < max_moves && alive; ++i, ++t.steps) {
    __syncthreads();  // previous move's updates are visible
    if (tid == 0) n_pull = 0;
    const float amp = i < pert ? 1e9f : 1e-3f;
    const float thr = fmaxf(eps_abs, fabsf(w0 - w1));
    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int v = tid; v < n; v += kThreads) {
      const uint8_t m = moved[v];
      if (part[v] != 2 || (m & 1) || lk[v]) continue;
      const float x = vw[v], q0 = pulled0[v], q1 = pulled1[v];
      const float g0 = __fsub_rn(x, q0), g1 = __fsub_rn(x, q1);
      const float imb0 = fabsf(__fsub_rn(__fadd_rn(w0, x), __fsub_rn(w1, q0)));
      const float imb1 = fabsf(__fsub_rn(__fsub_rn(w0, q1), __fadd_rn(w1, x)));
      bool ok0 = imb0 <= thr, ok1 = imb1 <= thr;
      t.ops += 12;  // two gains, two balances of four, two compares
      if (pos_only) {
        ok0 = ok0 && g0 > 0.f;
        ok1 = ok1 && g1 > 0.f;
        t.ops += 2;
      }
      uint8_t seen = m;
      if (ok0) {
        const float s = __fadd_rn(g0, __fmul_rn(nz0[v], amp));
        if (beats(s, v, bs, bi)) { bs = s; bi = v; }
        t.ops += 3;  // multiply, add, compare
        seen |= 2;
      }
      if (ok1) {
        const float s = __fadd_rn(g1, __fmul_rn(nz1[v], amp));
        if (beats(s, n + v, bs, bi)) { bs = s; bi = n + v; }
        t.ops += 3;
        seen |= 4;
      }
      if (seen != m) {
        t.noise_reads += ((seen ^ m) >> 1 & 1) + ((seen ^ m) >> 2 & 1);
        moved[v] = seen;
      }
    }
    block_argmax(bs, bi, red);
    const bool ok = bs > -INFINITY;
    float dv = 0.f, pulled_w = 0.f;
    int side = 0;
    if (ok) {
      side = bi >= n ? 1 : 0;
      const int v = bi - side * n;
      const int* row = tile + (int64_t)v * d;
      // the pulled set, judged on the state before the move
      float pw = 0.f;
      for (int j = tid; j < d; j += kThreads) {
        const int u = row[j];
        if (u < 0) continue;
        t.ops += 2;  // test the side, update its neighbour's pull (below)
        if (part[u] == 1 - side) {
          pw += vw[u];
          pull_list[atomicAdd(&n_pull, 1)] = u;
          t.ops += 1;
        }
      }
      pulled_w = block_sum(pw, red);  // also publishes pull_list
      dv = vw[v];
      const int np = n_pull;
      for (int k = tid; k < np; k += kThreads) part[pull_list[k]] = 2;
      if (tid == 0) {
        part[v] = (int8_t)side;
        moved[v] |= 1;
        t.ops += 12;  // the balances, the separator weight, the best test
      }
      // v leaves the separator for `side`: its neighbours' pull grows
      float* pv = side == 1 ? pulled0 : pulled1;
      for (int j = tid; j < d; j += kThreads) {
        const int u = row[j];
        if (u >= 0) atomicAdd(&pv[u], dv);
      }
      // each pulled x leaves side 1-side: its neighbours' pull shrinks
      float* pu = side == 0 ? pulled0 : pulled1;
      for (int k = tid; k < np * d; k += kThreads) {
        const int x = pull_list[k / d];
        const int u = tile[(int64_t)x * d + k % d];
        if (u >= 0) {
          atomicAdd(&pu[u], -vw[x]);
          ++t.ops;
        }
      }
    }
    w0 = w0 + (side == 0 ? dv : 0.f) - (side == 1 ? pulled_w : 0.f);
    w1 = w1 + (side == 1 ? dv : 0.f) - (side == 0 ? pulled_w : 0.f);
    ws = ws - dv + pulled_w;
    const float imb_new = fabsf(w0 - w1);
    const bool better = ws < bws && imb_new <= fmaxf(eps_abs, bimb);
    if (better) {
      bws = ws;
      bimb = fminf(imb_new, bimb);
      __syncthreads();  // the move's part writes are visible
      for (int v = tid; v < n; v += kThreads) bpart[v] = part[v];
    }
    alive = ok;
  }
}

// Write a lane's results: best part, its separator weight and imbalance,
// and the tally summed over the block.
__device__ void finish_lane(int l, int n, const LaneState& st, float bws,
                            float bimb, const Tally& t,
                            unsigned long long* tally, int8_t* parts_out,
                            float* sep_w_out, float* imb_out,
                            long long* stats_out) {
  atomicAdd(&tally[0], (unsigned long long)t.ops);
  atomicAdd(&tally[1], (unsigned long long)t.noise_reads);
  __syncthreads();
  for (int v = threadIdx.x; v < n; v += kThreads)
    parts_out[(int64_t)l * n + v] = st.bpart[v];
  if (threadIdx.x == 0) {
    sep_w_out[l] = bws;
    imb_out[l] = bimb;
    stats_out[3 * l] = t.steps;
    stats_out[3 * l + 1] = (long long)tally[0];
    stats_out[3 * l + 2] = (long long)tally[1];
  }
}

// All passes of one lane: per pass, recompute the pulled weights, run the
// move loop, revert to the best state.
__global__ void __launch_bounds__(kThreads, 1)
fm_fused_kernel(const int* __restrict__ nbr, const int* __restrict__ lane_work,
                const float* __restrict__ vwgt,
                const int8_t* __restrict__ parts_in,
                const uint8_t* __restrict__ locked,
                const float* __restrict__ noise,
                const float* __restrict__ eps_abs_in,
                const int* __restrict__ max_moves_in,
                const int* __restrict__ n_pert_in, int8_t* parts_out,
                float* sep_w_out, float* imb_out, long long* stats_out,
                uint8_t* scratch,
                int64_t stride, int n, int d, int passes, int pos_only) {
  __shared__ Reduce red;
  __shared__ int n_pull;
  __shared__ unsigned long long tally[2];  // operations, noise entries read

  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const LaneState st = lane_state(scratch + (int64_t)l * stride, n, d);
  const int* tile = nbr + (int64_t)lane_work[l] * n * d;
  const float* vw = vwgt + (int64_t)l * n;
  const uint8_t* lk = locked + (int64_t)l * n;
  const float eps_abs = eps_abs_in[l];
  const int max_moves = max_moves_in[l];
  const int n_pert = n_pert_in[l];

  for (int v = tid; v < n; v += kThreads) {
    int8_t p = parts_in[(int64_t)l * n + v];
    st.part[v] = p;
    st.bpart[v] = p;
  }
  if (tid < 2) tally[tid] = 0;
  float w0, w1, ws;
  part_sums(st.part, vw, n, red, w0, w1, ws);  // syncs: tally is zeroed
  float bws = ws, bimb = fabsf(w0 - w1);
  Tally t = {0, 0, 0};

  for (int p = 0; p < passes && max_moves > 0; ++p) {
    if (p > 0) {  // revert to the best state of the previous pass
      __syncthreads();
      for (int v = tid; v < n; v += kThreads) st.part[v] = st.bpart[v];
      part_sums(st.part, vw, n, red, w0, w1, ws);  // syncs before reading
    }
    t.ops += 2LL * recompute_pulled(tile, st.part, vw, st.pulled0,
                                    st.pulled1, n, d);
    const float* nz0 = noise + ((int64_t)l * passes + p) * 2 * n;
    move_loop(tile, vw, lk, nz0, nz0 + n, st, n, d, eps_abs, max_moves,
              p == 0 ? n_pert : 0, pos_only, w0, w1, ws, bws, bimb, red,
              n_pull, t);
  }
  finish_lane(l, n, st, bws, bimb, t, tally, parts_out, sep_w_out, imb_out,
              stats_out);
}

// One pass of one lane, with the pulled weights given (the hoisted path:
// the gains come from sep_gain.cu).  bws and bimb are carried in from the
// previous pass: bimb is a running minimum, not a function of part.
__global__ void __launch_bounds__(kThreads, 1)
fm_move_loop_kernel(const int* __restrict__ nbr,
                    const int* __restrict__ lane_work,
                    const float* __restrict__ vwgt,
                    const int8_t* __restrict__ parts_in,
                    const uint8_t* __restrict__ locked,
                    const float* __restrict__ pulled0_in,
                    const float* __restrict__ pulled1_in,
                    const float* __restrict__ noise,
                    const int* __restrict__ pert_in,
                    const float* __restrict__ eps_abs_in,
                    const int* __restrict__ max_moves_in,
                    const float* __restrict__ bws_in,
                    const float* __restrict__ bimb_in, int8_t* parts_out,
                    float* sep_w_out, float* imb_out, long long* stats_out,
                    uint8_t* scratch, int64_t stride, int n, int d,
                    int pos_only) {
  __shared__ Reduce red;
  __shared__ int n_pull;
  __shared__ unsigned long long tally[2];

  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const LaneState st = lane_state(scratch + (int64_t)l * stride, n, d);
  const int* tile = nbr + (int64_t)lane_work[l] * n * d;
  const float* vw = vwgt + (int64_t)l * n;
  const int max_moves = max_moves_in[l];

  for (int v = tid; v < n; v += kThreads) {
    const int64_t k = (int64_t)l * n + v;
    st.part[v] = parts_in[k];
    st.bpart[v] = parts_in[k];
    st.pulled0[v] = pulled0_in[k];
    st.pulled1[v] = pulled1_in[k];
  }
  if (tid < 2) tally[tid] = 0;
  float w0, w1, ws;
  part_sums(st.part, vw, n, red, w0, w1, ws);  // syncs: state is copied
  float bws = bws_in[l], bimb = bimb_in[l];
  Tally t = {0, 0, 0};
  if (max_moves > 0) {
    const float* nz0 = noise + (int64_t)l * 2 * n;
    move_loop(tile, vw, locked + (int64_t)l * n, nz0, nz0 + n, st, n, d,
              eps_abs_in[l], max_moves, pert_in[l], pos_only, w0, w1, ws,
              bws, bimb, red, n_pull, t);
  }
  finish_lane(l, n, st, bws, bimb, t, tally, parts_out, sep_w_out, imb_out,
              stats_out);
}

}  // namespace

// Bytes of per-lane state: pulled0/1, the pulled-slot list, part, best
// part and moved.  The wrapper uses the same formula.
static int64_t state_bytes(int n, int d) { return 11LL * n + 4LL * d; }

// The state lives in `scratch`, one 256-byte-aligned slice per lane.
extern "C" int fm_fused_launch(const void* nbr, const void* lane_work,
                               const void* vwgt, const void* parts_in,
                               const void* locked, const void* noise,
                               const void* eps_abs, const void* max_moves,
                               const void* n_pert, void* parts_out,
                               void* sep_w, void* imb, void* stats,
                               void* scratch, int L,
                               int n, int d, int passes, int pos_only,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t stride = (state_bytes(n, d) + 255) / 256 * 256;
  fm_fused_kernel<<<L, kThreads, 0, s>>>(
      (const int*)nbr, (const int*)lane_work, (const float*)vwgt,
      (const int8_t*)parts_in, (const uint8_t*)locked, (const float*)noise,
      (const float*)eps_abs, (const int*)max_moves, (const int*)n_pert,
      (int8_t*)parts_out, (float*)sep_w, (float*)imb, (long long*)stats,
      (uint8_t*)scratch, stride,
      n, d, passes, pos_only);
  return (int)cudaGetLastError();
}

// One pass per lane with given pulled weights; noise is this pass's
// (L, 2, n) slice and pert the lanes' perturbed-move counts.
extern "C" int fm_move_loop_launch(const void* nbr, const void* lane_work,
                                   const void* vwgt, const void* parts_in,
                                   const void* locked, const void* pulled0,
                                   const void* pulled1, const void* noise,
                                   const void* pert, const void* eps_abs,
                                   const void* max_moves, const void* bws_in,
                                   const void* bimb_in, void* parts_out,
                                   void* sep_w, void* imb, void* stats,
                                   void* scratch, int L, int n, int d,
                                   int pos_only, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t stride = (state_bytes(n, d) + 255) / 256 * 256;
  fm_move_loop_kernel<<<L, kThreads, 0, s>>>(
      (const int*)nbr, (const int*)lane_work, (const float*)vwgt,
      (const int8_t*)parts_in, (const uint8_t*)locked, (const float*)pulled0,
      (const float*)pulled1, (const float*)noise, (const int*)pert,
      (const float*)eps_abs, (const int*)max_moves, (const float*)bws_in,
      (const float*)bimb_in, (int8_t*)parts_out, (float*)sep_w, (float*)imb,
      (long long*)stats, (uint8_t*)scratch, stride, n, d, pos_only);
  return (int)cudaGetLastError();
}
