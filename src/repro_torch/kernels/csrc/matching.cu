// Synchronous probabilistic heavy-edge matching over a bucket of lanes.
//
// Replaces: src/repro/core/matching.py:63-133, heavy_edge_matching and its
// vmapped heavy_edge_matching_multi, which the reference runs as one jitted
// XLA program (not Pallas) for every MatchWork bucket.
//
// Per lane and round r, with (k_coin, k_tie, k_grant) = split(split(key,
// rounds)[r], 3) derived here from the lane's key:
//   coin      vertex v proposes iff it is unmatched and
//             uniform(k_coin, (n,))[v] < 0.5; unmatched non-proposers accept;
//   propose   a proposer scores the slots of its row whose neighbour is an
//             unmatched acceptor, float(wgt) + uniform(k_tie, (n, d))[v*d+j],
//             and proposes to the first maximal slot (jnp.argmax), or to no
//             one when no slot qualifies;
//   grant     an acceptor takes the proposal of largest key
//             gkey = float(prop_w) + uniform(k_grant, (n,))[v], the smallest
//             proposer id among equal keys;
//   commit    both directions; after the last round unmatched vertices
//             match themselves.
// n and d are the bucket's padded shape (MatchWork.bucket_key): the draws'
// counters depend on it.  Any vertex's coin and state follow from its
// counter and `match`, so a proposer recomputes its neighbours' coins and
// no coin array is exchanged.
//
// The grant is one 64-bit atomicMax a proposal in place of the reference's
// segment_max then segment_min: the high word is an order-preserving image
// of gkey (sign bit set on a non-negative float, all bits inverted on a
// negative one, so it holds for any int32 weight), the low word
// 0x7FFFFFFF - v.  The largest word names the largest key and, among equal
// keys (at weights of 2^24 and up the tie draw rounds away), the smallest
// proposer, which is the reference's is_best & winner exactly.  A proposer
// is granted iff the low word of its acceptor's word names it; an acceptor
// grants at most one, so the commit's writes never collide.
//
// An id outside [-1, n) never appears in a MatchWork; the kernel treats one
// as padding, as the port's other kernels do, so no read leaves the lane.
//
// What bounds it on an H100: the threefry operations and the tile's bytes,
// within 2x of each other.  Each draw is a threefry2x32 of about 100
// integer operations; a round may draw 2n coins and grant keys and n*d tie
// breaks, and reads the tile's nbr and wgt (8 bytes a slot, L2-resident at
// the main path's sizes), 8 rounds in all.  Counted over what the data
// needs (a coin per unmatched vertex, a tie per slot a proposer scores, a
// grant key per proposal; each real slot read once), the root bucket of
// grid3d(30^3), (1, 32768, 8), needs ~163 K draws (16 M operations) against
// 1.4 MB: bytes by a little, both well under a microsecond.  At these sizes
// the launches, not either bound, set the time.
//
// Design: two launches a round over a grid of (row blocks, L), state in
// device memory (match, prop, and a double buffer of grant words, so that
// the commit of round r clears the words round r + 1 will use), and one
// last launch for the singletons: 2 * rounds + 1 launches a matching, none
// of them torch ops.  A row is read by a group of min(d, 32) neighbouring
// threads (coarse levels have rows of 64-128 slots) whose best slots are
// combined with shuffles; only unmatched proposers draw their row's ties.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gain_row.cuh"  // gain_group: threads a row, min(d, 32)
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kLowMax = 0x7FFFFFFFu;

// An order-preserving unsigned image of a float (no NaN arises here).
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool coin_proposes(Key2x32 k_coin, int64_t v) {
  return threefry_uniform(k_coin, (uint64_t)v) < 0.5f;
}

__global__ void match_propose(const int* __restrict__ nbr,
                              const int* __restrict__ wgt,
                              const int64_t* __restrict__ keys,
                              const int* __restrict__ match,
                              int* __restrict__ prop,
                              unsigned long long* __restrict__ best, int n,
                              int d, int group, int round) {
  __shared__ Key2x32 ks[3];  // k_coin, k_tie, k_grant of this round
  const int lane = blockIdx.y;
  if (threadIdx.x < 3) {
    const Key2x32 rkey = threefry_split(key_of(keys + 2 * lane), round);
    ks[threadIdx.x] = threefry_split(rkey, threadIdx.x);
  }
  __syncthreads();
  const Key2x32 k_coin = ks[0], k_tie = ks[1], k_grant = ks[2];
  const int64_t base = (int64_t)lane * n;
  const int* m = match + base;
  const int sub = threadIdx.x % group;
  const int64_t v =
      (int64_t)blockIdx.x * (kThreads / group) + threadIdx.x / group;
  const int64_t row = (base + v) * d;
  const bool proposer = v < n && m[v] < 0 && coin_proposes(k_coin, v);
  float best_score = -INFINITY;
  int best_slot = -1;
  if (proposer) {
    for (int j = sub; j < d; j += group) {
      const int u = nbr[row + j];
      if ((unsigned)u >= (unsigned)n) continue;  // padding, or not an id
      if (m[u] >= 0 || coin_proposes(k_coin, u)) continue;  // no acceptor
      const float score =
          __fadd_rn(__int2float_rn(wgt[row + j]),
                    threefry_uniform(k_tie, (uint64_t)v * d + j));
      if (best_slot < 0 || score > best_score) {  // first maximal slot
        best_score = score;
        best_slot = j;
      }
    }
  }
  for (int off = group / 2; off > 0; off /= 2) {
    const float s = __shfl_down_sync(0xffffffffu, best_score, off, group);
    const int j = __shfl_down_sync(0xffffffffu, best_slot, off, group);
    if (j >= 0 && (best_slot < 0 || s > best_score ||
                   (s == best_score && j < best_slot))) {
      best_score = s;
      best_slot = j;
    }
  }
  if (v >= n || sub != 0) return;
  int p = -1;
  if (best_slot >= 0) {
    p = nbr[row + best_slot];
    const float gkey =
        __fadd_rn(__int2float_rn(wgt[row + best_slot]),
                  threefry_uniform(k_grant, (uint64_t)v));
    const unsigned long long word =
        ((unsigned long long)ordered(gkey) << 32) | (kLowMax - (uint32_t)v);
    atomicMax(best + base + p, word);
  }
  prop[base + v] = p;
}

__global__ void match_commit(const int* __restrict__ prop,
                             const unsigned long long* __restrict__ best,
                             unsigned long long* __restrict__ best_next,
                             int* __restrict__ match, int n) {
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const int64_t base = (int64_t)blockIdx.y * n;
  const int p = prop[base + v];
  if (p >= 0 && (uint32_t)best[base + p] == kLowMax - (uint32_t)v) {
    match[base + v] = p;
    match[base + p] = (int)v;
  }
  best_next[base + v] = 0ull;  // the next round's grant words start empty
}

__global__ void match_singletons(int* __restrict__ match, int n) {
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  int* m = match + (int64_t)blockIdx.y * n;
  if (m[v] < 0) m[v] = (int)v;
}

}  // namespace

// nbr, wgt (L, n, d) int32, keys (L, 2) int64 (32-bit words)  ->  match
// (L, n) int32.  Scratch: prop (L, n) int32, best (2, L, n) 64-bit words.
extern "C" int matching_launch(const void* nbr, const void* wgt,
                               const void* keys, void* match, void* prop,
                               void* best, int L, int n, int d, int rounds,
                               void* stream) {
  if (L == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const size_t cells = (size_t)L * n;
  unsigned long long* words = (unsigned long long*)best;
  cudaError_t err = cudaMemsetAsync(match, 0xFF, cells * sizeof(int), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(words, 0, 2 * cells * sizeof(*words), s);
  if (err != cudaSuccess) return (int)err;
  const int group = gain_group(d);
  const int rows = kThreads / group;
  const dim3 grid_rows((unsigned)((n + rows - 1) / rows), (unsigned)L);
  const dim3 grid_verts((unsigned)((n + kThreads - 1) / kThreads),
                        (unsigned)L);
  for (int r = 0; r < rounds; ++r) {
    unsigned long long* cur = words + (r % 2) * cells;
    unsigned long long* next = words + ((r + 1) % 2) * cells;
    match_propose<<<grid_rows, kThreads, 0, s>>>(
        (const int*)nbr, (const int*)wgt, (const int64_t*)keys,
        (const int*)match, (int*)prop, cur, n, d, group, r);
    match_commit<<<grid_verts, kThreads, 0, s>>>((const int*)prop, cur, next,
                                                 (int*)match, n);
  }
  match_singletons<<<grid_verts, kThreads, 0, s>>>((int*)match, n);
  return (int)cudaGetLastError();
}
