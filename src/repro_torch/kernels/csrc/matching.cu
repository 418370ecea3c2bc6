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
// counters depend on it.
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
// integer operations; a round may draw n coins and grant keys and n*d tie
// breaks, and reads the tile's nbr and wgt (8 bytes a slot, L2-resident at
// the main path's sizes), 8 rounds in all.  Counted over what the data
// needs (a coin per unmatched vertex, a tie per slot a proposer scores, a
// grant key per proposal; each real slot read once), the root bucket of
// grid3d(30^3), (1, 32768, 8), needs ~163 K draws (16 M operations) against
// 1.4 MB: bytes by a little, both well under a microsecond.  At these sizes
// the dependent steps, not either bound, set the time: in the cluster
// design a phase's chain of dependent loads, and in the first rounds the
// draws, which 1 to 16 SMs compute where the grid design has 132.
//
// Two designs, chosen by the lane's size in kernels/band_batch.py
// (`lane_plan`):
//
// cluster (one launch a call): one thread-block cluster of C CTAs a lane
// (cluster.cuh).  The kernel starts the state itself and runs the rounds
// as phases a lane barrier apart: start (every vertex free, round 0's coin
// drawn once a vertex into a role byte: proposer, acceptor or matched),
// then per round propose + grant, and commit, which also draws the next
// round's coin and clears the next round's grant words; the last commit
// matches the unmatched vertices with themselves.  2 * rounds barriers and
// no other device operation.  A proposer reads its neighbours' roles.
//
// grid (2 * rounds + 1 launches, two memsets): a grid of (row blocks, L)
// a phase, for lanes larger than a cluster can take, where the launches
// cost little beside the work and the whole card is used.  A proposer
// recomputes its neighbours' coins from their counters and `match`.
//
// The state: match, prop, a double buffer of grant words (so that the
// commit of round r clears the words round r + 1 uses) and, in the cluster
// design, the role bytes: 25 bytes a vertex in device memory, L2-resident
// at these sizes, except that a one-CTA lane keeps all but match (21
// bytes a vertex) in shared memory.  A row is read by a group of neighbouring
// threads whose best slots are combined with shuffles: min(d, 32) threads
// in the grid design, and in the cluster design as many as give each
// thread at most 8 slots (lane_group), read 4 at a time with their
// neighbours' roles loaded together, since a cluster has few threads for
// a lane and the dependent loads, not the bytes, set a phase's time.  Only
// proposers draw their row's ties.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"
#include "gain_row.cuh"  // gain_group: threads a row, min(d, 32)
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;  // the grid design's block
constexpr uint32_t kLowMax = 0x7FFFFFFFu;
// a vertex's role in a round of the cluster design
constexpr uint8_t kMatched = 0, kProposer = 1, kAcceptor = 2;

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


// The keys of round r: (k_coin, k_tie, k_grant).
__device__ __forceinline__ Key2x32 round_key(Key2x32 lane_key, int r, int i) {
  return threefry_split(threefry_split(lane_key, (uint32_t)r), (uint32_t)i);
}

__device__ __forceinline__ uint8_t role_of(Key2x32 k_coin, int v) {
  return coin_proposes(k_coin, v) ? kProposer : kAcceptor;
}

// The cluster design: one lane a cluster (grid L * C, lane blockIdx.x / C).
// The state: words (2, L, n) grant words, prop (L, n), role (L, n) bytes,
// in device memory; or, with kShared (C == 1), the lane's share of each in
// the CTA's shared memory (21 bytes a vertex).
template <bool kShared>
__global__ void __launch_bounds__(kLaneThreads, 1)
    match_lanes(const int* __restrict__ nbr, const int* __restrict__ wgt,
                const int64_t* __restrict__ keys, int* match, int* prop,
                unsigned long long* words, uint8_t* role, int L, int n, int d,
                int group, bool vec, int rounds, int C) {
  extern __shared__ __align__(16) unsigned char lane_state[];
  __shared__ Key2x32 ks[2][3];  // this round's keys and the next round's
  const int lane = blockIdx.x / C;
  int lo, hi;
  lane_rows(n, C, blockIdx.x % C, lo, hi);
  const int64_t base = (int64_t)lane * n;
  int* m = match + base;
  // the grant words of this round (cur) and of the next (nxt), swapped
  // each round
  unsigned long long* cur;
  unsigned long long* nxt;
  int* pr;
  uint8_t* ro;
  if constexpr (kShared) {
    cur = reinterpret_cast<unsigned long long*>(lane_state);
    nxt = cur + n;
    pr = reinterpret_cast<int*>(nxt + n);
    ro = reinterpret_cast<uint8_t*>(pr + n);
  } else {
    cur = words + base;
    nxt = words + (int64_t)L * n + base;
    pr = prop + base;
    ro = role + base;
  }
  const Key2x32 lane_key = key_of(keys + 2 * lane);
  if (threadIdx.x < 3 && rounds > 0)
    ks[0][threadIdx.x] = round_key(lane_key, 0, threadIdx.x);
  __syncthreads();
  // start: every vertex free with round 0's coin, round 0's words empty
  for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    __stcg(m + v, rounds > 0 ? -1 : v);
    if (rounds > 0) lane_st<kShared>(ro + v, role_of(ks[0][0], v));
    lane_st<kShared>(cur + v, 0ull);
  }
  const int rows = blockDim.x / group;
  const int sub = threadIdx.x % group;
  for (int r = 0; r < rounds; ++r) {
    const int b = r & 1;
    const bool last = r + 1 == rounds;
    lane_sync(C);
    if (threadIdx.x < 3 && !last)
      ks[b ^ 1][threadIdx.x] = round_key(lane_key, r + 1, threadIdx.x);
    // propose + grant: a group of `group` threads a row, each reading up to
    // 8 slots, 4 at a time, whose neighbours' roles are loaded together
    const Key2x32 k_tie = ks[b][1], k_grant = ks[b][2];
    for (int v0 = lo; v0 < hi; v0 += rows) {
      const int v = v0 + threadIdx.x / group;
      const bool proposer = v < hi && lane_ld<kShared>(ro + v) == kProposer;
      const int* nrow = nbr + (base + v) * d;
      const int* wrow = wgt + (base + v) * d;
      float best_score = -INFINITY;
      int best_slot = -1, best_u = -1, best_w = 0;
      for (int c = sub; proposer && 4 * c < d; c += group) {
        const int4 q = load4(nrow, c, d, vec, -1);
        const int4 qw = load4(wrow, c, d, vec, 0);  // in flight with q
        const int ids[4] = {q.x, q.y, q.z, q.w};
        const int ws[4] = {qw.x, qw.y, qw.z, qw.w};
        bool acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)  // padding, or not an id, is skipped
          acc[e] = (unsigned)ids[e] < (unsigned)n &&
                   lane_ld<kShared>(ro + ids[e]) == kAcceptor;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!acc[e]) continue;
          const int j = 4 * c + e;
          const float score =
              __fadd_rn(__int2float_rn(ws[e]),
                        threefry_uniform(k_tie, (uint64_t)v * d + j));
          if (best_slot < 0 || score > best_score) {  // first maximal slot
            best_score = score;
            best_slot = j;
            best_u = ids[e];
            best_w = ws[e];
          }
        }
      }
      for (int off = group / 2; off > 0; off /= 2) {
        const float s = __shfl_down_sync(0xffffffffu, best_score, off, group);
        const int j = __shfl_down_sync(0xffffffffu, best_slot, off, group);
        const int u = __shfl_down_sync(0xffffffffu, best_u, off, group);
        const int wj = __shfl_down_sync(0xffffffffu, best_w, off, group);
        if (j >= 0 && (best_slot < 0 || s > best_score ||
                       (s == best_score && j < best_slot))) {
          best_score = s;
          best_slot = j;
          best_u = u;
          best_w = wj;
        }
      }
      if (!proposer || sub != 0) continue;
      if (best_slot >= 0) {
        const float gkey = __fadd_rn(__int2float_rn(best_w),
                                     threefry_uniform(k_grant, (uint64_t)v));
        atomicMax(cur + best_u, ((unsigned long long)ordered(gkey) << 32) |
                                    (kLowMax - (uint32_t)v));
      }
      lane_st<kShared>(pr + v, best_u);
    }
    lane_sync(C);
    // commit: each vertex writes its own mate; then the next round's coin
    // and grant words
    const Key2x32 k_coin = ks[b ^ 1][0];
    for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
      const uint8_t rv = lane_ld<kShared>(ro + v);
      int mate = -1;
      if (rv == kAcceptor) {
        const unsigned long long word = lane_ld<kShared>(cur + v);
        if (word != 0ull) mate = (int)(kLowMax - (uint32_t)word);
      } else if (rv == kProposer) {
        const int p = lane_ld<kShared>(pr + v);
        if (p >= 0 &&
            (uint32_t)lane_ld<kShared>(cur + p) == kLowMax - (uint32_t)v)
          mate = p;
      }
      if (last && rv != kMatched && mate < 0) mate = v;  // singleton
      if (mate >= 0) __stcg(m + v, mate);
      if (!last) {
        if (rv != kMatched)
          lane_st<kShared>(ro + v,
                           mate >= 0 ? kMatched : role_of(k_coin, v));
        lane_st<kShared>(nxt + v, 0ull);
      }
    }
    unsigned long long* const used = cur;
    cur = nxt;
    nxt = used;
  }
}

}  // namespace

// nbr, wgt (L, n, d) int32, keys (L, 2) int64 (32-bit words)  ->  match
// (L, n) int32.  Scratch: the grant words (2, L, n) 64-bit, then prop
// (L, n) int32, then (cluster design only) the roles (L, n) bytes.

// The grid design: 2 * rounds + 1 launches and two memsets.
extern "C" int matching_grid_launch(const void* nbr, const void* wgt,
                                    const void* keys, void* match,
                                    void* scratch, int L, int n, int d,
                                    int rounds, void* stream) {
  if (L == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const size_t cells = (size_t)L * n;
  unsigned long long* words = (unsigned long long*)scratch;
  int* prop = (int*)(words + 2 * cells);
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
        (const int*)match, prop, cur, n, d, group, r);
    match_commit<<<grid_verts, kThreads, 0, s>>>(prop, cur, next,
                                                 (int*)match, n);
  }
  match_singletons<<<grid_verts, kThreads, 0, s>>>((int*)match, n);
  return (int)cudaGetLastError();
}

// The cluster design: one launch, one cluster of C CTAs (1-16) a lane.
extern "C" int matching_cluster_launch(const void* nbr, const void* wgt,
                                       const void* keys, void* match,
                                       void* scratch, int L, int n, int d,
                                       int rounds, int C, void* stream) {
  if (L == 0 || n == 0) return (int)cudaGetLastError();
  const size_t cells = (size_t)L * n;
  unsigned long long* words = (unsigned long long*)scratch;
  int* prop = (int*)(words + 2 * cells);
  uint8_t* role = (uint8_t*)(prop + cells);
  // a lane of one CTA keeps its state in shared memory where it fits
  const size_t smem = (21 * (size_t)n + 15) / 16 * 16;
  const bool shared = C == 1 && smem <= kMaxLaneSmem;
  const cudaError_t err = launch_lanes(
      shared ? match_lanes<true> : match_lanes<false>, L, C,
      shared ? smem : 0, (cudaStream_t)stream, (const int*)nbr,
      (const int*)wgt, (const int64_t*)keys, (int*)match, prop, words, role,
      L, n, d, lane_group(d), rows_vec(nbr, wgt, d), rounds, C);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
