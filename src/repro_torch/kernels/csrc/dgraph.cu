// The distributed plane's device programs: the ELL relaxation, the halo
// exchange, the distributed band BFS and the distributed heavy-edge
// matching, for many same-bucket sharded graphs (lanes) per call.
//
// Replaces:
//   src/repro/kernels/ops.py:93        ell_relax_step (XLA)
//   src/repro/core/dgraph.py:857       halo_exchange_stacked (shard_map)
//   src/repro/core/dgraph.py:953       distributed_bfs_stacked (shard_map)
//   src/repro/core/dgraph.py:1161      distributed_matching_stacked
//
// The reference runs each program under shard_map over a `parts` mesh
// axis, one device a part, and moves ghost values with an all_gather.  On
// one card the parts are a tensor dimension: a lane's P parts are rows
// (L, P, n_loc_max) of one buffer, and an all_gather becomes a read of
// another part's row.  A ghost's owner part is `upper_bound(vtxdist, gid)
// - 1`, clipped to [0, P-1] (dgraph.py:833-837); parts left empty by a
// fold or an induced subgraph repeat a vtxdist entry, and the upper bound
// skips them as the reference's searchsorted(side="right") does.  A ghost
// id of -1 reads 0.  A ghost's lane-local slot is owner * n_loc_max +
// local (local clipped to the row).
//
// halo_exchange (a thread 4 words of a part's row): each part's values,
// then each ghost's at its slot in the DGraph's slot table, which the host
// resolves once a DGraph and keeps on the card; no search at all.
//
// ell_relax (the ids in 16-byte loads, a thread a row of up to 8 ids, a
// group of threads a wider row): out = min over valid slots of ext[id] + 1,
// padding (-1) read as `big`.  In its
// distributed form it is the grid BFS's step: it reads a ghost's value
// straight from its owner's row at the ghost's lane-local slot (the halo
// exchange of the step, fused), and takes the min with the row's old
// distance.
//
// The BFS and the matching run in the design kernels/band_batch.py's
// `lane_plan` picks for a lane of P * n_loc_max rows and d slots, as the
// centralized matching.cu and bfs_multi.cu do:
//
// cluster (one launch a call, up to 2^18 slots a lane): one thread-block
// cluster of C CTAs a lane (cluster.cuh); CTA k owns a power-of-two share
// of the lane's rows and of its ghosts (Place).  The kernel starts its own
// state, resolves each ghost's owner slot once, and runs the steps or
// rounds as phases a lane barrier apart.  The state lives in the CTAs'
// shared memory where each share fits, a row of another CTA read over
// distributed shared memory; else in device memory through L2.
//   dbfs_lanes    `width` synchronous steps, each reading the previous
//                 step's buffer and writing the other (the last lands in
//                 the output): min(old, min over slots + 1), a ghost read
//                 from its owner's row, BIG for padding;
//   dmatch_lanes  per round, propose (+ grant) | commit, or with a cap
//                 propose | rank | grant | commit.  Each row keeps its
//                 round role in a byte (off: padding or matched, proposer,
//                 acceptor), drawn once a round in the commit; a ghost
//                 whose owner row has its gid is that row's role byte, so
//                 a proposer reads a byte a neighbour and hashes only its
//                 candidates' tie breaks.  The winner words take atomics
//                 from every CTA, so with C > 1 they stay in device
//                 memory.
//
// grid (lanes above 2^18 slots): a launch a phase over the whole card.
//   dbfs          dbfs_init, then ell_relax a step: 1 + width launches;
//   dmatch        dmatch_init, then per round propose and commit, the
//                 grant posted inside propose (1 + 2 * rounds launches);
//                 with a cap, propose counts each 256-row tile's
//                 proposals and a grant launch ranks them, each block
//                 summing its part's earlier tiles (1 + 3 * rounds).
//
// Each design's C entry writes what it enqueued into the caller's
// counts[3]: its own kernels, its ell_relax kernels (the grid BFS's steps)
// and the cluster state's placement; the wrappers add these to their
// launch counts.
//
// A group of devices (core/dgraph.py, make_parts_group: the reference's
// `parts` mesh, make_parts_mesh) holds a lane's P parts in D contiguous
// blocks, block g parts [p0, p1) on member g.  Each member keeps a replica
// of the per-row state of all P parts (L, P, nlm), writes only its own
// parts' rows, and the host copies each member's rows into the others'
// replicas between phases (the reference's all_gather; a peer copy over
// NVLink between cards, a copy inside the card for members on one card).
// So the kernels of the grid designs take a part range: halo_exchange,
// ell_relax (the grid BFS's step) and dbfs_init write the rows of parts
// [p0, p1) only, and read their structure (ELL rows, ghosts: (L, p1 - p0,
// ...)) for those parts alone; the matching's propose and commit run on
// the range's rows, and its grant runs on every part's proposals, which
// the host gathered, so that each member derives the whole winner table,
// as each shard of the reference does, and commits its own rows:
//   dmatch_parts_launch  init (every row's mate -1, the ghosts' slots of
//                        the range); a round: propose over the range (and,
//                        with a cap, the range's proposals ranked and
//                        compacted to (L, P, cap) rows: the gather's
//                        width), then, after the host's gather, post over
//                        all parts' proposals and commit the range:
//                        1 + 3 * rounds launches, 1 + 4 * rounds with a
//                        cap.
// The one-device entries run the same kernels on the range [0, P), the
// grid matching's compiled without the range's index arithmetic (kRange).
//
// The matching's protocol, in both designs (dgraph.py:1015-1131):
//   propose  each unmatched proposer (coin hash_mix(gid, r, seed) & 1)
//            picks its heaviest unmatched acceptor neighbour: the first
//            slot of largest float(w) + hash_unit(gid, tgt, r + 17);
//   grant    each part's proposals in row order, the first `cap` (all
//            when cap == 0; the reference's compact gather keeps these),
//            each posted to its target's winner slot with one 64-bit
//            atomicMax of (order-preserving bits of float(w) +
//            hash_unit(gid, tgt, r + 31), INT_MAX - gid): the largest
//            score, then the smallest gid, as the reference's segment_max
//            then segment_min (dgraph.py:1098-1108);
//   commit   acceptors take their slot's winner, proposers whose target's
//            winner is themselves take their target, and each clears its
//            slot of the next round's table.
// Every phase reads the round's starting mates; each row writes only its
// own.
//
// What bounds them on an H100: the halo and the relaxation move bytes
// once, and below a few MB take the launch floor; the BFS and the matching,
// at the main path's buckets, neither bytes nor operations (a few MB and a
// few tens of M hash operations a call, each under a microsecond) but the
// chain of dependent phases: launches in the grid design; in the cluster
// design each phase's dependent loads and hashes on C SMs, and its lane
// barrier (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (build.py).
// Float sums are single adds, so no contraction can change a bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kThreads = 256;  // the grid designs' block
constexpr int kBig = 1 << 30;  // the distributed BFS's unreached distance
constexpr uint32_t kIntMax = 0x7FFFFFFFu;
// a row's round role in the cluster matching
constexpr uint8_t kOff = 0, kProposer = 1, kAcceptor = 2;

__host__ __device__ inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// lowbias32, the reference's hash_u32
__device__ __forceinline__ uint32_t lowbias(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t mix_step(uint32_t h, uint32_t x) {
  return lowbias(h ^ (x * 0x85EBCA6Bu + 1u));
}

// hash_mix(a, b, c): the chain over three values taken mod 2^32
__device__ __forceinline__ uint32_t hash_mix3(int a, int b, uint32_t c) {
  return mix_step(mix_step(mix_step(0x9E3779B9u, (uint32_t)a), (uint32_t)b),
                  c);
}

// hash_unit: the hash rounded to float32 (to nearest), times 2^-32
__device__ __forceinline__ float unit_of(uint32_t h) {
  return __fmul_rn(__uint2float_rn(h), 0x1p-32f);
}

__device__ __forceinline__ float hash_unit3(int a, int b, uint32_t c) {
  return unit_of(hash_mix3(a, b, c));
}

// The chain's first step, hash_mix(a, ...)'s state after a: a row keeps
// it for its gid, so each of its hashes costs two steps.
__device__ __forceinline__ uint32_t hash_head(int a) {
  return mix_step(0x9E3779B9u, (uint32_t)a);
}

// An order-preserving unsigned image of a float (no NaN arises here).
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The grant word of proposer `gid` at weight w, given its target's hash
// state pair = mix_step(hash_head(gid), tg), in round r.
__device__ __forceinline__ unsigned long long grant_word(float w, int gid,
                                                         uint32_t pair,
                                                         int r) {
  const float score = __fadd_rn(w, unit_of(mix_step(pair, r + 31)));
  return ((unsigned long long)ordered(score) << 32) |
         (kIntMax - (uint32_t)gid);
}

// The owner part of global id g >= 0 in a lane's ranges vd (P + 1
// entries): upper_bound - 1, clipped to [0, P - 1].
__device__ __forceinline__ int owner_of(const int* vd, int P, int g) {
  int lo = 0, hi = P + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (vd[mid] <= g) lo = mid + 1; else hi = mid;
  }
  return min(max(lo - 1, 0), P - 1);
}

// The slot (owner, local) of global id g >= 0 in a lane's (P, nlm) rows.
__device__ __forceinline__ int lane_slot(const int* vd, int P, int nlm,
                                         int g) {
  const int o = owner_of(vd, P, g);
  return o * nlm + min(max(g - vd[o], 0), nlm - 1);
}

// The flat slot of global id g in lane l's rows, or -1 for g < 0 (a ghost
// that reads 0).
__device__ __forceinline__ int64_t slot_of(const int* vd, int P, int nlm,
                                           int64_t l, int g) {
  if (g < 0) return -1;
  return l * P * (int64_t)nlm + lane_slot(vd, P, nlm, g);
}

// ------------------------------------------------------------ relaxation
// One thread a row of rows (R, n) of ELL ids (R, n, d).  Plain form
// (kDist false): row r reads ext row r of width m.  Distributed form (kDist,
// the grid BFS's step): the rows are those of parts [p0, p0 + pr) of each
// lane, R = L * pr, row r of lane r / pr and part p0 + r % pr; ids < n read
// the part's own row of the lanes' (L, P, n) distances (m == n), ids in
// [n, n + G) read the lane's rows at the ghost's lane-local slot
// gslot[r, id - n] (0 if -1), and the result, min(old, relaxed), goes to
// the part's row of dout.  Ids outside the row read as padding, so no
// input reads outside its buffers.
//
// Bound by bytes: each id is read once, so the row is streamed in 16-byte
// loads (__ldcs, evict-first; kVec: d % 4 == 0 and the ids on 16 bytes) two
// at a time, and every gather of the row is issued before the min; the
// values, read again by neighbouring rows, go through the read-only path
// (__ldg) and keep the caches.  A row of more than 8 ids is read by a group
// of threads (lane_group: 2 to 32, 8 ids each), whose minimum is taken with
// shuffles, so that no thread waits on more than one load and one gather
// in turn.  A row of d % 4 != 0 takes scalar loads, one thread a row.
struct Relax {
  const int* nbr;
  const int* din;
  int* dout;
  const int* gslot;  // (R, G) lane-local slots, kDist only
  int64_t rows;      // R
  int P, n, d, G, big;
  int p0, pr;        // the part range [p0, p0 + pr), kDist only
  int64_t m;
};

// The value a slot id c of row r reads, `big` for padding.
template <bool kDist>
__device__ __forceinline__ int relax_read(const Relax& a, const int* ext,
                                          const int* lane, const int* gs,
                                          int c) {
  if (kDist && c >= a.n) {
    if (c - a.n >= a.G) return a.big;
    const int s = __ldg(gs + (c - a.n));
    return s >= 0 ? __ldg(lane + s) : 0;
  }
  return (unsigned)c < (unsigned)a.m ? __ldg(ext + c) : a.big;
}

template <bool kDist>
__device__ __forceinline__ int relax_min4(const Relax& a, const int* ext,
                                          const int* lane, const int* gs,
                                          int4 q) {
  return min(min(relax_read<kDist>(a, ext, lane, gs, q.x),
                 relax_read<kDist>(a, ext, lane, gs, q.y)),
             min(relax_read<kDist>(a, ext, lane, gs, q.z),
                 relax_read<kDist>(a, ext, lane, gs, q.w)));
}

// Row t's index r = t / n: a 32-bit division where the rows allow it.
__device__ __forceinline__ int64_t row_index(int64_t t, int n, bool narrow) {
  return narrow ? (int64_t)((uint32_t)t / (uint32_t)n) : t / n;
}

// kGroup: 2^gshift threads a row (at most 32, so a group never spans two
// warps) on the vector path; else one thread a row, with its two 16-byte
// loads in flight (kVec) or its scalar loads.
template <bool kVec, bool kGroup, bool kDist>
__global__ void __launch_bounds__(kThreads) ell_relax(Relax a, int gshift) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t cells = a.rows * a.n;
  const int64_t t = kGroup ? tid >> gshift : tid;
  if constexpr (!kGroup) {
    if (t >= cells) return;
  }
  const bool live = t < cells;
  const int64_t r = live ? row_index(t, a.n, cells <= 0xFFFFFFFFll) : 0;
  // the row's place in the lanes' (L, P, n) rows: r itself in plain form
  // and on the whole range (one device)
  const bool whole = !kDist || a.pr == a.P;
  const int64_t l = kDist ? r / a.pr : 0;
  const int64_t rg = whole ? r : r + l * (a.P - a.pr) + a.p0;
  const int* ext = a.din + rg * a.m;
  const int* lane = kDist ? a.din + l * a.P * a.m : nullptr;
  const int* gs = kDist ? a.gslot + r * a.G : nullptr;
  const int4* row4 = reinterpret_cast<const int4*>(a.nbr + t * a.d);
  int best = a.big;
  if constexpr (kGroup) {
    const int group = 1 << gshift;
    const int q = live ? a.d / 4 : 0;
    const int sub = (int)tid & (group - 1);
    for (int c = 2 * sub; c < q; c += 2 * group) {  // 2 loads, 8 gathers
      const int4 u = __ldcs(row4 + c);
      const int4 w = c + 1 < q ? __ldcs(row4 + c + 1) : make_int4(-1, -1, -1, -1);
      best = min(best, min(relax_min4<kDist>(a, ext, lane, gs, u),
                           relax_min4<kDist>(a, ext, lane, gs, w)));
    }
    for (int off = group / 2; off > 0; off /= 2)
      best = min(best, __shfl_down_sync(0xffffffffu, best, off, group));
    if (!live || sub != 0) return;
  } else if constexpr (kVec) {
    const int q = a.d / 4;
    int c = 0;
    for (; c + 1 < q; c += 2) {  // two loads in flight, then 8 gathers
      const int4 u = __ldcs(row4 + c), w = __ldcs(row4 + c + 1);
      best = min(best, min(relax_min4<kDist>(a, ext, lane, gs, u),
                           relax_min4<kDist>(a, ext, lane, gs, w)));
    }
    if (c < q)
      best = min(best, relax_min4<kDist>(a, ext, lane, gs, __ldcs(row4 + c)));
  } else {
    const int* row = a.nbr + t * a.d;
    for (int s = 0; s < a.d; ++s)
      best = min(best, relax_read<kDist>(a, ext, lane, gs, __ldcs(row + s)));
  }
  if constexpr (kDist)
    a.dout[whole ? t : rg * a.n + (t - r * a.n)] =
        min(__ldg(ext + (t - r * a.n)), best + 1);
  else
    a.dout[t] = best + 1;
}

// Launch the relaxation: the vector path where the ids allow it, with a
// group of threads a row above 8 ids.
template <bool kDist>
cudaError_t relax_launch(const Relax& a, cudaStream_t s) {
  const int64_t cells = a.rows * a.n;
  if (cells == 0) return cudaGetLastError();
  int gshift = 0;
  while ((1 << gshift) < lane_group(a.d)) ++gshift;
  if (!rows_vec(a.nbr, a.nbr, a.d))
    ell_relax<false, false, kDist><<<blocks_for(cells), kThreads, 0, s>>>(
        a, 0);
  else if (gshift == 0)
    ell_relax<true, false, kDist><<<blocks_for(cells), kThreads, 0, s>>>(
        a, 0);
  else
    ell_relax<true, true, kDist><<<blocks_for(cells << gshift), kThreads, 0,
                                   s>>>(a, gshift);
  return cudaGetLastError();
}

// ------------------------------------------------------------ halo
// out (L, P, W = nlm + G): each part's own values, then each ghost's owner
// value, read at the ghost's lane-local slot (owner * nlm + local; -1 for a
// padding ghost, and any slot outside the lane's rows, reads 0) in its
// lane's slot table.  A DGraph's table is resolved once on the host and
// kept on the card (core/dgraph.py, ghost_slots), so the kernel searches
// nothing: a ghost is one slot load and one value load.  Each lane's table
// pointer rides in the parameter block (up to kLanes; Hopper takes 32 KB
// of parameters with CUDA 12.1 and later), so lanes of different DGraphs
// need no stacked table.  Calls of up to 8 lanes (every call of the
// distributed ordering) take a 64-byte block, which the card launches
// about 0.6 us sooner than the 32 KB one (PERF.md §6).
//
// Bound by bytes: a thread writes 4 words of a part's out row (kVec: nlm
// and G multiples of 4, every pointer on 16 bytes), its own words in one
// 16-byte load and store, its ghosts' slots in one 16-byte load; else one
// word.  Grid (units / kHaloThreads, p1 - p0, L): small blocks, so that
// even the root bucket's 49,152 words spread over most SMs, and several
// blocks an SM where the work is large.  On a group the call covers the
// member's parts [p0, p1): out is (L, p1 - p0, W), x the lanes' replica of
// all P parts, and each lane's table is still (P, G), read at rows p.
constexpr int kHaloThreads = 128;
constexpr int kHaloLanes = 4000;  // 32,000 bytes of pointers

template <int kLanes>
struct HaloLanes {
  const int* slots[kLanes];
};

// The lanes' pointers are read where the parameters lie (__grid_constant__):
// indexed by the lane, a by-value copy would go to each thread's stack.
template <int kLanes, bool kVec>
__global__ void __launch_bounds__(kHaloThreads)
    halo_exchange(const int* __restrict__ x, int* __restrict__ out, int P,
                  int nlm, int G, int p0,
                  const __grid_constant__ HaloLanes<kLanes> lanes) {
  constexpr int kWords = kVec ? 4 : 1;
  const int W = nlm + G;
  const int k = (blockIdx.x * kHaloThreads + threadIdx.x) * kWords;
  if (k >= W) return;
  const int p = p0 + (int)blockIdx.y, l = blockIdx.z;
  const int* xl = x + (int64_t)l * P * nlm;
  int* o = out + ((int64_t)l * gridDim.y + blockIdx.y) * W + k;
  if (k < nlm) {
    if constexpr (kVec)
      *reinterpret_cast<int4*>(o) =
          __ldg(reinterpret_cast<const int4*>(xl + p * nlm + k));
    else
      *o = __ldg(xl + p * nlm + k);
    return;
  }
  const int* sl = lanes.slots[l] + (int64_t)p * G + (k - nlm);
  const unsigned N = (unsigned)(P * nlm);
  if constexpr (kVec) {
    const int4 s = __ldg(reinterpret_cast<const int4*>(sl));
    *reinterpret_cast<int4*>(o) = make_int4(
        (unsigned)s.x < N ? __ldg(xl + s.x) : 0,
        (unsigned)s.y < N ? __ldg(xl + s.y) : 0,
        (unsigned)s.z < N ? __ldg(xl + s.z) : 0,
        (unsigned)s.w < N ? __ldg(xl + s.w) : 0);
  } else {
    const int s = __ldg(sl);
    *o = (unsigned)s < N ? __ldg(xl + s) : 0;
  }
}

// Whether p can be read and written in 16-byte accesses.
inline bool on16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <int kLanes>
cudaError_t halo_lanes(const int* x, const int* const* slots, int* out,
                       int L, int P, int nlm, int G, int p0, int p1,
                       bool vec, cudaStream_t s) {
  HaloLanes<kLanes> lanes;
  for (int l = 0; l < L; ++l) lanes.slots[l] = slots[l];
  const int units = vec ? (nlm + G) / 4 : nlm + G;
  const dim3 grid((unsigned)((units + kHaloThreads - 1) / kHaloThreads),
                  (unsigned)(p1 - p0), (unsigned)L);
  if (vec)
    halo_exchange<kLanes, true><<<grid, kHaloThreads, 0, s>>>(
        x, out, P, nlm, G, p0, lanes);
  else
    halo_exchange<kLanes, false><<<grid, kHaloThreads, 0, s>>>(
        x, out, P, nlm, G, p0, lanes);
  return cudaGetLastError();
}

// The ghosts' lane-local slots of a call, gslot[l, q, g] (-1 for a padding
// ghost) for the pr parts of a range, resolved by a search over the lane's
// ranges: the grid BFS's.
__device__ __forceinline__ void lane_slots(const int* ghost_gid,
                                           const int* vtxdist, int* gslot,
                                           int64_t t, int P, int pr, int nlm,
                                           int G) {
  const int tg = ghost_gid[t];
  gslot[t] = tg >= 0 ? lane_slot(vtxdist + t / ((int64_t)pr * G) * (P + 1),
                                 P, nlm, tg)
                     : -1;
}

// The ghost table of the grid matching: gidx[l, q, g] = flat owner slot in
// the lanes' (L, P, nlm) rows of ghost g of the range's part q, or -1.
__device__ __forceinline__ void ghost_table(const int* ghost_gid,
                                            const int* vtxdist, int64_t* gidx,
                                            int64_t t, int P, int pr, int nlm,
                                            int G) {
  const int64_t l = t / G / pr;
  gidx[t] = slot_of(vtxdist + l * (P + 1), P, nlm, l, ghost_gid[t]);
}

// ------------------------------------------------------------ BFS, grid
// The sources of parts [p0, p0 + pr) (src, ghost_gid: (L, pr, ...)) into
// their rows of the lanes' (L, P, nlm) distances, and their ghosts' slots.
__global__ void dbfs_init(const int* __restrict__ src,
                          const int* __restrict__ ghost_gid,
                          const int* __restrict__ vtxdist,
                          int* __restrict__ dist, int* __restrict__ gslot,
                          int L, int P, int nlm, int G, int p0, int pr) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t span = (int64_t)pr * nlm;
  const int64_t cells = L * span, ghosts = (int64_t)L * pr * G;
  if (t < cells) {
    int64_t at = t;  // the row in the lanes' (L, P, nlm) rows
    if (pr != P) at += t / span * (P - pr) * nlm + (int64_t)p0 * nlm;
    dist[at] = src[t] != 0 ? 0 : kBig;
  }
  if (t < ghosts) lane_slots(ghost_gid, vtxdist, gslot, t, P, pr, nlm, G);
}

// ------------------------------------------------------------ cluster state
// Where a cluster kernel keeps a lane's per-row (and per-ghost) arrays.
// CTA k of C owns rows [k << shift, (k + 1) << shift) (clipped to the
// lane), so a row's CTA is a shift away, and writes only its own.
//   kL2       each array is the lane's slice of device memory, read
//             through L2 (__ldcg, __stcg);
//   kLocal    a lane of one CTA: each array in its shared memory;
//   kCluster  each CTA holds its rows of each array in its shared memory,
//             and a row of another CTA is read over distributed shared
//             memory; its own rows stay plain shared-memory accesses.
constexpr int kL2 = 0, kLocal = 1, kCluster = 2;

template <int kMode>
struct Place {
  int shift, rank;
  // the element of row v, which this CTA owns
  template <typename T>
  __device__ __forceinline__ T* own(T* base, int v) const {
    return kMode == kCluster ? base + (v - (rank << shift)) : base + v;
  }
  template <typename T>
  __device__ __forceinline__ T ld(T* base, int v) const {
    if constexpr (kMode == kL2) {
      return __ldcg(base + v);
    } else if constexpr (kMode == kLocal) {
      return base[v];
    } else {
      const int k = v >> shift;
      T* p = base + (v - (k << shift));
      if (k == rank) return *p;
      return *cooperative_groups::cluster_group::map_shared_rank(p, k);
    }
  }
  template <typename T>
  __device__ __forceinline__ void st(T* base, int v, T x) const {
    if constexpr (kMode == kL2) {
      __stcg(base + v, x);
    } else {
      *own(base, v) = x;
    }
  }
};

// The smallest s with 2^s * C >= n: each CTA's share of n rows.
__host__ __device__ inline int share_shift(int64_t n, int C) {
  const int64_t per = (n + C - 1) / C;
  int s = 0;
  while (((int64_t)1 << s) < per) ++s;
  return s;
}

// A CTA's first and last + 1 of n items at `shift`.
__device__ __forceinline__ void share(int n, int shift, int rank, int& lo,
                                      int& hi) {
  lo = min((int64_t)n, (int64_t)rank << shift);
  hi = min((int64_t)n, (int64_t)(rank + 1) << shift);
}

// Entries of an array a CTA holds in shared memory: its share, or the
// whole lane when that is smaller.
__host__ __device__ inline int64_t share_cap(int64_t n, int shift) {
  return n < ((int64_t)1 << shift) ? n : ((int64_t)1 << shift);
}

// The placement of a cluster kernel's state of `smem` bytes a CTA: shared
// memory where it fits, else device memory.
inline int placement(size_t smem, int C) {
  return smem > kMaxLaneSmem ? kL2 : C == 1 ? kLocal : kCluster;
}

// What a design's C entry enqueued, into the caller's counts[3]: its own
// kernels, its ell_relax kernels (the grid BFS's steps) and the cluster
// state's placement (kGrid for the grid design).
constexpr int kGrid = -1;
inline void enqueued(int* counts, int own, int relax, int place) {
  counts[0] = own;
  counts[1] = relax;
  counts[2] = place;
}

// ------------------------------------------------------------ BFS, cluster
// One lane a cluster (grid L * C, lane blockIdx.x / C).  The two distance
// buffers a, b and the ghosts' lane slots gs, placed by Place: in the
// CTAs' shared memory, or in device memory as (dist, scratch) and
// gslot_all (L, P, G), the ping-pong started so that the last step lands
// in dist.  A row is read by `group` threads (lane_group), 4 slots at a time,
// whose minimum is taken with shuffles.
template <int kMode>
__global__ void __launch_bounds__(kLaneThreads, 1)
    dbfs_lanes(const int* __restrict__ nbr, const int* __restrict__ src,
               const int* __restrict__ ghost_gid,
               const int* __restrict__ vtxdist, int* dist, int* scratch,
               int* gslot_all, int P, int nlm, int d, int G, int group,
               bool vec, int width, int C, int shift, int gshift) {
  extern __shared__ __align__(16) int lane_buf[];
  const int lane = blockIdx.x / C, rank = blockIdx.x % C;
  const int N = P * nlm, PG = P * G;
  constexpr bool kSmem = kMode != kL2;
  const Place<kMode> at{shift, rank};
  const Place<kMode> gat{gshift, rank};
  int lo, hi, glo, ghi;
  share(N, shift, rank, lo, hi);
  share(PG, gshift, rank, glo, ghi);
  const int64_t base = (int64_t)lane * N, gbase = (int64_t)lane * PG;
  const int* vd = vtxdist + (int64_t)lane * (P + 1);
  int* out = dist + base;
  int* a;
  int* b;
  int* gs;
  if constexpr (kSmem) {
    const int64_t cap = share_cap(N, shift);
    a = lane_buf;
    b = lane_buf + cap;
    gs = lane_buf + 2 * cap;
  } else {
    const int start = width % 2;
    a = start ? scratch + base : out;
    b = start ? out : scratch + base;
    gs = gslot_all + gbase;
  }
  for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    const int d0 = src[base + v] != 0 ? 0 : kBig;
    if (kSmem && width == 0) out[v] = d0;
    else at.st(a, v, d0);
  }
  for (int g = glo + threadIdx.x; g < ghi; g += blockDim.x) {
    const int tg = ghost_gid[gbase + g];
    gat.st(gs, g, tg >= 0 ? lane_slot(vd, P, nlm, tg) : -1);
  }
  const int rows = blockDim.x / group;
  const int sub = threadIdx.x % group;
  for (int k = 0; k < width; ++k) {
    lane_sync(C);
    int* din = k % 2 == 0 ? a : b;
    int* dnext = k % 2 == 0 ? b : a;
    const bool last = kSmem && k == width - 1;  // lands in dist
    for (int v0 = lo; v0 < hi; v0 += rows) {
      const int v = v0 + threadIdx.x / group;
      const int p = v / nlm;
      int best = kBig;
      const int* row = nbr + (base + v) * d;
      for (int c = sub; v < hi && 4 * c < d; c += group) {
        const int4 q = load4(row, c, d, vec, -1);
        const int ids[4] = {q.x, q.y, q.z, q.w};
        int f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // the row read; -2 padding
          const int id = ids[e];
          f[e] = (unsigned)id < (unsigned)nlm ? p * nlm + id
                 : id >= nlm && id - nlm < G ? gat.ld(gs, p * G + (id - nlm))
                                             : -2;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)  // a ghost of id -1 reads 0
          if (f[e] != -2) best = min(best, f[e] >= 0 ? at.ld(din, f[e]) : 0);
      }
      for (int off = group / 2; off > 0; off /= 2)
        best = min(best, __shfl_down_sync(0xffffffffu, best, off, group));
      if (v < hi && sub == 0) {
        const int nd = min(at.ld(din, v), best + 1);
        if (last) out[v] = nd;
        else at.st(dnext, v, nd);
      }
    }
  }
  if (kMode == kCluster) lane_sync(C);  // no CTA leaves while read remotely
}

// ------------------------------------------------------------ matching, grid
// The rows of (L, P, nlm) state (match, prop_tgt, prop_w, tables,
// tile_count) are every part's; the structure (nbr, ewgt, ghost_gid, gidx)
// is that of parts [p0, p0 + pr) alone, (L, pr, ...).  The kernels'
// kRange: a group member's range (else one device's, [0, P), compiled with
// the range's index arithmetic left out).  On one device propose posts the
// grant when cap == 0; on a group the post kernel does, after the gather.
// ctgt, cw, cgid: a group's compacted proposals, (L, P, cap), each part's
// first cap in row order.
struct MatchArgs {
  const int* nbr;
  const int* ewgt;
  const int* ghost_gid;
  const int* vtxdist;
  const int* nloc;
  const int* seeds;
  int* match;
  int64_t* gidx;
  int* prop_tgt;
  float* prop_w;
  int* tile_count;             // (L, P, tiles) proposals a 256-row tile
  unsigned long long* tables;  // two (L, P, nlm) winner tables
  int* ctgt;
  float* cw;
  int* cgid;
  int L, P, nlm, d, G, cap, tiles, p0, pr;
};

// Every row's mate -1 and round 0's table empty (all P parts: each member
// of a group knows them), the range's ghosts' slots.
__global__ void dmatch_init(MatchArgs a) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t cells = (int64_t)a.L * a.P * a.nlm;
  if (t < cells) {
    a.match[t] = -1;
    a.tables[t] = 0ull;
  }
  if (t < (int64_t)a.L * a.pr * a.G)
    ghost_table(a.ghost_gid, a.vtxdist, a.gidx, t, a.P, a.pr, a.nlm, a.G);
}

// The flat (L, P) part of the range's part lpl (of L * pr): lpl itself on
// one device.
template <bool kRange>
__device__ __forceinline__ int64_t part_of(const MatchArgs& a, int64_t lpl) {
  if (!kRange) return lpl;
  const int64_t l = lpl / a.pr;
  return l * a.P + a.p0 + (lpl - l * a.pr);
}

// A row's identity: its lane, part (flat lp of the lanes' parts, lpl of the
// range's), local index, state row t, global id (-1 on padding) and
// whether it is unmatched at the round's start.
struct Row {
  int64_t l, lp, lpl, t;
  int i, lo, nloc, gid;
  bool unmatched;
  uint32_t seed;
};

// Row tl of the range's (L, pr, nlm) rows.
template <bool kRange>
__device__ __forceinline__ Row row_of(const MatchArgs& a, int64_t tl) {
  Row w;
  w.lpl = tl / a.nlm;
  w.i = (int)(tl - w.lpl * a.nlm);
  w.lp = part_of<kRange>(a, w.lpl);
  w.l = w.lp / a.P;
  w.t = w.lp * a.nlm + w.i;
  const int p = (int)(w.lp - w.l * a.P);
  w.lo = a.vtxdist[w.l * (a.P + 1) + p];
  w.nloc = a.nloc[w.lp];
  w.gid = w.i < w.nloc ? w.lo + w.i : -1;
  w.unmatched = w.i < w.nloc && a.match[w.t] < 0;
  w.seed = (uint32_t)a.seeds[w.l];
  return w;
}

// A grid of (tiles, L * pr): block (k, lpl) proposes for rows k * 256 ..
// of the range's part lpl, so no tile spans two parts.  With cap == 0, on
// one device, each proposal is posted here; otherwise the tile's proposal
// count is kept for the grant.  A group's compacted rows of the part are
// cleared here for the grant to fill.
template <bool kRange>
__global__ void dmatch_propose(MatchArgs a, int r,
                               unsigned long long* __restrict__ table) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int64_t lpl = blockIdx.y;
  const int64_t lp = part_of<kRange>(a, lpl);
  const int64_t tl = lpl * a.nlm + i;
  int tgt = -1;
  float wsel = 0.f;
  Row w;
  if (kRange && a.ctgt != nullptr && i < a.cap) a.ctgt[lp * a.cap + i] = -1;
  if (i < a.nlm) {
    w = row_of<kRange>(a, tl);
    if (w.unmatched && (hash_mix3(w.gid, r, w.seed) & 1u)) {
      float best = -INFINITY;
      const int* row = a.nbr + tl * a.d;
      const int* ew = a.ewgt + tl * a.d;
      for (int s = 0; s < a.d; ++s) {
        const int c = row[s];
        if (c < 0 || c >= a.nlm + a.G) continue;  // padding, or no slot
        int tg;
        bool un;
        if (c < a.nlm) {
          tg = c < w.nloc ? w.lo + c : -1;
          un = c < w.nloc && a.match[w.lp * a.nlm + c] < 0;
        } else {
          tg = a.ghost_gid[lpl * a.G + (c - a.nlm)];
          const int64_t f = a.gidx[lpl * a.G + (c - a.nlm)];
          un = false;
          if (f >= 0) {
            const int64_t olp = f / a.nlm;
            un = (int)(f - olp * a.nlm) < a.nloc[olp] && a.match[f] < 0;
          }
        }
        if (!un || tg < 0 || (hash_mix3(tg, r, w.seed) & 1u)) continue;
        const float score =
            __fadd_rn(__int2float_rn(ew[s]), hash_unit3(w.gid, tg, r + 17));
        if (score > best) {  // the first slot of largest score
          best = score;
          tgt = tg;
          wsel = __int2float_rn(ew[s]);
        }
      }
    }
    a.prop_tgt[w.t] = tgt;
    a.prop_w[w.t] = wsel;
    if (!kRange && tgt >= 0 && a.cap == 0)
      atomicMax(table + slot_of(a.vtxdist + w.l * (a.P + 1), a.P, a.nlm,
                                w.l, tgt),
                grant_word(wsel, w.gid, mix_step(hash_head(w.gid), tgt), r));
  }
  if (a.cap > 0) {
    const int n = __syncthreads_count(tgt >= 0);
    if (threadIdx.x == 0) a.tile_count[lp * a.tiles + blockIdx.x] = n;
  }
}

// With cap > 0, over the propose grid: block (k, lpl) sums its part's
// proposals on tiles 0 .. k - 1, ranks its own in row order with a block
// scan, and posts those ranked below the cap (kCompact: writes them to the
// part's compacted rows at their rank instead, for a group's gather).
template <bool kCompact>
__global__ void dmatch_grant(MatchArgs a, int r,
                             unsigned long long* __restrict__ table) {
  __shared__ int warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t lp = part_of<kCompact>(a, blockIdx.y);
  int before = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += kThreads)
    before += a.tile_count[lp * a.tiles + j];
  for (int off = 16; off > 0; off /= 2)
    before += __shfl_down_sync(0xffffffffu, before, off);
  if (lane == 0) warp_sum[warp] = before;
  __syncthreads();
  int earlier = 0;
  for (int k = 0; k < kThreads / 32; ++k) earlier += warp_sum[k];
  if (earlier >= a.cap) return;  // the whole tile is past the cap
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int64_t t = lp * a.nlm + i;
  const int tg = i < a.nlm ? a.prop_tgt[t] : -1;
  const unsigned ballot = __ballot_sync(0xffffffffu, tg >= 0);
  if (lane == 0) warp_sum[warp] = __popc(ballot);
  __syncthreads();
  int rank = earlier + __popc(ballot & ((1u << lane) - 1u));
  for (int k = 0; k < warp; ++k) rank += warp_sum[k];
  if (tg < 0 || rank >= a.cap) return;
  const int64_t l = lp / a.P;
  const int* vd = a.vtxdist + l * (a.P + 1);
  const int gid = vd[lp - l * a.P] + i;
  if constexpr (kCompact) {
    const int64_t c = lp * a.cap + rank;
    a.ctgt[c] = tg;
    a.cw[c] = a.prop_w[t];
    a.cgid[c] = gid;
  } else {
    atomicMax(table + slot_of(vd, a.P, a.nlm, l, tg),
              grant_word(a.prop_w[t], gid, mix_step(hash_head(gid), tg), r));
  }
}

// A group's grant, after the gather: every part's proposals (prop_tgt and
// prop_w, or with cap > 0 the compacted rows) posted to this member's
// winner table, so that it holds the whole lanes' winners; and the next
// round's table cleared (every row, not only the range's).
__global__ void dmatch_post(MatchArgs a, int r,
                           unsigned long long* __restrict__ table,
                           unsigned long long* __restrict__ next) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t cells = (int64_t)a.L * a.P * a.nlm;
  if (t < cells) next[t] = 0ull;
  int tg, gid;
  float w;
  int64_t l;
  if (a.cap == 0) {
    if (t >= cells) return;
    tg = a.prop_tgt[t];
    const int64_t lp = t / a.nlm;
    l = lp / a.P;
    gid = a.vtxdist[l * (a.P + 1) + (lp - l * a.P)] + (int)(t - lp * a.nlm);
    w = a.prop_w[t];
  } else {
    if (t >= (int64_t)a.L * a.P * a.cap) return;
    tg = a.ctgt[t];
    l = t / ((int64_t)a.P * a.cap);
    gid = a.cgid[t];
    w = a.cw[t];
  }
  if (tg < 0) return;
  const int* vd = a.vtxdist + l * (a.P + 1);
  atomicMax(table + slot_of(vd, a.P, a.nlm, l, tg),
            grant_word(w, gid, mix_step(hash_head(gid), tg), r));
}

// Over the range's (L, pr, nlm) rows.
template <bool kRange>
__global__ void dmatch_commit(MatchArgs a, int r,
                              const unsigned long long* __restrict__ table,
                              unsigned long long* __restrict__ next) {
  const int64_t tl = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (tl >= (int64_t)a.L * a.pr * a.nlm) return;
  const Row w = row_of<kRange>(a, tl);
  const int64_t t = w.t;
  const bool proposer = (hash_mix3(w.gid, r, w.seed) & 1u) != 0;
  int mate = a.match[t];
  const int tg = a.prop_tgt[t];
  if (tg >= 0) {
    const unsigned long long win =
        table[slot_of(a.vtxdist + w.l * (a.P + 1), a.P, a.nlm, w.l, tg)];
    if (win != 0ull && (int)(kIntMax - (uint32_t)win) == w.gid) mate = tg;
  }
  const unsigned long long mine = table[t];
  if (w.unmatched && !proposer && mine != 0ull)
    mate = (int)(kIntMax - (uint32_t)mine);
  a.match[t] = mate;
  next[t] = 0ull;
}

// ----------------------------------------------------------- matching, cluster
// The arguments of dmatch_lanes.  The lane's state, placed by Place:
// prop, pslot, pw (float), pre a row; gslot (ghost_code) a ghost; role a
// row (a byte).  In shared memory 17 bytes a row and 4 a ghost of each
// CTA's share; in device memory the scratch's ints: prop, pslot, pw, pre
// (4, L, N), gslot (L, P * G), and role (L, N) bytes; N = P * nlm.  The
// winner words cur, nxt (u64), which every CTA posts to, are in shared
// memory (16 bytes a row, first) only with kLocal, else in the scratch
// (2, L, N).  Each CTA's proposals a
// part, cnt, and its rank base a part, pbase, are in the scratch: cnt,
// pbase (2, L, C, P) int32 after the ints.
struct LaneMatch {
  const int* nbr;
  const int* ewgt;
  const int* ghost_gid;
  const int* vtxdist;
  const int* nloc;
  const int* seeds;
  int* match;
  unsigned long long* words;
  int* ints;
  int* counts;
  uint8_t* role;
  int L, P, nlm, d, G, rounds, cap, C, group, shift, gshift;
  bool vec;
};

__device__ __forceinline__ uint8_t role_of(uint32_t head, int r,
                                           uint32_t seed) {
  return (mix_step(mix_step(head, r), seed) & 1u) ? kProposer : kAcceptor;
}

// A ghost's code, resolved once a call: its owner slot f when the owner
// row is real and has the ghost's gid (its role byte then holds the
// ghost's coin too), -2 - f when the row is real under another gid (the
// ghost's coin is drawn each round), -1 when no real row answers.
__device__ __forceinline__ int ghost_code(const int* vd, const int* nl,
                                          int P, int nlm, int tg) {
  if (tg < 0) return -1;
  const int f = lane_slot(vd, P, nlm, tg);
  const int o = f / nlm, i = f - o * nlm;
  if (i >= nl[o]) return -1;
  return vd[o] + i == tg ? f : -2 - f;
}

// One lane a cluster (grid L * C, lane blockIdx.x / C).
template <int kMode>
__global__ void __launch_bounds__(kLaneThreads, 1)
    dmatch_lanes(LaneMatch a) {
  extern __shared__ __align__(16) unsigned char lane_state[];
  __shared__ int warp_sum[kLaneThreads / 32];
  const int C = a.C, P = a.P, nlm = a.nlm, G = a.G, d = a.d;
  const int lane = blockIdx.x / C, rank = blockIdx.x % C;
  const int N = P * nlm, PG = P * G;
  const int64_t L = a.L, cells = L * N;
  constexpr bool kSmem = kMode != kL2;
  const Place<kMode> at{a.shift, rank};
  const Place<kMode> gat{a.gshift, rank};
  int lo, hi, glo, ghi;
  share(N, a.shift, rank, lo, hi);
  share(PG, a.gshift, rank, glo, ghi);
  const int64_t base = (int64_t)lane * N, gbase = (int64_t)lane * PG;
  const int* vd = a.vtxdist + (int64_t)lane * (P + 1);
  const int* nl = a.nloc + (int64_t)lane * P;
  const int* gg = a.ghost_gid + gbase;
  const uint32_t seed = (uint32_t)a.seeds[lane];
  int* m = a.match + base;
  // the winner words of this round (cur) and of the next (nxt), swapped
  // each round
  unsigned long long* cur;
  unsigned long long* nxt;
  int *prop, *pslot, *pre, *gslot;
  float* pw;
  uint8_t* ro;
  // the winner words take posts from every CTA: in shared memory only
  // when the lane has one CTA, else in device memory (atomics in L2)
  constexpr bool words_smem = kMode == kLocal;
  if constexpr (words_smem) {
    cur = reinterpret_cast<unsigned long long*>(lane_state);
    nxt = cur + N;
  } else {
    cur = a.words + base;
    nxt = a.words + cells + base;
  }
  if constexpr (kSmem) {
    const int64_t cap = share_cap(N, a.shift), gcap = share_cap(PG, a.gshift);
    prop = reinterpret_cast<int*>(lane_state + (words_smem ? 16 * cap : 0));
    pslot = prop + cap;
    pw = reinterpret_cast<float*>(pslot + cap);
    pre = reinterpret_cast<int*>(pw + cap);
    gslot = pre + cap;
    ro = reinterpret_cast<uint8_t*>(gslot + gcap);
  } else {
    prop = a.ints + base;
    pslot = a.ints + cells + base;
    pw = reinterpret_cast<float*>(a.ints + 2 * cells) + base;
    pre = a.ints + 3 * cells + base;
    gslot = a.ints + 4 * cells + gbase;
    ro = a.role + base;
  }
  const auto wld = [](const unsigned long long* w) {
    if constexpr (words_smem) return *w; else return __ldcg(w);
  };
  const auto wst = [](unsigned long long* w) {
    if constexpr (words_smem) *w = 0ull; else __stcg(w, 0ull);
  };
  int* cnt = a.counts + (int64_t)lane * C * P;
  int* pbase = a.counts + L * C * P + ((int64_t)lane * C + rank) * P;
  // start: mates -1, round 0's roles, round 0's words empty, the ghosts'
  // codes
  for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    const int p = v / nlm, i = v - p * nlm;
    __stcg(m + v, -1);
    at.st(ro, v, a.rounds > 0 && i < nl[p]
                     ? role_of(hash_head(vd[p] + i), 0, seed) : kOff);
    wst(cur + v);
  }
  for (int g = glo + threadIdx.x; g < ghi; g += blockDim.x)
    gat.st(gslot, g, ghost_code(vd, nl, P, nlm, gg[g]));
  const int rows = blockDim.x / a.group;
  const int sub = threadIdx.x % a.group;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < a.rounds; ++r) {
    lane_sync(C);
    // propose (+ the grant when cap == 0): a group of threads a row, each
    // reading up to 8 slots, 4 at a time, whose neighbours' roles are
    // loaded together; only candidates draw a tie break
    for (int v0 = lo; v0 < hi; v0 += rows) {
      const int v = v0 + threadIdx.x / a.group;
      const bool proposer = v < hi && at.ld(ro, v) == kProposer;
      const int p = v / nlm;
      const int gid = vd[min(p, P - 1)] + (v - p * nlm);
      const uint32_t head = hash_head(gid);
      const int* nrow = a.nbr + (base + v) * d;
      const int* wrow = a.ewgt + (base + v) * d;
      float best_score = -INFINITY;
      int best_slot = -1, best_t = -1, best_w = 0, best_f = -1;
      uint32_t best_pair = 0;
      for (int c = sub; proposer && 4 * c < d; c += a.group) {
        const int4 q = load4(nrow, c, d, a.vec, -1);
        const int4 qw = load4(wrow, c, d, a.vec, 0);  // in flight with q
        const int ids[4] = {q.x, q.y, q.z, q.w};
        const int ws[4] = {qw.x, qw.y, qw.z, qw.w};
        int f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // a row's slot, a ghost's code
          const int id = ids[e];
          f[e] = (unsigned)id < (unsigned)nlm ? p * nlm + id
                 : id >= nlm && id - nlm < G ? gat.ld(gslot, p * G + (id - nlm))
                                             : -1;
        }
        bool acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int fe = f[e] >= -1 ? f[e] : -2 - f[e];
          const uint8_t rf = fe >= 0 ? at.ld(ro, fe) : kOff;
          acc[e] = f[e] >= -1 ? rf == kAcceptor : rf != kOff;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!acc[e]) continue;
          const int j = 4 * c + e;
          const bool own = ids[e] < nlm;
          const int tg = own ? vd[p] + ids[e] : gg[p * G + (ids[e] - nlm)];
          // a ghost whose owner row has another gid: its own coin
          if (f[e] < -1 && (hash_mix3(tg, r, seed) & 1u)) continue;
          const uint32_t pair = mix_step(head, tg);
          const float score = __fadd_rn(__int2float_rn(ws[e]),
                                        unit_of(mix_step(pair, r + 17)));
          if (best_slot < 0 || score > best_score) {  // first maximal slot
            best_score = score;
            best_slot = j;
            best_t = tg;
            best_w = ws[e];
            best_pair = pair;
            // the target's owner slot: a ghost's is its code's; a row's
            // own part's unless vtxdist ends the part before it
            const bool past = p + 1 < P && tg >= vd[p + 1];
            best_f = !own ? (f[e] >= 0 ? f[e] : -2 - f[e])
                     : past ? lane_slot(vd, P, nlm, tg) : f[e];
          }
        }
      }
      for (int off = a.group / 2; off > 0; off /= 2) {
        const float s = __shfl_down_sync(0xffffffffu, best_score, off, a.group);
        const int j = __shfl_down_sync(0xffffffffu, best_slot, off, a.group);
        const int tg = __shfl_down_sync(0xffffffffu, best_t, off, a.group);
        const int wj = __shfl_down_sync(0xffffffffu, best_w, off, a.group);
        const uint32_t pr =
            __shfl_down_sync(0xffffffffu, best_pair, off, a.group);
        const int fj = __shfl_down_sync(0xffffffffu, best_f, off, a.group);
        if (j >= 0 && (best_slot < 0 || s > best_score ||
                       (s == best_score && j < best_slot))) {
          best_score = s;
          best_slot = j;
          best_t = tg;
          best_w = wj;
          best_pair = pr;
          best_f = fj;
        }
      }
      if (!proposer || sub != 0) continue;
      at.st(prop, v, best_t);
      if (best_slot < 0) continue;
      const int f = best_f;
      at.st(pslot, v, f);
      if (a.cap == 0)
        atomicMax(cur + f,
                  grant_word(__int2float_rn(best_w), gid, best_pair, r));
      else
        at.st(pw, v, __int2float_rn(best_w));
    }
    if (a.cap > 0) {
      // rank: pre[v] = this CTA's proposals on rows lo .. v - 1, by a
      // block scan in row order
      __syncthreads();
      int running = 0;
      for (int v0 = lo; v0 < hi; v0 += blockDim.x) {
        const int v = v0 + threadIdx.x;
        const bool has =
            v < hi && at.ld(ro, v) == kProposer && at.ld(prop, v) >= 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, has);
        if (wl == 0) warp_sum[warp] = __popc(ballot);
        __syncthreads();
        int before = running + __popc(ballot & ((1u << wl) - 1u)), total = 0;
        for (int k = 0; k < kLaneThreads / 32; ++k) {
          if (k < warp) before += warp_sum[k];
          total += warp_sum[k];
        }
        if (v < hi) at.st(pre, v, before);
        __syncthreads();
        running += total;
      }
      // publish this CTA's proposals a part; a part's rows are contiguous
      for (int q = threadIdx.x; q < P; q += blockDim.x) {
        const int s = max(lo, q * nlm), e = min(hi, (q + 1) * nlm);
        const int n =
            s < e ? (e < hi ? at.ld(pre, e) : running) - at.ld(pre, s) : 0;
        __stcg(cnt + rank * P + q, n);
      }
      lane_sync(C);
      // a proposal's rank in its part: the part's proposals on earlier
      // CTAs, plus this CTA's before it
      for (int q = threadIdx.x; q < P; q += blockDim.x) {
        const int s = max(lo, q * nlm);
        if (s >= min(hi, (q + 1) * nlm)) continue;
        int before = 0;
        for (int k = 0; k < rank; ++k) before += __ldcg(cnt + k * P + q);
        __stcg(pbase + q, before - at.ld(pre, s));
      }
      __syncthreads();
      for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
        if (at.ld(ro, v) != kProposer) continue;
        const int tg = at.ld(prop, v);
        if (tg < 0) continue;
        const int p = v / nlm;
        if (__ldcg(pbase + p) + at.ld(pre, v) >= a.cap) continue;
        const int gid = vd[p] + (v - p * nlm);
        atomicMax(cur + at.ld(pslot, v),
                  grant_word(at.ld(pw, v), gid, mix_step(hash_head(gid), tg),
                             r));
      }
    }
    lane_sync(C);
    // commit: each row writes its own mate and next round's role, and
    // clears its slot of the next round's words
    const bool more = r + 1 < a.rounds;
    for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
      const uint8_t rv = at.ld(ro, v);
      if (rv != kOff) {
        const int p = v / nlm;
        const int gid = vd[p] + (v - p * nlm);
        int mate = -1;
        if (rv == kAcceptor) {
          const unsigned long long w = wld(cur + v);
          if (w != 0ull) mate = (int)(kIntMax - (uint32_t)w);
        } else {
          const int tg = at.ld(prop, v);
          if (tg >= 0) {
            const unsigned long long w = wld(cur + at.ld(pslot, v));
            if (w != 0ull && (uint32_t)w == kIntMax - (uint32_t)gid) mate = tg;
          }
        }
        if (mate >= 0) __stcg(m + v, mate);
        if (more)
          at.st(ro, v, mate >= 0 ? kOff : role_of(hash_head(gid), r + 1, seed));
      }
      wst(nxt + v);
    }
    unsigned long long* const used = cur;
    cur = nxt;
    nxt = used;
  }
  if (kMode == kCluster) lane_sync(C);  // no CTA leaves while read remotely
}

// The launch floor: a kernel that does nothing, to time what any launch
// of this library costs the card.
__global__ void empty() {}

}  // namespace

// One launch of an empty kernel (one warp).
extern "C" int empty_launch(void* stream) {
  empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// ext (L, m), nbr (L, n, d) -> out (L, n): one launch.
extern "C" int ell_relax_launch(const void* nbr, const void* ext, void* out,
                                int L, int n, int d, int m, int big,
                                void* stream) {
  const Relax a{(const int*)nbr, (const int*)ext, (int*)out, nullptr, L,
                1, n, d, 0, big, 0, 1, m};
  return (int)relax_launch<false>(a, (cudaStream_t)stream);
}

// The distributed relaxation of parts [p0, p0 + pr) of each of L lanes of
// P parts against a replica of every part's rows (din, dout set a step).
inline Relax dist_relax(const void* nbr, const void* gslot, int L, int P,
                        int nlm, int d, int G, int p0, int pr) {
  return Relax{(const int*)nbr, nullptr, nullptr, (const int*)gslot,
               (int64_t)L * pr, P, nlm, d, G, kBig, p0, pr, nlm};
}

// Whether [p0, p1) is a part range of P parts.
inline bool parts_ok(int P, int p0, int p1) {
  return P >= 1 && 0 <= p0 && p0 < p1 && p1 <= P;
}

// x (L, P, nlm), slots: a host array of L pointers, lane l's (P, G) int32
// slot table -> out (L, p1 - p0, nlm + G), the rows of parts [p0, p1): one
// launch, 1 <= L <= kHaloLanes.
extern "C" int halo_parts_launch(const void* x, const void* slots, void* out,
                                 int L, int P, int nlm, int G, int p0, int p1,
                                 void* stream) {
  if (L < 1 || L > kHaloLanes || P > 65535 || nlm < 1 || G < 0 ||
      !parts_ok(P, p0, p1))
    return (int)cudaErrorInvalidValue;
  const int* const* tables = (const int* const*)slots;
  bool vec = nlm % 4 == 0 && G % 4 == 0 && on16(x) && on16(out);
  for (int l = 0; vec && l < L; ++l) vec = on16(tables[l]);
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      L <= 8 ? halo_lanes<8>((const int*)x, tables, (int*)out, L, P, nlm, G,
                             p0, p1, vec, s)
             : halo_lanes<kHaloLanes>((const int*)x, tables, (int*)out, L, P,
                                      nlm, G, p0, p1, vec, s);
  return (int)err;
}

// nbr (L, P, nlm, d), src (L, P, nlm) -> dist (L, P, nlm) after `width`
// synchronous steps.  scratch: a second (L, P, nlm) int32 buffer; gslot:
// (L, P, G) int32.

// The grid design: 1 + width launches, dbfs_init (the sources and the
// ghosts' lane-local slots), then ell_relax in its distributed form a step.
extern "C" int dbfs_launch(const void* nbr, const void* src,
                           const void* ghost_gid, const void* vtxdist,
                           void* dist, void* scratch, void* gslot, int L,
                           int P, int nlm, int d, int G, int width,
                           int* counts, void* stream) {
  const int64_t cells = (int64_t)L * P * nlm;
  enqueued(counts, 0, 0, kGrid);
  if (cells == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* bufs[2] = {(int*)dist, (int*)scratch};
  const int start = width % 2;  // the last step lands in `dist`
  const int64_t ghosts = (int64_t)L * P * G;
  dbfs_init<<<blocks_for(cells > ghosts ? cells : ghosts), kThreads, 0, s>>>(
      (const int*)src, (const int*)ghost_gid, (const int*)vtxdist,
      bufs[start], (int*)gslot, L, P, nlm, G, 0, P);
  Relax a = dist_relax(nbr, gslot, L, P, nlm, d, G, 0, P);
  for (int k = 0; k < width; ++k) {
    a.din = bufs[(start + k) % 2];
    a.dout = bufs[(start + k + 1) % 2];
    relax_launch<true>(a, s);
  }
  enqueued(counts, 1, width, kGrid);
  return (int)cudaGetLastError();
}

// A group member's BFS, parts [p0, p1) of each lane (core/dgraph.py drives
// the steps and the gathers between them).  The init: src (L, p1 - p0,
// nlm) into the parts' rows of dist (L, P, nlm), and gslot (L, p1 - p0, G)
// the parts' ghosts' lane-local slots (ghost_gid (L, p1 - p0, G)).  One
// launch.
extern "C" int dbfs_parts_init_launch(const void* src, const void* ghost_gid,
                                      const void* vtxdist, void* dist,
                                      void* gslot, int L, int P, int nlm,
                                      int G, int p0, int p1, void* stream) {
  if (L < 0 || nlm < 1 || G < 0 || !parts_ok(P, p0, p1))
    return (int)cudaErrorInvalidValue;
  const int pr = p1 - p0;
  const int64_t cells = (int64_t)L * pr * nlm, ghosts = (int64_t)L * pr * G;
  if (cells == 0) return (int)cudaGetLastError();
  dbfs_init<<<blocks_for(cells > ghosts ? cells : ghosts), kThreads, 0,
              (cudaStream_t)stream>>>(
      (const int*)src, (const int*)ghost_gid, (const int*)vtxdist,
      (int*)dist, (int*)gslot, L, P, nlm, G, p0, pr);
  return (int)cudaGetLastError();
}

// A step: the rows of parts [p0, p1) of dout (L, P, nlm) relaxed against
// din (L, P, nlm), which holds every part's distances after the gather;
// nbr (L, p1 - p0, nlm, d), gslot from the init.  One launch.
extern "C" int dbfs_parts_step_launch(const void* nbr, const void* din,
                                      void* dout, const void* gslot, int L,
                                      int P, int nlm, int d, int G, int p0,
                                      int p1, void* stream) {
  if (L < 0 || nlm < 1 || d < 1 || G < 0 || !parts_ok(P, p0, p1))
    return (int)cudaErrorInvalidValue;
  Relax a = dist_relax(nbr, gslot, L, P, nlm, d, G, p0, p1 - p0);
  a.din = (const int*)din;
  a.dout = (int*)dout;
  return (int)relax_launch<true>(a, (cudaStream_t)stream);
}

// The cluster design: one launch, one cluster of C CTAs (1-16) a lane;
// gidx holds the ghosts' lane-local slots (L, P, G) int32 when the state is
// in device memory.  The state is in the CTAs' shared memory where each CTA's share
// fits, else in device memory.
extern "C" int dbfs_cluster_launch(const void* nbr, const void* src,
                                   const void* ghost_gid,
                                   const void* vtxdist, void* dist,
                                   void* scratch, void* gidx, int L, int P,
                                   int nlm, int d, int G, int width, int C,
                                   int* counts, void* stream) {
  const int64_t N = (int64_t)P * nlm, PG = (int64_t)P * G;
  enqueued(counts, 0, 0, kGrid);
  if (L * N == 0) return (int)cudaGetLastError();
  const int shift = share_shift(N, C), gshift = share_shift(PG, C);
  const size_t smem =
      4 * (2 * share_cap(N, shift) + share_cap(PG, gshift));
  const int place = placement(smem, C);
  const cudaError_t err = launch_lanes(
      place == kL2 ? dbfs_lanes<kL2>
      : place == kLocal ? dbfs_lanes<kLocal> : dbfs_lanes<kCluster>,
      L, C, place == kL2 ? 0 : smem,
      (cudaStream_t)stream, (const int*)nbr, (const int*)src,
      (const int*)ghost_gid, (const int*)vtxdist, (int*)dist, (int*)scratch,
      (int*)gidx, P, nlm, d, G, lane_group(d), rows_vec(nbr, nbr, d), width,
      C, shift, gshift);
  if (err != cudaSuccess) return (int)err;
  enqueued(counts, 1, 0, place);
  return (int)cudaGetLastError();
}

// nbr, ewgt (L, P, nlm, d), ghost_gid (L, P, G), vtxdist (L, P + 1), nloc
// (L, P), seeds (L,) -> match (L, P, nlm) mate gids, -1 unmatched.

// The grid matching's arguments over parts [p0, p0 + pr) of each lane:
// one device's (the whole range) or a group member's (with the compacted
// proposals ctgt, cw, cgid).
inline MatchArgs match_args(const void* nbr, const void* ewgt,
                            const void* ghost_gid, const void* vtxdist,
                            const void* nloc, const void* seeds, void* match,
                            void* gidx, void* tables, void* prop_tgt,
                            void* prop_w, void* tile_count, void* ctgt,
                            void* cw, void* cgid, int L, int P, int nlm,
                            int d, int G, int cap, int p0, int pr) {
  return MatchArgs{(const int*)nbr, (const int*)ewgt, (const int*)ghost_gid,
                   (const int*)vtxdist, (const int*)nloc, (const int*)seeds,
                   (int*)match, (int64_t*)gidx, (int*)prop_tgt,
                   (float*)prop_w, (int*)tile_count,
                   (unsigned long long*)tables, (int*)ctgt, (float*)cw,
                   (int*)cgid, L, P, nlm, d, G, cap, (int)blocks_for(nlm),
                   p0, pr};
}

// The grid design.  scratch: gidx (L, P, G) int64, two (L, P, nlm) u64
// winner tables, prop_tgt (L, P, nlm) int32, prop_w (L, P, nlm) float32,
// tile counts (L, P, ceil(nlm / 256)) int32.  1 + 2 * rounds launches, or
// 1 + 3 * rounds with cap > 0.
extern "C" int dmatch_launch(const void* nbr, const void* ewgt,
                             const void* ghost_gid, const void* vtxdist,
                             const void* nloc, const void* seeds,
                             void* match, void* scratch, int L, int P,
                             int nlm, int d, int G, int rounds, int cap,
                             int* counts, void* stream) {
  const int64_t cells = (int64_t)L * P * nlm;
  enqueued(counts, 0, 0, kGrid);
  if (cells == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t ghosts = (int64_t)L * P * G;
  int64_t* gidx = (int64_t*)scratch;
  unsigned long long* tables = (unsigned long long*)(gidx + ghosts);
  int* prop_tgt = (int*)(tables + 2 * cells);
  float* prop_w = (float*)(prop_tgt + cells);
  const MatchArgs a = match_args(
      nbr, ewgt, ghost_gid, vtxdist, nloc, seeds, match, gidx, tables,
      prop_tgt, prop_w, prop_w + cells, nullptr, nullptr, nullptr, L, P, nlm,
      d, G, cap, 0, P);
  dmatch_init<<<blocks_for(cells > ghosts ? cells : ghosts), kThreads, 0, s>>>(
      a);
  const dim3 tiles((unsigned)a.tiles, (unsigned)(L * P));
  for (int r = 0; r < rounds; ++r) {
    unsigned long long* cur = a.tables + (r % 2) * cells;
    unsigned long long* nxt = a.tables + ((r + 1) % 2) * cells;
    dmatch_propose<false><<<tiles, kThreads, 0, s>>>(a, r, cur);
    if (cap > 0) dmatch_grant<false><<<tiles, kThreads, 0, s>>>(a, r, cur);
    dmatch_commit<false><<<blocks_for(cells), kThreads, 0, s>>>(a, r, cur,
                                                                nxt);
  }
  enqueued(counts, 1 + (cap > 0 ? 3 : 2) * rounds, 0, kGrid);
  return (int)cudaGetLastError();
}

// A group member's matching, parts [p0, p1) of each lane, one phase a call
// (core/dgraph.py gathers between them): nbr, ewgt (L, p1 - p0, nlm, d),
// ghost_gid (L, p1 - p0, G), vtxdist (L, P + 1), nloc (L, P), seeds (L,);
// state: match, prop_tgt, prop_w (L, P, nlm), gidx (L, p1 - p0, G) int64,
// tables (2, L, P, nlm) u64, tile_count (L, P, ceil(nlm / 256)), and with
// cap > 0 ctgt, cw, cgid (L, P, cap).  phase 0: init (1 launch); 1:
// round r's propose over the range, and with cap > 0 its compaction (1 or
// 2); 2: round r's post over every part's gathered proposals and its
// commit over the range (2).
extern "C" int dmatch_parts_launch(
    const void* nbr, const void* ewgt, const void* ghost_gid,
    const void* vtxdist, const void* nloc, const void* seeds, void* match,
    void* gidx, void* tables, void* prop_tgt, void* prop_w, void* tile_count,
    void* ctgt, void* cw, void* cgid, int L, int P, int nlm, int d, int G,
    int cap, int p0, int p1, int phase, int r, int* counts, void* stream) {
  enqueued(counts, 0, 0, kGrid);
  if (L < 0 || nlm < 1 || d < 1 || G < 0 || cap < 0 || cap > nlm ||
      !parts_ok(P, p0, p1) || phase < 0 || phase > 2)
    return (int)cudaErrorInvalidValue;
  const int64_t cells = (int64_t)L * P * nlm;
  if (cells == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const MatchArgs a = match_args(
      nbr, ewgt, ghost_gid, vtxdist, nloc, seeds, match, gidx, tables,
      prop_tgt, prop_w, tile_count, cap > 0 ? ctgt : nullptr, cw, cgid, L, P,
      nlm, d, G, cap, p0, p1 - p0);
  unsigned long long* cur = a.tables + (r % 2) * cells;
  unsigned long long* nxt = a.tables + ((r + 1) % 2) * cells;
  const dim3 tiles((unsigned)a.tiles, (unsigned)(L * a.pr));
  int own = 0;
  if (phase == 0) {
    const int64_t ghosts = (int64_t)L * a.pr * G;
    dmatch_init<<<blocks_for(cells > ghosts ? cells : ghosts), kThreads, 0,
                  s>>>(a);
    own = 1;
  } else if (phase == 1) {
    dmatch_propose<true><<<tiles, kThreads, 0, s>>>(a, r, cur);
    own = 1;
    if (cap > 0) {
      dmatch_grant<true><<<tiles, kThreads, 0, s>>>(a, r, cur);
      own = 2;
    }
  } else {
    const int64_t posts = cap > 0 ? (int64_t)L * P * cap : cells;
    dmatch_post<<<blocks_for(cells > posts ? cells : posts), kThreads, 0,
                  s>>>(a, r, cur, nxt);
    dmatch_commit<true><<<blocks_for((int64_t)L * a.pr * nlm), kThreads, 0,
                        s>>>(a, r, cur, nxt);
    own = 2;
  }
  enqueued(counts, own, 0, kGrid);
  return (int)cudaGetLastError();
}

// The cluster design: one launch, one cluster of C CTAs (1-16) a lane.
// scratch: words (2, L, N) u64; prop, pslot, pw, pre (4, L, N), gslot
// (L, P, G), cnt, pbase (2, L, C, P) int32; role (L, N) bytes.
// The state is in the CTAs' shared memory where each CTA's share fits,
// else in the scratch.
extern "C" int dmatch_cluster_launch(const void* nbr, const void* ewgt,
                                     const void* ghost_gid,
                                     const void* vtxdist, const void* nloc,
                                     const void* seeds, void* match,
                                     void* scratch, int L, int P, int nlm,
                                     int d, int G, int rounds, int cap,
                                     int C, int* counts, void* stream) {
  const int64_t N = (int64_t)P * nlm, cells = L * N, PG = (int64_t)P * G;
  enqueued(counts, 0, 0, kGrid);
  if (cells == 0) return (int)cudaGetLastError();
  LaneMatch a;
  a.nbr = (const int*)nbr;
  a.ewgt = (const int*)ewgt;
  a.ghost_gid = (const int*)ghost_gid;
  a.vtxdist = (const int*)vtxdist;
  a.nloc = (const int*)nloc;
  a.seeds = (const int*)seeds;
  a.match = (int*)match;
  a.words = (unsigned long long*)scratch;
  a.ints = (int*)(a.words + 2 * cells);
  a.counts = a.ints + 4 * cells + L * PG;
  a.role = (uint8_t*)(a.counts + 2 * (int64_t)L * C * P);
  a.L = L;
  a.P = P;
  a.nlm = nlm;
  a.d = d;
  a.G = G;
  a.rounds = rounds;
  a.cap = cap;
  a.C = C;
  a.group = lane_group(d);
  a.shift = share_shift(N, C);
  a.gshift = share_shift(PG, C);
  a.vec = rows_vec(nbr, ewgt, d);
  const size_t smem = ((C == 1 ? 33 : 17) * (size_t)share_cap(N, a.shift) +
                       4 * (size_t)share_cap(PG, a.gshift) + 15) / 16 * 16;
  const int place = placement(smem, C);
  const cudaError_t err = launch_lanes(
      place == kL2 ? dmatch_lanes<kL2>
      : place == kLocal ? dmatch_lanes<kLocal> : dmatch_lanes<kCluster>,
      L, C, place == kL2 ? 0 : smem, (cudaStream_t)stream, a);
  if (err != cudaSuccess) return (int)err;
  enqueued(counts, 1, 0, place);
  return (int)cudaGetLastError();
}
