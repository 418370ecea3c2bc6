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
// id of -1 reads 0.
//
// ell_relax (one thread a row): out = min over valid slots of ext[id] + 1,
// padding (-1) read as `big`.  The same kernel runs every step of the
// distributed BFS (dbfs_launch) in its distributed form: given a table of
// each ghost's owner slot, it reads a ghost's value straight from its
// owner's row (the halo exchange of the step, fused) and takes the min
// with the row's old distance.  The BFS is synchronous, so each step reads
// the previous step's distances and writes the other buffer.
//
// dmatch (1 + 3 * rounds launches): init (mates -1, the round-0 winner
// table cleared, the ghost table), then per round
//   propose  each unmatched proposer (coin hash_mix(gid, r, seed) & 1)
//            picks its heaviest unmatched acceptor neighbour: the first
//            slot of largest float(w) + hash_unit(gid, tgt, r + 17);
//   grant    one block a (lane, part) ranks its proposals in row order
//            (the compact gather keeps the first `cap`, when cap > 0) and
//            posts each one to its target's winner slot with one 64-bit
//            atomicMax of (order-preserving bits of float(w) +
//            hash_unit(gid, tgt, r + 31), INT_MAX - gid): the largest
//            score, then the smallest gid, as the reference's segment_max
//            then segment_min (dgraph.py:1098-1108);
//   commit   acceptors take their slot's winner, proposers whose target's
//            winner is themselves take their target, and each clears its
//            slot of the next round's table.
// All three read the round's starting mates; each writes only its own.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false (build.py).
// Float sums are single adds, so no contraction can change a bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBig = 1 << 30;  // the distributed BFS's unreached distance
constexpr uint32_t kIntMax = 0x7FFFFFFFu;

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
__device__ __forceinline__ float hash_unit3(int a, int b, uint32_t c) {
  return __fmul_rn(__uint2float_rn(hash_mix3(a, b, c)), 0x1p-32f);
}

// An order-preserving unsigned image of a float (no NaN arises here).
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
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

// The flat slot (lane l, owner, local) of global id g in a lane's
// (P, nlm) rows, or -1 for g < 0 (a ghost that reads 0).
__device__ __forceinline__ int64_t slot_of(const int* vd, int P, int nlm,
                                           int64_t l, int g) {
  if (g < 0) return -1;
  const int o = owner_of(vd, P, g);
  const int loc = min(max(g - vd[o], 0), nlm - 1);
  return (l * P + o) * (int64_t)nlm + loc;
}

// ------------------------------------------------------------ relaxation
// rows (R, n) of ELL ids (R, n, d).  Plain form (dist == 0): row r reads
// ext row r of width m.  Distributed form (dist != 0): ids < n read the
// part's own row (m == n), ids in [n, n + G) read din[gidx[r, id - n]] (0
// if -1), and the result is min(old, relaxed); with G == 0 gidx is never
// read.  Ids outside the row read as padding, so no input reads outside
// its buffers.
__global__ void ell_relax(const int* __restrict__ nbr,
                          const int* __restrict__ din, int* __restrict__ dout,
                          const int64_t* __restrict__ gidx, int dist,
                          int64_t rows, int n, int d, int64_t m, int G,
                          int big) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * n) return;
  const int64_t r = t / n;
  const int v = (int)(t - r * n);
  const int* row = nbr + t * d;
  const int* ext = din + r * m;
  int best = big;
  for (int s = 0; s < d; ++s) {
    const int c = row[s];
    if (c < 0) continue;
    int val;
    if (dist && c >= n) {
      if (c - n >= G) continue;
      const int64_t f = gidx[r * G + (c - n)];
      val = f >= 0 ? din[f] : 0;
    } else {
      if (c >= m) continue;
      val = ext[c];
    }
    best = min(best, val);
  }
  dout[t] = dist ? min(ext[v], best + 1) : best + 1;
}

// ------------------------------------------------------------ halo
// out (L, P, nlm + G): the part's own values, then each ghost's owner value.
__global__ void halo_exchange(const int* __restrict__ x,
                              const int* __restrict__ ghost_gid,
                              const int* __restrict__ vtxdist,
                              int* __restrict__ out, int L, int P, int nlm,
                              int G) {
  const int W = nlm + G;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)L * P * W) return;
  const int64_t lp = t / W;
  const int k = (int)(t - lp * W);
  if (k < nlm) {
    out[t] = x[lp * nlm + k];
    return;
  }
  const int64_t l = lp / P;
  const int64_t f = slot_of(vtxdist + l * (P + 1), P, nlm, l,
                            ghost_gid[lp * G + (k - nlm)]);
  out[t] = f >= 0 ? x[f] : 0;
}

// The ghost table of a call: gidx[l, p, g] = flat owner slot of ghost g of
// part p, or -1.
__device__ __forceinline__ void ghost_table(const int* ghost_gid,
                                            const int* vtxdist, int64_t* gidx,
                                            int64_t t, int P, int nlm,
                                            int G) {
  const int64_t lp = t / G;
  const int64_t l = lp / P;
  gidx[t] = slot_of(vtxdist + l * (P + 1), P, nlm, l, ghost_gid[t]);
}

// ------------------------------------------------------------ BFS
__global__ void dbfs_init(const int* __restrict__ src,
                          const int* __restrict__ ghost_gid,
                          const int* __restrict__ vtxdist,
                          int* __restrict__ dist, int64_t* __restrict__ gidx,
                          int L, int P, int nlm, int G) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t cells = (int64_t)L * P * nlm, ghosts = (int64_t)L * P * G;
  if (t < cells) dist[t] = src[t] != 0 ? 0 : kBig;
  if (t < ghosts) ghost_table(ghost_gid, vtxdist, gidx, t, P, nlm, G);
}

// ------------------------------------------------------------ matching
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
  unsigned long long* tables;  // two (L, P, nlm) winner tables
  int L, P, nlm, d, G, cap;
};

__global__ void dmatch_init(MatchArgs a) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t cells = (int64_t)a.L * a.P * a.nlm;
  if (t < cells) {
    a.match[t] = -1;
    a.tables[t] = 0ull;
  }
  if (t < (int64_t)a.L * a.P * a.G)
    ghost_table(a.ghost_gid, a.vtxdist, a.gidx, t, a.P, a.nlm, a.G);
}

// A row's identity: its lane, part, local index, global id (-1 on
// padding) and whether it is unmatched at the round's start.
struct Row {
  int64_t l, lp;
  int i, lo, nloc, gid;
  bool unmatched;
  uint32_t seed;
};

__device__ __forceinline__ Row row_of(const MatchArgs& a, int64_t t) {
  Row w;
  w.lp = t / a.nlm;
  w.i = (int)(t - w.lp * a.nlm);
  w.l = w.lp / a.P;
  const int p = (int)(w.lp - w.l * a.P);
  w.lo = a.vtxdist[w.l * (a.P + 1) + p];
  w.nloc = a.nloc[w.lp];
  w.gid = w.i < w.nloc ? w.lo + w.i : -1;
  w.unmatched = w.i < w.nloc && a.match[t] < 0;
  w.seed = (uint32_t)a.seeds[w.l];
  return w;
}

__global__ void dmatch_propose(MatchArgs a, int r) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)a.L * a.P * a.nlm) return;
  const Row w = row_of(a, t);
  int tgt = -1;
  float wsel = 0.f;
  if (w.unmatched && (hash_mix3(w.gid, r, w.seed) & 1u)) {
    float best = -INFINITY;
    const int* row = a.nbr + t * a.d;
    const int* ew = a.ewgt + t * a.d;
    for (int s = 0; s < a.d; ++s) {
      const int c = row[s];
      if (c < 0 || c >= a.nlm + a.G) continue;  // padding, or no slot
      int tg;
      bool un;
      if (c < a.nlm) {
        tg = c < w.nloc ? w.lo + c : -1;
        un = c < w.nloc && a.match[w.lp * a.nlm + c] < 0;
      } else {
        tg = a.ghost_gid[w.lp * a.G + (c - a.nlm)];
        const int64_t f = a.gidx[w.lp * a.G + (c - a.nlm)];
        un = false;
        if (f >= 0) {
          const int64_t olp = f / a.nlm;
          un = (int)(f - olp * a.nlm) < a.nloc[olp] && a.match[f] < 0;
        }
      }
      if (!un || tg < 0 || (hash_mix3(tg, r, w.seed) & 1u)) continue;
      const float score =
          __fadd_rn(__int2float_rn(ew[s]), hash_unit3(w.gid, tg, r + 17));
      if (score > best) {  // the first slot of the largest score
        best = score;
        tgt = tg;
        wsel = __int2float_rn(ew[s]);
      }
    }
  }
  a.prop_tgt[t] = tgt;
  a.prop_w[t] = wsel;
}

// One block a (lane, part): its proposals in row order, ranked by a block
// scan, the first `cap` (all when cap == 0) posted to the winner table.
__global__ void dmatch_grant(MatchArgs a, int r,
                             unsigned long long* __restrict__ table) {
  __shared__ int warp_sum[kThreads / 32];
  const int64_t lp = blockIdx.x;
  const int64_t l = lp / a.P;
  const int* vd = a.vtxdist + l * (a.P + 1);
  const int lo = vd[lp - l * a.P];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int running = 0;
  for (int base = 0; base < a.nlm; base += kThreads) {
    const int i = base + threadIdx.x;
    const int tg = i < a.nlm ? a.prop_tgt[lp * a.nlm + i] : -1;
    const bool has = tg >= 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, has);
    if (lane == 0) warp_sum[warp] = __popc(ballot);
    __syncthreads();
    int before = running + __popc(ballot & ((1u << lane) - 1u));
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) {
      if (k < warp) before += warp_sum[k];
      total += warp_sum[k];
    }
    __syncthreads();
    running += total;
    if (has && (a.cap == 0 || before < a.cap)) {
      const int o = owner_of(vd, a.P, tg);
      const int loc = min(max(tg - vd[o], 0), a.nlm - 1);
      const int gid = lo + i;
      const float score = __fadd_rn(a.prop_w[lp * a.nlm + i],
                                    hash_unit3(gid, tg, r + 31));
      atomicMax(table + (l * a.P + o) * (int64_t)a.nlm + loc,
                ((unsigned long long)ordered(score) << 32) |
                    (kIntMax - (uint32_t)gid));
    }
  }
}

__global__ void dmatch_commit(MatchArgs a, int r,
                              const unsigned long long* __restrict__ table,
                              unsigned long long* __restrict__ next) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)a.L * a.P * a.nlm) return;
  const Row w = row_of(a, t);
  const bool proposer = (hash_mix3(w.gid, r, w.seed) & 1u) != 0;
  int mate = a.match[t];
  const int tg = a.prop_tgt[t];
  if (tg >= 0) {
    const int* vd = a.vtxdist + w.l * (a.P + 1);
    const int o = owner_of(vd, a.P, tg);
    const int loc = min(max(tg - vd[o], 0), a.nlm - 1);
    const unsigned long long win =
        table[(w.l * a.P + o) * (int64_t)a.nlm + loc];
    if (win != 0ull && (int)(kIntMax - (uint32_t)win) == w.gid) mate = tg;
  }
  const unsigned long long mine = table[t];
  if (w.unmatched && !proposer && mine != 0ull)
    mate = (int)(kIntMax - (uint32_t)mine);
  a.match[t] = mate;
  next[t] = 0ull;
}

}  // namespace

// ext (L, m), nbr (L, n, d) -> out (L, n): one launch.
extern "C" int ell_relax_launch(const void* nbr, const void* ext, void* out,
                                int L, int n, int d, int m, int big,
                                void* stream) {
  const int64_t rows = (int64_t)L * n;
  if (rows == 0) return (int)cudaGetLastError();
  ell_relax<<<blocks_for(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)nbr, (const int*)ext, (int*)out, nullptr, 0, L, n, d, m,
      0, big);
  return (int)cudaGetLastError();
}

// x (L, P, nlm), ghost_gid (L, P, G), vtxdist (L, P + 1) -> out (L, P,
// nlm + G): one launch.
extern "C" int halo_launch(const void* x, const void* ghost_gid,
                           const void* vtxdist, void* out, int L, int P,
                           int nlm, int G, void* stream) {
  const int64_t total = (int64_t)L * P * (nlm + G);
  if (total == 0) return (int)cudaGetLastError();
  halo_exchange<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (const int*)ghost_gid, (const int*)vtxdist, (int*)out,
      L, P, nlm, G);
  return (int)cudaGetLastError();
}

// nbr (L, P, nlm, d), src (L, P, nlm) -> dist (L, P, nlm) after `width`
// synchronous steps.  scratch: a second (L, P, nlm) int32 buffer; gidx:
// (L, P, G) int64.  1 + width launches: dbfs_init, then ell_relax in its
// distributed form a step.
extern "C" int dbfs_launch(const void* nbr, const void* src,
                           const void* ghost_gid, const void* vtxdist,
                           void* dist, void* scratch, void* gidx, int L,
                           int P, int nlm, int d, int G, int width,
                           void* stream) {
  const int64_t cells = (int64_t)L * P * nlm;
  if (cells == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* bufs[2] = {(int*)dist, (int*)scratch};
  const int start = width % 2;  // the last step lands in `dist`
  const int64_t ghosts = (int64_t)L * P * G;
  dbfs_init<<<blocks_for(cells > ghosts ? cells : ghosts), kThreads, 0, s>>>(
      (const int*)src, (const int*)ghost_gid, (const int*)vtxdist,
      bufs[start], (int64_t*)gidx, L, P, nlm, G);
  for (int k = 0; k < width; ++k)
    ell_relax<<<blocks_for(cells), kThreads, 0, s>>>(
        (const int*)nbr, bufs[(start + k) % 2], bufs[(start + k + 1) % 2],
        (const int64_t*)gidx, 1, (int64_t)L * P, nlm, d, nlm, G, kBig);
  return (int)cudaGetLastError();
}

// nbr, ewgt (L, P, nlm, d), ghost_gid (L, P, G), vtxdist (L, P + 1), nloc
// (L, P), seeds (L,) -> match (L, P, nlm) mate gids, -1 unmatched.
// scratch: gidx (L, P, G) int64, two (L, P, nlm) u64 winner tables,
// prop_tgt (L, P, nlm) int32, prop_w (L, P, nlm) float32.
// 1 + 3 * rounds launches.
extern "C" int dmatch_launch(const void* nbr, const void* ewgt,
                             const void* ghost_gid, const void* vtxdist,
                             const void* nloc, const void* seeds,
                             void* match, void* scratch, int L, int P,
                             int nlm, int d, int G, int rounds, int cap,
                             void* stream) {
  const int64_t cells = (int64_t)L * P * nlm;
  if (cells == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t ghosts = (int64_t)L * P * G;
  MatchArgs a;
  a.nbr = (const int*)nbr;
  a.ewgt = (const int*)ewgt;
  a.ghost_gid = (const int*)ghost_gid;
  a.vtxdist = (const int*)vtxdist;
  a.nloc = (const int*)nloc;
  a.seeds = (const int*)seeds;
  a.match = (int*)match;
  a.gidx = (int64_t*)scratch;
  a.tables = (unsigned long long*)(a.gidx + ghosts);
  a.prop_tgt = (int*)(a.tables + 2 * cells);
  a.prop_w = (float*)(a.prop_tgt + cells);
  a.L = L;
  a.P = P;
  a.nlm = nlm;
  a.d = d;
  a.G = G;
  a.cap = cap;
  dmatch_init<<<blocks_for(cells > ghosts ? cells : ghosts), kThreads, 0, s>>>(
      a);
  for (int r = 0; r < rounds; ++r) {
    unsigned long long* cur = a.tables + (r % 2) * cells;
    unsigned long long* nxt = a.tables + ((r + 1) % 2) * cells;
    dmatch_propose<<<blocks_for(cells), kThreads, 0, s>>>(a, r);
    dmatch_grant<<<(unsigned)(L * P), kThreads, 0, s>>>(a, r, cur);
    dmatch_commit<<<blocks_for(cells), kThreads, 0, s>>>(a, r, cur, nxt);
  }
  return (int)cudaGetLastError();
}
