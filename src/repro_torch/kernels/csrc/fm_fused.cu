// Vertex-separator FM, one CTA per lane: the fused pass loop and the
// hoisted path's one-pass move loop, each drawing its tiebreak noise itself.
//
// Replaces: src/repro/kernels/fm_fused.py:209, fm_fused_multi
// (_fm_fused_kernel with the per-lane fm_move_loop, fm_fused.py:48), the
// TPU kernel that keeps one lane's state resident in VMEM across all passes
// and moves, and the noise the reference draws outside it
// (fm_fused.py:139, fm_noise, jax.random).  The move loop is one
// __device__ function, `move_loop`, called by both kernels here, as the
// reference shares fm_move_loop between its fused kernel and its hoisted
// path (src/repro/core/fm.py:104):
// * fm_fused_kernel runs every pass: gain recompute, moves, revert;
// * fm_move_loop_kernel runs one pass with the gains given (from
//   sep_gain.cu) and bws / bimb carried in, so that a pass loop on the host
//   that alternates the two kernels gives the fused kernel's results.
//
// What bounds it on an H100: latency, not bytes or operations.  A move is
// an argmax over the movable separator vertices followed by an update of
// the moved row and the pulled rows, and every move depends on the one
// before: the lane's work is a chain of block-wide steps on one SM.  The
// roofline bound counts only the work the moves need: the kernel tallies,
// per lane, the arithmetic on the candidates it scores, on the slots the
// moves update and on each pass's recompute, and the noise entries the
// candidates need drawn (two a listed or staged vertex a pass).
// chip_smoke.py turns that tally into the bound; it is
// operations, far below the time the chain takes: the moved row's and the
// pulled rows' ids are device-memory reads that each move waits on.
//
// The noise: the reference draws, per pass p, uniform((2, n)) from the
// subkey split(k_p)[1], with k_0 the lane's key and k_{q+1} =
// split(k_q)[0], n the tile's padded n.  Here one thread derives pass p's
// subkey at the pass start (`pass_key`) and the entry of side s and vertex
// v is threefry_uniform(subkey, s * n + v) (threefry.cuh), the bits of
// prng.py.  Every vertex's pair (both sides) is drawn while the pass start
// builds the candidate list, into a per-vertex float2 array that the scan
// reads as it read a noise tensor: in shared memory beside the hot state
// where both fit (hot_bytes), else in the lane's scratch.  On an H100 this
// was the fastest of four placements timed, ahead of drawing only the
// listed vertices there and each staged vertex as it is staged, by 2.5% at
// the band bucket and 5.4% at (8, 4096, 512) (PERF.md §6): a pass's 2n
// draws at its start cost less than a staged vertex's draw on a move's
// dependent chain.
//
// Design: every step costs O(what changes), not O(n) or O(d):
// * A candidate list per lane holds the separator vertices that are neither
//   moved nor locked; it is built at each pass start from `part`.  A move
//   drops the moved vertex (the list's last staged entry fills its place)
//   and appends each vertex pulled into the separator unless it is moved or
//   locked.  The argmax scans the list, not 0..n.  Ties stay exact: the
//   score's index side * n + v does not depend on the scan order.
// * A move journal replaces the copy of the best state: every `part` write
//   of the pass is logged as (vertex, old value), and the journal's length
//   at the best state is kept.  At pass end the entries past it are undone,
//   each vertex taking the old value of its earliest such entry.  A move
//   moves a vertex that was never moved in the pass, and a vertex enters
//   the separator at most twice a pass (pulled before its move and after
//   it) and leaves it at most once, so a pass logs at most
//   min(max_moves, n) + 2n <= 3n entries; the scratch holds 3n.
// * Row extents (`row_len`, 1 + the last slot of a row that holds an id,
//   from band_batch.row_extents): the moved row, the pulled rows and the
//   pass-start recompute read each row only to its extent, so a band tile
//   whose two anchors make d = 1024 costs its rows' ~7 ids, not d.  The
//   pulled rows are shared out by warps; a recompute row longer than
//   kLongLoops loops of its group (an anchor) is read by the whole block.
// * Three block-wide barriers a move: the argmax's, one after the moved
//   row's pass (pull list, staged candidates, journal and pulled weight
//   complete; the weight is a shared-memory atomic sum), one after the
//   update (visible to the next scan).
// * Duplicate ids in a row count per slot, as in the reference; the row's
//   first slot naming a pulled vertex logs it and stages it.
// * the hot state (pulled0/1, the list, copies of the lane's vertex
//   weights and of the tile's row extents, part, flags, the pulled slots:
//   22n + 4d bytes) lives in shared memory where it fits (n <= 8192 at
//   d <= 4096), so that a move's device-memory reads are the moved row,
//   the pulled rows and, where the noise pairs (8n) do not fit beside it,
//   the scored candidates' pairs; the pairs where they do not fit, the
//   journal and the undo's marks, and at larger n all of the state, live
//   in a per-lane device-memory scratch
//   (at the band bucket shared memory was 3-4% faster than the scratch
//   alone: PERF.md §6);
// * the argmax is two warp max-reductions of a key (the score's
//   order-preserving bits, then the complement of the index), and carries
//   the winner's list position and row extent, so the move starts without
//   another load; a pulled slot adds its weight with a shared-memory
//   atomic, and a row's duplicate ids are found with a warp match;
// * the ELL tile is read from device memory: one tile per work, shared by
//   the work's lanes through `lane_work`, so lanes do not copy it; a
//   `lane_work` outside [0, W) reads as an empty tile, and ids outside
//   [0, n) as padding, so no read leaves the tiles;
// * every float sum is over integer-valued float32 weights, so atomics and
//   reductions in any order give the reference's values exactly;
// * score = gain + noise * amp is rounded twice, as the reference does:
//   __fmul_rn / __fadd_rn, and the file is built with -fmad=false;
// * the argmax is the first maximal index over [side 0 | side 1], with
//   -inf for infeasible entries: ties go to the lower index.
// The block has kThreads = 256 threads: at the band bucket 512 was within
// 4% of it and 1024 was 37% slower (PERF.md §6).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "gain_row.cuh"
#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
// Where the state lives (`place`, bits).
constexpr int kHotShared = 1;    // the hot state in shared memory
constexpr int kPairsInSmem = 2;  // the noise pairs too
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// A recompute row longer than this many loops of its group is left to the
// whole block, up to kMaxLong such rows a pass (more are read by their
// groups).
constexpr int kLongLoops = 4;
constexpr int kMaxLong = 64;

struct Shared {
  float arg_s[kWarps];  // block argmax: each warp's best
  int arg_i[kWarps];
  int arg_pos[kWarps];  // ... its list position and row extent
  int arg_len[kWarps];
  float sums[3][kWarps];  // part_sums: each warp's side weights
  float pw;                  // the move's pulled weight
  int n_pull, n_add, n_log;  // the move's pulled slots, staged, logged
  int cnt;                   // the list built at pass start
  int n_long;
  int long_rows[kMaxLong];
  Key2x32 sub;                  // the pass's noise subkey
  unsigned long long tally[2];  // operations, noise entries drawn
};

// Pass p's noise subkey from the lane's key words: split(k_p)[1], with k_0
// the lane's key and k_{q+1} = split(k_q)[0].
__device__ Key2x32 pass_key(const int64_t* key_words, int p) {
  Key2x32 k = key_of(key_words);
  for (int q = 0; q < p; ++q) k = threefry_split(k, 0u);
  return threefry_split(k, 1u);
}

// Vertex v's noise pair: the entries of sides 0 and 1, at s * n + v of the
// pass's uniform((2, n)).
__device__ __forceinline__ float2 noise_pair(Key2x32 sub, int v, int n) {
  return make_float2(threefry_uniform(sub, (uint64_t)v),
                     threefry_uniform(sub, (uint64_t)n + (uint64_t)v));
}

__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// A score's bits, ordered as the floats are (no NaN; -0 counts as +0).
__device__ __forceinline__ unsigned ordered(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's best (s, i) by `beats`, with the winner's payload (pos, len):
// the highest key, then among its lanes the highest ~i (the lowest index).
__device__ __forceinline__ void warp_argmax(float& s, int& i, int& pos,
                                            int& len) {
  const unsigned key = ordered(s);
  const unsigned top = __reduce_max_sync(kFull, key);
  const unsigned low = __reduce_max_sync(kFull, key == top ? ~(unsigned)i : 0u);
  const int src =
      __ffs(__ballot_sync(kFull, key == top && ~(unsigned)i == low)) - 1;
  s = __shfl_sync(kFull, s, src);
  i = __shfl_sync(kFull, i, src);
  pos = __shfl_sync(kFull, pos, src);
  len = __shfl_sync(kFull, len, src);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Block-wide argmax with the winner's payload, one barrier; every thread
// gets the result.  The previous call's readers must be past a barrier.
__device__ void block_argmax(float& s, int& i, int& pos, int& len,
                             Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(s, i, pos, len);
  if (lane == 0) {
    sh.arg_s[warp] = s;
    sh.arg_i[warp] = i;
    sh.arg_pos[warp] = pos;
    sh.arg_len[warp] = len;
  }
  __syncthreads();
  const bool has = lane < kWarps;
  s = has ? sh.arg_s[lane] : -INFINITY;
  i = has ? sh.arg_i[lane] : INT_MAX;
  pos = has ? sh.arg_pos[lane] : 0;
  len = has ? sh.arg_len[lane] : 0;
  warp_argmax(s, i, pos, len);
}

// The side and separator weights of `part`, one barrier.
__device__ void part_sums(const int8_t* part, const float* vw, int n,
                          Shared& sh, float& w0, float& w1, float& ws) {
  float a[3] = {0.f, 0.f, 0.f};
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const int p = part[v];
    const float x = vw[v];
    if (p == 0) a[0] += x;
    else if (p == 1) a[1] += x;
    else if (p == 2) a[2] += x;
  }
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < 3; ++k) {
    a[k] = warp_sum(a[k]);
    if (lane == 0) sh.sums[k][threadIdx.x >> 5] = a[k];
  }
  __syncthreads();
  for (int k = 0; k < 3; ++k)
    a[k] = warp_sum(lane < kWarps ? sh.sums[k][lane] : 0.f);
  w0 = a[0];
  w1 = a[1];
  ws = a[2];
}

// A row's extent, clamped to [0, d]; 0 for a lane without a tile.
__device__ __forceinline__ int extent(const int* rlen, int v, int d) {
  return rlen == nullptr ? 0 : min(max(rlen[v], 0), d);
}

// pulled0[v] = weight of v's neighbours on side 1, pulled1[v] on side 0:
// the row body of sep_gain.cu (gain_row.cuh) over every row of the lane,
// each to its extent.  Rows longer than kLongLoops loops of their group are
// read by the whole block afterwards (each warp a share, summed with
// atomics).  Starts and ends with a barrier.  Returns the number of valid
// slots this thread read.
__device__ int recompute_pulled(const int* tile, const int* rlen,
                                const int8_t* part, const float* vw,
                                float* pulled0, float* pulled1, int n, int d,
                                int group, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int rows = kThreads / group;
  const bool lead = tid % group == 0;
  int slots = 0;
  if (tid == 0) sh.n_long = 0;
  __syncthreads();
  for (int base = 0; base < n; base += rows) {
    const int v = base + tid / group;
    const int len = v < n ? extent(rlen, v, d) : 0;
    const int* row = len > 0 ? tile + (int64_t)v * d : nullptr;
    int slot = -1;
    if (lead && len > kLongLoops * group) slot = atomicAdd(&sh.n_long, 1);
    slot = __shfl_sync(kFull, slot, lane & ~(group - 1));
    if (slot >= 0 && slot < kMaxLong) {  // left to the block
      if (lead) sh.long_rows[slot] = v;
      row = nullptr;
    }
    float a0, a1;
    slots += gain_row(row, len, n, group, part, vw, a0, a1);
    if (v < n && lead) {
      pulled0[v] = a0;
      pulled1[v] = a1;
    }
  }
  __syncthreads();
  const int n_long = min(sh.n_long, kMaxLong);
  for (int k = 0; k < n_long; ++k) {
    const int u = sh.long_rows[k];
    const int len = extent(rlen, u, d);
    const int share = (len + kWarps - 1) / kWarps;
    const int first = min((tid >> 5) * share, len);
    float a0, a1;
    slots += gain_row(tile + (int64_t)u * d + first, min(share, len - first),
                      n, 32, part, vw, a0, a1);
    if (lane == 0) {
      atomicAdd(&pulled0[u], a0);
      atomicAdd(&pulled1[u], a1);
    }
  }
  __syncthreads();
  return slots;
}

// Per-lane mutable state: a device-memory scratch slice of the lane, with
// the hot part, and the noise pairs where they fit too, in shared memory.
struct LaneState {
  const float* vw;  // the lane's vertex weights
  const int* rlen;  // the tile's row extents, nullptr for no tile
  float* pulled0;
  float* pulled1;
  float2* nz;      // n: each vertex's noise pair this pass (sides 0, 1)
  int* cand;       // n: the candidate list, then the move's staged entries
  int* journal;    // 3n: the pass's part writes, vertex << 2 | old value
  int* first;      // n: the undo's earliest entry of each vertex
  int* pull_list;  // d: the move's pulled slots
  int8_t* part;
  uint8_t* flags;  // bit 0 moved, bit 1 locked
};

// The lane's state; with kHotShared in `place`, the hot state lives in
// `smem` and the vertex weights and row extents are copied in (the copy is
// visible after the caller's next barrier); with kPairsInSmem, the noise
// pairs live there too.
__device__ LaneState lane_state(uint8_t* base, uint8_t* smem, int place,
                                const float* vw, const int* rlen, int n,
                                int d) {
  LaneState st;
  st.vw = vw;
  st.rlen = rlen;
  st.pulled0 = reinterpret_cast<float*>(base);
  st.pulled1 = st.pulled0 + n;
  st.nz = reinterpret_cast<float2*>(st.pulled1 + n);
  st.cand = reinterpret_cast<int*>(st.nz + n);
  st.journal = st.cand + n;
  st.first = st.journal + 3 * (int64_t)n;
  st.pull_list = st.first + n;
  st.part = reinterpret_cast<int8_t*>(st.pull_list + d);
  st.flags = reinterpret_cast<uint8_t*>(st.part + n);
  if (place & kHotShared) {  // the hot state: hot_bytes(n, d, pairs)
    if (place & kPairsInSmem) {
      st.nz = reinterpret_cast<float2*>(smem);
      smem += 8 * (int64_t)n;
    }
    st.pulled0 = reinterpret_cast<float*>(smem);
    st.pulled1 = st.pulled0 + n;
    st.cand = reinterpret_cast<int*>(st.pulled1 + n);
    float* vw_s = reinterpret_cast<float*>(st.cand + n);
    int* rlen_s = reinterpret_cast<int*>(vw_s + n);
    st.pull_list = rlen_s + n;
    st.part = reinterpret_cast<int8_t*>(st.pull_list + d);
    st.flags = reinterpret_cast<uint8_t*>(st.part + n);
    for (int v = threadIdx.x; v < n; v += kThreads) {
      vw_s[v] = vw[v];
      if (rlen != nullptr) rlen_s[v] = rlen[v];
    }
    st.vw = vw_s;
    if (rlen != nullptr) st.rlen = rlen_s;
  }
  return st;
}

// Counts of the work the moves need (the roofline's tally): move-loop
// steps, arithmetic on scored candidates, updated slots and pass
// recomputes, and the noise entries the candidates need drawn (both sides
// of every listed or staged vertex, each pass).
struct Tally {
  int steps;
  long long ops;
  long long draws;
};

// The candidate list of a pass start: the separator vertices not locked,
// with every vertex's flags reset to its lock and its noise pair drawn from
// sh.sub.  sh.cnt must be 0, `part` and sh.sub visible; the caller's next
// barrier publishes sh.cnt, the list and the pairs.
__device__ void build_candidates(const LaneState& st, const uint8_t* lk,
                                 int n, Shared& sh, Tally& t) {
  const int lane = threadIdx.x & 31;
  const Key2x32 sub = sh.sub;
  for (int base = 0; base < n; base += kThreads) {
    const int v = base + threadIdx.x;
    const bool locked = v < n && lk[v];
    const bool c = v < n && st.part[v] == 2 && !locked;
    if (v < n) {
      st.flags[v] = locked ? 2 : 0;
      st.nz[v] = noise_pair(sub, v, n);
    }
    if (c) t.draws += 2;
    const unsigned b = __ballot_sync(kFull, c);
    int off = 0;
    if (lane == 0 && b) off = atomicAdd(&sh.cnt, __popc(b));
    off = __shfl_sync(kFull, off, 0);
    if (c) st.cand[off + __popc(b & ((1u << lane) - 1u))] = v;
  }
}

// One pass of moves on one lane: the reference's per-lane fm_move_loop
// (src/repro/kernels/fm_fused.py:48).  On entry the candidate list of
// `part` holds cnt entries, every vertex's noise pair is drawn, pulled0/1
// hold the gains of part, w0, w1, ws its side and separator weights, and
// all of it is visible to the block.  Runs up to max_moves moves; bws and bimb track the best feasible state and
// `best_j` the journal's length there, `jlen` its length at the end.  Every
// thread of the block calls it and gets the same scalars.
__device__ void move_loop(const int* tile, const int* rlen, const float* vw,
                          const LaneState& st, int cnt,
                          int n, int d, float eps_abs, int max_moves,
                          int pert, int pos_only, float& w0, float& w1,
                          float& ws, float& bws, float& bimb, Shared& sh,
                          int& best_j, int& jlen, Tally& t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pulled0 = st.pulled0;
  float* pulled1 = st.pulled1;
  int* cand = st.cand;
  int8_t* part = st.part;
  uint8_t* flags = st.flags;
  best_j = jlen = 0;
  bool alive = true;
  for (int i = 0; i < max_moves && alive; ++i, ++t.steps) {
    // the previous move's writes are visible (its closing barrier)
    if (tid == 0) {
      sh.pw = 0.f;
      sh.n_pull = sh.n_add = sh.n_log = 0;
    }
    const float amp = i < pert ? 1e9f : 1e-3f;
    const float thr = fmaxf(eps_abs, fabsf(w0 - w1));
    float bs = -INFINITY;
    int bi = INT_MAX, bp = 0, bl = 0;
    for (int k = tid; k < cnt; k += kThreads) {
      const int v = cand[k];
      const float2 z = st.nz[v];
      const int len = extent(rlen, v, d);
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
      if (ok0) {
        const float s = __fadd_rn(g0, __fmul_rn(z.x, amp));
        if (beats(s, v, bs, bi)) { bs = s; bi = v; bp = k; bl = len; }
        t.ops += 3;  // multiply, add, compare
      }
      if (ok1) {
        const float s = __fadd_rn(g1, __fmul_rn(z.y, amp));
        if (beats(s, n + v, bs, bi)) { bs = s; bi = n + v; bp = k; bl = len; }
        t.ops += 3;
      }
    }
    block_argmax(bs, bi, bp, bl, sh);
    const bool ok = bs > -INFINITY;
    float dv = 0.f, pulled_w = 0.f;
    int side = 0, v = 0;
    if (ok) {
      side = bi >= n ? 1 : 0;
      v = bi - side * n;
      dv = vw[v];
      const int len = bl;
      const int* row = tile + (int64_t)v * d;
      // the pulled set, judged on the state before the move; v leaves the
      // separator for `side`, so its neighbours' pull toward it grows
      float* pv = side == 1 ? pulled0 : pulled1;
      for (int base = 0; base < len; base += kThreads) {
        const int j = base + tid;
        const int u = j < len ? row[j] : -1;
        bool pulled = false;
        if ((unsigned)u < (unsigned)n) {
          t.ops += 2;  // test the side, update its neighbour's pull (below)
          atomicAdd(&pv[u], dv);
          pulled = part[u] == 1 - side;
        }
        // the row's first slot naming u claims it: in this warp the lowest
        // lane of the match, before it a scan of the earlier slots
        const unsigned same = __match_any_sync(kFull, pulled ? u : -1 - lane);
        if (!pulled) continue;
        atomicAdd(&sh.pw, vw[u]);
        ++t.ops;
        st.pull_list[atomicAdd(&sh.n_pull, 1)] = u;
        bool first = (same & ((1u << lane) - 1u)) == 0;
        for (int q = j - lane - 1; q >= 0 && first; --q) first = row[q] != u;
        if (first) {
          st.journal[jlen + atomicAdd(&sh.n_log, 1)] = u << 2 | (1 - side);
          if (!(flags[u] & 3)) {  // neither moved nor locked: staged
            cand[cnt + atomicAdd(&sh.n_add, 1)] = u;
            t.draws += 2;
          }
        }
      }
      if (tid == 0) st.journal[jlen + atomicAdd(&sh.n_log, 1)] = v << 2 | 2;
    }
    __syncthreads();  // pull list, staged entries, journal, pw complete
    if (ok) {
      pulled_w = sh.pw;
      const int np = sh.n_pull, na = sh.n_add;
      for (int k = tid; k < np; k += kThreads) part[st.pull_list[k]] = 2;
      if (tid == 0) {
        part[v] = (int8_t)side;
        flags[v] |= 1;
        cand[bp] = cand[cnt + na - 1];  // v's place: the last entry
        t.ops += 12;  // the balances, the separator weight, the best test
      }
      // each pulled x leaves side 1-side: its neighbours' pull shrinks
      float* pu = side == 0 ? pulled0 : pulled1;
      for (int k = warp; k < np; k += kWarps) {
        const int x = st.pull_list[k];
        const int lx = extent(rlen, x, d);
        const int* rx = tile + (int64_t)x * d;
        const float wx = -vw[x];
        for (int j = lane; j < lx; j += 32) {
          const int u = rx[j];
          if ((unsigned)u < (unsigned)n) {
            atomicAdd(&pu[u], wx);
            ++t.ops;
          }
        }
      }
      cnt += na - 1;
      jlen += sh.n_log;
    }
    w0 = w0 + (side == 0 ? dv : 0.f) - (side == 1 ? pulled_w : 0.f);
    w1 = w1 + (side == 1 ? dv : 0.f) - (side == 0 ? pulled_w : 0.f);
    ws = ws - dv + pulled_w;
    const float imb_new = fabsf(w0 - w1);
    if (ws < bws && imb_new <= fmaxf(eps_abs, bimb)) {
      bws = ws;
      bimb = fminf(imb_new, bimb);
      best_j = jlen;
    }
    alive = ok;
    __syncthreads();  // this move's writes are visible to the next scan
  }
}

// Undo the journal's entries [from, to): each vertex takes the old value of
// its earliest entry there, which is its value at entry `from`.  The
// journal must be visible; ends with a barrier.
__device__ void undo(const LaneState& st, int from, int to) {
  for (int k = from + threadIdx.x; k < to; k += kThreads)
    st.first[st.journal[k] >> 2] = INT_MAX;
  __syncthreads();
  for (int k = from + threadIdx.x; k < to; k += kThreads)
    atomicMin(&st.first[st.journal[k] >> 2], k);
  __syncthreads();
  for (int k = from + threadIdx.x; k < to; k += kThreads) {
    const int e = st.journal[k];
    if (st.first[e >> 2] == k) st.part[e >> 2] = (int8_t)(e & 3);
  }
  __syncthreads();
}

// Write a lane's results: its part, separator weight and imbalance, and
// the tally summed over the block.  `part` must be visible.
__device__ void finish_lane(int l, int n, const LaneState& st, float bws,
                            float bimb, const Tally& t, Shared& sh,
                            int8_t* parts_out, float* sep_w_out,
                            float* imb_out, long long* stats_out) {
  atomicAdd(&sh.tally[0], (unsigned long long)t.ops);
  atomicAdd(&sh.tally[1], (unsigned long long)t.draws);
  for (int v = threadIdx.x; v < n; v += kThreads)
    parts_out[(int64_t)l * n + v] = st.part[v];
  __syncthreads();
  if (threadIdx.x == 0) {
    sep_w_out[l] = bws;
    imb_out[l] = bimb;
    stats_out[3 * l] = t.steps;
    stats_out[3 * l + 1] = (long long)sh.tally[0];
    stats_out[3 * l + 2] = (long long)sh.tally[1];
  }
}

// The lane's tile and row extents, or none for a lane_work outside [0, W).
struct Tile {
  const int* ids;
  const int* rlen;
};

__device__ Tile lane_tile(const int* nbr, const int* row_len,
                          const int* lane_work, int l, int W, int n, int d) {
  const int w = lane_work[l];
  if ((unsigned)w >= (unsigned)W) return {nullptr, nullptr};
  return {nbr + (int64_t)w * n * d, row_len + (int64_t)w * n};
}

// All passes of one lane: per pass, derive the noise subkey, recompute the
// pulled weights, build the candidate list and draw the noise pairs, run the
// move loop, undo back to the best state.
__global__ void __launch_bounds__(kThreads, 1)
fm_fused_kernel(const int* __restrict__ nbr, const int* __restrict__ row_len,
                const int* __restrict__ lane_work,
                const float* __restrict__ vwgt,
                const int8_t* __restrict__ parts_in,
                const uint8_t* __restrict__ locked,
                const int64_t* __restrict__ keys,
                const float* __restrict__ eps_abs_in,
                const int* __restrict__ max_moves_in,
                const int* __restrict__ n_pert_in, int8_t* parts_out,
                float* sep_w_out, float* imb_out, long long* stats_out,
                uint8_t* scratch, int64_t stride, int W, int n, int d,
                int group, int passes, int pos_only, int place) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) uint8_t smem[];
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const Tile tile = lane_tile(nbr, row_len, lane_work, l, W, n, d);
  const LaneState st =
      lane_state(scratch + (int64_t)l * stride, smem, place,
                 vwgt + (int64_t)l * n, tile.rlen, n, d);
  const float* vw = st.vw;
  const int* rlen = st.rlen;
  const uint8_t* lk = locked + (int64_t)l * n;
  const float eps_abs = eps_abs_in[l];
  const int max_moves = max_moves_in[l];
  const int n_pert = n_pert_in[l];

  for (int v = tid; v < n; v += kThreads)
    st.part[v] = parts_in[(int64_t)l * n + v];
  if (tid < 2) sh.tally[tid] = 0;
  float w0, w1, ws;
  part_sums(st.part, vw, n, sh, w0, w1, ws);  // each thread its own v
  float bws = ws, bimb = fabsf(w0 - w1);
  Tally t = {0, 0, 0};

  for (int p = 0; p < passes && max_moves > 0; ++p) {
    if (p > 0) part_sums(st.part, vw, n, sh, w0, w1, ws);
    if (tid == 0) {
      sh.cnt = 0;
      sh.sub = pass_key(keys + 2 * (int64_t)l, p);
    }
    t.ops += 2LL * recompute_pulled(tile.ids, rlen, st.part, vw, st.pulled0,
                                    st.pulled1, n, d, group, sh);
    build_candidates(st, lk, n, sh, t);
    __syncthreads();  // the list, its count and its noise pairs
    int best_j, jlen;
    move_loop(tile.ids, rlen, vw, st, sh.cnt, n, d, eps_abs, max_moves,
              p == 0 ? n_pert : 0, pos_only, w0, w1, ws, bws, bimb, sh,
              best_j, jlen, t);
    undo(st, best_j, jlen);
  }
  __syncthreads();
  finish_lane(l, n, st, bws, bimb, t, sh, parts_out, sep_w_out, imb_out,
              stats_out);
}

// Pass p of one lane, with the pulled weights given (the hoisted path: the
// gains come from sep_gain.cu).  bws and bimb are carried in from the
// previous pass: bimb is a running minimum, not a function of part.
__global__ void __launch_bounds__(kThreads, 1)
fm_move_loop_kernel(const int* __restrict__ nbr,
                    const int* __restrict__ row_len,
                    const int* __restrict__ lane_work,
                    const float* __restrict__ vwgt,
                    const int8_t* __restrict__ parts_in,
                    const uint8_t* __restrict__ locked,
                    const float* __restrict__ pulled0_in,
                    const float* __restrict__ pulled1_in,
                    const int64_t* __restrict__ keys,
                    const int* __restrict__ pert_in,
                    const float* __restrict__ eps_abs_in,
                    const int* __restrict__ max_moves_in,
                    const float* __restrict__ bws_in,
                    const float* __restrict__ bimb_in, int8_t* parts_out,
                    float* sep_w_out, float* imb_out, long long* stats_out,
                    uint8_t* scratch, int64_t stride, int W, int n, int d,
                    int p, int pos_only, int place) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) uint8_t smem[];
  const int l = blockIdx.x;
  const int tid = threadIdx.x;
  const Tile tile = lane_tile(nbr, row_len, lane_work, l, W, n, d);
  const LaneState st =
      lane_state(scratch + (int64_t)l * stride, smem, place,
                 vwgt + (int64_t)l * n, tile.rlen, n, d);
  const float* vw = st.vw;
  const int* rlen = st.rlen;
  const uint8_t* lk = locked + (int64_t)l * n;
  const int max_moves = max_moves_in[l];

  for (int v = tid; v < n; v += kThreads) {
    const int64_t k = (int64_t)l * n + v;
    st.part[v] = parts_in[k];
    st.pulled0[v] = pulled0_in[k];
    st.pulled1[v] = pulled1_in[k];
  }
  if (tid < 2) sh.tally[tid] = 0;
  if (tid == 0) {
    sh.cnt = 0;
    sh.sub = pass_key(keys + 2 * (int64_t)l, p);
  }
  float w0, w1, ws;
  part_sums(st.part, vw, n, sh, w0, w1, ws);  // syncs: state is copied
  float bws = bws_in[l], bimb = bimb_in[l];
  Tally t = {0, 0, 0};
  if (max_moves > 0) {
    build_candidates(st, lk, n, sh, t);
    __syncthreads();  // the list, its count and its noise pairs
    int best_j, jlen;
    move_loop(tile.ids, rlen, vw, st, sh.cnt, n, d, eps_abs_in[l], max_moves,
              pert_in[l], pos_only, w0, w1, ws, bws, bimb, sh, best_j, jlen,
              t);
    undo(st, best_j, jlen);
  }
  __syncthreads();
  finish_lane(l, n, st, bws, bimb, t, sh, parts_out, sep_w_out, imb_out,
              stats_out);
}

// Bytes of the hot state (pulled0/1, the list, the vertex weights and row
// extents, the pulled slots, part, flags), with the noise pairs or without,
// and whether they fit in shared memory beside `Shared`: a block has at
// most 232,448 bytes.
int64_t hot_bytes(int n, int d, bool pairs) {
  return 22LL * n + 4LL * d + (pairs ? 8LL * n : 0LL);
}
bool fits(int64_t bytes) { return bytes + (int64_t)sizeof(Shared) <= 232448; }

// Launch `kernel` with the hot state in dynamic shared memory where it
// fits, else in the scratch, and the noise pairs beside it where they fit
// too.
template <typename Kernel, typename... Args>
cudaError_t launch_lanes(Kernel kernel, int L, int n, int d, cudaStream_t s,
                         Args... args) {
  const bool hot = fits(hot_bytes(n, d, false));
  const bool pairs = fits(hot_bytes(n, d, true));
  const int place = (hot ? kHotShared : 0) | (pairs ? kPairsInSmem : 0);
  const int bytes = hot ? (int)hot_bytes(n, d, pairs) : 0;
  if (bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<L, kThreads, bytes, s>>>(args..., place);
  return cudaGetLastError();
}

}  // namespace

// Bytes of per-lane state: pulled0/1, the noise pairs (8n), the candidate
// list, the journal (3n), the undo's marks, the pulled-slot list (d), part
// and flags: 38n + 4d.  The wrapper (kernels/fm_fused.py, state_bytes)
// uses the same formula.
static int64_t state_bytes(int n, int d) { return 38LL * n + 4LL * d; }

// The state lives in `scratch`, one 256-byte-aligned slice per lane.
// keys: (L, 2) int64 words, the lanes' PRNG keys.  group: threads a
// recompute row (a power of two <= 32, from the row extents).
extern "C" int fm_fused_launch(const void* nbr, const void* row_len,
                               const void* lane_work, const void* vwgt,
                               const void* parts_in, const void* locked,
                               const void* keys, const void* eps_abs,
                               const void* max_moves, const void* n_pert,
                               void* parts_out, void* sep_w, void* imb,
                               void* stats, void* scratch, int L, int W,
                               int n, int d, int group, int passes,
                               int pos_only, void* stream) {
  if (L == 0) return (int)cudaGetLastError();
  if (group <= 0 || group > 32 || (group & (group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t stride = (state_bytes(n, d) + 255) / 256 * 256;
  return (int)launch_lanes(
      fm_fused_kernel, L, n, d, (cudaStream_t)stream, (const int*)nbr,
      (const int*)row_len, (const int*)lane_work, (const float*)vwgt,
      (const int8_t*)parts_in, (const uint8_t*)locked, (const int64_t*)keys,
      (const float*)eps_abs, (const int*)max_moves, (const int*)n_pert,
      (int8_t*)parts_out, (float*)sep_w, (float*)imb, (long long*)stats,
      (uint8_t*)scratch, stride, W, n, d, group, passes, pos_only);
}

// Pass p per lane with given pulled weights: keys are the lanes' (L, 2)
// PRNG keys, from which the kernel draws pass p's noise, and pert the
// lanes' perturbed-move counts.
extern "C" int fm_move_loop_launch(
    const void* nbr, const void* row_len, const void* lane_work,
    const void* vwgt, const void* parts_in, const void* locked,
    const void* pulled0, const void* pulled1, const void* keys,
    const void* pert, const void* eps_abs, const void* max_moves,
    const void* bws_in, const void* bimb_in, void* parts_out, void* sep_w,
    void* imb, void* stats, void* scratch, int L, int W, int n, int d,
    int p, int pos_only, void* stream) {
  if (L == 0) return (int)cudaGetLastError();
  const int64_t stride = (state_bytes(n, d) + 255) / 256 * 256;
  return (int)launch_lanes(
      fm_move_loop_kernel, L, n, d, (cudaStream_t)stream,
      (const int*)nbr, (const int*)row_len, (const int*)lane_work,
      (const float*)vwgt, (const int8_t*)parts_in, (const uint8_t*)locked,
      (const float*)pulled0, (const float*)pulled1, (const int64_t*)keys,
      (const int*)pert, (const float*)eps_abs, (const int*)max_moves,
      (const float*)bws_in, (const float*)bimb_in, (int8_t*)parts_out,
      (float*)sep_w, (float*)imb, (long long*)stats, (uint8_t*)scratch,
      stride, W, n, d, p, pos_only);
}
