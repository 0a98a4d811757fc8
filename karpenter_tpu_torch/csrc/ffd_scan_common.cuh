// The FFD scan shared by K5 ffd_batch_scan (and its gang instance), K4
// ffd_sweep_scan (both lanes), K6 ffd_delta_scan and K7 ffd_sharded_scan:
// one templated kernel, `scan_kernel<TOPO, SWEEP, GANG, SEED, SHARDED>`,
// that runs the
// whole G-step scan of karpenter_tpu/solver/ffd.py `_solve_ffd_impl`
// (ffd.py:210, scanned at :1062) for B problems in one launch, one thread
// block per problem (the reference's `jax.vmap` axis, ffd.py:1492, :1531,
// :1610).
//
//   * light_step: the light branch, ffd.py:460-587 (`_fit_count` :116,
//     `_prefix_fill` :125, `_atomic_fill` :134, `_clamp_pool_limits` :442,
//     `pt_any`/`pt_expand` :381-390), for every class without a domain
//     constraint;
//   * heavy_step: the heavy branch, ffd.py:589-818, for classes with
//     dsel > 0 (zone or capacity-type spread and anti-affinity): per-domain
//     capacity estimates, the `_water_fill` quotas (:147-196), per-domain
//     prefix fills of existing and in-flight nodes, the pool x domain
//     new-node budget loop, each touched or opened node pinned to its
//     domain.  Only the TOPO instances compile it (`if constexpr`), the
//     reference's `lax.cond(dsel > 0, heavy, light)` (:1057), uniform across
//     the block;
//   * gang_step: the atomic K-node gang fill, ffd.py:820-1047, for groups
//     with group_gang set, compiled only into the GANG instance (the
//     reference's `with_gang` static, ffd.py:1049-1056): for every domain
//     the light cascade restricted to that domain against its own copy of
//     the pool budget, evaluated without touching the carry; the feasible
//     domain of lowest trial rank is then evaluated once more and
//     committed, every node it touches pinned to it;
//   * SWEEP: the problem is a consolidation simulation, "the shared snapshot
//     minus a few nodes" (ffd.py:1570): the block keeps the existing rows
//     its exclusions leave, reads its groups' column masks and node caps
//     from per-class tables (`class_mask[gcls]`, `class_cap[gcls] * keep`)
//     and ANDs in its price cap (`col_price < pcap`) as a word mask;
//   * SEED: the scan starts from a seeded carry instead of zeros (the
//     delta path's `solve_ffd_delta`, ffd.py:406-427 and :1403): used,
//     pool and active per node slot and the first A slots' surviving
//     column words come from a prefix the host replayed, the active count
//     is the count of seeded slots, the zone and capacity-type pins stay
//     -1, and exist_remaining arrives already consumed;
//   * SHARDED (K7, ffd_sharded_scan.cu): one problem on a column-sharded
//     catalog, the reference's `shard_map` program (ffd.py:1372, :1446;
//     parallel/mesh.py): S thread blocks in ONE thread-block cluster, block
//     r owning the r-th contiguous shard of the offering columns O (and of
//     the (pool,type) axis PT in lockstep) and of the resident mask table,
//     with the group-scan state replicated in every block.  Each
//     column-axis reduction runs locally and is combined across the cluster
//     through distributed shared memory (`cluster_combine`): the per-node
//     best fit and the per-pool best column of the light step, the per-node
//     slot maxima and the [P, D] best column of the heavy and gang steps
//     (the reference's `_axmax`/`_axany` pmax, ffd.py:93-113, :490, :527,
//     :632, :649, :667, :894, :918); the grid-slot domain pattern is shard
//     0's leading block (its all_gather, :631, :893, :1161); and the
//     explain=1 elimination counts are summed over the shards in the
//     epilogue (its psum, :1202), the slot class joining after the sum;
//   * with K > 0 the take_exist top-K compaction (:1068-1086) in the
//     epilogue: a block scan ranks each group's nonzero entries;
//   * with a priority row, the priority inversion witness (:1238-1257) in
//     the epilogue: one thread walks the groups with the exclusive running
//     max of the stranded groups' priorities (integers only, exact).
// The packed-mask expansion `_expand_packed_mask` (:199) disappears: the
// kernels read the group mask as bits.  Results land in the flat result
// row of ffd.py:1258, one row per problem.
//
// What bounds it on the H100: not bytes and not arithmetic.  A problem's
// inputs are a few hundred KB (catalog rows, one 480-byte mask row per
// class, the existing rows), its outputs tens of KB, and its float work
// tens of millions of operations at most: both bounds are microseconds.
// Each problem's scan is a dependency chain, steps x pools (x domains in the
// heavy step) long, with block-wide barriers inside each step: its time is
// latency, on one SM.  The batch axis spreads problems over SMs.
//
// Design: one thread block of 1024 threads per problem (block b offsets every
// per-problem pointer to problem b, offset_block).  The carry lives in
// device memory, one slice per block: the surviving-column mask as u32
// bit-words in [N, W] layout (one node's words in one run), used [N, R],
// the pool budgets [P, R], the existing-node remainders [E, R], and each
// node's zone and capacity-type pin.  The per-node column work — the best
// fit over a node's surviving admitted (pool,type) blocks, in the heavy
// step per grid slot, and the colmask narrowing of touched and opened
// nodes — is one tile of lanes per node (tile_best, tile_slotmax,
// tile_narrow): a tile is 1 to 32 lanes of one warp, as wide as lets every
// node the step walks have its own tile at once (so a step over 15 nodes
// gives each a warp, one over 782 each a thread); the tiles take the nodes
// in turn, a tile's lanes take whole lcm(ZC, 32)-column chunks of the
// node's row in turn and test once per (pool,type) block that holds a bit
// (ffd_walk.cuh), the lanes' maxima combine with an exact warp max, and the
// capacity walk stops once a lane reaches the group's per-node cap.  Only
// slots below the highest active one (slots open in index order) are
// walked.  The rest is thread-parallel over nodes, existing rows or
// columns: block scans give the node-axis and
// existing-axis cumsums (`_prefix_fill`, `_clamp_pool_limits`, and per
// domain in the heavy step), shared-memory atomics the per-pool and
// per-(pool, domain) maxima, and the short sequential loops (the per-pool
// new-node cascade, the pool x domain budget loop, the water-fill's
// integral repair) run on thread 0 before the slots they open are
// activated.  The water-fill evaluates its 6D candidate levels one per
// thread.  Work is skipped where the reference's is a provable no-op: the
// fit runs only over blocks that hold a surviving, admitted column, and
// the ok-block narrowing only on nodes that took pods (an untouched node's
// mask is already narrowed against its unchanged `used`).  (pool, type)
// rows sit in shared memory.
//
// Float parity: every operation is the reference's, in its order, rounded
// to nearest (ffd_common.cuh); float sums over domains run in index order.
// Integer sums that the reference takes in int32 wrap modulo 2^32 here too
// (unsigned arithmetic).  Pool-limit and pool-take arithmetic is on
// integer-valued float32 terms, exact below 2^24 in any order.
#pragma once

#include "ffd_common.cuh"

#include <cooperative_groups.h>
#include <limits.h>

namespace cg = cooperative_groups;

#define NT 1024
#define MAXP 64
#define MAXD 128
#define MAXZC 64

struct ScanArgs {
  // problem (per solve)
  const float* group_req;        // [G, R]
  const int* group_count;        // [G]
  const uint32_t* mask_bits;     // [G, W] bit o%32 of word o/32 = column o
  const int* exist_cap;          // [G, E]
  const float* exist_remaining;  // [E, R]
  const float* pool_limit;       // [P, R]
  const int* group_ncap;         // [G]
  const int* group_whole;        // [G] 0/1
  // catalog (resident)
  const float* col_alloc;        // [O, R]
  const float* col_daemon;       // [O, R]
  const float* pt_alloc;         // [PT, R]
  const int* col_pool;           // [O]
  const float* pool_daemon;      // [P, R]
  const uint32_t* pool_bits;     // [P, W] columns of each pool
  // carry (scratch)
  float* exist_rem;              // [E, R]
  float* used;                   // [N, R]
  uint32_t* colmask;             // [N, W]
  int* active;                   // [N]
  int* node_pool;                // [N]
  int* cap_e;                    // [E]
  float* limits;                 // [P, R] carry, final budgets on exit
  // outputs (float32, the flat layout of ffd.py:1258)
  float* take_exist;             // [G, E]
  float* take_new;               // [G, N]
  float* unsched;                // [G]
  float* dom_placed;             // [G, D]
  float* used_out;               // [N, R]
  float* pool_out;               // [N]
  float* zone_out;               // [N]
  float* ct_out;                 // [N]
  float* na_out;                 // [1]
  // topology (read by the TOPO instances only)
  const int* group_dsel;         // [G] 0 none / 1 zone / 2 capacity type
  const int* group_dbase;        // [G, D] spread base counts
  const int* group_dcap;         // [G, D] max additional pods per domain
  const int* group_skew;         // [G]
  const int* group_mindom;       // [G] (0 = unset)
  const int* group_delig;        // [G, D] 0/1 eligible for the skew min
  const int* exist_zone;         // [E]
  const int* exist_ct;           // [E]
  const int* col_zone;           // [O] (padding carries the block pattern)
  const int* col_ct;             // [O]
  int* node_zone;                // [N] carry (scratch)
  int* node_ct;                  // [N] carry (scratch)
  // the consolidation sweep (K4): per-simulation gather and price cap
  const int* group_class;        // [G] row of the class tables (mask_bits
                                 // [C, W], exist_cap [C, E]); null = g
  const int* exclude_idx;        // [X] existing rows excluded (-1 = pad)
  const float* price_cap;        // [1] columns priced below it survive
  const float* col_price;        // [O] (+inf on padding)
  // the take_exist top-K compaction (K > 0)
  float* te_dense;               // [G, E] scratch: the dense rows
  float* te_head;                // flat: counts [G, K], indices [G, K]
  // gangs (the GANG instance) and priority bands (the witness)
  const int* group_gang;         // [G] 0/1 gang unit
  const int* group_prio;         // [G] effective priority
  float* prio_inv;               // [G] (flat) the witness; null = none
  // the seeded start (the SEED instance): the prefix's carry
  const float* seed_used;        // [N, R]
  const int* seed_pool;          // [N]
  const int* seed_active;        // [N] 0/1
  const uint32_t* seed_colmask;  // [A, W] surviving-column words per slot
  // the column-sharded scan (the SHARDED instance): every column-axis
  // pointer above addresses shard 0 of [S, ...] stacked shards, and O, PT
  // and W are one shard's; mask_bits is the resident mask table [S, C, W]
  const int* mask_rows;          // [G] each group's row of the mask table
  int* xslot;                    // [S, N*ZC + 4G] scratch: per-node slot
                                 // maxima, then the pack's [G, 4] counts
  float* ex_counts;              // [G, 5] (flat) explain=1 counts, or null
  float* ex_bits;                // [G]    (flat)
  float* row0;                   // the flat row block 0 writes (the caller's)
  float* xrow;                   // [S-1, total] then [S-1, P, R] scratch: the
                                 // other blocks' flat rows and pool budgets
  int G, E, N, O, PT, ZC, P, D, W;
  int B, X, K, total;            // problems, exclusions, top-K, flat row
  int A;                         // seeded colmask rows (0 = not seeded)
  int C, S;                      // mask-table rows, shards (SHARDED)
};
// Every pointer above addresses problem 0 of the batch; block b offsets the
// per-problem ones (inputs, carry, the flat row) in offset_block.

#define SCAN_NPTRS 61
#define SCAN_NDIMS 16
#define MAXX 8
#define BIGCAP 536870912  /* encode.BIG: no per-node cap */

// per-step state every thread reads, in shared memory
struct ScanShared {
  unsigned warp[NT / 32];
  float req[KR];
  int cnt, ncap, whole, dsel, gang, first, sum, na, crem;
  int hi0;                // 1 + the highest seeded active slot (0 unseeded)
  int row;               // this group's row of the (class) tables
  int nx, excl[MAXX];    // the sweep simulation's excluded existing rows
  int dreal_zone, dreal_ct;
  int kfull[MAXP], any[MAXP], ptake[MAXP], limcap[MAXP];
  int start[MAXP], m[MAXP], taken[MAXP];
};

// the dynamic shared arrays (sizes depend on the problem)
struct ScanDyn {
  float* pt;      // [PT, R]
  int* cap;       // [N]
  int* take;      // [N]
  uint32_t* gm;   // [W]
  uint32_t* feas; // [W]
  int* bd;        // [N]     (TOPO) each node's domain this step
  int* kpd;       // [P, D]  (TOPO) best pods per new node, per pool, domain
  uint32_t* pm;   // [W]     (SWEEP) columns under the price cap
  uint32_t* csum; // [N, NS] each node's chunk summary (tile_best), then
                  // [NS] the step's group mask's (gsum)
};

// the step's group mask's chunk summary, after the nodes' in s.csum
__device__ __forceinline__ uint32_t* gsum_of(const ScanDyn& s, int N,
                                             int NS) {
  return s.csum + (size_t)N * NS;
}

// whether existing row e survives the simulation's exclusions (the
// reference's keep = all(arange(E) != excl), ffd.py:1571)
__device__ __forceinline__ bool kept(const ScanShared& S, int e) {
  for (int x = 0; x < S.nx; ++x)
    if (S.excl[x] == e) return false;
  return true;
}

// the group's per-existing-node allowance: its table row, times keep
__device__ __forceinline__ int exist_cap_at(const ScanArgs& a,
                                            const ScanShared& S, int e) {
  const int c = a.exist_cap[(size_t)S.row * a.E + e];
  return kept(S, e) ? c : 0;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// -(-t // kf): the reference's ceil-divide on floor division
__device__ __forceinline__ int ceil_div(int t, int kf) {
  return -floor_div(-t, kf);
}

// _prefix_fill's take for one slot: clip(min(cap, want - before), 0)
__device__ __forceinline__ int prefix_take(int cap, int want,
                                           unsigned before) {
  return max(min(cap, wsub(want, before)), 0);
}

#define FULLMASK 0xffffffffu
#define ALL_SLOTS (~0ull)

// node n's surviving-column words in the carry, [N, W]: one node's W words
// in one run, the run its tile reads
__device__ __forceinline__ uint32_t* node_words(const ScanArgs& a, int n) {
  return a.colmask + (size_t)n * a.W;
}

// the grid slots of domain d as a slot mask (bit z: zcdom[z] == d)
__device__ __forceinline__ uint64_t dom_slots(const int* zcdom, int ZC,
                                              int d) {
  uint64_t m = 0ull;
  for (int z = 0; z < ZC; ++z)
    if (zcdom[z] == d) m |= 1ull << z;
  return m;
}

// The per-node column walk, one tile of L lanes per node (L a power of two,
// at most 32: L consecutive lanes of one warp).  Each node keeps a summary
// of its row in shared memory (s.csum, [N, NS] words: bit c % 32 of word
// c / 32 set when chunk c may hold a bit, and set for every chunk that
// does), so a walk visits only the chunks that can hold a bit: the tile's
// lanes take those chunks (ffd_walk.cuh lane_*, whole blocks each) in
// turn, the j-th set bit of a summary word to lane j % L, and combine with
// an exact max.  Every lane of the tile calls, with the same node.

// Lanes per node: the widest tile that still gives each of `nodes` nodes
// its own tile at once (the block's NT threads over the nodes), and no
// wider than the row's nch chunks need.  A step over many nodes walks
// them side by side, thread by thread; a step over a few splits each
// node's walk over a warp.
__device__ __forceinline__ int tile_width(int nodes, int nch) {
  int L = 32;
  while (L > 1 && (L * nodes > NT || (L >> 1) >= nch)) L >>= 1;
  return L;
}

// this thread's tile of L lanes, as a shuffle mask
__device__ __forceinline__ unsigned tile_mask(int L) {
  const int lane = threadIdx.x & 31;
  return L == 32 ? FULLMASK : ((1u << L) - 1u) << (lane & ~(L - 1));
}

// min(best fit over the blocks with a bit of row & gm in `slots`, ncap);
// the tile stops once any lane's best reaches ncap (the min is then ncap)
__device__ __forceinline__ int tile_best(int L, const uint32_t* row,
                                         const uint32_t* sum,
                                         const uint32_t* gsum, int NS,
                                         const uint32_t* gm, int W, int ZC,
                                         uint64_t slots, const float* s_pt,
                                         const float* u, const float* req,
                                         int ncap) {
  const unsigned tm = tile_mask(L);
  const int t = threadIdx.x & (L - 1);
  int best = 0;
  for (int sw = 0; sw < NS; ++sw) {
    best = lane_best(row, gm, sum[sw] & gsum[sw], sw, t, L, W, ZC, slots,
                     s_pt, u, req, best);
    if (__any_sync(tm, best >= ncap)) return ncap;
  }
  return min(__reduce_max_sync(tm, best), ncap);
}

// slotmax[ZC] (every lane's copy): per grid slot, the max block fit over
// the blocks whose bit of row & gm in that slot survives
__device__ __forceinline__ void tile_slotmax(int L, const uint32_t* row,
                                             const uint32_t* sum,
                                             const uint32_t* gsum, int NS,
                                             const uint32_t* gm, int W,
                                             int ZC, const float* s_pt,
                                             const float* u,
                                             const float* req,
                                             int* slotmax) {
  const unsigned tm = tile_mask(L);
  const int t = threadIdx.x & (L - 1);
  for (int z = 0; z < ZC; ++z) slotmax[z] = 0;
  for (int sw = 0; sw < NS; ++sw)
    lane_slotmax(row, gm, sum[sw] & gsum[sw], sw, t, L, W, ZC, s_pt, u, req,
                 slotmax);
  if (L > 1)
    for (int z = 0; z < ZC; ++z)
      slotmax[z] = __reduce_max_sync(tm, slotmax[z]);
}

// A touched node's row in place: row & gm in `slots`, narrowed to the
// (pool,type) blocks whose allocatable still holds `u` (pt_expand(ok_pt));
// only the chunks its summary marks can hold a bit, and those left empty
// leave the summary.
__device__ __forceinline__ void tile_narrow(int L, uint32_t* row,
                                            uint32_t* sum,
                                            int NS, const uint32_t* gm,
                                            int W, int ZC, uint64_t slots,
                                            const float* s_pt,
                                            const float* u) {
  const unsigned tm = tile_mask(L);
  const int t = threadIdx.x & (L - 1);
  for (int sw = 0; sw < NS; ++sw) {
    const uint32_t had = sum[sw];
    const uint32_t emptied = __reduce_or_sync(
        tm, lane_narrow(row, gm, had, sw, t, L, W, ZC, slots, s_pt, u));
    if (t == 0) sum[sw] = had & ~emptied;
  }
}

// An opened node's row: src_a & src_b (its feasible columns and its
// pool's) in `slots`, narrowed as above, every chunk written (the chunks
// `reach` leaves unmarked, zeros) and the summary rebuilt.
__device__ __forceinline__ void tile_open(int L, uint32_t* row,
                                          uint32_t* sum,
                                          const uint32_t* reach, int NS,
                                          const uint32_t* src_a,
                                          const uint32_t* src_b, int W,
                                          int ZC, uint64_t slots,
                                          const float* s_pt,
                                          const float* u) {
  const unsigned tm = tile_mask(L);
  const int t = threadIdx.x & (L - 1);
  for (int sw = 0; sw < NS; ++sw) {
    const uint32_t held = __reduce_or_sync(
        tm, lane_open(row, src_a, src_b, reach[sw], sw, t, L, W, ZC, slots,
                      s_pt, u));
    if (t == 0) sum[sw] = held;
  }
}

// how many of the first N node slots took pods this step (s_take); also
// the barrier between the takes and the tiles that read them (a step with
// no active slot has neither)
__device__ __forceinline__ int count_touched(const int* s_take, int N) {
  int n = 0;
  for (int base = 0; base < N; base += NT)
    n += __syncthreads_count(base + (int)threadIdx.x < N &&
                             s_take[base + threadIdx.x] > 0);
  return n;
}

// One run of opened slots [st, st + m) of pool p, pinned to domain dom (-1
// none): kfull pods on each node but the last, which takes klast; its
// columns are the pool's feasible ones in the grid slots `slots`.
struct OpenRun {
  int p, st, m, kfull, klast, dom;
  uint64_t slots;
};

// Activates the slots [lo, hi) the cascade opened, in R runs (run(r) gives
// run r, run_of(n) the run that holds slot n or -1).  A new node's row
// depends only on its pool, its grid slots and its pods, so each run's
// first slot and its last (whose pods may differ) are narrowed from the
// feasible columns, a tile each, and every other slot of the run copies
// the first's row and summary, a warp a slot.  Each slot gets its used
// vector, pool and pin, and with take_add its pods added there.  Every
// thread calls.
template <class Run, class RunOf>
__device__ void open_slots(const ScanArgs& a, const ScanDyn& s, int R,
                           Run run, RunOf run_of, int lo, int hi,
                           const float* req, int* node_dom, int* take_add) {
  if (hi <= lo) return;  // nothing opened (uniform)
  const int tid = threadIdx.x, lane = tid & 31, W = a.W, ZC = a.ZC;
  const int NS = summary_words(W, ZC);
  const int L = tile_width(2 * R, row_chunks(W, ZC));
  for (int i = tid / L; i < 2 * R; i += NT / L) {
    const OpenRun o = run(i >> 1);
    if (o.m == 0 || ((i & 1) && o.m < 2)) continue;
    const int n = (i & 1) ? o.st + o.m - 1 : o.st;
    const int k = n == o.st + o.m - 1 ? o.klast : o.kfull;
    float u[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r)
      u[r] = __fadd_rn(a.pool_daemon[o.p * KR + r],
                       __fmul_rn((float)k, req[r]));
    tile_open(L, node_words(a, n), s.csum + (size_t)n * NS,
              gsum_of(s, a.N, NS), NS, s.feas, a.pool_bits + (size_t)o.p * W,
              W, ZC, o.slots, s.pt, u);
  }
  __syncthreads();
  for (int n = lo + (tid >> 5); n < hi; n += NT / 32) {
    const int r = run_of(n);
    if (r < 0) continue;
    const OpenRun o = run(r);
    const bool last = n == o.st + o.m - 1;
    if (n != o.st && !last) {
      const uint32_t* from = node_words(a, o.st);
      uint32_t* to = node_words(a, n);
      for (int w = lane; w < W; w += 32) to[w] = from[w];
      for (int i = lane; i < NS; i += 32)
        s.csum[(size_t)n * NS + i] = s.csum[(size_t)o.st * NS + i];
    }
    if (lane == 0) {
      const int k = last ? o.klast : o.kfull;
#pragma unroll
      for (int r = 0; r < KR; ++r)
        a.used[n * KR + r] = __fadd_rn(a.pool_daemon[o.p * KR + r],
                                       __fmul_rn((float)k, req[r]));
      a.active[n] = 1;
      a.node_pool[n] = o.p;
      if (node_dom) node_dom[n] = o.dom;
      if (take_add) take_add[n] += k;
    }
  }
}

// ---------------------------------------------------------------------------
// the cluster exchange of the column-sharded scan (SHARDED only)

#define XCH 2048  // ints per exchange slot

// Per block: two exchange slots (double-buffered, so one cluster barrier
// per exchange round is enough: a block writes slot p only after the
// barrier that follows every peer's reads of slot p from two rounds
// before), each thread's own slot parity (every thread runs the same
// sequence of exchanges, so the parities stay in step without a shared
// counter), shard 0's leading grid-slot block of the zone and
// capacity-type ids, and a small staging row.
struct ClusterXch {
  int buf[2][XCH];
  unsigned char par[NT];
  int zc0_zone[MAXZC], zc0_ct[MAXZC];
  int tmp[2 * MAXP];
};

__device__ __forceinline__ ClusterXch& xch() {
  __shared__ ClusterXch X;
  return X;
}

// x [L] (shared or device memory) holds this block's local reduction; on
// return every block of the cluster holds the combination over the
// cluster's blocks: the max (the reference's pmax), or with SUM the
// integer sum (its psum).  Both are exact in any order.  In rounds of XCH
// values: each thread copies its values into this round's slot, one
// cluster barrier, then each thread combines its values over every block's
// slot through distributed shared memory.  Every thread of every block
// calls, with the same L.
template <bool SUM>
__device__ void cluster_combine(int* x, int L) {
  cg::cluster_group cl = cg::this_cluster();
  ClusterXch& X = xch();
  const int tid = threadIdx.x;
  const unsigned S = cl.num_blocks();
  __syncthreads();
  for (int base = 0; base < L; base += XCH) {
    const int n = min(XCH, L - base);
    int* slot = X.buf[X.par[tid]];
    for (int i = tid; i < n; i += NT) slot[i] = x[base + i];
    cl.sync();
    for (int i = tid; i < n; i += NT) {
      int v = SUM ? 0 : INT_MIN;
      for (unsigned r = 0; r < S; ++r) {
        const int y = cl.map_shared_rank(slot, r)[i];
        v = SUM ? (int)((unsigned)v + (unsigned)y) : max(v, y);
      }
      x[base + i] = v;
    }
    X.par[tid] ^= 1;
  }
  __syncthreads();
}

// the grid-slot domain ids every block uses: its own leading block, or
// under SHARDED shard 0's (gathered in the prologue)
template <bool SHARDED>
__device__ __forceinline__ const int* slot_zone(const ScanArgs& a) {
  if constexpr (SHARDED) return xch().zc0_zone;
  return a.col_zone;
}

template <bool SHARDED>
__device__ __forceinline__ const int* slot_ct(const ScanArgs& a) {
  if constexpr (SHARDED) return xch().zc0_ct;
  return a.col_ct;
}

// the pool whose new nodes the cascade opened at slot n ([start[p],
// start[p] + m[p])), or -1
__device__ __forceinline__ int opened_pool(const ScanShared& S, int P,
                                           int n) {
  for (int p = 0; p < P; ++p)
    if (S.m[p] > 0 && n >= S.start[p] && n < S.start[p] + S.m[p]) return p;
  return -1;
}

// the pods the cascade put on opened slot n of pool p: k_full, the last
// node the remainder
__device__ __forceinline__ int opened_pods(const ScanShared& S, int p,
                                           int kfull, int n) {
  return (n - S.start[p] == S.m[p] - 1) ? S.taken[p] - wmul(S.m[p] - 1, kfull)
                                        : kfull;
}

// ---------------------------------------------------------------------------
// the light step (ffd.py:460-587)
template <bool SHARDED>
__device__ void light_step(const ScanArgs& a, ScanShared& S,
                           const ScanDyn& s, int g) {
  const int tid = threadIdx.x;
  const int E = a.E, N = a.N, O = a.O, ZC = a.ZC, P = a.P, D = a.D,
            W = a.W;
  // every active slot lies below hi (slots open in index order)
  const int hi = max(S.hi0, S.na), NS = summary_words(W, ZC);
  float req[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) req[r] = S.req[r];
  const int cnt = S.cnt, ncap = S.ncap;
  const bool whole = S.whole != 0;

  // -- 1. existing nodes --------------------------------------------------
  int c1 = cnt;
  if (E > 0) {
    for (int e = tid; e < E; e += NT) {
      const int cap = min(fit_count(&a.exist_rem[e * KR], req),
                          exist_cap_at(a, S, e));
      a.cap_e[e] = cap;
      if (whole && cap >= cnt) atomicMin(&S.first, e);
    }
    __syncthreads();
    const int first = S.first;
    unsigned carry = 0u;
    for (int base = 0; base < E; base += NT) {
      const int e = base + tid;
      const int cap = e < E ? a.cap_e[e] : 0;
      unsigned tot;
      const unsigned before =
          block_excl_scan<NT>((unsigned)cap, S.warp, &tot) + carry;
      carry += tot;
      if (e < E) {
        // whole-node groups: ALL-or-nothing on the first slot that holds
        // the entire group (_atomic_fill)
        const int take = whole ? ((e == first && cnt > 0) ? cnt : 0)
                               : prefix_take(cap, cnt, before);
        a.take_exist[(size_t)g * E + e] = (float)take;
        if (take != 0) {
#pragma unroll
          for (int r = 0; r < KR; ++r)
            a.exist_rem[e * KR + r] = __fsub_rn(
                a.exist_rem[e * KR + r], __fmul_rn((float)take, req[r]));
          atomicAdd(&S.sum, take);
        }
      }
    }
    __syncthreads();
    c1 = cnt - S.sum;
    __syncthreads();
    if (tid == 0) {
      S.sum = 0;
      S.first = INT_MAX;
    }
  }

  // -- 2. in-flight nodes -------------------------------------------------
  // per-node capacity: the best fit over (pool,type) blocks that still hold
  // a surviving column the group admits, capped by the group's per-node
  // cap; inactive slots hold nothing.  One tile of lanes per active node.
  for (int n = tid; n < N; n += NT)
    if (n >= hi || !a.active[n]) s.cap[n] = 0;
  const int Lc = tile_width(hi, row_chunks(W, ZC));
  for (int n = tid / Lc; n < hi; n += NT / Lc) {
    if (!a.active[n]) continue;
    float u[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) u[r] = a.used[n * KR + r];
    const int cap = tile_best(Lc, node_words(a, n), s.csum + (size_t)n * NS,
                              gsum_of(s, N, NS), NS, s.gm, W, ZC, ALL_SLOTS,
                              s.pt, u, req, ncap);
    if ((tid & (Lc - 1)) == 0) s.cap[n] = cap;
  }
  if (tid < P) S.limcap[tid] = fit_count(&a.limits[tid * KR], req);
  __syncthreads();
  // the best over every shard's blocks (min with the cap commutes)
  if constexpr (SHARDED) cluster_combine<false>(s.cap, N);

  // pool limits are collective: each node's cap is clamped by what its
  // pool's budget leaves after lower-index nodes of the same pool take
  // theirs; whole-node groups clamp against the full budget instead
  if (whole) {
    for (int n = tid; n < N; n += NT)
      s.cap[n] = min(s.cap[n], S.limcap[a.node_pool[n]]);
  } else {
    for (int p = 0; p < P; ++p) {
      unsigned carry = 0u;
      for (int base = 0; base < N; base += NT) {
        const int n = base + tid;
        const bool mine = n < N && a.node_pool[n] == p;
        const int v = mine ? s.cap[n] : 0;
        unsigned tot;
        const unsigned before =
            block_excl_scan<NT>((unsigned)v, S.warp, &tot) + carry;
        carry += tot;
        if (mine) s.cap[n] = min(v, max(wsub(S.limcap[p], before), 0));
      }
    }
  }
  __syncthreads();

  if (whole) {
    for (int n = tid; n < N; n += NT)
      if (s.cap[n] >= c1) atomicMin(&S.first, n);
    __syncthreads();
    const int first = S.first;
    for (int n = tid; n < N; n += NT)
      s.take[n] = (n == first && c1 > 0) ? c1 : 0;
  } else {
    unsigned carry = 0u;
    for (int base = 0; base < N; base += NT) {
      const int n = base + tid;
      const int cap = n < N ? s.cap[n] : 0;
      unsigned tot;
      const unsigned before =
          block_excl_scan<NT>((unsigned)cap, S.warp, &tot) + carry;
      carry += tot;
      if (n < N) s.take[n] = prefix_take(cap, c1, before);
    }
  }

  // touched nodes: charge used, AND the group's mask into the surviving
  // columns, drop blocks the new `used` no longer fits (a tile a node)
  const int Lt =
      hi > 0 ? tile_width(count_touched(s.take, N), row_chunks(W, ZC)) : 1;
  for (int n = tid / Lt; n < hi; n += NT / Lt) {
    const int take = s.take[n];
    if (take > 0) {
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        u[r] = __fadd_rn(a.used[n * KR + r], __fmul_rn((float)take, req[r]));
      uint32_t* row = node_words(a, n);
      tile_narrow(Lt, row, s.csum + (size_t)n * NS, NS, s.gm, W, ZC,
                  ALL_SLOTS, s.pt, u);
      __syncwarp(tile_mask(Lt));
      if ((tid & (Lt - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < KR; ++r) a.used[n * KR + r] = u[r];
        atomicAdd(&S.ptake[a.node_pool[n]], take);
        atomicAdd(&S.sum, take);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    // segment_sum of integer takes: exact in float32 below 2^24
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int r = 0; r < KR; ++r)
        a.limits[p * KR + r] = __fsub_rn(
            a.limits[p * KR + r], __fmul_rn((float)S.ptake[p], req[r]));
    S.crem = c1 - S.sum;
  }

  // -- 3. open new nodes --------------------------------------------------
  // per-column pods-per-node of an empty node, the feasible columns as
  // bits, and each pool's best column (k_full) and "any column" flag
  for (int o = tid; o < O; o += NT) {
    if ((s.gm[o >> 5] >> (o & 31)) & 1u) {
      float av[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        av[r] = __fsub_rn(a.col_alloc[o * KR + r], a.col_daemon[o * KR + r]);
      const int pc = min(fit_count(av, req), ncap);
      if (pc >= 1) {
        atomicOr(&s.feas[o >> 5], 1u << (o & 31));
        const int p = a.col_pool[o];
        atomicMax(&S.kfull[p], pc);
        S.any[p] = 1;
      }
    }
  }
  __syncthreads();
  if constexpr (SHARDED) {
    // each pool's best column and "any column" over every shard, as one
    // [2P] exchange
    ClusterXch& X = xch();
    for (int p = tid; p < P; p += NT) {
      X.tmp[p] = S.kfull[p];
      X.tmp[P + p] = S.any[p];
    }
    cluster_combine<false>(X.tmp, 2 * P);
    for (int p = tid; p < P; p += NT) {
      S.kfull[p] = X.tmp[p];
      S.any[p] = X.tmp[P + p];
    }
    __syncthreads();
  }

  // the per-pool cascade, in pool priority order, on one thread
  if (tid == 0) {
    int c_rem = S.crem, na = S.na;
    for (int p = 0; p < P; ++p) {
      float* lim = a.limits + p * KR;
      const float* pd = a.pool_daemon + p * KR;
      const int k_full = S.kfull[p];
      bool can = S.any[p] && all_fits3(lim, pd, req) && c_rem > 0 &&
                 k_full > 0;
      float tmp[KR];
      if (whole) {
        // the whole remainder must land on one node of one pool
#pragma unroll
        for (int r = 0; r < KR; ++r) tmp[r] = __fsub_rn(lim[r], pd[r]);
        can = can && k_full >= c_rem && fit_count(tmp, req) >= c_rem;
      }
      const int kf = max(k_full, 1);
      // budget-exact node count: affordable pods first, then the per-node
      // daemon charge for the implied node count
      int t = min(c_rem, fit_count(lim, req));
      const int m_t = ceil_div(t, kf);
#pragma unroll
      for (int r = 0; r < KR; ++r)
        tmp[r] = __fsub_rn(lim[r], __fmul_rn((float)m_t, pd[r]));
      t = min(t, fit_count(tmp, req));
      const int m_need = can ? ceil_div(t, kf) : 0;
      const int m = min(m_need, N - na);
      const int taken = min(t, wmul(m, k_full));
      S.start[p] = na;
      S.m[p] = m;
      S.taken[p] = taken;
#pragma unroll
      for (int r = 0; r < KR; ++r)
        lim[r] = __fadd_rn(lim[r],
                           -__fadd_rn(__fmul_rn((float)m, pd[r]),
                                      __fmul_rn((float)taken, req[r])));
      na += m;
      c_rem -= taken;
    }
    S.na = na;
    a.unsched[g] = (float)c_rem;
  }
  __syncthreads();

  // emit the take_new row, and activate the opened slots [start[0], na),
  // one run per pool
  for (int n = tid; n < N; n += NT) {
    int tn = s.take[n];
    const int p = opened_pool(S, P, n);
    if (p >= 0) tn += opened_pods(S, p, S.kfull[p], n);
    a.take_new[(size_t)g * N + n] = (float)tn;
  }
  open_slots(
      a, s, P,
      [&](int p) {
        return OpenRun{p, S.start[p], S.m[p], S.kfull[p],
                       S.taken[p] - wmul(S.m[p] - 1, S.kfull[p]), -1,
                       ALL_SLOTS};
      },
      [&](int n) { return opened_pool(S, P, n); }, S.start[0], S.na, req,
      nullptr, nullptr);
  for (int d = tid; d < D; d += NT) a.dom_placed[(size_t)g * D + d] = 0.0f;
}

// ---------------------------------------------------------------------------
// the heavy step (ffd.py:589-818)

// per-domain state of one heavy step, in shared memory (TOPO only)
struct HeavyShared {
  int zcdom[MAXZC];           // domain of each grid slot
  uint64_t dslots[MAXD];      // each domain's grid slots as a slot mask
  int dbase[MAXD], delig[MAXD], xmax[MAXD], want[MAXD];
  unsigned cape[MAXD];        // sum of existing-node caps per domain
  unsigned capn[MAXD];        // sum of in-flight caps per domain
  unsigned dexist[MAXD], dflight[MAXD], dnew[MAXD];  // dom_placed parts
  int md[MAXD], takend[MAXD], startd[MAXD];
  int rooms[MAXP], afford[MAXP];
  // _water_fill
  float c[MAXD], ub[MAXD];
  float bps[2 * MAXD];
  float cand[6 * MAXD];
  int cnt_eff, unplaceable, pool_m, pool_na;
};

// the water-fill's final counts at level L for domain d: clip(L, c, ub)
__device__ __forceinline__ float wf_f(const HeavyShared& H, float L, int d) {
  return fminf(fmaxf(L, H.c[d]), H.ub[d]);
}

// placed(L): sum over domains, in index order, of clip(L, c, ub) - c
__device__ __forceinline__ float wf_placed(const HeavyShared& H, float L,
                                           int D) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d)
    acc = __fadd_rn(acc, __fsub_rn(wf_f(H, L, d), H.c[d]));
  return acc;
}

// minf(L): the eligible minimum of the final counts, 0 while fewer than
// mindom eligible domains hold more than half a pod
__device__ __forceinline__ float wf_minf(const HeavyShared& H, float L,
                                         int D, int mindom) {
  float m = __int_as_float(0x7f800000);  // +inf
  int pop = 0;
  for (int d = 0; d < D; ++d) {
    if (!H.delig[d]) continue;
    const float f = wf_f(H, L, d);
    m = fminf(m, f);
    if (f > 0.5f) ++pop;
  }
  return (mindom > 0 && pop < mindom) ? 0.0f : m;
}

// _water_fill (ffd.py:147): split cnt_eff pods into per-domain quotas
// H.want[D] under the skew, given H.dbase, H.xmax, H.delig.  Every thread
// calls (barriers inside).
__device__ void water_fill(HeavyShared& H, int D, int skew, int mindom) {
  const int tid = threadIdx.x;
  const int cnt = H.cnt_eff;
  const float cnt_f = (float)cnt, skew_f = (float)skew;
  for (int d = tid; d < D; d += NT) {
    H.c[d] = (float)H.dbase[d];
    H.ub[d] = H.delig[d] ? (float)(int)((unsigned)H.dbase[d] +
                                        (unsigned)H.xmax[d])
                         : H.c[d];
  }
  __syncthreads();
  // the 2D breakpoints, sorted ascending by rank (ties by index)
  for (int i = tid; i < 2 * D; i += NT) {
    const float v = i < D ? H.c[i] : H.ub[i - D];
    int rank = 0;
    for (int j = 0; j < 2 * D; ++j) {
      const float u = j < D ? H.c[j] : H.ub[j - D];
      rank += (u < v) || (u == v && j < i);
    }
    H.bps[rank] = v;
  }
  __syncthreads();
  // candidate levels: the breakpoints, the skew crossings, the count
  // crossings
  for (int k = tid; k < 2 * D; k += NT) {
    const float b = H.bps[k];
    const float pl = wf_placed(H, b, D);
    int slope = 0;
    for (int d = 0; d < D; ++d)
      slope += (H.c[d] <= b) && (b < H.ub[d]) && H.delig[d];
    H.cand[k] = b;
    H.cand[2 * D + k] = __fadd_rn(wf_minf(H, b, D, mindom), skew_f);
    H.cand[4 * D + k] = __fadd_rn(
        b, __fdiv_rn(__fsub_rn(cnt_f, pl), (float)max(slope, 1)));
  }
  __syncthreads();
  // feasibility of every candidate; infeasible ones fall to min(c)
  float floor_val = H.c[0];
  for (int d = 1; d < D; ++d) floor_val = fminf(floor_val, H.c[d]);
  for (int k = tid; k < 6 * D; k += NT) {
    const float L = H.cand[k];
    const bool ok =
        (L <= __fadd_rn(__fadd_rn(wf_minf(H, L, D, mindom), skew_f),
                        KEPS)) &&
        (wf_placed(H, L, D) <= __fadd_rn(cnt_f, KEPS));
    H.cand[k] = ok ? L : floor_val;
  }
  __syncthreads();
  if (tid == 0) {
    float best = H.cand[0];
    for (int k = 1; k < 6 * D; ++k) best = fmaxf(best, H.cand[k]);
    const float L = floorf(best);
    unsigned xsum = 0u;
    for (int d = 0; d < D; ++d) {
      H.want[d] = (int)__fsub_rn(wf_f(H, L, d), H.c[d]);
      xsum += (unsigned)H.want[d];
    }
    // integral repair: flooring L strands < D pods; hand them to domains
    // whose bumped count still respects the skew floor (_prefix_fill)
    const int leftover = max(wsub(cnt, xsum), 0);
    const float m = wf_minf(H, L, D, mindom);
    unsigned before = 0u;
    for (int d = 0; d < D; ++d) {
      const float fl = wf_f(H, L, d);
      const int bump =
          H.delig[d] && (__fadd_rn(H.c[d], (float)H.want[d]) < H.ub[d]) &&
          (__fsub_rn(__fadd_rn(fl, 1.0f), m) <= __fadd_rn(skew_f, KEPS));
      H.want[d] += prefix_take(bump, leftover, before);
      before += (unsigned)bump;
      H.want[d] = min(H.want[d], cnt);
    }
  }
  __syncthreads();
}

template <bool SHARDED>
__device__ void heavy_step(const ScanArgs& a, ScanShared& S,
                           const ScanDyn& s, int g) {
  __shared__ HeavyShared H;
  const int tid = threadIdx.x;
  const int E = a.E, N = a.N, O = a.O, ZC = a.ZC, P = a.P, D = a.D,
            W = a.W;
  const int hi = max(S.hi0, S.na), NS = summary_words(W, ZC);
  float req[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) req[r] = S.req[r];
  const int cnt = S.cnt, ncap = S.ncap, dsel = S.dsel;
  const int* col_dom = dsel == 1 ? a.col_zone : a.col_ct;
  const int* ex_dom = dsel == 1 ? a.exist_zone : a.exist_ct;
  int* node_dom = dsel == 1 ? a.node_zone : a.node_ct;
  const int dreal = dsel == 1 ? S.dreal_zone : S.dreal_ct;
  const int* zc_dom = dsel == 1 ? slot_zone<SHARDED>(a) : slot_ct<SHARDED>(a);

  for (int d = tid; d < D; d += NT) {
    H.dbase[d] = a.group_dbase[(size_t)g * D + d];
    H.delig[d] = a.group_delig[(size_t)g * D + d] != 0;
    H.cape[d] = H.capn[d] = 0u;
    H.dexist[d] = H.dflight[d] = H.dnew[d] = 0u;
  }
  for (int z = tid; z < ZC; z += NT) H.zcdom[z] = zc_dom[z];
  for (int i = tid; i < P * D; i += NT) s.kpd[i] = 0;
  __syncthreads();
  for (int d = tid; d < D; d += NT) H.dslots[d] = dom_slots(H.zcdom, ZC, d);

  // -- capacity estimates per domain (for the water-fill) -----------------
  for (int e = tid; e < E; e += NT) {
    const int cap = min(fit_count(&a.exist_rem[e * KR], req),
                        exist_cap_at(a, S, e));
    a.cap_e[e] = cap;
    const int d = ex_dom[e];
    if (d >= 0 && d < D) atomicAdd(&H.cape[d], (unsigned)cap);
  }
  // each in-flight node serves ONE domain: the best per-domain capacity
  // (max over the domain's grid slots of the max over admitted blocks),
  // saturated at the group count, ties rotated over the real domain count
  auto pick_domain = [&](int n, bool act, const int* slotmax) {
    int best = 0, bd = 0, bcap = 0;
    for (int d = 0; d < D; ++d) {
      int capd = 0;
      if (act) {
        for (int z = 0; z < ZC; ++z)
          if (H.zcdom[z] == d) capd = max(capd, slotmax[z]);
        capd = min(capd, ncap);
      }
      const int score = (int)((unsigned)wmul(min(capd, cnt), D + 1) +
                              (unsigned)((n + d) % dreal));
      if (d == 0 || score > best) {
        best = score;
        bd = d;
        bcap = capd;
      }
    }
    s.bd[n] = bd;
    s.cap[n] = bcap;
    atomicAdd(&H.capn[bd], (unsigned)bcap);
  };
  // (inactive slots: no capacity; a tile per active node)
  for (int n = tid; n < N; n += NT) {
    if (n < hi && a.active[n]) continue;
    if constexpr (SHARDED) {
      for (int z = 0; z < ZC; ++z) a.xslot[(size_t)n * ZC + z] = 0;
    } else {
      pick_domain(n, false, nullptr);
    }
  }
  const int Lc = tile_width(hi, row_chunks(W, ZC));
  for (int n = tid / Lc; n < hi; n += NT / Lc) {
    if (!a.active[n]) continue;
    float u[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) u[r] = a.used[n * KR + r];
    int slotmax[MAXZC];
    tile_slotmax(Lc, node_words(a, n), s.csum + (size_t)n * NS,
                 gsum_of(s, N, NS), NS, s.gm, W, ZC, s.pt, u, req, slotmax);
    if constexpr (SHARDED) {
      // this shard's slot maxima; the pick waits for every shard's
      for (int z = tid & (Lc - 1); z < ZC; z += Lc)
        a.xslot[(size_t)n * ZC + z] = slotmax[z];
    } else {
      if ((tid & (Lc - 1)) == 0) pick_domain(n, true, slotmax);
    }
  }
  if constexpr (SHARDED) {
    // the [N, ZC] slot maxima over every shard (ffd.py:632)
    cluster_combine<false>(a.xslot, N * ZC);
    for (int n = tid; n < N; n += NT)
      pick_domain(n, a.active[n] != 0, a.xslot + (size_t)n * ZC);
  }
  // per-column pods-per-node of an empty node, the feasible columns, and
  // the best column per (pool, domain)
  for (int o = tid; o < O; o += NT) {
    if ((s.gm[o >> 5] >> (o & 31)) & 1u) {
      float av[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        av[r] = __fsub_rn(a.col_alloc[o * KR + r], a.col_daemon[o * KR + r]);
      const int pc = min(fit_count(av, req), ncap);
      if (pc >= 1) {
        atomicOr(&s.feas[o >> 5], 1u << (o & 31));
        const int d = col_dom[o];
        if (d >= 0 && d < D) atomicMax(&s.kpd[a.col_pool[o] * D + d], pc);
      }
    }
  }
  for (int p = tid; p < P; p += NT) {
    H.rooms[p] = all_fits3(&a.limits[p * KR], &a.pool_daemon[p * KR], req);
    H.afford[p] = fit_count(&a.limits[p * KR], req);
  }
  __syncthreads();
  // the [P, D] best column per (pool, domain) over every shard (:667)
  if constexpr (SHARDED) cluster_combine<false>(s.kpd, P * D);
  const int na0 = S.na;
  for (int d = tid; d < D; d += NT) {
    // new-node pods per domain, clamped by what each pool can buy
    int new_est = INT_MIN;
    for (int p = 0; p < P; ++p) {
      const int v = H.rooms[p]
                        ? min(wmul(N - na0, s.kpd[p * D + d]), H.afford[p])
                        : 0;
      new_est = max(new_est, v);
    }
    const int capacity = (int)(H.cape[d] + H.capn[d] + (unsigned)new_est);
    H.xmax[d] = min(capacity, a.group_dcap[(size_t)g * D + d]);
  }
  if (tid == 0) {
    // the group count capped by the total affordable (f32 sums, in order)
    float afford_total = 0.0f;
    for (int p = 0; p < P; ++p)
      afford_total = __fadd_rn(afford_total, (float)H.afford[p]);
    unsigned capsum = 0u;
    for (int d = 0; d < D; ++d) capsum += H.cape[d];
    const float capsum_f = E > 0 ? (float)(int)capsum : 0.0f;
    H.cnt_eff = (int)fminf((float)cnt, __fadd_rn(capsum_f, afford_total));
  }
  __syncthreads();
  water_fill(H, D, a.group_skew[g], a.group_mindom[g]);
  if (tid == 0) {
    unsigned ws = 0u;
    for (int d = 0; d < D; ++d) ws += (unsigned)H.want[d];
    H.unplaceable = wsub(cnt, ws);
  }

  // -- 1. existing nodes, per domain --------------------------------------
  for (int e = tid; e < E; e += NT) {
    const int d = ex_dom[e];
    if (d < 0 || d >= D) a.take_exist[(size_t)g * E + e] = 0.0f;
  }
  if (E > 0) {
    for (int d = 0; d < D; ++d) {
      const int want = H.want[d];
      unsigned carry = 0u;
      for (int base = 0; base < E; base += NT) {
        const int e = base + tid;
        const bool mine = e < E && ex_dom[e] == d;
        const int cap = mine ? a.cap_e[e] : 0;
        unsigned tot;
        const unsigned before =
            block_excl_scan<NT>((unsigned)cap, S.warp, &tot) + carry;
        carry += tot;
        if (mine) {
          const int take = prefix_take(cap, want, before);
          a.take_exist[(size_t)g * E + e] = (float)take;
          if (take != 0) {
#pragma unroll
            for (int r = 0; r < KR; ++r)
              a.exist_rem[e * KR + r] = __fsub_rn(
                  a.exist_rem[e * KR + r], __fmul_rn((float)take, req[r]));
            atomicAdd(&H.dexist[d], (unsigned)take);
          }
        }
      }
    }
    __syncthreads();
    for (int d = tid; d < D; d += NT)
      H.want[d] = (int)((unsigned)H.want[d] - H.dexist[d]);
  }

  // -- 2. in-flight nodes, per domain -------------------------------------
  // clamp each node's cap by its domain's want, then by the collective
  // pool budget, then fill each domain's nodes in index order
  __syncthreads();
  for (int n = tid; n < N; n += NT) s.cap[n] = min(s.cap[n], H.want[s.bd[n]]);
  if (tid < P) S.limcap[tid] = fit_count(&a.limits[tid * KR], req);
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    unsigned carry = 0u;
    for (int base = 0; base < N; base += NT) {
      const int n = base + tid;
      const bool mine = n < N && a.node_pool[n] == p;
      const int v = mine ? s.cap[n] : 0;
      unsigned tot;
      const unsigned before =
          block_excl_scan<NT>((unsigned)v, S.warp, &tot) + carry;
      carry += tot;
      if (mine) s.cap[n] = min(v, max(wsub(S.limcap[p], before), 0));
    }
  }
  __syncthreads();
  for (int d = 0; d < D; ++d) {
    const int want = H.want[d];
    unsigned carry = 0u;
    for (int base = 0; base < N; base += NT) {
      const int n = base + tid;
      const bool mine = n < N && s.bd[n] == d;
      const int cap = mine ? s.cap[n] : 0;
      unsigned tot;
      const unsigned before =
          block_excl_scan<NT>((unsigned)cap, S.warp, &tot) + carry;
      carry += tot;
      if (mine) s.take[n] = prefix_take(cap, want, before);
    }
  }
  // touched nodes: charge used, AND the group's mask and the domain's grid
  // slots into the surviving columns, drop blocks that no longer fit, pin
  // the node to its domain (a tile a node)
  const int Lt =
      hi > 0 ? tile_width(count_touched(s.take, N), row_chunks(W, ZC)) : 1;
  for (int n = tid / Lt; n < hi; n += NT / Lt) {
    const int take = s.take[n];
    if (take > 0) {
      const int bd = s.bd[n];
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        u[r] = __fadd_rn(a.used[n * KR + r], __fmul_rn((float)take, req[r]));
      uint32_t* row = node_words(a, n);
      tile_narrow(Lt, row, s.csum + (size_t)n * NS, NS, s.gm, W, ZC,
                  H.dslots[bd], s.pt, u);
      __syncwarp(tile_mask(Lt));
      if ((tid & (Lt - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < KR; ++r) a.used[n * KR + r] = u[r];
        node_dom[n] = bd;
        atomicAdd(&S.ptake[a.node_pool[n]], take);
        atomicAdd(&H.dflight[bd], (unsigned)take);
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int r = 0; r < KR; ++r)
        a.limits[p * KR + r] = __fsub_rn(
            a.limits[p * KR + r], __fmul_rn((float)S.ptake[p], req[r]));
  }
  for (int d = tid; d < D; d += NT)
    H.want[d] = (int)((unsigned)H.want[d] - H.dflight[d]);
  __syncthreads();

  // -- 3. open new nodes, per pool x domain -------------------------------
  for (int p = 0; p < P; ++p) {
    if (tid == 0) {
      // the pool budget is shared over domains, in domain order
      const float* pd = a.pool_daemon + p * KR;
      float* lim = a.limits + p * KR;
      float rem[KR], tmp[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r) rem[r] = lim[r];
      const int na = S.na;
      int slots_left = N - na;
      unsigned msum = 0u, tsum = 0u;
      for (int d = 0; d < D; ++d) {
        const int kfull = s.kpd[p * D + d];
        const bool can = kfull > 0 && H.want[d] > 0;
        const int kf = max(kfull, 1);
        int t = min(H.want[d], fit_count(rem, req));
        const int m_t = ceil_div(t, kf);
#pragma unroll
        for (int r = 0; r < KR; ++r)
          tmp[r] = __fsub_rn(rem[r], __fmul_rn((float)m_t, pd[r]));
        t = min(t, fit_count(tmp, req));
        const int m_need = can ? ceil_div(t, kf) : 0;
        const int m_d = min(m_need, slots_left);
        const int taken = min(t, wmul(m_d, kfull));
#pragma unroll
        for (int r = 0; r < KR; ++r)
          rem[r] = __fsub_rn(rem[r], __fadd_rn(__fmul_rn((float)m_d, pd[r]),
                                               __fmul_rn((float)taken,
                                                         req[r])));
        slots_left -= m_d;
        H.startd[d] = (int)((unsigned)na + msum);
        H.md[d] = m_d;
        H.takend[d] = taken;
        msum += (unsigned)m_d;
        tsum += (unsigned)taken;
        H.dnew[d] += (unsigned)taken;
        H.want[d] = wsub(H.want[d], (unsigned)taken);
      }
#pragma unroll
      for (int r = 0; r < KR; ++r)
        lim[r] = __fadd_rn(
            lim[r], -__fadd_rn(__fmul_rn((float)(int)msum, pd[r]),
                               __fmul_rn((float)(int)tsum, req[r])));
      H.pool_na = na;
      H.pool_m = (int)msum;
      S.na = (int)((unsigned)na + msum);
    }
    __syncthreads();
    // activate the opened slots, one run per domain, each pinned to it
    open_slots(
        a, s, D,
        [&](int d) {
          const int kf = s.kpd[p * D + d];
          return OpenRun{p, H.startd[d], H.md[d], kf,
                         H.takend[d] - wmul(H.md[d] - 1, kf), d,
                         H.dslots[d]};
        },
        [&](int n) {
          int d = 0;
          while (d < D && !(H.md[d] > 0 && n >= H.startd[d] &&
                            n < H.startd[d] + H.md[d]))
            ++d;
          return d < D ? d : -1;
        },
        H.pool_na, H.pool_na + H.pool_m, req, node_dom, s.take);
    __syncthreads();
  }

  // -- outputs ------------------------------------------------------------
  for (int n = tid; n < N; n += NT)
    a.take_new[(size_t)g * N + n] = (float)s.take[n];
  for (int d = tid; d < D; d += NT)
    a.dom_placed[(size_t)g * D + d] =
        (float)(int)(H.dexist[d] + H.dflight[d] + H.dnew[d]);
  if (tid == 0) {
    unsigned ws = 0u;
    for (int d = 0; d < D; ++d) ws += (unsigned)H.want[d];
    a.unsched[g] = (float)(int)((unsigned)H.unplaceable + ws);
  }
}

// ---------------------------------------------------------------------------
// the gang fill (ffd.py:820-1047)

// per-step state of one gang step, in shared memory (GANG only)
struct GangShared {
  int zcdom[MAXZC];        // domain of each grid slot (all 0 for dsel 0)
  uint64_t dslots;         // the candidate domain's grid slots
  int placed[MAXD];        // each domain's candidate total
  float lim[MAXP * KR];    // a candidate's own copy of the pool budgets
  int sum_e, sum_n, w, ok;
};

// the gang's domain of existing node / column i: zone, capacity type, or
// domain 0 for a domain-free gang (dsel 0)
__device__ __forceinline__ int gang_dom(int dsel, const int* zone,
                                        const int* ct, int i) {
  return dsel == 1 ? zone[i] : (dsel == 2 ? ct[i] : 0);
}

// Domain d's candidate: the light cascade (existing, in-flight, new
// nodes) restricted to d's existing nodes, node slots and grid slots, the
// new nodes charged to a copy of the pool budgets pre-charged with d's
// in-flight take.  Without `commit` it only records Gs.placed[d] and
// leaves the carry alone; with `commit` (the winner) it applies the
// candidate to the carry in the reference's order (ffd.py:979-1035):
// existing takes, in-flight takes narrowed to d's slots and pinned, the
// budgets charged with the in-flight take, then each pool's new nodes and
// pods, the new nodes pinned.  Evaluating the winner twice on the same
// carry gives the same candidate bit for bit.  Every thread calls.
template <bool SHARDED>
__device__ void gang_candidate(const ScanArgs& a, ScanShared& S,
                               const ScanDyn& s, GangShared& Gs, int g,
                               int d, bool commit) {
  const int tid = threadIdx.x;
  const int E = a.E, N = a.N, ZC = a.ZC, P = a.P, D = a.D, W = a.W;
  const int hi = max(S.hi0, S.na), NS = summary_words(W, ZC);
  float req[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) req[r] = S.req[r];
  const int cnt = S.cnt, ncap = S.ncap, dsel = S.dsel;
  int* node_dom = dsel == 1 ? a.node_zone : (dsel == 2 ? a.node_ct : nullptr);
  if (tid == 0) {
    Gs.sum_e = 0;
    Gs.sum_n = 0;
    Gs.dslots = dom_slots(Gs.zcdom, ZC, d);
  }
  if (tid < P) S.ptake[tid] = 0;
  __syncthreads();

  // -- 1. existing nodes of domain d ---------------------------------------
  {
    unsigned carry = 0u;
    for (int base = 0; base < E; base += NT) {
      const int e = base + tid;
      const bool mine =
          e < E && gang_dom(dsel, a.exist_zone, a.exist_ct, e) == d;
      const int cap = mine ? a.cap_e[e] : 0;
      unsigned tot;
      const unsigned before =
          block_excl_scan<NT>((unsigned)cap, S.warp, &tot) + carry;
      carry += tot;
      if (e < E) {
        const int take = mine ? prefix_take(cap, cnt, before) : 0;
        if (commit) {
          a.take_exist[(size_t)g * E + e] = (float)take;
          if (take != 0) {
#pragma unroll
            for (int r = 0; r < KR; ++r)
              a.exist_rem[e * KR + r] = __fsub_rn(
                  a.exist_rem[e * KR + r], __fmul_rn((float)take, req[r]));
          }
        }
        if (take != 0) atomicAdd(&Gs.sum_e, take);
      }
    }
  }
  __syncthreads();
  const int rem1 = cnt - Gs.sum_e;

  // -- 2. in-flight nodes: the best fit over the node's surviving,
  // admitted blocks in d's grid slots (a node pinned elsewhere has none);
  // a tile per active node
  for (int n = tid; n < N; n += NT)
    if (n >= hi || !a.active[n]) s.cap[n] = 0;
  const int Lc = tile_width(hi, row_chunks(W, ZC));
  for (int n = tid / Lc; n < hi; n += NT / Lc) {
    if (!a.active[n]) continue;
    float u[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) u[r] = a.used[n * KR + r];
    const int cap = tile_best(Lc, node_words(a, n), s.csum + (size_t)n * NS,
                              gsum_of(s, N, NS), NS, s.gm, W, ZC, Gs.dslots,
                              s.pt, u, req, ncap);
    if ((tid & (Lc - 1)) == 0) s.cap[n] = cap;
  }
  __syncthreads();
  // the best over every shard's blocks in d's slots (ffd.py:894)
  if constexpr (SHARDED) cluster_combine<false>(s.cap, N);
  // pool limits are collective (_clamp_pool_limits on the carry budgets)
  for (int p = 0; p < P; ++p) {
    unsigned carry = 0u;
    for (int base = 0; base < N; base += NT) {
      const int n = base + tid;
      const bool mine = n < N && a.node_pool[n] == p;
      const int v = mine ? s.cap[n] : 0;
      unsigned tot;
      const unsigned before =
          block_excl_scan<NT>((unsigned)v, S.warp, &tot) + carry;
      carry += tot;
      if (mine) s.cap[n] = min(v, max(wsub(S.limcap[p], before), 0));
    }
  }
  __syncthreads();
  {
    unsigned carry = 0u;
    for (int base = 0; base < N; base += NT) {
      const int n = base + tid;
      const int cap = n < N ? s.cap[n] : 0;
      unsigned tot;
      const unsigned before =
          block_excl_scan<NT>((unsigned)cap, S.warp, &tot) + carry;
      carry += tot;
      if (n < N) s.take[n] = prefix_take(cap, rem1, before);
    }
  }
  for (int n = tid; n < N; n += NT) {
    const int take = s.take[n];
    if (take > 0) {
      atomicAdd(&S.ptake[a.node_pool[n]], take);
      atomicAdd(&Gs.sum_n, take);
    }
  }
  // the winner's in-flight takes: charge used, narrow to d's slots and
  // the blocks that still fit, pin (a tile a node)
  if (commit) {
    const int Lt =
        hi > 0 ? tile_width(count_touched(s.take, N), row_chunks(W, ZC)) : 1;
    for (int n = tid / Lt; n < hi; n += NT / Lt) {
      const int take = s.take[n];
      if (take <= 0) continue;
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        u[r] = __fadd_rn(a.used[n * KR + r], __fmul_rn((float)take, req[r]));
      uint32_t* row = node_words(a, n);
      tile_narrow(Lt, row, s.csum + (size_t)n * NS, NS, s.gm, W, ZC,
                  Gs.dslots, s.pt, u);
      __syncwarp(tile_mask(Lt));
      if ((tid & (Lt - 1)) == 0) {
#pragma unroll
        for (int r = 0; r < KR; ++r) a.used[n * KR + r] = u[r];
        if (node_dom) node_dom[n] = d;
      }
    }
  }
  __syncthreads();

  // -- 3. new nodes, pools in priority order, on one thread: the budget
  // copy (the carry itself for the winner) charged first with d's
  // in-flight take per pool (segment_sum of integer takes: exact in
  // float32 below 2^24), then pool by pool
  if (tid == 0) {
    const int rem2 = rem1 - Gs.sum_n;
    int c_rem = rem2, na = S.na;
    float* lim = commit ? a.limits : Gs.lim;
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int r = 0; r < KR; ++r)
        lim[p * KR + r] = __fsub_rn(a.limits[p * KR + r],
                                    __fmul_rn((float)S.ptake[p], req[r]));
    for (int p = 0; p < P; ++p) {
      float* lp = lim + p * KR;
      const float* pd = a.pool_daemon + p * KR;
      const int kf_raw = s.kpd[p * D + d];
      const bool can = all_fits3(lp, pd, req) && c_rem > 0 && kf_raw > 0;
      const int kf = max(kf_raw, 1);
      // budget-exact node count, the light step's two passes
      int t = min(c_rem, fit_count(lp, req));
      const int m_t = ceil_div(t, kf);
      float tmp[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        tmp[r] = __fsub_rn(lp[r], __fmul_rn((float)m_t, pd[r]));
      t = min(t, fit_count(tmp, req));
      const int m_need = can ? ceil_div(t, kf) : 0;
      const int m = min(m_need, N - na);
      const int taken = min(t, wmul(m, kf_raw));
      S.start[p] = na;
      S.m[p] = m;
      S.taken[p] = taken;
#pragma unroll
      for (int r = 0; r < KR; ++r)
        lp[r] = __fadd_rn(lp[r],
                          -__fadd_rn(__fmul_rn((float)m, pd[r]),
                                     __fmul_rn((float)taken, req[r])));
      na += m;
      c_rem -= taken;
    }
    // a slot-starved candidate places less than the gang: infeasible
    Gs.placed[d] = (int)((unsigned)Gs.sum_e + (unsigned)Gs.sum_n +
                         (unsigned)(rem2 - c_rem));
    if (commit) S.na = na;
  }
  __syncthreads();
  if (!commit) return;

  // the winner's take_new row, and its new nodes [start[0], na), one run
  // per pool, pinned to d
  for (int n = tid; n < N; n += NT) {
    int tn = s.take[n];
    const int p = opened_pool(S, P, n);
    if (p >= 0) tn += opened_pods(S, p, s.kpd[p * D + d], n);
    a.take_new[(size_t)g * N + n] = (float)tn;
  }
  open_slots(
      a, s, P,
      [&](int p) {
        const int kf = s.kpd[p * D + d];
        return OpenRun{p, S.start[p], S.m[p], kf,
                       S.taken[p] - wmul(S.m[p] - 1, kf), d, Gs.dslots};
      },
      [&](int n) { return opened_pool(S, P, n); }, S.start[0], S.na, req,
      node_dom, nullptr);
}

template <bool SHARDED>
__device__ void gang_step(const ScanArgs& a, ScanShared& S, const ScanDyn& s,
                          int g) {
  __shared__ GangShared Gs;
  const int tid = threadIdx.x;
  const int E = a.E, N = a.N, O = a.O, ZC = a.ZC, P = a.P, D = a.D;
  float req[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) req[r] = S.req[r];
  const int cnt = S.cnt, ncap = S.ncap, dsel = S.dsel;

  // -- the step's tables: slot domains, existing caps, the budgets' pod
  // caps, the feasible columns and the best column per (pool, domain)
  for (int z = tid; z < ZC; z += NT)
    Gs.zcdom[z] = gang_dom(dsel, slot_zone<SHARDED>(a), slot_ct<SHARDED>(a),
                           z);
  for (int i = tid; i < P * D; i += NT) s.kpd[i] = 0;
  for (int e = tid; e < E; e += NT)
    a.cap_e[e] = min(fit_count(&a.exist_rem[e * KR], req),
                     exist_cap_at(a, S, e));
  if (tid < P) S.limcap[tid] = fit_count(&a.limits[tid * KR], req);
  __syncthreads();
  for (int o = tid; o < O; o += NT) {
    if ((s.gm[o >> 5] >> (o & 31)) & 1u) {
      float av[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r)
        av[r] = __fsub_rn(a.col_alloc[o * KR + r], a.col_daemon[o * KR + r]);
      const int pc = min(fit_count(av, req), ncap);
      if (pc >= 1) {
        atomicOr(&s.feas[o >> 5], 1u << (o & 31));
        const int d = gang_dom(dsel, a.col_zone, a.col_ct, o);
        if (d >= 0 && d < D) atomicMax(&s.kpd[a.col_pool[o] * D + d], pc);
      }
    }
  }
  __syncthreads();
  // the [P, D] best column per (pool, domain) over every shard (:918)
  if constexpr (SHARDED) cluster_combine<false>(s.kpd, P * D);

  // -- every domain's candidate, then the feasible one of lowest rank
  for (int d = 0; d < D; ++d)
    gang_candidate<SHARDED>(a, S, s, Gs, g, d, false);
  if (tid == 0) {
    int w = 0, best = 0;
    for (int d = 0; d < D; ++d) {
      const bool feas = a.group_delig[(size_t)g * D + d] != 0 &&
                        Gs.placed[d] >= cnt;
      const int rank = feas ? a.group_dbase[(size_t)g * D + d] : BIGCAP;
      if (d == 0 || rank < best) {  // argmin: the first minimum
        best = rank;
        w = d;
      }
      a.dom_placed[(size_t)g * D + d] = (float)min(Gs.placed[d], cnt);
    }
    Gs.w = w;
    Gs.ok = best < BIGCAP && cnt > 0;
  }
  __syncthreads();
  const int w = Gs.w;
  if (Gs.ok) {
    gang_candidate<SHARDED>(a, S, s, Gs, g, w, true);
    if (tid == 0) a.unsched[g] = 0.0f;
  } else {
    // nothing commits: the gang strands whole
    for (int e = tid; e < E; e += NT) a.take_exist[(size_t)g * E + e] = 0.0f;
    for (int n = tid; n < N; n += NT) a.take_new[(size_t)g * N + n] = 0.0f;
    if (tid == 0) a.unsched[g] = (float)cnt;
  }
}

// The priority inversion witness (ffd.py:1238-1257) from the strand
// outputs: a group that placed pods after an earlier group of strictly
// higher priority stranded.  One thread; integers only.
__device__ void priority_witness(const ScanArgs& a) {
  int before = -2147483647;  // -(2^31) + 1
  for (int g = 0; g < a.G; ++g) {
    const int un = (int)a.unsched[g];
    const int gp = a.group_prio[g];
    a.prio_inv[g] = (a.group_count[g] - un > 0 && gp < before) ? 1.0f : 0.0f;
    if (un > 0) before = max(before, gp);
  }
}

// ---------------------------------------------------------------------------
// Block b's view of the batch: every per-problem pointer moved to problem
// b.  K5 (SWEEP false) stacks whole problems; K4 (SWEEP true) stacks only
// the simulations' rows and shares the class tables and existing nodes.
template <bool SWEEP>
__device__ void offset_block(ScanArgs& a, int b) {
  const size_t G = a.G, E = a.E, N = a.N, P = a.P, D = a.D, W = a.W;
  const size_t bb = b;
  a.group_req += bb * G * KR;
  a.group_count += bb * G;
  a.pool_limit += bb * P * KR;
  if (a.group_ncap) a.group_ncap += bb * G;
  if (a.group_whole) a.group_whole += bb * G;
  if (a.group_gang) a.group_gang += bb * G;
  if (a.group_prio) a.group_prio += bb * G;
  if (a.group_dsel) {
    a.group_dsel += bb * G;
    a.group_dbase += bb * G * D;
    a.group_dcap += bb * G * D;
    a.group_skew += bb * G;
    a.group_mindom += bb * G;
    a.group_delig += bb * G * D;
  }
  if (SWEEP) {
    a.group_class += bb * G;
    a.exclude_idx += bb * a.X;
    a.price_cap += bb;
  } else {
    a.mask_bits += bb * G * W;
    a.exist_cap += bb * G * E;
    a.exist_remaining += bb * E * KR;
    a.exist_zone += bb * E;
    a.exist_ct += bb * E;
  }
  // the carry
  a.exist_rem += bb * E * KR;
  a.used += bb * N * KR;
  a.colmask += bb * W * N;
  a.active += bb * N;
  a.node_pool += bb * N;
  a.cap_e += bb * E;
  a.limits += bb * P * KR;
  a.node_zone += bb * N;
  a.node_ct += bb * N;
  // the flat row
  const size_t row = bb * (size_t)a.total;
  if (a.K > 0) {
    a.take_exist = a.te_dense + bb * G * E;
    a.te_head += row;
  } else {
    a.take_exist += row;
  }
  a.take_new += row;
  a.unsched += row;
  a.dom_placed += row;
  a.used_out += row;
  a.pool_out += row;
  a.zone_out += row;
  a.ct_out += row;
  a.na_out += row;
  if (a.prio_inv) a.prio_inv += row;
}

// Block r's view of the column-sharded problem (SHARDED): the column-axis
// arrays moved to shard r (O, PT and W are one shard's), the carry to block
// r's own (every block keeps a replica of the group-scan state), and for
// r > 0 the flat result row and the pool budgets to a scratch replica:
// block 0 alone writes the caller's.  The problem's replicated rows stay
// where they are.
__device__ void offset_shard(ScanArgs& a, int r) {
  const size_t G = a.G, E = a.E, N = a.N, P = a.P, W = a.W;
  const size_t O = a.O, PT = a.PT, rr = r;
  // the shards
  a.col_alloc += rr * O * KR;
  a.col_daemon += rr * O * KR;
  a.pt_alloc += rr * PT * KR;
  a.col_pool += rr * O;
  a.pool_bits += rr * P * W;
  a.col_zone += rr * O;
  a.col_ct += rr * O;
  a.mask_bits += rr * (size_t)a.C * W;
  if (a.seed_colmask) a.seed_colmask += rr * (size_t)a.A * W;
  // the carry
  a.exist_rem += rr * E * KR;
  a.used += rr * N * KR;
  a.colmask += rr * W * N;
  a.active += rr * N;
  a.node_pool += rr * N;
  a.cap_e += rr * E;
  a.node_zone += rr * N;
  a.node_ct += rr * N;
  a.xslot += rr * (N * (size_t)a.ZC + 4 * G);
  if (r == 0) return;
  // the flat row and the pool budgets: block 0 writes the caller's, every
  // other block a replica of its own in the scratch (the steps read their
  // flat rows and budgets back, so each block keeps its own)
  const ptrdiff_t row = (a.xrow + (rr - 1) * a.total) - a.row0;
  a.take_exist += row;
  a.take_new += row;
  a.unsched += row;
  a.dom_placed += row;
  a.used_out += row;
  a.pool_out += row;
  a.zone_out += row;
  a.ct_out += row;
  a.na_out += row;
  if (a.prio_inv) a.prio_inv += row;
  if (a.ex_counts) {
    a.ex_counts += row;
    a.ex_bits += row;
  }
  a.limits = a.xrow + (size_t)(a.S - 1) * a.total + (rr - 1) * P * KR;
}

// The explain=1 elimination counts of the column-sharded scan, K2's pack
// (ffd_pack.cu; ffd.py:1113-1214) moved into K7's epilogue: each block
// counts its shard's admitted columns per class (fit, limit, topology,
// and the fitting, fundable ones for the whole-node class) for every
// group from the final state, the counts are summed over the shards (the
// reference's psum, ffd.py:1202), and the slot class joins after the sum.
// A column's domain is its grid slot's in shard 0's leading block.
// Integers only.  Every thread calls.
template <bool GANG>
__device__ void sharded_pack(const ScanArgs& a, ScanShared& S) {
  __shared__ int s_part[4];
  __shared__ int s_blocked[MAXZC];
  __shared__ int s_bdom[MAXD];
  const int tid = threadIdx.x;
  const int G = a.G, PT = a.PT, ZC = a.ZC, D = a.D, W = a.W;
  int* part = a.xslot + (size_t)a.N * ZC;  // [G, 4]
  for (int g = 0; g < G; ++g) {
    const int dsel = a.group_dsel ? a.group_dsel[g] : 0;
    if (tid == 0) {
      for (int k = 0; k < 4; ++k) s_part[k] = 0;
      if (dsel > 0) {
        // the skew ceiling after the group's own placements
        const int* base = a.group_dbase + (size_t)g * D;
        const int* elig = a.group_delig + (size_t)g * D;
        const float* placed = a.dom_placed + (size_t)g * D;
        int m_elig = 1 << 29, pop = 0;
        for (int d = 0; d < D; ++d) {
          const int f = (int)((unsigned)base[d] + (unsigned)(int)placed[d]);
          if (elig[d]) {
            m_elig = min(m_elig, f);
            pop += f > 0;
          }
        }
        const int mindom = a.group_mindom[g];
        const int m_floor = (mindom > 0 && pop < mindom) ? 0 : m_elig;
        const int ceiling =
            (int)((unsigned)m_floor + (unsigned)a.group_skew[g]);
        for (int d = 0; d < D; ++d) {
          const int f = (int)((unsigned)base[d] + (unsigned)(int)placed[d]);
          s_bdom[d] = !elig[d] || f >= ceiling;
        }
        const int* slot_dom =
            dsel == 1 ? slot_zone<true>(a) : slot_ct<true>(a);
        for (int z = 0; z < ZC; ++z)
          s_blocked[z] = s_bdom[min(max(slot_dom[z], 0), D - 1)];
      }
    }
    __syncthreads();
    float req[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) req[r] = a.group_req[g * KR + r];
    const uint32_t* row = a.mask_bits + (size_t)a.mask_rows[g] * W;
    int fit = 0, lim = 0, topo = 0, ok = 0;
    for (int pt = tid; pt < PT; pt += NT) {
      const int lo = pt * ZC;
      int cpb = 0;  // admitted columns of the block
      for (int z = 0; z < ZC; ++z)
        cpb += (row[(lo + z) >> 5] >> ((lo + z) & 31)) & 1u;
      if (!cpb) continue;
      const bool fits = all_fits3(&a.pt_alloc[pt * KR],
                                  &a.col_daemon[(size_t)lo * KR], req);
      const int p = a.col_pool[lo];
      const bool lim_ok = all_fits3(&a.limits[p * KR],
                                    &a.pool_daemon[p * KR], req);
      if (!fits) {
        fit += cpb;
      } else if (!lim_ok) {
        lim += cpb;
      } else {
        ok += cpb;
        if (dsel > 0)
          for (int z = 0; z < ZC; ++z)
            if (s_blocked[z])
              topo += (row[(lo + z) >> 5] >> ((lo + z) & 31)) & 1u;
      }
    }
    atomicAdd(&s_part[0], fit);
    atomicAdd(&s_part[1], lim);
    atomicAdd(&s_part[2], topo);
    atomicAdd(&s_part[3], ok);
    __syncthreads();
    if (tid < 4) part[g * 4 + tid] = s_part[tid];
    __syncthreads();
  }
  cluster_combine<true>(part, 4 * G);
  for (int g = tid; g < G; g += NT) {
    const int* c = part + g * 4;
    const bool stranded = a.unsched[g] > 0.0f;
    const bool gang = GANG && a.group_gang[g] != 0;
    const bool whole = a.group_whole[g] != 0 || gang;
    const int whole_cols = GANG ? c[3] - c[2] : c[3];
    const int counts[5] = {c[0], c[1], c[2],
                           (whole && stranded) ? whole_cols : 0,
                           (stranded && S.na >= a.N) ? 1 : 0};
    int bits = 0;
    for (int i = 0; i < 5; ++i) {
      a.ex_counts[(size_t)g * 5 + i] = (float)counts[i];
      if (counts[i] > 0) bits |= 1 << i;
    }
    a.ex_bits[g] = (float)bits;
  }
}

// The top-K take_exist compaction (ffd.py:1068-1086): each group's nonzero
// entries in index order, ranked by a block scan, scattered into K
// (count, index) slots; empty slots hold (0, 0), ranks past K drop.
__device__ void compact_take_exist(const ScanArgs& a, ScanShared& S) {
  const int tid = threadIdx.x;
  const int G = a.G, E = a.E, K = a.K;
  float* cnt = a.te_head;
  float* idx = a.te_head + (size_t)G * K;
  for (int g = 0; g < G; ++g) {
    for (int k = tid; k < K; k += NT) {
      cnt[(size_t)g * K + k] = 0.0f;
      idx[(size_t)g * K + k] = 0.0f;
    }
    __syncthreads();
    unsigned carry = 0u;
    for (int base = 0; base < E; base += NT) {
      const int e = base + tid;
      const float v = e < E ? a.take_exist[(size_t)g * E + e] : 0.0f;
      const bool nz = v > 0.0f;
      unsigned tot;
      const unsigned rank =
          block_excl_scan<NT>(nz ? 1u : 0u, S.warp, &tot) + carry;
      carry += tot;
      if (nz && rank < (unsigned)K) {
        cnt[(size_t)g * K + rank] = v;
        idx[(size_t)g * K + rank] = (float)e;
      }
    }
    __syncthreads();
  }
}

// One block of NT threads per problem (grid = B).  TOPO: the heavy step for
// groups with dsel > 0.  GANG (with TOPO): the gang fill for groups with
// group_gang set.  SWEEP: the problem is a simulation of a shared
// snapshot, built in the prologue (kept existing rows, price-capped class
// masks).  SEED (light only, one problem): the carry starts from the
// prefix state of the seed arrays.  SHARDED (one problem, B = 1): the
// grid is ONE cluster of S blocks, block r holding column shard r; the
// column-axis reductions combine across the cluster (cluster_combine).
template <bool TOPO, bool SWEEP, bool GANG, bool SEED, bool SHARDED = false>
__global__ void __launch_bounds__(NT, 1) scan_kernel(const ScanArgs a0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScanShared S;
  __shared__ ScanArgs A;
  const int tid = threadIdx.x;
  if (tid == 0) {
    A = a0;
    if constexpr (SHARDED)
      offset_shard(A, (int)cg::this_cluster().block_rank());
    else
      offset_block<SWEEP>(A, blockIdx.x);
  }
  __syncthreads();
  const ScanArgs& a = A;
  const int G = a.G, E = a.E, N = a.N, O = a.O, PT = a.PT;
  const int P = a.P, D = a.D, W = a.W;
  ScanDyn s;
  s.pt = reinterpret_cast<float*>(smem);                        // [PT, R]
  s.cap = reinterpret_cast<int*>(s.pt + PT * KR);                // [N]
  s.take = s.cap + N;                                            // [N]
  s.gm = reinterpret_cast<uint32_t*>(s.take + N);                // [W]
  s.feas = s.gm + W;                                             // [W]
  s.bd = reinterpret_cast<int*>(s.feas + W);                     // [N]
  s.kpd = s.bd + (TOPO ? N : 0);                                 // [P, D]
  s.pm = reinterpret_cast<uint32_t*>(s.kpd + (TOPO ? P * D : 0));  // [W]
  s.csum = s.pm + (SWEEP ? W : 0);        // [N, NS], then the mask's [NS]

  // -- the simulation: its exclusions and its price-capped columns --------
  if (tid == 0) S.nx = SWEEP ? a.X : 0;
  if (SWEEP) {
    if (tid < a.X) S.excl[tid] = a.exclude_idx[tid];
    const float pcap = a.price_cap[0];
    for (int w = tid; w < W; w += NT) {
      uint32_t word = 0u;
      for (int bit = 0; bit < 32; ++bit) {
        const int o = w * 32 + bit;
        if (o < O && a.col_price[o] < pcap) word |= 1u << bit;
      }
      s.pm[w] = word;
    }
  }
  __syncthreads();

  // -- initial carry --------------------------------------------------------
  for (int i = tid; i < PT * KR; i += NT) s.pt[i] = a.pt_alloc[i];
  for (int i = tid; i < E * KR; i += NT)
    a.exist_rem[i] =
        SWEEP ? __fmul_rn(a.exist_remaining[i], kept(S, i / KR) ? 1.0f : 0.0f)
              : a.exist_remaining[i];
  for (int i = tid; i < N * KR; i += NT)
    a.used[i] = SEED ? a.seed_used[i] : 0.0f;
  // the carry's [N, W] column words: the seed's [A, W] slot rows, and their
  // chunk summaries (none past them).  A walk reads only the chunks a
  // summary marks, and an opened slot writes its whole row and summary, so
  // nothing else needs clearing.
  const int NS = summary_words(W, a.ZC);
  if constexpr (SEED) {
    for (size_t i = tid; i < (size_t)a.A * W; i += NT)
      a.colmask[i] = a.seed_colmask[i];
    for (int i = tid; i < N * NS; i += NT)
      s.csum[i] = i / NS < a.A
                      ? summary_word(a.seed_colmask + (size_t)(i / NS) * W,
                                     i % NS, W, a.ZC)
                      : 0u;
  }
  for (int i = tid; i < N; i += NT) {
    a.active[i] = SEED ? (a.seed_active[i] != 0) : 0;
    a.node_pool[i] = SEED ? a.seed_pool[i] : 0;
    a.node_zone[i] = -1;
    a.node_ct[i] = -1;
  }
  for (int i = tid; i < P * KR; i += NT) a.limits[i] = a.pool_limit[i];
  if (tid == 0) {
    S.na = 0;
    S.hi0 = 0;
    S.first = INT_MAX;
    S.sum = 0;
    S.dreal_zone = INT_MIN;
    S.dreal_ct = INT_MIN;
  }
  if constexpr (SHARDED) {
    // every block takes shard 0's leading grid-slot block as the
    // slot->domain map (the reference's all_gather(...)[0], ffd.py:631)
    cg::cluster_group cl = cg::this_cluster();
    ClusterXch& X = xch();
    X.par[tid] = 0;  // each thread's own exchange-slot parity
    for (int z = tid; z < a.ZC; z += NT) {
      X.zc0_zone[z] = a.col_zone[z];
      X.zc0_ct[z] = a.col_ct[z];
    }
    cl.sync();
    if (cl.block_rank() != 0) {
      const int* zz = cl.map_shared_rank(X.zc0_zone, 0);
      const int* zt = cl.map_shared_rank(X.zc0_ct, 0);
      for (int z = tid; z < a.ZC; z += NT) {
        X.zc0_zone[z] = zz[z];
        X.zc0_ct[z] = zt[z];
      }
    }
  }
  __syncthreads();
  if (SEED) {
    // num_active = seed_active.sum(): new nodes append after the seeded
    // slots, exactly where the full solve's suffix would open them
    int mine = 0, top = 0;
    for (int i = tid; i < N; i += NT)
      if (a.seed_active[i] != 0) {
        ++mine;
        top = i + 1;
      }
    if (mine) {
      atomicAdd(&S.na, mine);
      atomicMax(&S.hi0, top);
    }
    __syncthreads();
  }
  if (TOPO) {
    // the real domain count of each axis: max id over every column + 1
    // (padding carries the block pattern), at least 1
    int mz = INT_MIN, mc = INT_MIN;
    for (int o = tid; o < O; o += NT) {
      mz = max(mz, a.col_zone[o]);
      mc = max(mc, a.col_ct[o]);
    }
    atomicMax(&S.dreal_zone, mz);
    atomicMax(&S.dreal_ct, mc);
    __syncthreads();
    if constexpr (SHARDED) {
      // the max over every shard's columns
      ClusterXch& X = xch();
      if (tid == 0) {
        X.tmp[0] = S.dreal_zone;
        X.tmp[1] = S.dreal_ct;
      }
      cluster_combine<false>(X.tmp, 2);
      if (tid == 0) {
        S.dreal_zone = X.tmp[0];
        S.dreal_ct = X.tmp[1];
      }
      __syncthreads();
    }
    if (tid == 0) {
      S.dreal_zone = max(S.dreal_zone + 1, 1);
      S.dreal_ct = max(S.dreal_ct + 1, 1);
    }
  }

  for (int g = 0; g < G; ++g) {
    const int row = a.group_class ? a.group_class[g] : g;
    if (tid < KR) S.req[tid] = a.group_req[g * KR + tid];
    if (tid == 0) {
      S.cnt = a.group_count[g];
      S.ncap = a.group_ncap ? a.group_ncap[g] : BIGCAP;
      S.whole = a.group_whole ? a.group_whole[g] != 0 : 0;
      S.dsel = TOPO ? a.group_dsel[g] : 0;
      S.gang = GANG ? a.group_gang[g] != 0 : 0;
      S.row = row;
      S.first = INT_MAX;
      S.sum = 0;
    }
    // the mesh path gathers the group's row of the resident mask table
    const int mrow = SHARDED ? a.mask_rows[g] : row;
    const uint32_t* mask = a.mask_bits + (size_t)mrow * W;
    for (int w = tid; w < W; w += NT) {
      s.gm[w] = SWEEP ? (mask[w] & s.pm[w]) : mask[w];
      s.feas[w] = 0u;
    }
    // the chunks that mask reaches, a thread a chunk: a node's walk visits
    // only those (and the feasible columns lie in them)
    for (int c = tid; c < NS * 32; c += NT) {
      bool any = false;
      if (c < row_chunks(W, a.ZC))
        for (int w = c * chunk_words(a.ZC); w < chunk_end(c, W, a.ZC); ++w)
          any = any || (SWEEP ? (mask[w] & s.pm[w]) : mask[w]) != 0u;
      const unsigned held = __ballot_sync(FULLMASK, any);
      if ((tid & 31) == 0) gsum_of(s, N, NS)[c >> 5] = held;
    }
    if (tid < P) {
      S.kfull[tid] = 0;
      S.any[tid] = 0;
      S.ptake[tid] = 0;
    }
    __syncthreads();
    if constexpr (GANG) {
      if (S.gang)
        gang_step<SHARDED>(a, S, s, g);
      else if (S.dsel > 0)
        heavy_step<SHARDED>(a, S, s, g);
      else
        light_step<SHARDED>(a, S, s, g);
    } else if constexpr (TOPO) {
      if (S.dsel > 0)
        heavy_step<SHARDED>(a, S, s, g);
      else
        light_step<SHARDED>(a, S, s, g);
    } else {
      light_step<SHARDED>(a, S, s, g);
    }
    __syncthreads();
  }
  if (a.K > 0) compact_take_exist(a, S);
  if (!SWEEP && a.prio_inv && tid == 0) priority_witness(a);
  if constexpr (SHARDED) {
    if (a.ex_counts) {
      __syncthreads();
      sharded_pack<GANG>(a, S);
    }
  }

  // -- final state ---------------------------------------------------------
  for (int i = tid; i < N * KR; i += NT) a.used_out[i] = a.used[i];
  for (int n = tid; n < N; n += NT) {
    a.pool_out[n] = (float)a.node_pool[n];
    a.zone_out[n] = (float)a.node_zone[n];
    a.ct_out[n] = (float)a.node_ct[n];
  }
  if (tid == 0) a.na_out[0] = (float)S.na;
  // no block leaves while a peer may still read its shared memory
  if constexpr (SHARDED) cg::this_cluster().sync();
}

// the dynamic shared memory of one block
template <bool TOPO, bool SWEEP>
size_t scan_smem(const ScanArgs& a) {
  return (size_t)a.PT * KR * sizeof(float) + 2 * (size_t)a.N * sizeof(int) +
         2 * (size_t)a.W * sizeof(uint32_t) +
         (TOPO ? ((size_t)a.N + (size_t)a.P * a.D) * sizeof(int) : 0) +
         (SWEEP ? (size_t)a.W * sizeof(uint32_t) : 0) +
         ((size_t)a.N + 1) * summary_words(a.W, a.ZC) * sizeof(uint32_t);
}

// The launch configuration of the column-sharded instance: one cluster of
// a.S blocks (cudaLaunchAttributeClusterDimension), sizes past the
// portable 8 with cudaFuncAttributeNonPortableClusterSizeAllowed.  `attr`
// is the one attribute `cfg` points at.
template <bool TOPO, bool GANG, bool SEED>
cudaError_t sharded_config(const ScanArgs& a, size_t smem, void* stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  auto kern = scan_kernel<TOPO, false, GANG, SEED, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.S > 8) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3(a.S, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of this launch shape the card holds at once
// (cudaOccupancyMaxActiveClusters), or -1000 - a CUDA error code.  The
// caller asks once per shape before the first launch (parallel/mesh.py
// MeshExecutor); a launch the card cannot hold is refused by
// cudaLaunchKernelEx all the same, never run some other way.
template <bool TOPO, bool GANG, bool SEED>
int sharded_occupancy(const ScanArgs& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = sharded_config<TOPO, GANG, SEED>(
      a, scan_smem<TOPO, false>(a), nullptr, cfg, attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &n, (void*)scan_kernel<TOPO, false, GANG, SEED, true>, &cfg);
  return err == cudaSuccess ? n : -1000 - (int)err;
}

// Plain-C entry point body for ctypes.  ptrs: SCAN_NPTRS device addresses in
// ScanArgs order (0 for what the instance does not read); dims: G, E, N, O,
// PT, ZC, P, D, W, B, X, K, total, A, C, S.  Returns 0, a CUDA error code
// (cudaGetLastError after the launch, or cudaLaunchKernelEx's refusal of a
// cluster the card cannot hold), or a negative argument error.  Launches B
// blocks (SHARDED: one cluster of S blocks) on `stream` and does not
// synchronise.
template <bool TOPO, bool SWEEP, bool GANG, bool SEED, bool SHARDED = false>
int scan_entry(const unsigned long long* ptrs, int nptrs, const int* dims,
               int ndims, void* stream) {
  if (nptrs != SCAN_NPTRS || ndims != SCAN_NDIMS) return -1;
  ScanArgs a;
  int i = 0;
  a.group_req = (const float*)ptrs[i++];
  a.group_count = (const int*)ptrs[i++];
  a.mask_bits = (const uint32_t*)ptrs[i++];
  a.exist_cap = (const int*)ptrs[i++];
  a.exist_remaining = (const float*)ptrs[i++];
  a.pool_limit = (const float*)ptrs[i++];
  a.group_ncap = (const int*)ptrs[i++];
  a.group_whole = (const int*)ptrs[i++];
  a.col_alloc = (const float*)ptrs[i++];
  a.col_daemon = (const float*)ptrs[i++];
  a.pt_alloc = (const float*)ptrs[i++];
  a.col_pool = (const int*)ptrs[i++];
  a.pool_daemon = (const float*)ptrs[i++];
  a.pool_bits = (const uint32_t*)ptrs[i++];
  a.exist_rem = (float*)ptrs[i++];
  a.used = (float*)ptrs[i++];
  a.colmask = (uint32_t*)ptrs[i++];
  a.active = (int*)ptrs[i++];
  a.node_pool = (int*)ptrs[i++];
  a.cap_e = (int*)ptrs[i++];
  a.limits = (float*)ptrs[i++];
  a.take_exist = (float*)ptrs[i++];
  a.take_new = (float*)ptrs[i++];
  a.unsched = (float*)ptrs[i++];
  a.dom_placed = (float*)ptrs[i++];
  a.used_out = (float*)ptrs[i++];
  a.pool_out = (float*)ptrs[i++];
  a.zone_out = (float*)ptrs[i++];
  a.ct_out = (float*)ptrs[i++];
  a.na_out = (float*)ptrs[i++];
  a.group_dsel = (const int*)ptrs[i++];
  a.group_dbase = (const int*)ptrs[i++];
  a.group_dcap = (const int*)ptrs[i++];
  a.group_skew = (const int*)ptrs[i++];
  a.group_mindom = (const int*)ptrs[i++];
  a.group_delig = (const int*)ptrs[i++];
  a.exist_zone = (const int*)ptrs[i++];
  a.exist_ct = (const int*)ptrs[i++];
  a.col_zone = (const int*)ptrs[i++];
  a.col_ct = (const int*)ptrs[i++];
  a.node_zone = (int*)ptrs[i++];
  a.node_ct = (int*)ptrs[i++];
  a.group_class = (const int*)ptrs[i++];
  a.exclude_idx = (const int*)ptrs[i++];
  a.price_cap = (const float*)ptrs[i++];
  a.col_price = (const float*)ptrs[i++];
  a.te_dense = (float*)ptrs[i++];
  a.te_head = (float*)ptrs[i++];
  a.group_gang = (const int*)ptrs[i++];
  a.group_prio = (const int*)ptrs[i++];
  a.prio_inv = (float*)ptrs[i++];
  a.seed_used = (const float*)ptrs[i++];
  a.seed_pool = (const int*)ptrs[i++];
  a.seed_active = (const int*)ptrs[i++];
  a.seed_colmask = (const uint32_t*)ptrs[i++];
  a.mask_rows = (const int*)ptrs[i++];
  a.xslot = (int*)ptrs[i++];
  a.ex_counts = (float*)ptrs[i++];
  a.ex_bits = (float*)ptrs[i++];
  a.row0 = (float*)ptrs[i++];
  a.xrow = (float*)ptrs[i++];
  a.G = dims[0];
  a.E = dims[1];
  a.N = dims[2];
  a.O = dims[3];
  a.PT = dims[4];
  a.ZC = dims[5];
  a.P = dims[6];
  a.D = dims[7];
  a.W = dims[8];
  a.B = dims[9];
  a.X = dims[10];
  a.K = dims[11];
  a.total = dims[12];
  a.A = dims[13];
  a.C = dims[14];
  a.S = dims[15];
  if (a.P < 1 || a.P > MAXP || a.ZC < 1 || a.N < 1 || a.D < 1 || a.G < 1 ||
      a.B < 1 || a.O != a.PT * a.ZC || a.W != (a.O + 31) / 32 || a.K < 0 ||
      !a.node_zone || !a.node_ct ||
      (a.E > 0 && (!a.exist_zone || !a.exist_ct)))
    return -2;
  if (TOPO && (a.D > MAXD || a.ZC > MAXZC || !a.group_dsel ||
               !a.group_dbase || !a.group_dcap || !a.group_skew ||
               !a.group_mindom || !a.group_delig || !a.col_zone ||
               !a.col_ct))
    return -2;
  if (SWEEP && (a.X < 0 || a.X > MAXX || !a.group_class || !a.price_cap ||
                !a.col_price || (a.X > 0 && !a.exclude_idx)))
    return -2;
  if (!SWEEP && (a.X != 0 || a.group_class || !a.group_ncap ||
                 !a.group_whole))
    return -2;
  // the gang instance needs the topology rows and the gang row; the
  // witness its priority row, and only the batched scan writes it
  if (GANG != (a.group_gang != nullptr) || (GANG && (!TOPO || SWEEP)))
    return -2;
  if ((a.prio_inv != nullptr) != (a.group_prio != nullptr) ||
      (SWEEP && a.prio_inv))
    return -2;
  if ((a.K > 0) != (a.te_dense != nullptr && a.te_head != nullptr) ||
      (a.K == 0 && a.E > 0 && !a.take_exist))
    return -2;
  // the seeded instance: one light-only problem with its seed arrays, a
  // dense take_exist and no witness; every other instance takes none
  if (SEED != (a.seed_used != nullptr) ||
      (SEED && (TOPO || SWEEP || GANG || a.B != 1 || a.K != 0 ||
                a.prio_inv || !a.seed_pool || !a.seed_active ||
                a.A < 0 || a.A > a.N || (a.A > 0 && !a.seed_colmask))) ||
      (!SEED && (a.A != 0 || a.seed_pool || a.seed_active ||
                 a.seed_colmask)))
    return -2;
  // the column-sharded instance: one problem over S shards, the mask
  // table rows gathered per group, the slot scratch, the counts in the
  // epilogue (both regions or none); no other instance takes any of it
  if (SHARDED && (SWEEP || a.B != 1 || a.K != 0 || a.S < 1 || a.S > 16 ||
                  a.C < 1 || !a.mask_rows || !a.xslot || a.ZC > MAXZC ||
                  a.P > MAXP || !a.row0 || (a.S > 1 && !a.xrow) ||
                  (a.ex_counts != nullptr) != (a.ex_bits != nullptr)))
    return -2;
  if (!SHARDED && (a.C != 0 || a.S != 0 || a.mask_rows || a.xslot ||
                   a.ex_counts || a.ex_bits || a.row0 || a.xrow))
    return -2;
  const size_t smem = scan_smem<TOPO, SWEEP>(a);
  if constexpr (SHARDED) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t err =
        sharded_config<TOPO, GANG, SEED>(a, smem, stream, cfg, attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, scan_kernel<TOPO, false, GANG, SEED, true>,
                               a);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<TOPO, SWEEP, GANG, SEED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    scan_kernel<TOPO, SWEEP, GANG, SEED>
        <<<a.B, NT, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
}
