// The per-group arithmetic of the explain pack in the scans' epilogue
// (ffd_scan_common.cuh `explain_pack`), for the device and for a host shim
// built with g++ -ffp-contract=off (tests/test_torch_explain_epilogue.py).
//
// Replaces the explain=1 aux of karpenter_tpu/solver/ffd.py
// `_solve_ffd_impl`, ffd.py:1113-1214, and the explain=2 class map,
// :1215-1237: per group, the admitted catalog columns eliminated by fit /
// limit / topology / whole-node / slots, judged against the scan's FINAL
// state, and the reason bitset; with a map row, each column's first
// eliminating class.
//
//   * fit: no EMPTY node of the column's (pool,type) block holds one pod
//     plus the block's daemon charge (all_fits3 of the block's
//     allocatable, its first column's daemon row and the request);
//   * limit: the block fits, but its pool's final budget cannot fund one
//     more pod plus the per-node daemon charge;
//   * topology (a group with a zone or capacity-type constraint,
//     ffd.py:1141-1175): the block fits and is funded, and the column's
//     domain is ineligible or at the skew ceiling after the group's own
//     placements (dom_placed + base counts; minDomains as in the
//     water-fill).  A column's domain is its grid slot's, so the counts
//     test a per-group mask of blocked grid slots;
//   * whole (a whole-node class, or with the gang row a gang,
//     ffd.py:1181-1194, that stranded): the fitting, funded columns, less
//     the topology ones with the gang row;
//   * slots: the group stranded with every node slot in use.
//
// A team of L lanes takes one group (one warp, or with fewer groups than
// warps several): each lane takes every L-th (pool,type) block
// (`lane_pack`) and every L-th map column (`map_column`), and each warp
// every 32nd domain (`lane_dom`); the device combines the lanes with
// exact integer warp reductions (add, min), ballots and, across a team's
// warps, sums in shared memory; the host shim replays the lanes one after
// another.
// Integers only, apart from the all-fits tests, which are the scans' own
// (ffd_walk.cuh), their first subtraction taken once a block
// (`block_room`); every row a test reads is loaded before the test
// (`load_row`).
#pragma once

#include "ffd_walk.cuh"

// the explain classes (solver/explain.py KERNEL_CONSTRAINTS)
#define EXPLAIN_C 5
// the domain axis's capacity (ffd_scan_common.cuh MAXD) in 32-bit words
#define EXPLAIN_DWORDS 4

KT_HD int kt_popc64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __popcll(x);
#else
  return __builtin_popcountll(x);
#endif
}

// a domain's pod count after the group's own placements, with the
// reference's int32 wrap-around: base + (int)placed
KT_HD int dom_count(int base, float placed) {
  return (int)((unsigned)base + (unsigned)(int)placed);
}

// One lane's share of the skew floor's inputs, over the domains
// d = lane, lane + L, ... < D: the least count of an eligible domain
// (1 << 29 when the lane has none) and how many eligible domains hold a
// pod.
struct DomPart {
  int m_elig;
  unsigned pop;
};

KT_HD DomPart lane_dom(const int* base, const int* elig, const float* placed,
                       int D, int lane, int L) {
  DomPart p = {1 << 29, 0u};
  for (int d = lane; d < D; d += L) {
    // every row read before any test: one memory round trip a domain
    const int e = elig[d];
    const int f = dom_count(base[d], placed[d]);
    p.m_elig = e && f < p.m_elig ? f : p.m_elig;
    p.pop += e && f > 0 ? 1u : 0u;
  }
  return p;
}

// The skew ceiling from the lanes' combined parts: the least eligible
// count, or 0 while fewer than minDomains domains hold a pod, plus the
// max skew (int32 wrap-around).
KT_HD int skew_ceiling(int m_elig, unsigned pop, int mindom, int skew) {
  const int m_floor = (mindom > 0 && (int)pop < mindom) ? 0 : m_elig;
  return (int)((unsigned)m_floor + (unsigned)skew);
}

// whether domain d blocks the group: ineligible, or at the ceiling
KT_HD bool dom_blocked(const int* base, const int* elig, const float* placed,
                       int d, int ceiling) {
  const int e = elig[d];
  const int f = dom_count(base[d], placed[d]);
  return !e || f >= ceiling;
}

// the KR floats of row `src` in registers: the loads of a row issue
// together, where all_fits3's short-circuit would chain them one resource
// after another
KT_HD void load_row(const float* src, float* dst) {
#pragma unroll
  for (int r = 0; r < KR; ++r) dst[r] = src[r];
}

// The blocked domains as bit words (bit d % 32 of word d / 32), at most
// EXPLAIN_DWORDS of them; indexed with compile-time constants only, so the
// device keeps the words in registers.
struct DomWords {
  uint32_t w0, w1, w2, w3;
  KT_HD uint32_t at(int k) const {
    return k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : w3;
  }
  KT_HD void set(int k, uint32_t v) {
    if (k == 0) w0 = v;
    else if (k == 1) w1 = v;
    else if (k == 2) w2 = v;
    else w3 = v;
  }
};

// whether domain id `d` (clamped to [0, D), as the reference's gather)
// is blocked
KT_HD bool blocked_in(const DomWords& bw, int d, int D) {
  d = d < 0 ? 0 : d >= D ? D - 1 : d;
  return (bw.at(d >> 5) >> (d & 31)) & 1u;
}

// whether pool p's final budget funds one more pod of `req` plus the
// pool's per-node daemon charge
KT_HD bool pool_funds(const float* limits, const float* pool_daemon, int p,
                      const float* req) {
  float lim[KR], dm[KR];
  load_row(&limits[p * KR], lim);
  load_row(&pool_daemon[p * KR], dm);
  return all_fits3(lim, dm, req);
}

// The admitted columns of block pt (ZC <= 64 of them from column pt * ZC)
// as a slot mask: bit z = column pt * ZC + z.  The block spans at most
// three words; only those it reaches are read.
KT_HD uint64_t block_cols(const uint32_t* row, int pt, int ZC) {
  const int lo = pt * ZC, w = lo >> 5, b = lo & 31;
  uint64_t x = (uint64_t)row[w] >> b;
  int have = 32 - b;
  if (have < ZC) {
    x |= (uint64_t)row[w + 1] << have;
    have += 32;
  }
  if (have < ZC) x |= (uint64_t)row[w + 2] << have;
  return ZC >= 64 ? x : x & ((1ull << ZC) - 1ull);
}

// a block's verdict for the group: 1 fit, 2 limit, 0 neither
KT_HD int block_verdict(bool fits, bool funds) {
  return !fits ? 1 : !funds ? 2 : 0;
}

// Element i of the blocks' [PT, R] room for pods on an empty node: the
// block's allocatable less its first column's daemon row, all_fits3's
// first subtraction (ffd_walk.cuh), taken once a block for every group.
KT_HD float block_room(const float* pt_alloc, const float* col_daemon,
                       int ZC, int i) {
  return kt_sub(pt_alloc[i], col_daemon[(size_t)(i / KR) * ZC * KR + i % KR]);
}

// Block pt's verdict for a group of request `req`: whether its room (a
// [PT, R] row of `block_room`) holds one pod — all_fits3 of allocatable,
// daemon row and request, to the bit — and the bit of its pool `p` in
// `pool_ok` (bit p: pool_funds of pool p; ids past 63 never occur, the
// mask only keeps a padding block's read defined).
KT_HD int block_verdict_of(int pt, const float* room, int p,
                           uint64_t pool_ok, const float* req) {
  float rm[KR];
  load_row(&room[pt * KR], rm);
  return block_verdict(all_fits2(rm, req), (pool_ok >> (p & 63)) & 1ull);
}

// explain=2: a column's first eliminating class, fit > limit > topology >
// whole (1-based into KERNEL_CONSTRAINTS), 0 for a kept or not admitted
// column
KT_HD int map_class(bool admitted, int verdict, bool topo_blocked,
                    bool whole_stranded) {
  if (!admitted) return 0;
  if (verdict) return verdict;
  if (topo_blocked) return 3;
  return whole_stranded ? 4 : 0;
}

// One lane's share of the group's class counts, over the blocks
// pt = lane, lane + L, ... < PT: its admitted columns in blocks that do
// not fit (fit), that fit but whose pool cannot fund a pod (lim), that
// fit and are funded (ok), and of those the columns in the blocked grid
// slots `topo_slots` (topo).  A block the group admits no column of is
// judged not at all.  Four blocks a turn: their global loads (pool ids,
// mask words) issue before any of them is tested.
struct PackPart {
  unsigned fit, lim, topo, ok;
};

KT_HD PackPart lane_pack(const uint32_t* row, int PT, int ZC,
                         const float* room, const int* col_pool,
                         uint64_t pool_ok, uint64_t topo_slots,
                         const float* req, int lane, int L) {
  PackPart c = {0u, 0u, 0u, 0u};
#pragma unroll 4
  for (int pt = lane; pt < PT; pt += L) {
    const int p = col_pool[pt * ZC];
    const uint64_t cols = block_cols(row, pt, ZC);
    if (!cols) continue;
    const unsigned n = (unsigned)kt_popc64(cols);
    const int v = block_verdict_of(pt, room, p, pool_ok, req);
    c.fit += v == 1 ? n : 0u;
    c.lim += v == 2 ? n : 0u;
    c.ok += v == 0 ? n : 0u;
    c.topo += v == 0 ? (unsigned)kt_popc64(cols & topo_slots) : 0u;
  }
  return c;
}

// Column o's class in the group's explain=2 map row: its block's verdict
// (judged only for an admitted column), its own domain id `col_dom[o]`
// against the blocked domains `bw` when the group has a domain selector
// (`topo`), and whether the group is a stranded whole-node class.  Its
// global loads (pool id, domain id, mask word) issue before any test.
KT_HD int map_column(const uint32_t* row, int o, int ZC, const float* room,
                     const int* col_pool, uint64_t pool_ok,
                     const float* req, bool topo, const DomWords& bw,
                     const int* col_dom, int D, bool whole_stranded) {
  const int pt = o / ZC;
  const int p = col_pool[pt * ZC];
  const int dom = topo ? col_dom[o] : 0;
  if (!((row[o >> 5] >> (o & 31)) & 1u)) return 0;
  return map_class(true, block_verdict_of(pt, room, p, pool_ok, req),
                   topo && blocked_in(bw, dom, D), whole_stranded);
}

// The group's explain row from its combined class counts: counts[5] as
// floats and the reason bits (bit i: counts[i] > 0).  `whole`: the group
// is a whole-node class (or with `gang_row`, a gang); with `gang_row`
// the whole class leaves out the topology columns.  `slots_full`: every
// node slot is in use.
KT_HD int explain_row(unsigned fit, unsigned lim, unsigned topo, unsigned ok,
                      bool whole, bool gang_row, bool stranded,
                      bool slots_full, float* counts) {
  const unsigned whole_cols = gang_row ? ok - topo : ok;
  const unsigned c[EXPLAIN_C] = {
      fit, lim, topo, (whole && stranded) ? whole_cols : 0u,
      (stranded && slots_full) ? 1u : 0u};
  int bits = 0;
  for (int i = 0; i < EXPLAIN_C; ++i) {
    counts[i] = (float)(int)c[i];
    if (c[i] > 0u) bits |= 1 << i;
  }
  return bits;
}

