// The FFD scan shared by K5 ffd_batch_scan and K4 ffd_sweep_scan (both
// lanes): one templated kernel, `scan_kernel<TOPO, SWEEP>`, that runs the
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
//   * SWEEP: the problem is a consolidation simulation, "the shared snapshot
//     minus a few nodes" (ffd.py:1570): the block keeps the existing rows
//     its exclusions leave, reads its groups' column masks and node caps
//     from per-class tables (`class_mask[gcls]`, `class_cap[gcls] * keep`)
//     and ANDs in its price cap (`col_price < pcap`) as a word mask;
//   * with K > 0 the take_exist top-K compaction (:1068-1086) in the
//     epilogue: a block scan ranks each group's nonzero entries.
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
// per-problem pointer to problem b, offset_block).  Thread n owns node
// slot n (a strided loop when N > 1024; threads past N idle in the node
// loops).  The carry lives in device memory, one slice per block:
// the surviving-column mask as u32 bit-words in [W, N] layout (neighbouring
// threads touch neighbouring words), used [N, R], the pool budgets [P, R],
// the existing-node remainders [E, R], and each node's zone and
// capacity-type pin.  Per step, every thread works on its own node (the
// [N, PT] fit and the per-node max over eligible blocks, in the heavy step
// per grid slot and then per domain; the colmask narrowing), block scans
// give the node-axis and existing-axis cumsums (`_prefix_fill`,
// `_clamp_pool_limits`, and per domain in the heavy step), shared-memory
// atomics the per-pool and per-(pool, domain) maxima, and the short
// sequential loops (the per-pool new-node cascade, the pool x domain budget
// loop, the water-fill's integral repair) run on thread 0 before the slots
// they open are activated in parallel.  The water-fill evaluates its 6D
// candidate levels one per thread.  Work is skipped where the reference's is
// a provable no-op: the fit runs only over blocks that hold a surviving,
// admitted column, and the ok-block narrowing only on nodes that took pods
// (an untouched node's mask is already narrowed against its unchanged
// `used`).  (pool, type) rows sit in shared memory.
//
// Float parity: every operation is the reference's, in its order, rounded
// to nearest (ffd_common.cuh); float sums over domains run in index order.
// Integer sums that the reference takes in int32 wrap modulo 2^32 here too
// (unsigned arithmetic).  Pool-limit and pool-take arithmetic is on
// integer-valued float32 terms, exact below 2^24 in any order.
#pragma once

#include "ffd_common.cuh"

#include <limits.h>

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
  uint32_t* colmask;             // [W, N]
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
  int G, E, N, O, PT, ZC, P, D, W;
  int B, X, K, total;            // problems, exclusions, top-K, flat row
};
// Every pointer above addresses problem 0 of the batch; block b offsets the
// per-problem ones (inputs, carry, the flat row) in offset_block.

#define SCAN_NPTRS 48
#define SCAN_NDIMS 13
#define MAXX 8
#define BIGCAP 536870912  /* encode.BIG: no per-node cap */

// per-step state every thread reads, in shared memory
struct ScanShared {
  unsigned warp[NT / 32];
  float req[KR];
  int cnt, ncap, whole, dsel, first, sum, na, crem;
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
};

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

// Narrow one node's candidate columns `m` (word w of its row) to the
// (pool,type) blocks whose allocatable still holds `u`: pt_expand(ok_pt).
// With dom >= 0, also to the grid slots of domain `dom` (slot_expand of
// zc_dom == dom).  last_pt/last_ok carry a block's verdict across a word
// boundary.
__device__ __forceinline__ uint32_t narrow_word(uint32_t m, int w, int ZC,
                                                const float* s_pt,
                                                const float* u,
                                                int& last_pt, bool& last_ok,
                                                const int* zcdom = nullptr,
                                                int dom = -1) {
  uint32_t keep = m;
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const int o = w * 32 + b;
    const int pt = o / ZC;
    if (dom >= 0 && zcdom[o - pt * ZC] != dom) {
      keep &= ~(1u << b);
      continue;
    }
    if (pt != last_pt) {
      last_pt = pt;
      last_ok = all_fits2(&s_pt[pt * KR], u);
    }
    if (!last_ok) keep &= ~(1u << b);
  }
  return keep;
}

// ---------------------------------------------------------------------------
// the light step (ffd.py:460-587)
__device__ void light_step(const ScanArgs& a, ScanShared& S,
                           const ScanDyn& s, int g) {
  const int tid = threadIdx.x;
  const int E = a.E, N = a.N, O = a.O, ZC = a.ZC, P = a.P, D = a.D,
            W = a.W;
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
  // cap; inactive slots hold nothing
  for (int n = tid; n < N; n += NT) {
    int cap = 0;
    if (a.active[n]) {
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r) u[r] = a.used[n * KR + r];
      int best = 0, last_pt = -1;
      for (int w = 0; w < W; ++w) {
        uint32_t m = a.colmask[(size_t)w * N + n] & s.gm[w];
        while (m) {
          const int o = w * 32 + __ffs(m) - 1;
          m &= m - 1;
          const int pt = o / ZC;
          if (pt != last_pt) {
            last_pt = pt;
            float av[KR];
#pragma unroll
            for (int r = 0; r < KR; ++r)
              av[r] = __fsub_rn(s.pt[pt * KR + r], u[r]);
            best = max(best, fit_count(av, req));
          }
        }
      }
      cap = min(best, ncap);
    }
    s.cap[n] = cap;
  }
  if (tid < P) S.limcap[tid] = fit_count(&a.limits[tid * KR], req);
  __syncthreads();

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
  // columns, drop blocks the new `used` no longer fits
  for (int n = tid; n < N; n += NT) {
    const int take = s.take[n];
    if (take > 0) {
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        u[r] = __fadd_rn(a.used[n * KR + r], __fmul_rn((float)take, req[r]));
        a.used[n * KR + r] = u[r];
      }
      int last_pt = -1;
      bool last_ok = true;
      for (int w = 0; w < W; ++w) {
        const uint32_t m = a.colmask[(size_t)w * N + n] & s.gm[w];
        a.colmask[(size_t)w * N + n] =
            narrow_word(m, w, ZC, s.pt, u, last_pt, last_ok);
      }
      atomicAdd(&S.ptake[a.node_pool[n]], take);
      atomicAdd(&S.sum, take);
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

  // activate the opened slots in parallel and emit the take_new row
  for (int n = tid; n < N; n += NT) {
    int tn = s.take[n];
    for (int p = 0; p < P; ++p) {
      const int m = S.m[p], st = S.start[p];
      if (m > 0 && n >= st && n < st + m) {
        const int kfull = S.kfull[p];
        const int k = (n - st == m - 1) ? S.taken[p] - wmul(m - 1, kfull)
                                        : kfull;
        float u[KR];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          u[r] = __fadd_rn(a.pool_daemon[p * KR + r],
                           __fmul_rn((float)k, req[r]));
          a.used[n * KR + r] = u[r];
        }
        int last_pt = -1;
        bool last_ok = true;
        for (int w = 0; w < W; ++w) {
          const uint32_t m0 = s.feas[w] & a.pool_bits[(size_t)p * W + w];
          a.colmask[(size_t)w * N + n] =
              narrow_word(m0, w, ZC, s.pt, u, last_pt, last_ok);
        }
        a.active[n] = 1;
        a.node_pool[n] = p;
        tn += k;
        break;
      }
    }
    a.take_new[(size_t)g * N + n] = (float)tn;
  }
  for (int d = tid; d < D; d += NT) a.dom_placed[(size_t)g * D + d] = 0.0f;
}

// ---------------------------------------------------------------------------
// the heavy step (ffd.py:589-818)

// per-domain state of one heavy step, in shared memory (TOPO only)
struct HeavyShared {
  int zcdom[MAXZC];           // domain of each grid slot
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

__device__ void heavy_step(const ScanArgs& a, ScanShared& S,
                           const ScanDyn& s, int g) {
  __shared__ HeavyShared H;
  const int tid = threadIdx.x;
  const int E = a.E, N = a.N, O = a.O, ZC = a.ZC, P = a.P, D = a.D,
            W = a.W;
  float req[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) req[r] = S.req[r];
  const int cnt = S.cnt, ncap = S.ncap, dsel = S.dsel;
  const int* col_dom = dsel == 1 ? a.col_zone : a.col_ct;
  const int* ex_dom = dsel == 1 ? a.exist_zone : a.exist_ct;
  int* node_dom = dsel == 1 ? a.node_zone : a.node_ct;
  const int dreal = dsel == 1 ? S.dreal_zone : S.dreal_ct;

  for (int d = tid; d < D; d += NT) {
    H.dbase[d] = a.group_dbase[(size_t)g * D + d];
    H.delig[d] = a.group_delig[(size_t)g * D + d] != 0;
    H.cape[d] = H.capn[d] = 0u;
    H.dexist[d] = H.dflight[d] = H.dnew[d] = 0u;
  }
  for (int z = tid; z < ZC; z += NT) H.zcdom[z] = col_dom[z];
  for (int i = tid; i < P * D; i += NT) s.kpd[i] = 0;
  __syncthreads();

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
  for (int n = tid; n < N; n += NT) {
    int slotmax[MAXZC];
    for (int z = 0; z < ZC; ++z) slotmax[z] = 0;
    const bool act = a.active[n] != 0;
    if (act) {
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r) u[r] = a.used[n * KR + r];
      int last_pt = -1, fit = 0;
      for (int w = 0; w < W; ++w) {
        uint32_t m = a.colmask[(size_t)w * N + n] & s.gm[w];
        while (m) {
          const int o = w * 32 + __ffs(m) - 1;
          m &= m - 1;
          const int pt = o / ZC;
          if (pt != last_pt) {
            last_pt = pt;
            float av[KR];
#pragma unroll
            for (int r = 0; r < KR; ++r)
              av[r] = __fsub_rn(s.pt[pt * KR + r], u[r]);
            fit = fit_count(av, req);
          }
          const int z = o - pt * ZC;
          slotmax[z] = max(slotmax[z], fit);
        }
      }
    }
    int best = 0, bd = 0, bcap = 0;
    for (int d = 0; d < D; ++d) {
      int capd = 0;
      for (int z = 0; z < ZC; ++z)
        if (H.zcdom[z] == d) capd = max(capd, slotmax[z]);
      capd = act ? min(capd, ncap) : 0;
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
  // the node to its domain
  for (int n = tid; n < N; n += NT) {
    const int take = s.take[n];
    if (take > 0) {
      const int bd = s.bd[n];
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        u[r] = __fadd_rn(a.used[n * KR + r], __fmul_rn((float)take, req[r]));
        a.used[n * KR + r] = u[r];
      }
      int last_pt = -1;
      bool last_ok = true;
      for (int w = 0; w < W; ++w) {
        const uint32_t m = a.colmask[(size_t)w * N + n] & s.gm[w];
        a.colmask[(size_t)w * N + n] =
            narrow_word(m, w, ZC, s.pt, u, last_pt, last_ok, H.zcdom, bd);
      }
      node_dom[n] = bd;
      atomicAdd(&S.ptake[a.node_pool[n]], take);
      atomicAdd(&H.dflight[bd], (unsigned)take);
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
    // activate the opened slots in parallel, each pinned to its domain
    const int na = H.pool_na, mtot = H.pool_m;
    for (int n = na + tid; n < na + mtot; n += NT) {
      int d = 0;
      while (d < D && !(H.md[d] > 0 && n >= H.startd[d] &&
                        n < H.startd[d] + H.md[d]))
        ++d;
      if (d == D) continue;
      const int kfull = s.kpd[p * D + d];
      const int k = (n == H.startd[d] + H.md[d] - 1)
                        ? H.takend[d] - wmul(H.md[d] - 1, kfull)
                        : kfull;
      float u[KR];
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        u[r] = __fadd_rn(a.pool_daemon[p * KR + r],
                         __fmul_rn((float)k, req[r]));
        a.used[n * KR + r] = u[r];
      }
      int last_pt = -1;
      bool last_ok = true;
      for (int w = 0; w < W; ++w) {
        const uint32_t m0 = s.feas[w] & a.pool_bits[(size_t)p * W + w];
        a.colmask[(size_t)w * N + n] =
            narrow_word(m0, w, ZC, s.pt, u, last_pt, last_ok, H.zcdom, d);
      }
      a.active[n] = 1;
      a.node_pool[n] = p;
      node_dom[n] = d;
      s.take[n] += k;
    }
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
// groups with dsel > 0.  SWEEP: the problem is a simulation of a shared
// snapshot, built in the prologue (kept existing rows, price-capped class
// masks).
template <bool TOPO, bool SWEEP>
__global__ void __launch_bounds__(NT, 1) scan_kernel(const ScanArgs a0) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ScanShared S;
  __shared__ ScanArgs A;
  const int tid = threadIdx.x;
  if (tid == 0) {
    A = a0;
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
  for (int i = tid; i < N * KR; i += NT) a.used[i] = 0.0f;
  for (size_t i = tid; i < (size_t)W * N; i += NT) a.colmask[i] = 0u;
  for (int i = tid; i < N; i += NT) {
    a.active[i] = 0;
    a.node_pool[i] = 0;
    a.node_zone[i] = -1;
    a.node_ct[i] = -1;
  }
  for (int i = tid; i < P * KR; i += NT) a.limits[i] = a.pool_limit[i];
  if (tid == 0) {
    S.na = 0;
    S.first = INT_MAX;
    S.sum = 0;
    S.dreal_zone = INT_MIN;
    S.dreal_ct = INT_MIN;
  }
  __syncthreads();
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
      S.row = row;
      S.first = INT_MAX;
      S.sum = 0;
    }
    for (int w = tid; w < W; w += NT) {
      const uint32_t m = a.mask_bits[(size_t)row * W + w];
      s.gm[w] = SWEEP ? (m & s.pm[w]) : m;
      s.feas[w] = 0u;
    }
    if (tid < P) {
      S.kfull[tid] = 0;
      S.any[tid] = 0;
      S.ptake[tid] = 0;
    }
    __syncthreads();
    if constexpr (TOPO) {
      if (S.dsel > 0)
        heavy_step(a, S, s, g);
      else
        light_step(a, S, s, g);
    } else {
      light_step(a, S, s, g);
    }
    __syncthreads();
  }
  if (a.K > 0) compact_take_exist(a, S);

  // -- final state ---------------------------------------------------------
  for (int i = tid; i < N * KR; i += NT) a.used_out[i] = a.used[i];
  for (int n = tid; n < N; n += NT) {
    a.pool_out[n] = (float)a.node_pool[n];
    a.zone_out[n] = (float)a.node_zone[n];
    a.ct_out[n] = (float)a.node_ct[n];
  }
  if (tid == 0) a.na_out[0] = (float)S.na;
}

// Plain-C entry point body for ctypes.  ptrs: SCAN_NPTRS device addresses in
// ScanArgs order (0 for what the instance does not read); dims: G, E, N, O,
// PT, ZC, P, D, W, B, X, K, total.  Returns 0, a CUDA error code
// (cudaGetLastError after the launch), or a negative argument error.
// Launches B blocks on `stream` and does not synchronise.
template <bool TOPO, bool SWEEP>
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
  if ((a.K > 0) != (a.te_dense != nullptr && a.te_head != nullptr) ||
      (a.K == 0 && a.E > 0 && !a.take_exist))
    return -2;
  const size_t smem = (size_t)a.PT * KR * sizeof(float) +
                      2 * (size_t)a.N * sizeof(int) +
                      2 * (size_t)a.W * sizeof(uint32_t) +
                      (TOPO ? ((size_t)a.N + (size_t)a.P * a.D) * sizeof(int)
                            : 0) +
                      (SWEEP ? (size_t)a.W * sizeof(uint32_t) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<TOPO, SWEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<TOPO, SWEEP><<<a.B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
