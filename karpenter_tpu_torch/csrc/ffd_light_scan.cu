// K1 ffd_light_scan: the whole G-step light FFD scan in one launch.
//
// Replaces karpenter_tpu/solver/ffd.py:210 `_solve_ffd_impl`, light branch:
// the scan `step` -> `light` (ffd.py:456-587) with `_fit_count` :116,
// `_prefix_fill` :125, `_atomic_fill` :134, `_clamp_pool_limits` :442 and
// `pt_any`/`pt_expand` :381-390, scanned at :1062; and the packed-mask
// expansion `_expand_packed_mask` :199, which disappears here because the
// kernel reads the group mask as bits.  It writes the dense result rows
// straight into the flat result buffer of `ffd.py:1258`.
//
// What bounds it on the H100: not bytes and not arithmetic.  At the 50k
// headline (G=8 groups, N=1024 node slots, PT=640 (pool,type) blocks of
// ZC=6 columns, O=3840, R=6) the inputs are ~0.2 MB (catalog rows, eight
// 480-byte mask rows) and the outputs ~0.07 MB, and the dense algorithm
// of the reference does ~N*PT*R*3 = 12M float ops per step: both bounds
// are microseconds (0.1 us of HBM, ~1.5 us of fp32 over the whole scan).
// The scan is a dependency chain, steps x pools long, with block-wide
// barriers inside each step: its time is latency, on one SM.
//
// Design: one thread block of 1024 threads per problem.  Thread n owns
// node slot n (a strided loop when N > 1024).  The carry lives in device
// memory: the surviving-column mask as u32 bit-words in [W, N] layout
// (neighbouring threads touch neighbouring words), used [N, R], the pool
// budgets [P, R], the existing-node remainders [E, R].  Per step, every
// thread works on its own node in parallel (the [N, PT] fit and the
// per-node max over eligible blocks, the colmask narrowing), block scans
// give the node-axis cumsums (`_prefix_fill`, `_clamp_pool_limits`),
// shared-memory atomics the per-pool maxima, and the short per-pool
// new-node cascade runs on thread 0 before the slots it opens are
// activated in parallel.  Work is skipped where the reference's is a
// provable no-op: the fit runs only over blocks that hold a surviving,
// admitted column, and the ok-block narrowing only on nodes that took pods
// (an untouched node's mask is already narrowed against its unchanged
// `used`).  (pool, type) rows sit in shared memory.
//
// Float parity: every operation is the reference's, in its order, rounded
// to nearest (ffd_common.cuh).  Pool-limit and pool-take arithmetic is on
// integer-valued float32 terms, exact below 2^24 in any order.
#include "ffd_common.cuh"

#include <limits.h>

#define NT 1024
#define MAXP 64

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
  int G, E, N, O, PT, ZC, P, D, W;
};

#define SCAN_NPTRS 30
#define SCAN_NDIMS 9

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
// last_pt/last_ok carry the verdict of a block across a word boundary.
__device__ __forceinline__ uint32_t narrow_word(uint32_t m, int w, int ZC,
                                                const float* s_pt,
                                                const float* u,
                                                int& last_pt, bool& last_ok) {
  uint32_t keep = m;
  while (m) {
    const int b = __ffs(m) - 1;
    m &= m - 1;
    const int pt = (w * 32 + b) / ZC;
    if (pt != last_pt) {
      last_pt = pt;
      last_ok = all_fits2(&s_pt[pt * KR], u);
    }
    if (!last_ok) keep &= ~(1u << b);
  }
  return keep;
}

__global__ void __launch_bounds__(NT, 1) light_scan_kernel(const ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int G = a.G, E = a.E, N = a.N, O = a.O, PT = a.PT, ZC = a.ZC;
  const int P = a.P, D = a.D, W = a.W;
  float* s_pt = reinterpret_cast<float*>(smem);             // [PT, R]
  int* s_cap = reinterpret_cast<int*>(s_pt + PT * KR);       // [N]
  int* s_take = s_cap + N;                                   // [N]
  uint32_t* s_gm = reinterpret_cast<uint32_t*>(s_take + N);  // [W]
  uint32_t* s_feas = s_gm + W;                               // [W]

  __shared__ unsigned s_warp[NT / 32];
  __shared__ float s_req[KR];
  __shared__ int s_cnt, s_ncap, s_whole, s_first, s_sum, s_na, s_crem;
  __shared__ int s_kfull[MAXP], s_any[MAXP], s_ptake[MAXP], s_limcap[MAXP];
  __shared__ int s_start[MAXP], s_m[MAXP], s_taken[MAXP];

  // -- initial carry ------------------------------------------------------
  for (int i = tid; i < PT * KR; i += NT) s_pt[i] = a.pt_alloc[i];
  for (int i = tid; i < E * KR; i += NT) a.exist_rem[i] = a.exist_remaining[i];
  for (int i = tid; i < N * KR; i += NT) a.used[i] = 0.0f;
  for (size_t i = tid; i < (size_t)W * N; i += NT) a.colmask[i] = 0u;
  for (int i = tid; i < N; i += NT) {
    a.active[i] = 0;
    a.node_pool[i] = 0;
  }
  for (int i = tid; i < P * KR; i += NT) a.limits[i] = a.pool_limit[i];
  if (tid == 0) s_na = 0;
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    if (tid < KR) s_req[tid] = a.group_req[g * KR + tid];
    if (tid == 0) {
      s_cnt = a.group_count[g];
      s_ncap = a.group_ncap[g];
      s_whole = a.group_whole[g] != 0;
      s_first = INT_MAX;
      s_sum = 0;
    }
    for (int w = tid; w < W; w += NT) {
      s_gm[w] = a.mask_bits[(size_t)g * W + w];
      s_feas[w] = 0u;
    }
    if (tid < P) {
      s_kfull[tid] = 0;
      s_any[tid] = 0;
      s_ptake[tid] = 0;
    }
    __syncthreads();
    float req[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) req[r] = s_req[r];
    const int cnt = s_cnt, ncap = s_ncap;
    const bool whole = s_whole != 0;

    // -- 1. existing nodes ------------------------------------------------
    int c1 = cnt;
    if (E > 0) {
      for (int e = tid; e < E; e += NT) {
        const int cap = min(fit_count(&a.exist_rem[e * KR], req),
                            a.exist_cap[(size_t)g * E + e]);
        a.cap_e[e] = cap;
        if (whole && cap >= cnt) atomicMin(&s_first, e);
      }
      __syncthreads();
      const int first = s_first;
      unsigned carry = 0u;
      for (int base = 0; base < E; base += NT) {
        const int e = base + tid;
        const int cap = e < E ? a.cap_e[e] : 0;
        unsigned tot;
        const unsigned before =
            block_excl_scan<NT>((unsigned)cap, s_warp, &tot) + carry;
        carry += tot;
        if (e < E) {
          // whole-node groups: ALL-or-nothing on the first slot that
          // holds the entire group (_atomic_fill)
          const int take = whole ? ((e == first && cnt > 0) ? cnt : 0)
                                 : prefix_take(cap, cnt, before);
          a.take_exist[(size_t)g * E + e] = (float)take;
          if (take != 0) {
#pragma unroll
            for (int r = 0; r < KR; ++r)
              a.exist_rem[e * KR + r] = __fsub_rn(
                  a.exist_rem[e * KR + r], __fmul_rn((float)take, req[r]));
            atomicAdd(&s_sum, take);
          }
        }
      }
      __syncthreads();
      c1 = cnt - s_sum;
      __syncthreads();
      if (tid == 0) {
        s_sum = 0;
        s_first = INT_MAX;
      }
    }

    // -- 2. in-flight nodes -----------------------------------------------
    // per-node capacity: the best fit over (pool,type) blocks that still
    // hold a surviving column the group admits, capped by the group's
    // per-node cap; inactive slots hold nothing
    for (int n = tid; n < N; n += NT) {
      int cap = 0;
      if (a.active[n]) {
        float u[KR];
#pragma unroll
        for (int r = 0; r < KR; ++r) u[r] = a.used[n * KR + r];
        int best = 0, last_pt = -1;
        for (int w = 0; w < W; ++w) {
          uint32_t m = a.colmask[(size_t)w * N + n] & s_gm[w];
          while (m) {
            const int o = w * 32 + __ffs(m) - 1;
            m &= m - 1;
            const int pt = o / ZC;
            if (pt != last_pt) {
              last_pt = pt;
              float av[KR];
#pragma unroll
              for (int r = 0; r < KR; ++r)
                av[r] = __fsub_rn(s_pt[pt * KR + r], u[r]);
              best = max(best, fit_count(av, req));
            }
          }
        }
        cap = min(best, ncap);
      }
      s_cap[n] = cap;
    }
    if (tid < P) s_limcap[tid] = fit_count(&a.limits[tid * KR], req);
    __syncthreads();

    // pool limits are collective: each node's cap is clamped by what its
    // pool's budget leaves after lower-index nodes of the same pool take
    // theirs; whole-node groups clamp against the full budget instead
    if (whole) {
      for (int n = tid; n < N; n += NT)
        s_cap[n] = min(s_cap[n], s_limcap[a.node_pool[n]]);
    } else {
      for (int p = 0; p < P; ++p) {
        unsigned carry = 0u;
        for (int base = 0; base < N; base += NT) {
          const int n = base + tid;
          const bool mine = n < N && a.node_pool[n] == p;
          const int v = mine ? s_cap[n] : 0;
          unsigned tot;
          const unsigned before =
              block_excl_scan<NT>((unsigned)v, s_warp, &tot) + carry;
          carry += tot;
          if (mine) s_cap[n] = min(v, max(wsub(s_limcap[p], before), 0));
        }
      }
    }
    __syncthreads();

    if (whole) {
      for (int n = tid; n < N; n += NT)
        if (s_cap[n] >= c1) atomicMin(&s_first, n);
      __syncthreads();
      const int first = s_first;
      for (int n = tid; n < N; n += NT)
        s_take[n] = (n == first && c1 > 0) ? c1 : 0;
    } else {
      unsigned carry = 0u;
      for (int base = 0; base < N; base += NT) {
        const int n = base + tid;
        const int cap = n < N ? s_cap[n] : 0;
        unsigned tot;
        const unsigned before =
            block_excl_scan<NT>((unsigned)cap, s_warp, &tot) + carry;
        carry += tot;
        if (n < N) s_take[n] = prefix_take(cap, c1, before);
      }
    }

    // touched nodes: charge used, AND the group's mask into the surviving
    // columns, drop blocks the new `used` no longer fits
    for (int n = tid; n < N; n += NT) {
      const int take = s_take[n];
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
          const uint32_t m = a.colmask[(size_t)w * N + n] & s_gm[w];
          a.colmask[(size_t)w * N + n] =
              narrow_word(m, w, ZC, s_pt, u, last_pt, last_ok);
        }
        atomicAdd(&s_ptake[a.node_pool[n]], take);
        atomicAdd(&s_sum, take);
      }
    }
    __syncthreads();
    if (tid == 0) {
      // segment_sum of integer takes: exact in float32 below 2^24
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < KR; ++r)
          a.limits[p * KR + r] = __fsub_rn(
              a.limits[p * KR + r], __fmul_rn((float)s_ptake[p], req[r]));
      s_crem = c1 - s_sum;
    }

    // -- 3. open new nodes ------------------------------------------------
    // per-column pods-per-node of an empty node, the feasible columns as
    // bits, and each pool's best column (k_full) and "any column" flag
    for (int o = tid; o < O; o += NT) {
      if ((s_gm[o >> 5] >> (o & 31)) & 1u) {
        float av[KR];
#pragma unroll
        for (int r = 0; r < KR; ++r)
          av[r] = __fsub_rn(a.col_alloc[o * KR + r], a.col_daemon[o * KR + r]);
        const int pc = min(fit_count(av, req), ncap);
        if (pc >= 1) {
          atomicOr(&s_feas[o >> 5], 1u << (o & 31));
          const int p = a.col_pool[o];
          atomicMax(&s_kfull[p], pc);
          s_any[p] = 1;
        }
      }
    }
    __syncthreads();

    // the per-pool cascade, in pool priority order, on one thread
    if (tid == 0) {
      int c_rem = s_crem, na = s_na;
      for (int p = 0; p < P; ++p) {
        float* lim = a.limits + p * KR;
        const float* pd = a.pool_daemon + p * KR;
        const int k_full = s_kfull[p];
        bool can = s_any[p] && all_fits3(lim, pd, req) && c_rem > 0 &&
                   k_full > 0;
        float tmp[KR];
        if (whole) {
          // the whole remainder must land on one node of one pool
#pragma unroll
          for (int r = 0; r < KR; ++r) tmp[r] = __fsub_rn(lim[r], pd[r]);
          can = can && k_full >= c_rem && fit_count(tmp, req) >= c_rem;
        }
        const int kf = max(k_full, 1);
        // budget-exact node count: affordable pods first, then the
        // per-node daemon charge for the implied node count
        int t = min(c_rem, fit_count(lim, req));
        const int m_t = ceil_div(t, kf);
#pragma unroll
        for (int r = 0; r < KR; ++r)
          tmp[r] = __fsub_rn(lim[r], __fmul_rn((float)m_t, pd[r]));
        t = min(t, fit_count(tmp, req));
        const int m_need = can ? ceil_div(t, kf) : 0;
        const int m = min(m_need, N - na);
        const int taken = min(t, wmul(m, k_full));
        s_start[p] = na;
        s_m[p] = m;
        s_taken[p] = taken;
#pragma unroll
        for (int r = 0; r < KR; ++r)
          lim[r] = __fadd_rn(lim[r],
                             -__fadd_rn(__fmul_rn((float)m, pd[r]),
                                        __fmul_rn((float)taken, req[r])));
        na += m;
        c_rem -= taken;
      }
      s_na = na;
      a.unsched[g] = (float)c_rem;
    }
    __syncthreads();

    // activate the opened slots in parallel and emit the take_new row
    for (int n = tid; n < N; n += NT) {
      int tn = s_take[n];
      for (int p = 0; p < P; ++p) {
        const int m = s_m[p], st = s_start[p];
        if (m > 0 && n >= st && n < st + m) {
          const int kfull = s_kfull[p];
          const int k = (n - st == m - 1) ? s_taken[p] - wmul(m - 1, kfull)
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
            const uint32_t m0 = s_feas[w] & a.pool_bits[(size_t)p * W + w];
            a.colmask[(size_t)w * N + n] =
                narrow_word(m0, w, ZC, s_pt, u, last_pt, last_ok);
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
    __syncthreads();
  }

  // -- final state ---------------------------------------------------------
  for (int i = tid; i < N * KR; i += NT) a.used_out[i] = a.used[i];
  for (int n = tid; n < N; n += NT) {
    a.pool_out[n] = (float)a.node_pool[n];
    a.zone_out[n] = -1.0f;
    a.ct_out[n] = -1.0f;
  }
  if (tid == 0) a.na_out[0] = (float)s_na;
}

// Plain-C entry point for ctypes.  ptrs: SCAN_NPTRS device addresses in
// ScanArgs order; dims: G, E, N, O, PT, ZC, P, D, W.  Returns 0, a CUDA
// error code (cudaGetLastError after the launch), or a negative argument
// error.  Launches on `stream` and does not synchronise.
extern "C" int ffd_light_scan(const unsigned long long* ptrs, int nptrs,
                              const int* dims, int ndims, void* stream) {
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
  a.G = dims[0];
  a.E = dims[1];
  a.N = dims[2];
  a.O = dims[3];
  a.PT = dims[4];
  a.ZC = dims[5];
  a.P = dims[6];
  a.D = dims[7];
  a.W = dims[8];
  if (a.P < 1 || a.P > MAXP || a.ZC < 1 || a.N < 1 ||
      a.O != a.PT * a.ZC || a.W != (a.O + 31) / 32)
    return -2;
  const size_t smem = (size_t)a.PT * KR * sizeof(float) +
                      2 * (size_t)a.N * sizeof(int) +
                      2 * (size_t)a.W * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      light_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  light_scan_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
