// K2 ffd_pack: the post-scan explain counts, one thread block per group.
//
// Replaces the explain=1 provenance aux of karpenter_tpu/solver/ffd.py
// `_solve_ffd_impl`, ffd.py:1113-1214: per group, the catalog columns
// eliminated by fit / limit / topology / whole-node / slots, judged against
// the scan's FINAL state, and the reason bitset.  The topology class
// (ffd.py:1141-1175) counts, for a group with a domain constraint, the
// admitted columns of fitting, fundable blocks whose domain is ineligible
// or at the skew ceiling after the group's own placements (dom_placed +
// base counts, minDomains as in the water-fill); a column's domain is its
// grid slot's, col_zone[:zc] or col_ct[:zc].  The counts land at the
// offsets of the flat result buffer `unpack` reads.  (The reference's
// take_new top-K compaction, ffd.py:1089-1109, saves device-to-host bytes
// on a TPU link; on the card it bought nothing, and the port keeps the
// dense rows the scan kernels write.)
//
// What bounds it on the H100: per group it reads one mask row, walks the PT
// (pool,type) blocks once and reads a few per-group rows; at the 50k
// headline (G=8, PT=640, R=6) that is ~0.1 MB in and a few hundred bytes
// out, under 0.1 us of HBM, and ~0.1 M float ops.  G blocks of 256 threads
// occupy 8 of 132 SMs: the launch itself is the cost.
//
// Design: a strided walk over the blocks with per-thread partial sums
// combined by shared-memory atomics; the blocked grid slots are a [ZC]
// flag row computed once per group.  Float parity as in ffd_common.cuh.
#include "ffd_common.cuh"

#define NT2 256
#define PACK_MAXZC 64

struct PackArgs {
  const uint32_t* mask_bits;  // [G, W]
  const float* group_req;     // [G, R]
  const int* group_whole;     // [G]
  const float* pt_alloc;      // [PT, R]
  const float* col_daemon;    // [O, R]
  const int* col_pool;        // [O]
  const float* pool_daemon;   // [P, R]
  const float* limits;        // [P, R] final budgets (the scan's carry)
  const float* unsched;       // [G]  (flat)
  const float* na;            // [1]  (flat)
  float* ex_counts;           // [G, 5]
  float* ex_bits;             // [G]
  const float* dom_placed;    // [G, D] (flat)
  const int* group_dsel;      // [G]
  const int* group_dbase;     // [G, D]
  const int* group_skew;      // [G]
  const int* group_mindom;    // [G]
  const int* group_delig;     // [G, D] 0/1
  const int* col_zone;        // [O] (the first ZC: the grid's slot pattern)
  const int* col_ct;          // [O]
  int G, N, PT, ZC, P, W, D;
};

#define PACK_NPTRS 20
#define PACK_NDIMS 7

// number of set bits of `row` in columns [lo, lo + n)
__device__ __forceinline__ int range_popc(const uint32_t* row, int lo, int n) {
  int c = 0;
  for (int o = lo; o < lo + n;) {
    const int w = o >> 5, b = o & 31;
    const int take = min(32 - b, lo + n - o);
    const uint32_t m =
        take == 32 ? 0xffffffffu : (((1u << take) - 1u) << b);
    c += __popc(row[w] & m);
    o += take;
  }
  return c;
}

__global__ void __launch_bounds__(NT2) pack_kernel(const PackArgs a) {
  const int g = blockIdx.x, tid = threadIdx.x;
  __shared__ int s_fit, s_lim, s_topo, s_ok;
  __shared__ int s_blocked[PACK_MAXZC];

  const int dsel = a.group_dsel[g];
  if (tid == 0) {
    s_fit = 0;
    s_lim = 0;
    s_topo = 0;
    s_ok = 0;
    if (dsel > 0) {
      // the skew ceiling after the group's own placements
      const int D = a.D;
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
      const int* slot_dom = dsel == 1 ? a.col_zone : a.col_ct;
      for (int z = 0; z < a.ZC; ++z) {
        const int d = min(max(slot_dom[z], 0), D - 1);
        const int f = (int)((unsigned)base[d] + (unsigned)(int)placed[d]);
        s_blocked[z] = !elig[d] || f >= ceiling;
      }
    }
  }
  __syncthreads();
  float req[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) req[r] = a.group_req[g * KR + r];
  const uint32_t* row = a.mask_bits + (size_t)g * a.W;
  int fit = 0, lim = 0, topo = 0, ok = 0;
  for (int pt = tid; pt < a.PT; pt += NT2) {
    const int lo = pt * a.ZC;
    const int cpb = range_popc(row, lo, a.ZC);  // admitted columns
    if (!cpb) continue;
    // fit: one pod cannot land on an EMPTY node of the block
    const bool fits = all_fits3(&a.pt_alloc[pt * KR],
                                &a.col_daemon[(size_t)lo * KR], req);
    // limit: the pool's final budget cannot fund one more pod plus the
    // per-node daemon charge
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
        for (int z = 0; z < a.ZC; ++z)
          if (s_blocked[z])
            topo += (row[(lo + z) >> 5] >> ((lo + z) & 31)) & 1u;
    }
  }
  atomicAdd(&s_fit, fit);
  atomicAdd(&s_lim, lim);
  atomicAdd(&s_topo, topo);
  atomicAdd(&s_ok, ok);
  __syncthreads();
  if (tid == 0) {
    const bool stranded = a.unsched[g] > 0.0f;
    const bool whole = a.group_whole[g] != 0;
    const int counts[5] = {
        s_fit, s_lim, s_topo, (whole && stranded) ? s_ok : 0,
        (stranded && a.na[0] >= (float)a.N) ? 1 : 0};
    int bits = 0;
    for (int i = 0; i < 5; ++i) {
      a.ex_counts[(size_t)g * 5 + i] = (float)counts[i];
      if (counts[i] > 0) bits |= 1 << i;
    }
    a.ex_bits[g] = (float)bits;
  }
}

// Plain-C entry point for ctypes.  ptrs: PACK_NPTRS device addresses in
// PackArgs order; dims: G, N, PT, ZC, P, W, D.  Returns 0, a CUDA error
// code, or a negative argument error.
extern "C" int ffd_pack(const unsigned long long* ptrs, int nptrs,
                        const int* dims, int ndims, void* stream) {
  if (nptrs != PACK_NPTRS || ndims != PACK_NDIMS) return -1;
  PackArgs a;
  int i = 0;
  a.mask_bits = (const uint32_t*)ptrs[i++];
  a.group_req = (const float*)ptrs[i++];
  a.group_whole = (const int*)ptrs[i++];
  a.pt_alloc = (const float*)ptrs[i++];
  a.col_daemon = (const float*)ptrs[i++];
  a.col_pool = (const int*)ptrs[i++];
  a.pool_daemon = (const float*)ptrs[i++];
  a.limits = (const float*)ptrs[i++];
  a.unsched = (const float*)ptrs[i++];
  a.na = (const float*)ptrs[i++];
  a.ex_counts = (float*)ptrs[i++];
  a.ex_bits = (float*)ptrs[i++];
  a.dom_placed = (const float*)ptrs[i++];
  a.group_dsel = (const int*)ptrs[i++];
  a.group_dbase = (const int*)ptrs[i++];
  a.group_skew = (const int*)ptrs[i++];
  a.group_mindom = (const int*)ptrs[i++];
  a.group_delig = (const int*)ptrs[i++];
  a.col_zone = (const int*)ptrs[i++];
  a.col_ct = (const int*)ptrs[i++];
  a.G = dims[0];
  a.N = dims[1];
  a.PT = dims[2];
  a.ZC = dims[3];
  a.P = dims[4];
  a.W = dims[5];
  a.D = dims[6];
  if (a.G < 1 || a.N < 1 || a.ZC < 1 || a.D < 1 || a.ZC > PACK_MAXZC ||
      a.W != (a.PT * a.ZC + 31) / 32)
    return -2;
  for (int k = 0; k < PACK_NPTRS; ++k)
    if (!ptrs[k]) return -3;
  pack_kernel<<<a.G, NT2, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
