// K2 ffd_pack: the post-scan result pack, one thread block per group.
//
// Replaces two post-scan programs of karpenter_tpu/solver/ffd.py
// `_solve_ffd_impl`:
//   * the sparse_n take_new compaction, ffd.py:1089-1109: the nonzero
//     entries of each dense [N] take_new row compacted into K (count,
//     index) pairs by prefix-sum rank (entries ranked K and beyond are
//     dropped), plus the per-group nonzero count that lets the host detect
//     an overflow;
//   * the explain=1 provenance aux, ffd.py:1113-1214: per group, the
//     catalog columns eliminated by fit / limit / topology / whole-node /
//     slots, judged against the scan's FINAL state, and the reason bitset.
//     Only light-branch problems reach this kernel (no group carries a
//     zone/capacity-type domain constraint), so the topology class is 0.
// Both land at the offsets of the flat result buffer `unpack` reads.
//
// What bounds it on the H100: per group it reads one [N] take_new row and
// one mask row and walks the PT (pool,type) blocks once; at the 50k
// headline (G=8, N=1024, PT=640, R=6) that is ~0.3 MB in and a few KB
// out, under 0.1 us of HBM, and ~0.1 M float ops.  G blocks of 256
// threads occupy 8 of 132 SMs: the launch itself is the cost.
//
// Design: the compaction is one block-wide exclusive scan of the nonzero
// flags per 256-slot chunk (the rank), a scatter of the entries ranked
// below K, and the chunk totals carried; the explain counts are a strided
// walk over the blocks with per-thread partial sums combined by
// shared-memory atomics.  Float parity as in ffd_common.cuh.
#include "ffd_common.cuh"

#define NT2 256

struct PackArgs {
  const float* take_new;      // [G, N] dense
  const uint32_t* mask_bits;  // [G, W]
  const float* group_req;     // [G, R]
  const int* group_whole;     // [G]
  const float* pt_alloc;      // [PT, R]
  const float* col_daemon;    // [O, R]
  const int* col_pool;        // [O]
  const float* pool_daemon;   // [P, R]
  const float* limits;        // [P, R] final budgets (K1's carry)
  const float* unsched;       // [G]  (flat)
  const float* na;            // [1]  (flat)
  float* sp_cnt;              // [G, K]
  float* sp_idx;              // [G, K]
  float* sp_nnz;              // [G]
  float* ex_counts;           // [G, 5]
  float* ex_bits;             // [G]
  int G, N, PT, ZC, P, W, K, explain;
};

#define PACK_NPTRS 16
#define PACK_NDIMS 8

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
  __shared__ unsigned s_warp[NT2 / 32];
  __shared__ int s_fit, s_lim, s_ok;

  if (a.K > 0) {
    const int K = a.K, N = a.N;
    for (int r = tid; r < K; r += NT2) {
      a.sp_cnt[(size_t)g * K + r] = 0.0f;
      a.sp_idx[(size_t)g * K + r] = 0.0f;
    }
    __syncthreads();
    unsigned carry = 0u;
    for (int base = 0; base < N; base += NT2) {
      const int n = base + tid;
      const float v = n < N ? a.take_new[(size_t)g * N + n] : 0.0f;
      const unsigned nz = v > 0.0f ? 1u : 0u;
      unsigned tot;
      const unsigned rank = block_excl_scan<NT2>(nz, s_warp, &tot) + carry;
      carry += tot;
      if (nz && rank < (unsigned)K) {
        a.sp_cnt[(size_t)g * K + rank] = v;
        a.sp_idx[(size_t)g * K + rank] = (float)n;
      }
    }
    if (tid == 0) a.sp_nnz[g] = (float)carry;
  }

  if (a.explain) {
    if (tid == 0) {
      s_fit = 0;
      s_lim = 0;
      s_ok = 0;
    }
    __syncthreads();
    float req[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) req[r] = a.group_req[g * KR + r];
    const uint32_t* row = a.mask_bits + (size_t)g * a.W;
    int fit = 0, lim = 0, ok = 0;
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
      if (!fits)
        fit += cpb;
      else if (!lim_ok)
        lim += cpb;
      else
        ok += cpb;
    }
    atomicAdd(&s_fit, fit);
    atomicAdd(&s_lim, lim);
    atomicAdd(&s_ok, ok);
    __syncthreads();
    if (tid == 0) {
      const bool stranded = a.unsched[g] > 0.0f;
      const bool whole = a.group_whole[g] != 0;
      const int counts[5] = {
          s_fit, s_lim, 0, (whole && stranded) ? s_ok : 0,
          (stranded && a.na[0] >= (float)a.N) ? 1 : 0};
      int bits = 0;
      for (int i = 0; i < 5; ++i) {
        a.ex_counts[(size_t)g * 5 + i] = (float)counts[i];
        if (counts[i] > 0) bits |= 1 << i;
      }
      a.ex_bits[g] = (float)bits;
    }
  }
}

// Plain-C entry point for ctypes.  ptrs: PACK_NPTRS device addresses in
// PackArgs order (unused outputs may be 0); dims: G, N, PT, ZC, P, W, K,
// explain.  Returns 0, a CUDA error code, or a negative argument error.
extern "C" int ffd_pack(const unsigned long long* ptrs, int nptrs,
                        const int* dims, int ndims, void* stream) {
  if (nptrs != PACK_NPTRS || ndims != PACK_NDIMS) return -1;
  PackArgs a;
  int i = 0;
  a.take_new = (const float*)ptrs[i++];
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
  a.sp_cnt = (float*)ptrs[i++];
  a.sp_idx = (float*)ptrs[i++];
  a.sp_nnz = (float*)ptrs[i++];
  a.ex_counts = (float*)ptrs[i++];
  a.ex_bits = (float*)ptrs[i++];
  a.G = dims[0];
  a.N = dims[1];
  a.PT = dims[2];
  a.ZC = dims[3];
  a.P = dims[4];
  a.W = dims[5];
  a.K = dims[6];
  a.explain = dims[7];
  if (a.G < 1 || a.N < 1 || a.ZC < 1 || a.K < 0 ||
      a.W != (a.PT * a.ZC + 31) / 32)
    return -2;
  if ((a.K > 0 && (!a.sp_cnt || !a.sp_idx || !a.sp_nnz)) ||
      (a.explain && (!a.ex_counts || !a.ex_bits)))
    return -3;
  pack_kernel<<<a.G, NT2, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
