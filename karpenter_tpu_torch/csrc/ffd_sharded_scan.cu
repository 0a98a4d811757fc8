// K7 ffd_sharded_scan: the column-sharded FFD scan of one problem, one
// thread-block cluster of S blocks, block r owning offering-column shard r.
//
// Replaces karpenter_tpu/solver/ffd.py:1372 `_solve_ffd_resident_impl`
// and :1446 `_solve_ffd_delta_resident_impl` under `shard_map`
// (karpenter_tpu/parallel/mesh.py:92 `_full_kernel_program`, :110
// `sharded_solve_ffd`, :203 `MeshExecutor._program`, :235
// `_delta_program`), with the row gather `mask_table[group_rows]`
// (ffd.py:1392, :1465) of the resident mask table that `_table_update`
// (mesh.py:303) fills.  The reference splits the offering-column axis O
// (and the (pool,type) axis PT in lockstep, on whole blocks) over S
// devices, keeps the group-scan state replicated, and combines the
// shards' local reductions through three kinds of collective: max (pmax:
// the winner selections of every step, `_axmax`/`_axany` ffd.py:93-113
// and the [P, D] `kfull_pd` table :667, :918), shard 0's leading block
// (all_gather(...)[0]: the grid-slot domain pattern :631, :893,
// :1161-1162) and an integer sum (psum: the explain=1 elimination counts
// :1202, the slot class joining after it).
//
// On one H100 the S "devices" are the S blocks of one thread-block
// cluster, scheduled together on neighbouring SMs, and each collective is
// an exchange through distributed shared memory behind a cluster barrier
// (`cluster_combine` in ffd_scan_common.cuh): one [N] or [2P] vector per
// light step, one [N, ZC] and one [P, D] per heavy step, one [N] per gang
// candidate and one [P, D] per gang step, in rounds of 2,048 values over
// double-buffered slots.  Max over integers and sums of integers are exact
// in any order, so the result equals the plain version bit for bit.  Each
// block reads only its own column shard of the catalog, its shard of the
// mask table (per-shard words, W = ceil(O_shard / 32), pad bits zero) and
// of the seed's column words; every block keeps a replica of the carry,
// and block 0 writes the flat row and the pool budgets into the caller's
// buffers (the others into a scratch replica of their own).
//
// These are the `scan_kernel<TOPO, false, GANG, SEED, XCLUSTER>` instances
// of ffd_scan_common.cuh, which holds the design notes; K5, K4 and K6 are
// its SHARDED = XNONE instances, and K7x (ffd_card_scan.cu) the XCARD
// ones: the same scan body with the card exchange as its transport.  What
// bounds it on the H100: latency, as K5 — a chain of G steps with block
// barriers inside each, now with one or two cluster barriers per step
// besides; the catalog work per block shrinks by S.
#include "ffd_scan_common.cuh"

// Plain-C entry points for ctypes.  ptrs: SCAN_NPTRS device addresses in
// ScanArgs order (the sweep's are 0; mask_bits is the resident mask table
// [S, C, W], mask_rows the [G] row ids, xslot the [S, N*ZC + 4G] scratch,
// ex_counts/ex_bits the explain=1 regions or 0, ex_map 0, row0 the
// caller's flat row and xrow the [S-1, total + P*R] scratch of the other
// blocks' rows and budgets); dims: G, E, N, O, PT, ZC, P, D, W (one
// shard's O, PT and W), B (1), X (0), K (0), total, A, C, S.  Returns 0,
// a CUDA error code (cudaLaunchKernelEx's, e.g. a cluster of S blocks the
// card cannot hold, or cudaGetLastError after the launch), or a negative
// argument error.  Launches one cluster of S blocks on `stream` and does
// not synchronise.

// light and heavy steps (the reference's resident program, with_gang 0)
extern "C" int ffd_sharded_scan(const unsigned long long* ptrs, int nptrs,
                                const int* dims, int ndims, void* stream) {
  return scan_entry<true, false, false, false, XCLUSTER>(ptrs, nptrs, dims,
                                                         ndims, stream);
}

// with the gang fill (with_gang 1)
extern "C" int ffd_sharded_gang_scan(const unsigned long long* ptrs,
                                     int nptrs, const int* dims, int ndims,
                                     void* stream) {
  return scan_entry<true, false, true, false, XCLUSTER>(ptrs, nptrs, dims,
                                                        ndims, stream);
}

// the seeded instance (the delta resident program: light only, from the
// seed arrays; seed_colmask is [S, A, W] per-shard words)
extern "C" int ffd_sharded_delta_scan(const unsigned long long* ptrs,
                                      int nptrs, const int* dims, int ndims,
                                      void* stream) {
  return scan_entry<false, false, false, true, XCLUSTER>(ptrs, nptrs, dims,
                                                         ndims, stream);
}

// How many clusters of one launch's shape the card holds at once
// (cudaOccupancyMaxActiveClusters): `dims` as the entry points take them
// (only N, PT, ZC, P, D, W and S matter), `ptrs` unused, and in the stream's
// place the instance (0 ffd_sharded_scan, 1 the gang instance, 2 the
// seeded one).  Returns the count (>= 0), -2 for dims out of range, or
// -1000 - a CUDA error code.  Launches nothing.
extern "C" int ffd_sharded_occupancy(const unsigned long long* ptrs,
                                     int nptrs, const int* dims, int ndims,
                                     void* variant) {
  (void)ptrs;
  (void)nptrs;
  if (ndims != SCAN_NDIMS) return -2;
  ScanArgs a = {};
  a.N = dims[2];
  a.PT = dims[4];
  a.ZC = dims[5];
  a.P = dims[6];
  a.D = dims[7];
  a.W = dims[8];
  a.S = dims[15];
  if (a.N < 1 || a.PT < 0 || a.ZC < 1 || a.ZC > MAXZC || a.P < 1 ||
      a.P > MAXP || a.D < 1 || a.W < 0 || a.S < 1 || a.S > 16)
    return -2;
  switch ((int)(size_t)variant) {
    case 0: return sharded_occupancy<true, false, false>(a);
    case 1: return sharded_occupancy<true, true, false>(a);
    case 2: return sharded_occupancy<false, false, true>(a);
    default: return -2;
  }
}
