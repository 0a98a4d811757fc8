// K4 ffd_sweep_scan / ffd_sweep_topo_scan: the consolidation sweep, B
// simulations of one cluster snapshot, one thread block per simulation, in
// one launch.
//
// Replaces karpenter_tpu/solver/ffd.py:1531 `_solve_ffd_sweep_impl` (the
// light lane) and :1610 `_solve_ffd_sweep_topo_impl` (the heavy lane): the
// `jax.vmap` over simulations of a per-simulation prologue — keep =
// all(arange(E) != excl), exist_remaining * keep, class_cap[gcls] * keep,
// class_mask[gcls] & (col_price < pcap) — and `_solve_ffd_impl` with
// with_topology False (light lane: no node caps, no domains) or True (heavy
// lane: per-simulation topology rows, `lax.cond(dsel > 0, heavy, light)`),
// with the take_exist top-K compaction (:1068-1086) when sparse_k > 0.
//
// The snapshot (per-class column bits and node caps, the existing nodes'
// remainders and domains, the column prices) is read by every block; only
// the simulations' rows are per block.  Each block builds its price-cap
// column mask once in its prologue and ANDs it into every class row it
// reads; the kept-row test runs on the fly against the simulation's
// exclusions (at most 8) in shared memory.  The scan itself is
// ffd_scan_common.cuh's, `scan_kernel<false, true>` and
// `scan_kernel<true, true>`.
//
// What bounds it on the H100: latency, as K5 (ffd_batch_scan.cu).  At
// BASELINE config #4 (E=2048 existing rows, N=8 node slots, O=3840
// columns, G=1, B=64 a chunk) a block reads the 48 KB of existing rows and
// a few KB of class rows and writes ~300 bytes; its chain is one group's
// existing fill (two block scans over 2048 rows), the column walk and the
// pool cascade.
#include "ffd_scan_common.cuh"

// Plain-C entry points for ctypes, as ffd_batch_scan's: ptrs SCAN_NPTRS
// device addresses in ScanArgs order (mask_bits and exist_cap are the class
// tables [C, W] and [C, E]; the light lane passes 0 for the topology rows,
// group_ncap and group_whole); dims G, E, N, O, PT, ZC, P, D, W, B, X, K,
// total.
extern "C" int ffd_sweep_scan(const unsigned long long* ptrs, int nptrs,
                              const int* dims, int ndims, void* stream) {
  return scan_entry<false, true>(ptrs, nptrs, dims, ndims, stream);
}

extern "C" int ffd_sweep_topo_scan(const unsigned long long* ptrs,
                                   int nptrs, const int* dims, int ndims,
                                   void* stream) {
  return scan_entry<true, true>(ptrs, nptrs, dims, ndims, stream);
}
