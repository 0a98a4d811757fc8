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
// ffd_scan_common.cuh's, `scan_kernel<false, true, false, false>` and
// `scan_kernel<true, true, false, false>`.
//
// What bounds it on the H100: latency, on two levels.  At BASELINE
// config #4 (E=2048 existing rows, N=8 node slots, O=3840 columns, G=1,
// B=64 a chunk) a block reads ~70 KB of snapshot (48 KB of existing rows,
// 15 KB of (pool,type) rows, the class rows and prices) and the catalog's
// columns once, and writes ~300 bytes: its bound is 0.0001 ms.  Its time
// is one simulation's dependency chain on one SM — the prologue, one
// scan step (the existing fill over 2048 rows, the column pass over 3840
// columns, the pool cascade), the compaction — and, around it, the host's
// launch: the wrapper's checks, scratch and argument array took 5-8x the
// kernel when each chunk built them anew.
//
// The design, each part aimed at one of those:
//   * the carry in shared memory (carry_layout) where the block fits
//     SWEEP_SMEM_BUDGET — at config #4 ~85 KB: the existing rows, their
//     caps, the dense take_exist rows, the column words, the slot ints and
//     the budgets — so each step reads it at shared-memory latency; shapes
//     that do not fit keep the device-memory carry (a route chosen by
//     shape, sweep_carry_fits, mirrored by solver/ffd.py);
//   * the snapshot staged by the copy engine: one thread issues
//     cp.async.bulk of the existing rows and the (pool,type) rows on an
//     mbarrier, and while they land the block builds its price-cap mask
//     (a warp a word: one coalesced load and a ballot) and reads its
//     exclusions; the keep multiply, __fmul_rn(x, 1 or 0), applies after
//     arrival, row by row;
//   * a cheaper launch: solver/ffd.py SweepLaunch builds the argument
//     array once a sweep and each chunk patches its rows (in turns, 0.03-0.05
//     ms a launch by CUDA events at config #4's and #4b's chunks, against
//     0.09-0.12 through _launch_scan with the same checks), and the entry
//     point raises the kernel's shared-memory attribute only at a new
//     peak.
// The block keeps K5's 1,024 threads and their 64-register cap, which
// spills a few dozen bytes: 512-thread blocks, with up to 128 registers
// and no spills, were slower at every chunk measured in turns, as each
// step's loops over 2,048 rows and 3,840 columns take twice the rounds;
// the spills are not what bounds it.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (profiler, a launch, in
// turns): config #4's light chunk 0.0219 ms at 1,024 threads against
// 0.0236 at 512, #4b's heavy chunk 0.0435 against 0.0475, where the
// design before this one (1,024 threads, the carry in device memory, the
// price mask bit by bit) took 0.0261 and 0.0485.
#include "ffd_scan_common.cuh"

// Plain-C entry points for ctypes, as ffd_batch_scan's: ptrs SCAN_NPTRS
// device addresses in ScanArgs order (mask_bits and exist_cap are the class
// tables [C, W] and [C, E]; the light lane passes 0 for the topology rows,
// group_ncap and group_whole); dims G, E, N, O, PT, ZC, P, D, W, B, X, K,
// total.
extern "C" int ffd_sweep_scan(const unsigned long long* ptrs, int nptrs,
                              const int* dims, int ndims, void* stream) {
  return scan_entry<false, true, false, false>(ptrs, nptrs, dims, ndims, stream);
}

extern "C" int ffd_sweep_topo_scan(const unsigned long long* ptrs,
                                   int nptrs, const int* dims, int ndims,
                                   void* stream) {
  return scan_entry<true, true, false, false>(ptrs, nptrs, dims, ndims, stream);
}
