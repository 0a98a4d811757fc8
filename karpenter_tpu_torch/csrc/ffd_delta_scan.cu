// K6 ffd_delta_scan: the delta path's seeded FFD scan, one problem, one
// thread block.
//
// Replaces karpenter_tpu/solver/ffd.py:1403 `_solve_ffd_delta_impl` (the
// jitted `solve_ffd_delta`): `_solve_ffd_impl` (ffd.py:210) with the
// seeded start of ffd.py:406-427 and with_topology False.  The problem is
// the restricted SUFFIX of a pass (the changed pod classes only, or one
// chunk of the speculative chunk chain); the seed is the state the
// unchanged prefix left: per node slot its used vector, pool and active
// flag, and for the first A slots the surviving-column words, all
// replayed on the host (karpenter_tpu_torch/solver/delta.py) with the
// kernel's own float32 arithmetic.  The scan then runs the light step only
// (the delta and chunk paths are topology-, gang- and priority-free by
// contract), writes a dense take_exist row and no priority witness; K2
// adds the explain counts after it.
//
// This is the `scan_kernel<false, false, false, true>` instance of
// ffd_scan_common.cuh, which holds the design notes: the seed flag only
// adds the prologue that copies the seed into the carry (used [N, R] and
// pool/active [N] as given, the seed's [A, W] column words as the
// carry's first A rows with every slot past A cleared, the active count
// the number of seeded slots, node zone and capacity-type pins left at
// -1, exist_remaining taken as given).  What bounds it on the H100 is what
// bounds K5: latency, the step chain with block barriers inside each step,
// on one SM.
#include "ffd_scan_common.cuh"

// Plain-C entry point for ctypes.  ptrs: SCAN_NPTRS device addresses in
// ScanArgs order (the topology, sweep, gang and priority ones are 0; the
// four seed arrays last); dims: G, E, N, O, PT, ZC, P, D, W, B (1), X (0),
// K (0), total, A.  Returns 0, a CUDA error code (cudaGetLastError after
// the launch), or a negative argument error.  Launches on `stream` and
// does not synchronise.
extern "C" int ffd_delta_scan(const unsigned long long* ptrs, int nptrs,
                              const int* dims, int ndims, void* stream) {
  return scan_entry<false, false, false, true>(ptrs, nptrs, dims, ndims,
                                               stream);
}
