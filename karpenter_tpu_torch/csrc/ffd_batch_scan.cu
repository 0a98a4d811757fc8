// K5 ffd_batch_scan: the FFD scan of B stacked problems, one thread block
// per problem, in one launch.  One solve is the B=1 launch.
//
// Replaces karpenter_tpu/solver/ffd.py:1492 `_solve_ffd_batch_impl` (the
// `jax.vmap` of `_solve_ffd_impl` over the stacked problems of
// `_BATCH_AXES` :1483, the catalog shared) and, at B=1, the single-problem
// `_solve_ffd_impl` (ffd.py:210, scanned at :1062): per scan step the
// reference's `lax.cond(dsel > 0, heavy, light)` (:1057) — the heavy branch
// (:589-818, `_water_fill` :147-196) for classes with a zone or
// capacity-type spread or anti-affinity, the light branch (:460-587) for
// the rest — and, with sparse_k, the take_exist top-K compaction
// (:1068-1086).  It writes each problem's flat result row of ffd.py:1258.
//
// This is the `scan_kernel<true, false>` instance of ffd_scan_common.cuh,
// which holds the design notes.  What bounds it on the H100: latency, not
// bytes or arithmetic.  Each problem's inputs are a few hundred KB and its
// float work a few million operations at most (microseconds of HBM and of
// fp32), while its scan is a dependency chain, steps x pools (x domains)
// long, with block barriers inside each step.  The batch axis is the one
// source of parallelism across SMs: B blocks run on B SMs at once.
#include "ffd_scan_common.cuh"

// Plain-C entry point for ctypes.  ptrs: SCAN_NPTRS device addresses in
// ScanArgs order (the sweep's are 0); dims: G, E, N, O, PT, ZC, P, D, W, B,
// X (0), K, total.  Returns 0, a CUDA error code (cudaGetLastError after the
// launch), or a negative argument error.  Launches on `stream` and does not
// synchronise.
extern "C" int ffd_batch_scan(const unsigned long long* ptrs, int nptrs,
                              const int* dims, int ndims, void* stream) {
  return scan_entry<true, false>(ptrs, nptrs, dims, ndims, stream);
}
