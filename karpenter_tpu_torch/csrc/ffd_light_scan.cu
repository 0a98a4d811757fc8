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
// This is the topology-free instance of the scan kernel in
// ffd_scan_common.cuh (`scan_kernel<false>`): every group takes the light
// step, and node_zone/node_ct stay -1, as the reference's with_topology=
// False program leaves them.
//
// What bounds it on the H100: not bytes and not arithmetic.  At the 50k
// headline (G=8 groups, N=1024 node slots, PT=640 (pool,type) blocks of
// ZC=6 columns, O=3840, R=6) the inputs are ~0.2 MB (catalog rows, eight
// 480-byte mask rows) and the outputs ~0.07 MB, and the dense algorithm
// of the reference does ~N*PT*R*3 = 12M float ops per step: both bounds
// are microseconds (0.1 us of HBM, ~1.5 us of fp32 over the whole scan).
// The scan is a dependency chain, steps x pools long, with block-wide
// barriers inside each step: its time is latency, on one SM.  The design
// (one block of 1024 threads, thread n owns node slot n) is described in
// ffd_scan_common.cuh.
#include "ffd_scan_common.cuh"

// Plain-C entry point for ctypes.  ptrs: SCAN_NPTRS device addresses in
// ScanArgs order (the topology arguments are not read); dims: G, E, N, O,
// PT, ZC, P, D, W.  Returns 0, a CUDA error code (cudaGetLastError after
// the launch), or a negative argument error.  Launches on `stream` and does
// not synchronise.
extern "C" int ffd_light_scan(const unsigned long long* ptrs, int nptrs,
                              const int* dims, int ndims, void* stream) {
  return scan_entry<false>(ptrs, nptrs, dims, ndims, stream);
}
