// K3 ffd_topo_scan: the whole G-step FFD scan with the heavy branch, in one
// launch.
//
// Replaces karpenter_tpu/solver/ffd.py:210 `_solve_ffd_impl` with
// with_topology=True: per scan step the reference's
// `lax.cond(dsel > 0, heavy, light)` (ffd.py:1057) — the heavy branch
// (ffd.py:589-818, with `_water_fill` :147-196) for classes with a zone or
// capacity-type spread or anti-affinity constraint, the light branch
// (:460-587) for the rest.  The heavy step splits the class's pods into
// per-domain quotas by the water-fill against per-domain capacity
// estimates (existing nodes, in-flight nodes pinned one domain each, and
// new nodes per pool), fills existing and in-flight nodes per domain, opens
// new nodes per pool x domain under the shared pool budget, and pins every
// touched or opened node to its domain (node_zone/node_ct, the narrowed
// surviving columns).  It writes the flat result buffer of ffd.py:1258,
// dom_placed and the nodes' pins included.
//
// This is the `scan_kernel<true>` instance of ffd_scan_common.cuh, which
// holds the design notes.  What bounds it on the H100: latency, as K1 (see
// ffd_light_scan.cu): at config #3 (G=32, N=1024, PT=640, ZC=6, D=4, P=1)
// the inputs are ~0.3 MB and the float work a few million operations, both
// microseconds; the heavy step adds D block scans per fill and a serial
// pool x domain loop to the dependency chain.
#include "ffd_scan_common.cuh"

// Plain-C entry point for ctypes, as ffd_light_scan's: ptrs SCAN_NPTRS
// device addresses in ScanArgs order, dims G, E, N, O, PT, ZC, P, D, W.
// Also refuses D > MAXD and ZC > MAXZC.
extern "C" int ffd_topo_scan(const unsigned long long* ptrs, int nptrs,
                             const int* dims, int ndims, void* stream) {
  return scan_entry<true>(ptrs, nptrs, dims, ndims, stream);
}
