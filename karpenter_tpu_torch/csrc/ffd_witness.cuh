// The priority inversion witness, one group at a time, for the scans'
// steps (ffd_scan_common.cuh `witness_put`) and for a host shim built with
// g++ (tests/test_torch_witness.py).
//
// Replaces karpenter_tpu/solver/ffd.py:1238-1257, which judges it after
// the scan from the strand outputs: group g is flagged when it placed a
// pod (count - unsched > 0) and an earlier group of strictly higher
// priority stranded (prio < before, `before` the exclusive running max of
// the stranded groups' priorities, from -(2^31) + 1).  Every term of group
// g is known once its step has its strand count, so the thread that
// writes unsched[g] writes the flag and advances `before` then, in group
// order.  `before` is replicated group-axis state: under a column-sharded
// scan each rank keeps its own, with no exchange.  Integers only; the
// reference's int32 difference wraps modulo 2^32, as the unsigned one
// here does.
#pragma once

#ifdef __CUDACC__
#define KT_WIT_HD __host__ __device__ __forceinline__
#else
#define KT_WIT_HD inline
#endif

// `before` ahead of the first group: -(2^31) + 1
#define WITNESS_BEFORE0 (-2147483647)

// Group g's flag from its pod count, strand count and priority and the
// running `before` of the groups ahead of it; advances `before` past g
// (the max with g's priority, when g stranded).
KT_WIT_HD bool witness_step(int count, int unsched, int prio, int& before) {
  const int ahead = before;
  if (unsched > 0 && prio > ahead) before = prio;
  return (int)((unsigned)count - (unsigned)unsched) > 0 && prio < ahead;
}
