// Shared device helpers of the FFD scan kernels (ffd_scan_common.cuh).
//
// Bit parity with the JAX reference (karpenter_tpu/solver/ffd.py) is the
// contract, so every float operation here is spelled with a round-to-
// nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn): the
// compiler may neither contract a multiply-add into an FMA nor swap in an
// approximate division, whatever the build flags say.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// fit_count, all_fits2/3 and the column walk's per-word arithmetic
#include "ffd_walk.cuh"

// Exclusive prefix sum over the block (NT threads, every thread calls).
// Unsigned arithmetic: the reference's int32 cumsums wrap modulo 2^32, and
// unsigned overflow is defined in C++ where signed overflow is not.
// `total` receives the block-wide sum.  s_warp holds NT/32 words.
template <int NT>
__device__ __forceinline__ unsigned block_excl_scan(unsigned v,
                                                    unsigned* s_warp,
                                                    unsigned* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < NW ? s_warp[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < NW) s_warp[lane] = s;
  }
  __syncthreads();
  const unsigned pre = warp ? s_warp[warp - 1] : 0u;
  *total = s_warp[NW - 1];
  __syncthreads();
  return pre + x - v;
}

// int32 product with the reference's wrap-around semantics
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// int32 difference with the reference's wrap-around semantics
__device__ __forceinline__ int wsub(int a, unsigned b) {
  return (int)((unsigned)a - b);
}
