// Shared device helpers of the FFD kernels (ffd_scan_common.cuh, ffd_pack.cu).
//
// Bit parity with the JAX reference (karpenter_tpu/solver/ffd.py) is the
// contract, so every float operation here is spelled with a round-to-
// nearest intrinsic (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn): the
// compiler may neither contract a multiply-add into an FMA nor swap in an
// approximate division, whatever the build flags say.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the resource axis (karpenter_tpu_torch/models/resources.py RESOURCE_AXIS)
#define KR 6
// the fit-slack epsilon (solver/explain.py EPS) as float32
#define KEPS 1e-3f

// _fit_count (ffd.py:116): how many pods of request `req` fit in `avail`:
// floor((avail + EPS) / req) per resource with req > 0, the minimum over
// resources, clipped to [0, 2^30] BEFORE the integer conversion (pool
// limits are +inf for unlimited pools, and converting inf is undefined).
__device__ __forceinline__ int fit_count(const float* avail,
                                         const float* req) {
  float c = 1073741824.0f;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    if (req[r] > 0.0f) {
      const float v = floorf(__fdiv_rn(__fadd_rn(avail[r], KEPS), req[r]));
      c = fminf(c, v);
    }
  }
  c = fminf(fmaxf(c, 0.0f), 1073741824.0f);
  return (int)c;
}

// all(a - b - c >= -EPS) over the resource axis, evaluated left to right
__device__ __forceinline__ bool all_fits3(const float* a, const float* b,
                                          const float* c) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < KR; ++r)
    ok = ok && (__fsub_rn(__fsub_rn(a[r], b[r]), c[r]) >= -KEPS);
  return ok;
}

// all(a - b >= -EPS) over the resource axis
__device__ __forceinline__ bool all_fits2(const float* a, const float* b) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < KR; ++r)
    ok = ok && (__fsub_rn(a[r], b[r]) >= -KEPS);
  return ok;
}

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
