// An empty kernel, one thread: the device time of a launch that does no
// work, the floor any short kernel's time is read against.
// chip_smoke.py times it; nothing on the solve path launches it.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

// Plain-C entry point for ctypes: no pointers, no dims.  Returns 0, a
// CUDA error code, or -1 for arguments it does not take.
extern "C" int ffd_empty(const unsigned long long* ptrs, int nptrs,
                         const int* dims, int ndims, void* stream) {
  (void)ptrs;
  (void)dims;
  if (nptrs != 0 || ndims != 0) return -1;
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
