#!/usr/bin/env python3
"""Does a card-to-card copy wait behind a kernel that spins on the source
card?  The question behind the order of K7x's launch entry
(`ffd_card_launch`, karpenter_tpu_torch/csrc/ffd_card_scan.cu), which
puts every copy of card 0's problem rows on card 0's stream ahead of
every rank's block.

Run from the repository root on a host of two or more NVIDIA cards with
peer access:

    python3 peer_order.py

It builds a small probe with nvcc (into `karpenter_tpu_torch/_build/`)
and, for each trial, launches on card A a kernel that spins until a flag
in its own memory is set or a deadline (1 s, `%globaltimer`) passes;
then copies 64 KiB from card A to card B with cudaMemcpyPeerAsync and
launches on card B a kernel that sets card A's flag over NVLink. The
copy goes on card B's stream after the spinning kernel was enqueued
("peer-stream": what each rank's own copy would be), or on card A's
stream before the spinning kernel ("source-first": the shipped order).
Each side's stream is the legacy default stream (handle 0, what PyTorch
hands a launch on its default stream), a stream made with
cudaStreamCreate ("blocking") or one made with cudaStreamNonBlocking. A
trial prints whether the spinning kernel was released before its
deadline, the host's ms in the copy call and the ms until both cards
were idle. Nothing traps: the spinning kernel gives up at its deadline.
Prints one JSON line a trial and the card names and power limits."""

import ctypes
import json
import os
import subprocess
import sys

PROBE = r"""
#include <cuda_runtime.h>
#include <chrono>

__global__ void spin(volatile int* flag, int* out, unsigned long long ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  for (;;) {
    if (*flag) { out[0] = 1; return; }
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > ns) { out[0] = 0; return; }
  }
}

__global__ void release(int* flag) {
  *(volatile int*)flag = 1;
  __threadfence_system();
}

static cudaStream_t make(int kind) {
  cudaStream_t s = 0;
  if (kind == 1) cudaStreamCreate(&s);
  if (kind == 2) cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  return s;
}

// one trial on cards a, b: kind_a, kind_b 0 legacy, 1 blocking, 2
// non-blocking; source_first 0 the copy on b's stream after the spin, 1
// on a's stream before it.  out: released, host ms of the copy call, ms
// until both cards idle.  Returns 0 or a CUDA error.
extern "C" int trial(int a, int b, int kind_a, int kind_b, int source_first,
                     double* out) {
  using clk = std::chrono::steady_clock;
  static int* flag = nullptr;
  static int* res = nullptr;
  static void* src = nullptr;
  static void* dst = nullptr;
  const size_t bytes = 1 << 16;
  cudaError_t err;
  if (!flag) {
    cudaSetDevice(a);
    cudaDeviceEnablePeerAccess(b, 0);
    cudaMalloc(&flag, sizeof(int));
    cudaMalloc(&res, sizeof(int));
    cudaMalloc(&src, bytes);
    cudaSetDevice(b);
    cudaDeviceEnablePeerAccess(a, 0);
    cudaMalloc(&dst, bytes);
    cudaGetLastError();
  }
  cudaSetDevice(a);
  cudaMemset(flag, 0, sizeof(int));
  cudaMemset(res, 0, sizeof(int));
  cudaDeviceSynchronize();
  cudaStream_t sa = make(kind_a);
  cudaSetDevice(b);
  cudaStream_t sb = make(kind_b);
  const auto t0 = clk::now();
  double copy_ms = 0.0;
  cudaSetDevice(a);
  if (source_first) {
    const auto c0 = clk::now();
    cudaMemcpyPeerAsync(dst, b, src, a, bytes, sa);
    copy_ms = std::chrono::duration<double, std::milli>(clk::now() - c0)
                  .count();
  }
  spin<<<1, 1, 0, sa>>>(flag, res, 1000000000ull);
  cudaSetDevice(b);
  if (!source_first) {
    const auto c0 = clk::now();
    cudaMemcpyPeerAsync(dst, b, src, a, bytes, sb);
    copy_ms = std::chrono::duration<double, std::milli>(clk::now() - c0)
                  .count();
  }
  release<<<1, 1, 0, sb>>>(flag);
  cudaSetDevice(a);
  cudaDeviceSynchronize();
  cudaSetDevice(b);
  cudaDeviceSynchronize();
  const double wall =
      std::chrono::duration<double, std::milli>(clk::now() - t0).count();
  int got = -1;
  cudaSetDevice(a);
  cudaMemcpy(&got, res, sizeof(int), cudaMemcpyDeviceToHost);
  err = cudaGetLastError();
  if (sa) cudaStreamDestroy(sa);
  cudaSetDevice(b);
  if (sb) cudaStreamDestroy(sb);
  out[0] = got;
  out[1] = copy_ms;
  out[2] = wall;
  return (int)err;
}
"""

KINDS = ("legacy", "blocking", "nonblocking")


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "karpenter_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "peer_order.cu")
    lib = os.path.join(out_dir, "libpeer_order.so")
    with open(src, "w") as f:
        f.write(PROBE)
    nvcc = "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O2", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, src], check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    fn = ctypes.CDLL(lib).trial
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_double)]
    # the first trial is the process's first peer copy
    trials = [("peer-stream", "legacy", "legacy")]
    trials += [("source-first", ka, kb) for ka in KINDS for kb in KINDS]
    trials += [("peer-stream", ka, kb) for ka in KINDS for kb in KINDS]
    bad = 0
    for order, ka, kb in trials:
        res = (ctypes.c_double * 3)()
        rc = fn(0, 1, KINDS.index(ka), KINDS.index(kb),
                int(order == "source-first"), res)
        row = {"order": order, "stream_a": ka, "stream_b": kb,
               "released": bool(res[0] == 1), "copy_call_ms": res[1],
               "wall_ms": res[2], "cuda_error": rc}
        bad += rc != 0
        print(json.dumps(row), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
