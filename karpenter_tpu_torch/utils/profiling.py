"""Device-runtime telemetry of the solve path.

The port's `utils/profiling.py` holds, for now, only the watermark the
flight recorder and `karpenter_tpu_solver_device_memory_peak_bytes`
sample.  The reference's profiler hooks (`ENABLE_PROFILING`,
`KARPENTER_TPU_PROFILE`, `trace_solve`) start the JAX profiler; the
port's, on `torch.profiler` behind the same knobs, come with the
operator.
"""

from __future__ import annotations


def device_memory_peak() -> int:
    """Peak device-memory bytes allocated across the local CUDA devices
    (`torch.cuda.max_memory_allocated`, the largest over the devices), the
    per-solve watermark the flight recorder and
    `karpenter_tpu_solver_device_memory_peak_bytes` sample.  0 on a host
    without a CUDA device (the CPU path) — absence of telemetry reads as
    zero, never raises into a solve."""
    try:
        import torch
        if not torch.cuda.is_available():
            return 0
        peak = 0
        for i in range(torch.cuda.device_count()):
            peak = max(peak, int(torch.cuda.max_memory_allocated(i)))
        return peak
    except Exception:  # noqa: BLE001 — telemetry, not control flow
        return 0
