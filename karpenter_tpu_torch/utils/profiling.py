"""Profiling gate and device-runtime telemetry of the solve path.

The reference exposes pprof behind ENABLE_PROFILING
(website/.../settings.md:23); the hot path here is the hand-written CUDA
kernels, so the equivalent is `torch.profiler` (host spans and, on the
card, the kernels' device time), gated by the reference's knobs:

  ENABLE_PROFILING=true              at boot, arm the per-solve trace hook
                                     into KARPENTER_TPU_PROFILE_DIR or
                                     ./profiles, and log where the traces
                                     go (torch has no profiler server to
                                     attach to, so the reference's
                                     :9999 server becomes traces on disk)
  KARPENTER_TPU_PROFILE_DIR=<dir>    trace every solve into <dir> (one
                                     Chrome trace per solve region)
  KARPENTER_TPU_PROFILE=<dir>|1      the one-knob spelling of the same
                                     per-solve hook: a directory value
                                     traces there; a bare truthy value
                                     traces into KARPENTER_TPU_PROFILE_DIR
                                     or ./profiles.

Disabled (the default), `trace_solve` is a no-op context manager with one
environment read of overhead.

The reference's ``KARPENTER_TPU_PROFILE_PORT`` (the port of its JAX
profiler server, 9999 by default) has no reader here: with no server
there is no port to choose, and setting it changes no answer and no
trace.  (`utils/knobs.py` lists the reference's other unread knobs.)
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Optional

# the directory ENABLE_PROFILING armed at boot (maybe_start_server)
_armed_dir: Optional[str] = None
_trace_seq = itertools.count()  # next() is atomic: one file name each


def profiling_enabled() -> bool:
    return os.environ.get("ENABLE_PROFILING", "").strip().lower() in (
        "1", "true", "yes")


def maybe_start_server(log=None) -> Optional[str]:
    """When ENABLE_PROFILING is set, arm the per-solve trace hook (into
    the directory `profile_trace_dir` names, else ./profiles) and log
    where the traces go.  Returns that directory, or None when profiling
    is off."""
    global _armed_dir
    if not profiling_enabled():
        return None
    _armed_dir = profile_trace_dir() or "profiles"
    if log is not None:
        log(f"torch profiler: one Chrome trace per solve into "
            f"{os.path.abspath(_armed_dir)}")
    return _armed_dir


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


def profile_trace_dir() -> Optional[str]:
    """Resolve the per-solve trace destination: KARPENTER_TPU_PROFILE
    (a directory, or a bare truthy value deferring to
    KARPENTER_TPU_PROFILE_DIR / ./profiles), else KARPENTER_TPU_PROFILE_DIR
    alone, else the directory ENABLE_PROFILING armed at boot.  None = the
    hook is off (the default)."""
    raw = os.environ.get("KARPENTER_TPU_PROFILE", "").strip()
    legacy = os.environ.get("KARPENTER_TPU_PROFILE_DIR")
    if not raw or raw.lower() in ("0", "false", "off", "no"):
        return legacy or _armed_dir
    if raw.lower() in ("1", "true", "yes", "on"):
        return legacy or "profiles"
    return raw  # a directory path


@contextlib.contextmanager
def trace_solve(name: str = "solve"):
    """Trace one solve region into the resolved profile directory when
    the hook is armed — `torch.profiler` over the CPU and, with a card,
    CUDA activity, the region named by `record_function(name)`, exported
    as one Chrome trace `<name>-<pid>-<n>.json`; otherwise a no-op."""
    trace_dir = profile_trace_dir()
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{name}-{os.getpid()}-{next(_trace_seq)}.json"))
