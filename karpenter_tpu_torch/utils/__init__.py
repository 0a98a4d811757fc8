"""Shared runtime utilities: the canonical knob grammar (`knobs`), the
injected clock, the cloud error taxonomy, TTL and unavailable-offerings
caches, logfmt logging, the metrics registry and span tracing, and the
observability substrate: the flight recorder, the decision ledger, the
telemetry merge and the device-memory watermark (`profiling`); the
fault-injection hooks (`faults`) and the request-coalescing batcher.
The lock watchdog and the platform probe of the JAX package's `utils/`
are still to port (slices 5d and 6b)."""

from karpenter_tpu_torch.utils.clock import Clock, FakeClock, RealClock
from karpenter_tpu_torch.utils.cache import TTLCache, UnavailableOfferings
from karpenter_tpu_torch.utils.batcher import Batcher

__all__ = ["Batcher", "Clock", "FakeClock", "RealClock", "TTLCache",
           "UnavailableOfferings"]
