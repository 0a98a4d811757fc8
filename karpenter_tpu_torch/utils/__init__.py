"""Shared runtime utilities: the canonical knob grammar (`knobs`), the
injected clock, the cloud error taxonomy, TTL and unavailable-offerings
caches, logfmt logging, the metrics registry and span tracing, and the
observability substrate: the flight recorder, the decision ledger, the
telemetry merge and the device-memory watermark (`profiling`).  The
fault hooks, the request batcher, the lock watchdog and the platform
probe of the JAX package's `utils/` are still to port (slices 5c, 5d
and 6b)."""
