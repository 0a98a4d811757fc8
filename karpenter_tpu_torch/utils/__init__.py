"""Shared runtime utilities: the canonical knob grammar (`knobs`), the
injected clock, the cloud error taxonomy, TTL and unavailable-offerings
caches, logfmt logging, the metrics registry and span tracing.  The
ledger, flight recorder, fault hooks and the other observability modules
of the JAX package's `utils/` are still to port (slice 6)."""
