"""Windowed request-coalescing batcher.

The reference amortizes cloud-API round trips by coalescing concurrent
identical-shaped requests into one batched call behind a small idle/max
window (pkg/batcher/batcher.go:61-183): callers block on Add() while a
trigger goroutine waits for the request stream to go idle (or the window /
size cap to hit), then fans the whole bucket out as one API call and
distributes per-item results back to the callers. Requests are bucketed by
a hash of their non-batchable fields (DefaultHasher, batcher.go:119-125) so
only compatible requests share a call.

This is the same machinery that amortizes the host↔device solver hop:
many concurrent Schedule() calls coalesce into one padded pods×types
tensor batch (SURVEY §2.3).

Per-API window constants mirror the reference:
  create_fleet        idle 35 ms / max 1 s / 1000 items (createfleet.go:35-37)
  describe_instances  idle 100 ms / max 1 s / 500 items (describeinstances.go:39-41)
  terminate_instances idle 100 ms / max 1 s / 500 items (terminateinstances.go:38-40)

The port's copy of `karpenter_tpu/utils/batcher.py`, unchanged but for
its imports.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Generic, Hashable, List, Optional, TypeVar

from karpenter_tpu_torch.utils import metrics, tracing

T = TypeVar("T")  # request item
U = TypeVar("U")  # per-item result

# (idle window s, max window s, max items) — reference constants
CREATE_FLEET_WINDOW = (0.035, 1.0, 1000)
DESCRIBE_INSTANCES_WINDOW = (0.100, 1.0, 500)
TERMINATE_INSTANCES_WINDOW = (0.100, 1.0, 500)


@dataclass
class _Pending(Generic[T, U]):
    request: T
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[U] = None
    error: Optional[BaseException] = None
    # submitter's trace context, captured at submit() time: the window
    # executes on a worker thread with no thread-local trace of its own,
    # so the execute span stitches under the first traced submitter
    trace_ctx: Optional[tuple] = None


class _Bucket(Generic[T, U]):
    def __init__(self) -> None:
        self.items: List[_Pending[T, U]] = []
        self.first_ts: float = 0.0
        self.last_ts: float = 0.0
        self.worker: Optional[threading.Thread] = None


class Batcher(Generic[T, U]):
    """Coalesces concurrent ``add()`` calls into batched executor calls.

    ``executor(requests) -> results`` receives the drained bucket and must
    return one result per request, in order (or raise — the error is
    re-raised in every blocked caller, matching the reference's behavior of
    failing the whole batch, batcher.go:166-176).

    ``hasher(request)`` buckets requests; only same-hash requests share a
    call (non-batchable fields — e.g. launch-template config — go in the
    hash; per-item fields — e.g. instance ids — are the batch payload).
    """

    def __init__(
        self,
        executor: Callable[[List[T]], List[U]],
        idle_s: float = 0.1,
        max_s: float = 1.0,
        max_items: int = 500,
        hasher: Optional[Callable[[T], Hashable]] = None,
        name: str = "batcher",
    ):
        self.executor = executor
        self.idle_s = idle_s
        self.max_s = max_s
        self.max_items = max_items
        self.hasher = hasher or (lambda _req: 0)
        self.name = name
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._buckets: Dict[Hashable, _Bucket[T, U]] = {}
        # observability (role of pkg/batcher/metrics.go)
        self.batches_executed = 0
        self.items_batched = 0
        self.batch_sizes: List[int] = []

    def add(self, request: T) -> U:
        """Block until the batch containing ``request`` executes; return this
        request's result (pkg/batcher/batcher.go:101-116)."""
        return self.wait(self.submit(request))

    def submit(self, request: T) -> "_Pending[T, U]":
        """Enqueue without blocking — lets one caller put many items into the
        same window before waiting (terminate_instances takes a list)."""
        pending: _Pending[T, U] = _Pending(request,
                                           trace_ctx=tracing.current())
        key = self.hasher(request)
        now = time.monotonic()
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None or bucket.worker is None:
                bucket = _Bucket()
                self._buckets[key] = bucket
                bucket.first_ts = now
                bucket.worker = threading.Thread(
                    target=self._run_window, args=(key, bucket), daemon=True)
                start_worker = True
            else:
                start_worker = False
            bucket.items.append(pending)
            bucket.last_ts = now
            if len(bucket.items) >= self.max_items:
                self._wake.notify_all()  # size cap: fire immediately
        if start_worker:
            bucket.worker.start()
        return pending

    def wait(self, pending: "_Pending[T, U]") -> U:
        pending.done.wait()
        if pending.error is not None:
            raise pending.error
        return pending.result  # type: ignore[return-value]

    def _run_window(self, key: Hashable, bucket: _Bucket[T, U]) -> None:
        # wait for idle (no new adds for idle_s) or the max window / size cap
        with self._lock:
            while True:
                now = time.monotonic()
                idle_done = now - bucket.last_ts >= self.idle_s
                max_done = now - bucket.first_ts >= self.max_s
                full = len(bucket.items) >= self.max_items
                if idle_done or max_done or full:
                    # drain at most max_items — real APIs cap per-request
                    # item counts; late adds racing the size-cap notify stay
                    # queued for the next batch
                    items = bucket.items[:self.max_items]
                    bucket.items = bucket.items[self.max_items:]
                    if bucket.items:
                        bucket.first_ts = now
                        bucket.worker = threading.Thread(
                            target=self._run_window, args=(key, bucket),
                            daemon=True)
                        bucket.worker.start()
                    else:
                        bucket.worker = None
                        if self._buckets.get(key) is bucket:
                            del self._buckets[key]
                    break
                wait = min(self.idle_s - (now - bucket.last_ts),
                           self.max_s - (now - bucket.first_ts))
                self._wake.wait(timeout=max(wait, 0.001))
        self._execute(items)

    def _execute(self, items: List[_Pending[T, U]]) -> None:
        requests = [p.request for p in items]
        ctx = next((p.trace_ctx for p in items if p.trace_ctx), None)
        try:
            if ctx is not None:
                with tracing.span("batcher.execute", parent=ctx,
                                  batcher=self.name, items=len(items)):
                    results = self.executor(requests)
            else:
                results = self.executor(requests)
            if len(results) != len(requests):
                raise RuntimeError(
                    f"{self.name}: executor returned {len(results)} results "
                    f"for {len(requests)} requests")
        except BaseException as err:  # noqa: BLE001 — fail the whole batch
            for p in items:
                p.error = err
                p.done.set()
            return
        self.batches_executed += 1
        self.items_batched += len(items)
        self.batch_sizes.append(len(items))
        metrics.BATCHER_BATCH_SIZE.observe(len(items), batcher=self.name)
        for p, r in zip(items, results):
            p.result = r
            p.done.set()

    def flush(self) -> None:
        """Close every open window now (test/shutdown aid)."""
        with self._lock:
            for bucket in self._buckets.values():
                bucket.first_ts -= self.max_s
            self._wake.notify_all()
