"""End-to-end span tracing across the provisioning pipeline.

The reference leans on pprof + per-controller metrics to attribute control
-loop latency (settings.md ENABLE_PROFILING); our budget analysis needs
per-REQUEST causality on top of the metric totals — which reconcile pass
paid the 50 ms device segment, and what its parent was. This module is
the in-process analogue of a W3C-trace-context tracer reduced to the
slice the operator needs:

  - `span(name, **attrs)`    context manager; nests via a thread-local
                             stack, starts a new trace at the root
  - `record_span(...)`       retroactive child span for already-timed
                             intervals (the solver's phase stamps)
  - `inject()` / `extract()` a `traceparent`-style field carried in the
                             solverd RPC body so remote-solver spans
                             stitch into the caller's trace
  - `chrome_trace()`         Chrome trace-event JSON (loadable in
                             Perfetto / chrome://tracing) of the bounded
                             ring buffer of completed traces

Gating: tracing is off unless
KARPENTER_TPU_TRACE is truthy (or a remote context was extracted on this
thread), and the disabled path is one thread-local context lookup plus
one env dict get per span — nothing rides the 200 ms solve budget.

Bounds: completed traces live in a ring buffer of KARPENTER_TPU_TRACE_BUFFER
traces (default 64); in-progress traces are capped (oldest evicted) so an
orphaned context can never grow memory; spans per trace are capped so a
pathological loop cannot balloon one trace entry.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

_ENV_GATE = "KARPENTER_TPU_TRACE"
_ENV_BUFFER = "KARPENTER_TPU_TRACE_BUFFER"

_MAX_LIVE_TRACES = 256     # orphan bound: oldest in-progress trace evicted
_MAX_SPANS_PER_TRACE = 4096

_enabled_override: Optional[bool] = None
_tl = threading.local()


def _count_dropped(n: int) -> None:
    """Eviction accounting (`karpenter_tpu_trace_spans_dropped_total`):
    the bounded buffers drop spans by design, and the drop count is what
    tells an operator the ring was too small for the trace volume —
    surfaced by `GET /debug/traces` alongside the export.  Imported
    lazily so tracing stays importable from the metrics module's own
    test fixtures without a cycle."""
    from karpenter_tpu_torch.utils import metrics
    metrics.TRACE_SPANS_DROPPED.inc(n)


def tracing_enabled() -> bool:
    if _enabled_override is not None:
        return _enabled_override
    from karpenter_tpu_torch.utils.knobs import env_bool
    return env_bool(_ENV_GATE)


def set_enabled(value: Optional[bool]) -> None:
    """Programmatic override, `None` defers back to the env gate — tests
    and embedding processes; the operator leaves it to the environment."""
    global _enabled_override
    _enabled_override = value


def _stack() -> list:
    st = getattr(_tl, "stack", None)
    if st is None:
        st = _tl.stack = []
    return st


def _active() -> bool:
    """True when a span on THIS thread should record: an enclosing
    context exists (local span or extracted remote parent) or the global
    gate is on. The disabled fast path is the `getattr` + one env get."""
    return bool(getattr(_tl, "stack", None)) or tracing_enabled()


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "duration", "attrs", "thread")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, start: float, duration: float, attrs: dict,
                 thread: str):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start          # wall-clock epoch seconds
        self.duration = duration    # seconds
        self.attrs = attrs
        self.thread = thread

    def to_dict(self) -> dict:
        """Pickle/JSON-stable wire form (the solverd response rides this)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start": self.start, "duration": self.duration,
                "attrs": dict(self.attrs), "thread": self.thread}

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(d["trace_id"], d["span_id"], d.get("parent_id"),
                   d["name"], d["start"], d["duration"],
                   dict(d.get("attrs") or {}), d.get("thread", ""))


class _Collector:
    """Completed spans of in-progress traces + a bounded ring buffer of
    finished traces."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: "OrderedDict[str, List[Span]]" = OrderedDict()
        self._finished: deque = deque(maxlen=self._buffer_size())

    @staticmethod
    def _buffer_size() -> int:
        try:
            return max(1, int(os.environ.get(_ENV_BUFFER, "64")))
        except ValueError:
            return 64

    def add(self, span: Span, finalize: bool = False) -> None:
        dropped = 0
        try:
            with self._lock:
                spans = self._live.get(span.trace_id)
                if spans is None:
                    # a late span for an already-finished trace (an
                    # async batcher window closing after the root) joins
                    # its entry
                    late = next((fspans for tid, fspans in self._finished
                                 if tid == span.trace_id), None)
                    if late is not None:
                        if len(late) < _MAX_SPANS_PER_TRACE:
                            late.append(span)
                        else:
                            dropped += 1
                        return
                    spans = self._live[span.trace_id] = []
                    while len(self._live) > _MAX_LIVE_TRACES:
                        _, orphaned = self._live.popitem(last=False)
                        dropped += len(orphaned)
                if len(spans) < _MAX_SPANS_PER_TRACE:
                    spans.append(span)
                else:
                    dropped += 1
                if finalize:
                    done = self._live.pop(span.trace_id, None)
                    if done is not None:
                        if len(self._finished) == self._finished.maxlen:
                            # the deque silently evicts its oldest trace
                            # to make room — those spans are drops too
                            dropped += len(self._finished[0][1])
                        self._finished.append((span.trace_id, done))
        finally:
            if dropped:
                _count_dropped(dropped)

    def take(self, trace_id: str) -> List[Span]:
        """Remove and return an in-progress trace's spans (the extract
        side of the RPC boundary ships them back to the caller)."""
        with self._lock:
            return self._live.pop(trace_id, [])

    def finished(self, trace_id: Optional[str] = None) -> List[tuple]:
        with self._lock:
            out = [(tid, list(spans)) for tid, spans in self._finished]
        if trace_id is not None:
            out = [e for e in out if e[0] == trace_id]
        return out

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._finished = deque(maxlen=self._buffer_size())


_collector = _Collector()


def _new_trace_id() -> str:
    return uuid.uuid4().hex              # 32 hex chars, traceparent-shaped


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]         # 16 hex chars


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _SpanCm:
    __slots__ = ("name", "parent", "span")

    def __init__(self, name: str, parent: Optional[Tuple[str, str]],
                 attrs: dict):
        self.name = name
        self.parent = parent
        self.span = Span("", _new_span_id(), None, name, 0.0, 0.0, attrs,
                         threading.current_thread().name)

    def __enter__(self) -> Span:
        sp = self.span
        st = _stack()
        parent = self.parent or (st[-1] if st else None)
        if parent is None:
            sp.trace_id = _new_trace_id()
        else:
            sp.trace_id, sp.parent_id = parent
        sp.start = time.time()
        st.append((sp.trace_id, sp.span_id))
        return sp

    def __exit__(self, *exc):
        sp = self.span
        sp.duration = time.time() - sp.start
        st = _stack()
        if st and st[-1] == (sp.trace_id, sp.span_id):
            st.pop()
        # a trace completes when its ROOT span ends; spans parented on a
        # captured/remote context never finalize here (extract() or the
        # owning thread's root does)
        _collector.add(sp, finalize=(sp.parent_id is None
                                     and self.parent is None))
        return False


def span(name: str, parent: Optional[Tuple[str, str]] = None, **attrs):
    """Context manager for one span. `parent` overrides the thread-local
    context with a captured `(trace_id, span_id)` (cross-thread stitching,
    e.g. the batcher's worker). Yields the Span so callers can add attrs
    discovered mid-flight (`sp.attrs["path"] = ...`)."""
    if parent is None and not _active():
        return _NOOP
    return _SpanCm(name, parent, attrs)


def child_span(name: str, **attrs):
    """A span only when a trace is already active on this thread — I/O
    annotations (store requests, batcher windows) enrich traces but never
    start one of their own."""
    if not getattr(_tl, "stack", None):
        return _NOOP
    return _SpanCm(name, None, attrs)


def record_span(name: str, start: float, duration: float, **attrs) -> None:
    """Retroactive completed child of the current context — for intervals
    the caller already timed (the solver's per-phase perf stamps)."""
    st = getattr(_tl, "stack", None)
    if not st:
        return
    trace_id, parent_id = st[-1]
    _collector.add(Span(trace_id, _new_span_id(), parent_id, name, start,
                        duration, attrs, threading.current_thread().name))


def current() -> Optional[Tuple[str, str]]:
    """Capture the active `(trace_id, span_id)` for cross-thread or
    cross-process propagation; None when no trace is active."""
    st = getattr(_tl, "stack", None)
    return st[-1] if st else None


def current_trace_id() -> Optional[str]:
    st = getattr(_tl, "stack", None)
    return st[-1][0] if st else None


# -- traceparent-style propagation (W3C trace-context shaped) -------------
def inject() -> Optional[str]:
    """`00-<trace_id>-<span_id>-01` for the active span, else None. Rides
    the solverd schedule body so the daemon's spans join this trace."""
    ctx = current()
    if ctx is None:
        return None
    return f"00-{ctx[0]}-{ctx[1]}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    if not header or not isinstance(header, str):
        return None
    parts = header.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None
    return parts[1], parts[2]


class _RemoteTrace:
    """Extracted remote context: spans opened inside the `with` block are
    children of the caller's span; on exit they are collected into
    `.spans` for the response to carry back (they belong to the CALLER's
    trace, not this process's ring buffer)."""

    __slots__ = ("ctx", "spans")

    def __init__(self, ctx: Optional[Tuple[str, str]]):
        self.ctx = ctx
        self.spans: List[Span] = []

    def __enter__(self) -> "_RemoteTrace":
        if self.ctx is not None:
            _stack().append(self.ctx)
        return self

    def __exit__(self, *exc):
        if self.ctx is not None:
            st = _stack()
            if st and st[-1] == self.ctx:
                st.pop()
            self.spans = _collector.take(self.ctx[0])
        return False


def extract(header: Optional[str]) -> _RemoteTrace:
    """Context manager adopting a remote `traceparent`; inert (and free)
    when the header is absent or malformed. The remote side records even
    when its own env gate is off — the caller made the gating decision."""
    return _RemoteTrace(parse_traceparent(header))


def adopt(span_dicts: List[dict]) -> None:
    """Merge spans shipped back across the RPC boundary into the local
    collector. They already carry this process's trace ids (the caller
    injected them), so they stitch under the still-open local trace."""
    for d in span_dicts:
        try:
            _collector.add(Span.from_dict(d))
        except (KeyError, TypeError):
            continue  # a malformed remote span must not poison the trace


# -- export ----------------------------------------------------------------
def finished_traces(trace_id: Optional[str] = None) -> List[tuple]:
    """[(trace_id, [Span, ...]), ...] — most recent last."""
    return _collector.finished(trace_id)


def chrome_trace(trace_id: Optional[str] = None,
                 limit: Optional[int] = None) -> dict:
    """Chrome trace-event JSON (the `traceEvents` array format) of the
    completed-trace ring buffer, loadable in Perfetto / chrome://tracing.
    Spans become complete ("X") events; each trace maps to one pid so
    Perfetto groups its spans, threads map to tids within it.  `limit`
    keeps only the most recent N traces (the `?limit=` parameter on
    `GET /debug/traces` — a large ring must not dump unbounded JSON);
    `otherData.spansDropped` carries the collector's eviction counter so
    a truncated-looking trace is distinguishable from a dropped one."""
    traces = finished_traces(trace_id)
    if limit is not None and limit >= 0:
        # slice from the front: traces[-0:] would be the WHOLE list, the
        # exact opposite of the cap ?limit=0 asks for
        traces = traces[len(traces) - limit:] if limit else []
    events: List[dict] = []
    for pid, (tid_, spans) in enumerate(traces, start=1):
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"trace {tid_[:16]}"},
        })
        threads: Dict[str, int] = {}
        for sp in spans:
            tid = threads.setdefault(sp.thread, len(threads) + 1)
            events.append({
                "name": sp.name,
                "ph": "X",
                "ts": sp.start * 1e6,        # microseconds
                "dur": max(sp.duration, 0.0) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {"trace_id": sp.trace_id, "span_id": sp.span_id,
                         "parent_id": sp.parent_id, **sp.attrs},
            })
    from karpenter_tpu_torch.utils import metrics
    return {"displayTimeUnit": "ms", "traceEvents": events,
            "otherData": {
                "spansDropped": int(metrics.TRACE_SPANS_DROPPED.value()),
                "tracesReturned": len(traces)}}


def reset() -> None:
    """Clear all collected state (tests)."""
    _collector.reset()
    st = getattr(_tl, "stack", None)
    if st:
        del st[:]
