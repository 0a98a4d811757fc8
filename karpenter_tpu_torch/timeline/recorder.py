"""Timeline recorder: the cluster-mutation black box.

Where the flight recorder (utils/flightrecorder.py) answers "what did
ONE solve see and answer", the timeline recorder answers "what happened
to the CLUSTER, in order": every informer-cache mutation plus the
semantic drive events (spot reclaim, price refresh, fault injection,
gang/priority arrival) lands here as one monotonic record.  A spilled
timeline is replayable: the JAX package's `timeline/rewind.py`
reconstructs the cluster trajectory from the drive events and re-audits
every invariant along the way (the port's rewind comes with the
operator).

Knobs (env-resolved per record, same discipline as the flight ring):

  KARPENTER_TPU_TIMELINE=off|0       disable (default: on — the ring
                                     append is O(1) and the spill only
                                     runs when a directory is set)
  KARPENTER_TPU_TIMELINE_BUFFER=N    ring size (default 4096 — a
                                     timeline is much chattier than the
                                     solve ring)
  KARPENTER_TPU_TIMELINE_DIR=<dir>   spill each event as one JSONL line
                                     to <dir>/timeline-<pid>.jsonl

Cross-links stamped on every record: the active trace id, the flight
recorder's newest solve seq, and the decision ledger's newest row seq —
so any timeline event can be joined to the solve that preceded it and
the ledger row it produced.  The spill loader is
`flightrecorder.load_records` (shared torn-line-tolerant code path).

The port's copy of `karpenter_tpu/timeline/recorder.py`: the same knobs,
defaults, event fields and capture points, so one cluster trajectory
gives the same stream in both packages.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import List, Optional

from karpenter_tpu_torch.timeline import events as ev
from karpenter_tpu_torch.utils import flightrecorder, metrics, tracing

_ENV_GATE = "KARPENTER_TPU_TIMELINE"
_ENV_BUFFER = "KARPENTER_TPU_TIMELINE_BUFFER"
_ENV_DIR = "KARPENTER_TPU_TIMELINE_DIR"


def recording_enabled() -> bool:
    """On unless explicitly disabled — same always-on posture as the
    flight ring; the default path is a lock + deque append."""
    from karpenter_tpu_torch.utils.knobs import env_bool
    return env_bool(_ENV_GATE, default=True)


class TimelineEvent:
    __slots__ = ("seq", "ts", "pid", "kind", "name", "data",
                 "trace_id", "flight_seq", "ledger_seq")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.get(name))

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


class TimelineRecorder:
    """Bounded ring + optional JSONL spill; one per process
    (module-level RECORDER), thread-safe — controllers, the operator
    loop, and the dashboard reader all touch it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self._buffer_size())
        self._seq = 0
        self._spill = None          # (path, file handle) once opened
        self._spill_failed = False  # one strike, then best-effort off
        # first-member markers: one gang.arrival / priority.arrival per
        # distinct gang name / priority band per process lifetime
        self._seen_gangs: set = set()
        self._seen_priorities: set = set()

    @staticmethod
    def _buffer_size() -> int:
        try:
            return max(1, int(os.environ.get(_ENV_BUFFER, "4096")))
        except ValueError:
            return 4096

    @property
    def enabled(self) -> bool:
        return recording_enabled()

    def emit(self, kind: str, name: str = "",
             data: Optional[dict] = None) -> Optional[TimelineEvent]:
        if not self.enabled:
            return None
        from karpenter_tpu_torch.utils.ledger import LEDGER
        with self._lock:
            self._seq += 1
            rec = TimelineEvent(
                # capture-side provenance stamp: replay rebases ts (the
                # engine's clock drives ticks) and digests exclude it
                seq=self._seq, ts=time.time(), pid=os.getpid(),
                kind=kind, name=name, data=data,
                trace_id=tracing.current_trace_id(),
                flight_seq=flightrecorder.RECORDER.last_seq(),
                ledger_seq=LEDGER.last_seq())
            self._ring.append(rec)
        metrics.TIMELINE_EVENTS.inc(kind=kind)
        self._maybe_spill(rec)
        return rec

    def _maybe_spill(self, rec: TimelineEvent) -> None:
        d = os.environ.get(_ENV_DIR)
        if not d or self._spill_failed:
            return
        import json
        line = json.dumps(rec.to_dict(), default=str)
        try:
            with self._lock:
                path = os.path.join(d, f"timeline-{os.getpid()}.jsonl")
                if self._spill is None or self._spill[0] != path:
                    os.makedirs(d, exist_ok=True)
                    if self._spill is not None:
                        self._spill[1].close()
                    self._spill = (path, open(path, "a", encoding="utf-8"))
                f = self._spill[1]
                f.write(line + "\n")
                f.flush()
        except OSError:
            # best-effort, like the flight spill: a full disk degrades
            # the timeline to ring-only, never fails a controller —
            # but counted, so restart replay losing events is visible
            metrics.SPILL_DEGRADED.inc(recorder="timeline")
            self._spill_failed = True

    def tail(self, n: int = 64, kind: Optional[str] = None,
             since: Optional[int] = None) -> List[dict]:
        if n <= 0:
            return []  # recs[-0:] would be the whole ring, not nothing
        with self._lock:
            recs = list(self._ring)
        if kind is not None:
            recs = [r for r in recs if r.kind == kind]
        if since is not None:
            recs = [r for r in recs if r.seq > since]
        return [r.to_dict() for r in recs[-n:]]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def last_seq(self) -> Optional[int]:
        with self._lock:
            return self._seq if self._seq else None

    def reset(self) -> None:
        """Clear the ring and close any spill handle (tests)."""
        with self._lock:
            self._ring = deque(maxlen=self._buffer_size())
            self._seq = 0
            self._seen_gangs = set()
            self._seen_priorities = set()
            if self._spill is not None:
                try:
                    self._spill[1].close()
                except OSError:
                    pass
            self._spill = None
            self._spill_failed = False


RECORDER = TimelineRecorder()


def emit(kind: str, name: str = "",
         data: Optional[dict] = None) -> Optional[TimelineEvent]:
    """Module-level convenience over RECORDER.emit — the one call site
    shape; kinds come from `timeline.events`, never literals."""
    return RECORDER.emit(kind, name=name, data=data)


def pod_spec(pod) -> dict:
    """The replayable slice of a pod: dense request vector plus the
    metadata the solver's semantics depend on (gang/priority/topology
    annotations, labels).  `rewind.make_pod` inverts this."""
    meta = pod.meta
    return {
        "requests": list(getattr(pod.requests, "v", []) or []),
        "annotations": dict(getattr(meta, "annotations", {}) or {}),
        "labels": dict(getattr(meta, "labels", {}) or {}),
    }


def record_store_mutation(cluster, kind: str, op: str, name: str) -> None:
    """The `Cluster.mutated` hook: one `store.<kind>.<op>` observation
    per informer-cache mutation, plus the semantic first-member markers
    (gang.arrival / priority.arrival) on pod arrival.  Pod additions
    carry the replayable spec so a recorded stream can be promoted to
    drive events."""
    if not RECORDER.enabled or not kind:
        return
    data = None
    if kind == "pods" and op == "added":
        pod = cluster.pods.get(name)
        if pod is not None:
            data = pod_spec(pod)
            _semantic_markers(name, data["annotations"])
    emit(ev.store_event(kind, op), name=name, data=data)


def _semantic_markers(pod_name: str, annotations: dict) -> None:
    """gang.arrival on the first member of each gang, priority.arrival
    on the first pod of each non-default priority band — the scenario
    bookmarks of the 'priority/gang arrival' capture."""
    from karpenter_tpu_torch.models import wellknown
    gname = annotations.get(wellknown.GANG_NAME_ANNOTATION)
    if gname:
        with RECORDER._lock:
            fresh = gname not in RECORDER._seen_gangs
            RECORDER._seen_gangs.add(gname)
        if fresh:
            emit(ev.GANG_ARRIVAL, name=gname, data={
                "first_member": pod_name,
                "size": annotations.get(
                    wellknown.GANG_SIZE_ANNOTATION),
                "topology": annotations.get(
                    wellknown.GANG_TOPOLOGY_ANNOTATION)})
    prio = annotations.get(wellknown.PRIORITY_ANNOTATION)
    if prio:
        with RECORDER._lock:
            fresh = prio not in RECORDER._seen_priorities
            RECORDER._seen_priorities.add(prio)
        if fresh:
            emit(ev.PRIORITY_ARRIVAL, name=str(prio),
                 data={"first_pod": pod_name})


def load_events(path: str) -> List[dict]:
    """Parse one spilled timeline-<pid>.jsonl — or stitch every
    timeline-*.jsonl under a directory in (mtime, name) order, the
    multi-process / restart-replay case.  Delegates to the flight
    recorder's torn-line-tolerant loader: a crashed process leaves at
    most one torn tail line, and every record before it must load."""
    return [r for r in flightrecorder.load_records(path, prefix="timeline")
            if isinstance(r, dict) and "kind" in r]
