"""Flight recorder: an always-on, bounded, per-process ring of solve
records.

Every pass through the solver's `_solve_attempt` seam (a full solve, a
delta pass, a chunk chain) appends one :class:`FlightRecord`: catalog
identity, an encoded-problem fingerprint, the resolved execution knobs
(mesh/delta/pipeline/node axis), the per-phase timings from
`last_phase_ms`, the delta outcome + fallback reason, first-use events
(the `retraces` field: `solver/firstuse.total()`'s delta over the
attempt, the counterpart of the JAX package's trace count), the
device-memory watermark, a result digest (nodes / bit-exact cost), and
the active trace id.  The point: a parity bug stops being "reproduce it
by luck" — the record says exactly *what* the solve saw and *what* it
answered, and with full capture enabled the problem itself is on disk
to re-execute deterministically.

The port's copy of `karpenter_tpu/utils/flightrecorder.py`: the same
knobs, defaults, record fields and fingerprints.  The fingerprints hash
the host encode's numpy arrays, which the port produces bit for bit as
the reference does, so the two packages fingerprint one problem alike.

Modes (all env-resolved per record so tests and operators can flip them
without rebuilding the solver):

  KARPENTER_TPU_FLIGHT=off|0        disable entirely (default: on — the
                                    fingerprint-only record is budgeted
                                    <1% of the headline solve p50)
  KARPENTER_TPU_FLIGHT_BUFFER=N     ring size (default 256 records)
  KARPENTER_TPU_FLIGHT_DIR=<dir>    additionally spill each record as one
                                    JSONL line to <dir>/flight-<pid>.jsonl
                                    (the durable tail a crashed process
                                    leaves behind)
  KARPENTER_TPU_FLIGHT_CAPTURE=1    with FLIGHT_DIR set: pickle the FULL
                                    problem (ScheduleInput + node cap) to
                                    <dir>/capture-<pid>-<seq>.pkl and
                                    reference it from the record — the
                                    one-command-repro input

Fingerprints are sha256 over the SMALL encoded arrays (group axis +
existing axis + limits — kilobytes at the 50k-pod shape, never the
[G, O] mask), so the default record costs microseconds.  Two solves
with the same fingerprint saw the same problem as far as the kernel's
group/exist/limit inputs are concerned; the full capture is the
authoritative artifact.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from karpenter_tpu_torch.utils import metrics

_ENV_GATE = "KARPENTER_TPU_FLIGHT"
_ENV_BUFFER = "KARPENTER_TPU_FLIGHT_BUFFER"
_ENV_DIR = "KARPENTER_TPU_FLIGHT_DIR"
_ENV_CAPTURE = "KARPENTER_TPU_FLIGHT_CAPTURE"


def recording_enabled() -> bool:
    """On unless explicitly disabled — the recorder is the always-on
    black box, and its default path must stay cheap enough to leave on
    (budgeted under 1% of the headline p50)."""
    from karpenter_tpu_torch.utils.knobs import env_bool
    return env_bool(_ENV_GATE, default=True)


def _sha16(*chunks) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()[:16]


def catalog_identity(cat) -> dict:
    """Compact identity of a CatalogEncoding: enough to tell two
    catalogs apart (column count, grid stride, pool names, price
    digest) without hashing the multi-MB column matrices.  Memoized on
    the encoding object — one price-array hash per catalog identity,
    not per solve (the <1% overhead budget)."""
    ident = getattr(cat, "_flight_identity", None)
    if ident is None:
        ident = {
            "columns": len(cat.columns),
            "zc": cat.zc,
            "pools": [p.meta.name for p in cat.pools],
            "price_sha": _sha16(cat.col_price.tobytes()),
        }
        try:
            cat._flight_identity = ident
        except AttributeError:
            pass
    return ident


def problem_fingerprint(enc) -> str:
    """sha256 (truncated) over the group-axis and exist-axis encoded
    arrays — the per-problem kernel inputs that are small (KBs at the
    50k shape).  The [G, O] mask is deliberately excluded from the
    default fingerprint (it can be ~MBs); the full capture carries the
    authoritative problem."""
    return _sha16(
        enc.group_req.tobytes(), enc.group_count.tobytes(),
        enc.exist_remaining.tobytes(), enc.pool_limit.tobytes(),
        str((enc.n_groups, enc.n_columns, enc.n_domains,
             len(enc.existing))).encode())


def result_digest(res) -> dict:
    """Bit-exact digest of a ScheduleResult: node count, total price as
    both a readable float and its IEEE hex form (the replay CLI compares
    the hex — "close enough" is exactly the parity bug class the
    recorder exists to catch), plus placement counts."""
    price = res.total_price()
    return {
        "nodes": res.node_count(),
        "price": round(price, 4),
        "price_hex": float(price).hex(),
        "existing_assignments": len(res.existing_assignments),
        "unschedulable": len(res.unschedulable),
    }


class FlightRecord:
    __slots__ = ("seq", "ts", "pid", "kind", "trace_id", "catalog",
                 "fingerprint", "pods", "groups", "knobs", "phase_ms",
                 "delta", "retraces", "device_memory_peak_bytes",
                 "result", "capture")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.get(name))

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


class FlightRecorder:
    """Bounded ring + optional JSONL spill.  One per process
    (module-level RECORDER); thread-safe — the operator's solve path,
    the solverd batcher thread, and the dashboard reader all touch it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self._buffer_size())
        self._seq = 0
        # captures number themselves: predicting the NEXT record seq
        # would collide under concurrent solves (and stall at 1 if the
        # ring gate ever diverged from the capture gate)
        self._capture_seq = 0
        self._spill = None          # (path, file handle) once opened
        self._spill_failed = False  # one warning, then best-effort off

    @staticmethod
    def _buffer_size() -> int:
        try:
            return max(1, int(os.environ.get(_ENV_BUFFER, "256")))
        except ValueError:
            return 256

    @property
    def enabled(self) -> bool:
        return recording_enabled()

    def capture_enabled(self) -> bool:
        """Full problem capture: opt-in, needs a spill directory, and
        requires the recorder itself on — a capture no record ever
        references is an orphan artifact, not a repro."""
        from karpenter_tpu_torch.utils.knobs import env_bool
        return (self.enabled
                and env_bool(_ENV_CAPTURE)
                and bool(os.environ.get(_ENV_DIR)))

    def record(self, **fields) -> Optional[FlightRecord]:
        if not self.enabled:
            return None
        with self._lock:
            self._seq += 1
            # capture-side provenance stamp: every digest/fingerprint
            # canonicalization excludes ts (and pid)
            rec = FlightRecord(seq=self._seq, ts=time.time(),
                               pid=os.getpid(), **fields)
            self._ring.append(rec)
        self._maybe_spill(rec)
        return rec

    def capture_problem(self, payload, force: bool = False) -> Optional[str]:
        """Pickle the full problem next to the spill file; returns the
        capture path (referenced from the record) or None.  Called by
        the solver BEFORE the solve runs, so a crash mid-solve still
        leaves the input on disk — the black-box discipline.

        ``force=True`` (the shadow-audit divergence path) captures even
        when the per-solve KARPENTER_TPU_FLIGHT_CAPTURE opt-in is off:
        a detected divergence is exactly the problem worth a repro
        artifact, and waiting for the operator to re-arm capture means
        hoping it recurs.  A spill directory is still required — there
        is nowhere else to put the artifact."""
        if force:
            if not (self.enabled and os.environ.get(_ENV_DIR)):
                return None
        elif not self.capture_enabled():
            return None
        import pickle
        d = os.environ.get(_ENV_DIR)
        try:
            os.makedirs(d, exist_ok=True)
            with self._lock:
                self._capture_seq += 1
                seq = self._capture_seq
            path = os.path.join(d, f"capture-{os.getpid()}-{seq}.pkl")
            with open(path, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            return path
        except OSError:
            return None

    def _maybe_spill(self, rec: FlightRecord) -> None:
        d = os.environ.get(_ENV_DIR)
        if not d or self._spill_failed:
            return
        line = json.dumps(rec.to_dict(), default=str)
        try:
            with self._lock:
                path = os.path.join(d, f"flight-{os.getpid()}.jsonl")
                if self._spill is None or self._spill[0] != path:
                    os.makedirs(d, exist_ok=True)
                    if self._spill is not None:
                        self._spill[1].close()
                    self._spill = (path, open(path, "a", encoding="utf-8"))
                f = self._spill[1]
                f.write(line + "\n")
                f.flush()
        except OSError:
            # spill is best-effort: a full disk must degrade the black
            # box to ring-only, never fail a solve — but counted, so a
            # fleet losing its on-disk tail shows on a dashboard
            metrics.SPILL_DEGRADED.inc(recorder="flight")
            self._spill_failed = True

    def tail(self, n: int = 32,
             trace_id: Optional[str] = None) -> List[dict]:
        if n <= 0:
            return []  # recs[-0:] would be the whole ring, not nothing
        with self._lock:
            recs = list(self._ring)
        if trace_id is not None:
            recs = [r for r in recs if r.trace_id == trace_id]
        return [r.to_dict() for r in recs[-n:]]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def last_seq(self) -> Optional[int]:
        """The newest record's sequence number, or None while empty —
        the cross-link the decision ledger stamps so a ledger row jumps
        to the flight record of the solve that backed it."""
        with self._lock:
            return self._seq if self._seq else None

    def reset(self) -> None:
        """Clear the ring and close any spill handle (tests)."""
        with self._lock:
            self._ring = deque(maxlen=self._buffer_size())
            self._seq = 0
            self._capture_seq = 0
            if self._spill is not None:
                try:
                    self._spill[1].close()
                except OSError:
                    pass
            self._spill = None
            self._spill_failed = False


RECORDER = FlightRecorder()


def load_records(path: str, prefix: str = "flight") -> List[dict]:
    """Parse one spilled <prefix>-<pid>.jsonl, or — when `path` is a
    DIRECTORY — stitch every <prefix>-*.jsonl in it, ordered by
    (mtime, name): each process lifetime leaves its own per-pid spill,
    and a restart replay must see the whole sequence in the order the
    segments were written, with the filename as the deterministic
    tie-break (an unsorted listdir would make the order depend on the
    filesystem).
    Malformed lines (a torn write from a crashed process — exactly when
    the file matters most) are skipped, not fatal."""
    if os.path.isdir(path):
        spills = sorted(
            (os.path.join(path, f) for f in os.listdir(path)
             if f.startswith(prefix + "-") and f.endswith(".jsonl")),
            key=lambda p: (os.path.getmtime(p), p))
        out: List[dict] = []
        for p in spills:
            out.extend(load_records(p))
        return out
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
