"""Shadow-audit sampler: continuous in-prod solver re-verification.

Solver/oracle parity is asserted exhaustively in tests — but only
there.  This module closes the loop on LIVE traffic, the
shadow-scoring discipline production packers audit themselves with:
``KARPENTER_TPU_AUDIT=<rate>`` samples real solves at the solver's
`solve()` seam and re-verifies each sampled problem on a background
thread:

  * **oracle parity** — the sampled ScheduleInput re-solves through the
    reference CPU oracle; bit-exact digests (node count + IEEE-hex
    price) are verdict ``match``, a strictly better solver answer
    (cheaper, or fewer strands at equal cost) is ``improved``, anything
    worse is ``diverged``;
  * **delta parity** — a pass that engaged the incremental delta path
    additionally re-solves FULL (a dedicated single-device, delta-off
    solver on the live solver's device: on the card a second K5 launch)
    and must be bit-identical; a mismatch is ``diverged``
    regardless of what the oracle said — the delta contract is
    exactness, not optimality;
  * **divergence capture** — a diverged verdict force-captures the
    problem through the flight recorder (``KARPENTER_TPU_FLIGHT_DIR``
    required; the per-solve CAPTURE opt-in is bypassed — a detected
    divergence is precisely the problem worth an artifact) and writes a
    ``kind="audit"`` flight record carrying the LIVE digest and the
    capture, from which the divergence reproduces bit-for-bit.

Verdicts export as ``karpenter_tpu_solver_audit_total{verdict}``
(match/improved/diverged/dropped/error).

Grammar (parsed HERE — the knob-registry single-owner rule):
``KARPENTER_TPU_AUDIT`` unset/``off``/``0`` disables; ``on``/``true``
arms at DEFAULT_RATE; a float in (0, 1] is the sampling rate (1.0 =
audit every solve — acceptance territory; the oracle re-solve is
O(pods), so production wants a small rate).  Malformed values degrade
to disabled, never crash.

Sampling is deterministic (a rate accumulator, not randomness): at
rate r every ⌈1/r⌉-th eligible solve is audited, so tests and
benchmarks can reason about exactly which solves were sampled.  Only REAL
solves are eligible — consolidation simulations (an explicit
``max_nodes`` cap) strand by design and the oracle does not model the
cap, so auditing them would manufacture divergences.

The worker holds a bounded backlog (an audit is O(pods) of oracle
time); overflow is counted as verdict ``dropped``, never silently
skipped and never backpressure on the solve path.  Tests run with the
knob scrubbed and the sampler reset around every test — the same
never-armed discipline as the fault harness.

Fault hook: ``solver.audit.digest`` (utils/faults.py) perturbs the
live digest before comparison — the injected-divergence lever the
fault matrix uses to prove the diverged → capture → replay loop works
without waiting for a real parity bug.

The port's copy of `karpenter_tpu/solver/audit.py`: the live solver is a
`TorchSolver`, and the full re-solve runs on that solver's device.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Optional

from karpenter_tpu_torch.utils import faults, metrics

_ENV = "KARPENTER_TPU_AUDIT"
DEFAULT_RATE = 0.01  # the "on" spelling's rate: 1 in 100 solves

VERDICT_MATCH = "match"
VERDICT_IMPROVED = "improved"
VERDICT_DIVERGED = "diverged"
VERDICT_DROPPED = "dropped"
VERDICT_ERROR = "error"

_BACKLOG = 4  # audits queued before overflow counts as dropped


def sample_rate() -> float:
    """The armed sampling rate in [0, 1]; 0.0 = disabled.  Re-read per
    solve (an env dict get — the flight recorder's flip-without-restart
    discipline)."""
    raw = os.environ.get(_ENV, "").strip().lower()
    if raw in ("", "off", "0", "false", "no", "none"):
        return 0.0
    if raw in ("on", "true", "yes", "1"):
        # "1" reads as "fully on" (as "1.0" does); "on"/"true"/"yes"
        # arm the sampled default
        return 1.0 if raw == "1" else DEFAULT_RATE
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    if rate <= 0.0:
        return 0.0
    return min(rate, 1.0)


def arm(rate: str = "1"):
    """Arm the sampler at `rate` (this knob's own grammar — "1" is
    rate=1.0) and return a zero-arg restore callable honoring whatever
    spelling was armed before.  The ONE place KARPENTER_TPU_AUDIT is
    written programmatically (env-knob ownership): the rewind engine
    forces rate=1 for a replay and must put the operator's setting
    back afterwards."""
    prior = os.environ.get(_ENV)
    os.environ[_ENV] = rate

    def restore() -> None:
        if prior is None:
            os.environ.pop(_ENV, None)
        else:
            os.environ[_ENV] = prior
    return restore


class _Job:
    __slots__ = ("inp", "digest", "delta_engaged", "max_nodes",
                 "solver_max_nodes", "device", "trace_id")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.get(name))


class AuditSampler:
    """Per-process sampler + background verifier (module-level
    SAMPLER).  The solve path pays one env read and, when armed, a
    digest + enqueue; everything O(pods) happens on the worker
    thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._acc = 0.0             # deterministic rate accumulator
        self._queue: deque = deque()
        self._wake = threading.Condition(self._lock)
        self._worker: Optional[threading.Thread] = None
        # per-worker stop event: reset() sets the CURRENT worker's event
        # and abandons it — a verification that outlives the join
        # timeout exits on its own event without racing a replacement
        # worker or counting verdicts into post-reset state
        self._stop_ev = threading.Event()
        self._resolver = None       # lazy full-re-solve TorchSolver
        self._inflight = 0          # popped but not yet verified
        self.audits = 0             # completed verifications (tests)

    # -- the solve-path seam ----------------------------------------------
    def maybe_submit(self, inp, res, solver, max_nodes=None) -> bool:
        """Called at the end of every `TorchSolver.solve()`.  Returns True
        when this solve was sampled.  Never raises and never blocks —
        the audit must cost the solve path nothing measurable."""
        try:
            # the audit's OWN full re-solve runs through the same
            # TorchSolver.solve seam — sampling it would audit the
            # auditor recursively (and double-count every verdict)
            if getattr(solver, "_audit_exempt", False):
                return False
            rate = sample_rate()
            if rate <= 0.0 or max_nodes is not None:
                return False
            with self._lock:
                self._acc += rate
                if self._acc < 1.0:
                    return False
                self._acc -= 1.0
            from karpenter_tpu_torch.utils import flightrecorder as fr
            from karpenter_tpu_torch.utils import tracing
            cache = getattr(solver, "_delta_cache", None)
            job = _Job(
                inp=inp, digest=fr.result_digest(res),
                delta_engaged=(getattr(cache, "last_outcome", None)
                               == "delta"),
                max_nodes=max_nodes,
                solver_max_nodes=getattr(solver, "max_nodes", 2048),
                device=str(getattr(solver, "device", "cuda")),
                trace_id=tracing.current_trace_id())
            with self._lock:
                if len(self._queue) >= _BACKLOG:
                    metrics.SOLVER_AUDIT.inc(verdict=VERDICT_DROPPED)
                    return False
                self._queue.append(job)
                self._ensure_worker()
                self._wake.notify()
            return True
        except Exception:  # noqa: BLE001 — the audit must never cost a solve
            return False

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        ev = self._stop_ev = threading.Event()
        self._worker = threading.Thread(
            target=self._run, args=(ev,), name="solver-audit",
            daemon=True)
        self._worker.start()

    # -- the background verifier ------------------------------------------
    def _run(self, stop_ev: threading.Event) -> None:
        while True:
            with self._lock:
                while not self._queue and not stop_ev.is_set():
                    self._wake.wait(timeout=1.0)
                if stop_ev.is_set():
                    return
                job = self._queue.popleft()
                self._inflight += 1
            try:
                verdict = self._verify(job)
            except Exception:  # noqa: BLE001 — a broken audit is a verdict
                verdict = VERDICT_ERROR
            with self._lock:
                if stop_ev.is_set():
                    # abandoned mid-verify by a reset(): the reset
                    # already zeroed _inflight, and the verdict must
                    # not count into post-reset state
                    continue
                # verdict metric BEFORE _inflight drops: drain() polls
                # queue/_inflight, and a post-lock inc would let it
                # return with the counter not yet moved
                metrics.SOLVER_AUDIT.inc(verdict=verdict)
                self._inflight -= 1
                self.audits += 1

    def _full_resolver(self, device: str):
        """The dedicated full-re-solve solver for delta parity: single
        device, delta off, recorder-visible, on the live solver's device
        (on the card its solve is a second K5 launch).  Lazy: never built
        unless a delta pass is actually sampled."""
        if self._resolver is None or str(self._resolver.device) != device:
            from karpenter_tpu_torch.solver.solve import TorchSolver
            self._resolver = TorchSolver(max_nodes=2048, device=device,
                                         mesh="off", delta="off")
            self._resolver._audit_exempt = True  # never audit the auditor
            # pin the RESOLVED modes, not just the constructed specs:
            # the KARPENTER_TPU_DELTA/MESH rollback knobs override the
            # constructor arguments (that is their whole point), and
            # under KARPENTER_TPU_DELTA=on the "full re-solve" would
            # engage the delta path on its own warm cache — comparing
            # delta output to delta output, blind to exactly the
            # divergence class this baseline exists to catch
            self._resolver._delta_resolved = False
            self._resolver._mesh_resolved = True  # leaves _mesh = None
        return self._resolver

    def _verify(self, job: _Job) -> str:
        from karpenter_tpu_torch.utils import flightrecorder as fr
        live = dict(job.digest)
        # injected-divergence lever (fault matrix): perturb the live
        # digest so the diverged → capture → replay loop is provable
        # without a real parity bug
        try:
            faults.fire("solver.audit.digest")
        except faults.FaultInjected:
            live["nodes"] = (live.get("nodes") or 0) + 1
            live["price_hex"] = float(
                (live.get("price") or 0.0) + 1.0).hex()

        diverged = False
        detail = {}
        if job.delta_engaged:
            solver = self._full_resolver(job.device)
            solver.max_nodes = max(solver.max_nodes,
                                   job.solver_max_nodes or 0)
            full = fr.result_digest(solver.solve(job.inp))
            detail["full"] = full
            if (full["nodes"] != live["nodes"]
                    or full["price_hex"] != live["price_hex"]
                    or full["unschedulable"] != live["unschedulable"]):
                diverged = True

        from karpenter_tpu_torch.scheduling import Scheduler
        oracle = fr.result_digest(Scheduler(job.inp).solve())
        detail["oracle"] = oracle
        verdict = VERDICT_DIVERGED if diverged else \
            self._classify(live, oracle)
        if verdict == VERDICT_DIVERGED:
            # which tripwire fired decides the debugging path: the
            # delta full-resolve compare points at the seeded-scan
            # replay, the oracle compare at device-vs-host parity
            detail["tripwire"] = ("delta-full-resolve" if diverged
                                  else "oracle")
            self._capture_divergence(job, live, detail)
        return verdict

    @staticmethod
    def _classify(live: dict, oracle: dict) -> str:
        if (live["nodes"] == oracle["nodes"]
                and live["price_hex"] == oracle["price_hex"]
                and live["unschedulable"] == oracle["unschedulable"]):
            return VERDICT_MATCH
        # compare the EXACT prices (the hex form), never the digest's
        # display-rounded `price` field: a sub-rounding divergence is
        # precisely the parity class the audit exists to catch, and the
        # rounded compare would call it "improved"
        def exact(d):
            hx = d.get("price_hex")
            try:
                return float.fromhex(hx)
            except (TypeError, ValueError):
                return d.get("price", 0.0)
        live_p, oracle_p = exact(live), exact(oracle)
        if live["unschedulable"] <= oracle["unschedulable"] and (
                live_p < oracle_p
                or (live_p == oracle_p
                    and live["nodes"] <= oracle["nodes"])
                or live["unschedulable"] < oracle["unschedulable"]):
            # fewer strands always beats the oracle's coverage, even at
            # higher spend — placing more pods legitimately costs more
            return VERDICT_IMPROVED
        return VERDICT_DIVERGED

    def _capture_divergence(self, job: _Job, live: dict,
                            detail: dict) -> None:
        """Force-capture the diverged problem + write the audit flight
        record referencing it, so the capture (or the JSONL record)
        reproduces the divergence on any desk.  Best-effort: no
        spill dir means no artifact, never an audit crash."""
        from karpenter_tpu_torch.utils import flightrecorder as fr
        path = fr.RECORDER.capture_problem(
            {"inp": job.inp, "max_nodes": job.max_nodes,
             "solver_max_nodes": job.solver_max_nodes}, force=True)
        fr.RECORDER.record(
            kind="audit", trace_id=job.trace_id,
            pods=len(job.inp.pods), knobs={"audit": sample_rate()},
            delta={"engaged": job.delta_engaged,
                   "tripwire": detail.get("tripwire")},
            result=live, capture=path,
            phase_ms={}, retraces=0,
            device_memory_peak_bytes=0,
            catalog=None, fingerprint=None, groups=None)
        from karpenter_tpu_torch.utils.logging import get_logger
        get_logger("solver").warn(
            "shadow audit divergence",
            tripwire=detail.get("tripwire"),
            live_nodes=live.get("nodes"),
            oracle_nodes=detail.get("oracle", {}).get("nodes"),
            full_nodes=detail.get("full", {}).get("nodes"),
            capture=path or "unavailable (set KARPENTER_TPU_FLIGHT_DIR)")

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> None:
        """Block until the backlog is empty and no verification is in
        flight (tests, benchmarks)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._queue) or self._inflight > 0
            if not busy:
                return
            _time.sleep(0.01)

    def backlog(self) -> int:
        with self._lock:
            return len(self._queue)

    def reset(self) -> None:
        """Stop the worker, clear the backlog and the accumulator
        (tests — an autouse disarm).  A worker stuck in a
        long verification past the join timeout is ABANDONED, not
        resurrected: its own stop event stays set, so it exits at the
        next loop check without counting its verdict or draining the
        replacement worker's queue."""
        with self._lock:
            self._stop_ev.set()
            self._queue.clear()
            self._acc = 0.0
            self._wake.notify_all()
            worker = self._worker
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            worker.join(timeout=5.0)
        with self._lock:
            self._worker = None
            self._stop_ev = threading.Event()
            self._resolver = None
            self._inflight = 0
            self.audits = 0


SAMPLER = AuditSampler()
