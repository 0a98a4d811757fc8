"""Rewind engine: replay a timeline against a live control plane.

Takes an ordered event stream — recorded (`timeline/recorder.py` spill)
or synthetic (`timeline/generators.py`) — and re-runs it against a real
Environment, either stepped deterministically by the engine ("manager"
driver: fake-clock set + `env.settle()` per tick — the driver seek
bit-identity is defined on) or through a real Operator's watch-driven
run loop ("operator" driver: the end-to-end benchmark and smoke mode).
The trajectory invariant auditors (`timeline/invariants.py`) ride
along: gang
atomicity and priority inversions on every solve via the SolveProbe,
the shadow audit sampler forced to rate=1, and ledger-hex-exactness +
lost-pod reconciliation at the end.

Checkpoint/seek: the stream is batched into ticks (events sharing one
`at`); after every tick both drivers are at a well-defined state, so a
checkpoint at event count k (snapped to its tick boundary) digests
identically whether reached by straight-line replay or by `seek` —
replay events [0..k) on a fresh environment, digest, compare
bit-for-bit.

The port's copy of `karpenter_tpu/timeline/rewind.py`.  The engine takes
a `device` ("cuda", the card, by default; the tests pass "cpu") for its
Environment's solver.  On the card a failed device solve raises rather
than fall back to the oracle (an armed `solver.dispatch` fault — the
stream's worker crash — included); the operator driver's Operator logs
it as a `ReconcileError` and retries at its next resync, and the manager
driver does the same: it records the error and settles the tick again.
So after a crash tick the card's trajectory may differ from the JAX
package's, where the oracle answers that tick.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from karpenter_tpu_torch.timeline import events as ev
from karpenter_tpu_torch.timeline import invariants as inv

_BASE_CLOCK = 1_000_000.0  # FakeClock's own default start
# settle attempts a manager-driver tick gets when a reconcile raises
_SETTLE_ATTEMPTS = 3


def normalize(events: List[dict]) -> List[dict]:
    """Sort a stream by replay offset.  Synthetic events carry `at`
    already; recorded spills carry wall `ts` — rebased so the first
    event is at 0.  Store observations other than pod add/delete are
    dropped (they are the controllers' own output; replaying them
    would double-apply), with pods promoted to drive events."""
    out = []
    ts0 = None
    for e in events:
        if not isinstance(e, dict) or "kind" not in e:
            continue
        kind = e["kind"]
        at = e.get("at")
        if at is None:
            ts = e.get("ts")
            if ts is None:
                continue
            if ts0 is None:
                ts0 = float(ts)
            at = float(ts) - ts0
        if ev.is_store(kind):
            if kind == ev.store_event("pods", "added"):
                kind = ev.POD_ADD
            elif kind == ev.store_event("pods", "deleted"):
                kind = ev.POD_REMOVE
            else:
                continue
        out.append({"at": float(at), "kind": kind,
                    "name": e.get("name", ""), "data": e.get("data")})
    out.sort(key=lambda x: (x["at"], x["kind"], x["name"]))
    return out


def ticks_of(events: List[dict]) -> List[List[dict]]:
    """Group consecutive events sharing one `at` into ticks — the
    settle/checkpoint granularity."""
    ticks: List[List[dict]] = []
    for e in events:
        if ticks and ticks[-1][0]["at"] == e["at"]:
            ticks[-1].append(e)
        else:
            ticks.append([e])
    return ticks


def make_pod(name: str, data: Optional[dict]):
    """Invert `recorder.pod_spec` (dense `requests` vector) or a
    generator's readable request map (`cpu`/`memory` strings) into a
    Pod ready for `cluster.pods.create`."""
    from karpenter_tpu_torch.models import ObjectMeta, Pod
    from karpenter_tpu_torch.models.resources import Resources
    data = data or {}
    if data.get("requests"):
        req = Resources(v=[float(x) for x in data["requests"]])
    else:
        req = Resources.parse({"cpu": data.get("cpu", "250m"),
                               "memory": data.get("memory", "512Mi")})
    return Pod(meta=ObjectMeta(name=name,
                               labels=dict(data.get("labels") or {}),
                               annotations=dict(
                                   data.get("annotations") or {})),
               requests=req)


class RewindEngine:
    """One replay run: fresh Environment, probed solver, armed shadow
    audit, timeline re-recording ON (a replay leaves its own recorded
    timeline — the recorder is part of what's being exercised)."""

    def __init__(self, events: List[dict], *,
                 options=None, catalog_spec=None, audit: bool = True,
                 settle_rounds: int = 80,
                 resolution: Optional[float] = None, device="cuda"):
        self.events = normalize(events)
        if resolution:
            # replay frame rate: quantize offsets down to `resolution`
            # seconds so a dense stream (every arrival at its own
            # millisecond) batches into a bounded number of ticks —
            # each tick is one settle/quiesce, and THAT is the wall
            # cost of replay, not the event count.  Deterministic, and
            # identical for straight-line and seek runs (both quantize
            # before ticks are formed), so bit-identity is preserved.
            self.events = [
                dict(e, at=(e["at"] // resolution) * resolution)
                for e in self.events]
            self.events.sort(key=lambda x: (x["at"], x["kind"],
                                            x["name"]))
        self.ticks = ticks_of(self.events)
        self.audit = audit
        self.settle_rounds = settle_rounds
        self._catalog_spec = catalog_spec
        self._options = options
        self.device = device
        # reconcile passes of the manager driver that raised (each
        # settled again)
        self.reconcile_errors = 0
        self.auditor = inv.TrajectoryAuditor()
        # serializes the engine's event-apply loop against the probed
        # solver's solve+audit window (see SolveProbe.solve): a tick is
        # applied atomically with respect to any in-flight solve
        self._world_lock = threading.RLock()
        self.env = None
        self.operator = None  # the operator driver's Operator
        self.skipped: Dict[str, int] = {}

    # -- environment -------------------------------------------------------
    def _build_env(self):
        from karpenter_tpu_torch.env import Environment
        from karpenter_tpu_torch.models import NodePool, ObjectMeta
        from karpenter_tpu_torch.operator.options import Options
        from karpenter_tpu_torch.utils.clock import FakeClock
        opts = self._options or Options(batch_idle_duration=0)
        env = Environment(clock=FakeClock(), options=opts,
                          catalog_spec=self._catalog_spec,
                          device=self.device)
        env.add_default_nodeclass()
        env.cluster.nodepools.create(
            NodePool(meta=ObjectMeta(name="default")))
        probe = inv.SolveProbe(env.solver, self.auditor,
                               world_lock=self._world_lock)
        # all three references point at ONE shared GatedSolver — the
        # probe must replace every alias or a path escapes the judges
        env.solver = probe
        env.provisioner.solver = probe
        env.disruption.solver = probe
        self.env = env
        return env

    # -- event application -------------------------------------------------
    def _skip(self, why: str) -> None:
        self.skipped[why] = self.skipped.get(why, 0) + 1

    def _live_spot_ids(self) -> List[str]:
        cloud = self.env.cloud
        return sorted(
            iid for iid, inst in cloud.instances.items()
            if inst.capacity_type == "spot" and not inst.interrupted
            and inst.state == "running")

    def apply(self, e: dict) -> None:
        """Apply ONE drive event to the live environment."""
        kind, name, data = e["kind"], e["name"], e.get("data") or {}
        cluster = self.env.cluster
        if kind == ev.POD_ADD:
            if cluster.pods.get(name) is not None:
                self._skip("pod_add_duplicate")
                return
            cluster.pods.create(make_pod(name, data))
            self.auditor.expected_pods.add(name)
        elif kind == ev.POD_REMOVE:
            self.auditor.expected_pods.discard(name)
            if cluster.pods.get(name) is None:
                self._skip("pod_remove_unknown")
                return
            cluster.pods.delete(name)
        elif kind == ev.SPOT_RECLAIM:
            spot = self._live_spot_ids()
            if not spot:
                self._skip("spot_reclaim_no_capacity")
                return
            pick = data.get("pick")
            iid = data.get("instance_id")
            if iid not in spot:
                iid = spot[int(pick or 0) % len(spot)]
            self.env.cloud.interrupt_spot(iid)
        elif kind == ev.PRICE_REFRESH:
            self.env.pricing.update()
        elif kind in (ev.FAULT_INJECT, ev.WORKER_CRASH):
            from karpenter_tpu_torch.utils import faults
            faults.arm(data.get("point", "solver.dispatch"),
                       data.get("mode", "error"),
                       arg=data.get("arg"),
                       times=data.get("times", 1),
                       after=int(data.get("after", 0) or 0))
        elif kind == ev.WORKER_RESTART:
            from karpenter_tpu_torch.utils import faults
            faults.disarm()
        elif kind in (ev.GANG_ARRIVAL, ev.PRIORITY_ARRIVAL,
                      ev.CHECKPOINT):
            pass  # scenario markers — bookkeeping, not inputs
        else:
            self._skip(f"unknown_kind:{kind}")

    # -- drivers -----------------------------------------------------------
    def _drive_manager(self, checkpoint_at, stop_after):
        """Deterministic single-thread driver: per tick, set the fake
        clock to the tick's offset, apply its events, settle to a fixed
        point.  The driver seek bit-identity is defined on."""
        clock = self.env.clock
        checkpoints: Dict[int, str] = {}
        applied = 0
        for tick in self.ticks:
            if stop_after is not None and applied >= stop_after:
                break
            clock.set(_BASE_CLOCK + tick[0]["at"])
            for e in tick:
                self.apply(e)
                applied += 1
            self._settle()
            for k in checkpoint_at:
                if k not in checkpoints and applied >= k:
                    checkpoints[k] = inv.state_digest(
                        self.env.cluster, self.env.pricing)
        self._settle()
        return applied, checkpoints

    def _settle(self) -> None:
        """`env.settle`, retried when a reconcile raises (a device solve
        on the card that failed): `reconcile_guarded` logs it and records
        a `ReconcileError` event, the pods stay pending, and the tick
        settles again — the operator's retry at its next resync.  The
        error of the last of `_SETTLE_ATTEMPTS` settles propagates."""
        from karpenter_tpu_torch.operator.operator import reconcile_guarded
        from karpenter_tpu_torch.utils.logging import get_logger
        for _ in range(_SETTLE_ATTEMPTS - 1):
            if reconcile_guarded(
                    lambda: self.env.settle(self.settle_rounds),
                    self.env.cluster, get_logger("rewind"), "RewindEngine",
                    "manager", "settling the tick again"):
                return
            self.reconcile_errors += 1
        self.env.settle(self.settle_rounds)

    def _drive_operator(self, checkpoint_at, stop_after, speedup,
                        operator_kw=None):
        """Replay through a REAL Operator: its watch-driven run loop
        reconciles in its own thread while the engine feeds events and
        steps the fake clock.  `speedup` paces wall time (None = as
        fast as the operator drains); convergence per tick is
        generation-stability, not sleep-polling."""
        from karpenter_tpu_torch.operator.operator import Operator
        op = Operator(options=self.env.options, env=self.env,
                      metrics_port=0, health_port=0,
                      reconcile_interval=0.02, **(operator_kw or {}))
        self.operator = op
        t = threading.Thread(target=op.run, daemon=True,
                             name="kt-rewind-operator")
        t.start()
        checkpoints: Dict[int, str] = {}
        applied = 0
        clock = self.env.clock
        try:
            prev_at = self.ticks[0][0]["at"] if self.ticks else 0.0
            for tick in self.ticks:
                if stop_after is not None and applied >= stop_after:
                    break
                if speedup:
                    gap = (tick[0]["at"] - prev_at) / float(speedup)
                    if gap > 0:
                        time.sleep(min(gap, 5.0))
                prev_at = tick[0]["at"]
                # a tick applies atomically w.r.t. the solver: the
                # operator's watch wakes it on the tick's FIRST event,
                # and a solve that encodes mid-tick (then audits
                # against post-tick state) is the one remaining way a
                # phantom divergence can race in
                with self._world_lock:
                    clock.set(_BASE_CLOCK + tick[0]["at"])
                    for e in tick:
                        self.apply(e)
                        applied += 1
                self._quiesce()
                for k in checkpoint_at:
                    if k not in checkpoints and applied >= k:
                        checkpoints[k] = inv.state_digest(
                            self.env.cluster, self.env.pricing)
            self._quiesce(timeout=10.0)
        finally:
            op.stop()
            t.join(timeout=10.0)
        return applied, checkpoints

    def _quiesce(self, timeout: float = 10.0) -> None:
        """Wait for the operator thread to drain the tick: done when no
        pod is left pending AND the cluster generation has held still
        across consecutive observation windows.  Generation stability
        alone is not enough — a first solve (compile included) can hold
        the generation flat for seconds while work is very much in
        flight — so pending pods keep the wait alive until the deadline
        (a crashed-solver window legitimately times out with pods
        pending; the next tick's retry seats them)."""
        deadline = time.monotonic() + timeout
        stable = 0
        cluster = self.env.cluster
        gen = cluster.generation
        while time.monotonic() < deadline:
            time.sleep(0.05)
            pending = any(not p.scheduled and not p.meta.deleting
                          for p in cluster.pods.list())
            g = cluster.generation
            if g == gen and not pending:
                stable += 1
                if stable >= 3:
                    return
            else:
                stable = 0
                gen = g

    # -- entry points ------------------------------------------------------
    def run(self, driver: str = "manager", speedup: Optional[float] = None,
            checkpoint_at=(), stop_after: Optional[int] = None) -> dict:
        from karpenter_tpu_torch.solver import audit as audit_mod
        from karpenter_tpu_torch.utils import faults, ledger
        # arm rate=1 shadow audit through the knob's owner module (it
        # returns the restore callable honoring the prior spelling)
        restore_audit = audit_mod.arm("1") if self.audit else None
        audit_before = inv.audit_series()
        # the hex-exact judge must see EVERY row of this replay — widen
        # the ring past the default 512 unless the caller pinned it
        ledger.ensure_buffer(65536)
        ledger_seq_before = ledger.LEDGER.last_seq() or 0
        self._build_env()
        t0 = time.perf_counter()
        try:
            if driver == "operator":
                applied, checkpoints = self._drive_operator(
                    tuple(checkpoint_at), stop_after, speedup)
            else:
                applied, checkpoints = self._drive_manager(
                    tuple(checkpoint_at), stop_after)
        finally:
            faults.disarm()
            if restore_audit is not None:
                audit_mod.SAMPLER.drain(timeout=60.0)
                restore_audit()
        wall = time.perf_counter() - t0
        audit_after = inv.audit_series()
        # judge only THIS replay's ledger rows (the ring may carry a
        # prior run's history in one process)
        records = [r for r in ledger.LEDGER.tail(1 << 20)
                   if r.get("seq", 0) > ledger_seq_before]
        report = self.auditor.report(
            self.env.cluster, records,
            inv.audit_deltas(audit_before, audit_after))
        cluster = self.env.cluster
        report.update({
            "driver": driver,
            "device": str(self.device),
            "reconcile_errors": (self.operator.reconcile_errors
                                 if self.operator is not None
                                 else self.reconcile_errors),
            "events_total": len(self.events),
            "events_applied": applied,
            "events_skipped": dict(self.skipped),
            "wall_s": round(wall, 3),
            "events_per_s": round(applied / wall, 1) if wall > 0 else None,
            "pods_final": len(cluster.pods.list()),
            "scheduled_final": sum(
                1 for p in cluster.pods.list() if p.scheduled),
            "nodes_final": len(cluster.nodes.list(
                lambda n: not n.meta.deleting)),
            "digest": inv.state_digest(cluster, self.env.pricing),
            "checkpoints": checkpoints,
        })
        report["invariants_held"] = all((
            report["ledger_hex_exact"],
            report["zero_gang_atomicity_violations"],
            report["zero_priority_inversions"],
            report["audit_clean"],
            report["zero_lost_pods"]))
        return report


def replay(events: List[dict], **kw) -> dict:
    """One-shot convenience: build an engine, run, return the report."""
    driver = kw.pop("driver", "manager")
    speedup = kw.pop("speedup", None)
    checkpoint_at = kw.pop("checkpoint_at", ())
    stop_after = kw.pop("stop_after", None)
    return RewindEngine(events, **kw).run(
        driver=driver, speedup=speedup, checkpoint_at=checkpoint_at,
        stop_after=stop_after)


def seek(events: List[dict], k: int, **kw) -> dict:
    """Reconstruct the cluster at event k (snapped to its tick
    boundary): replay [0..k) on a fresh deterministic environment and
    digest.  `seek_check` compares this against the straight-line run's
    checkpoint at the same k — the bit-identity contract."""
    eng = RewindEngine(events, **kw)
    k = snap_to_tick(eng.ticks, k)
    report = eng.run(driver="manager", stop_after=k)
    return {"k": k, "digest": report["digest"], "report": report}


def snap_to_tick(ticks: List[List[dict]], k: int) -> int:
    """Checkpoint granularity is the tick: round k up to the end of the
    tick containing event index k-1 (state mid-tick is not defined —
    the engine settles per tick, not per event)."""
    total = 0
    for tick in ticks:
        total += len(tick)
        if total >= k:
            return total
    return total


def seek_check(events: List[dict], k: int, **kw) -> dict:
    """The acceptance check: straight-line replay with a checkpoint at
    k vs an independent seek to k — digests must match bit-for-bit."""
    eng = RewindEngine(events, **kw)
    k = snap_to_tick(eng.ticks, k)
    straight = eng.run(driver="manager", checkpoint_at=(k,))
    sought = seek(events, k, **kw)
    a = straight["checkpoints"].get(k)
    b = sought["digest"]
    return {"k": k, "straight_digest": a, "seek_digest": b,
            "bit_identical": bool(a) and a == b,
            "straight": straight, "seek": sought["report"]}
