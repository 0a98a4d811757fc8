"""Trajectory invariant auditors for timeline replay.

A replayed timeline is only a benchmark if something can FAIL it.
This module holds the judges the rewind engine runs continuously:

  * **gang atomicity** — every solve's result through the shared
    `gang_placement_audit` (the ONE implementation the gang tests
    already trust): no partial placement, no
    cross-domain adjacency split, ever, across the whole trajectory.
  * **priority inversions** — every solve through
    `priority_inversion_audit` with the result's attached preemption
    plans: a stranded high-priority pod whose seat one eviction could
    free is a trajectory failure, not a log line.
  * **ledger-hex-exact cost trajectory** — every ledger row's
    `fleet_cost_after` must equal `before + cost_delta` bit-for-bit
    (IEEE hex compare, not an epsilon) and `cost_delta_hex` must match
    its float re-encoded: the fleet $/hr chain never breaks.
  * **audit-clean solves** — with the shadow sampler at rate=1, the
    diverged/error verdict counters must not move during replay.
  * **zero lost pods** — set reconciliation between what the timeline
    fed in (adds minus removes) and what the cluster holds at the end:
    a silently-dropped pod is the one failure mode no per-solve check
    can see.

The solve-level judges attach via `SolveProbe`, a transparent wrapper
around the shared GatedSolver (env.solver / provisioner.solver /
disruption.solver all point at the same instance, so the engine
re-points all three).

The port's copy of `karpenter_tpu/timeline/invariants.py`.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Optional


class SolveProbe:
    """Transparent GatedSolver wrapper feeding every solve (and every
    consumed batch simulation) to the auditor.  `__getattr__` forwards
    everything else (warmup, feature gates, delta feed wiring) so the
    controllers can't tell they're probed."""

    def __init__(self, inner, auditor: "TrajectoryAuditor",
                 world_lock: Optional[threading.RLock] = None):
        self._inner = inner
        self._auditor = auditor
        # shared with the rewind engine's event-apply loop: nothing may
        # mutate the cluster between the live solve's encode and the
        # drained oracle re-solve below, or the oracle judges a world
        # the live solve never saw
        self._world = world_lock if world_lock is not None \
            else threading.RLock()

    def solve(self, inp, source: str = "solver",
              max_nodes: Optional[int] = None):
        # the whole solve+audit window runs under the world lock, and
        # the shadow sampler drains BEFORE the caller acts on the
        # result: the sampler's oracle re-solve reads live cluster
        # objects through inp (ExistingNode.node taints, resident-pod
        # lists), and replay compresses hours of churn into seconds —
        # a pod marked deleting (or a node tainted) by the rewind
        # thread anywhere between the live encode and the async
        # worker's re-solve makes the oracle call the difference a
        # divergence.  Lock + drain pin the oracle to the exact state
        # the live solve encoded, so a diverged verdict during replay
        # is a real parity break, not a race artifact.
        with self._world:
            res = self._inner.solve(inp, source=source,
                                    max_nodes=max_nodes)
            self._auditor.on_solve(inp, res)
            from karpenter_tpu_torch.solver.audit import (
                SAMPLER,
                sample_rate,
            )
            if sample_rate() > 0.0:
                SAMPLER.drain(timeout=60.0)
        return res

    def solve_batch(self, inps, source: str = "disruption",
                    max_nodes: Optional[int] = None):
        # batch simulations are what-if probes (consolidation's
        # candidate axis), not committed placements: the atomicity /
        # inversion judges only score results a controller acts on, so
        # the batch passes through unprobed.
        return self._inner.solve_batch(inps, source=source,
                                       max_nodes=max_nodes)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class TrajectoryAuditor:
    """Accumulates violations across a replay; `report()` renders the
    invariant booleans a benchmark record and a smoke check assert."""

    def __init__(self):
        self._lock = threading.Lock()
        self.solves = 0
        self.gang_violations: List[dict] = []
        self.priority_inversions: List[dict] = []
        # expected pod universe, maintained by the rewind engine:
        # pod.add inserts, pod.remove (and observed completions the
        # engine itself initiates) discards
        self.expected_pods: set = set()

    # -- solve-level judges (called from SolveProbe, solver thread) ----
    def on_solve(self, inp, res) -> None:
        if res is None:
            return
        from karpenter_tpu_torch.scheduling.types import (
            gang_placement_audit, priority_inversion_audit)
        with self._lock:
            self.solves += 1
        try:
            audit = gang_placement_audit(inp, res)
        except Exception:
            audit = {}
        for gname, entry in audit.items():
            bad = entry["placed"] not in (0, entry["total"])
            if not bad and entry["placed"] and \
                    entry["spec"].domain_key is not None:
                bad = bool(entry["unpinned"]) or len(entry["domains"]) > 1
            if bad:
                with self._lock:
                    self.gang_violations.append({
                        "gang": gname, "total": entry["total"],
                        "placed": entry["placed"],
                        "stranded": entry["stranded"],
                        "domains": sorted(map(str, entry["domains"])),
                        "unpinned": entry["unpinned"]})
        try:
            inversions = priority_inversion_audit(
                inp, res, getattr(res, "preemptions", ()) or ())
        except Exception:
            inversions = []
        if inversions:
            with self._lock:
                self.priority_inversions.extend(inversions)

    # -- trajectory-level judges ---------------------------------------
    @staticmethod
    def ledger_check(records: List[dict]) -> dict:
        """Hex-exact chain over ledger record dicts (ring tail or spill
        load): after == before + delta bit-for-bit, and the recorded
        cost_delta_hex round-trips its float."""
        broken = []
        checked = 0
        for r in records:
            delta = r.get("cost_delta")
            hexed = r.get("cost_delta_hex")
            if delta is not None and hexed and \
                    float(delta).hex() != hexed:
                broken.append({"seq": r.get("seq"),
                               "why": "cost_delta_hex mismatch"})
                continue
            before, after = r.get("fleet_cost_before"), \
                r.get("fleet_cost_after")
            if before is None or after is None or delta is None:
                continue
            checked += 1
            want = float(before) + float(delta)
            if float(after).hex() != want.hex():
                broken.append({"seq": r.get("seq"),
                               "why": "after != before + delta",
                               "after": float(after).hex(),
                               "want": want.hex()})
        return {"records": len(records), "checked": checked,
                "broken": broken, "exact": not broken}

    def lost_pods(self, cluster) -> List[str]:
        """Expected-universe reconciliation: every pod the timeline fed
        in and never removed must still exist in the cluster (pending
        OR scheduled — stranded is visible, vanished is the bug)."""
        with self._lock:
            expected = set(self.expected_pods)
        live = {p.meta.name for p in cluster.pods.list()}
        return sorted(expected - live)

    def report(self, cluster, ledger_records: List[dict],
               audit_deltas: Dict[str, int]) -> dict:
        ledger = self.ledger_check(ledger_records)
        lost = self.lost_pods(cluster)
        diverged = audit_deltas.get("diverged", 0)
        errored = audit_deltas.get("error", 0)
        with self._lock:
            gang = list(self.gang_violations)
            inv = list(self.priority_inversions)
            solves = self.solves
        return {
            "solves": solves,
            "ledger_hex_exact": ledger["exact"],
            "ledger_rows_checked": ledger["checked"],
            "ledger_breaks": ledger["broken"][:8],
            "zero_gang_atomicity_violations": not gang,
            "gang_violations": gang[:8],
            "zero_priority_inversions": not inv,
            "priority_inversions": inv[:8],
            "audit_clean": diverged == 0 and errored == 0,
            "audit_verdict_deltas": dict(audit_deltas),
            "zero_lost_pods": not lost,
            "lost_pods": lost[:16],
        }


def audit_series() -> Dict[str, float]:
    """Snapshot of the shadow-audit verdict counters, by verdict label
    — subtract two snapshots to get the replay's own deltas."""
    from karpenter_tpu_torch.utils import metrics
    vals = getattr(metrics.SOLVER_AUDIT, "_values", None)
    if vals is None:
        return {}
    with metrics.SOLVER_AUDIT._lock:
        items = list(vals.items())
    return {"/".join(k) if k else "": v for k, v in items}


def audit_deltas(before: Dict[str, float],
                 after: Dict[str, float]) -> Dict[str, int]:
    return {k: int(after.get(k, 0) - before.get(k, 0))
            for k in sorted(set(before) | set(after))}


def state_digest(cluster, pricing=None) -> str:
    """Canonical sha256 of the cluster's schedulable state: sorted
    pods (name, node, phase), nodes (name, instance labels that matter
    to packing), claims (name, instance type, capacity type, zone,
    phase), plus the fleet $/hr in IEEE hex when pricing is given.
    Two replays that agree here reconstructed the SAME cluster —
    the seek/checkpoint bit-identity contract."""
    from karpenter_tpu_torch.models import wellknown
    pods = sorted(
        (p.meta.name, p.node_name or "", p.phase)
        for p in cluster.pods.list())
    nodes = sorted(
        (n.meta.name,
         n.labels.get(wellknown.INSTANCE_TYPE_LABEL, ""),
         n.labels.get(wellknown.CAPACITY_TYPE_LABEL, ""),
         n.labels.get(wellknown.ZONE_LABEL, ""),
         bool(n.meta.deleting))
        for n in cluster.nodes.list())
    claims = sorted(
        (c.meta.name, c.nodepool, c.provider_id or "",
         c.node_name or "", bool(c.meta.deleting),
         tuple(sorted((k, bool(v)) for k, v in c.conditions.items())))
        for c in cluster.nodeclaims.list())
    payload = {"pods": pods, "nodes": nodes, "claims": claims}
    if pricing is not None:
        from karpenter_tpu_torch.utils.ledger import fleet_cost
        payload["fleet_cost_hex"] = float(
            fleet_cost(cluster, pricing)["total"]).hex()
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()
