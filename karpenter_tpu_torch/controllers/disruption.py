"""Disruption controller — drift, emptiness, and consolidation.

The second hot path (SURVEY §3.3). Flow per disruption.md:14-27: build
candidates from cluster state → budget check → scheduling SIMULATION →
taint → pre-spin replacement → wait Ready → delete. Methods run in order
Drift → Emptiness → Multi-node consolidation → Single-node consolidation
(disruption.md:90-101), one command at a time.

Candidate ranking follows designs/consolidation.md:25-42: disruption cost =
Σ over evictable pods of (1 + deletion-cost & priority weights), scaled by
the node's remaining lifetime fraction (1.0 at creation → 0.0 at expiry).

Consolidation decisions:
  delete   — candidate's pods fit on the remaining nodes, no new capacity
  replace  — pods fit with exactly ONE new node strictly cheaper than the
             candidates it replaces; spot→spot additionally requires ≥15
             instance-type flexibility in the replacement
             (disruption.md:123-132) and its feature gate
Multi-node tries the cheapest-to-disrupt prefix of candidates first and
shrinks until feasible (the reference's heuristic subset search).

The port's copy of `karpenter_tpu/controllers/disruption.py`: its
simulations run through the port's `GatedSolver` (a `TorchSolver`: the
wide multi-node prefixes on K5's batched scan, the leave-one-out sims on
K4's sweep).  The decision ledger's records (`_ledger_decision`,
`utils/ledger.py`) are left out until slice 6 ports the ledger; the
savings counter and every decision are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.controllers.provisioning import create_claim_from_spec
from karpenter_tpu_torch.controllers.state import (GatedSolver,
                                             build_existing_nodes,
                                             build_schedule_input)
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import (
    CONSOLIDATE_WHEN_EMPTY,
    CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED,
    COND_INITIALIZED,
    Node,
    NodeClaim,
    NodePool,
)
from karpenter_tpu_torch.models.taints import NO_SCHEDULE, Taint
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.scheduling import ScheduleResult
from karpenter_tpu_torch.scheduling.types import ScheduleInput
from karpenter_tpu_torch.solver import explain as explainmod
from karpenter_tpu_torch.solver.solve import B_BUCKETS as SOLVER_B_BUCKETS
from karpenter_tpu_torch.utils import cron, errors, metrics, tracing
from karpenter_tpu_torch.utils.clock import Clock

SPOT_TO_SPOT_MIN_TYPES = 15  # disruption.md:123-132

REASON_DRIFT = "Drifted"
REASON_EMPTY = "Empty"
REASON_UNDERUTILIZED = "Underutilized"

DISRUPTING_TAINT = Taint(wellknown.DISRUPTION_TAINT_KEY, "disrupting",
                         NO_SCHEDULE)


@dataclass
class Candidate:
    claim: NodeClaim
    node: Node
    pool: NodePool
    reschedulable: List = field(default_factory=list)  # non-daemon pods
    price: float = 0.0
    cost: float = 0.0  # disruption cost for ranking


@dataclass
class Command:
    """An in-flight disruption: replacements must initialize before the
    candidates are deleted (pre-spin — disruption.md:14-27)."""
    reason: str
    candidate_names: List[str]
    replacement_names: List[str]
    started: float


class Disruption:
    name = "disruption"

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider: TPUCloudProvider,
        options: Optional[Options] = None,
        clock: Optional[Clock] = None,
        solver: Optional[GatedSolver] = None,
    ):
        self.cluster = cluster
        self.cp = cloud_provider
        self.options = options or Options()
        self.clock = clock or cluster.clock
        self.solver = solver or GatedSolver(self.options, cluster)
        self.commands: List[Command] = []
        self._replacement_seq = 0
        self.command_timeout = 10 * 60.0
        # replacements stay off the candidate list until pods land on them
        # (or the grace period lapses) — otherwise the emptiness method can
        # delete a just-initialized replacement before evicted pods rebind
        self._protected: Dict[str, float] = {}
        self.protection_grace = 5 * 60.0

    # ------------------------------------------------------------------
    def reconcile(self) -> None:
        try:
            self._reconcile()
        except Exception as e:  # noqa: BLE001 — cloud outage: skip the pass
            if not errors.is_retryable(e):
                raise
            from karpenter_tpu_torch.utils.logging import get_logger
            get_logger(self.name).warn(
                "disruption pass skipped on retryable error",
                error=str(e)[:200])
            metrics.RECONCILE_ERRORS.inc(controller=self.name)

    def _reconcile(self) -> None:
        if self._process_commands():
            return  # one in-flight command at a time (minimal-change bias)
        candidates = self._build_candidates()
        self._publish_eligibility(candidates)
        if not candidates:
            return
        # one trace per disruption pass: each method's evaluation (and the
        # batched simulations under it) nests here, mirroring the
        # provisioning pass's root span
        with tracing.span("disruption.pass",
                          candidates=len(candidates)) as _sp:
            for method in (self._drift, self._emptiness,
                           self._multi_node, self._single_node):
                mname = method.__name__.lstrip("_")
                with metrics.DISRUPTION_EVALUATION_DURATION.time(
                        method=mname):
                    with tracing.span(f"disruption.{mname}"):
                        acted = method(candidates)
                if acted:
                    metrics.DISRUPTION_ACTIONS.inc(method=mname)
                    if _sp is not None:
                        _sp.attrs["acted"] = mname
                    return

    def _publish_eligibility(self, candidates: List[Candidate]) -> None:
        """Refresh every method's eligible-nodes gauge each pass (including
        to zero) so the exported values never go stale."""
        consolidatable = self._consolidatable(candidates)
        empty = [c for c in candidates if not c.reschedulable]
        metrics.DISRUPTION_ELIGIBLE_NODES.set(len(candidates), method="drift")
        metrics.DISRUPTION_ELIGIBLE_NODES.set(len(empty), method="emptiness")
        metrics.DISRUPTION_ELIGIBLE_NODES.set(
            len(consolidatable), method="multi_node")
        metrics.DISRUPTION_ELIGIBLE_NODES.set(
            len(consolidatable), method="single_node")

    # -- in-flight commands ----------------------------------------------
    def _process_commands(self) -> bool:
        still: List[Command] = []
        for cmd in self.commands:
            done, abort = self._command_state(cmd)
            if done:
                for name in cmd.candidate_names:
                    self.cluster.nodeclaims.delete(name)
                self.cluster.record_event(
                    "Disruption", ",".join(cmd.candidate_names),
                    f"Disrupted{cmd.reason}",
                    f"replacements: {cmd.replacement_names or 'none'}")
            elif abort:
                self._abort(cmd)
            else:
                still.append(cmd)
        self.commands = still
        return bool(still)

    def _command_state(self, cmd: Command) -> tuple:
        if self.clock.now() - cmd.started > self.command_timeout:
            return False, True
        for name in cmd.replacement_names:
            rep = self.cluster.nodeclaims.get(name)
            if rep is None:
                return False, True  # replacement failed terminally
            if not rep.is_(COND_INITIALIZED):
                return False, False
        return True, False

    def _abort(self, cmd: Command) -> None:
        for name in cmd.replacement_names:
            self.cluster.nodeclaims.delete(name)
        for name in cmd.candidate_names:
            claim = self.cluster.nodeclaims.get(name)
            node = self.cluster.node_for_claim(claim) if claim else None
            if node is not None:
                node.taints = [t for t in node.taints
                               if t.key != wellknown.DISRUPTION_TAINT_KEY]
                self.cluster.nodes.update(node)
        self.cluster.record_event(
            "Disruption", ",".join(cmd.candidate_names),
            "DisruptionAborted", cmd.reason)

    # -- candidates -------------------------------------------------------
    def _build_candidates(self) -> List[Candidate]:
        out: List[Candidate] = []
        in_flight = {n for cmd in self.commands for n in cmd.candidate_names}
        now = self.clock.now()
        # drop stale protections (claim gone, grace lapsed, or pods landed)
        for name, t in list(self._protected.items()):
            claim = self.cluster.nodeclaims.get(name)
            if claim is None or now - t > self.protection_grace:
                del self._protected[name]
            elif claim.node_name and self.cluster.pods_on_node(claim.node_name):
                del self._protected[name]
        for claim in self.cluster.nodeclaims.list():
            if claim.meta.deleting or claim.name in in_flight:
                continue
            if claim.name in self._protected:
                continue  # fresh replacement: evicted pods haven't landed yet
            if not claim.is_(COND_INITIALIZED):
                continue
            node = self.cluster.node_for_claim(claim)
            if node is None or node.meta.deleting or not node.ready:
                continue
            # the do-not-disrupt annotation blocks voluntary disruption at
            # the node/claim level too, not just per pod (reference:
            # disruption.md — karpenter.sh/do-not-disrupt on the node)
            if any(o.meta.annotations.get(
                    wellknown.DO_NOT_DISRUPT_ANNOTATION) == "true"
                   for o in (node, claim)):
                continue
            pool = self.cluster.nodepools.get(claim.nodepool)
            if pool is None:
                continue
            # minimum settle time before consolidation (consolidate_after)
            settle = pool.disruption.consolidate_after
            if claim.launch_time is not None and now - claim.launch_time < settle:
                continue
            pods = self.cluster.pods_on_node(node.name)
            resched = [p for p in pods if not p.is_daemonset]
            # blocking pods (designs/consolidation.md:46-52)
            if any(p.do_not_disrupt() or p.owner_kind is None
                   or not self.cluster.can_evict(p) for p in resched):
                continue
            out.append(Candidate(
                claim=claim, node=node, pool=pool, reschedulable=resched,
                price=self._node_price(claim, node),
                cost=self._disruption_cost(claim, pool, resched, now),
            ))
        out.sort(key=lambda c: c.cost)
        return out

    def _node_price(self, claim: NodeClaim, node: Node) -> float:
        itype = node.instance_type
        zone = node.zone
        ct = node.capacity_type
        if itype and zone and ct:
            p = self.cp.instance_types.pricing.price(itype, zone, ct)
            if p is not None:
                return p
        return 0.0

    def _disruption_cost(self, claim: NodeClaim, pool: NodePool,
                         pods: List, now: float) -> float:
        base = sum(
            1.0 + max(p.priority, 0) / 1e6 + p.deletion_cost() / 1e3
            for p in pods)
        lifetime = 1.0
        if pool.expire_after and claim.launch_time is not None:
            remaining = pool.expire_after - (now - claim.launch_time)
            lifetime = max(0.0, min(1.0, remaining / pool.expire_after))
        return base * lifetime

    # -- budgets ----------------------------------------------------------
    def _budget_allows(self, pool: NodePool, reason: str, want: int) -> int:
        total = len([
            c for c in self.cluster.nodeclaims.list(
                lambda c: c.nodepool == pool.name)
        ])
        disrupting = len([
            c for c in self.cluster.nodeclaims.list(
                lambda c: c.nodepool == pool.name and c.meta.deleting)
        ]) + sum(
            1 for cmd in self.commands for n in cmd.candidate_names
            if (cl := self.cluster.nodeclaims.get(n)) is not None
            and cl.nodepool == pool.name)
        allowed = None
        for budget in pool.disruption.budgets:
            if budget.reasons is not None and reason not in budget.reasons:
                continue
            # cron-windowed budgets only bind while their window is open
            # (schedule fires in UTC; active for `duration` seconds). An
            # unparseable schedule fails SAFE: the budget binds — a typo
            # must neither drop a configured freeze nor kill the operator
            try:
                if not cron.in_window(budget.schedule, budget.duration,
                                      self.clock.now()):
                    continue
            except cron.CronError as e:
                self.cluster.record_event(
                    "NodePool", pool.name, "InvalidBudgetSchedule", str(e))
            a = budget.allowed_disruptions(total)
            allowed = a if allowed is None else min(allowed, a)
        if allowed is None:
            allowed = total
        return max(0, min(want, allowed - disrupting))

    # -- methods ----------------------------------------------------------
    def _drift(self, candidates: List[Candidate]) -> bool:
        if not self.options.feature_gates.drift:
            return False
        for cand in candidates:
            reason = self._drift_reason(cand)
            if reason is None:
                continue
            if self._budget_allows(cand.pool, REASON_DRIFT, 1) < 1:
                self.cluster.record_event(
                    "NodeClaim", cand.claim.name, "DisruptionBlocked",
                    explainmod.make(
                        explainmod.BUDGET_BLOCKED,
                        f"drift of {cand.claim.name} blocked by "
                        f"nodepool {cand.pool.name}'s disruption budget"))
                continue
            # drifted capacity is replaced in kind: feasibility simulation
            # without the cheaper-price requirement
            sim = self._simulate([cand], price_cap=None)
            if sim is None:
                self.cluster.record_event(
                    "NodeClaim", cand.claim.name, "Undisruptable",
                    explainmod.make(
                        explainmod.CANDIDATE_NOT_RESCHEDULABLE,
                        "drifted but pods cannot reschedule"))
                continue
            self._execute(REASON_DRIFT, [cand], sim, method="drift")
            return True
        return False

    def _drift_reason(self, cand: Candidate) -> Optional[str]:
        pool_hash = cand.pool.static_hash()
        stamped = cand.claim.meta.annotations.get(
            wellknown.NODEPOOL_HASH_ANNOTATION)
        if stamped is not None and stamped != pool_hash:
            return explainmod.make(
                explainmod.NODEPOOL_DRIFT,
                "NodePoolDrift: stamped hash no longer matches the pool")
        return self.cp.is_drifted(cand.claim)

    def _emptiness(self, candidates: List[Candidate]) -> bool:
        empty = [c for c in candidates if not c.reschedulable
                 and c.pool.disruption.consolidation_policy in (
                     CONSOLIDATE_WHEN_EMPTY,
                     CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED)]
        if not empty:
            return False
        by_pool: Dict[str, List[Candidate]] = {}
        for c in empty:
            by_pool.setdefault(c.pool.name, []).append(c)
        acted = False
        for cands in by_pool.values():
            n = self._budget_allows(cands[0].pool, REASON_EMPTY, len(cands))
            deleted = cands[:n]
            for cand in deleted:
                self.cluster.record_event(
                    "NodeClaim", cand.claim.name, "DisruptedEmpty", "")
                self.cluster.nodeclaims.delete(cand.claim.name)
                acted = True
            if deleted:
                # empty deletes are pure savings: the savings counter
                # carries the exact sum of retired prices (IEEE-exactness
                # contract); the ledger's ConsolidationDelete record
                # comes with utils/ledger.py in slice 6
                retired = sum(c.price for c in deleted)
                if retired > 0:
                    metrics.DISRUPTION_SAVINGS.inc(
                        retired, method="emptiness")
        return acted

    def _consolidatable(self, candidates: List[Candidate]) -> List[Candidate]:
        return [
            c for c in candidates
            if c.pool.disruption.consolidation_policy
            == CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED
            and c.reschedulable  # empties are handled by emptiness
        ]

    # candidate sets per batched simulation call: one device call evaluates
    # the whole chunk — linked to the solver's largest batch bucket so a
    # disruption chunk never splits into multiple device calls
    SIM_CHUNK = SOLVER_B_BUCKETS[-1]

    def _multi_node(self, candidates: List[Candidate]) -> bool:
        cands = self._consolidatable(candidates)
        if len(cands) < 2:
            return False
        # shrink the cheapest-to-disrupt prefix until feasible, largest
        # prefix first (the reference's heuristic subset search) — all
        # prefix simulations batch onto the device in chunks
        subsets: List[List[Candidate]] = []
        for k in range(len(cands), 1, -1):
            subset = cands[:k]
            # budgets are per pool over the WHOLE subset — each pool must
            # allow as many concurrent disruptions as the subset takes
            per_pool: Dict[str, int] = {}
            for c in subset:
                per_pool[c.pool.name] = per_pool.get(c.pool.name, 0) + 1
            pools = {c.pool.name: c.pool for c in subset}
            if any(self._budget_allows(pools[name], REASON_UNDERUTILIZED, n) < n
                   for name, n in per_pool.items()):
                continue
            subsets.append(subset)
        for start in range(0, len(subsets), self.SIM_CHUNK):
            chunk = subsets[start:start + self.SIM_CHUNK]
            sims = self._simulate_batch(
                chunk, [sum(c.price for c in s) for s in chunk])
            for subset, sim in zip(chunk, sims):
                if sim is not None and self._acceptable(subset, sim):
                    self._execute(REASON_UNDERUTILIZED, subset, sim,
                                  method="multi_node")
                    return True
        return False

    def _single_node(self, candidates: List[Candidate]) -> bool:
        cands = [c for c in self._consolidatable(candidates)
                 if self._budget_allows(c.pool, REASON_UNDERUTILIZED, 1) >= 1]
        for start in range(0, len(cands), self.SIM_CHUNK):
            chunk = cands[start:start + self.SIM_CHUNK]
            sims = self._simulate_batch(
                [[c] for c in chunk], [c.price for c in chunk])
            for cand, sim in zip(chunk, sims):
                reason = (explainmod.make(
                    explainmod.CANDIDATE_NOT_RESCHEDULABLE,
                    "pods cannot reschedule onto remaining capacity "
                    "or a single cheaper node") if sim is None
                    else self._unacceptable_reason([cand], sim))
                if reason is None:
                    self._execute(REASON_UNDERUTILIZED, [cand], sim,
                                  method="single_node")
                    return True
                # user-facing reason a node stays up (disruption.md:109-117
                # Unconsolidatable events; the recorder deduplicates)
                self.cluster.record_event(
                    "NodeClaim", cand.claim.name, "Unconsolidatable", reason)
        return False

    # -- simulation -------------------------------------------------------
    def _build_sim_input(self, cands: List[Candidate],
                         price_cap: Optional[float],
                         prebuilt=None) -> ScheduleInput:
        pods = [p for c in cands for p in c.reschedulable]
        exclude = {c.node.name for c in cands}
        exclude_claims = {c.claim.name for c in cands}
        return build_schedule_input(
            self.cluster, self.cp, pods,
            exclude_nodes=exclude, exclude_claims=exclude_claims,
            price_cap=price_cap, prebuilt_existing=prebuilt)

    @staticmethod
    def _admissible(result: ScheduleResult) -> Optional[ScheduleResult]:
        if result.unschedulable:
            return None
        if len(result.new_claims) > 1:
            return None  # minimal change: at most one replacement node
        return result

    def _simulate(self, cands: List[Candidate],
                  price_cap: Optional[float]) -> Optional[ScheduleResult]:
        """Can the candidates' pods run on the remaining nodes, plus at most
        one new (price-capped) node? None = infeasible."""
        inp = self._build_sim_input(cands, price_cap)
        with metrics.SCHEDULING_SIMULATION_DURATION.time():
            with tracing.span("disruption.simulate", pods=len(inp.pods)):
                return self._admissible(self.solver.solve(
                    inp, source="disruption", max_nodes=8))

    def _simulate_batch(self, cand_sets: List[List[Candidate]],
                        price_caps: List[Optional[float]]):
        """Lazy iterator of admissible results: with the oracle fallback the
        underlying solve runs per-consumed item, so a caller that acts on
        the first acceptable candidate pays for exactly the simulations it
        looked at (per-simulation metrics recorded in GatedSolver)."""
        # one node snapshot shared by every simulation: wrappers are
        # reused, so the controller-side build is O(nodes + sims) and the
        # solver's per-batch union cache keys work by object identity
        with tracing.span("disruption.simulate_batch",
                          sims=len(cand_sets)):
            prebuilt = build_existing_nodes(self.cluster)
            inps = [self._build_sim_input(cs, cap, prebuilt=prebuilt)
                    for cs, cap in zip(cand_sets, price_caps)]
            # admissibility allows at most ONE replacement node
            # (_admissible), so a tiny new-node axis is exact: slot
            # exhaustion reports unschedulable, rejected the same as a
            # >1-claim result
            results = self.solver.solve_batch(inps, source="disruption",
                                              max_nodes=8)
        return (self._admissible(r) for r in results)

    def _acceptable(self, cands: List[Candidate],
                    sim: ScheduleResult) -> bool:
        return self._unacceptable_reason(cands, sim) is None

    def _unacceptable_reason(self, cands: List[Candidate],
                             sim: ScheduleResult) -> Optional[str]:
        """None = acceptable; else a registry-coded Reason
        (solver/explain.py — the ledger stores the code, the event keeps
        the human detail; the accurate message matters: pointing an
        operator at pricing when the spot-flexibility rule is what
        blocked the replacement sends the debugging in the wrong
        direction)."""
        if not sim.new_claims:
            return None  # pure delete: always saves money
        total_price = sum(c.price for c in cands)
        rep = sim.new_claims[0]
        if rep.price >= total_price:
            return explainmod.make(
                explainmod.REPLACEMENT_NOT_CHEAPER,
                "replacement would not reduce cost")
        # spot→spot: replacement must keep ≥15 types of flexibility so it
        # lands on reliable spot capacity (disruption.md:123-132)
        all_spot = all(
            c.node.capacity_type == wellknown.CAPACITY_TYPE_SPOT for c in cands)
        rep_ct = rep.requirements.get(wellknown.CAPACITY_TYPE_LABEL)
        rep_spot = rep_ct is not None and rep_ct.is_finite() \
            and rep_ct.values() == {wellknown.CAPACITY_TYPE_SPOT}
        rep_spot = rep_spot or (rep_ct is None)
        if all_spot and rep_spot:
            if not self.options.feature_gates.spot_to_spot_consolidation:
                return explainmod.make(
                    explainmod.SPOT_TO_SPOT_DISABLED,
                    "spot-to-spot consolidation is disabled "
                    "(SpotToSpotConsolidation feature gate)")
            if len(rep.instance_type_names) < SPOT_TO_SPOT_MIN_TYPES:
                return explainmod.make(
                    explainmod.SPOT_FLEXIBILITY_TOO_LOW,
                    f"spot-to-spot replacement keeps only "
                    f"{len(rep.instance_type_names)} instance types of "
                    f"the {SPOT_TO_SPOT_MIN_TYPES} required for "
                    f"reliable spot capacity")
        return None

    # -- execution --------------------------------------------------------
    def _execute(self, reason: str, cands: List[Candidate],
                 sim: ScheduleResult, method: str = "single_node") -> None:
        for cand in cands:
            if not any(t.key == wellknown.DISRUPTION_TAINT_KEY
                       for t in cand.node.taints):
                cand.node.taints.append(DISRUPTING_TAINT)
                self.cluster.nodes.update(cand.node)
        replacements = []
        for spec in sim.new_claims:
            self._replacement_seq += 1
            claim = create_claim_from_spec(
                self.cluster, self.cp, spec,
                f"{spec.nodepool}-replace-{self._replacement_seq}")
            replacements.append(claim.name)
            self._protected[claim.name] = self.clock.now()
        # savings: recorded at DECISION time with the
        # exact floats this method compared — savings is (sum of retired
        # candidate prices − replacement price), the IEEE-exactness
        # contract the config4 bench asserts.  Drift replaces in kind
        # (no cheaper-price rule), so it never claims savings.
        retired = sum(c.price for c in cands)
        added = sum(s.price for s in sim.new_claims)
        # the ledger's record of this decision (DriftReplaced,
        # ConsolidationReplace or ConsolidationDelete, cost delta
        # added - retired) comes with utils/ledger.py in slice 6
        savings = retired - added
        if reason != REASON_DRIFT and savings > 0:
            metrics.DISRUPTION_SAVINGS.inc(savings, method=method)
        self.commands.append(Command(
            reason=reason,
            candidate_names=[c.claim.name for c in cands],
            replacement_names=replacements,
            started=self.clock.now(),
        ))
