"""Provisioning controller: pending pods → batch → solve → NodeClaims.

Mirrors the core provisioning controller (SURVEY §2.2/§3.2): watches
unschedulable pods, batches them (idle 1 s / max 10 s — settings.md
BATCH_*), runs the scheduler against cluster state + per-pool instance
types, creates NodeClaims for new nodes and binds pods that fit existing
capacity. The device solver is feature-gated with the CPU oracle as
fallback —
solver failure must never fail provisioning (SURVEY §5).

The port's copy of `karpenter_tpu/controllers/provisioning.py`, solving
through the port's `GatedSolver` (a `TorchSolver`), with the decision
ledger's fleet-cost gauges and launch records (`utils/ledger.py`).
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.controllers.state import GatedSolver, build_schedule_input
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import NodeClaim, ObjectMeta, Pod
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.scheduling import ScheduleInput
from karpenter_tpu_torch.scheduling.types import NewNodeClaim, ScheduleResult
from karpenter_tpu_torch.utils import errors, ledger, metrics, tracing
from karpenter_tpu_torch.utils.clock import Clock

NOMINATED_ANNOTATION = "karpenter.sh/nominated-claim"


class Provisioner:
    name = "provisioning"
    # fleet-metric staleness bound when the generation is quiet (the
    # price book can change out-of-band): one O(nodes+pods+types)
    # sweep per this many seconds, worst case
    FLEET_METRICS_TTL = 30.0

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
        self._claim_seq = 0
        self._batch_first: Optional[float] = None
        self._batch_sig: Optional[frozenset] = None
        self._batch_last_change: Optional[float] = None
        # pod uid → first time seen pending, for the backlog-age gauge
        # (degraded-mode liveness: shed pods re-enter later passes, and
        # the oldest pending pod's age must shrink to zero as the
        # backlog drains — designs/limits.md:23-25 liveness discipline)
        self._first_pending: dict = {}
        self._warmup_started = False

    # -- startup warm-up (the solver's first-use costs) --------------------
    def _maybe_warmup(self) -> None:
        """Pay the solver's warm-up (`TorchSolver.warmup`: kernel builds,
        catalog upload, one launch per bucketed shape) ONCE, at the first
        pass that sees a NodePool, gated by KARPENTER_TPU_WARMUP (off by
        default: unit tests and tiny deployments must not pay it at
        construction; production sets it so the first real burst meets
        no first-use cost).  A synthetic one-pod input pins the catalog
        and existing-node buckets; the extra G-bucket shapes cover burst
        sizes up to the 50k headline class.  The reference warms in a
        background thread; the port warms in the pass itself, so the
        warm-up never shares the solver's staging with a real solve.  A
        failure degrades to cold first solves on the CPU and propagates
        on the card (`GatedSolver.warmup`)."""
        if self._warmup_started:
            return
        from karpenter_tpu_torch.utils.knobs import env_bool
        if not env_bool("KARPENTER_TPU_WARMUP"):
            self._warmup_started = True
            return
        if not self.cluster.nodepools.list(lambda p: not p.meta.deleting):
            return  # no catalog yet — retry on a later pass
        self._warmup_started = True
        from karpenter_tpu_torch.models.resources import Resources
        from karpenter_tpu_torch.utils.logging import get_logger
        pod = Pod(meta=ObjectMeta(name="karpenter-warmup"),
                  requests=Resources.parse({"cpu": "100m",
                                            "memory": "128Mi"}))
        inp = self._build_input([pod])
        e = len(inp.existing_nodes)
        warmed = self.solver.warmup(inp, shapes=((8, e), (512, e)))
        get_logger("provisioning").info(
            "solver warm-up complete", launches=warmed)

    # -- batching (settings.md BATCH_IDLE/MAX_DURATION) -------------------
    def _batch_ready(self, pending: List[Pod]) -> bool:
        now = self.clock.now()
        sig = frozenset(p.meta.uid for p in pending)
        if not pending:
            self._batch_first = self._batch_sig = self._batch_last_change = None
            return False
        if sig != self._batch_sig:
            self._batch_sig = sig
            self._batch_last_change = now
            if self._batch_first is None:
                self._batch_first = now
        idle = self.options.batch_idle_duration
        maxd = self.options.batch_max_duration
        if idle <= 0:
            return True
        return (now - self._batch_last_change >= idle
                or now - self._batch_first >= maxd)

    # -- reconcile --------------------------------------------------------
    def reconcile(self) -> None:
        self._maybe_warmup()
        pending = [
            p for p in self.cluster.pending_pods()
            if NOMINATED_ANNOTATION not in p.meta.annotations
        ]
        metrics.SCHEDULING_QUEUE_DEPTH.set(len(pending))
        now = self.clock.now()
        live = {p.meta.uid for p in pending}
        for uid in live - self._first_pending.keys():
            self._first_pending[uid] = now
        for uid in list(self._first_pending):
            if uid not in live:
                del self._first_pending[uid]
        metrics.PROVISIONER_BACKLOG_AGE.set(
            max((now - t for t in self._first_pending.values()),
                default=0.0))
        # fleet spend/packing gauges: refreshed whenever the cluster
        # actually changed (generation-gated — the sweep is O(nodes + pods
        # + types) of pure Python, and an idle 1 s reconcile tick must not
        # pay it to recompute identical values), plus a TTL fallback: the
        # price book can move WITHOUT a store mutation (PricingRefresh
        # updates the provider, never the generation), and an idle fleet
        # must not export stale $/hr forever.  Best-effort — a pricing or
        # discovery hiccup degrades the gauges, never the loop
        gen = self.cluster.generation
        last = getattr(self, "_fleet_metrics_at", None)
        if (gen != getattr(self, "_fleet_metrics_gen", None)
                or last is None
                or now - last >= self.FLEET_METRICS_TTL):
            try:
                ledger.update_fleet_metrics(self.cluster, self.cp)
                self._fleet_metrics_gen = gen
                self._fleet_metrics_at = now
            except Exception as e:  # noqa: BLE001 — advisory telemetry
                from karpenter_tpu_torch.utils.logging import get_logger
                get_logger(self.name).warn(
                    "fleet cost metrics refresh failed",
                    error=str(e)[:200])
        if not self._batch_ready(pending):
            return
        self._batch_first = self._batch_sig = self._batch_last_change = None

        # ONE trace per provisioning pass, rooted here: every child span
        # (input assembly, solve phases, remote-solver RPC, store I/O,
        # apply) hangs off this id, and record_event stamps it so events
        # and traces cross-reference
        with tracing.span("provisioning.pass", pods=len(pending)) as _sp:
            try:
                with tracing.span("provisioning.build_input"):
                    inp = self._build_input(pending)
            except Exception as e:  # noqa: BLE001
                # catalog discovery hit a cloud outage with a cold cache —
                # keep the pods pending and retry next round (provisioning
                # must never crash the loop, SURVEY §5)
                if not errors.is_retryable(e):
                    raise
                self.cluster.record_event(
                    "Provisioner", "provisioning", "SchedulingRetryable",
                    str(e))
                return
            with metrics.SCHEDULING_DURATION.time():
                with tracing.span("provisioning.solve"):
                    result = self._solve(inp)
            with tracing.span("provisioning.apply"):
                self._apply(result, pending)
            if _sp is not None:
                _sp.attrs["new_claims"] = len(result.new_claims)
                _sp.attrs["unschedulable"] = len(result.unschedulable)

    # -- input assembly ---------------------------------------------------
    def _build_input(self, pending: List[Pod]) -> ScheduleInput:
        return build_schedule_input(self.cluster, self.cp, pending)

    def _solve(self, inp: ScheduleInput) -> ScheduleResult:
        return self.solver.solve(inp, source="provisioning")

    # -- apply -------------------------------------------------------------
    def _apply(self, result: ScheduleResult,
               pods: "List[Pod] | None" = None) -> None:
        if pods:
            # gang placement outcomes: ONE increment per gang
            # per pass.  By the atomicity invariant a gang is either
            # fully placed or fully stranded — outcome is derived from
            # "any member unschedulable", and a partial gang would show
            # up on the solver's gang-repair counter, never here.
            from karpenter_tpu_torch.scheduling.types import gang_of
            gangs: dict = {}
            for p in pods:
                sp = gang_of(p)
                if sp is not None:
                    placed = p.meta.name not in result.unschedulable
                    gangs[sp.name] = gangs.get(sp.name, True) and placed
            for _name, placed in sorted(gangs.items()):
                metrics.GANG_PLACEMENTS.inc(
                    outcome="placed" if placed else "stranded")
        for pod_name, node_name in result.existing_assignments.items():
            pod = self.cluster.pods.get(pod_name)
            node = self.cluster.nodes.get(node_name)
            if pod is None or node is None:
                continue
            pod.node_name = node_name
            pod.phase = "Running"
            self.cluster.pods.update(pod)

        for claim_spec in result.new_claims:
            claim = self._create_claim(claim_spec)
            for pod in claim_spec.pods:
                live = self.cluster.pods.get(pod.meta.name)
                if live is not None:
                    live.meta.annotations[NOMINATED_ANNOTATION] = claim.name
                    self.cluster.pods.update(live)
        if result.new_claims and ledger.LEDGER.enabled:
            # decision ledger: one launch record per pass — the cost delta
            # is the exact sum of the planned claims' prices (the same
            # floats the solver minimized), fleet-before the independent
            # sum over live nodes
            from karpenter_tpu_torch.solver import explain as explainmod
            pricing = getattr(self.cp.instance_types, "pricing", None)
            ledger.LEDGER.record(
                "provisioning", "launch",
                reason_code=explainmod.CAPACITY_LAUNCHED,
                detail=f"{len(result.new_claims)} claim(s) for "
                       f"{sum(len(s.pods) for s in result.new_claims)} "
                       "pod(s)",
                pools=[s.nodepool for s in result.new_claims],
                nodes_delta=len(result.new_claims),
                pods_affected=sum(len(s.pods) for s in result.new_claims)
                + len(result.existing_assignments),
                fleet_cost_before=ledger.fleet_cost(
                    self.cluster, pricing)["total"],
                cost_delta=sum(s.price for s in result.new_claims))

        if result.preemptions:
            # preemption plans: stamp every victim with the
            # plan annotations — the Preemption controller executes the
            # evictions atomically per plan; the provisioner only
            # publishes the decision
            for plan in result.preemptions:
                target = ",".join(plan.target_pods)
                stamped = 0
                for vname in plan.victim_pod_names():
                    live = self.cluster.pods.get(vname)
                    if live is None or not live.node_name:
                        continue
                    live.meta.annotations[
                        wellknown.PREEMPT_PLAN_ANNOTATION] = plan.plan_id
                    live.meta.annotations[
                        wellknown.PREEMPT_FOR_ANNOTATION] = target
                    self.cluster.pods.update(live)
                    stamped += 1
                if stamped:
                    self.cluster.record_event(
                        "Pod", plan.target_pods[0], "PreemptionPlanned",
                        f"plan {plan.plan_id}: evict {stamped} "
                        f"lower-priority pod(s) to seat {target}")

        if result.unschedulable:
            # placement provenance: this is the authoritative
            # "pod is unschedulable" surface — every solver path (device,
            # split, rescue, degraded, remote: the reason tree rides the
            # pickled Reason) lands here, so the per-reason counter and
            # the explain store are fed here, not inside the solver
            # (whose solve() also serves counterfactual simulations)
            from karpenter_tpu_torch.solver import explain as explainmod
            explainmod.STORE.register(
                result.unschedulable,
                trace_id=tracing.current_trace_id(),
                source="provisioning")
            for reason in result.unschedulable.values():
                metrics.UNSCHEDULABLE_PODS.inc(
                    reason=explainmod.code_of(reason))
        for pod_name, reason in result.unschedulable.items():
            self.cluster.record_event(
                "Pod", pod_name, "FailedScheduling", reason)

    def _create_claim(self, spec: NewNodeClaim) -> NodeClaim:
        # generateName semantics: the sequence keeps names readable and
        # roughly ordered, but uniqueness must hold across REPLICAS — two
        # operators each start their counter at zero, and a failover's
        # dual-writer window would collide on bare sequence names (k8s
        # solves this with a random generateName suffix)
        self._claim_seq += 1
        name = f"{spec.nodepool}-{self._claim_seq}"
        import uuid
        if name in self.cluster.nodeclaims:
            name = f"{spec.nodepool}-{uuid.uuid4().hex[:8]}"
        try:
            return create_claim_from_spec(self.cluster, self.cp, spec, name)
        except ValueError:
            # the authoritative store held the name even though our cache
            # didn't (peer's create not yet synced): retry under a random
            # name — the window where this recurses twice is negligible
            return create_claim_from_spec(
                self.cluster, self.cp, spec,
                f"{spec.nodepool}-{uuid.uuid4().hex[:8]}")


def create_claim_from_spec(cluster: Cluster, cp: TPUCloudProvider,
                           spec: NewNodeClaim, name: str) -> NodeClaim:
    """NewNodeClaim (scheduler output) → NodeClaim CR, shared by the
    provisioner and the disruption controller's replacement pre-spin."""
    pool = cluster.nodepools.get(spec.nodepool)
    nc = cp.node_classes.get(spec.node_class_ref)
    claim = NodeClaim(
        meta=ObjectMeta(
            name=name,
            labels={wellknown.NODEPOOL_LABEL: spec.nodepool},
            annotations={
                wellknown.NODEPOOL_HASH_ANNOTATION:
                    pool.static_hash() if pool else "",
                wellknown.NODECLASS_HASH_ANNOTATION:
                    nc.static_hash() if nc else "",
            },
            finalizers=[wellknown.TERMINATION_FINALIZER],
        ),
        nodepool=spec.nodepool,
        nodepool_uid=(pool.meta.uid if pool else None),
        node_class_ref=spec.node_class_ref,
        requirements=spec.requirements.copy(),
        resource_requests=spec.requests.copy(),
        taints=list(spec.taints),
        startup_taints=list(spec.startup_taints),
        instance_type_options=list(spec.instance_type_names),
        termination_grace_period=(
            pool.termination_grace_period if pool else None),
    )
    cluster.nodeclaims.create(claim)
    return claim
