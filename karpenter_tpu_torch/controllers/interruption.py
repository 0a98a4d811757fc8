"""Interruption controller — spot reclaim / health events → proactive drain.

Mirrors pkg/controllers/interruption/controller.go:86-126: drain the
interruption queue via the queue provider, match messages to NodeClaims by
instance id (:148-173), act per message kind
(pkg/controllers/interruption/messages/*):

  spot_interruption        mark the offering unavailable (feeding the
                           scheduler's ICE cache, :202-208) and delete the
                           claim so termination drains it ahead of the
                           2-minute reclaim (designs/interruption-handling.md)
  rebalance_recommendation advisory only — event, no action (the reference
                           only acts on these behind explicit opt-in)
  scheduled_change         cloud maintenance: delete the claim
  state_change             stopping/terminated out from under us: delete

The port's copy of `karpenter_tpu/controllers/interruption.py`, with the
timeline's spot.reclaim capture point and the decision ledger's reclaim
record.
"""

from __future__ import annotations

from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.providers.queue import QueueProvider
from karpenter_tpu_torch.utils import errors, ledger, metrics
from karpenter_tpu_torch.utils.cache import UnavailableOfferings


class Interruption:
    name = "interruption"

    def __init__(self, cluster: Cluster, queue: QueueProvider,
                 unavailable: UnavailableOfferings, cloud_provider=None):
        self.cluster = cluster
        self.queue = queue
        self.unavailable = unavailable
        # optional: only the decision ledger's pricing lookups need it
        self.cp = cloud_provider
        self._drain_fleet_cost = None  # per-reconcile running total
        self._drain_cache: dict = {}   # per-reconcile pods-by-node index

    # long-poll batches drained per reconcile: the reference requeues
    # immediately after each poll (controller.go:124 — effectively a
    # continuous drain); a bounded in-reconcile drain gets the same
    # throughput without starving the other controllers in our
    # single-threaded manager
    MAX_BATCHES_PER_RECONCILE = 1000

    def reconcile(self) -> None:
        by_pid = None
        # per-drain ledger state: a mass reclaim deletes hundreds of
        # claims in one reconcile, and re-walking the fleet per record
        # would be O(deleted x fleet) — the sum is computed once at the
        # first reclaim and advanced by each record's own delta; the
        # pods-by-node index amortizes the pod count the same way
        self._drain_fleet_cost = None
        self._drain_cache = {}
        for _ in range(self.MAX_BATCHES_PER_RECONCILE):
            try:
                msgs = list(self.queue.receive())
            except Exception as e:  # noqa: BLE001 — outage: poll next round
                if not errors.is_retryable(e):
                    raise
                from karpenter_tpu_torch.utils.logging import get_logger
                get_logger(self.name).warn(
                    "interruption queue poll failed; retry next round",
                    error=str(e)[:200])
                metrics.RECONCILE_ERRORS.inc(controller=self.name)
                return
            if not msgs:
                return
            if by_pid is None:
                # ONE claim index per drain: messages only ever REMOVE
                # claims, so the index stays valid across batches —
                # rebuilding per 20-message poll is quadratic at benchmark
                # volumes (interruption_benchmark_test.go drives 15k)
                by_pid = {c.provider_id: c
                          for c in self.cluster.nodeclaims.list()
                          if c.provider_id}
            for msg in msgs:
                self._handle(msg, by_pid)
                self.queue.delete(msg)

    def _handle(self, msg: dict, by_pid=None) -> None:
        metrics.INTERRUPTION_MESSAGES.inc(
            message_type=msg.get("kind", "unknown"))
        instance_id = msg.get("instance_id")
        if by_pid is not None:
            claim = by_pid.get(instance_id)
        else:
            claim = next(
                (c for c in self.cluster.nodeclaims.list()
                 if c.provider_id == instance_id), None)
        kind = msg.get("kind")
        if kind == "spot_interruption":
            # the timeline's spot.reclaim capture point — one event per
            # reclaim message, cross-linked to the claim it takes down
            from karpenter_tpu_torch.timeline import events as tev
            from karpenter_tpu_torch.timeline import recorder as trec
            trec.emit(tev.SPOT_RECLAIM, name=str(instance_id or ""),
                      data={"claim": claim.name if claim else None})
            inst = self.queue.cloud.instances.get(instance_id)
            if inst is not None:
                # the reclaimed pool is unavailable for the next 3 minutes —
                # the scheduler must not immediately relaunch into it
                self.unavailable.mark_unavailable(
                    inst.capacity_type, inst.instance_type, inst.zone,
                    reason="SpotInterruption")
                # feed the spot-risk model: one observed
                # reclaim raises this pool's interruption probability and
                # bumps the model version, so the next solve re-ranks
                # against the new reality
                from karpenter_tpu_torch.scheduling import risk
                risk.observe_interruption(inst.instance_type, inst.zone)
            if claim is not None:
                self.cluster.record_event(
                    "NodeClaim", claim.name, "SpotInterrupted",
                    f"instance {instance_id} reclaim imminent")
                self._delete_claim(claim, by_pid, instance_id)
        elif kind == "rebalance_recommendation":
            if claim is not None:
                self.cluster.record_event(
                    "NodeClaim", claim.name, "RebalanceRecommendation",
                    f"instance {instance_id} at elevated reclaim risk")
        elif kind == "scheduled_change":
            if claim is not None:
                self.cluster.record_event(
                    "NodeClaim", claim.name, "ScheduledChange",
                    "cloud maintenance event")
                self._delete_claim(claim, by_pid, instance_id)
        elif kind == "state_change":
            if msg.get("state") in ("stopping", "stopped", "terminated") \
                    and claim is not None:
                self.cluster.record_event(
                    "NodeClaim", claim.name, "InstanceStateChange",
                    msg.get("state", ""))
                self._delete_claim(claim, by_pid, instance_id)

    def _delete_claim(self, claim, by_pid, instance_id) -> None:
        """Delete + drop from the drain index: a duplicate message for the
        same instance later in the drain must see the claim gone, exactly
        as a fresh informer read would."""
        self._ledger_reclaim(claim, instance_id)
        self.cluster.nodeclaims.delete(claim.name)
        if by_pid is not None:
            by_pid.pop(instance_id, None)

    def _ledger_reclaim(self, claim, instance_id) -> None:
        """One decision-ledger record per interruption-driven delete: the
        reclaimed node's $/hr leaves the fleet (the replacement shows up
        as a later provisioning launch record).  The fleet sum is the
        drain-scoped running total, never a per-record fleet walk."""
        if not ledger.LEDGER.enabled:
            return
        from karpenter_tpu_torch.solver import explain as explainmod
        if self._drain_fleet_cost is None:
            pricing = getattr(getattr(self.cp, "instance_types", None),
                              "pricing", None)
            self._drain_fleet_cost = ledger.fleet_cost(
                self.cluster, pricing)["total"]
        rec = ledger.record_claim_delete(
            self.cluster, self.cp, claim,
            source="interruption",
            reason_code=explainmod.INTERRUPTION_RECLAIM,
            detail=f"instance {instance_id} reclaim/maintenance",
            fleet_before=self._drain_fleet_cost,
            pass_cache=self._drain_cache)
        if rec is not None:
            self._drain_fleet_cost += rec.cost_delta
