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

The port's copy of `karpenter_tpu/controllers/interruption.py`.  The
timeline's spot.reclaim capture point comes with `timeline/` and the
decision ledger's reclaim record with `utils/ledger.py`, both in slice 6.
"""

from __future__ import annotations

from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.providers.queue import QueueProvider
from karpenter_tpu_torch.utils import errors, metrics
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

    # long-poll batches drained per reconcile: the reference requeues
    # immediately after each poll (controller.go:124 — effectively a
    # continuous drain); a bounded in-reconcile drain gets the same
    # throughput without starving the other controllers in our
    # single-threaded manager
    MAX_BATCHES_PER_RECONCILE = 1000

    def reconcile(self) -> None:
        by_pid = None
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
            # the timeline's spot.reclaim capture point (one event per
            # reclaim message) comes with timeline/ in slice 6
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
        # the ledger's InterruptionReclaim record comes with
        # utils/ledger.py in slice 6
        self.cluster.nodeclaims.delete(claim.name)
        if by_pid is not None:
            by_pid.pop(instance_id, None)
