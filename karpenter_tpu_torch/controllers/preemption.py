"""Preemption controller — executes the planner's eviction plans.

The solver attaches :class:`PreemptionPlan`s to its result
(solver/preempt.py) and the provisioner stamps every victim pod with
the plan annotations (``karpenter.tpu/preempt-plan`` = plan id,
``karpenter.tpu/preempted-for`` = the target pods).  This controller
reconciles those annotations into evictions:

  * **atomic per plan** — if ANY victim fails its eviction gate
    (do-not-disrupt set after planning, or the pod turned out to be a
    daemonset), NO victim is evicted: the annotations are cleared, the
    plan counts ``outcome=blocked``, and the next provisioning pass
    replans against the new reality.  Gang victims are whole-gang
    inside one plan by planner construction, so plan atomicity IS gang
    atomicity.
  * **termination-style drain** — an evicted victim goes back to
    ``Pending`` with its node binding and nominations cleared, exactly
    how the termination path releases pods, so the next pass reschedules
    it at its own (lower) priority.
  * **ledger truth** — the reference writes one ``source="preemption"``
    record per executed plan (``reason_code=PreemptedFor``,
    ``cost_delta=0.0``); the port leaves it out until slice 6 ports
    `utils/ledger.py`.

Victims that vanished before execution (completed, already rescheduled)
make the plan ``outcome=stale`` — nothing to do, annotations of any
stragglers are cleared.
"""

from __future__ import annotations

from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.controllers.provisioning import NOMINATED_ANNOTATION
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import Pod
from karpenter_tpu_torch.utils import metrics


class Preemption:
    name = "preemption"

    def __init__(self, cluster: Cluster, cloud_provider=None):
        self.cluster = cluster
        # optional: only the ledger's fleet-cost snapshot (slice 6)
        # needs pricing
        self.cp = cloud_provider

    def reconcile(self) -> None:
        plans: dict = {}
        for pod in self.cluster.pods.list():
            pid = pod.meta.annotations.get(
                wellknown.PREEMPT_PLAN_ANNOTATION)
            if pid:
                plans.setdefault(pid, []).append(pod)
        for pid in sorted(plans):
            self._execute(pid, plans[pid])

    @staticmethod
    def _can_evict(pod: Pod) -> bool:
        return not (pod.is_daemonset or pod.do_not_disrupt())

    def _clear(self, pod: Pod) -> None:
        pod.meta.annotations.pop(wellknown.PREEMPT_PLAN_ANNOTATION, None)
        pod.meta.annotations.pop(wellknown.PREEMPT_FOR_ANNOTATION, None)
        self.cluster.pods.update(pod)

    def _execute(self, plan_id: str, victims: list) -> None:
        target = victims[0].meta.annotations.get(
            wellknown.PREEMPT_FOR_ANNOTATION, "")
        live = [p for p in victims if p.node_name]
        if not live:
            for p in victims:
                self._clear(p)
            metrics.PREEMPTIONS.inc(outcome="stale")
            return
        blocked = [p for p in live if not self._can_evict(p)]
        if blocked:
            # atomic: one blocked victim voids the WHOLE plan — a
            # partial eviction would pay the disruption without freeing
            # enough capacity to seat the target
            for p in victims:
                self._clear(p)
            metrics.PREEMPTIONS.inc(outcome="blocked")
            self.cluster.record_event(
                "Pod", blocked[0].meta.name, "PreemptionBlocked",
                f"plan {plan_id}: victim {blocked[0].meta.name} is not "
                "evictable; no victim evicted")
            return
        for p in live:
            self.cluster.record_event(
                "Pod", p.meta.name, "Preempted",
                f"plan {plan_id}: evicted for higher-priority {target}")
            p.node_name = None
            p.phase = "Pending"
            p.meta.annotations.pop(NOMINATED_ANNOTATION, None)
            self._clear(p)
        metrics.PREEMPTIONS.inc(outcome="evicted")
        # the ledger's PreemptedFor record (fleet cost before, cost delta
        # 0.0) comes with utils/ledger.py in slice 6
