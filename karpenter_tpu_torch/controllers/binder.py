"""PodBinder — the kube-scheduler's observable role in the fake cluster.

The reference relies on the real kube-scheduler to bind pending pods once
capacity registers; here nominated pods bind to their claim's node when it
is ready, and stale nominations (claim vanished — e.g. terminal launch
failure) are cleared so pods re-enter the provisioning queue.
"""

from __future__ import annotations

from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.controllers.provisioning import NOMINATED_ANNOTATION
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.taints import tolerates_all


class PodBinder:
    name = "pod-binder"

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self) -> None:
        for pod in self.cluster.pods.list(lambda p: not p.scheduled):
            claim_name = pod.meta.annotations.get(NOMINATED_ANNOTATION)
            if claim_name is None:
                continue
            claim = self.cluster.nodeclaims.get(claim_name)
            if claim is None or claim.meta.deleting:
                del pod.meta.annotations[NOMINATED_ANNOTATION]
                self.cluster.pods.update(pod)
                continue
            node = self.cluster.node_for_claim(claim)
            if node is None or not node.ready or node.meta.deleting:
                continue
            if not tolerates_all(node.taints, pod.tolerations):
                continue  # startup/unregistered taints still present
            pod.node_name = node.name
            pod.phase = "Running"
            # WaitForFirstConsumer volume binding: unbound claims bind to
            # the zone the scheduler picked (scheduling.md:381-417) — from
            # here on the pod (and any future reschedule) is zone-pinned
            zone = node.labels.get(wellknown.ZONE_LABEL)
            if zone is not None:  # a zone-less node can't pin the volume;
                for claim in pod.volume_claims:  # leave the claim unbound
                    if not claim.bound:
                        claim.bound = True
                        claim.zone = zone
            del pod.meta.annotations[NOMINATED_ANNOTATION]
            self.cluster.pods.update(pod)
