"""Termination controller — the graceful drain state machine.

Mirrors website/.../disruption.md:29-36 + designs/termination.md: when a
NodeClaim is deleted its finalizer holds it while we (1) taint the node
`karpenter.sh/disrupted:NoSchedule`, (2) evict evictable pods through the
PDB-aware eviction budget (daemonsets stay), (3) once drained, call
CloudProvider.Delete, strip the finalizer, and remove the node object.
Evicted pods return to Pending and re-enter the provisioning queue.

The port's copy of `karpenter_tpu/controllers/termination.py`.  The
decision ledger's settlement record (`ledger.record_claim_delete` with
the pass's running fleet $/hr) is left out until slice 6 ports
`utils/ledger.py`.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.controllers.provisioning import NOMINATED_ANNOTATION
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import NodeClaim
from karpenter_tpu_torch.models.taints import NO_SCHEDULE, Taint
from karpenter_tpu_torch.utils import errors, metrics

DISRUPTED_TAINT = Taint(wellknown.DISRUPTED_TAINT_KEY, "", NO_SCHEDULE)


class Termination:
    name = "termination"

    def __init__(self, cluster: Cluster, cloud_provider: TPUCloudProvider):
        self.cluster = cluster
        self.cp = cloud_provider

    def reconcile(self) -> None:
        for claim in list(self.cluster.nodeclaims.list(
                lambda c: c.meta.deleting)):
            self._terminate(claim)

    def _terminate(self, claim: NodeClaim) -> None:
        node = self.cluster.node_for_claim(claim)
        if node is not None:
            if not any(t.key == wellknown.DISRUPTED_TAINT_KEY
                       for t in node.taints):
                node.taints.append(DISRUPTED_TAINT)
                self.cluster.nodes.update(node)
            # terminationGracePeriod (NodePool template): once a deleting
            # claim has waited this long, the drain stops honoring PDBs —
            # the bounded-drain contract; pods are force-evicted and the
            # instance released (reference: NodeClaim terminationGracePeriod)
            force = self._grace_expired(claim)
            remaining = self._drain(node.name, force=force)
            if remaining > 0:
                return  # PDBs throttle the drain; retry next round
        # drained (or node never joined): release the instance + objects.
        # NotFound is success (the instance is already gone); transient cloud
        # errors keep the finalizer for a retry next round
        # (pkg/errors/errors.go taxonomy)
        # the ledger's settlement inputs (the node's price, the pass's
        # running fleet $/hr), read before the release, come with
        # utils/ledger.py in slice 6
        try:  # noqa: E501 — see taxonomy note below
            self.cp.delete(claim)
        except Exception as e:  # noqa: BLE001
            if errors.is_retryable(e):
                self.cluster.record_event(
                    "NodeClaim", claim.name, "TerminationRetryable", str(e))
                return
            if not errors.is_not_found(e):
                raise
        if node is not None and not node.meta.deleting:
            self.cluster.nodes.delete(node.name)
        self.cluster.nodeclaims.remove_finalizer(
            claim.name, wellknown.TERMINATION_FINALIZER)
        metrics.NODECLAIMS_TERMINATED.inc(nodepool=claim.nodepool)
        self.cluster.record_event(
            "NodeClaim", claim.name, "Terminated", "instance released")
        # the ledger's NodeTerminated settlement record
        # (ledger.record_claim_delete, pods_affected=0) comes with
        # utils/ledger.py in slice 6

    def _grace_expired(self, claim: NodeClaim) -> bool:
        # stamped on the claim at creation; live-pool fallback covers
        # claims created before the field existed. Claims whose pool was
        # deleted (the gc owner cascade) keep their stamped grace.
        grace = claim.termination_grace_period
        if grace is None:
            pool = self.cluster.nodepools.get(claim.nodepool)
            grace = (pool.termination_grace_period
                     if pool is not None else None)
        if grace is None or claim.meta.deletion_time is None:
            return False
        expired = (self.cluster.clock.now() - claim.meta.deletion_time
                   >= grace)
        if expired:
            self.cluster.record_event(
                "NodeClaim", claim.name, "TerminationGraceElapsed",
                f"draining past terminationGracePeriod={grace}s; "
                "eviction no longer waits for PDBs")
        return expired

    def _drain(self, node_name: str, force: bool = False) -> int:
        """Evict what the budgets allow (everything evictable when
        `force` — grace elapsed); returns count of pods still to evict
        (excluding daemonsets)."""
        remaining = 0
        for pod in self.cluster.pods_on_node(node_name):
            if pod.is_daemonset:
                continue
            if not force and not self.cluster.can_evict(pod):
                remaining += 1
                continue
            pod.node_name = None
            pod.phase = "Pending"
            pod.meta.annotations.pop(NOMINATED_ANNOTATION, None)
            self.cluster.pods.update(pod)
        return remaining
