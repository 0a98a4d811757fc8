"""Garbage collection.

Two directions, mirroring pkg/controllers/nodeclaim/garbagecollection
(:54-109) and the core's cloud-side reconciliation:
  * leaked instances — cloud instances tagged to this cluster with no
    matching NodeClaim are terminated (cloud-side orphans)
  * vanished instances — claims whose instance is gone (out-of-band
    termination, spot reclaim executed) are deleted so their pods
    reschedule; orphan Node objects without claims are removed
"""

from __future__ import annotations

from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.providers.fake_cloud import INSTANCE_RUNNING
from karpenter_tpu_torch.utils import errors, metrics, tracing
from karpenter_tpu_torch.utils.logging import get_logger


class GarbageCollection:
    name = "garbagecollection"

    def __init__(self, cluster: Cluster, cloud_provider: TPUCloudProvider):
        self.cluster = cluster
        self.cp = cloud_provider

    def reconcile(self) -> None:
        try:
            # one trace per sweep: record_event stamps the active trace
            # id, so reclaim/orphan events cross-reference their pass
            # exactly like provisioning's FailedScheduling events do
            with tracing.span("gc.pass"):
                self._reconcile()
        except Exception as e:  # noqa: BLE001
            # GC is cloud-read-heavy; a transient outage just means this
            # sweep is skipped (pkg/errors taxonomy — retry next round).
            # Skipped-but-visible: a silent swallow hides a persistent
            # outage
            if not errors.is_retryable(e):
                raise
            get_logger(self.name).warn(
                "gc sweep skipped on retryable error", error=str(e)[:200])
            metrics.RECONCILE_ERRORS.inc(controller=self.name)

    def _reconcile(self) -> None:
        claims = self.cluster.nodeclaims.list()
        by_provider = {c.provider_id for c in claims if c.provider_id}

        # leaked: instance exists, claim doesn't
        for inst in self.cp.list_instances():
            if inst.state != INSTANCE_RUNNING:
                continue
            if inst.instance_id not in by_provider:
                self.cp.cloud.terminate_instances([inst.instance_id])
                self.cluster.record_event(
                    "Instance", inst.instance_id, "LeakedInstanceReclaimed",
                    "no NodeClaim references this instance")

        # owner cascade: the reference deletes a NodePool's nodes with it
        # (owner references on NodeClaims; nodepools.md — deleting a
        # NodePool drains its nodes gracefully). Ownership is keyed on the
        # pool UID like a k8s ownerReference (name-keying
        # conflated 'pool deleted' with 'pool recreated under the same
        # name between GC passes' and drained the recreated fleet). A
        # claim whose owner UID matches no live pool is deleted here,
        # which routes through the termination controller's finalizer
        # drain, not a hard kill.
        live = self.cluster.nodepools.list(lambda p: not p.meta.deleting)
        live_uids = {p.meta.uid for p in live}
        live_names = {p.name for p in live}
        for claim in claims:
            if claim.meta.deleting:
                continue
            if claim.nodepool_uid is not None:
                orphaned = claim.nodepool_uid not in live_uids
            else:
                # claims predating UID stamping (adopted via relist): the
                # name check is the only ownership signal available
                orphaned = claim.nodepool not in live_names
            if orphaned:
                self.cluster.record_event(
                    "NodeClaim", claim.name, "OwnerDeleted",
                    f"nodepool {claim.nodepool} was deleted; draining")
                self.cluster.nodeclaims.delete(claim.name)

        # vanished: claim exists, instance doesn't (or is terminated)
        for claim in claims:
            if not claim.provider_id or claim.meta.deleting:
                continue
            inst = self.cp.get(claim.provider_id)
            if inst is None or inst.state != INSTANCE_RUNNING:
                self.cluster.record_event(
                    "NodeClaim", claim.name, "InstanceTerminated",
                    "backing instance is gone; removing claim")
                self.cluster.nodeclaims.delete(claim.name)

        # orphan nodes: node object with no claim — unbind residents (their
        # machine is gone) so they re-enter the provisioning queue
        for node in self.cluster.nodes.list(lambda n: not n.meta.deleting):
            if self.cluster.claim_for_node(node) is None:
                for pod in self.cluster.pods_on_node(node.name):
                    if pod.is_daemonset:
                        continue
                    pod.node_name = None
                    pod.phase = "Pending"
                    self.cluster.pods.update(pod)
                self.cluster.nodes.delete(node.name)
