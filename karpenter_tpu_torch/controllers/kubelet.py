"""FakeKubelet — the node agent the fake cluster needs.

In the reference's tests, envtest has no kubelet: "nodes are just CRs and
the cloud is the fake" (SURVEY §4). This controller plays the kubelet's
observable role so lifecycle semantics are exercised for real: a running
cloud instance joins as a Node (labels from its claim, unregistered taint,
not ready), then goes ready, then sheds startup taints — each on a separate
reconcile round so Launched/Registered/Initialized transitions are
individually observable.
"""

from __future__ import annotations

from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import Node, ObjectMeta
from karpenter_tpu_torch.models.taints import Taint
from karpenter_tpu_torch.providers.fake_cloud import INSTANCE_RUNNING, TAG_NODECLAIM
from karpenter_tpu_torch.utils import errors, metrics
from karpenter_tpu_torch.utils.logging import get_logger


class FakeKubelet:
    name = "fake-kubelet"

    def __init__(self, cluster: Cluster, cloud_provider: TPUCloudProvider):
        self.cluster = cluster
        self.cp = cloud_provider

    def reconcile(self) -> None:
        try:
            self._reconcile()
        except Exception as e:  # noqa: BLE001 — skip the round on outage
            if not errors.is_retryable(e):
                raise
            get_logger(self.name).warn(
                "kubelet round skipped on retryable error",
                error=str(e)[:200])
            metrics.RECONCILE_ERRORS.inc(controller=self.name)

    def _reconcile(self) -> None:
        for inst in self.cp.list_instances():
            if inst.state != INSTANCE_RUNNING:
                continue
            claim_name = inst.tags.get(TAG_NODECLAIM)
            if claim_name is None:
                continue
            claim = self.cluster.nodeclaims.get(claim_name)
            if claim is None:
                continue
            node = self.cluster.node_for_claim(claim)
            if node is None:
                self._join(claim, inst)
            elif not node.ready:
                node.ready = True
                self.cluster.nodes.update(node)
            else:
                self._shed_startup_taints(claim, node)

    def _join(self, claim, inst) -> None:
        labels = {}
        for req in claim.requirements:
            if req.is_finite() and len(req.values()) == 1:
                (labels[req.key],) = req.values()
        labels[wellknown.NODEPOOL_LABEL] = claim.nodepool
        labels[wellknown.HOSTNAME_LABEL] = claim.name
        node = Node(
            meta=ObjectMeta(name=claim.name, labels=labels),
            provider_id=inst.instance_id,
            capacity=claim.capacity.copy(),
            allocatable=claim.allocatable.copy(),
            taints=(list(claim.taints) + list(claim.startup_taints)
                    + [Taint(wellknown.UNREGISTERED_TAINT_KEY)]),
            ready=False,
        )
        try:
            self.cluster.nodes.create(node)
        except ValueError:
            # AlreadyExists: a replica losing leadership can race its
            # successor inside the brief dual-writer window (k8s absorbs
            # this as an apiserver 409) — the node is joined either way
            pass

    def _shed_startup_taints(self, claim, node) -> None:
        """One reconcile round after readiness, the 'CNI-style' agents the
        startup taints wait for come up and remove them."""
        startup_keys = {t.key for t in claim.startup_taints}
        if not startup_keys:
            return
        before = len(node.taints)
        node.taints = [t for t in node.taints if t.key not in startup_keys]
        if len(node.taints) != before:
            self.cluster.nodes.update(node)
