"""NodeClaim tagging controller.

Mirrors pkg/controllers/nodeclaim/tagging/controller.go:56-119: once a
NodeClaim registers (its node joined), tag the backing instance with the
claim/node identity so cloud-side inventory tooling can attribute it.
Tagging is post-registration because the node name only exists then.
"""

from __future__ import annotations

from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.models.objects import COND_REGISTERED
from karpenter_tpu_torch.utils import errors, metrics
from karpenter_tpu_torch.utils.logging import get_logger

TAG_NAME = "Name"
TAG_MANAGED_BY = "karpenter.tpu/managed-by"


class NodeClaimTagging:
    name = "nodeclaim-tagging"

    def __init__(self, cluster: Cluster, cloud,
                 cluster_name: str = "default-cluster"):
        self.cluster = cluster
        self.cloud = cloud
        self.cluster_name = cluster_name

    def reconcile(self) -> None:
        try:
            self._reconcile()
        except Exception as e:  # noqa: BLE001 — tagging is cosmetic; retry
            if not errors.is_retryable(e):
                raise
            get_logger(self.name).warn(
                "tagging pass skipped on retryable error",
                error=str(e)[:200])
            metrics.RECONCILE_ERRORS.inc(controller=self.name)

    def _reconcile(self) -> None:
        for claim in self.cluster.nodeclaims.list():
            if not claim.is_(COND_REGISTERED) or not claim.provider_id:
                continue
            inst = self.cloud.get_instance(claim.provider_id)
            if inst is None or TAG_NAME in inst.tags:
                continue
            self.cloud.create_tags(claim.provider_id, {
                TAG_NAME: claim.node_name or claim.name,
                TAG_MANAGED_BY: self.cluster_name,
            })
