"""Expiration — nodes past their NodePool `expireAfter` are replaced.

Reference: NodePool.spec.template.spec.expireAfter
(karpenter.sh_nodepools.yaml) — expiration deletes the claim; the
termination flow drains it and the provisioner replaces the capacity.

The port's copy of `karpenter_tpu/controllers/expiration.py`.  The
reference writes one decision-ledger record an expiry
(`utils/ledger.py`); that call is left out until slice 6 ports the
ledger.
"""

from __future__ import annotations

from karpenter_tpu_torch.cluster import Cluster


class Expiration:
    name = "expiration"

    def __init__(self, cluster: Cluster, cloud_provider=None):
        self.cluster = cluster
        # optional: only needed for the ledger's pricing lookups — the
        # controller's own logic is pure clock-vs-expireAfter
        self.cp = cloud_provider

    def reconcile(self) -> None:
        now = self.cluster.clock.now()
        for claim in self.cluster.nodeclaims.list(lambda c: not c.meta.deleting):
            pool = self.cluster.nodepools.get(claim.nodepool)
            if pool is None or pool.expire_after is None:
                continue
            if claim.launch_time is None:
                continue
            if now - claim.launch_time >= pool.expire_after:
                self.cluster.record_event(
                    "NodeClaim", claim.name, "Expired",
                    f"older than expireAfter={pool.expire_after}s")
                # the ledger's NodeExpired record comes with
                # utils/ledger.py in slice 6
                self.cluster.nodeclaims.delete(claim.name)
