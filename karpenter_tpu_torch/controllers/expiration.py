"""Expiration — nodes past their NodePool `expireAfter` are replaced.

Reference: NodePool.spec.template.spec.expireAfter
(karpenter.sh_nodepools.yaml) — expiration deletes the claim; the
termination flow drains it and the provisioner replaces the capacity.
Each expiry writes one decision-ledger record (utils/ledger.py): the
expired node's $/hr leaves the fleet now, and the replacement capacity
shows up as a later provisioning launch record.

The port's copy of `karpenter_tpu/controllers/expiration.py`, with its
decision-ledger record an expiry (`utils/ledger.py`).
"""

from __future__ import annotations

from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.utils import ledger


class Expiration:
    name = "expiration"

    def __init__(self, cluster: Cluster, cloud_provider=None):
        self.cluster = cluster
        # optional: only needed for the ledger's pricing lookups — the
        # controller's own logic is pure clock-vs-expireAfter
        self.cp = cloud_provider
        # per-reconcile running fleet $/hr + pods-by-node index: a
        # pool-wide expireAfter sweep deletes many claims in ONE pass —
        # walk the fleet (and the pod list) once, then advance by each
        # record's own delta (interruption's drain-scoped discipline,
        # not O(expired × fleet))
        self._pass_fleet_cost = None
        self._pass_cache: dict = {}

    def reconcile(self) -> None:
        self._pass_fleet_cost = None
        self._pass_cache = {}
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
                self._ledger_expiry(claim, pool)
                self.cluster.nodeclaims.delete(claim.name)

    def _ledger_expiry(self, claim, pool) -> None:
        from karpenter_tpu_torch.solver import explain as explainmod
        if ledger.LEDGER.enabled and self._pass_fleet_cost is None:
            pricing = getattr(getattr(self.cp, "instance_types", None),
                              "pricing", None)
            self._pass_fleet_cost = ledger.fleet_cost(
                self.cluster, pricing)["total"]
        rec = ledger.record_claim_delete(
            self.cluster, self.cp, claim,
            source="expiration", reason_code=explainmod.NODE_EXPIRED,
            detail=f"{claim.name} older than "
                   f"expireAfter={pool.expire_after}s",
            fleet_before=self._pass_fleet_cost,
            pass_cache=self._pass_cache)
        if rec is not None:
            self._pass_fleet_cost += rec.cost_delta
