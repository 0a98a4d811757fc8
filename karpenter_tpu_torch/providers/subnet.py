"""Subnet provider — discovery + IP-exhaustion-aware zonal choice.

Mirrors pkg/providers/subnet/subnet.go: List discovers subnets matching the
nodeclass selector terms (:78-124); ZonalSubnetsForLaunch picks, per zone,
the subnet with the most free IPs (:126-173); UpdateInflightIPs decrements
the predicted free-IP count after each launch so concurrent launches don't
all pile into a nearly-exhausted subnet (:175-234).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from karpenter_tpu_torch.models.objects import NodeClass, match_selector_terms
from karpenter_tpu_torch.providers.fake_cloud import Subnet, TAG_CLUSTER
from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.clock import Clock, RealClock

SUBNET_CACHE_TTL = 60.0  # pkg/cache/cache.go default 1 min


class SubnetProvider:
    def __init__(self, cloud, cluster_name: str = "default-cluster",
                 clock: Optional[Clock] = None):
        self.cloud = cloud
        self.cluster_name = cluster_name
        self.clock = clock or RealClock()
        self._cache = TTLCache(ttl=SUBNET_CACHE_TTL, clock=self.clock)
        # predicted free IPs for in-flight launches, keyed by subnet id
        self._inflight: Dict[str, int] = {}
        self._lock = threading.Lock()

    def list(self, nc: NodeClass) -> List[Subnet]:
        key = ("subnets", nc.name, nc.static_hash())
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        subnets = self.cloud.describe_subnets()
        terms = nc.subnet_selector_terms
        if terms is None:
            out = [s for s in subnets
                   if s.tags.get(TAG_CLUSTER) == self.cluster_name]
        else:
            out = [s for s in subnets
                   if match_selector_terms(terms, s.subnet_id, s.subnet_id,
                                           s.tags)]
        if nc.zones:
            out = [s for s in out if s.zone in nc.zones]
        self._cache.set(key, out)
        return out

    def zonal_subnets_for_launch(self, nc: NodeClass) -> Dict[str, Subnet]:
        """zone → best subnet (most predicted-free IPs), skipping exhausted
        ones (subnet.go:126-173)."""
        best: Dict[str, Subnet] = {}
        with self._lock:
            for s in self.list(nc):
                free = s.available_ips - self._inflight.get(s.subnet_id, 0)
                if free <= 0:
                    continue
                cur = best.get(s.zone)
                if cur is None or free > (
                        cur.available_ips
                        - self._inflight.get(cur.subnet_id, 0)):
                    best[s.zone] = s
        return best

    def update_inflight_ips(self, subnet_id: str, count: int = 1) -> None:
        """Record IPs consumed by a launch before the cloud's own free-IP
        count catches up (subnet.go:175-234)."""
        with self._lock:
            self._inflight[subnet_id] = self._inflight.get(subnet_id, 0) + count

    def reset_inflight(self) -> None:
        """Called when the subnet cache refreshes — the cloud's counts are
        authoritative again."""
        with self._lock:
            self._inflight.clear()

    def live(self) -> bool:
        try:
            self.cloud.describe_subnets()
            return True
        except Exception:  # noqa: BLE001
            return False
