"""Security-group provider — discovery by selector terms.

Mirrors pkg/providers/securitygroup/securitygroup.go:55-96: resolves the
nodeclass's security-group selector terms (id / name / tags, OR across
terms) against the cloud, with the standard 1-minute TTL cache.
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.models.objects import NodeClass, match_selector_terms
from karpenter_tpu_torch.providers.fake_cloud import SecurityGroup, TAG_CLUSTER
from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.clock import Clock, RealClock

SECURITY_GROUP_CACHE_TTL = 60.0


class SecurityGroupProvider:
    def __init__(self, cloud, cluster_name: str = "default-cluster",
                 clock: Optional[Clock] = None):
        self.cloud = cloud
        self.cluster_name = cluster_name
        self._cache = TTLCache(ttl=SECURITY_GROUP_CACHE_TTL,
                               clock=clock or RealClock())

    def list(self, nc: NodeClass) -> List[SecurityGroup]:
        key = ("sgs", nc.name, nc.static_hash())
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        groups = self.cloud.describe_security_groups()
        terms = nc.security_group_selector_terms
        if terms is None:
            out = [g for g in groups
                   if g.tags.get(TAG_CLUSTER) == self.cluster_name]
        else:
            out = [g for g in groups
                   if match_selector_terms(terms, g.group_id, g.group_name,
                                           g.tags)]
        self._cache.set(key, out)
        return out
