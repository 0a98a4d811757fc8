"""Version provider — control-plane Kubernetes version discovery.

Mirrors pkg/providers/version/version.go:39-90: resolves the cluster's
minor version (used by image alias resolution) with a TTL cache over the
control-plane API.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.clock import Clock, RealClock

VERSION_CACHE_TTL = 900.0  # 15 min (cache.go instance-profile-class TTL)


class VersionProvider:
    def __init__(self, cloud, clock: Optional[Clock] = None):
        self.cloud = cloud
        self._cache = TTLCache(ttl=VERSION_CACHE_TTL,
                               clock=clock or RealClock())

    def get(self) -> str:
        v = self._cache.get("version")
        if v is None:
            v = self.cloud.get_cluster_version()
            self._cache.set("version", v)
        return v
