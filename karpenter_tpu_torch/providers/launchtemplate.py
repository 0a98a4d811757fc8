"""Launch-template provider — ensure/cache-by-hash launch configs.

Mirrors pkg/providers/launchtemplate/launchtemplate.go: EnsureAll creates
(or reuses) one stored launch template per distinct resolved config
(:113-138, :193-224), named by a hash of the config so identical configs
dedupe; a TTL cache fronts the cloud and eviction deletes the template
(:357-374); DeleteAll removes every template a nodeclass owns (:389-418).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional

from karpenter_tpu_torch.models.objects import InstanceType, NodeClass
from karpenter_tpu_torch.providers.fake_cloud import LaunchTemplate, TAG_NODECLASS
from karpenter_tpu_torch.providers.imagefamily import ImageProvider, ResolvedLaunchConfig
from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.clock import Clock, RealClock

LAUNCH_TEMPLATE_CACHE_TTL = 600.0  # "10-minute-ish" (launchtemplate.go:357)


class LaunchTemplateProvider:
    def __init__(self, cloud, images: ImageProvider, security_groups,
                 cluster_name: str = "default-cluster",
                 clock: Optional[Clock] = None):
        self.cloud = cloud
        self.images = images
        self.security_groups = security_groups
        self.cluster_name = cluster_name
        # eviction → delete the cloud-side template (launchtemplate.go:357-374)
        self._cache = TTLCache(
            ttl=LAUNCH_TEMPLATE_CACHE_TTL, clock=clock or RealClock(),
            on_evict=lambda _key, name: self._delete_silently(name))

    def _delete_silently(self, name: str) -> None:
        try:
            self.cloud.delete_launch_template(name)
        except Exception:  # noqa: BLE001 — eviction cleanup is best-effort
            pass

    @staticmethod
    def _hash_config(cfg: ResolvedLaunchConfig) -> str:
        payload = json.dumps({
            "image": cfg.image.image_id,
            "user_data": cfg.user_data,
            "sgs": sorted(cfg.security_group_ids),
            "block_gib": cfg.block_device_gib,
            # device list / metadata exposure / instance-store policy are
            # launch parameters: a spec change must mint a NEW template,
            # not silently reuse one with stale devices
            "mappings": [m.key() for m in cfg.block_device_mappings or []],
            "metadata": (cfg.metadata_options.key()
                         if cfg.metadata_options else None),
            "store_policy": cfg.instance_store_policy,
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]

    def ensure_all(self, nc: NodeClass,
                   instance_types: List[InstanceType],
                   ) -> Dict[str, ResolvedLaunchConfig]:
        """Resolve the nodeclass + instance types into launch configs and
        make sure each exists cloud-side. Returns template-name → config
        (launchtemplate.go:113-138)."""
        sg_ids = [g.group_id for g in self.security_groups.list(nc)]
        configs = self.images.resolve(nc, instance_types,
                                      security_group_ids=sg_ids)
        out: Dict[str, ResolvedLaunchConfig] = {}
        for cfg in configs:
            name = f"karpenter-{nc.name}-{self._hash_config(cfg)}"
            if self._cache.get(name) is None:
                if not any(lt.name == name
                           for lt in self.cloud.list_launch_templates()):
                    self.cloud.create_launch_template(LaunchTemplate(
                        name=name,
                        image_id=cfg.image.image_id,
                        user_data=cfg.user_data,
                        security_group_ids=cfg.security_group_ids,
                        block_device_gib=cfg.block_device_gib,
                        block_device_mappings=cfg.block_device_mappings,
                        metadata_options=cfg.metadata_options,
                        tags={TAG_NODECLASS: nc.name,
                              "karpenter.sh/cluster": self.cluster_name},
                    ))
                self._cache.set(name, name)
            out[name] = cfg
        return out

    def invalidate(self, name: str) -> None:
        """Drop a cached template (launch-template-not-found retry path,
        instance.go:107-111)."""
        self._cache.delete(name)

    def delete_all(self, nc: NodeClass) -> int:
        """Finalizer path: remove every template the nodeclass owns
        (launchtemplate.go:389-418)."""
        n = 0
        for lt in self.cloud.list_launch_templates(
                tag_filter={TAG_NODECLASS: nc.name}):
            self.cloud.delete_launch_template(lt.name)
            self._cache.delete(lt.name)
            n += 1
        return n

    def sweep(self) -> None:
        self._cache.sweep()
