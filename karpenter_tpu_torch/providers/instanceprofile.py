"""Instance-profile provider — node identity per nodeclass role.

Mirrors pkg/providers/instanceprofile/instanceprofile.go:60-140: creates
(idempotently) one cloud-side identity profile per EC2NodeClass role, named
by a stable hash of (cluster, role) exactly as the reference derives the
profile name (pkg/apis/v1/ec2nodeclass.go:429-431), and deletes it on
nodeclass termination.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from karpenter_tpu_torch.models.objects import NodeClass


class InstanceProfileProvider:
    def __init__(self, cloud, cluster_name: str = "default-cluster",
                 region: str = "local-1"):
        self.cloud = cloud
        self.cluster_name = cluster_name
        self.region = region

    def profile_name(self, nc: NodeClass) -> str:
        h = hashlib.sha256(
            f"{self.cluster_name}/{self.region}/{nc.role}".encode()
        ).hexdigest()[:16]
        return f"{self.cluster_name}_{h}"

    def create(self, nc: NodeClass) -> str:
        name = self.profile_name(nc)
        if name not in self.cloud.instance_profiles:
            self.cloud.create_instance_profile(
                name, nc.role,
                tags={"karpenter.sh/cluster": self.cluster_name,
                      "karpenter.tpu/nodeclass": nc.name})
        return name

    def delete(self, nc: NodeClass) -> bool:
        return self.cloud.delete_instance_profile(self.profile_name(nc))

    def get(self, nc: NodeClass) -> Optional[dict]:
        return self.cloud.instance_profiles.get(self.profile_name(nc))
