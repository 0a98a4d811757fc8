"""Image-family resolver — the AMI-family analogue.

Mirrors pkg/providers/amifamily: a family interface (resolver.go:79-86)
with per-family bootstrap user-data, dispatched by name
(resolver.go:163-180); image discovery combines release-channel alias
resolution (the SSM path in ami.go) with explicit selector terms, and
newest-creation-time wins among candidates. Resolve() groups instance
types by which discovered image can boot them (per-(image ×
instance-type-group) launch parameters, resolver.go:122-161).

Families here are TPU/GCE-flavored: "cos" (Container-Optimized OS — the
AL2023 role), "ubuntu", and "custom" (selector terms only, no alias, no
generated user-data — amifamily/custom.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.models.objects import (
    BlockDevice,
    BlockDeviceMapping,
    InstanceType,
    NodeClass,
    match_selector_terms,
)
from karpenter_tpu_torch.providers.fake_cloud import MachineImage
from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.clock import Clock, RealClock

IMAGE_CACHE_TTL = 60.0


@dataclass
class ResolvedLaunchConfig:
    """One (image × compatible-instance-type-group) launch parameter set —
    the reference's amifamily.LaunchTemplate (resolver.go:122-161)."""
    image: MachineImage
    instance_type_names: List[str]
    user_data: str
    block_device_gib: int = 100
    security_group_ids: List[str] = field(default_factory=list)
    # full device list + metadata exposure (resolver.go:94-100 carries
    # the family's default block devices and the class's metadata
    # options into every launch template)
    block_device_mappings: Optional[list] = None
    metadata_options: Optional[object] = None
    instance_store_policy: Optional[str] = None


class ImageFamily:
    """Family interface (resolver.go:79-86): alias for discovery, the
    bootstrap script the node runs to join the cluster, and the family's
    default block devices (resolver.go:94-100 — each reference family
    ships its own DefaultBlockDeviceMappings; an explicit spec always
    wins)."""

    name = "base"

    def user_data(self, cluster_name: str, k8s_version: str,
                  nc: NodeClass) -> str:
        raise NotImplementedError

    def default_block_device_mappings(self, nc: NodeClass):
        """The mappings a node boots with when the class doesn't pin any
        (reference: amifamily defaults; e.g. Bottlerocket's two-volume
        layout vs AL2's single root). Base: one root at the class's
        legacy scalar size."""
        return [BlockDeviceMapping(
            device_name="/dev/sda1",
            ebs=BlockDevice(volume_size_gib=nc.block_device_gib),
            root_volume=True)]


class COSFamily(ImageFamily):
    name = "cos"

    def user_data(self, cluster_name, k8s_version, nc):
        base = (f"#cloud-config\n# join {cluster_name} (k8s {k8s_version})\n"
                f"runcmd:\n- kubelet --bootstrap --cluster {cluster_name}\n")
        return base + nc.user_data


class UbuntuFamily(ImageFamily):
    name = "ubuntu"

    def user_data(self, cluster_name, k8s_version, nc):
        base = (f"#!/bin/bash\n/etc/kubernetes/bootstrap.sh "
                f"--cluster {cluster_name} --kube-version {k8s_version}\n")
        return base + nc.user_data


class AccelFamily(ImageFamily):
    """Accelerator-optimized family: a small OS root plus a separate
    scratch volume for model/images — the two-volume layout of the
    reference's Bottlerocket family (bottlerocket.go DefaultBlockDevice-
    Mappings: 4Gi root + data volume), reshaped for accelerator nodes."""
    name = "accel"
    ROOT_GIB = 8
    MIN_DATA_GIB = 200

    def user_data(self, cluster_name, k8s_version, nc):
        base = (f"#cloud-config\n# accel node join {cluster_name} "
                f"(k8s {k8s_version})\nruncmd:\n"
                f"- kubelet --bootstrap --cluster {cluster_name} "
                f"--accelerator-runtime\n")
        return base + nc.user_data

    def default_block_device_mappings(self, nc: NodeClass):
        return [
            BlockDeviceMapping(device_name="/dev/sda1",
                               ebs=BlockDevice(volume_size_gib=self.ROOT_GIB),
                               root_volume=True),
            # the DATA volume takes the class's size knob: accel nodes
            # grow scratch, not OS root
            BlockDeviceMapping(device_name="/dev/sdb", ebs=BlockDevice(
                volume_size_gib=max(nc.block_device_gib,
                                    self.MIN_DATA_GIB))),
        ]


class CustomFamily(ImageFamily):
    """Selector-terms-only: the user supplies the full user-data
    (amifamily/custom.go)."""
    name = "custom"

    def user_data(self, cluster_name, k8s_version, nc):
        return nc.user_data


FAMILIES: Dict[str, ImageFamily] = {
    f.name: f for f in (COSFamily(), UbuntuFamily(), AccelFamily(),
                        CustomFamily())
}


def get_family(name: str) -> ImageFamily:
    """Dispatch by family name, defaulting like GetAMIFamily
    (resolver.go:163-180)."""
    return FAMILIES.get(name, FAMILIES["cos"])


def effective_block_device_mappings(nc: NodeClass):
    """The device list a node of this class actually boots with: an
    explicit spec wins, else the family's defaults — ONE definition
    shared by launch (resolve → launch template) and allocatable math
    (providers/instancetype.apply_node_class), so the scheduler's
    ephemeral-storage view can never diverge from the disk the node gets
    (the reference resolves both from the same amifamily defaults,
    resolver.go:94-100 + types.go ephemeral math)."""
    if nc.block_device_mappings is not None:
        return nc.block_device_mappings
    return get_family(nc.image_family).default_block_device_mappings(nc)


def root_volume_gib_of(mappings, fallback: int) -> int:
    """Root size of a device list (mapping flagged root, else first, else
    the legacy scalar) — NodeClass.root_volume_gib over an arbitrary
    list."""
    for m in mappings or []:
        if m.root_volume and m.ebs.volume_size_gib:
            return m.ebs.volume_size_gib
    if mappings and mappings[0].ebs.volume_size_gib:
        return mappings[0].ebs.volume_size_gib
    return fallback


class ImageProvider:
    def __init__(self, cloud, version_provider,
                 cluster_name: str = "default-cluster",
                 clock: Optional[Clock] = None):
        self.cloud = cloud
        self.versions = version_provider
        self.cluster_name = cluster_name
        self._cache = TTLCache(ttl=IMAGE_CACHE_TTL,
                               clock=clock or RealClock())

    def list(self, nc: NodeClass) -> List[MachineImage]:
        """Discovered images, newest first (ami.go newest-wins)."""
        key = ("images", nc.name, nc.static_hash())
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        out: List[MachineImage] = []
        terms = nc.image_selector_terms
        if terms:
            for img in self.cloud.describe_images():
                if img.deprecated:
                    continue
                if match_selector_terms(terms, img.image_id, img.name,
                                        img.tags):
                    out.append(img)
        elif nc.image_family != "custom":
            # release-channel alias → latest image of the family; variants
            # (e.g. accelerator builds) of the same generation come along
            alias = self.cloud.resolve_image_alias(
                nc.image_family, self.versions.get())
            if alias is not None:
                base = self.cloud.images[alias]
                for img in self.cloud.describe_images():
                    if (img.family == nc.image_family and not img.deprecated
                            and img.creation_time == base.creation_time):
                        out.append(img)
        out.sort(key=lambda i: (-i.creation_time, i.image_id))
        self._cache.set(key, out)
        return out

    def resolve(self, nc: NodeClass, instance_types: List[InstanceType],
                security_group_ids: Optional[List[str]] = None,
                ) -> List[ResolvedLaunchConfig]:
        """Group instance types under the newest image whose requirements
        admit them (resolver.go:122-161)."""
        images = self.list(nc)
        if not images:
            return []
        family = get_family(nc.image_family)
        ud = family.user_data(self.cluster_name, self.versions.get(), nc)
        mappings = effective_block_device_mappings(nc)
        # specific variants (accelerator builds) outrank plain images of the
        # same generation; then newest wins
        images = sorted(images, key=lambda i: (-len(i.requirements),
                                               -i.creation_time, i.image_id))
        assigned: Dict[str, List[str]] = {}
        for it in instance_types:
            for img in images:  # first admitting image wins
                if self._image_admits(img, it):
                    assigned.setdefault(img.image_id, []).append(it.name)
                    break
        by_id = {img.image_id: img for img in images}
        return [
            ResolvedLaunchConfig(
                image=by_id[iid], instance_type_names=names, user_data=ud,
                # one source of truth: the scalar is the ROOT of the
                # effective device list, never an independent knob
                block_device_gib=root_volume_gib_of(
                    mappings, nc.block_device_gib),
                security_group_ids=list(security_group_ids or []),
                block_device_mappings=mappings,
                metadata_options=nc.metadata_options,
                instance_store_policy=nc.instance_store_policy)
            for iid, names in assigned.items()
        ]

    @staticmethod
    def _image_admits(img: MachineImage, it: InstanceType) -> bool:
        """An image with requirements only boots matching types (accelerator
        variants). "*" means the label must exist with any value. Plain
        images admit every type."""
        for key, values in img.requirements.items():
            req = it.requirements.get(key)
            if req is None:
                return False
            if "*" in values:
                continue
            if not any(req.matches(v) for v in values):
                return False
        return True
