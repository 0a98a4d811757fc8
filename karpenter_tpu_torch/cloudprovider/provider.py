"""TPUCloudProvider — Create/Delete/Get/List/GetInstanceTypes/IsDrifted.

Mirrors the reference implementation's behavior:
  Create     pkg/cloudprovider/cloudprovider.go:80-124 → resolve NodeClass
             (Ready gate :99-102), filter instance types by requirements +
             fits + offering availability (:267-282), then the instance
             provider's launch path (pkg/providers/instance/instance.go:95-117):
             exotic-type deprioritization (:456-477), spot-over-OD choice
             (:372-385), drop spot pricier than cheapest OD (:429-451),
             truncate to 60 types (:54), ranked (type × zone × capacity-type)
             overrides to one fleet call, ICE errors → unavailableOfferings
             (:361-367).
  Delete     batched terminate (terminateinstances.go) — NotFound is success.
  List/Get   tag-scoped instance discovery → NodeClaim reconstruction
             (cloudprovider.go:126-165, :321-375).
  IsDrifted  nodeclass-hash annotation comparison (pkg/cloudprovider/drift.go).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import (
    COND_LAUNCHED,
    InstanceType,
    NodeClaim,
    NodeClass,
)
from karpenter_tpu_torch.models.requirements import Requirement
from karpenter_tpu_torch.providers.fake_cloud import (
    CloudInstance,
    FakeCloud,
    FleetCandidate,
    LaunchTemplateNotFound,
    TAG_CLUSTER,
    TAG_NODECLAIM,
    TAG_NODECLASS,
    TAG_NODEPOOL,
)
from karpenter_tpu_torch.providers.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.utils.cache import UnavailableOfferings

MAX_INSTANCE_TYPES = 60  # pkg/providers/instance/instance.go:54


class CloudProviderError(Exception):
    pass


class NodeClassNotReady(CloudProviderError):
    pass


class InsufficientCapacity(CloudProviderError):
    """Every candidate pool returned an ICE; the claim should retry after
    the unavailable-offering TTL (pkg/cache/cache.go:29)."""


class TPUCloudProvider:
    def __init__(
        self,
        cloud: FakeCloud,
        instance_types: InstanceTypeProvider,
        unavailable: UnavailableOfferings,
        node_classes,  # Store of NodeClass
        cluster_name: str = "default-cluster",
        subnets=None,  # SubnetProvider (optional plumbing)
        launch_templates=None,  # LaunchTemplateProvider
        security_groups=None,  # SecurityGroupProvider (drift inputs)
        images=None,  # ImageProvider (drift inputs)
    ):
        self.cloud = cloud
        self.instance_types = instance_types
        self.unavailable = unavailable
        self.node_classes = node_classes
        self.cluster_name = cluster_name
        self.subnets = subnets
        self.launch_templates = launch_templates
        self.security_groups = security_groups
        self.images = images

    # -- instance types ---------------------------------------------------
    def get_instance_types(self, node_class_ref: str) -> List[InstanceType]:
        nc = self.node_classes.get(node_class_ref)
        if nc is None:
            return []
        return self.instance_types.list(nc)

    # -- create -----------------------------------------------------------
    def create(self, claim: NodeClaim) -> CloudInstance:
        nc: Optional[NodeClass] = self.node_classes.get(claim.node_class_ref)
        if nc is None:
            raise CloudProviderError(
                f"nodeclass {claim.node_class_ref} not found")
        if not nc.ready:
            raise NodeClassNotReady(
                f"nodeclass {nc.name} is not ready")

        types = self._resolve_instance_types(claim, nc)
        if not types:
            raise CloudProviderError(
                "all requested instance types were unavailable during launch")

        candidates = self._fleet_candidates(claim, types, nc)
        try:
            inst, ice = self.cloud.create_fleet(
                candidates, tags=self._tags(claim))
        except LaunchTemplateNotFound as err:
            # a template the cache thought existed is gone: invalidate and
            # retry once (instance.go:107-111)
            if self.launch_templates is not None:
                self.launch_templates.invalidate(str(err))
            candidates = self._fleet_candidates(claim, types, nc)
            inst, ice = self.cloud.create_fleet(
                candidates, tags=self._tags(claim))
        for cap_type, itype, zone in ice:
            self.unavailable.mark_unavailable(cap_type, itype, zone)
        if inst is None:
            raise InsufficientCapacity(
                f"no capacity in {len(ice)} candidate pools")
        if self.subnets is not None:
            chosen_cand = next(
                (c for c in candidates
                 if c.instance_type == inst.instance_type
                 and c.zone == inst.zone
                 and c.capacity_type == inst.capacity_type), None)
            if chosen_cand is not None and chosen_cand.subnet_id:
                self.subnets.update_inflight_ips(chosen_cand.subnet_id)

        by_name = {it.name: it for it in types}
        chosen = by_name[inst.instance_type]
        claim.provider_id = inst.instance_id
        claim.capacity = chosen.capacity
        claim.allocatable = chosen.allocatable()
        claim.launch_time = inst.launch_time
        claim.set_condition(COND_LAUNCHED)
        # stamp resolved single-valued labels onto the claim requirements
        for key, val in self._instance_labels(inst, chosen).items():
            claim.requirements.add(Requirement.single(key, val))
        return inst

    def _resolve_instance_types(self, claim: NodeClaim,
                                nc: NodeClass) -> List[InstanceType]:
        """Filter + order the claim's instance types for launch
        (cloudprovider.go:267-282 + instance.go:389-397)."""
        all_types = {it.name: it for it in self.instance_types.list(nc)}
        wanted = claim.instance_type_options or list(all_types)
        out = []
        for name in wanted:
            it = all_types.get(name)
            if it is None:
                continue
            if not it.requirements.compatible(claim.requirements):
                continue
            if not claim.resource_requests.fits(it.allocatable()):
                continue
            if not it.available_offerings(claim.requirements):
                continue
            out.append(it)
        out = self._filter_exotic(claim, out)
        out = self._prefer_capacity_type(claim, out)
        out.sort(key=lambda it: (
            it.cheapest_offering(claim.requirements).price, it.name))
        return out[:MAX_INSTANCE_TYPES]

    def _filter_exotic(self, claim: NodeClaim,
                       types: List[InstanceType]) -> List[InstanceType]:
        """Drop GPU/accelerator shapes unless requested — launching exotic
        capacity for generic pods wastes money (instance.go:456-477)."""
        if claim.resource_requests.get("gpu") > 0:
            return types
        plain = [it for it in types if it.capacity.get("gpu") == 0]
        return plain or types

    def _prefer_capacity_type(self, claim: NodeClaim,
                              types: List[InstanceType]) -> List[InstanceType]:
        """If the claim allows both spot and on-demand, launch spot, and
        drop spot offerings pricier than the cheapest on-demand
        (instance.go:372-385, :429-451)."""
        ct_req = claim.requirements.get(wellknown.CAPACITY_TYPE_LABEL)
        allows_spot = ct_req is None or ct_req.matches(wellknown.CAPACITY_TYPE_SPOT)
        if not allows_spot:
            return types
        cheapest_od = min(
            (o.price for it in types
             for o in it.available_offerings(claim.requirements)
             if o.capacity_type == wellknown.CAPACITY_TYPE_ON_DEMAND),
            default=None)
        out = []
        for it in types:
            spot_offs = [
                o for o in it.available_offerings(claim.requirements)
                if o.capacity_type == wellknown.CAPACITY_TYPE_SPOT
                and (cheapest_od is None or o.price <= cheapest_od)
            ]
            if spot_offs:
                out.append(it)
        return out or types

    def _fleet_candidates(self, claim: NodeClaim, types: List[InstanceType],
                          nc: Optional[NodeClass] = None,
                          ) -> List[FleetCandidate]:
        """(type × zone × capacity-type) overrides ranked by price, crossed
        with the zonal subnet choice and the per-type launch template — the
        price-capacity-optimized allocation input (instance.go:323-359)."""
        ct_req = claim.requirements.get(wellknown.CAPACITY_TYPE_LABEL)
        allows_spot = ct_req is None or ct_req.matches(wellknown.CAPACITY_TYPE_SPOT)
        zonal = None
        if self.subnets is not None and nc is not None:
            zonal = self.subnets.zonal_subnets_for_launch(nc)
        lt_by_type: Dict[str, str] = {}
        if self.launch_templates is not None and nc is not None:
            for lt_name, cfg in self.launch_templates.ensure_all(
                    nc, types).items():
                for tname in cfg.instance_type_names:
                    lt_by_type[tname] = lt_name

        def mk(it, o) -> Optional[FleetCandidate]:
            subnet_id = None
            if zonal is not None:
                subnet = zonal.get(o.zone)
                if subnet is None:
                    return None  # no launchable subnet in this zone
                subnet_id = subnet.subnet_id
            return FleetCandidate(
                instance_type=it.name, zone=o.zone,
                capacity_type=o.capacity_type, price=o.price,
                subnet_id=subnet_id,
                launch_template=lt_by_type.get(it.name))

        cands = []
        for it in types:
            for o in it.available_offerings(claim.requirements):
                if allows_spot and o.capacity_type != wellknown.CAPACITY_TYPE_SPOT:
                    continue  # spot-capable claims launch spot
                c = mk(it, o)
                if c is not None:
                    cands.append(c)
        if not cands:  # no spot offerings at all — fall back to whatever exists
            for it in types:
                for o in it.available_offerings(claim.requirements):
                    c = mk(it, o)
                    if c is not None:
                        cands.append(c)
        cands.sort(key=lambda c: (c.price, c.instance_type, c.zone))
        return cands

    def _tags(self, claim: NodeClaim) -> Dict[str, str]:
        return {
            TAG_CLUSTER: self.cluster_name,
            TAG_NODEPOOL: claim.nodepool,
            TAG_NODECLAIM: claim.name,
            TAG_NODECLASS: claim.node_class_ref,
        }

    def _instance_labels(self, inst: CloudInstance,
                         it: InstanceType) -> Dict[str, str]:
        labels = {
            wellknown.INSTANCE_TYPE_LABEL: inst.instance_type,
            wellknown.ZONE_LABEL: inst.zone,
            wellknown.CAPACITY_TYPE_LABEL: inst.capacity_type,
        }
        for req in it.requirements:
            if req.is_finite() and len(req.values()) == 1:
                (labels[req.key],) = req.values()
        return labels

    # -- delete / get / list ---------------------------------------------
    def delete(self, claim: NodeClaim) -> bool:
        """NotFound is success (pkg/errors/errors.go)."""
        if claim.provider_id:
            self.cloud.terminate_instances([claim.provider_id])
        return True

    def get(self, provider_id: str) -> Optional[CloudInstance]:
        return self.cloud.get_instance(provider_id)

    def list_instances(self) -> List[CloudInstance]:
        """Cluster-scoped discovery by tag (instance.go:140-160)."""
        return self.cloud.describe_instances(
            tag_filter={TAG_CLUSTER: self.cluster_name})

    # -- drift ------------------------------------------------------------
    def is_drifted(self, claim: NodeClaim) -> Optional[str]:
        """Drift reasons mirror pkg/cloudprovider/drift.go:35-38
        (AMIDrift→ImageDrift, SubnetDrift, SecurityGroupDrift,
        NodeClassDrift): compare the live instance's launch provenance
        against what the nodeclass would resolve today."""
        nc = self.node_classes.get(claim.node_class_ref)
        if nc is None:
            return None
        stamped = claim.meta.annotations.get(wellknown.NODECLASS_HASH_ANNOTATION)
        if stamped is not None and stamped != nc.static_hash():
            return "NodeClassDrift"
        inst = self.get(claim.provider_id) if claim.provider_id else None
        if inst is None:
            return None
        if self.images is not None and inst.image_id is not None:
            wanted = {img.image_id for img in self.images.list(nc)}
            if wanted and inst.image_id not in wanted:
                return "ImageDrift"
        if self.subnets is not None and inst.subnet_id is not None:
            wanted = {s.subnet_id for s in self.subnets.list(nc)}
            if wanted and inst.subnet_id not in wanted:
                return "SubnetDrift"
        if self.security_groups is not None and inst.security_group_ids:
            wanted = {g.group_id for g in self.security_groups.list(nc)}
            if wanted and not set(inst.security_group_ids) <= wanted:
                return "SecurityGroupDrift"
        return None

    # -- liveness ---------------------------------------------------------
    def live(self) -> bool:
        return self.instance_types.live()
