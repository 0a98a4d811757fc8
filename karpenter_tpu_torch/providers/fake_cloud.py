"""The fake cloud — an in-memory machine fleet API.

This is both the test backend (the role of pkg/fake/ec2api.go: canned
behaviors, call capture, error injection, per-pool insufficient-capacity
simulation honored by CreateFleet, pkg/fake/ec2api.go:40-199) and, for now,
the only cloud implementation. The CloudProvider seam talks to this
interface; a real GCE/TPU-pool backend would implement the same methods.

Semantics mirrored from the reference:
  * create_fleet walks the ranked candidate list and launches the first
    (type, zone, capacity_type) not in an insufficient-capacity pool,
    returning per-pool errors for the ones it skipped
    (pkg/fake/ec2api.go:112-199).
  * instances carry tags; list/describe filters by tag — recovery after
    restart is re-listing by tag, there is no other persistent state
    (pkg/providers/instance/instance.go:140-160).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.models.objects import InstanceType
from karpenter_tpu_torch.providers.catalog import CatalogSpec, generate_catalog
from karpenter_tpu_torch.utils.clock import Clock, RealClock

# tag keys (reference: cluster-discovery tags on instances,
# pkg/providers/instance/instance.go:140-160)
TAG_CLUSTER = "karpenter.sh/discovery"
TAG_NODEPOOL = "karpenter.sh/nodepool"
TAG_NODECLAIM = "karpenter.sh/nodeclaim"
TAG_NODECLASS = "karpenter.tpu/nodeclass"

INSTANCE_RUNNING = "running"
INSTANCE_TERMINATED = "terminated"


class CloudAPIError(Exception):
    pass


class LaunchTemplateNotFound(CloudAPIError):
    """Launch template referenced by a fleet request no longer exists —
    the launch path retries once after cache invalidation
    (pkg/providers/instance/instance.go:107-111)."""


@dataclass
class FleetCandidate:
    instance_type: str
    zone: str
    capacity_type: str
    price: float
    # launch plumbing (filled when the subnet/launch-template providers are
    # wired — the reference's getOverrides crosses offerings × zonal subnets
    # and attaches the per-AMI launch template, instance.go:323-359)
    subnet_id: Optional[str] = None
    launch_template: Optional[str] = None


@dataclass
class Subnet:
    """VPC subnet analogue (pkg/providers/subnet/subnet.go)."""
    subnet_id: str
    zone: str
    available_ips: int
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SecurityGroup:
    """Firewall/network-tag analogue (pkg/providers/securitygroup)."""
    group_id: str
    group_name: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class MachineImage:
    """Boot image analogue (pkg/providers/amifamily/ami.go). ``requirements``
    restricts which instance types can boot it (e.g. accelerator variants)."""
    image_id: str
    name: str
    family: str
    creation_time: float = 0.0
    deprecated: bool = False
    requirements: Dict[str, List[str]] = field(default_factory=dict)
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class LaunchTemplate:
    """Stored launch config (pkg/providers/launchtemplate)."""
    name: str
    image_id: str
    user_data: str
    security_group_ids: List[str]
    block_device_gib: int  # root volume (kept for quick assertions)
    # the FULL device list the instance boots with (family defaults or
    # explicit spec) + metadata exposure — the cloud stores what the
    # reference's CreateLaunchTemplate request carries
    block_device_mappings: Optional[list] = None
    metadata_options: Optional[object] = None
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class CloudInstance:
    instance_id: str
    instance_type: str
    zone: str
    capacity_type: str
    tags: Dict[str, str]
    state: str = INSTANCE_RUNNING
    launch_time: float = 0.0
    interrupted: bool = False
    # launch-config provenance (drift inputs — pkg/cloudprovider/drift.go)
    subnet_id: Optional[str] = None
    image_id: Optional[str] = None
    security_group_ids: List[str] = field(default_factory=list)


class FakeCloud:
    def __init__(
        self,
        catalog: Optional[List[InstanceType]] = None,
        clock: Optional[Clock] = None,
        spec: Optional[CatalogSpec] = None,
    ):
        self.clock = clock or RealClock()
        self._spec = spec or CatalogSpec()
        self._catalog = catalog if catalog is not None else generate_catalog(self._spec)
        self.catalog_seqnum = 1
        self.zones = self._catalog_zones()
        self._id_counter = itertools.count(1)
        self.instances: Dict[str, CloudInstance] = {}
        # fault injection (role of EC2Behavior: pkg/fake/ec2api.go:40-109)
        self.insufficient_capacity_pools: Set[Tuple[str, str, str]] = set()
        self.next_error: Optional[Exception] = None
        self.api_calls: List[Tuple[str, object]] = []
        self._alive = True
        # interruption queue (EventBridge→SQS analogue)
        self.interruption_queue: List[dict] = []
        # networking / boot resources (seeded per zone; tests can replace)
        self.subnets: Dict[str, Subnet] = {}
        self.security_groups: Dict[str, SecurityGroup] = {}
        self.images: Dict[str, MachineImage] = {}
        self.launch_templates: Dict[str, LaunchTemplate] = {}
        self.instance_profiles: Dict[str, Dict[str, str]] = {}
        self.cluster_version = "1.30"
        self._seed_network_resources()

    def _seed_network_resources(self) -> None:
        """Default geography: one subnet per zone, one cluster SG, and two
        image generations per family (newest must win —
        pkg/providers/amifamily/ami.go newest-wins discovery)."""
        cluster_tag = {TAG_CLUSTER: "default-cluster"}
        for i, zone in enumerate(self.zones):
            sid = f"subnet-{zone}"
            self.subnets[sid] = Subnet(
                subnet_id=sid, zone=zone, available_ips=4096,
                tags=dict(cluster_tag))
        self.security_groups["sg-cluster"] = SecurityGroup(
            group_id="sg-cluster", group_name="cluster-default",
            tags=dict(cluster_tag))
        t = self.clock.now()
        for family, variants in (("cos", ("", "-accelerator")),
                                 ("ubuntu", ("",)),
                                 ("accel", ("",))):
            for gen, age in (("v118", 2_000_000.0), ("v121", 1_000.0)):
                for variant in variants:
                    iid = f"img-{family}-{gen}{variant}"
                    # accelerator variants only boot GPU shapes ("*" = the
                    # label must exist, any value)
                    reqs = ({"karpenter.tpu/instance-gpu-name": ["*"]}
                            if variant else {})
                    self.images[iid] = MachineImage(
                        image_id=iid, name=f"{family}-{gen}{variant}",
                        family=family, creation_time=t - age,
                        requirements=reqs)

    def _catalog_zones(self) -> List[str]:
        """Zones are derived from the catalog's offerings (not the spec) so an
        explicitly supplied catalog defines the cloud's geography."""
        zones = sorted({o.zone for it in self._catalog for o in it.offerings})
        return zones or list(self._spec.zones)

    # -- behavior controls (tests) --------------------------------------
    def set_catalog(self, catalog: List[InstanceType]) -> None:
        self._catalog = catalog
        self.zones = self._catalog_zones()
        self.catalog_seqnum += 1

    def fail_next(self, err: Exception) -> None:
        self.next_error = err

    def set_alive(self, alive: bool) -> None:
        self._alive = alive

    def _check_fault(self, api: str, arg: object = None) -> None:
        self.api_calls.append((api, arg))
        if not self._alive:
            raise CloudAPIError(f"{api}: cloud unreachable")
        if self.next_error is not None:
            err, self.next_error = self.next_error, None
            raise err

    # -- catalog APIs ----------------------------------------------------
    def describe_instance_types(self) -> List[InstanceType]:
        self._check_fault("DescribeInstanceTypes")
        return self._catalog

    def live(self) -> bool:
        return self._alive

    # -- network / boot resource APIs ------------------------------------
    def describe_subnets(self) -> List[Subnet]:
        self._check_fault("DescribeSubnets")
        return list(self.subnets.values())

    def describe_security_groups(self) -> List[SecurityGroup]:
        self._check_fault("DescribeSecurityGroups")
        return list(self.security_groups.values())

    def describe_images(self) -> List[MachineImage]:
        self._check_fault("DescribeImages")
        return list(self.images.values())

    def resolve_image_alias(self, family: str, k8s_version: str) -> Optional[str]:
        """Release-channel alias → image id (SSM parameter analogue,
        pkg/providers/amifamily/ami.go SSM alias resolution): latest
        non-deprecated image of the family's base variant."""
        self._check_fault("ResolveImageAlias", (family, k8s_version))
        best = None
        for img in self.images.values():
            if img.family != family or img.deprecated or img.requirements:
                continue
            if best is None or img.creation_time > best.creation_time:
                best = img
        return best.image_id if best else None

    def get_cluster_version(self) -> str:
        self._check_fault("GetClusterVersion")
        return self.cluster_version

    def create_launch_template(self, lt: LaunchTemplate) -> None:
        self._check_fault("CreateLaunchTemplate", lt.name)
        self.launch_templates[lt.name] = lt

    def delete_launch_template(self, name: str) -> bool:
        self._check_fault("DeleteLaunchTemplate", name)
        return self.launch_templates.pop(name, None) is not None

    def list_launch_templates(
            self, tag_filter: Optional[Dict[str, str]] = None
    ) -> List[LaunchTemplate]:
        self._check_fault("ListLaunchTemplates", tag_filter)
        out = []
        for lt in self.launch_templates.values():
            if tag_filter and any(lt.tags.get(k) != v
                                  for k, v in tag_filter.items()):
                continue
            out.append(lt)
        return out

    def create_instance_profile(self, name: str, role: str,
                                tags: Dict[str, str]) -> None:
        self._check_fault("CreateInstanceProfile", name)
        self.instance_profiles[name] = {"role": role, **tags}

    def delete_instance_profile(self, name: str) -> bool:
        self._check_fault("DeleteInstanceProfile", name)
        return self.instance_profiles.pop(name, None) is not None

    # -- fleet APIs ------------------------------------------------------
    def create_fleet(
        self,
        candidates: List[FleetCandidate],
        tags: Dict[str, str],
    ) -> Tuple[Optional[CloudInstance], List[Tuple[str, str, str]]]:
        """Launch one instance from a ranked candidate list. Returns
        (instance | None, ice_pools_hit). Walks candidates in order and
        takes the first whose (capacity_type, type, zone) pool has capacity —
        the single-instance analogue of CreateFleet type=instant with
        price-capacity-optimized allocation over ranked overrides
        (pkg/providers/instance/instance.go:203-259, pkg/fake/ec2api.go:112-199).
        """
        self._check_fault("CreateFleet", (candidates, tags))
        for cand in candidates:
            if (cand.launch_template is not None
                    and cand.launch_template not in self.launch_templates):
                raise LaunchTemplateNotFound(cand.launch_template)
        ice: List[Tuple[str, str, str]] = []
        for cand in candidates:
            pool = (cand.capacity_type, cand.instance_type, cand.zone)
            if pool in self.insufficient_capacity_pools:
                ice.append(pool)
                continue
            subnet = (self.subnets.get(cand.subnet_id)
                      if cand.subnet_id else None)
            if subnet is not None:
                if subnet.zone != cand.zone or subnet.available_ips <= 0:
                    ice.append(pool)
                    continue
                subnet.available_ips -= 1
            lt = (self.launch_templates.get(cand.launch_template)
                  if cand.launch_template else None)
            inst = CloudInstance(
                instance_id=f"i-{next(self._id_counter):08d}",
                instance_type=cand.instance_type,
                zone=cand.zone,
                capacity_type=cand.capacity_type,
                tags=dict(tags),
                state=INSTANCE_RUNNING,
                launch_time=self.clock.now(),
                subnet_id=cand.subnet_id,
                image_id=lt.image_id if lt else None,
                security_group_ids=list(lt.security_group_ids) if lt else [],
            )
            self.instances[inst.instance_id] = inst
            return inst, ice
        return None, ice

    def describe_instances(
        self,
        tag_filter: Optional[Dict[str, str]] = None,
        states: Tuple[str, ...] = (INSTANCE_RUNNING,),
    ) -> List[CloudInstance]:
        self._check_fault("DescribeInstances", tag_filter)
        out = []
        for inst in self.instances.values():
            if inst.state not in states:
                continue
            if tag_filter and any(
                inst.tags.get(k) != v for k, v in tag_filter.items()
            ):
                continue
            out.append(inst)
        return out

    def get_instance(self, instance_id: str) -> Optional[CloudInstance]:
        self._check_fault("GetInstance", instance_id)
        return self.instances.get(instance_id)

    def terminate_instances(self, instance_ids: List[str]) -> List[str]:
        """Returns the ids actually terminated; unknown ids are skipped
        (NotFound is a success for delete — pkg/errors/errors.go:57-100)."""
        self._check_fault("TerminateInstances", instance_ids)
        done = []
        for iid in instance_ids:
            inst = self.instances.get(iid)
            if inst is not None and inst.state != INSTANCE_TERMINATED:
                inst.state = INSTANCE_TERMINATED
                done.append(iid)
        return done

    def create_tags(self, instance_id: str, tags: Dict[str, str]) -> bool:
        self._check_fault("CreateTags", (instance_id, tags))
        inst = self.instances.get(instance_id)
        if inst is None:
            return False
        inst.tags.update(tags)
        return True

    # -- interruption (EventBridge→SQS analogue) -------------------------
    def interrupt_spot(self, instance_id: str) -> None:
        """Simulate a spot interruption warning for tests/chaos."""
        inst = self.instances.get(instance_id)
        if inst is None:
            return
        inst.interrupted = True
        self.interruption_queue.append({
            "kind": "spot_interruption",
            "instance_id": instance_id,
            "time": self.clock.now(),
        })

    def send_state_change(self, instance_id: str, state: str) -> None:
        self.interruption_queue.append({
            "kind": "state_change",
            "instance_id": instance_id,
            "state": state,
            "time": self.clock.now(),
        })

    def send_rebalance_recommendation(self, instance_id: str) -> None:
        self.interruption_queue.append({
            "kind": "rebalance_recommendation",
            "instance_id": instance_id,
            "time": self.clock.now(),
        })

    def send_scheduled_change(self, instance_id: str) -> None:
        self.interruption_queue.append({
            "kind": "scheduled_change",
            "instance_id": instance_id,
            "time": self.clock.now(),
        })

    def receive_messages(self, max_messages: int = 20) -> List[dict]:
        """Long-poll receive (pkg/providers/sqs/sqs.go:53-73)."""
        self._check_fault("ReceiveMessages")
        out = self.interruption_queue[:max_messages]
        return out

    def delete_message(self, msg: dict) -> None:
        self._check_fault("DeleteMessage")
        try:
            self.interruption_queue.remove(msg)
        except ValueError:
            pass
