"""CRD-shaped objects.

NodePool / NodeClaim mirror the core CRDs
(pkg/apis/crds/karpenter.sh_nodepools.yaml, karpenter.sh_nodeclaims.yaml);
NodeClass is the provider CRD analogue of EC2NodeClass
(pkg/apis/v1/ec2nodeclass.go:29-128) with TPU/GCE-shaped fields; InstanceType
and Offering mirror cloudprovider.InstanceType
(consumed at pkg/cloudprovider/cloudprovider.go:172-193 and built by
pkg/providers/instancetype/types.go:51-210).
"""

from __future__ import annotations

import hashlib
import itertools
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.requirements import Requirement, Requirements
from karpenter_tpu_torch.models.resources import Resources
from karpenter_tpu_torch.models.taints import Taint, Toleration

_uid_counter = itertools.count(1)
_SCHED_KEY_INTERN: Dict[tuple, int] = {}
_INTERN_LIMIT = 100_000
# group ids are globally unique (never reused across intern-table resets)
_sched_gid_counter = itertools.count(1)


def do_not_disrupt(meta: "ObjectMeta") -> bool:
    """The karpenter.sh/do-not-disrupt annotation — ONE definition for
    every level it applies at (pod, node, nodeclaim)."""
    return meta.annotations.get(wellknown.DO_NOT_DISRUPT_ANNOTATION) == "true"


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class ObjectMeta:
    name: str
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    creation_time: float = 0.0
    deletion_time: Optional[float] = None  # set => being deleted (finalizing)
    resource_version: int = 0

    @property
    def deleting(self) -> bool:
        return self.deletion_time is not None


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

@dataclass
class TopologySpreadConstraint:
    topology_key: str
    max_skew: int = 1
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Dict[str, str] = field(default_factory=dict)
    min_domains: Optional[int] = None


@dataclass
class PodAffinityTerm:
    """Required/preferred pod (anti-)affinity over a topology domain."""
    label_selector: Dict[str, str]
    topology_key: str
    anti: bool = False
    required: bool = True
    weight: int = 100  # for preferred terms
    # True on the required=True copy the relaxation ladder makes of a
    # preferred term: enforced for the pod's own placement, but excluded
    # from the k8s anti-affinity SYMMETRY rule — a soft anti must never
    # hard-block other pods (scheduling.md:282-379 scoring semantics)
    promoted: bool = False


@dataclass
class VolumeClaim:
    """A persistent-volume claim a pod mounts (PV topology —
    scheduling.md:381-417): once bound to a zonal volume, the pod can only
    schedule into that zone, and each claim consumes one of the node's
    attachable-volume slots (the `volumes` resource axis). An unbound
    claim (WaitForFirstConsumer) binds to whatever zone the scheduler
    picks — the binder stamps it at bind time."""
    name: str
    zone: Optional[str] = None      # set once bound to a zonal volume
    bound: bool = False
    storage_class: str = "standard"


@dataclass
class Pod:
    meta: ObjectMeta
    requests: Resources = field(default_factory=Resources)
    # hard node constraints: nodeSelector + requiredDuringScheduling node
    # affinity, already folded into one Requirements conjunction
    requirements: Requirements = field(default_factory=Requirements)
    # preferredDuringScheduling node affinity: (weight, requirements) terms
    preferences: List[Tuple[int, Requirements]] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    pod_affinities: List[PodAffinityTerm] = field(default_factory=list)
    # persistent-volume claims this pod mounts (attach slots + zone pinning)
    volume_claims: List[VolumeClaim] = field(default_factory=list)
    priority: int = 0
    # k8s priorityClassName — resolved to an integer through
    # scheduling.types.PRIORITY_CLASSES by priority_of
    priority_class_name: Optional[str] = None
    # binding / lifecycle
    node_name: Optional[str] = None
    phase: str = "Pending"
    # "has a controller owner" — pods without one block consolidation
    # (designs/consolidation.md:46-52)
    owner_kind: Optional[str] = "ReplicaSet"
    is_daemonset: bool = False

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def scheduled(self) -> bool:
        return self.node_name is not None

# class attrs (deliberately unannotated: not dataclass fields)
    _sched_key_cache = None
    _sched_group_id = None

    def deletion_cost(self) -> float:
        raw = self.meta.annotations.get(wellknown.POD_DELETION_COST_ANNOTATION)
        try:
            return float(raw) if raw is not None else 0.0
        except ValueError:
            return 0.0

    def do_not_disrupt(self) -> bool:
        return do_not_disrupt(self.meta)

    def _soft_ladder(self) -> list:
        """Every best-effort term, strongest first: preferred node affinity
        (by weight), preferred pod (anti-)affinity (by weight), and
        ScheduleAnyway topology spread (weakest — pure scoring in kube).
        The relaxation loop drops them from the END of this list."""
        terms = []
        for i, (w, reqs) in enumerate(self.preferences):
            terms.append((w, 2, i, ("pref", reqs)))
        for i, t in enumerate(self.pod_affinities):
            if not t.required:
                terms.append((t.weight, 1, i, ("aff", t)))
        for i, c in enumerate(self.topology_spread):
            if c.when_unsatisfiable == "ScheduleAnyway":
                terms.append((0, 0, i, ("spread", c)))
        terms.sort(key=lambda x: (-x[0], -x[1], x[2]))
        return terms

    def relax_levels(self) -> int:
        """How many relaxation steps this pod supports (0 = nothing soft)."""
        return len(self._soft_ladder())

    def has_soft_terms(self) -> bool:
        if self.preferences:
            return True
        for t in self.pod_affinities:
            if not t.required:
                return True
        for c in self.topology_spread:
            if c.when_unsatisfiable == "ScheduleAnyway":
                return True
        return False

    def relaxed(self, level: int) -> "Pod":
        """The pod with its soft terms ENFORCED as hard constraints, the
        `level` weakest dropped entirely.

        Mirrors the reference scheduler's preference handling
        (website/content/en/preview/concepts/scheduling.md:282-379:
        preferences are treated as required, then relaxed one at a time
        when the pod cannot schedule). Enforcement per kind: preferred node
        affinity folds into the hard requirements; preferred pod
        (anti-)affinity becomes a required term; ScheduleAnyway spread
        becomes DoNotSchedule. level 0 = all enforced; level ==
        relax_levels() = none (the pod's true hard constraints only).
        Returns a variant with `preferences=[]` so variants at equal
        effective constraints share a scheduling group.
        """
        ladder = self._soft_ladder()
        if not ladder:
            return self
        import dataclasses
        keep = ladder[: max(0, len(ladder) - level)]
        eff = self.requirements
        affs = [t for t in self.pod_affinities if t.required]
        spreads = [c for c in self.topology_spread
                   if c.when_unsatisfiable != "ScheduleAnyway"]
        for _, _, _, (kind, payload) in keep:
            if kind == "pref":
                eff = eff.intersection(payload)
            elif kind == "aff":
                affs.append(dataclasses.replace(payload, required=True,
                                                promoted=True))
            else:
                spreads.append(dataclasses.replace(
                    payload, when_unsatisfiable="DoNotSchedule"))
        return dataclasses.replace(self, requirements=eff, preferences=[],
                                   pod_affinities=affs,
                                   topology_spread=spreads)

    def scheduling_key(self) -> tuple:
        """Equivalence-class key: pods with equal keys are interchangeable to
        the scheduler. The reference exploits the same equivalence when
        batching identical pods; the TPU grouped solver depends on it.
        Cached — pod specs are immutable once submitted for scheduling.
        """
        if self._sched_key_cache is not None:
            return self._sched_key_cache
        self._sched_key_cache = (
            self.requests,
            self.requirements,
            tuple(sorted(self.tolerations, key=str)),
            tuple(
                (c.topology_key, c.max_skew, c.when_unsatisfiable,
                 tuple(sorted(c.label_selector.items())), c.min_domains)
                for c in self.topology_spread
            ),
            tuple(
                (t.topology_key, t.anti, t.required,
                 tuple(sorted(t.label_selector.items())))
                for t in self.pod_affinities
            ),
            # preferred node affinity participates in relaxation (pods at
            # different relax states are not interchangeable)
            tuple((w, r) for w, r in self.preferences),
            # attach-slot count and bound zones change the packing
            # footprint and the zone mask respectively
            tuple(sorted((c.zone or "", c.bound)
                         for c in self.volume_claims)),
            tuple(sorted(self.meta.labels.items())),
            self.priority,
            self.is_daemonset,
            # gang identity: a gang member is NOT
            # interchangeable with an identical non-gang pod (its
            # placement is atomic with its gang), and two gangs never
            # share a class — the grouped solver's gang unit IS the
            # equivalence class.  None (inert) when the
            # KARPENTER_TPU_GANG rollback knob is off.
            self._gang_key(),
            # priority identity: beyond the spec `priority`
            # field above, the class/annotation-resolved effective
            # priority joins the key — two otherwise-identical pods in
            # different priority bands pack in different passes and must
            # not share a group.  None (inert) when the
            # KARPENTER_TPU_PRIORITY rollback knob is off or nothing
            # beyond the spec field contributes, keeping priority-free
            # keys bit-compatible with the pre-priority layout.
            self._priority_key(),
        )
        return self._sched_key_cache

    def _gang_key(self):
        # delegate to gang_of — the ONE owner of the annotation
        # grammar (knob gate, size/domain normalization): raw
        # annotation strings here would split one gang into two
        # classes on a cosmetic difference ("slice" vs "Slice") that
        # gang_of parses identically, and _encode_gang would then
        # reject the gang as multi-class.  Lazy import (the same
        # direction gang_of's own lazy imports take) avoids the
        # models↔scheduling cycle.
        from karpenter_tpu_torch.scheduling.types import gang_of
        sp = gang_of(self)
        if sp is None:
            return None
        return (sp.name, sp.size, sp.domain_key)

    def _priority_key(self):
        # delegate to priority_of — the ONE owner of the priority
        # grammar (knob gate, annotation > class > spec precedence,
        # malformed-value degradation).  Only the EXTRA identity is
        # keyed: when the effective priority equals the spec field (the
        # priority-free common case, or the knob off) this is None and
        # the key layout matches the pre-priority one.
        from karpenter_tpu_torch.scheduling.types import priority_of
        eff = priority_of(self)
        if eff == self.priority:
            return None
        return eff

    def scheduling_group_id(self) -> int:
        """Interned integer id of the scheduling_key — deep-tuple hashing is
        the grouping hot path at 50k pods, so equal keys are mapped to one
        int once per pod and grouped by int thereafter. Pod specs must not
        mutate after this is first called (k8s pod specs are immutable
        post-admission; the cache relies on it). The intern table is bounded:
        it resets once it exceeds _INTERN_LIMIT distinct keys — group ids
        from different epochs are never mixed because pods cache their id.
        """
        if self._sched_group_id is None:
            if len(_SCHED_KEY_INTERN) > _INTERN_LIMIT:
                _SCHED_KEY_INTERN.clear()
            key = self.scheduling_key()
            gid = _SCHED_KEY_INTERN.get(key)
            if gid is None:
                gid = next(_sched_gid_counter)
                _SCHED_KEY_INTERN[key] = gid
            self._sched_group_id = gid
        return self._sched_group_id


@dataclass
class PodDisruptionBudget:
    """Minimal PDB: how many pods matching the selector may be voluntarily
    disrupted (reference consumes these through the Eviction API —
    website/.../disruption.md:29-36; pods at/over budget block consolidation,
    designs/consolidation.md:46-52)."""
    meta: ObjectMeta
    selector: Dict[str, str] = field(default_factory=dict)
    max_unavailable: int = 1

    def matches(self, pod: "Pod") -> bool:
        return all(pod.meta.labels.get(k) == v for k, v in self.selector.items())


# ---------------------------------------------------------------------------
# Instance types
# ---------------------------------------------------------------------------

@dataclass
class Offering:
    """One purchasable (zone × capacity-type) variant of an instance type with
    a price (reference: createOfferings,
    pkg/providers/instancetype/instancetype.go:264-315).
    """
    zone: str
    capacity_type: str
    price: float
    available: bool = True

    def requirements(self) -> Requirements:
        return Requirements(
            Requirement.single(wellknown.ZONE_LABEL, self.zone),
            Requirement.single(wellknown.CAPACITY_TYPE_LABEL, self.capacity_type),
        )


@dataclass
class InstanceType:
    """A machine shape: capacity, overhead, static label requirements, and
    offerings (reference: cloudprovider.InstanceType built at
    pkg/providers/instancetype/types.go:51-210).
    """
    name: str
    capacity: Resources
    requirements: Requirements  # single-valued label reqs + zone/captype In[...]
    offerings: List[Offering] = field(default_factory=list)
    overhead: Resources = field(default_factory=Resources)  # kube-reserved + eviction

    _allocatable: Optional[Resources] = field(default=None, repr=False, compare=False)

    def allocatable(self) -> Resources:
        if self._allocatable is None:
            self._allocatable = self.capacity - self.overhead
        return self._allocatable

    def available_offerings(self, reqs: Optional[Requirements] = None) -> List[Offering]:
        """Offerings compatible with the zone / capacity-type constraints in
        `reqs`. Only those two keys are consulted — other keys in `reqs`
        (arch, instance-type, …) are about the instance type itself, not the
        offering, and are open-world here (reference: offering filtering in
        pkg/cloudprovider/cloudprovider.go:276-281 checks offering
        requirements only).
        """
        zone_req = reqs.get(wellknown.ZONE_LABEL) if reqs is not None else None
        ct_req = reqs.get(wellknown.CAPACITY_TYPE_LABEL) if reqs is not None else None
        out = []
        for o in self.offerings:
            if not o.available:
                continue
            if zone_req is not None and not zone_req.matches(o.zone):
                continue
            if ct_req is not None and not ct_req.matches(o.capacity_type):
                continue
            out.append(o)
        return out

    def cheapest_offering(self, reqs: Optional[Requirements] = None) -> Optional[Offering]:
        offs = self.available_offerings(reqs)
        return min(offs, key=lambda o: o.price) if offs else None


# ---------------------------------------------------------------------------
# Nodes & claims
# ---------------------------------------------------------------------------

@dataclass
class Node:
    meta: ObjectMeta
    provider_id: Optional[str] = None
    capacity: Resources = field(default_factory=Resources)
    allocatable: Resources = field(default_factory=Resources)
    taints: List[Taint] = field(default_factory=list)
    ready: bool = False

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def labels(self) -> Dict[str, str]:
        return self.meta.labels

    @property
    def nodepool(self) -> Optional[str]:
        return self.meta.labels.get(wellknown.NODEPOOL_LABEL)

    @property
    def zone(self) -> Optional[str]:
        return self.meta.labels.get(wellknown.ZONE_LABEL)

    @property
    def capacity_type(self) -> Optional[str]:
        return self.meta.labels.get(wellknown.CAPACITY_TYPE_LABEL)

    @property
    def instance_type(self) -> Optional[str]:
        return self.meta.labels.get(wellknown.INSTANCE_TYPE_LABEL)


# NodeClaim status conditions (karpenter.sh_nodeclaims.yaml status.conditions;
# lifecycle per SURVEY §2.2 "Node lifecycle").
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"


@dataclass
class NodeClaim:
    meta: ObjectMeta
    nodepool: str
    node_class_ref: str
    # owning pool's UID, the k8s ownerReference analogue: GC cascades only
    # for claims whose owner UID no longer matches a live pool, so a
    # delete+recreate of a NodePool under the same name between GC passes
    # does not drain the recreated fleet
    nodepool_uid: Optional[str] = None
    requirements: Requirements = field(default_factory=Requirements)
    resource_requests: Resources = field(default_factory=Resources)  # aggregate of packed pods
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    # ranked candidate instance types (cheapest-first), as the reference's
    # NodeClaim carries instance-type requirements ranked by price
    instance_type_options: List[str] = field(default_factory=list)
    # max drain time before PDBs stop being honored, stamped from the
    # NodePool template at creation (reference: NodeClaim
    # spec.terminationGracePeriod) — read from the CLAIM, not the live
    # pool, so claims orphaned by pool deletion still force-drain
    termination_grace_period: Optional[float] = None
    # status
    provider_id: Optional[str] = None
    node_name: Optional[str] = None
    capacity: Resources = field(default_factory=Resources)
    allocatable: Resources = field(default_factory=Resources)
    conditions: Dict[str, bool] = field(default_factory=dict)
    launch_time: Optional[float] = None

    @property
    def name(self) -> str:
        return self.meta.name

    def is_(self, cond: str) -> bool:
        return self.conditions.get(cond, False)

    def set_condition(self, cond: str, val: bool = True) -> None:
        self.conditions[cond] = val


# ---------------------------------------------------------------------------
# NodePool & NodeClass
# ---------------------------------------------------------------------------

@dataclass
class Budget:
    """Disruption budget (karpenter.sh_nodepools.yaml spec.disruption.budgets).
    nodes: "10%" or "5"; reasons limits which disruption reasons it caps.
    """
    nodes: str = "10%"
    schedule: Optional[str] = None  # cron; None = always active
    duration: Optional[float] = None  # seconds the window stays open
    reasons: Optional[List[str]] = None  # None = all reasons

    def allowed_disruptions(self, total_nodes: int) -> int:
        if self.nodes.endswith("%"):
            import math
            pct = float(self.nodes[:-1]) / 100.0
            # ceil (with float-error guard): "10%" of a 3-node cluster allows
            # 1 disruption — flooring would freeze small clusters entirely
            return math.ceil(pct * total_nodes - 1e-9)
        return int(self.nodes)


CONSOLIDATE_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"
CONSOLIDATE_WHEN_UNDERUTILIZED = "WhenUnderutilized"


@dataclass
class Disruption:
    consolidation_policy: str = CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED
    consolidate_after: float = 0.0  # seconds; 0 = immediately
    budgets: List[Budget] = field(default_factory=lambda: [Budget(nodes="10%")])


@dataclass
class NodePool:
    """karpenter.sh/NodePool (karpenter.sh_nodepools.yaml): a template for
    nodes plus disruption policy, limits, and weight.
    """
    meta: ObjectMeta
    node_class_ref: str = "default"
    requirements: Requirements = field(default_factory=Requirements)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)       # template labels
    annotations: Dict[str, str] = field(default_factory=dict)
    expire_after: Optional[float] = None  # seconds; None = Never
    termination_grace_period: Optional[float] = None
    disruption: Disruption = field(default_factory=Disruption)
    limits: Optional[Resources] = None
    weight: int = 0  # higher = tried first (nodepools.md:525-529)

    @property
    def name(self) -> str:
        return self.meta.name

    def template_requirements(self) -> Requirements:
        """Full requirement set a node from this pool will satisfy."""
        reqs = Requirements.from_labels(self.labels)
        reqs.update(self.requirements)
        reqs.add(Requirement.single(wellknown.NODEPOOL_LABEL, self.name))
        return reqs

    def static_hash(self) -> str:
        """Drift-detection hash over the template's static fields
        (reference: NodePool hash annotation mechanism,
        pkg/controllers/nodeclass/hash/controller.go:48-128 analogue).
        """
        payload = json.dumps({
            "labels": sorted(self.labels.items()),
            "annotations": sorted(self.annotations.items()),
            "taints": sorted(str(t) for t in self.taints),
            "startup_taints": sorted(str(t) for t in self.startup_taints),
            "requirements": sorted(repr(r) for r in self.requirements),
            "node_class_ref": self.node_class_ref,
            "expire_after": self.expire_after,
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass
class SelectorTerm:
    """One discovery selector term (pkg/apis/v1/ec2nodeclass.go selector
    terms): terms in a list are OR'd; within a term, id/name/tags are AND'd
    and the tag map entries are AND'd."""
    id: Optional[str] = None
    name: Optional[str] = None
    tags: Dict[str, str] = field(default_factory=dict)

    def matches(self, obj_id: str, name: str = "",
                tags: Optional[Dict[str, str]] = None) -> bool:
        if self.id is not None and self.id != obj_id:
            return False
        if self.name is not None and self.name != name:
            return False
        tags = tags or {}
        for k, v in self.tags.items():
            if v == "*":
                if k not in tags:
                    return False
            elif tags.get(k) != v:
                return False
        return True

    def key(self) -> tuple:
        return (self.id, self.name, tuple(sorted(self.tags.items())))


def match_selector_terms(terms: List[SelectorTerm], obj_id: str,
                         name: str = "",
                         tags: Optional[Dict[str, str]] = None) -> bool:
    """Empty terms = select nothing is the reference's rule; our fake cloud
    seeds cluster-tagged defaults, so None/empty means 'cluster defaults'
    and is handled by the providers, not here."""
    return any(t.matches(obj_id, name, tags) for t in terms)


@dataclass
class BlockDevice:
    """Volume parameters for a block-device mapping
    (pkg/apis/v1/ec2nodeclass.go:319-382 BlockDevice). Sizes are GiB; the
    TPU cloud's volume types mirror the reference's enum so selector
    semantics carry over."""
    volume_size_gib: Optional[int] = None
    volume_type: str = "gp3"
    iops: Optional[int] = None
    throughput: Optional[int] = None
    encrypted: bool = True
    kms_key_id: Optional[str] = None
    snapshot_id: Optional[str] = None
    delete_on_termination: bool = True

    def key(self) -> tuple:
        return (self.volume_size_gib, self.volume_type, self.iops,
                self.throughput, self.encrypted, self.kms_key_id,
                self.snapshot_id, self.delete_on_termination)


@dataclass
class BlockDeviceMapping:
    """One device attach (pkg/apis/v1/ec2nodeclass.go:305-317): a list of
    these, not a single scalar GiB — the root volume (at most one) sizes
    the node's ephemeral-storage capacity."""
    device_name: str
    ebs: BlockDevice = field(default_factory=BlockDevice)
    root_volume: bool = False

    def key(self) -> tuple:
        return (self.device_name, self.ebs.key(), self.root_volume)


@dataclass
class MetadataOptions:
    """Instance metadata service exposure
    (pkg/apis/v1/ec2nodeclass.go:255-300). Defaults mirror the
    reference's hardened defaults (IMDSv2-style required tokens,
    hop limit 1)."""
    http_endpoint: str = "enabled"      # enabled | disabled
    http_protocol_ipv6: str = "disabled"
    http_put_response_hop_limit: int = 1
    http_tokens: str = "required"       # required | optional

    def key(self) -> tuple:
        return (self.http_endpoint, self.http_protocol_ipv6,
                self.http_put_response_hop_limit, self.http_tokens)


# instance-store policy enum (pkg/apis/v1/ec2nodeclass.go:384-394): RAID0
# stripes all local NVMe disks into the node's ephemeral storage
INSTANCE_STORE_RAID0 = "RAID0"


@dataclass
class KubeletConfiguration:
    """Per-NodeClass kubelet args (pkg/apis/v1/ec2nodeclass.go:186-253),
    the subset that feeds allocatable math: max-pods / pods-per-core
    override the catalog's ENI-style ladder; reserved and eviction maps
    override the reserved-resource formulas
    (pkg/providers/instancetype/types.go:363-431). Quantities are
    k8s-style strings ("100m", "1Gi", "5%" for eviction signals)."""
    cluster_dns: List[str] = field(default_factory=list)
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    system_reserved: Dict[str, str] = field(default_factory=dict)
    kube_reserved: Dict[str, str] = field(default_factory=dict)
    eviction_hard: Dict[str, str] = field(default_factory=dict)
    eviction_soft: Dict[str, str] = field(default_factory=dict)
    eviction_soft_grace_period: Dict[str, str] = field(default_factory=dict)
    eviction_max_pod_grace_period: Optional[int] = None
    image_gc_high_threshold_percent: Optional[int] = None
    image_gc_low_threshold_percent: Optional[int] = None
    cpu_cfs_quota: Optional[bool] = None

    def key(self) -> tuple:
        return (tuple(self.cluster_dns), self.max_pods, self.pods_per_core,
                tuple(sorted(self.system_reserved.items())),
                tuple(sorted(self.kube_reserved.items())),
                tuple(sorted(self.eviction_hard.items())),
                tuple(sorted(self.eviction_soft.items())),
                tuple(sorted(self.eviction_soft_grace_period.items())),
                self.eviction_max_pod_grace_period,
                self.image_gc_high_threshold_percent,
                self.image_gc_low_threshold_percent,
                self.cpu_cfs_quota)


@dataclass
class NodeClass:
    """Provider node configuration — the EC2NodeClass analogue
    (pkg/apis/v1/ec2nodeclass.go:29-128). Carries zone/network/boot
    configuration: subnet/security-group/image selector terms, the image
    family, and the node identity role; `ready` gates Create() exactly as
    the reference's readiness condition does
    (pkg/cloudprovider/cloudprovider.go:99-102).
    """
    meta: ObjectMeta
    zones: List[str] = field(default_factory=list)
    capacity_types: List[str] = field(
        default_factory=lambda: [wellknown.CAPACITY_TYPE_ON_DEMAND,
                                 wellknown.CAPACITY_TYPE_SPOT])
    boot_config: Dict[str, str] = field(default_factory=dict)  # userdata analogue
    instance_families: Optional[List[str]] = None  # None = all
    # discovery selectors (None = the cloud's cluster-tagged defaults)
    subnet_selector_terms: Optional[List[SelectorTerm]] = None
    security_group_selector_terms: Optional[List[SelectorTerm]] = None
    image_selector_terms: Optional[List[SelectorTerm]] = None
    image_family: str = "cos"  # AMIFamily analogue (resolver.go:163-180)
    role: str = "default-node-role"
    user_data: str = ""  # appended to the family bootstrap script
    # legacy single-scalar root size, used only when no mapping is given
    block_device_gib: int = 100
    # full spec surface (pkg/apis/v1/ec2nodeclass.go:186-394): device
    # mapping LIST, metadata options, instance-store policy, per-class
    # kubelet config — all drift-hashed and fed into allocatable math
    # (providers/instancetype.py apply_node_class)
    block_device_mappings: Optional[List[BlockDeviceMapping]] = None
    metadata_options: Optional[MetadataOptions] = None
    instance_store_policy: Optional[str] = None  # None | "RAID0"
    kubelet: Optional[KubeletConfiguration] = None
    tags: Dict[str, str] = field(default_factory=dict)
    ready: bool = True
    # status (mirrors EC2NodeClass.status discovered resources,
    # pkg/apis/v1/ec2nodeclass_status.go)
    discovered_zones: List[str] = field(default_factory=list)
    discovered_subnets: List[str] = field(default_factory=list)
    discovered_security_groups: List[str] = field(default_factory=list)
    discovered_images: List[str] = field(default_factory=list)
    instance_profile: str = ""
    status_conditions: Dict[str, bool] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.meta.name

    def root_volume_gib(self) -> int:
        """Root volume size: the mapping flagged root_volume (at most one,
        per the reference's CEL rule), else the first mapping, else the
        legacy scalar."""
        for m in self.block_device_mappings or []:
            if m.root_volume and m.ebs.volume_size_gib:
                return m.ebs.volume_size_gib
        if self.block_device_mappings:
            first = self.block_device_mappings[0]
            if first.ebs.volume_size_gib:
                return first.ebs.volume_size_gib
        return self.block_device_gib

    def static_hash(self) -> str:
        """Drift input — spec-only, status excluded
        (pkg/apis/v1/ec2nodeclass.go:421-427)."""
        payload = json.dumps({
            "zones": sorted(self.zones),
            "capacity_types": sorted(self.capacity_types),
            "boot_config": sorted(self.boot_config.items()),
            "instance_families": sorted(self.instance_families or []),
            "image_family": self.image_family,
            "role": self.role,
            "user_data": self.user_data,
            "block_device_gib": self.block_device_gib,
            "block_device_mappings": [
                m.key() for m in self.block_device_mappings or []],
            "metadata_options": (self.metadata_options.key()
                                 if self.metadata_options else None),
            "instance_store_policy": self.instance_store_policy,
            "kubelet": self.kubelet.key() if self.kubelet else None,
            "tags": sorted(self.tags.items()),
            "subnet_terms": sorted(
                t.key() for t in self.subnet_selector_terms or []),
            "sg_terms": sorted(
                t.key() for t in self.security_group_selector_terms or []),
            "image_terms": sorted(
                t.key() for t in self.image_selector_terms or []),
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]
