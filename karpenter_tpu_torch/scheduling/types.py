"""Scheduler input/output contracts — the `Solve(pods, stateNodes,
instanceTypes)` seam (SURVEY §3.2) shared by the CPU oracle and the TPU
solver so they are drop-in interchangeable behind the provisioner.

The port's copy of `karpenter_tpu/scheduling/types.py` without the
preemption planner's and the audits' types, which no ported module uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.models.objects import InstanceType, Node, NodePool, Pod
from karpenter_tpu_torch.models.requirements import Requirements
from karpenter_tpu_torch.models.resources import Resources


def min_values_violation(reqs: Requirements, types) -> "str | None":
    """NodePool minValues: the surviving instance-type set must expose ≥ N
    distinct values for the keyed label (nodepools.md:240-304). Shared by
    the oracle and the solver — parity depends on them agreeing."""
    for r in reqs:
        if r.min_values is None:
            continue
        seen = set()
        for it in types:
            tr = it.requirements.get(r.key)
            if tr is not None and tr.is_finite():
                seen |= tr.values()
        if len(seen) < r.min_values:
            return f"minValues violated for {r.key}: {len(seen)} < {r.min_values}"
    return None


def effective_request(pod: Pod) -> Resources:
    """A pod's packing footprint: declared requests plus the one pod slot it
    occupies, plus one attachable-volume slot per mounted claim (the
    reference enforces per-node volume attach limits during scheduling —
    scheduling.md:381-417). Shared by the oracle and the solver encoder —
    parity depends on them agreeing."""
    r = pod.requests.copy()
    r.set("pods", r.get("pods") + 1.0)
    if pod.volume_claims:
        r.set("volumes", r.get("volumes") + len(pod.volume_claims))
    return r


def fold_volume_topology(pods: List[Pod]) -> List[Pod]:
    """PV zone pinning (SURVEY §7 step 5: 'PV zone pinning as
    pre-masking'): a pod mounting a claim BOUND to a zonal volume can only
    run in that zone — expressed by intersecting a zone requirement into
    the pod, which pre-masks solver columns and constrains the oracle
    identically. Unbound (WaitForFirstConsumer) claims impose nothing; the
    binder stamps their zone at bind time. Pods are copied, not mutated
    (specs are immutable post-admission and the grouping cache relies on
    it). Idempotent: re-folding intersects an already-present zone."""
    import dataclasses

    from karpenter_tpu_torch.models import wellknown
    from karpenter_tpu_torch.models.requirements import Requirement, Requirements

    out = []
    for p in pods:
        zones = {c.zone for c in p.volume_claims if c.bound and c.zone}
        if not zones:
            out.append(p)
            continue
        pin = Requirements(*(
            Requirement.make(wellknown.ZONE_LABEL, "In", z)
            for z in sorted(zones)))
        out.append(dataclasses.replace(
            p, requirements=p.requirements.intersection(pin)))
    return out


# -- gang scheduling -------------------------------------------
# A gang is a pod class annotated with gang-name/gang-size: placement is
# ATOMIC (all members or none — partial placement of a tightly-coupled
# MPI/multi-host-TPU job is worse than none) and, when an adjacency
# domain is declared, rank-ADJACENT (every member lands in ONE domain).
# The adjacency axes reuse the solver's existing domain machinery:
# "slice" is the zone axis (a TPU multi-host slice), "rack" the
# capacity-type axis (for catalogs that encode racks as capacity types),
# "none" disables adjacency (pure atomicity).  The annotation being
# OPTIONAL defaults to "slice" — rank adjacency is the point of gang
# scheduling for multi-host accelerator workloads; a gang that does not
# care says so explicitly.

GANG_DOMAIN_VALUES = {
    "slice": "zone-axis",
    "rack": "capacity-type-axis",
    "none": None,
}


@dataclass(frozen=True)
class GangSpec:
    """Parsed gang identity of one pod: the gang name, the declared
    member count (0 = undeclared/malformed — "whatever is pending"),
    and the adjacency domain label key (ZONE_LABEL, CAPACITY_TYPE_LABEL,
    or None for no adjacency requirement)."""
    name: str
    size: int
    domain_key: "str | None"


def gang_of(pod: Pod) -> "GangSpec | None":
    """The pod's gang spec, or None for ordinary pods (or when the
    KARPENTER_TPU_GANG rollback knob is off — gang annotations are then
    inert and members schedule independently).  Malformed sizes degrade
    to 0 (no completeness requirement); unknown topology-domain values
    degrade to "slice" — the conservative default keeps adjacency
    rather than silently dropping it on a typo.  The parsed spec is
    cached on the pod (keyed by the knob state, which tests flip):
    grouping, encode, delta planning, and the oracle all call this per
    pod per pass, and the annotation parse must not become an O(groups)
    tax on the delta hot path."""
    from karpenter_tpu_torch.models import wellknown
    from karpenter_tpu_torch.utils.knobs import gang_enabled
    enabled = gang_enabled()
    cached = getattr(pod, "_gang_of_cache", None)
    if cached is not None and cached[0] == enabled:
        return cached[1]
    if not enabled:
        pod._gang_of_cache = (False, None)
        return None
    a = pod.meta.annotations
    name = a.get(wellknown.GANG_NAME_ANNOTATION)
    if not name:
        pod._gang_of_cache = (True, None)
        return None
    raw_size = a.get(wellknown.GANG_SIZE_ANNOTATION)
    try:
        size = max(int(raw_size), 0) if raw_size is not None else 0
    except (TypeError, ValueError):
        size = 0
    raw_dom = (a.get(wellknown.GANG_TOPOLOGY_ANNOTATION) or "slice")
    dom = raw_dom.strip().lower()
    if dom not in GANG_DOMAIN_VALUES:
        dom = "slice"
    if dom == "none":
        key = None
    elif dom == "rack":
        key = wellknown.CAPACITY_TYPE_LABEL
    else:
        key = wellknown.ZONE_LABEL
    sp = GangSpec(name=name, size=size, domain_key=key)
    pod._gang_of_cache = (True, sp)
    return sp


def gang_trial_order(domains) -> list:
    """The SHARED deterministic order both engines try adjacency
    domains in: lexicographic by domain name.  The kernel encodes it as
    a per-domain rank (encode.py folds it into the gang group's dbase
    row); the oracle walks candidate domains in exactly this order —
    parity of the chosen domain depends on the two never drifting."""
    return sorted(d for d in domains if d is not None)


# -- priority & preemption -------------------------------------
# Pod priority is first-class scheduling identity: the effective
# priority joins the scheduling key (objects.Pod._priority_key), the
# encoder packs equivalence classes in strict priority-band order
# (high→low), and the preemption planner (solver/preempt.py) may evict
# strictly-lower-priority victims to seat a stranded higher-priority
# pod.  Three sources, strongest first: the karpenter.tpu/priority
# annotation (integer), priorityClassName resolved through the
# PRIORITY_CLASSES table, then the spec `priority` field.  Malformed
# values degrade to the next source — never to a crash.

# the cluster's priority-class table (k8s PriorityClass analogue): the
# two system classes ship by default; deployments register their own
# via register_priority_class (tests/benches do too).
PRIORITY_CLASSES: Dict[str, int] = {
    "system-cluster-critical": 2_000_000_000,
    "system-node-critical": 2_000_001_000,
}


def register_priority_class(name: str, value: int) -> None:
    """Register (or update) a priority class.  The scheduling-key cache
    on pods keys on the knob state only, so classes should be
    registered before pods are grouped — the k8s posture, where a
    PriorityClass exists before pods reference it."""
    PRIORITY_CLASSES[name] = int(value)


def priority_of(pod: Pod) -> int:
    """The pod's effective scheduling priority (0 default).  Inert
    (always the spec `priority` field, historically in the scheduling
    key) when the KARPENTER_TPU_PRIORITY rollback knob is off.  Cached
    on the pod keyed by knob state — grouping, encode, the oracle's
    band sort, and the planner all call this per pod per pass."""
    from karpenter_tpu_torch.models import wellknown
    from karpenter_tpu_torch.utils.knobs import priority_enabled
    enabled = priority_enabled()
    cached = getattr(pod, "_priority_of_cache", None)
    if cached is not None and cached[0] == enabled:
        return cached[1]
    prio = pod.priority
    if enabled:
        cls = getattr(pod, "priority_class_name", None)
        if cls and cls in PRIORITY_CLASSES:
            prio = PRIORITY_CLASSES[cls]
        raw = pod.meta.annotations.get(wellknown.PRIORITY_ANNOTATION)
        if raw is not None:
            try:
                prio = int(raw)
            except (TypeError, ValueError):
                pass  # malformed annotation degrades to the next source
    pod._priority_of_cache = (enabled, prio)
    return prio


@dataclass
class ExistingNode:
    """A live node as the scheduler sees it: identity + headroom + resident
    pods (for topology/affinity accounting). Mirrors the cluster-state
    `StateNode` consumed by the core scheduler (SURVEY §2.2 Cluster state).
    """
    node: Node
    available: Resources            # allocatable − Σ(resident pod requests)
    pods: List[Pod] = field(default_factory=list)
    # set on SYNTHETIC nodes (the split/rescue paths present the device
    # solve's planned claims as existing nodes): placements onto them are
    # still purchases and must charge this pool's remaining limit — real
    # existing nodes are free capacity and leave this None
    charge_pool: "str | None" = None

    @property
    def name(self) -> str:
        return self.node.name


@dataclass
class ScheduleInput:
    pods: List[Pod]
    nodepools: List[NodePool]
    # nodepool name → instance types (already filtered per its NodeClass)
    instance_types: Dict[str, List[InstanceType]]
    existing_nodes: List[ExistingNode] = field(default_factory=list)
    # nodepool name → aggregate daemonset requests a new node must reserve
    # (reference: daemonset overhead accounting,
    # test/suites/scale/provisioning_test.go:74-75)
    daemon_overhead: Dict[str, Resources] = field(default_factory=dict)
    # nodepool name → resources still allowed under NodePool.spec.limits
    # (None = unlimited)
    remaining_limits: Dict[str, Optional[Resources]] = field(default_factory=dict)
    # consolidation simulations only consider replacements strictly cheaper
    # than the disrupted candidates (designs/consolidation.md). Carried as a
    # field (not pre-filtered type lists) so the TPU solver can apply it as
    # a column mask without invalidating its cached catalog encoding.
    price_cap: Optional[float] = None
    # leave-k-out provenance: when the caller derived `existing_nodes`
    # from a shared snapshot list by dropping a few rows (the consolidation
    # sweep — every simulation is 'the cluster minus this candidate'), it
    # records the snapshot and the dropped row indices here. The batched
    # solver then encodes the snapshot ONCE and expresses each simulation
    # as an exclusion index on the device, instead of re-encoding ~N nodes
    # per simulation (SURVEY §3.3 hot loop #2). Invariant (caller-owned):
    # existing_nodes == [exist_base[i] for i not in exist_excluded].
    exist_base: Optional[List[ExistingNode]] = None
    exist_excluded: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        # PV zone pinning happens at the seam so BOTH engines (oracle and
        # solver) see identical constraints no matter who built the input
        if any(p.volume_claims for p in self.pods):
            self.pods = fold_volume_topology(self.pods)


def price_capped_types(types: List[InstanceType], price_cap: float) -> List[InstanceType]:
    """Restrict offerings to those strictly cheaper than the cap — the
    consolidation simulator only considers cheaper replacements
    (designs/consolidation.md node-replacement cost rule)."""
    out: List[InstanceType] = []
    for it in types:
        offs = [o for o in it.offerings if o.available and o.price < price_cap]
        if not offs:
            continue
        out.append(InstanceType(
            name=it.name, capacity=it.capacity,
            requirements=it.requirements, offerings=offs,
            overhead=it.overhead))
    return out


@dataclass
class NewNodeClaim:
    """A planned node: which pool, the accumulated requirement intersection,
    the ranked instance-type candidates, and the pods packed onto it."""
    nodepool: str
    node_class_ref: str
    requirements: Requirements
    pods: List[Pod] = field(default_factory=list)
    requests: Resources = field(default_factory=Resources)  # incl. daemon overhead
    # candidate types that still fit everything, ranked cheapest-first
    instance_type_names: List[str] = field(default_factory=list)
    # cheapest viable (type, zone, capacity_type, price) — the simulation's
    # cost estimate; launch may pick differently under live capacity
    price: float = 0.0
    taints: List = field(default_factory=list)
    startup_taints: List = field(default_factory=list)
    hostname: str = ""  # synthetic hostname domain for topology


@dataclass
class ScheduleResult:
    new_claims: List[NewNodeClaim] = field(default_factory=list)
    existing_assignments: Dict[str, str] = field(default_factory=dict)  # pod → node
    unschedulable: Dict[str, str] = field(default_factory=dict)         # pod → reason
    # preemption plans for stranded higher-priority pods (the reference's
    # solver/preempt.py); the port has no planner yet and refuses inputs
    # where one would plan (oracle.preemption_would_plan), so this stays
    # empty
    preemptions: List = field(default_factory=list)

    def node_count(self) -> int:
        return len(self.new_claims)

    def total_price(self) -> float:
        return sum(c.price for c in self.new_claims)
