"""Scheduler input/output contracts — the `Solve(pods, stateNodes,
instanceTypes)` seam (SURVEY §3.2) shared by the CPU oracle and the TPU
solver so they are drop-in interchangeable behind the provisioner.

The port's copy of `karpenter_tpu/scheduling/types.py`, with the lazy
`PodSegments` pod list that the native decode (`native/hostops.cc`) hands
out.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.models.objects import InstanceType, Node, NodePool, Pod
from karpenter_tpu_torch.models.requirements import Requirements
from karpenter_tpu_torch.models.resources import Resources


class PodSegments(Sequence):
    """Lazy pod list for `NewNodeClaim.pods`: contiguous `(group_list,
    start, count)` slices into the encoder's group pod lists, plus a
    materialized tail for post-decode appends (the rescue pass).

    The kernel's fill order guarantees each node holds contiguous runs
    of whole groups, so the 50k-pod headline decode was spending most of
    its budget materializing per-node pod lists — ~50k scattered object
    increfs of pods the solve path itself never reads.  Handing out
    slice views instead moves that cost off the solve hot path onto the
    consumers that actually walk the pods (provisioning apply, tests),
    one node at a time.

    Duck-compatible with the plain lists the oracle and the Python
    fallback decode produce: iteration, `len`, indexing, `in`,
    `.append`, truthiness.  Pickles as a plain list — the solverd wire
    must carry the pods by value, never a view pinning a whole group.
    """

    __slots__ = ("_segs", "_tail")

    def __init__(self, segs=()):
        # adopt a list as-is: the native decode hands over a fresh list
        # it never touches again, and the headline wraps ~800 of these
        self._segs = segs if type(segs) is list else list(segs)
        self._tail: list = []

    def __len__(self) -> int:
        return sum(s[2] for s in self._segs) + len(self._tail)

    def __bool__(self) -> bool:
        return bool(self._segs) or bool(self._tail)

    def __iter__(self):
        for lst, start, count in self._segs:
            yield from lst[start:start + count]
        yield from self._tail

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self)[i]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        for lst, start, count in self._segs:
            if i < count:
                return lst[start + i]
            i -= count
        return self._tail[i]

    def append(self, pod) -> None:
        self._tail.append(pod)

    def __eq__(self, other):
        if isinstance(other, (PodSegments, list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    __hash__ = None  # mutable, like list

    def __reduce__(self):
        return (list, (list(self),))

    def __repr__(self) -> str:
        return f"PodSegments({list(self)!r})"


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


def gang_placement_audit(inp, res) -> dict:
    """Per-gang placement audit over a ScheduleResult — the ONE
    implementation of the atomicity/adjacency invariant that the gang
    test suite, the fuzz class, and the config9 acceptance bench all
    assert (a private copy drifting in one of them would make the
    bench gate and the test suite enforce different invariants).

    Returns ``{gang_name: entry}`` where entry carries ``spec``,
    ``total``/``placed`` member counts, ``stranded`` (names),
    ``domains`` (the adjacency values the placed members landed in —
    claim-pinned requirement values for new nodes, the node's own
    label for existing assignments; ``None`` marks an unlabeled node),
    and ``unpinned`` (placed members whose new-node claim is not
    pinned to exactly one value of the gang's domain key).  The
    invariant holds iff ``placed in (0, total)`` and, for placed
    adjacency gangs, ``not unpinned and len(domains) == 1``."""
    members: dict = {}
    for p in inp.pods:
        sp = gang_of(p)
        if sp is not None:
            members.setdefault(sp.name, (sp, []))[1].append(p)
    claim_of = {p.meta.name: c for c in res.new_claims for p in c.pods}
    node_labels = {en.name: en.node.labels for en in inp.existing_nodes}
    out = {}
    for gname, (sp, pods) in members.items():
        stranded = [p.meta.name for p in pods
                    if p.meta.name in res.unschedulable]
        domains: set = set()
        unpinned: list = []
        if sp.domain_key is not None:
            for p in pods:
                if p.meta.name in res.unschedulable:
                    continue
                c = claim_of.get(p.meta.name)
                if c is not None:
                    req = c.requirements.get(sp.domain_key)
                    if req is None or not req.is_finite() or \
                            len(req.values()) != 1:
                        unpinned.append(p.meta.name)
                    else:
                        domains |= req.values()
                else:
                    node = res.existing_assignments.get(p.meta.name)
                    domains.add(
                        node_labels.get(node, {}).get(sp.domain_key))
        out[gname] = {"spec": sp, "total": len(pods),
                      "placed": len(pods) - len(stranded),
                      "stranded": stranded, "domains": domains,
                      "unpinned": unpinned}
    return out


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


@dataclass(frozen=True)
class VictimUnit:
    """One atomically-evictable unit the preemption planner considers: a
    single pod, or a WHOLE gang (evicting part of a gang would leave a
    broken gang running, so gangs evict all or none).  ``cost`` is the
    summed pod deletion cost (karpenter.sh/pod-deletion-cost),
    ``node_names`` the existing nodes whose capacity the eviction
    frees."""
    name: str                      # pod name, or "gang:<name>"
    priority: int
    cost: float
    pod_names: Tuple[str, ...]
    node_names: Tuple[str, ...]
    gang: "str | None" = None


def preemption_victim_order(units) -> list:
    """The ONE shared victim order both the planner and the oracle
    pre-pass walk (kernel-vs-oracle parity covers the *chosen victims*
    because both engines' plans come from this order): ascending
    effective priority (evict the least important first), then
    ascending deletion cost, then name for determinism."""
    return sorted(units, key=lambda u: (u.priority, u.cost, u.name))


@dataclass
class PreemptionPlan:
    """One planned preemption: evict ``victims`` (atomic per plan —
    a gang victim is whole-gang by construction) to seat the stranded
    higher-priority ``target_pods``.  ``plan_id`` is deterministic from
    the target so re-planning an unexecuted plan is idempotent."""
    plan_id: str
    target_pods: List[str]
    target_priority: int
    victims: List[VictimUnit] = field(default_factory=list)

    def victim_pod_names(self) -> List[str]:
        return [n for u in self.victims for n in u.pod_names]


def priority_inversion_audit(inp, res, plans=()) -> list:
    """The ONE priority-inversion checker the fuzz class and the
    config10 acceptance bench both assert (the gang_placement_audit
    pattern): an inversion is a LOWER-priority pod remaining placed
    (resident, same-pass assignment, or new-claim placement) while a
    HIGHER-priority pod strands *that its single eviction could seat*
    — the freed capacity fits the stranded pod on a node/claim whose
    labels, taints, and requirements it is compatible with.  Planned
    victims (``plans``) no longer count as "remaining placed", and a
    stranded pod an attached plan TARGETS is not an inversion (its
    seat is in flight — the Preemption controller executes the plan).
    Topology-constrained stranded pods are skipped (the capacity-level
    sufficiency check cannot model spread/affinity).  Returns a list of
    ``{pod, priority, victim, victim_priority, on}`` dicts — empty
    means the invariant holds."""
    from karpenter_tpu_torch.models.taints import tolerates_all
    planned = {n for p in plans for n in p.victim_pod_names()}
    targeted = {n for p in plans for n in p.target_pods}
    # remaining per existing node AFTER this pass's assignments
    assigned: Dict[str, List[Pod]] = {}
    by_name = {p.meta.name: p for p in inp.pods}
    for pod_name, node in res.existing_assignments.items():
        p = by_name.get(pod_name)
        if p is not None:
            assigned.setdefault(node, []).append(p)
    alloc_of = {it.name: it for types in inp.instance_types.values()
                for it in types}
    inversions = []
    for sname, _reason in res.unschedulable.items():
        s = by_name.get(sname)
        if s is None or sname in targeted \
                or s.topology_spread or s.pod_affinities:
            continue
        ps = priority_of(s)
        sreq = effective_request(s)
        for en in inp.existing_nodes:
            node = en.node
            if node.meta.deleting or not node.ready:
                continue
            if not tolerates_all(node.taints, s.tolerations):
                continue
            if not s.requirements.matched_by_labels(node.labels):
                continue
            rem = en.available
            for p in assigned.get(en.name, ()):
                rem = rem - effective_request(p)
            victims = list(en.pods) + assigned.get(en.name, [])
            for v in victims:
                if v.meta.name in planned or v.is_daemonset \
                        or v.do_not_disrupt():
                    continue
                if priority_of(v) >= ps:
                    continue
                if sreq.fits(rem + effective_request(v)):
                    inversions.append({
                        "pod": sname, "priority": ps,
                        "victim": v.meta.name,
                        "victim_priority": priority_of(v),
                        "on": en.name})
        for c in res.new_claims:
            if not c.instance_type_names:
                continue
            it = alloc_of.get(c.instance_type_names[0])
            if it is None:
                continue
            if not tolerates_all(c.taints, s.tolerations):
                continue
            if not c.requirements.compatible(s.requirements):
                continue
            # the claim's requirement intersection is silent on any key
            # no packed pod constrained, so `compatible` alone lets a
            # zone-pinned strand claim a seat on a type with no offering
            # in that zone.  Require one concrete offering whose labels
            # the strand accepts (conservative: a requirement on a label
            # outside these axes skips the claim rather than guessing).
            from karpenter_tpu_torch.models import wellknown as _wk
            if not any(
                    s.requirements.matched_by_labels({
                        _wk.ZONE_LABEL: o.zone,
                        _wk.CAPACITY_TYPE_LABEL: o.capacity_type,
                        _wk.INSTANCE_TYPE_LABEL: it.name,
                        _wk.NODEPOOL_LABEL: c.nodepool})
                    for o in it.offerings if o.available):
                continue
            rem = it.allocatable() - c.requests
            for v in c.pods:
                if v.meta.name in planned or v.is_daemonset \
                        or v.do_not_disrupt():
                    continue
                if priority_of(v) >= ps:
                    continue
                if sreq.fits(rem + effective_request(v)):
                    inversions.append({
                        "pod": sname, "priority": ps,
                        "victim": v.meta.name,
                        "victim_priority": priority_of(v),
                        "on": c.hostname or c.nodepool})
    return inversions


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
    # preemption plans proposed for still-stranded higher-priority pods
    # (solver/preempt.py): executing them is a controller's job, not the
    # scheduler's — attaching keeps solve() pure.
    preemptions: List["PreemptionPlan"] = field(default_factory=list)

    def node_count(self) -> int:
        return len(self.new_claims)

    def total_price(self) -> float:
        return sum(c.price for c in self.new_claims)
