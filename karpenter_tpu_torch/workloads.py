"""Scheduling inputs the port is measured on.

`build_config1()` is BASELINE config #1 (the JAX package's
`benchmarks/config1_inflate.py make_input`), the `inflate` Deployment:
100 identical pods of 1 cpu / 1536Mi on one NodePool against the
generated catalog cut to 30 types without GPUs.

`build_input(n)` is the headline workload (the JAX package's
`bench.py build_input`): `n` pods in 8 size classes, one of them asking for
an `nvidia.com/gpu`, one NodePool with no limits, no existing nodes and no
topology, against the 605-type generated catalog.

`build_config2()` is BASELINE config #2 at 5k pods (the JAX package's
`bench.py build_config2_5k`, the multichip bench's cell): 5,000 pods in 6
size classes, every third pinned to one of 3 zones by a node selector,
every seventh tolerating the `team=ml` taint, on 3 weighted NodePools —
"general" (weight 10), "spot-only" (capacity type spot) and "dedicated"
(tainted team=ml) — each against the full generated catalog.

`build_config3()` is BASELINE config #3 (the JAX package's
`benchmarks/config3_topology.py make_input`): 10k pods — 4 workloads of
2,495 pods, each spread over `topology.kubernetes.io/zone` with maxSkew 1,
and 20 singleton services with required hostname anti-affinity — on one
NodePool against the same catalog.

`build_config4()` is BASELINE config #4 (the JAX package's
`benchmarks/config4_consolidation.py make_input`): the consolidation sweep
of 2,000 under-utilized nodes (16 cpu / 32Gi / 58 pods, 3 zones, spot and
on-demand alternating, one 500m/1Gi pod each), one simulation per
candidate node — its pod against the other 1,999 nodes, price-capped at
0.5 — carrying the snapshot's provenance (`exist_base`, `exist_excluded`)
as the product's sweep does.  `build_config4b()` is the same sweep with
70% of the pods in 8 zone-spread deployments (maxSkew 2), the JAX
package's `benchmarks/config4b_consolidation_spread.py`.  Both are
solved with `solve_batch(inps, max_nodes=8)`.

`build_config9()` is BASELINE config #9 (the JAX package's
`benchmarks/config9_gang.py make_input`): 1,082 pods — 10 gangs of 2-64
members (one on the rack, i.e. capacity-type, axis, one domain-free, and
"jumbo", whose 8000Gi members strand it whole), an 8-of-9 "waiting" gang
that strands GangIncomplete, and 800 singletons — on one NodePool.

`build_config10()` is BASELINE config #10 (the JAX package's
`benchmarks/config10_priority.py make_input`): 650 pods in 4 priority
bands (best-effort, 100, 1000, system-critical) and a 12-cpu high pod
pinned to an edge zone that only one existing 16-cpu node serves, whose
residents — a 2-member low-priority gang and a low single — leave 4 cpu,
so the preemption planner must evict the whole gang; before the solve it
records the benchmark's spot storm (4 interruptions of the 6 cheapest
types in two zones) in the spot-risk model.

`build_soft_terms()` is a soft-term input in the style of the JAX
package's `tests/test_solver_fuzz.py` `_gen_problem_mixed`: 1,912 pods in
six classes — a preferred zone, preferred zone anti-affinity within the
class (12 pods over 3 zones: 9 relax), ScheduleAnyway zone spread, a
preferred capacity type and zone on a tolerated spot pool, plain pods,
and a preferred zone no offering has (all relax) — on two pools and two
existing nodes.  The relaxation loop solves it in rounds.

The steady state's three workloads reuse pod objects across passes as
their benchmarks do — an unchanged pod keeps its object, a churned one is
a fresh object with a generation-stamped name — and keep the same
catalog list, NodePool and existing nodes from pass to pass:

`build_config7(gen)` is BASELINE config #7 (the JAX package's
`benchmarks/config7_churn.py`): a warm 50k-pod cluster — 400 size classes
of 125 pods, 256 existing 16-cpu nodes — at churn generation `gen`, where
the 4 FFD-last classes' 500 pods (1%) are replaced.

`build_config12()` is BASELINE config #12 (`benchmarks/
config12_megascale.py`): a cold fleet of 640 classes x 737 pods =
471,680 pods against the generated catalog, each class exactly one full
node on the pods axis, so the true scan only opens new nodes.

`build_config13(n_pods, gen)` is BASELINE config #13 (`benchmarks/
config13_warm_million.py`) at `n_pods`: 400 classes on one huge machine
shape whose pod capacity scales with the size, 256 existing nodes that
absorb nothing, and per generation the 4 tail classes' 125 pods each
replaced (500 pods at every size).  It returns the input and the watch
events since the previous generation (name -> the new object, None for
a deleted pod), in the order a store reports them.  Every count and
capacity stays below 2^24 (f32-exact) up to the benchmark's 1,000,000
pods (`C13_SIZES`).

`build_config6(n_messages, device, pkg)` is BASELINE config #6 (the JAX
package's `benchmarks/config6_interruption.py`): an `env.Environment` on
`device` with the default NodeClass and pool, and per message one
`m5.large` instance in the fake cloud (zones in turn, spot and on-demand
alternating) with a launched NodeClaim, then one queued interruption
message per claim (`i % 4`: a spot interruption twice, a "stopping"
state change, a rebalance recommendation).  `drain_config6(env)` drains
the queue with one `env.interruption.reconcile()` and returns what the
benchmark reports: the seconds and msgs/s, the claims deleted (their
names and `names_digest`), the offerings marked unavailable, and whether
the queue is empty.

`provisioning_loop(n_pods, options, clock, device)` is the provisioning
control loop as the JAX package's `env.py` wires it, cut to the
controllers ported so far: the fake cloud with the 605-type catalog, the
pricing and instance-type providers, the unavailable-offerings cache, the
cloud provider (metrics-decorated, without the subnet, launch-template,
security-group and image plumbing, which `TPUCloudProvider` takes as
None), the cluster store, the port's `GatedSolver` on `device`, and a
`ControllerManager` over the provisioner, the NodeClaim lifecycle, the
fake kubelet and the pod binder.  The store holds one NodePool `default`,
the default NodeClass and the headline's first `n_pods` pods
(`headline_pods`); `loop_answer` is the loop's canonical outcome, and
`store_answer` the same fields read off the store alone (for a process
that holds only a store client, as beside `python -m karpenter_tpu_torch`).

`disruption_loop(n_pods, options, clock, device)` is the disruption
control loop, BASELINE config #4's fleet reached through the port's
`env.Environment` (every controller, the reference's wiring): the default
NodeClass, a spot pool (weight 100, a cpu limit of half the fleet's
16-vCPU nodes) and an on-demand pool of the 2-16 vCPU types, and
`n_pods` pods that each need a 16-vCPU node.  `DisruptionWaves` drives it
(and the JAX package's, built with `pkg`) through three waves: provision;
resize every pod in place to 500m / 1Gi and settle until a settle
changes nothing, consolidating the fleet; spot interruptions.

`Config8Traffic` is BASELINE config #8 (the JAX package's
`benchmarks/config8_saturation.py Workload`): the closed-loop traffic one
tenant of a shared solver service sends — mostly ~120-pod 24-class
solves, every 4th step a 2-wide `solve_batch`, every 8th a ~48-pod
12-class solve — against the 12-type catalog without GPUs
(`config8_catalog`), deterministic per (tenant, iteration); `CONFIG8_*`
are the benchmark's tenants, arm length, node cap and window.
`config8_canon(res)` is the benchmark's canonical result with each price
as its IEEE hex.

`build_rewind_day(seed)` is BASELINE config #11 (the JAX package's
`benchmarks/config11_rewind.py build_day`): a compressed six-hour fleet
day of at least 5,000 events for the rewind engine — the diurnal hum, a
noon spot storm, an afternoon gang burst, an evening priority wave and
one solve-worker crash with its restart — replayed at `REWIND_TICK`
second ticks.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

from karpenter_tpu_torch.models import (
    InstanceType,
    Node,
    NodePool,
    ObjectMeta,
    Offering,
    Pod,
    PodAffinityTerm,
    Requirement,
    Requirements,
    Resources,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    wellknown,
)
from karpenter_tpu_torch.providers import generate_catalog
from karpenter_tpu_torch.scheduling import ExistingNode, ScheduleInput

HEADLINE_SIZES = (
    {"cpu": "250m", "memory": "512Mi"},
    {"cpu": "500m", "memory": "1Gi"},
    {"cpu": "1", "memory": "2Gi"},
    {"cpu": "2", "memory": "8Gi"},
    {"cpu": "4", "memory": "8Gi"},
    {"cpu": "500m", "memory": "2Gi"},
    {"cpu": "1", "memory": "4Gi"},
    {"cpu": "8", "memory": "16Gi", "nvidia.com/gpu": 1},
)


def build_input(n_pods: int) -> ScheduleInput:
    catalog = generate_catalog()
    sizes = HEADLINE_SIZES
    pods = [
        Pod(meta=ObjectMeta(name=f"p{i}"),
            requests=Resources.parse(sizes[i % len(sizes)]))
        for i in range(n_pods)
    ]
    pool = NodePool(meta=ObjectMeta(name="default"))
    return ScheduleInput(pods=pods, nodepools=[pool],
                         instance_types={"default": catalog})


CONFIG1_PODS = 100
CONFIG1_TYPES = 30


def build_config1() -> ScheduleInput:
    from karpenter_tpu_torch.providers.catalog import CatalogSpec
    catalog = generate_catalog(CatalogSpec(max_types=CONFIG1_TYPES,
                                           include_gpu=False))
    pods = [Pod(meta=ObjectMeta(name=f"inflate-{i}"),
                requests=Resources.parse({"cpu": "1", "memory": "1536Mi"}))
            for i in range(CONFIG1_PODS)]
    pool = NodePool(meta=ObjectMeta(name="default"))
    return ScheduleInput(pods=pods, nodepools=[pool],
                         instance_types={"default": catalog})


def build_config2() -> ScheduleInput:
    catalog = generate_catalog()
    zones = ["tpu-west-1a", "tpu-west-1b", "tpu-west-1c"]
    sizes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"),
             ("2", "4Gi"), ("4", "8Gi"), ("500m", "2Gi")]
    general = NodePool(meta=ObjectMeta(name="general"), weight=10)
    spot = NodePool(meta=ObjectMeta(name="spot-only"),
                    requirements=Requirements(Requirement.make(
                        wellknown.CAPACITY_TYPE_LABEL, "In", "spot")))
    dedicated = NodePool(meta=ObjectMeta(name="dedicated"),
                         taints=[Taint("team", "ml")])
    pods = []
    for i in range(5000):
        cpu, mem = sizes[i % len(sizes)]
        p = Pod(meta=ObjectMeta(name=f"m{i}"),
                requests=Resources.parse({"cpu": cpu, "memory": mem}))
        if i % 3 == 0:
            p.requirements = Requirements(Requirement.make(
                wellknown.ZONE_LABEL, "In", zones[i % len(zones)]))
        if i % 7 == 0:
            p.tolerations = [Toleration(key="team", operator="Exists")]
        pods.append(p)
    pools = [general, spot, dedicated]
    return ScheduleInput(pods=pods, nodepools=pools,
                         instance_types={p.meta.name: catalog
                                         for p in pools})


def build_soft_terms(M=None, Sch=None, catalog=None) -> ScheduleInput:
    """The soft-term input (module docstring).  `M` (models), `Sch`
    (scheduling types) and `catalog` default to the port's and its
    generated catalog; a test passes another package's to build the same
    input from its classes."""
    if M is None:
        import karpenter_tpu_torch.models as M
        import karpenter_tpu_torch.scheduling as Sch
    if catalog is None:
        catalog = generate_catalog()
    wk = M.wellknown
    zone, ct = wk.ZONE_LABEL, wk.CAPACITY_TYPE_LABEL

    def prefer(weight, key, value):
        return (weight, M.Requirements(M.Requirement.make(key, "In",
                                                          value)))

    classes = [
        # (name, count, cpu, memory, extra fields)
        ("softzone", 500, "500m", "1Gi",
         dict(preferences=[prefer(100, zone, "tpu-west-1b")])),
        ("softanti", 12, "1", "2Gi",
         dict(pod_affinities=[M.PodAffinityTerm(
             label_selector={"grp": "softanti"}, topology_key=zone,
             anti=True, required=False)])),
        ("sanyspread", 600, "250m", "512Mi",
         dict(topology_spread=[M.TopologySpreadConstraint(
             topology_key=zone, max_skew=1,
             when_unsatisfiable="ScheduleAnyway",
             label_selector={"grp": "sanyspread"})])),
        ("softspot", 300, "2", "2Gi",
         dict(preferences=[prefer(50, ct, "spot"),
                           prefer(10, zone, "tpu-west-1a")],
              tolerations=[M.Toleration(key="dedicated", value="burst")])),
        ("plain", 400, "125m", "256Mi", {}),
        ("nowhere", 100, "500m", "512Mi",
         dict(preferences=[prefer(100, zone, "tpu-west-1z")])),
    ]
    pods = []
    for name, count, cpu, mem, extra in classes:
        for i in range(count):
            pods.append(M.Pod(
                meta=M.ObjectMeta(name=f"{name}-{i}",
                                  labels={"grp": name}),
                requests=M.Resources.parse({"cpu": cpu, "memory": mem}),
                **{k: list(v) for k, v in extra.items()}))
    pools = [M.NodePool(meta=M.ObjectMeta(name="default"), weight=100),
             M.NodePool(meta=M.ObjectMeta(name="burst"), weight=10,
                        taints=[M.Taint(key="dedicated", value="burst")],
                        requirements=M.Requirements(M.Requirement.make(
                            ct, "In", "spot")))]
    existing = []
    for i, z in enumerate(("tpu-west-1a", "tpu-west-1c")):
        alloc = M.Resources.parse({"cpu": "16", "memory": "64Gi",
                                   "pods": "110"})
        existing.append(Sch.ExistingNode(
            node=M.Node(meta=M.ObjectMeta(
                name=f"exist-{i}",
                labels={zone: z, ct: "on-demand",
                        wk.HOSTNAME_LABEL: f"exist-{i}",
                        wk.NODEPOOL_LABEL: "default"}),
                allocatable=alloc, ready=True),
            available=alloc, pods=[]))
    return Sch.ScheduleInput(pods=pods, nodepools=pools,
                             instance_types={p.name: catalog for p in pools},
                             existing_nodes=existing)


def build_config3() -> ScheduleInput:
    catalog = generate_catalog()
    pods = []
    # 4 spread workloads x 2,495 pods, each zone-balanced within itself
    for w in range(4):
        sel = {"app": f"web-{w}"}
        for i in range(2495):
            pods.append(Pod(
                meta=ObjectMeta(name=f"w{w}-p{i}", labels=dict(sel)),
                requests=Resources.parse({"cpu": "250m", "memory": "512Mi"}),
                topology_spread=[TopologySpreadConstraint(
                    topology_key=wellknown.ZONE_LABEL, max_skew=1,
                    label_selector=sel)]))
    # 20 singleton services, one per node via required anti-affinity
    for s_ in range(20):
        sel = {"svc": f"s{s_}"}
        pods.append(Pod(
            meta=ObjectMeta(name=f"svc-{s_}", labels=dict(sel)),
            requests=Resources.parse({"cpu": "1", "memory": "2Gi"}),
            pod_affinities=[PodAffinityTerm(
                label_selector=sel, topology_key=wellknown.HOSTNAME_LABEL,
                anti=True)]))
    pool = NodePool(meta=ObjectMeta(name="default"))
    return ScheduleInput(pods=pods, nodepools=[pool],
                         instance_types={"default": catalog})


CONSOLIDATION_ZONES = ("tpu-west-1a", "tpu-west-1b", "tpu-west-1c")


def _consolidation_cluster(spread: bool) -> List[ExistingNode]:
    """Config #4's 2,000 nodes, each with one 500m/1Gi pod; with `spread`,
    config #4b's pods: 70% members of 8 zone-spread deployments."""
    nodes = []
    for i in range(2000):
        n = Node(meta=ObjectMeta(name=f"n{i}", labels={
            wellknown.ZONE_LABEL: CONSOLIDATION_ZONES[i % 3],
            wellknown.CAPACITY_TYPE_LABEL: ["spot", "on-demand"][i % 2],
            wellknown.NODEPOOL_LABEL: "default",
            wellknown.ARCH_LABEL: "amd64", wellknown.OS_LABEL: "linux",
            wellknown.HOSTNAME_LABEL: f"n{i}"}),
            allocatable=Resources.of(cpu=16000, memory=32768, pods=58),
            ready=True)
        requests = Resources.parse({"cpu": "500m", "memory": "1Gi"})
        grp = i % 10
        if spread and grp < 8 and i % 5 != 4:
            # a spread-constrained deployment member (self selector,
            # maxSkew 2)
            p = Pod(meta=ObjectMeta(name=f"p{i}",
                                    labels={"app": f"dep{grp}"}),
                    requests=requests, node_name=f"n{i}",
                    topology_spread=[TopologySpreadConstraint(
                        topology_key=wellknown.ZONE_LABEL, max_skew=2,
                        label_selector={"app": f"dep{grp}"})])
        else:
            p = Pod(meta=ObjectMeta(name=f"p{i}"), requests=requests,
                    node_name=f"n{i}")
        nodes.append(ExistingNode(node=n,
                                  available=n.allocatable - p.requests,
                                  pods=[p]))
    return nodes


def _consolidation_sweep(spread: bool) -> List[ScheduleInput]:
    shared = list(generate_catalog())
    pool = NodePool(meta=ObjectMeta(name="default"))
    nodes = _consolidation_cluster(spread)
    return [ScheduleInput(
        pods=list(nodes[i].pods), nodepools=[pool],
        instance_types={"default": shared},
        existing_nodes=nodes[:i] + nodes[i + 1:],
        price_cap=0.5,
        exist_base=nodes, exist_excluded=(i,)) for i in range(2000)]


def build_config4() -> List[ScheduleInput]:
    return _consolidation_sweep(spread=False)


def build_config4b() -> List[ScheduleInput]:
    return _consolidation_sweep(spread=True)


# config #9: (gang name, member count, per-pod cpu, per-pod memory,
# adjacency domain: None = the default zone axis, "rack" = capacity type,
# "none" = domain-free)
CONFIG9_GANGS = (
    ("mpi-a", 2, "2", "4Gi", None),
    ("mpi-b", 4, "4", "8Gi", None),
    ("mpi-c", 8, "2", "4Gi", None),
    ("mpi-d", 12, "1", "2Gi", "rack"),
    ("mpi-e", 16, "2", "4Gi", None),
    ("mpi-f", 24, "1", "2Gi", "none"),
    ("mpi-g", 32, "2", "4Gi", None),
    ("mpi-h", 48, "1", "2Gi", None),
    ("mpi-i", 64, "1", "2Gi", None),
    ("jumbo", 64, "4", "8000Gi", None),
)
CONFIG9_WAITING = ("waiting", 8)   # declared size 9, only 8 pending
CONFIG9_SINGLETONS = 800


def _gang_pod(name, gname, size, cpu, mem, dom) -> Pod:
    ann = {wellknown.GANG_NAME_ANNOTATION: gname,
           wellknown.GANG_SIZE_ANNOTATION: str(size)}
    if dom is not None:
        ann[wellknown.GANG_TOPOLOGY_ANNOTATION] = dom
    return Pod(meta=ObjectMeta(name=name, annotations=ann),
               requests=Resources.parse({"cpu": cpu, "memory": mem}))


def build_config9() -> ScheduleInput:
    pods = []
    for gname, size, cpu, mem, dom in CONFIG9_GANGS:
        for i in range(size):
            pods.append(_gang_pod(f"{gname}-{i}", gname, size, cpu, mem,
                                  dom))
    wname, wpending = CONFIG9_WAITING
    for i in range(wpending):
        pods.append(_gang_pod(f"{wname}-{i}", wname, wpending + 1, "1",
                              "2Gi", None))
    for i in range(CONFIG9_SINGLETONS):
        pods.append(Pod(
            meta=ObjectMeta(name=f"s{i}"),
            requests=Resources.parse(
                {"cpu": ["250m", "500m", "1"][i % 3],
                 "memory": ["512Mi", "1Gi", "2Gi"][i % 3]})))
    pool = NodePool(meta=ObjectMeta(name="default"))
    return ScheduleInput(pods=pods, nodepools=[pool],
                         instance_types={"default": generate_catalog()})


# config #10: a zone that exists only on the hand-built edge node
CONFIG10_EDGE_ZONE = "tpu-edge-1x"
# (prefix, count, cpu, memory, priority annotation): four bands from
# best-effort to system-critical
CONFIG10_WAVES = (
    ("be", 300, "250m", "512Mi", None),
    ("mid", 200, "1", "2Gi", 100),
    ("hi", 120, "2", "4Gi", 1000),
    ("sys", 30, "1", "2Gi", 2_000_000_000),
)
# the storm: spot reclaims observed in two zones for the catalog's
# cheapest types
CONFIG10_STORM_ZONES = ("tpu-west-1a", "tpu-west-1b")
CONFIG10_STORM_OBSERVATIONS = 4


def _prio_pod(name, cpu, mem, prio=None, annotations=None) -> Pod:
    ann = dict(annotations or {})
    if prio is not None:
        ann[wellknown.PRIORITY_ANNOTATION] = str(prio)
    return Pod(meta=ObjectMeta(name=name, annotations=ann),
               requests=Resources.parse({"cpu": cpu, "memory": mem}))


def _edge_node() -> ExistingNode:
    """The 16-cpu edge node: a 2 x 5-cpu low gang and a 2-cpu low single
    leave 4 cpu; the pinned 12-cpu high pod seats only when the gang
    goes."""
    residents = [_prio_pod(f"ring-{i}", "5", "4Gi", prio=1, annotations={
        wellknown.GANG_NAME_ANNOTATION: "ring",
        wellknown.GANG_SIZE_ANNOTATION: "2"}) for i in range(2)]
    residents.append(_prio_pod("low-edge", "2", "1Gi", prio=1))
    alloc = Resources.parse({"cpu": "16", "memory": "64Gi", "pods": "110"})
    used = Resources()
    for p in residents:
        used += p.requests
        p.node_name = "edge-0"
    node = Node(meta=ObjectMeta(
        name="edge-0",
        labels={wellknown.ZONE_LABEL: CONFIG10_EDGE_ZONE,
                wellknown.CAPACITY_TYPE_LABEL: "on-demand",
                wellknown.HOSTNAME_LABEL: "edge-0",
                wellknown.NODEPOOL_LABEL: "default"}),
        allocatable=alloc, ready=True)
    return ExistingNode(node=node, available=alloc - used, pods=residents)


def build_config10() -> ScheduleInput:
    from karpenter_tpu_torch.scheduling import risk
    catalog = generate_catalog()
    risk.reset()
    cheap = sorted(catalog, key=lambda it: min(
        (o.price for o in it.offerings if o.available), default=1e9))
    for it in cheap[:6]:
        for zone in CONFIG10_STORM_ZONES:
            for _ in range(CONFIG10_STORM_OBSERVATIONS):
                risk.observe_interruption(it.name, zone)
    pods = []
    for prefix, count, cpu, mem, prio in CONFIG10_WAVES:
        for i in range(count):
            pods.append(_prio_pod(f"{prefix}-{i}", cpu, mem, prio=prio))
    # the preemption trigger: a high pod pinned where only evicting the
    # resident low gang can seat it
    pin = _prio_pod("pin-hi", "12", "8Gi", prio=1000)
    pin.requirements = Requirements(
        Requirement.make(wellknown.ZONE_LABEL, "In", CONFIG10_EDGE_ZONE))
    pods.append(pin)
    pool = NodePool(meta=ObjectMeta(name="default"))
    return ScheduleInput(pods=pods, nodepools=[pool],
                         instance_types={"default": catalog},
                         existing_nodes=[_edge_node()])


# -- the steady state: BASELINE config #7, #12 and #13 ------------------------
C7_CLASSES = 400
C7_PODS_PER_CLASS = 125
C7_CHURN_CLASSES = 4
_C7: Dict = {}


def _warm_nodes(n: int, alloc: Resources, mixed: bool) -> List[ExistingNode]:
    """`n` ready existing nodes "warm<i>" of allocatable `alloc`; `mixed`
    spreads them over three zones with spot and on-demand alternating."""
    out = []
    for i in range(n):
        node = Node(
            meta=ObjectMeta(name=f"warm{i}", labels={
                wellknown.ZONE_LABEL: (f"tpu-west-1{'abc'[i % 3]}" if mixed
                                       else "tpu-west-1a"),
                wellknown.CAPACITY_TYPE_LABEL: (
                    ["spot", "on-demand"][i % 2] if mixed
                    else "on-demand"),
                wellknown.NODEPOOL_LABEL: "default",
                wellknown.HOSTNAME_LABEL: f"warm{i}"}),
            allocatable=alloc, ready=True)
        out.append(ExistingNode(node=node, available=node.allocatable,
                                pods=[]))
    return out


def build_config7(gen: int) -> ScheduleInput:
    if not _C7:
        _C7.update(
            catalog=generate_catalog(),
            existing=_warm_nodes(256, Resources.of(cpu=16000, memory=65536,
                                                   pods=110), mixed=True),
            pool=NodePool(meta=ObjectMeta(name="default")), pop={})
    pop = _C7["pop"]
    pods = []
    for g in range(C7_CLASSES):
        stamp = gen if g >= C7_CLASSES - C7_CHURN_CLASSES else 0
        for i in range(C7_PODS_PER_CLASS):
            p = pop.get((g, i))
            if p is None or not p.meta.name.endswith(f"-{stamp}"):
                cpu = 2100 - 5 * g        # distinct size per class
                p = pop[(g, i)] = Pod(
                    meta=ObjectMeta(name=f"w{g}-{i}-{stamp}"),
                    requests=Resources.parse({"cpu": f"{cpu}m",
                                              "memory": f"{2 * cpu}Mi"}))
            pods.append(p)
    return ScheduleInput(pods=pods, nodepools=[_C7["pool"]],
                         instance_types={"default": _C7["catalog"]},
                         existing_nodes=list(_C7["existing"]))


C12_CLASSES = 640
C12_PODS_PER_CLASS = 737
_C12: Dict = {}


def build_config12() -> ScheduleInput:
    if not _C12:
        pods = []
        for g in range(C12_CLASSES):
            res = Resources.parse({"cpu": f"{100 + g % 31}m",
                                   "memory": f"{150 + g % 97}Mi"})
            for i in range(C12_PODS_PER_CLASS):
                pods.append(Pod(meta=ObjectMeta(name=f"mg{g}-{i}"),
                                requests=res.copy()))
        _C12.update(pods=pods, catalog=generate_catalog(),
                    pool=NodePool(meta=ObjectMeta(name="default")))
    return ScheduleInput(pods=list(_C12["pods"]), nodepools=[_C12["pool"]],
                         instance_types={"default": _C12["catalog"]})


C13_CLASSES = 400
C13_CHURN_CLASSES = 4
C13_CHURN_PODS = 125
C13_SIZES = (50_000, 1_000_000)   # the benchmark's sweep
_C13: Dict[int, Dict] = {}


def _c13_catalog(pod_cap: int) -> List[InstanceType]:
    labels = {
        wellknown.INSTANCE_TYPE_LABEL: "warm.metal",
        wellknown.ARCH_LABEL: "amd64",
        wellknown.OS_LABEL: wellknown.OS_LINUX,
    }
    reqs = Requirements(*(Requirement.single(k, v)
                          for k, v in labels.items()))
    reqs.add(Requirement.make(wellknown.ZONE_LABEL, "In", "tpu-west-1a"))
    reqs.add(Requirement.make(wellknown.CAPACITY_TYPE_LABEL, "In",
                              wellknown.CAPACITY_TYPE_ON_DEMAND))
    return [InstanceType(
        name="warm.metal",
        capacity=Resources.of(cpu=8_000_000, memory=16_000_000,
                              pods=pod_cap),
        requirements=reqs,
        offerings=[Offering("tpu-west-1a",
                            wellknown.CAPACITY_TYPE_ON_DEMAND, 64.0)])]


def _c13_counts(total: int) -> List[int]:
    static = C13_CLASSES - C13_CHURN_CLASSES
    base, rem = divmod(total - C13_CHURN_CLASSES * C13_CHURN_PODS, static)
    return ([base + (1 if g < rem else 0) for g in range(static)]
            + [C13_CHURN_PODS] * C13_CHURN_CLASSES)


def build_config13(n_pods: int, gen: int
                   ) -> Tuple[ScheduleInput, Dict[str, object]]:
    st = _C13.get(n_pods)
    if st is None or gen < st["gen"]:
        counts = _c13_counts(n_pods)
        res = {}

        def pod(g, i, stamp):
            r = res.get(g)
            if r is None:
                cpu = 2100 - 5 * g        # tail (churn) classes sort last
                r = res[g] = Resources.parse({"cpu": f"{cpu}m",
                                              "memory": f"{2 * cpu}Mi"})
            return Pod(meta=ObjectMeta(name=f"w{g}-{i}-{stamp}"),
                       requests=r)

        st = _C13[n_pods] = dict(
            gen=0, pod=pod, catalog=_c13_catalog(max(counts)),
            existing=_warm_nodes(256, Resources.of(cpu=1, memory=1, pods=0),
                                 mixed=False),
            pool=NodePool(meta=ObjectMeta(name="default")),
            pods=[pod(g, i, 0) for g in range(C13_CLASSES)
                  for i in range(counts[g])])
    events: Dict[str, object] = {}
    n_churn = C13_CHURN_CLASSES * C13_CHURN_PODS
    while st["gen"] < gen:
        st["gen"] += 1
        fresh = [st["pod"](g, i, st["gen"])
                 for g in range(C13_CLASSES - C13_CHURN_CLASSES,
                                C13_CLASSES)
                 for i in range(C13_CHURN_PODS)]
        # store order: the outgoing pods' deletes, then the creates
        # appended at the tail, as a watch stream reports them
        for p in st["pods"][-n_churn:]:
            events[p.meta.name] = None
        events.update({p.meta.name: p for p in fresh})
        del st["pods"][-n_churn:]
        st["pods"].extend(fresh)
    inp = ScheduleInput(pods=st["pods"], nodepools=[st["pool"]],
                        instance_types={"default": st["catalog"]},
                        existing_nodes=list(st["existing"]))
    return inp, events


# -- BASELINE config #8: the solver service under multi-tenant load --------
CONFIG8_TENANTS = 8
CONFIG8_ARM_S = 12.0        # seconds each arm (fusion on, fusion off) runs
CONFIG8_MAX_NODES = 128     # the worker's KARPENTER_TPU_MAX_NODES
CONFIG8_WINDOW = ("--idle-ms", "25", "--max-ms", "150")  # kt_solverd's
CONFIG8_WARM_STEPS = (0, 3, 7)  # one step of each traffic shape


def config8_catalog() -> List[InstanceType]:
    """The benchmark's catalog: the generated one cut to 12 types, no
    GPUs."""
    from karpenter_tpu_torch.providers.catalog import CatalogSpec
    return generate_catalog(CatalogSpec(max_types=12, include_gpu=False))


class Config8Traffic:
    """config #8's per-(tenant, iteration) traffic, so the fused arm, the
    unfused arm, and the solo parity solver all see identical problems."""

    def __init__(self, catalog=None, pool=None):
        self.catalog = catalog if catalog is not None else config8_catalog()
        self.pool = pool if pool is not None else NodePool(
            meta=ObjectMeta(name="default"))

    def mkinp(self, tag, n=10, classes=1) -> ScheduleInput:
        pods = [Pod(meta=ObjectMeta(name=f"{tag}-p{c}-{i}"),
                    requests=Resources.parse(
                        {"cpu": f"{500 + 10 * c}m", "memory": "1Gi"}))
                for c in range(classes) for i in range(n)]
        return ScheduleInput(pods=pods, nodepools=[self.pool],
                             instance_types={"default": self.catalog})

    def inputs(self, tenant, it) -> List[ScheduleInput]:
        """The inputs of traffic step `it` of `tenant`: a 12-class solve
        every 8th step, a 2-wide 24-class batch every 4th, else one
        24-class solve."""
        if it % 8 == 7:
            return [self.mkinp(f"{tenant}-i{it}", n=4, classes=12)]
        if it % 4 == 3:
            return [self.mkinp(f"{tenant}-i{it}b{j}", n=4 + j, classes=24)
                    for j in range(2)]
        return [self.mkinp(f"{tenant}-i{it}", n=5 + it % 2, classes=24)]

    def call(self, client, tenant, it):
        """One traffic step through `client` (a `SolverServiceClient`);
        returns (n_requests, [results], [inputs])."""
        inps = self.inputs(tenant, it)
        if len(inps) > 1:
            return len(inps), client.solve_batch(inps), inps
        return 1, [client.solve(inps[0])], inps

    def warm(self, client, tenant):
        """Every traffic shape once (`CONFIG8_WARM_STEPS`)."""
        return [self.call(client, f"{tenant}-warm", it)
                for it in CONFIG8_WARM_STEPS]


def config8_canon(res):
    """The benchmark's `canon`, prices as IEEE hex: the new claims
    (pool, pods, types, price), the existing-node assignments and the
    unschedulable pods."""
    return (sorted((c.nodepool, tuple(sorted(p.meta.name for p in c.pods)),
                    tuple(c.instance_type_names), float(c.price).hex())
                   for c in res.new_claims),
            sorted(dict(res.existing_assignments).items()),
            sorted(res.unschedulable))


# -- the provisioning control loop ------------------------------------------
def headline_pods(n: int, prefix: str = "p",
                  sizes=HEADLINE_SIZES) -> List[Pod]:
    """`n` pods named `prefix`0.. cycling through `sizes` (the headline's
    eight by default)."""
    return [Pod(meta=ObjectMeta(name=f"{prefix}{i}"),
                requests=Resources.parse(sizes[i % len(sizes)]))
            for i in range(n)]


# the second wave of the loop's cell: the headline's two smallest sizes
WAVE2_SIZES = HEADLINE_SIZES[:2]


@dataclass
class ProvisioningLoop:
    """The pieces `provisioning_loop` wires, as `env.py` names them."""
    clock: object
    options: object
    cloud: object
    pricing: object
    unavailable: object
    instance_types: object
    cluster: object
    cloud_provider: object
    solver: object
    provisioner: object
    lifecycle: object
    kubelet: object
    binder: object
    manager: object

    def add_pods(self, pods: List[Pod]) -> None:
        for pod in pods:
            self.cluster.pods.create(pod)

    def settle(self, max_rounds: int = 50) -> int:
        """Run every controller until the cluster stops changing; the
        rounds taken."""
        return self.manager.run_until_idle(max_rounds)


def provisioning_loop(n_pods: int, options=None, clock=None,
                      device="cuda", catalog=None,
                      store_backend=None) -> ProvisioningLoop:
    """The provisioning control loop (module docstring) holding the
    headline's first `n_pods` pods, not yet reconciled.  `options`
    defaults to `Options()`, `clock` to a `FakeClock`, `catalog` to the
    generated 605-type catalog, `store_backend` (the cluster's
    `store.StoreBackend`, e.g. a `RemoteBackend` on a store daemon) to
    the in-memory store."""
    from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
    from karpenter_tpu_torch.cluster import Cluster
    from karpenter_tpu_torch.controllers import (
        ControllerManager,
        FakeKubelet,
        NodeClaimLifecycle,
        PodBinder,
        Provisioner,
    )
    from karpenter_tpu_torch.controllers.state import GatedSolver
    from karpenter_tpu_torch.models import NodeClass
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.providers import (
        FakeCloud,
        InstanceTypeProvider,
        PricingProvider,
    )
    from karpenter_tpu_torch.utils import metrics
    from karpenter_tpu_torch.utils.cache import UnavailableOfferings
    from karpenter_tpu_torch.utils.clock import FakeClock

    clock = clock or FakeClock()
    options = options or Options()
    cloud = FakeCloud(catalog=catalog, clock=clock)
    pricing = PricingProvider(cloud)
    unavailable = UnavailableOfferings(clock=clock)
    instance_types = InstanceTypeProvider(cloud, pricing, unavailable,
                                          clock=clock)
    cluster = Cluster(clock=clock, backend=store_backend)
    cloud_provider = metrics.DecoratedCloudProvider(TPUCloudProvider(
        cloud=cloud, instance_types=instance_types, unavailable=unavailable,
        node_classes=cluster.nodeclasses,
        cluster_name=options.cluster_name))
    solver = GatedSolver(options, cluster, device=device)
    provisioner = Provisioner(cluster, cloud_provider, options, clock,
                              solver=solver)
    lifecycle = NodeClaimLifecycle(cluster, cloud_provider, options, clock)
    kubelet = FakeKubelet(cluster, cloud_provider)
    binder = PodBinder(cluster)
    manager = ControllerManager(cluster,
                                [provisioner, lifecycle, kubelet, binder])
    cluster.nodeclasses.create(NodeClass(meta=ObjectMeta(name="default")))
    cluster.nodepools.create(NodePool(meta=ObjectMeta(name="default")))
    loop = ProvisioningLoop(
        clock=clock, options=options, cloud=cloud, pricing=pricing,
        unavailable=unavailable, instance_types=instance_types,
        cluster=cluster, cloud_provider=cloud_provider, solver=solver,
        provisioner=provisioner, lifecycle=lifecycle, kubelet=kubelet,
        binder=binder, manager=manager)
    loop.add_pods(headline_pods(n_pods))
    return loop


def _digest(rows) -> str:
    import hashlib
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


def _answer(cluster, insts, book) -> Dict[str, object]:
    """The fields of `loop_answer` but `rounds`: `insts` the sorted
    (nodepool, instance type, zone, capacity type) of the running
    instances, priced from `book` in that order; the pods bound per node
    and left unbound, read off `cluster`."""
    price = 0.0
    for _, t, z, ct in insts:
        price += book[(t, z, ct)]
    per_node: Dict[str, int] = {}
    unbound = 0
    for pod in cluster.pods.list():
        if pod.node_name and pod.phase == "Running":
            per_node[pod.node_name] = per_node.get(pod.node_name, 0) + 1
        else:
            unbound += 1
    nodes = sorted(
        (n.meta.name, n.meta.labels.get(wellknown.INSTANCE_TYPE_LABEL),
         per_node.get(n.meta.name, 0)) for n in cluster.nodes.list())
    return {"instances": len(insts), "instances_digest": _digest(insts),
            "price": float(price).hex(), "nodes": len(nodes),
            "pods_per_node_digest": _digest(nodes),
            "bound": sum(per_node.values()), "unbound": unbound}


def loop_answer(cluster, cloud, rounds: int) -> Dict[str, object]:
    """The canonical outcome of a settled loop, read off its store and its
    cloud with attribute access only (so it reads either package's
    objects): the running instances' sorted (nodepool, instance type,
    zone, capacity type) and their count, the IEEE-hex sum of their
    catalog prices in that order, each node's bound-pod count (sorted by
    node name, with the node's instance type), the pods bound and left
    unbound, and the rounds taken."""
    book = {(it.name, o.zone, o.capacity_type): o.price
            for it in cloud.describe_instance_types() for o in it.offerings}
    insts = sorted(
        (i.tags.get("karpenter.sh/nodepool"), i.instance_type, i.zone,
         i.capacity_type)
        for i in cloud.instances.values() if i.state == "running")
    return dict(_answer(cluster, insts, book), rounds=rounds)


def store_answer(cluster, catalog) -> Dict[str, object]:
    """`loop_answer`'s fields but `rounds`, read off the store alone: the
    nodes' (nodepool, instance type, zone, capacity type) labels stand
    for the running instances (one node each), priced from `catalog`'s
    offerings."""
    book = {(it.name, o.zone, o.capacity_type): o.price
            for it in catalog for o in it.offerings}
    insts = sorted(
        tuple(n.meta.labels.get(k) for k in (
            wellknown.NODEPOOL_LABEL, wellknown.INSTANCE_TYPE_LABEL,
            wellknown.ZONE_LABEL, wellknown.CAPACITY_TYPE_LABEL))
        for n in cluster.nodes.list())
    return _answer(cluster, insts, book)


# -- the rewind day ------------------------------------------------------------
REWIND_TICK = 240.0       # replay frame: one settle/audit round per 4 min
REWIND_DAY = 21600.0      # 6 h of compressed fleet life
REWIND_MIN_EVENTS = 5000


def build_rewind_day(seed: int = 1107) -> List[dict]:
    """BASELINE config #11's day (module docstring): diurnal hum + noon
    spot storm + afternoon gang burst + evening priority wave + one
    worker crash, from the port's seeded generators."""
    from karpenter_tpu_torch.timeline import generators as g
    day, tick = REWIND_DAY, REWIND_TICK
    return g.compose(
        g.diurnal_load(seed=seed, duration=day, step=tick,
                       base=12, peak=48, lifetime=2700.0),
        g.spot_storm(at=day * 0.45, reclaims=60, spacing=20.0,
                     seed=seed + 1),
        g.gang_burst(at=day * 0.6, gangs=30, size=6, spacing=8.0,
                     seed=seed + 2),
        g.priority_wave(at=day * 0.75,
                        bands=((1000, 40), (100, 40), (0, 40)),
                        seed=seed + 3),
        g.crash_schedule(day * 0.3, restart_after=tick),
    )


# -- the disruption control loop ---------------------------------------------
# BASELINE config #4's fleet reached through the control plane: pods that
# each need a 16-vCPU node of their own, then resized in place to config
# #4's one 500m / 1Gi pod a node, on two weighted pools (spot first,
# on-demand overflow) of the small sizes
DISRUPTION_NODES = 2000
DISRUPTION_REQUEST = {"cpu": "12", "memory": "8Gi"}
DISRUPTION_RESIZED = {"cpu": "500m", "memory": "1Gi"}
DISRUPTION_CPUS = ("2", "4", "8", "16")
DISRUPTION_STEP_S = 30.0       # FakeClock seconds before each wave-2 settle
# the pools' consolidateAfter: a node is a candidate once it is one step
# old, so the provisioning burst of wave 1 simulates nothing and every
# node is a candidate again after each step of wave 2
DISRUPTION_CONSOLIDATE_AFTER_S = DISRUPTION_STEP_S
DISRUPTION_MAX_ROUNDS = 400    # rounds one settle may take
DISRUPTION_MAX_SETTLES = 200   # settles wave 2 may take


@dataclass
class Package:
    """What `disruption_loop` builds a cluster from: a package's models
    module, its Environment constructor and its Options class."""
    M: object
    Environment: object
    Options: object


def port_package(device="cuda") -> Package:
    """The port's `Package`, its Environment's solver on `device`."""
    import functools

    from karpenter_tpu_torch import env as envmod
    from karpenter_tpu_torch import models
    from karpenter_tpu_torch.operator.options import Options
    return Package(M=models, Environment=functools.partial(
        envmod.Environment, device=device), Options=Options)


def disruption_pools(M, spot_cpu: int):
    """The loop's two NodePools from the models module `M`: `spot`
    (weight 100, capacity type spot, a cpu limit of `spot_cpu`) and
    `on-demand` (weight 10, capacity type on-demand, no limit), both of
    the small sizes (`DISRUPTION_CPUS`), WhenEmptyOrUnderutilized with
    consolidate_after `DISRUPTION_CONSOLIDATE_AFTER_S` and the default 10%
    budget."""
    wk = M.wellknown
    pools = []
    for name, weight, ct, limits in (
            ("spot", 100, wk.CAPACITY_TYPE_SPOT,
             M.Resources.limits({"cpu": spot_cpu})),
            ("on-demand", 10, wk.CAPACITY_TYPE_ON_DEMAND, None)):
        pools.append(M.NodePool(
            meta=M.ObjectMeta(name=name), weight=weight, limits=limits,
            requirements=M.Requirements(
                M.Requirement.make(wk.CAPACITY_TYPE_LABEL, "In", ct),
                M.Requirement.make(wk.INSTANCE_CPU_LABEL, "In",
                                   *DISRUPTION_CPUS)),
            disruption=M.Disruption(
                consolidate_after=DISRUPTION_CONSOLIDATE_AFTER_S)))
    return pools


def disruption_loop(n_pods: int = DISRUPTION_NODES, options=None,
                    device="cuda", catalog=None, pkg=None,
                    store_backend=None):
    """The disruption control loop's cluster, not yet reconciled: an
    `env.Environment` with the default NodeClass, the two pools of
    `disruption_pools` (the spot pool's cpu limit holds half the fleet's
    16-vCPU nodes) and `n_pods` pods of `DISRUPTION_REQUEST` (`d0`..,
    ReplicaSet-owned, so evictable).  `pkg` (a `Package`) names the
    package whose classes build it; by default the port's, its solver on
    `device`.  `options` defaults to Options(batch_idle_duration=0),
    `store_backend` to the Environment's own choice (the in-memory store
    unless `KARPENTER_TPU_STORE_BACKEND` names another); drive it with
    `DisruptionWaves`."""
    pkg = pkg or port_package(device)
    M = pkg.M
    options = options or pkg.Options(batch_idle_duration=0)
    env = pkg.Environment(catalog=catalog, options=options,
                          store_backend=store_backend)
    env.add_default_nodeclass()
    for pool in disruption_pools(M, 16 * (n_pods // 2)):
        env.cluster.nodepools.create(pool)
    for i in range(n_pods):
        env.cluster.pods.create(M.Pod(
            meta=M.ObjectMeta(name=f"d{i}"),
            requests=M.Resources.parse(DISRUPTION_REQUEST)))
    return env


# -- BASELINE config #6: the interruption queue's drain ---------------------
CONFIG6_MESSAGES = 15_000     # the reference harness's top tier
CONFIG6_TYPE = "m5.large"
CONFIG6_PRICE = 0.05


def build_config6(n_messages: int = CONFIG6_MESSAGES, device="cuda",
                  pkg=None):
    """Config #6's fleet and queue (module docstring), from `pkg`'s
    classes (a `Package`; the port's on `device` by default).  The claims
    carry no finalizer, so a deleted one leaves the store at once: the
    drain measures the interruption path, not termination."""
    pkg = pkg or port_package(device)
    M = pkg.M
    env = pkg.Environment()
    env.add_default_nodeclass()
    env.cluster.nodepools.create(M.NodePool(meta=M.ObjectMeta(
        name="default")))
    # the candidate class of the fake cloud's own module (either package)
    candidate = sys.modules[type(env.cloud).__module__].FleetCandidate
    zones = env.cloud.zones
    for i in range(n_messages):
        inst, _ = env.cloud.create_fleet(
            [candidate(CONFIG6_TYPE, zones[i % len(zones)],
                       ("spot", "on-demand")[i % 2], CONFIG6_PRICE)],
            tags={"karpenter.sh/managed-by": "default-cluster"})
        claim = M.NodeClaim(
            meta=M.ObjectMeta(name=f"c{i}", labels={
                M.wellknown.NODEPOOL_LABEL: "default"}),
            nodepool="default", node_class_ref="default",
            provider_id=inst.instance_id)
        claim.set_condition("Launched")
        env.cluster.nodeclaims.create(claim)
    for i, claim in enumerate(env.cluster.nodeclaims.list()):
        k = i % 4
        if k in (0, 1):
            env.cloud.interrupt_spot(claim.provider_id)
        elif k == 2:
            env.cloud.send_state_change(claim.provider_id, "stopping")
        else:
            env.cloud.send_rebalance_recommendation(claim.provider_id)
    return env


def names_digest(names) -> str:
    """sha256 of the sorted names as one JSON list."""
    return hashlib.sha256(json.dumps(sorted(names)).encode()).hexdigest()


def drain_config6(env) -> Dict[str, object]:
    """Drain config #6's queue with one interruption reconcile; what the
    benchmark reports (module docstring)."""
    before = {c.meta.name for c in env.cluster.nodeclaims.list()}
    n = len(env.cloud.interruption_queue)
    t0 = time.perf_counter()
    env.interruption.reconcile()
    secs = time.perf_counter() - t0
    left = {c.meta.name for c in env.cluster.nodeclaims.list(
        lambda c: not c.meta.deleting)}
    deleted = sorted(before - left)
    return {"messages": n, "drain_s": secs, "msgs_per_s": n / secs,
            "drained": not env.cloud.interruption_queue,
            "claims_deleted": len(deleted), "deleted": deleted,
            "names_digest": names_digest(deleted),
            "offerings_unavailable": len(env.unavailable._cache)}


class DisruptionWaves:
    """Drives a `disruption_loop` environment through its three waves,
    reading either package's objects by attribute only:

    1. provision: settle once (the pods' nodes launch and bind);
    2. right-size: every pod is resized in place to `DISRUPTION_RESIZED`,
       then the manager settles, the FakeClock stepped
       `DISRUPTION_STEP_S` before each settle, until a settle changes
       nothing;
    3. interruption: spot-interruption messages for a tenth of the spot
       nodes left (rounded up, the first by claim name), then one settle.

    Each wave returns `loop_answer` plus its disruption record
    (`disruption_record`)."""

    def __init__(self, env):
        self.env = env
        self._last_event = None
        self.last_events: list = []  # the last wave's events

    def _new_events(self):
        """The events recorded since the last call.  The store keeps the
        newest 2,500-5,000: the last event seen is found by identity, and
        every event after it (all of them when it has been dropped) is
        new."""
        evs = self.env.cluster.events
        start = 0
        for i in range(len(evs) - 1, -1, -1):
            if evs[i] is self._last_event:
                start = i + 1
                break
        if evs:
            self._last_event = evs[-1]
        return list(evs[start:])

    def settle(self, events: list) -> int:
        """`ControllerManager.run_until_idle`, a round at a time so that
        no event is lost to the store's bound; the rounds taken."""
        mgr = self.env.manager
        for r in range(DISRUPTION_MAX_ROUNDS):
            gen = self.env.cluster.generation
            mgr.run_once()
            events.extend(self._new_events())
            if self.env.cluster.generation == gen:
                return r + 1
        raise RuntimeError(
            f"controllers did not settle in {DISRUPTION_MAX_ROUNDS} rounds")

    def wave1(self):
        self._new_events()
        events: list = []
        rounds = [self.settle(events)]
        return self._answer(events, rounds)

    def wave2(self):
        self._new_events()
        parse = type(self.env.cluster.pods.list()[0].requests).parse
        for pod in self.env.cluster.pods.list():
            pod.requests = parse(DISRUPTION_RESIZED)
            self.env.cluster.pods.update(pod)
        events: list = []
        rounds = []
        while not rounds or rounds[-1] > 1:
            if len(rounds) == DISRUPTION_MAX_SETTLES:
                raise RuntimeError(
                    f"wave 2 changed the cluster in each of "
                    f"{DISRUPTION_MAX_SETTLES} settles")
            self.env.clock.step(DISRUPTION_STEP_S)
            rounds.append(self.settle(events))
        return self._answer(events, rounds)

    def wave3(self):
        self._new_events()
        spot = sorted(
            c.name for c in self.env.cluster.nodeclaims.list()
            if not c.meta.deleting and c.provider_id
            and (i := self.env.cloud.instances.get(c.provider_id))
            is not None and i.capacity_type == "spot")
        by_name = {c.name: c for c in self.env.cluster.nodeclaims.list()}
        for name in spot[:-(-len(spot) // 10)]:
            self.env.cloud.interrupt_spot(by_name[name].provider_id)
        events: list = []
        rounds = [self.settle(events)]
        return self._answer(events, rounds)

    def _answer(self, events, rounds):
        self.last_events = events
        out = dict(loop_answer(self.env.cluster, self.env.cloud,
                               sum(rounds)))
        out["disruption"] = disruption_record(self.env, events, rounds)
        return out


def disruption_record(env, events, rounds) -> Dict[str, object]:
    """A wave's disruption record, from its events and the fake cloud,
    attribute access only: the ordered Disrupted* events, each as (reason,
    candidate count, digest of the candidate names, the replacements'
    instance types); the Unconsolidatable and DisruptionBlocked events
    counted by reason code; the IEEE-hex sums of the retired and the
    added instances' catalog prices in event order; the rounds of each
    settle."""
    import ast
    import hashlib
    book = {(it.name, o.zone, o.capacity_type): o.price
            for it in env.cloud.describe_instance_types()
            for o in it.offerings}
    by_claim = {i.tags.get("karpenter.sh/nodeclaim"): i
                for i in env.cloud.instances.values()}

    def price(claim):
        i = by_claim.get(claim)
        return 0.0 if i is None else book[(i.instance_type, i.zone,
                                           i.capacity_type)]

    acts = []
    verdicts: Dict[str, int] = {}
    retired = added = 0.0
    for ev in events:
        _, _, obj, reason, message = ev[:5]
        if reason.startswith("Disrupted"):
            cands = obj.split(",")
            reps = []
            if message.startswith("replacements: ["):
                reps = ast.literal_eval(message[len("replacements: "):])
            acts.append((reason, len(cands), hashlib.sha256(
                ",".join(sorted(cands)).encode()).hexdigest()[:16],
                tuple(by_claim[r].instance_type if r in by_claim else None
                      for r in reps)))
            for c in cands:
                retired += price(c)
            for r in reps:
                added += price(r)
        elif reason in ("Unconsolidatable", "DisruptionBlocked"):
            code = message[1:message.index("]")] if message.startswith(
                "[") else message
            key = f"{reason}:{code}"
            verdicts[key] = verdicts.get(key, 0) + 1
    return {"acts": acts, "verdicts": dict(sorted(verdicts.items())),
            "retired": float(retired).hex(), "added": float(added).hex(),
            "settles": len(rounds), "rounds": list(rounds)}


# -- the observability substrate over a wave ---------------------------------
# ledger record fields that differ from run to run (wall clock, process,
# random trace ids); every other field is compared
LEDGER_NONDETERMINISTIC = ("ts", "pid", "trace_id")
# the ledger ring a loop's observation needs: every record of the widest
# wave (phase 19's wave 2 writes ~2,300)
LEDGER_RING = 100_000


@dataclass
class Observability:
    """A package's observability modules, for `WaveObserver`: its metrics
    registry (`utils.metrics`), decision ledger (`utils.ledger`),
    trajectory judges (`timeline.invariants`), flight recorder
    (`utils.flightrecorder`) and timeline recorder
    (`timeline.recorder`)."""
    metrics: object
    ledger: object
    invariants: object
    flightrecorder: object
    timeline: object

    def reset(self) -> None:
        """Empty the three process-global rings, as a fresh process has
        them (their sequence numbers restart at 1), the ledger's wide
        enough for a whole wave (`ledger.ensure_buffer`; an explicit
        KARPENTER_TPU_LEDGER_BUFFER wins)."""
        self.ledger.ensure_buffer(LEDGER_RING)
        self.ledger.LEDGER.reset()
        self.flightrecorder.RECORDER.reset()
        self.timeline.RECORDER.reset()


def port_observability() -> Observability:
    from karpenter_tpu_torch.timeline import invariants, recorder
    from karpenter_tpu_torch.utils import flightrecorder, ledger, metrics
    return Observability(metrics=metrics, ledger=ledger,
                         invariants=invariants,
                         flightrecorder=flightrecorder, timeline=recorder)


class WaveObserver:
    """What the decision ledger and the timeline recorded over one wave of
    a loop, read by attribute from either package's modules (`obs`, an
    `Observability`).  `start(cluster)` notes the counters, the ledger's
    newest row and the pods the workload has fed in; `finish(cluster)`
    returns:

    * `ledger`: the wave's records by source (`LEDGER_RECORDS`), the
      IEEE-hex sums of their savings and added spend (summed in record
      order, termination records excluded as `summarize` excludes them),
      and the sha256 of the records with `LEDGER_NONDETERMINISTIC`
      removed — the ring must hold the whole wave
      (`ledger.ensure_buffer`);
    * `timeline`: the wave's events by kind (`TIMELINE_EVENTS`: the ring
      is bounded, the counter is not);
    * `verdict`: the trajectory judges' booleans over the wave
      (`TrajectoryAuditor.report`): the ledger's hex-exact cost chain,
      the rows it checked, and no pod fed in before the wave lost."""

    def __init__(self, obs: Observability):
        self.obs = obs

    def start(self, cluster) -> None:
        from karpenter_tpu_torch.utils.telemetry import _series
        m = self.obs.metrics
        self._events0 = _series(m.TIMELINE_EVENTS)
        self._records0 = _series(m.LEDGER_RECORDS)
        self._seq0 = self.obs.ledger.LEDGER.last_seq() or 0
        self._expected = {p.meta.name for p in cluster.pods.list()}

    def records(self) -> List[dict]:
        """The ledger's records of this wave (the ring's rows after the
        newest one at `start`)."""
        led = self.obs.ledger.LEDGER
        return [r for r in led.tail(len(led)) if r["seq"] > self._seq0]

    def finish(self, cluster) -> Dict[str, object]:
        import hashlib
        import json

        from karpenter_tpu_torch.utils.telemetry import _series
        m = self.obs.metrics
        recs = self.records()

        def delta(now, then):
            return {k: v - then.get(k, 0) for k, v in sorted(now.items())
                    if v != then.get(k, 0)}
        by_source = delta(_series(m.LEDGER_RECORDS), self._records0)
        if sum(by_source.values()) != len(recs):
            raise RuntimeError(
                f"the ledger's ring holds {len(recs)} of the wave's "
                f"{sum(by_source.values())} records")
        savings = added = 0.0
        for r in recs:
            if r["source"] == "termination":
                continue
            if r["cost_delta"] < 0:
                savings += -r["cost_delta"]
            else:
                added += r["cost_delta"]
        stripped = [{k: v for k, v in r.items()
                     if k not in LEDGER_NONDETERMINISTIC} for r in recs]
        auditor = self.obs.invariants.TrajectoryAuditor()
        auditor.expected_pods = set(self._expected)
        rep = auditor.report(cluster, recs, {})
        verdict = {k: rep[k] for k in (
            "ledger_hex_exact", "ledger_rows_checked", "zero_lost_pods",
            "zero_gang_atomicity_violations", "zero_priority_inversions",
            "audit_clean")}
        return {
            "ledger": {"records": by_source,
                       "savings": float(savings).hex(),
                       "added": float(added).hex(),
                       "digest": hashlib.sha256(json.dumps(
                           stripped, sort_keys=True,
                           default=str).encode()).hexdigest()[:16]},
            "timeline": delta(_series(m.TIMELINE_EVENTS), self._events0),
            "verdict": verdict}
