"""Scheduling inputs the port is measured on.

`build_input(n)` is the headline workload (the JAX package's
`bench.py build_input`): `n` pods in 8 size classes, one of them asking for
an `nvidia.com/gpu`, one NodePool with no limits, no existing nodes and no
topology, against the 605-type generated catalog.

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
"""

from __future__ import annotations

from typing import List

from karpenter_tpu_torch.models import (
    Node,
    NodePool,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    Resources,
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
