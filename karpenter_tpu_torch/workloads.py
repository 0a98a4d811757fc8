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
"""

from __future__ import annotations

from karpenter_tpu_torch.models import (
    NodePool,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    Resources,
    TopologySpreadConstraint,
    wellknown,
)
from karpenter_tpu_torch.providers import generate_catalog
from karpenter_tpu_torch.scheduling import ScheduleInput

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
