"""Scheduling inputs the port is measured on.

`build_input(n)` is the headline workload (the JAX package's
`bench.py build_input`): `n` pods in 8 size classes, one of them asking for
an `nvidia.com/gpu`, one NodePool with no limits, no existing nodes and no
topology, against the 605-type generated catalog.
"""

from __future__ import annotations

from karpenter_tpu_torch.models import NodePool, ObjectMeta, Pod, Resources
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
