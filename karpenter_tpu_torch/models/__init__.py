"""Data model: the CRD-shaped objects and the constraint algebra.

Mirrors the API surface of the reference's NodePool / NodeClaim CRDs
(reference: pkg/apis/crds/karpenter.sh_nodepools.yaml,
karpenter.sh_nodeclaims.yaml) and the EC2NodeClass provider CRD
(reference: pkg/apis/v1/ec2nodeclass.go) — re-shaped as plain Python
dataclasses since our control plane is in-process rather than etcd-backed.
"""

from karpenter_tpu_torch.models.resources import (
    Resources,
    parse_quantity,
    format_quantity,
    RESOURCE_AXIS,
)
from karpenter_tpu_torch.models.requirements import Requirement, Requirements, Operator
from karpenter_tpu_torch.models.taints import Taint, Toleration
from karpenter_tpu_torch.models.objects import (
    ObjectMeta,
    Pod,
    Node,
    NodeClaim,
    NodePool,
    BlockDevice,
    BlockDeviceMapping,
    KubeletConfiguration,
    MetadataOptions,
    NodeClass,
    InstanceType,
    Offering,
    TopologySpreadConstraint,
    PodAffinityTerm,
    VolumeClaim,
    Disruption,
    Budget,
)
from karpenter_tpu_torch.models import wellknown

__all__ = [
    "Resources",
    "parse_quantity",
    "format_quantity",
    "RESOURCE_AXIS",
    "Requirement",
    "Requirements",
    "Operator",
    "Taint",
    "Toleration",
    "ObjectMeta",
    "Pod",
    "Node",
    "NodeClaim",
    "NodePool",
    "BlockDevice",
    "BlockDeviceMapping",
    "KubeletConfiguration",
    "MetadataOptions",
    "NodeClass",
    "InstanceType",
    "Offering",
    "TopologySpreadConstraint",
    "PodAffinityTerm",
    "VolumeClaim",
    "Disruption",
    "Budget",
    "wellknown",
]
