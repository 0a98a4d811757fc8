"""Well-known labels, annotations, and taint keys.

Core `karpenter.sh/*` names mirror sigs.k8s.io/karpenter (these names are the
observable API contract — see pkg/apis/crds/*.yaml and
website/content/en/preview/reference/). Provider-scoped names use
`karpenter.tpu/*` where the reference uses `karpenter.k8s.aws/*`
(pkg/apis/v1/labels.go).
"""

# -- core labels ---------------------------------------------------------
NODEPOOL_LABEL = "karpenter.sh/nodepool"
CAPACITY_TYPE_LABEL = "karpenter.sh/capacity-type"
INITIALIZED_LABEL = "karpenter.sh/initialized"
REGISTERED_LABEL = "karpenter.sh/registered"

CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# -- kubernetes well-known labels ---------------------------------------
ARCH_LABEL = "kubernetes.io/arch"
OS_LABEL = "kubernetes.io/os"
HOSTNAME_LABEL = "kubernetes.io/hostname"
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
ZONE_LABEL = "topology.kubernetes.io/zone"
REGION_LABEL = "topology.kubernetes.io/region"

ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"
OS_LINUX = "linux"

# -- provider labels (reference: karpenter.k8s.aws/* — pkg/apis/v1/labels.go)
INSTANCE_CATEGORY_LABEL = "karpenter.tpu/instance-category"
INSTANCE_FAMILY_LABEL = "karpenter.tpu/instance-family"
INSTANCE_GENERATION_LABEL = "karpenter.tpu/instance-generation"
INSTANCE_SIZE_LABEL = "karpenter.tpu/instance-size"
INSTANCE_CPU_LABEL = "karpenter.tpu/instance-cpu"
INSTANCE_MEMORY_LABEL = "karpenter.tpu/instance-memory"  # MiB
INSTANCE_GPU_COUNT_LABEL = "karpenter.tpu/instance-gpu-count"
INSTANCE_GPU_NAME_LABEL = "karpenter.tpu/instance-gpu-name"
INSTANCE_NETWORK_BANDWIDTH_LABEL = "karpenter.tpu/instance-network-bandwidth"
INSTANCE_LOCAL_NVME_LABEL = "karpenter.tpu/instance-local-nvme"
NODECLASS_LABEL = "karpenter.tpu/nodeclass"

# -- taints --------------------------------------------------------------
DISRUPTED_TAINT_KEY = "karpenter.sh/disrupted"
DISRUPTION_TAINT_KEY = "karpenter.sh/disruption"   # value "disrupting"
UNREGISTERED_TAINT_KEY = "karpenter.sh/unregistered"

# -- annotations ---------------------------------------------------------
DO_NOT_DISRUPT_ANNOTATION = "karpenter.sh/do-not-disrupt"
POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"
NODEPOOL_HASH_ANNOTATION = "karpenter.sh/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION = "karpenter.sh/nodepool-hash-version"
NODECLASS_HASH_ANNOTATION = "karpenter.tpu/nodeclass-hash"
NODECLASS_HASH_VERSION_ANNOTATION = "karpenter.tpu/nodeclass-hash-version"
# gang scheduling: tightly-coupled multi-host workloads
# declare all-or-nothing, rank-adjacent placement via pod annotations.
# gang-name groups the members, gang-size declares the expected member
# count (a gang with fewer pending members than declared is incomplete
# and strands whole), gang-topology names the adjacency domain the
# members must share: "slice" (the zone axis — a TPU multi-host slice),
# "rack" (the capacity-type axis doubling as the rack domain when the
# catalog encodes racks that way), or "none" (atomic, no adjacency).
GANG_NAME_ANNOTATION = "karpenter.tpu/gang-name"
GANG_SIZE_ANNOTATION = "karpenter.tpu/gang-size"
GANG_TOPOLOGY_ANNOTATION = "karpenter.tpu/gang-topology-domain"
# priority & preemption: an integer priority override that
# outranks both priorityClassName and the spec `priority` field —
# scheduling packs strict priority bands high-to-low, and the
# preemption planner may evict strictly-lower-priority pods to seat a
# stranded higher-priority one.  Parsed by scheduling.types.priority_of
# (the ONE grammar owner); malformed values degrade to the next source.
PRIORITY_ANNOTATION = "karpenter.tpu/priority"
# stamped on planned preemption victims by the provisioner (value: the
# plan id); the preemption controller drains annotated victims
# atomically per plan through the termination-style eviction path
PREEMPT_PLAN_ANNOTATION = "karpenter.tpu/preempt-plan"
PREEMPT_FOR_ANNOTATION = "karpenter.tpu/preempted-for"

# -- finalizers ----------------------------------------------------------
TERMINATION_FINALIZER = "karpenter.sh/termination"
NODECLASS_TERMINATION_FINALIZER = "karpenter.tpu/termination"

# Labels the scheduler knows how to derive from instance types / offerings,
# so a pod/NodePool may require them even when a template doesn't list them
# (reference: scheduling.WellKnownLabels allowUndefined behavior).
WELL_KNOWN_LABELS = frozenset({
    NODEPOOL_LABEL,
    CAPACITY_TYPE_LABEL,
    ARCH_LABEL,
    OS_LABEL,
    HOSTNAME_LABEL,
    INSTANCE_TYPE_LABEL,
    ZONE_LABEL,
    REGION_LABEL,
    INSTANCE_CATEGORY_LABEL,
    INSTANCE_FAMILY_LABEL,
    INSTANCE_GENERATION_LABEL,
    INSTANCE_SIZE_LABEL,
    INSTANCE_CPU_LABEL,
    INSTANCE_MEMORY_LABEL,
    INSTANCE_GPU_COUNT_LABEL,
    INSTANCE_GPU_NAME_LABEL,
    INSTANCE_NETWORK_BANDWIDTH_LABEL,
    INSTANCE_LOCAL_NVME_LABEL,
    NODECLASS_LABEL,
})

# Restricted: users may not set these directly on NodePool templates.
RESTRICTED_LABELS = frozenset({
    HOSTNAME_LABEL,
})
