"""v1beta1 compatibility API + conversion.

The reference ships a v1beta1 API family and a conversion webhook so
pre-v1 manifests keep working during migration
(pkg/apis/v1beta1, pkg/webhooks/webhooks.go:1-57,
pkg/apis/v1/ec2nodeclass_conversion.go). Our control plane is
in-process, so the conversion seam is at object ADMISSION instead of an
apiserver webhook: `admit()` accepts either API version and hands the
stores v1 objects.

The shape differences mirrored here are the reference's real v1beta1→v1
moves:

- NodePool: `expireAfter` lived under spec.disruption in v1beta1 and
  moved to the node template in v1; consolidationPolicy
  `WhenUnderutilized` was renamed `WhenEmptyOrUnderutilized`.
- Kubelet configuration lived on the NodePool's node TEMPLATE in
  v1beta1 and moved to the provider NodeClass in v1 (the reference
  carries it across via a compatibility annotation during conversion).
- NodeClass: selector terms were `amiSelectorTerms`/`amiFamily`
  spellings (image* in v1), and metadata options defaulted to optional
  tokens (required in v1).

Round-tripping is lossless for everything expressible in both versions;
`to_v1`/`from_v1` are inverses on that subset (tests/test_v1beta1.py,
tests/test_torch_v1beta1.py).

The port's copy of `karpenter_tpu/models/v1beta1.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.models.objects import (
    CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED,
    CONSOLIDATE_WHEN_UNDERUTILIZED,
    Budget,
    Disruption,
    KubeletConfiguration,
    MetadataOptions,
    NodeClass,
    NodePool,
    ObjectMeta,
    SelectorTerm,
    Taint,
)
from karpenter_tpu_torch.models.requirements import Requirements
from karpenter_tpu_torch.models.resources import Resources

# annotation carrying a v1beta1 pool-level kubelet config through v1
# objects (role of the reference's
# compatibility.karpenter.k8s.aws/v1beta1-kubelet-conversion annotation)
KUBELET_COMPAT_ANNOTATION = "compatibility.karpenter.tpu/v1beta1-kubelet"


@dataclass
class V1Beta1Disruption:
    consolidation_policy: str = CONSOLIDATE_WHEN_UNDERUTILIZED
    consolidate_after: float = 0.0
    expire_after: Optional[float] = None  # v1beta1: lives HERE
    budgets: List[Budget] = field(default_factory=lambda: [Budget(nodes="10%")])


@dataclass
class V1Beta1NodePool:
    """The old NodePool shape: expireAfter under disruption, kubelet on
    the node template."""
    meta: ObjectMeta
    node_class_ref: str = "default"
    requirements: Requirements = field(default_factory=Requirements)
    taints: List[Taint] = field(default_factory=list)
    startup_taints: List[Taint] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    kubelet: Optional[KubeletConfiguration] = None  # template-level in v1beta1
    disruption: V1Beta1Disruption = field(default_factory=V1Beta1Disruption)
    limits: Optional["Resources"] = None
    weight: int = 0


@dataclass
class V1Beta1NodeClass:
    """The old NodeClass shape: ami* spellings, optional metadata tokens."""
    meta: ObjectMeta
    ami_family: str = "cos"
    ami_selector_terms: Optional[List[SelectorTerm]] = None
    subnet_selector_terms: Optional[List[SelectorTerm]] = None
    security_group_selector_terms: Optional[List[SelectorTerm]] = None
    role: str = "default-node-role"
    user_data: str = ""
    block_device_gib: int = 100
    metadata_http_tokens: str = "optional"  # v1 default: required
    tags: Dict[str, str] = field(default_factory=dict)


def _policy_to_v1(policy: str) -> str:
    if policy == CONSOLIDATE_WHEN_UNDERUTILIZED:
        return CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED
    return policy


def _policy_from_v1(policy: str) -> str:
    if policy == CONSOLIDATE_WHEN_EMPTY_OR_UNDERUTILIZED:
        return CONSOLIDATE_WHEN_UNDERUTILIZED
    return policy


def _dump_kubelet(k: KubeletConfiguration) -> str:
    import dataclasses
    import json
    return json.dumps(dataclasses.asdict(k), sort_keys=True)


def _load_kubelet(raw: str) -> Optional[KubeletConfiguration]:
    import json
    try:
        return KubeletConfiguration(**json.loads(raw))
    except (ValueError, TypeError):
        return None


def nodepool_to_v1(b: V1Beta1NodePool) -> NodePool:
    """expireAfter moves disruption→template; the template kubelet rides
    a compatibility annotation as NAMED fields (parsed back by
    nodepool_from_v1 and by the NodeClass attach at admission — the
    round trip is lossless). Object-metadata annotations and template
    annotations stay separate dicts; the compat key lives on the object
    metadata, like the reference's conversion annotation."""
    meta_ann = dict(b.meta.annotations)
    if b.kubelet is not None:
        meta_ann[KUBELET_COMPAT_ANNOTATION] = _dump_kubelet(b.kubelet)
    return NodePool(
        meta=replace(b.meta, annotations=meta_ann),
        node_class_ref=b.node_class_ref,
        requirements=b.requirements,
        taints=list(b.taints),
        startup_taints=list(b.startup_taints),
        labels=dict(b.labels),
        annotations=dict(b.annotations),
        expire_after=b.disruption.expire_after,
        disruption=Disruption(
            consolidation_policy=_policy_to_v1(
                b.disruption.consolidation_policy),
            consolidate_after=b.disruption.consolidate_after,
            budgets=list(b.disruption.budgets)),
        limits=b.limits,
        weight=b.weight,
    )


def nodepool_from_v1(p: NodePool,
                     kubelet: Optional[KubeletConfiguration] = None,
                     ) -> V1Beta1NodePool:
    if kubelet is None:
        raw = p.meta.annotations.get(KUBELET_COMPAT_ANNOTATION)
        if raw is not None:
            kubelet = _load_kubelet(raw)
    meta_ann = {k: v for k, v in p.meta.annotations.items()
                if k != KUBELET_COMPAT_ANNOTATION}
    return V1Beta1NodePool(
        meta=replace(p.meta, annotations=meta_ann),
        node_class_ref=p.node_class_ref,
        requirements=p.requirements,
        taints=list(p.taints),
        startup_taints=list(p.startup_taints),
        labels=dict(p.labels),
        annotations=dict(p.annotations),
        kubelet=kubelet,
        disruption=V1Beta1Disruption(
            consolidation_policy=_policy_from_v1(
                p.disruption.consolidation_policy),
            consolidate_after=p.disruption.consolidate_after,
            expire_after=p.expire_after,
            budgets=list(p.disruption.budgets)),
        limits=p.limits,
        weight=p.weight,
    )


def nodeclass_to_v1(b: V1Beta1NodeClass,
                    kubelet: Optional[KubeletConfiguration] = None,
                    ) -> NodeClass:
    """ami* → image*; optional metadata tokens survive explicitly (the
    v1 default hardened to required, so conversion must pin the old
    behavior rather than silently change launches)."""
    return NodeClass(
        meta=b.meta,
        image_family=b.ami_family,
        image_selector_terms=b.ami_selector_terms,
        subnet_selector_terms=b.subnet_selector_terms,
        security_group_selector_terms=b.security_group_selector_terms,
        role=b.role,
        user_data=b.user_data,
        block_device_gib=b.block_device_gib,
        metadata_options=MetadataOptions(http_tokens=b.metadata_http_tokens),
        kubelet=kubelet,
        tags=dict(b.tags),
    )


def nodeclass_from_v1(nc: NodeClass) -> V1Beta1NodeClass:
    return V1Beta1NodeClass(
        meta=nc.meta,
        ami_family=nc.image_family,
        ami_selector_terms=nc.image_selector_terms,
        subnet_selector_terms=nc.subnet_selector_terms,
        security_group_selector_terms=nc.security_group_selector_terms,
        role=nc.role,
        user_data=nc.user_data,
        block_device_gib=nc.block_device_gib,
        metadata_http_tokens=(nc.metadata_options.http_tokens
                              if nc.metadata_options else "required"),
        tags=dict(nc.tags),
    )


def _attach_pending_kubelet(cluster, nc: NodeClass) -> None:
    """Apply any admitted pool's compat-annotation kubelet to this class
    — admission order (pool-then-class or class-then-pool) must not
    matter, exactly as kubectl-apply ordering doesn't. An explicit v1
    kubelet on the class wins over the converted template config.

    LIMITATION (intentional, observable): v1 hangs kubelet config on the
    NodeClass, so several v1beta1 pools sharing one class flatten to ONE
    config — the first attached wins, and any DIFFERING later config
    raises a `KubeletConversionConflict` event telling the operator to
    split the class (the reference's v1 migration guide gives the same
    instruction for per-pool kubelet divergence)."""
    pending = []
    for pool in cluster.nodepools.list():
        if pool.node_class_ref != nc.name:
            continue
        raw = pool.meta.annotations.get(KUBELET_COMPAT_ANNOTATION)
        if raw is None:
            continue
        kub = _load_kubelet(raw)
        if kub is not None:
            pending.append((pool.name, kub))
    for pool_name, kub in pending:
        if nc.kubelet is None:
            nc.kubelet = kub
            cluster.nodeclasses.update(nc)
        elif nc.kubelet != kub:
            cluster.record_event(
                "NodeClass", nc.name, "KubeletConversionConflict",
                f"pool {pool_name}'s v1beta1 kubelet config differs from "
                f"the one already on this class; split the NodeClass to "
                f"keep per-pool kubelet settings")


def admit(cluster, obj) -> object:
    """The conversion-webhook seam for an in-process store: accepts
    either API version, converts v1beta1 to v1, and creates the v1
    object(s). A v1beta1 pool's template kubelet is applied to its
    referenced NodeClass regardless of which object is admitted first
    (the reference's conversion carries it the same direction)."""
    if isinstance(obj, V1Beta1NodePool):
        obj = nodepool_to_v1(obj)
        # falls through to the NodePool branch: a converted pool and a
        # pre-converted v1 pool carrying the compat annotation behave
        # identically regardless of admission order
    if isinstance(obj, V1Beta1NodeClass):
        nc = cluster.nodeclasses.create(nodeclass_to_v1(obj))
        _attach_pending_kubelet(cluster, nc)
        return nc
    if isinstance(obj, NodePool):
        out = cluster.nodepools.create(obj)
        if KUBELET_COMPAT_ANNOTATION in obj.meta.annotations:
            nc = cluster.nodeclasses.get(obj.node_class_ref)
            if nc is not None:
                _attach_pending_kubelet(cluster, nc)
        return out
    if isinstance(obj, NodeClass):
        nc = cluster.nodeclasses.create(obj)
        _attach_pending_kubelet(cluster, nc)
        return nc
    raise TypeError(f"unadmittable object {type(obj).__name__}")
