"""Reconcilers (reference: sigs.k8s.io/karpenter/pkg/controllers — the core
set — plus the provider controllers of pkg/controllers).

The port's copies of every controller of the reference: the provisioner,
the NodeClaim lifecycle, the fake kubelet, the pod binder and the
deterministic manager; disruption (drift, emptiness, multi- and
single-node consolidation), termination, expiration, garbage collection,
interruption, preemption, the nodeclass controllers (hash, status,
termination), tagging and the refresh controllers.  The calls into the
decision ledger (`utils/ledger.py`) and the timeline (`timeline/`) are
left out until slice 6 ports them; each is marked where it was."""

from karpenter_tpu_torch.controllers.manager import ControllerManager
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.controllers.lifecycle import NodeClaimLifecycle
from karpenter_tpu_torch.controllers.kubelet import FakeKubelet
from karpenter_tpu_torch.controllers.binder import PodBinder
from karpenter_tpu_torch.controllers.termination import Termination
from karpenter_tpu_torch.controllers.interruption import Interruption
from karpenter_tpu_torch.controllers.preemption import Preemption
from karpenter_tpu_torch.controllers.gc import GarbageCollection
from karpenter_tpu_torch.controllers.expiration import Expiration
from karpenter_tpu_torch.controllers.disruption import Disruption
from karpenter_tpu_torch.controllers.nodeclass import (
    NodeClassHash,
    NodeClassStatus,
    NodeClassTermination,
)
from karpenter_tpu_torch.controllers.tagging import NodeClaimTagging
from karpenter_tpu_torch.controllers.refresh import (
    InstanceTypeRefresh,
    PricingRefresh,
)

__all__ = [
    "ControllerManager",
    "Provisioner",
    "NodeClaimLifecycle",
    "FakeKubelet",
    "PodBinder",
    "Termination",
    "Interruption",
    "Preemption",
    "GarbageCollection",
    "Expiration",
    "Disruption",
    "NodeClassHash",
    "NodeClassStatus",
    "NodeClassTermination",
    "NodeClaimTagging",
    "InstanceTypeRefresh",
    "PricingRefresh",
]
