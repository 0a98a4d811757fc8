"""Reconcilers (reference: sigs.k8s.io/karpenter/pkg/controllers).

The port's provisioning control loop: the provisioner (pending pods →
solve → NodeClaims), the NodeClaim lifecycle (launch, register,
initialize), the fake kubelet, the pod binder and the deterministic
controller manager.  Disruption, termination, expiration, garbage
collection, interruption, preemption, the nodeclass and tagging
controllers and the refresh controllers are still to port (slice 5b)."""

from karpenter_tpu_torch.controllers.manager import ControllerManager
from karpenter_tpu_torch.controllers.provisioning import Provisioner
from karpenter_tpu_torch.controllers.lifecycle import NodeClaimLifecycle
from karpenter_tpu_torch.controllers.kubelet import FakeKubelet
from karpenter_tpu_torch.controllers.binder import PodBinder

__all__ = [
    "ControllerManager",
    "Provisioner",
    "NodeClaimLifecycle",
    "FakeKubelet",
    "PodBinder",
]
