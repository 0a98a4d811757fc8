"""NodeClaim lifecycle: Launch → Register → Initialize (+ liveness GC).

Mirrors the core node-lifecycle controller (SURVEY §2.2: metrics
karpenter_nodeclaims_{launched,registered,initialized}; liveness: claims
never registered within 15 min are garbage-collected —
designs/limits.md:23-25).
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.cloudprovider import (
    CloudProviderError,
    InsufficientCapacity,
    NodeClassNotReady,
    TPUCloudProvider,
)
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import (
    COND_INITIALIZED,
    COND_LAUNCHED,
    COND_REGISTERED,
    NodeClaim,
)
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.utils import errors, metrics, tracing
from karpenter_tpu_torch.utils.clock import Clock


class NodeClaimLifecycle:
    name = "nodeclaim.lifecycle"

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider: TPUCloudProvider,
        options: Optional[Options] = None,
        clock: Optional[Clock] = None,
    ):
        self.cluster = cluster
        self.cp = cloud_provider
        self.options = options or Options()
        self.clock = clock or cluster.clock

    def reconcile(self) -> None:
        # one trace per lifecycle pass: Launched/LaunchRetryable/
        # Registered events stamp the pass's trace id (same
        # cross-referencing contract as provisioning.pass)
        with tracing.span("lifecycle.pass"):
            for claim in self.cluster.nodeclaims.list():
                if claim.meta.deleting:
                    continue
                if not claim.is_(COND_LAUNCHED):
                    self._launch(claim)
                elif not claim.is_(COND_REGISTERED):
                    self._register(claim)
                elif not claim.is_(COND_INITIALIZED):
                    self._initialize(claim)

    # -- launch -----------------------------------------------------------
    def _launch(self, claim: NodeClaim) -> None:
        try:
            self.cp.create(claim)
            self.cluster.nodeclaims.update(claim)
            metrics.NODECLAIMS_LAUNCHED.inc(nodepool=claim.nodepool)
            self.cluster.record_event(
                "NodeClaim", claim.name, "Launched",
                f"instance {claim.provider_id}")
        except InsufficientCapacity as e:
            self.cluster.record_event(
                "NodeClaim", claim.name, "LaunchRetryable", str(e))
            # the failed attempt fed ICE pools into the unavailable-offerings
            # cache, so the next attempt sees different candidates — surface
            # that external-state progress as a cluster mutation so the
            # fixed-point manager keeps reconciling (the reference gets this
            # for free from workqueue requeues)
            self.cluster.mutated()
        except NodeClassNotReady as e:
            # waits on external readiness; nothing to retry until it changes
            self.cluster.record_event(
                "NodeClaim", claim.name, "LaunchRetryable", str(e))
        except CloudProviderError as e:
            # terminal for this claim: remove it; nominated pods re-enter the
            # provisioning queue once the nomination is cleared by the binder
            self.cluster.record_event(
                "NodeClaim", claim.name, "LaunchFailed", str(e))
            self.cluster.nodeclaims.remove_finalizer(
                claim.name, wellknown.TERMINATION_FINALIZER)
            self.cluster.nodeclaims.delete(claim.name)
        except Exception as e:  # noqa: BLE001 — raw cloud API errors
            if not errors.is_retryable(e):
                raise
            # cloud unreachable: keep the claim, retry next reconcile
            # (SURVEY §5 failure detection — launch failure must never
            # crash the control loop)
            self.cluster.record_event(
                "NodeClaim", claim.name, "LaunchRetryable", str(e))

    # -- register ---------------------------------------------------------
    def _register(self, claim: NodeClaim) -> None:
        node = self.cluster.node_for_claim(claim)
        if node is None:
            self._liveness_gc(claim)
            return
        claim.node_name = node.name
        claim.set_condition(COND_REGISTERED)
        metrics.NODECLAIMS_REGISTERED.inc(nodepool=claim.nodepool)
        node.meta.labels[wellknown.REGISTERED_LABEL] = "true"
        # strip the unregistered taint the node joined with
        node.taints = [
            t for t in node.taints
            if t.key != wellknown.UNREGISTERED_TAINT_KEY
        ]
        self.cluster.nodes.update(node)
        self.cluster.nodeclaims.update(claim)

    def _liveness_gc(self, claim: NodeClaim) -> None:
        """Never-registered claims are reclaimed after registration_ttl
        (designs/limits.md:23-25)."""
        if claim.launch_time is None:
            return
        if self.clock.now() - claim.launch_time < self.options.registration_ttl:
            return
        self.cluster.record_event(
            "NodeClaim", claim.name, "RegistrationTimeout",
            "node never joined; reclaiming instance")
        self.cp.delete(claim)
        self.cluster.nodeclaims.remove_finalizer(
            claim.name, wellknown.TERMINATION_FINALIZER)
        self.cluster.nodeclaims.delete(claim.name)

    # -- initialize -------------------------------------------------------
    def _initialize(self, claim: NodeClaim) -> None:
        node = self.cluster.node_for_claim(claim)
        if node is None or not node.ready:
            return
        # startup taints must have been removed and capacity reported
        startup_keys = {t.key for t in claim.startup_taints}
        if any(t.key in startup_keys for t in node.taints):
            return
        if node.allocatable.is_zero():
            return
        claim.set_condition(COND_INITIALIZED)
        metrics.NODECLAIMS_INITIALIZED.inc(nodepool=claim.nodepool)
        node.meta.labels[wellknown.INITIALIZED_LABEL] = "true"
        self.cluster.nodes.update(node)
        self.cluster.nodeclaims.update(claim)
