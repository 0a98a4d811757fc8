"""Environment — the DI container wiring clock, fake cloud, providers,
cloud provider, cluster, and controllers (reference:
pkg/test/environment.go — "wires all real providers against fake AWS APIs";
also the shape of pkg/operator.NewOperator's provider construction).

The port's copy of `karpenter_tpu/env.py`, with the reference's
construction order and controller order.  One argument is the port's
own: `device` ("cuda", the card, by default; "cpu" runs the kernels'
plain versions) is the device of the shared `GatedSolver`'s
`TorchSolver`.
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.controllers import (
    ControllerManager,
    Disruption,
    Expiration,
    FakeKubelet,
    GarbageCollection,
    InstanceTypeRefresh,
    Interruption,
    Preemption,
    NodeClaimLifecycle,
    NodeClaimTagging,
    NodeClassHash,
    NodeClassStatus,
    NodeClassTermination,
    PodBinder,
    PricingRefresh,
    Provisioner,
    Termination,
)
from karpenter_tpu_torch.models.objects import InstanceType, NodeClass, ObjectMeta
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.providers.catalog import CatalogSpec
from karpenter_tpu_torch.providers.fake_cloud import FakeCloud
from karpenter_tpu_torch.providers.imagefamily import ImageProvider
from karpenter_tpu_torch.providers.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.providers.instanceprofile import InstanceProfileProvider
from karpenter_tpu_torch.providers.launchtemplate import LaunchTemplateProvider
from karpenter_tpu_torch.providers.pricing import PricingProvider
from karpenter_tpu_torch.providers.queue import QueueProvider
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.providers.version import VersionProvider
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.cache import UnavailableOfferings
from karpenter_tpu_torch.utils.clock import Clock, FakeClock


def _close_store(backend, daemon, sockdir) -> None:
    """Module-level so the Environment finalizer holds no self-reference
    (a bound method would keep the environment alive forever)."""
    try:
        backend.close()
    finally:
        daemon.close()
    if sockdir is not None:
        import shutil
        shutil.rmtree(sockdir, ignore_errors=True)


class Environment:
    def __init__(
        self,
        clock: Optional[Clock] = None,
        catalog: Optional[List[InstanceType]] = None,
        options: Optional[Options] = None,
        catalog_spec: Optional[CatalogSpec] = None,
        cloud=None,
        store_backend=None,
        device="cuda",
    ):
        self.clock = clock or FakeClock()
        self.options = options or Options()
        # the cluster-store seam (store/__init__.py): explicit backend >
        # KARPENTER_TPU_STORE_BACKEND=remote (per-environment daemon, the
        # whole suite then runs against the external store) > in-memory
        self.store_daemon = None
        self._store_finalizer = None
        if store_backend is None:
            import os
            if os.environ.get("KARPENTER_TPU_STORE_BACKEND") == "remote":
                import tempfile
                import weakref
                from karpenter_tpu_torch.store import (
                    RemoteBackend,
                    StoreDaemon,
                )
                sockdir = tempfile.mkdtemp(prefix="kt_store_")
                self.store_daemon = StoreDaemon(
                    os.path.join(sockdir, "store.sock"))
                store_backend = RemoteBackend(self.store_daemon.path)
                # environments are created by the hundred in fixtures with
                # no teardown hook; a GC-driven finalizer keeps a
                # full-suite remote-store run from accumulating daemon
                # threads, sockets, and tmp dirs
                self._store_finalizer = weakref.finalize(
                    self, _close_store, store_backend, self.store_daemon,
                    sockdir)
            elif os.environ.get("KARPENTER_TPU_STORE_BACKEND") == "http":
                # the kube-protocol backend against the in-repo fake
                # apiserver — the whole suite then exercises REST
                # list/watch JSON as its cluster store
                import weakref
                from karpenter_tpu_torch.store import (
                    FakeApiServer,
                    HttpBackend,
                )
                self.store_daemon = FakeApiServer()
                store_backend = HttpBackend(self.store_daemon.url)
                self._store_finalizer = weakref.finalize(
                    self, _close_store, store_backend, self.store_daemon,
                    None)
        self.store_backend = store_backend
        # the cloud session is injectable (operator.go:105-116 resolves the
        # AWS session the same way); default is the in-memory fake, the only
        # cloud in this environment — a real TPU-pool/GCE session plugs in
        # here without touching the wiring below
        self.cloud = cloud if cloud is not None else FakeCloud(
            catalog=catalog, clock=self.clock, spec=catalog_spec)
        self.pricing = PricingProvider(self.cloud)
        self.unavailable = UnavailableOfferings(clock=self.clock)
        self.instance_types = InstanceTypeProvider(
            self.cloud, self.pricing, self.unavailable, clock=self.clock)
        self.cluster = Cluster(clock=self.clock, backend=self.store_backend)
        # cloud plumbing providers (operator.go:140-182 construction order)
        cluster_name = self.options.cluster_name
        # the fake cloud seeds its defaults under "default-cluster"
        self.versions = VersionProvider(self.cloud, clock=self.clock)
        self.subnets = SubnetProvider(
            self.cloud, cluster_name="default-cluster", clock=self.clock)
        self.security_groups = SecurityGroupProvider(
            self.cloud, cluster_name="default-cluster", clock=self.clock)
        self.images = ImageProvider(
            self.cloud, self.versions, cluster_name=cluster_name,
            clock=self.clock)
        self.launch_templates = LaunchTemplateProvider(
            self.cloud, self.images, self.security_groups,
            cluster_name=cluster_name, clock=self.clock)
        self.instance_profiles = InstanceProfileProvider(
            self.cloud, cluster_name=cluster_name)
        self.queue = QueueProvider(self.cloud)
        self.cloud_provider = metrics.DecoratedCloudProvider(TPUCloudProvider(
            cloud=self.cloud,
            instance_types=self.instance_types,
            unavailable=self.unavailable,
            node_classes=self.cluster.nodeclasses,
            cluster_name=cluster_name,
            subnets=self.subnets,
            launch_templates=self.launch_templates,
            security_groups=self.security_groups,
            images=self.images,
        ))
        # one GatedSolver shared by both hot paths so they share the device
        # catalog cache and compiled-program cache
        from karpenter_tpu_torch.controllers.state import GatedSolver
        self.solver = GatedSolver(self.options, self.cluster, device=device)
        self.provisioner = Provisioner(
            self.cluster, self.cloud_provider, self.options, self.clock,
            solver=self.solver)
        self.lifecycle = NodeClaimLifecycle(
            self.cluster, self.cloud_provider, self.options, self.clock)
        self.kubelet = FakeKubelet(self.cluster, self.cloud_provider)
        self.binder = PodBinder(self.cluster)
        self.termination = Termination(self.cluster, self.cloud_provider)
        self.preemption = Preemption(
            self.cluster, cloud_provider=self.cloud_provider)
        self.interruption = Interruption(
            self.cluster, self.queue, self.unavailable,
            cloud_provider=self.cloud_provider)
        self.gc = GarbageCollection(self.cluster, self.cloud_provider)
        self.expiration = Expiration(self.cluster, self.cloud_provider)
        self.nodeclass_hash = NodeClassHash(self.cluster)
        self.nodeclass_status = NodeClassStatus(
            self.cluster, self.subnets, self.security_groups, self.images,
            self.instance_profiles)
        self.nodeclass_termination = NodeClassTermination(
            self.cluster, self.launch_templates, self.instance_profiles,
            instance_types=self.instance_types)
        self.tagging = NodeClaimTagging(
            self.cluster, self.cloud, cluster_name=cluster_name)
        self.pricing_refresh = PricingRefresh(self.pricing, clock=self.clock)
        self.instancetype_refresh = InstanceTypeRefresh(
            self.instance_types, clock=self.clock)
        self.disruption = Disruption(
            self.cluster, self.cloud_provider, self.options, self.clock,
            solver=self.solver)
        self.manager = ControllerManager(self.cluster, [
            self.nodeclass_hash,
            self.nodeclass_status,
            self.pricing_refresh,
            self.instancetype_refresh,
            self.provisioner,
            self.lifecycle,
            self.kubelet,
            self.binder,
            self.tagging,
            self.preemption,
            self.interruption,
            self.expiration,
            self.disruption,
            self.termination,
            self.gc,
            self.nodeclass_termination,
        ])

    # -- conveniences -----------------------------------------------------
    def add_default_nodeclass(self, **kw) -> NodeClass:
        nc = NodeClass(meta=ObjectMeta(name=kw.pop("name", "default")), **kw)
        self.cluster.nodeclasses.create(nc)
        return nc

    def settle(self, max_rounds: int = 50) -> int:
        return self.manager.run_until_idle(max_rounds)

    def close(self) -> None:
        """Release the external store (no-op with the in-memory backend);
        also runs automatically when the environment is garbage-collected."""
        if self._store_finalizer is not None:
            self._store_finalizer()
