"""Instance-type provider — the hot-path input.

Builds `List[InstanceType]` per NodeClass with per-offering price and
availability, behind a composite cache key that folds in every upstream
seqnum, mirroring pkg/providers/instancetype/instancetype.go:100-175 (List +
the cache-key discipline at :127-136: nodeclass hash ⊕ unavailable-offerings
seqnum ⊕ pricing seqnum ⊕ catalog seqnum). A change anywhere upstream — an
ICE marking, a price refresh, a catalog update — invalidates exactly the
affected entries; otherwise the same list object is returned so the solver's
device-resident encoding can be reused call-over-call.
"""

from __future__ import annotations

from typing import List, Optional, TYPE_CHECKING

from typing import Dict

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import InstanceType, NodeClass, Offering
from karpenter_tpu_torch.models.resources import RESOURCE_AXIS, Resources
from karpenter_tpu_torch.providers.pricing import PricingProvider
from karpenter_tpu_torch.utils.cache import (
    INSTANCE_TYPES_ZONES_TTL,
    TTLCache,
    UnavailableOfferings,
)
from karpenter_tpu_torch.utils.clock import Clock

if TYPE_CHECKING:
    from karpenter_tpu_torch.providers.fake_cloud import FakeCloud


def _parse_eviction_signal(value: str, capacity_mib: float) -> float:
    """MiB from an eviction signal value: '5%' of capacity or an absolute
    quantity (pkg/providers/instancetype/types.go computeEvictionSignal)."""
    value = value.strip()
    if value.endswith("%"):
        return capacity_mib * float(value[:-1]) / 100.0
    return Resources.parse({"memory": value}).get("memory")


def _kube_reserved_cpu_millis(vcpus: int) -> float:
    """The reference's core-count staircase
    (pkg/providers/instancetype/types.go:380-402): 6% of the first core,
    1% of the second, 0.5% of the next two, 0.25% of the rest."""
    cpu = 0.0
    remaining = vcpus
    for n, frac in ((1, 0.06), (1, 0.01), (2, 0.005)):
        take = min(remaining, n)
        cpu += take * 1000 * frac
        remaining -= take
    cpu += max(remaining, 0) * 1000 * 0.0025
    return cpu


def apply_node_class(shape: InstanceType, nc: NodeClass) -> InstanceType:
    """Fold the NodeClass's kubelet config, block-device mappings, and
    instance-store policy into the per-type capacity/overhead — the role
    of the reference's per-nodepool InstanceType construction
    (pkg/providers/instancetype/types.go:193-210 capacity,
    :338-352 ENI/max-pods override, :369-431 reserved + eviction).

    Identity when none of those fields are set: the catalog's shape
    already carries the default ladder, and returning the SAME object
    preserves the provider's list-identity cache contract."""
    kub = nc.kubelet
    # family-default devices count as spec: an accel-family class boots
    # an 8 GiB root even with no explicit mappings, and advertising the
    # catalog's generic ephemeral there would pack pods onto disk that
    # doesn't exist (the reference computes ephemeral from the same
    # amifamily defaults its launch templates use)
    from karpenter_tpu_torch.providers.imagefamily import (
        ImageFamily, effective_block_device_mappings, get_family,
        root_volume_gib_of)
    family_has_defaults = (
        type(get_family(nc.image_family)).default_block_device_mappings
        is not ImageFamily.default_block_device_mappings)
    if (kub is None and nc.block_device_mappings is None
            and nc.instance_store_policy is None
            and not family_has_defaults):
        return shape

    caps = dict(zip(RESOURCE_AXIS, shape.capacity.v))
    vcpus = int(round(caps.get("cpu", 0.0) / 1000.0))
    # -- max pods (kubelet override beats the catalog's ENI ladder) ------
    pods = caps.get("pods", 0.0)
    if kub is not None and kub.max_pods is not None:
        pods = float(kub.max_pods)
    if kub is not None and kub.pods_per_core is not None:
        # podsPerCore cannot exceed maxPods (ec2nodeclass.go:203-206)
        pods = min(pods, float(kub.pods_per_core * max(vcpus, 1)))
    # -- ephemeral storage from mappings / instance store ----------------
    ephemeral_mib = caps.get("ephemeral-storage", 0.0)
    nvme_req = shape.requirements.get(wellknown.INSTANCE_LOCAL_NVME_LABEL)
    nvme_gib = 0
    if nvme_req is not None and nvme_req.values():
        try:
            nvme_gib = int(next(iter(nvme_req.values())))
        except ValueError:
            nvme_gib = 0
    if nc.instance_store_policy == "RAID0" and nvme_gib > 0:
        # RAID0 over the local disks IS the node's ephemeral storage
        # (ec2nodeclass.go:384-394)
        ephemeral_mib = nvme_gib * 1024.0
    elif nc.block_device_mappings is not None or family_has_defaults:
        eff = effective_block_device_mappings(nc)
        ephemeral_mib = root_volume_gib_of(
            eff, nc.block_device_gib) * 1024.0

    # -- reserved + eviction overhead ------------------------------------
    mem_mib = caps.get("memory", 0.0)
    kube_reserved = {
        "cpu": _kube_reserved_cpu_millis(vcpus),
        "memory": 11.0 * pods + 255.0,
        "ephemeral-storage": 1024.0,
    }
    system_reserved: Dict[str, float] = {}
    eviction = {"memory": 100.0,
                "ephemeral-storage": ephemeral_mib * 0.10}
    if kub is not None:
        # pid is a legal reserved key in the CRD but not a schedulable
        # axis — it is accepted and ignored, like the reference's
        # allocatable math which only folds cpu/memory/ephemeral-storage
        axes = ("cpu", "memory", "ephemeral-storage")
        for k, v in kub.kube_reserved.items():
            if k in axes:
                kube_reserved[k] = Resources.parse({k: v}).get(k)
        for k, v in kub.system_reserved.items():
            if k in axes:
                system_reserved[k] = Resources.parse({k: v}).get(k)
        for signals in (kub.eviction_hard, kub.eviction_soft):
            if not signals:
                continue
            override = {}
            if "memory.available" in signals:
                override["memory"] = _parse_eviction_signal(
                    signals["memory.available"], mem_mib)
            if "nodefs.available" in signals:
                override["ephemeral-storage"] = _parse_eviction_signal(
                    signals["nodefs.available"], ephemeral_mib)
            for k, v in override.items():
                eviction[k] = max(eviction.get(k, 0.0), v)

    overhead = Resources()
    for src in (kube_reserved, system_reserved, eviction):
        for k, v in src.items():
            overhead.set(k, overhead.get(k) + v)

    capacity = shape.capacity.copy()
    capacity.set("pods", pods)
    capacity.set("ephemeral-storage", ephemeral_mib)
    return InstanceType(
        name=shape.name, capacity=capacity,
        requirements=shape.requirements, offerings=shape.offerings,
        overhead=overhead)


class InstanceTypeProvider:
    def __init__(
        self,
        cloud: "FakeCloud",
        pricing: PricingProvider,
        unavailable: UnavailableOfferings,
        clock: Optional[Clock] = None,
    ):
        self._cloud = cloud
        self.pricing = pricing
        self.unavailable = unavailable
        self._cache = TTLCache(ttl=INSTANCE_TYPES_ZONES_TTL, clock=clock)
        from karpenter_tpu_torch.utils.logging import ChangeMonitor, get_logger
        self._log = get_logger("instancetype")
        self._changes = ChangeMonitor()
        # gauge-series ownership per nodeclass VIEW, surviving cache
        # flushes: removal must consider every nodeclass's last-listed
        # catalog, or one nodeclass's narrowed view would delete series
        # another still exports — and TTL expiry/invalidate() would skip
        # removal entirely (the cache entry is gone by then)
        self._exported: dict = {}   # name → (types set, offering-key set)

    def _cache_key(self, node_class: NodeClass) -> tuple:
        return (
            node_class.name,
            node_class.static_hash(),
            self.unavailable.seqnum,
            self.pricing.seqnum,
            self._cloud.catalog_seqnum,
        )

    def list(self, node_class: NodeClass) -> List[InstanceType]:
        key = self._cache_key(node_class)
        # cache is keyed by nodeclass name, validated by the composite key, so
        # superseded entries are replaced rather than orphaned (a seqnum bump
        # per ICE/price change would otherwise leak one full catalog each)
        cached = self._cache.get(node_class.name)
        if cached is not None and cached[0] == key:
            return cached[1]

        try:
            shapes = self._cloud.describe_instance_types()
        except Exception:  # noqa: BLE001
            if cached is not None:
                # stale-on-error: the last-known catalog beats failing the
                # scheduling pass (the static-fallback discipline,
                # pricing.go:54-59)
                return cached[1]
            raise

        zones = set(node_class.zones or self._cloud.zones)
        families = set(node_class.instance_families or [])
        cap_types = set(node_class.capacity_types)

        out: List[InstanceType] = []
        for shape in shapes:
            if families:
                fam = shape.requirements.get(wellknown.INSTANCE_FAMILY_LABEL)
                # unlabeled shapes are excluded: a family restriction is a
                # whitelist, not a hint
                if fam is None or not (fam.values() & families):
                    continue
            offerings = []
            for o in shape.offerings:
                if o.zone not in zones or o.capacity_type not in cap_types:
                    continue
                price = self.pricing.price(shape.name, o.zone, o.capacity_type)
                offerings.append(Offering(
                    zone=o.zone,
                    capacity_type=o.capacity_type,
                    price=price if price is not None else o.price,
                    available=not self.unavailable.is_unavailable(
                        o.capacity_type, shape.name, o.zone),
                ))
            if not offerings:
                continue
            out.append(apply_node_class(InstanceType(
                name=shape.name,
                capacity=shape.capacity,
                requirements=shape.requirements,
                offerings=offerings,
                overhead=shape.overhead,
            ), node_class))
        # change-gated count log on the fetch the re-pull already performed
        # (reference instancetype.go:151-153 via pretty.ChangeMonitor) —
        # steady-state refreshes stay silent
        if self._changes.has_changed(f"count/{node_class.name}", len(out)):
            self._log.info("discovered instance types",
                           node_class=node_class.name, count=len(out))
        # per-type catalog gauges, refreshed on the (rare) catalog rebuild
        # (reference instancetype.go:156-161,302-311); series for vanished
        # types/offerings are deleted, not left stale
        from karpenter_tpu_torch.utils import metrics
        for it in out:
            caps = it.capacity.to_dict()  # solver units → cores/bytes
            metrics.INSTANCE_TYPE_CPU.set(
                caps.get("cpu", 0.0), instance_type=it.name)
            metrics.INSTANCE_TYPE_MEMORY.set(
                caps.get("memory", 0.0), instance_type=it.name)
            for o in it.offerings:
                metrics.INSTANCE_TYPE_OFFERING_PRICE.set(
                    o.price, instance_type=it.name, zone=o.zone,
                    capacity_type=o.capacity_type)
                metrics.INSTANCE_TYPE_OFFERING_AVAILABLE.set(
                    1.0 if o.available else 0.0, instance_type=it.name,
                    zone=o.zone, capacity_type=o.capacity_type)
        new_types = {it.name for it in out}
        new_offs = {(it.name, o.zone, o.capacity_type)
                    for it in out for o in it.offerings}
        prev = self._exported.get(node_class.name, (set(), set()))
        self._exported[node_class.name] = (new_types, new_offs)
        self._remove_unclaimed(prev[0] - new_types, prev[1] - new_offs)
        self._cache.set(node_class.name, (key, out))
        return out

    def _remove_unclaimed(self, stale_types, stale_offs) -> None:
        """Delete gauge series no nodeclass's last-listed view exports
        anymore (removal keyed on the union, not one view)."""
        if not stale_types and not stale_offs:
            return
        from karpenter_tpu_torch.utils import metrics
        live_types = set().union(
            *(t for t, _ in self._exported.values()), set())
        live_offs = set().union(
            *(o for _, o in self._exported.values()), set())
        for name in stale_types - live_types:
            metrics.INSTANCE_TYPE_CPU.remove(instance_type=name)
            metrics.INSTANCE_TYPE_MEMORY.remove(instance_type=name)
        for (name, zone, ct) in stale_offs - live_offs:
            labels = dict(instance_type=name, zone=zone, capacity_type=ct)
            metrics.INSTANCE_TYPE_OFFERING_PRICE.remove(**labels)
            metrics.INSTANCE_TYPE_OFFERING_AVAILABLE.remove(**labels)

    def forget(self, node_class_name: str) -> None:
        """A NodeClass is gone: drop its view and delete the series only
        it exported (called from the nodeclass termination flow)."""
        ent = self._exported.pop(node_class_name, None)
        if ent is not None:
            self._remove_unclaimed(*ent)

    def invalidate(self) -> None:
        """Drop cached lists so the next call re-pulls the catalog (the
        refresh controller's UpdateInstanceTypes/Offerings analogue,
        instancetype.go:184-253)."""
        self._cache.flush()

    def live(self) -> bool:
        """Liveness aggregation (reference: instancetype.go:177-182 folds
        subnet+pricing liveness into the cloudprovider probe)."""
        return self.pricing.live() and self._cloud.live()
