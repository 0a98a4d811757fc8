"""Pricing provider.

Mirrors pkg/providers/pricing/pricing.go: on-demand and spot price books
refreshed from the cloud on an interval, a seqnum that folds into the
instance-type provider's cache key, and a static fallback (the generated
catalog's embedded prices — the analogue of the reference's
zz_generated.pricing_aws.go tables for isolated VPCs, pricing.go:54-59).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, TYPE_CHECKING

from karpenter_tpu_torch.models import wellknown

if TYPE_CHECKING:
    from karpenter_tpu_torch.providers.fake_cloud import FakeCloud

# (instance_type, zone, capacity_type) → $/hour
PriceBook = Dict[Tuple[str, str, str], float]


class PricingProvider:
    def __init__(self, cloud: "FakeCloud"):
        self._cloud = cloud
        self._prices: PriceBook = {}
        self.seqnum = 0
        self.update()  # static-fallback hydrate: catalog prices are always available

    def update(self) -> bool:
        """Refresh the price book from the cloud; returns True on change
        (reference: UpdateOnDemandPricing / UpdateSpotPricing via the
        pricing controller, pkg/controllers/providers/pricing/controller.go:67).
        """
        fresh: PriceBook = {}
        for it in self._cloud.describe_instance_types():
            for o in it.offerings:
                fresh[(it.name, o.zone, o.capacity_type)] = o.price
        if fresh != self._prices:
            self._prices = fresh
            self.seqnum += 1
            return True
        return False

    def price(self, instance_type: str, zone: str, capacity_type: str) -> Optional[float]:
        return self._prices.get((instance_type, zone, capacity_type))

    def on_demand_price(self, instance_type: str, zone: str) -> Optional[float]:
        return self.price(instance_type, zone, wellknown.CAPACITY_TYPE_ON_DEMAND)

    def spot_price(self, instance_type: str, zone: str) -> Optional[float]:
        return self.price(instance_type, zone, wellknown.CAPACITY_TYPE_SPOT)

    def live(self) -> bool:
        return len(self._prices) > 0
