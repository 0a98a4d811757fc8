"""Provider refresh controllers — singleton polling loops.

Mirrors pkg/controllers/providers: the instance-type controller re-pulls
instance types/offerings on an interval
(providers/instancetype/controller.go:68) and the pricing controller
refreshes the price books (providers/pricing/controller.go:67), feeding the
respective provider caches so the scheduling hot path never blocks on a
cloud API.

The port's copy of `karpenter_tpu/controllers/refresh.py`, with the
timeline's price.refresh capture point.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.clock import Clock, RealClock
from karpenter_tpu_torch.utils.logging import get_logger

DEFAULT_REFRESH_INTERVAL = 300.0  # instance-type cache TTL class (cache.go)


class _IntervalController:
    interval = DEFAULT_REFRESH_INTERVAL

    def __init__(self, clock: Optional[Clock] = None,
                 interval: Optional[float] = None):
        self.clock = clock or RealClock()
        if interval is not None:
            self.interval = interval
        self._last: Optional[float] = None

    def reconcile(self) -> None:
        now = self.clock.now()
        if self._last is not None and now - self._last < self.interval:
            return
        self._last = now
        self.refresh()

    def refresh(self) -> None:
        raise NotImplementedError


class PricingRefresh(_IntervalController):
    name = "pricing-refresh"

    def __init__(self, pricing, clock=None, interval=None):
        super().__init__(clock, interval)
        self.pricing = pricing

    def refresh(self) -> None:
        try:
            self.pricing.update()
            # the timeline's price.refresh capture point: a successful
            # book refresh is a cluster-trajectory input (solves after
            # it rank against new prices)
            from karpenter_tpu_torch.timeline import events as tev
            from karpenter_tpu_torch.timeline import recorder as trec
            trec.emit(tev.PRICE_REFRESH, name=self.name)
        except Exception as e:  # noqa: BLE001 — keep the stale book (static
            # fallback semantics, pricing.go:54-59) — but visibly: a price
            # book aging silently is how cost regressions go unnoticed
            get_logger(self.name).warn(
                "pricing update failed; keeping the stale book",
                error=str(e)[:200])
            metrics.RECONCILE_ERRORS.inc(controller=self.name)


class InstanceTypeRefresh(_IntervalController):
    name = "instancetype-refresh"

    def __init__(self, instance_types, clock=None, interval=None):
        super().__init__(clock, interval)
        self.instance_types = instance_types

    def refresh(self) -> None:
        # reading seqnum sweeps expired ICE entries (their disappearance
        # must invalidate downstream cache keys), then drop cached lists so
        # the next scheduler call re-pulls the catalog (which logs the
        # discovered count, change-gated, on its own fetch)
        _ = self.instance_types.unavailable.seqnum
        self.instance_types.invalidate()
