"""TTL caches and the unavailable-offerings (ICE) cache.

The ICE cache is *the* feedback path from launch failures back into
scheduling (reference: pkg/cache/unavailableofferings.go:31-66 — key
`capacityType:instanceType:zone`, TTL 3 min per pkg/cache/cache.go:29, and a
seqnum that invalidates the instance-type provider's composite cache key on
every change).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

from karpenter_tpu_torch.utils.clock import Clock, RealClock

# TTLs mirroring pkg/cache/cache.go:20-46
DEFAULT_TTL = 60.0
UNAVAILABLE_OFFERINGS_TTL = 180.0
INSTANCE_TYPES_ZONES_TTL = 300.0


class TTLCache:
    def __init__(self, ttl: float = DEFAULT_TTL, clock: Optional[Clock] = None,
                 on_evict=None):
        self.ttl = ttl
        self.clock = clock or RealClock()
        self.on_evict = on_evict  # called with (key, value) when an entry expires
        self._items: Dict[Any, Tuple[float, Any]] = {}

    def _expire(self, key: Any, value: Any) -> None:
        del self._items[key]
        if self.on_evict is not None:
            self.on_evict(key, value)

    def get(self, key: Any) -> Optional[Any]:
        item = self._items.get(key)
        if item is None:
            return None
        expires, value = item
        if self.clock.now() >= expires:
            self._expire(key, value)
            return None
        return value

    def sweep(self) -> int:
        """Evict every expired entry now (firing on_evict); returns count.
        Lazy expiry isn't enough for state whose *disappearance* must be
        observable — e.g. ICE entries aging out must bump the seqnum the
        instance-type cache key folds in (reference: OnEvicted callback in
        pkg/cache/unavailableofferings.go).
        """
        now = self.clock.now()
        expired = [(k, v) for k, (exp, v) in self._items.items() if now >= exp]
        for k, v in expired:
            self._expire(k, v)
        return len(expired)

    def set(self, key: Any, value: Any, ttl: Optional[float] = None) -> None:
        self._items[key] = (self.clock.now() + (ttl or self.ttl), value)

    def delete(self, key: Any) -> None:
        self._items.pop(key, None)

    def flush(self) -> None:
        self._items.clear()

    def keys(self) -> Iterator[Any]:
        now = self.clock.now()
        return iter([k for k, (exp, _) in self._items.items() if now < exp])

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())

    def __contains__(self, key: Any) -> bool:
        return self.get(key) is not None


class UnavailableOfferings:
    """Insufficient-capacity backoff cache with a monotonically increasing
    sequence number; the instance-type provider folds the seqnum into its
    cache key so a capacity-error immediately invalidates cached catalogs
    (pkg/cache/unavailableofferings.go + instancetype.go:127-136).
    """

    def __init__(self, clock: Optional[Clock] = None,
                 ttl: float = UNAVAILABLE_OFFERINGS_TTL):
        self._cache = TTLCache(ttl=ttl, clock=clock,
                               on_evict=lambda k, v: self._bump())
        self._seq = 0

    def _bump(self) -> None:
        self._seq += 1

    @property
    def seqnum(self) -> int:
        # sweep first so TTL expirations are visible to cache-key readers
        self._cache.sweep()
        return self._seq

    @staticmethod
    def _key(capacity_type: str, instance_type: str, zone: str) -> str:
        return f"{capacity_type}:{instance_type}:{zone}"

    def is_unavailable(self, capacity_type: str, instance_type: str, zone: str) -> bool:
        return self._key(capacity_type, instance_type, zone) in self._cache

    def mark_unavailable(self, capacity_type: str, instance_type: str, zone: str,
                         reason: str = "InsufficientInstanceCapacity") -> None:
        self._cache.set(self._key(capacity_type, instance_type, zone), reason)
        self._bump()

    def delete(self, capacity_type: str, instance_type: str, zone: str) -> None:
        self._cache.delete(self._key(capacity_type, instance_type, zone))
        self._bump()

    def flush(self) -> None:
        self._cache.flush()
        self._bump()
