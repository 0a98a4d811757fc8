"""The store-backend seam (see package docstring).

Contract, mirroring the slice of `client.Client` + informers the
reference's controllers actually use
(cmd/controller/main.go:46-54):

- `load(kind)` — authoritative name→object snapshot (relist/recovery).
- `put(kind, name, obj)` — upsert the authoritative copy; returns False
  when the store rejected the write as a conflict (create of an existing
  name, modify of a deleted one — the apiserver-409 analogue). Called by
  the cluster AFTER the local cache mutation; the object may be the same
  mutable instance the cache holds, so implementations must serialize
  (or copy) before returning.
- `delete(kind, name)` — remove the authoritative copy.
- `events()` — drain peer mutations as (kind, verb, name, obj) tuples;
  obj is None for deletes. Self-originated echoes must NOT be returned
  (the local cache is already newer).
- `close()` — release resources.

Verbs are the cluster's watch verbs: added/modified/deleting/deleted.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class StoreBackend:
    def load(self, kind: str) -> Dict[str, object]:
        raise NotImplementedError

    def put(self, kind: str, name: str, obj: object,
            verb: str = "modified") -> bool:
        raise NotImplementedError

    def delete(self, kind: str, name: str) -> None:
        raise NotImplementedError

    def events(self) -> List[Tuple[str, str, str, Optional[object]]]:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class InMemoryBackend(StoreBackend):
    """The default: the informer cache is the authority; every method is
    a no-op. Kept trivial on purpose — the in-process hot paths (50k-pod
    provisioning reconciles) must not pay a serialization tax for a seam
    they don't use."""

    def load(self, kind: str) -> Dict[str, object]:
        return {}

    def put(self, kind: str, name: str, obj: object,
            verb: str = "modified") -> bool:
        return True

    def delete(self, kind: str, name: str) -> None:
        pass

    def events(self) -> List[Tuple[str, str, str, Optional[object]]]:
        return []

    def close(self) -> None:
        pass
