"""Pluggable cluster-store backends.

The reference's controllers never own their state: they watch CRs through
controller-runtime's informer cache and write back to kube-apiserver
(cmd/controller/main.go:46-54 hands every controller one `client.Client`;
recovery is relist — SURVEY §5 checkpoint/resume).  This package gives
the port's `Cluster` the same split: the in-process object dicts are an
INFORMER CACHE, and a `StoreBackend` decides where the authoritative
copies live.

Three backends, as in the JAX package:

- `InMemoryBackend` — the cache IS the store (the default).
- `RemoteBackend` (`remote.py`) — a process-external store daemon spoken
  to over a unix socket with a watch stream (`python -m
  karpenter_tpu_torch.store <socket>` runs one in its own process).
- `HttpBackend` (`http.py`) — the kube list/watch REST protocol over
  chunked HTTP against `FakeApiServer`, a minimal in-repo apiserver.
"""

from karpenter_tpu_torch.store.backend import InMemoryBackend, StoreBackend
from karpenter_tpu_torch.store.http import (
    FakeApiServer,
    HttpBackend,
    PickleCodec,
)
from karpenter_tpu_torch.store.remote import RemoteBackend, StoreDaemon

__all__ = [
    "FakeApiServer",
    "HttpBackend",
    "InMemoryBackend",
    "PickleCodec",
    "RemoteBackend",
    "StoreBackend",
    "StoreDaemon",
]
