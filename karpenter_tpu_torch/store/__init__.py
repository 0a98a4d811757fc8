"""Pluggable cluster-store backends.

The reference's controllers never own their state: they watch CRs through
controller-runtime's informer cache and write back to kube-apiserver
(cmd/controller/main.go:46-54 hands every controller one `client.Client`;
recovery is relist — SURVEY §5 checkpoint/resume).  This package gives
the port's `Cluster` the same split: the in-process object dicts are an
INFORMER CACHE, and a `StoreBackend` decides where the authoritative
copies live.

The port has the seam and `InMemoryBackend` (the cache IS the store, the
default).  The remote store daemon (`remote.py`) and the kube list/watch
backend (`http.py`) are still to port (slice 5c).
"""

from karpenter_tpu_torch.store.backend import InMemoryBackend, StoreBackend

__all__ = [
    "InMemoryBackend",
    "StoreBackend",
]
