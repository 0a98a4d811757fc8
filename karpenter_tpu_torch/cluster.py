"""In-memory cluster state — the kube-apiserver + informer-cache analogue.

The reference's controllers watch CRs through controller-runtime's informer
cache and reconcile; all durable state is CRDs in etcd (SURVEY §5
checkpoint/resume: "recovery = relist"). Our control plane is in-process, so
the store IS the cluster: typed collections with resource versions,
finalizer-aware deletion, a global mutation counter the controller manager
uses to run reconcilers to a fixed point deterministically, and WATCHES —
subscribers receive typed (kind, op, name) events on every mutation, so the
operator's run loop is event-driven (reconcile on change, wake instantly)
with the poll cadence demoted to a periodic resync, matching
controller-runtime's informer + resync model.

The port's copy of `karpenter_tpu/cluster.py`, with the timeline
recorder's capture point in `mutated`.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, TypeVar

from karpenter_tpu_torch.models.objects import Node, NodeClaim, Pod
from karpenter_tpu_torch.timeline import recorder as timeline_recorder
from karpenter_tpu_torch.utils import tracing
from karpenter_tpu_torch.utils.clock import Clock, RealClock

T = TypeVar("T")


class WatchEvent(NamedTuple):
    kind: str   # "pods", "nodes", "nodeclaims", ...
    op: str     # "added" | "modified" | "deleting" | "deleted"
    name: str


class Watch:
    """One subscriber's buffered event stream + wake signal.

    `wait(timeout)` returns True as soon as any event lands (or
    immediately if some are already buffered); `drain()` hands back and
    clears the buffer. The buffer is bounded — a slow consumer loses OLD
    events, never new ones, and the informer discipline (level-driven
    reconcile + periodic resync) makes dropped edges harmless."""

    def __init__(self, maxlen: int = 4096):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._buffer: deque = deque(maxlen=maxlen)

    def _publish(self, ev: WatchEvent) -> None:
        with self._lock:
            self._buffer.append(ev)
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def drain(self) -> List[WatchEvent]:
        with self._lock:
            out = list(self._buffer)
            self._buffer.clear()
            self._event.clear()
        return out


class Store:
    """One typed collection with k8s-ish semantics.

    The `_items` dict is an INFORMER CACHE (reference: controller-runtime
    informers over kube-apiserver); writes go through and are forwarded
    to the cluster's `StoreBackend`, whose authoritative copies survive
    this process and feed peer replicas' caches. With the default
    in-memory backend the forward is a no-op and the cache is the store.
    """

    def __init__(self, cluster: "Cluster", kind: str = ""):
        self._items: Dict[str, object] = {}
        self._cluster = cluster
        self.kind = kind

    def create(self, obj) -> object:
        name = obj.meta.name
        if name in self._items:
            raise ValueError(f"already exists: {name}")
        obj.meta.creation_time = self._cluster.clock.now()
        self._items[name] = obj
        if self._cluster.backend.put(self.kind, name, obj,
                                     verb="added") is False:
            # the authoritative store already holds this name (a peer
            # created it in the failover dual-writer window before its
            # write synced into our cache): roll the local create back and
            # surface AlreadyExists so the caller retries under a fresh
            # name — exactly the apiserver-409 flow
            del self._items[name]
            raise ValueError(f"already exists: {name} (peer replica)")
        self._cluster.mutated(self.kind, "added", name)
        return obj

    def get(self, name: str):
        return self._items.get(name)

    def update(self, obj) -> None:
        if obj.meta.name not in self._items:
            # an update through a stale reference to a deleted object must
            # not resurrect it (kube-apiserver returns a conflict here;
            # informer discipline = drop and let the next reconcile relist)
            return
        obj.meta.resource_version += 1
        self._cluster.backend.put(self.kind, obj.meta.name, obj)
        self._cluster.mutated(self.kind, "modified", obj.meta.name)

    def delete(self, name: str) -> None:
        """Finalizer-aware: objects with finalizers are only marked deleting;
        removal happens when the last finalizer is stripped
        (reference termination flow — disruption.md:29-36)."""
        obj = self._items.get(name)
        if obj is None:
            return
        if obj.meta.finalizers:
            if obj.meta.deletion_time is None:
                obj.meta.deletion_time = self._cluster.clock.now()
                self._cluster.backend.put(self.kind, name, obj,
                                          verb="deleting")
                self._cluster.mutated(self.kind, "deleting", name)
            return
        del self._items[name]
        self._cluster.backend.delete(self.kind, name)
        self._cluster.mutated(self.kind, "deleted", name)

    def remove_finalizer(self, name: str, finalizer: str) -> None:
        obj = self._items.get(name)
        if obj is None:
            return
        if finalizer in obj.meta.finalizers:
            obj.meta.finalizers.remove(finalizer)
            self._cluster.backend.put(self.kind, name, obj)
            self._cluster.mutated(self.kind, "modified", name)
        if obj.meta.deleting and not obj.meta.finalizers:
            del self._items[name]
            self._cluster.backend.delete(self.kind, name)
            self._cluster.mutated(self.kind, "deleted", name)

    def list(self, filter_: Optional[Callable[[T], bool]] = None) -> List:
        out = list(self._items.values())
        if filter_ is not None:
            out = [o for o in out if filter_(o)]
        return out

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items


class Cluster:
    def __init__(self, clock: Optional[Clock] = None, backend=None):
        from karpenter_tpu_torch.store import InMemoryBackend
        self.clock = clock or RealClock()
        self.backend = backend or InMemoryBackend()
        self.generation = 0  # bumps on every mutation anywhere
        self.pods = Store(self, "pods")
        self.nodes = Store(self, "nodes")
        self.nodeclaims = Store(self, "nodeclaims")
        self.nodepools = Store(self, "nodepools")
        self.nodeclasses = Store(self, "nodeclasses")
        self.pdbs = Store(self, "pdbs")
        self._stores = {s.kind: s for s in (
            self.pods, self.nodes, self.nodeclaims, self.nodepools,
            self.nodeclasses, self.pdbs)}
        # recovery = relist (SURVEY §5): hydrate the informer cache from
        # whatever authoritative state the backend already holds
        for kind, store in self._stores.items():
            store._items.update(self.backend.load(kind))
        self.events: List[tuple] = []  # (time, kind, object, reason, message)
        # active trace id per event, in lockstep with `events` (a parallel
        # list, not a 6th tuple element: consumers unpack 5-tuples) — lets
        # an operator jump from a FailedScheduling event to the exact
        # provisioning pass's trace in /debug/traces
        self.event_trace_ids: List[Optional[str]] = []
        # rolling dedup window over the last 512 event keys, maintained
        # incrementally (re-slicing events[-512:] per call made
        # a 2k-candidate sweep's per-candidate events quadratic)
        self._recent_event_keys: "deque" = deque(maxlen=512)
        self._recent_event_set: set = set()
        self._pdb_budget_cache: Dict[str, int] = {}
        self._pdb_budget_gen = -1
        self._watches: List[Watch] = []
        self._watch_lock = threading.Lock()

    def sync_backend(self) -> int:
        """Apply peer replicas' mutations to the informer cache (the
        informer-update half of the seam; no-op on the in-memory
        backend). Returns the number of events applied. The controller
        manager calls this at the top of every reconcile round, so a
        peer's writes are visible with informer latency, not resync
        latency."""
        n = 0
        for kind, verb, name, obj in self.backend.events():
            store = self._stores.get(kind)
            if store is None:
                continue
            if verb == "deleted":
                store._items.pop(name, None)
            elif obj is not None:
                store._items[name] = obj
            self.mutated(kind, verb, name)
            n += 1
        return n

    def watch(self) -> Watch:
        """Subscribe to every store mutation (the informer-cache seam)."""
        w = Watch()
        with self._watch_lock:
            self._watches.append(w)
        return w

    def unwatch(self, w: Watch) -> None:
        with self._watch_lock:
            if w in self._watches:
                self._watches.remove(w)

    def mutated(self, kind: str = "", op: str = "modified",
                name: str = "") -> None:
        self.generation += 1
        if self._watches:
            ev = WatchEvent(kind, op, name)
            with self._watch_lock:
                watches = list(self._watches)
            for w in watches:
                w._publish(ev)
        if kind:
            # the timeline recorder's capture point: every informer-cache
            # mutation (local write or peer event via sync_backend) lands
            # as one store.<kind>.<op> timeline event — the recorder
            # checks its own gate and costs one env read when off
            timeline_recorder.record_store_mutation(self, kind, op, name)

    def wait_synced(self, predicate: Callable[[], bool],
                    timeout: float = 5.0) -> bool:
        """Event-driven convergence wait over the replication seam:
        drain peer events, check `predicate`, and if it does not hold
        yet BLOCK on the backend's watch stream until the next peer
        event (or the deadline) instead of sleep-polling.  Mirrors the
        `wait_events` deflake: a loaded host delays the watch
        thread, and a fixed sleep cadence turns that delay into a
        spurious timeout, while blocking on the stream's condition
        variable waits exactly as long as the event takes.  Falls back
        to a short poll when the backend has no `wait_events` (the
        in-memory backend, where sync is a no-op anyway)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        waiter = getattr(self.backend, "wait_events", None)
        while True:
            self.sync_backend()
            if predicate():
                return True
            left = deadline - _time.monotonic()
            if left <= 0:
                return False
            if waiter is not None:
                # returns early on a new event or a dead stream; either
                # way re-check the predicate against a fresh sync
                waiter(1, timeout=min(left, 1.0))
            else:
                _time.sleep(min(left, 0.01))

    def record_event(self, kind: str, obj_name: str, reason: str,
                     message: str = "") -> None:
        """Deduplicated event recorder (reference: sigs.k8s.io/karpenter
        pkg/events; k8s events carry a TTL — here the list is bounded so a
        long-running operator emitting per-candidate reasons every
        reconcile pass can't grow it without limit). The dedup window
        covers more candidates than the largest supported consolidation
        sweep so per-pass repeats collapse."""
        # structured reasons (solver/explain.py Reason) upgrade to
        # code+detail: the registry code leads the message so operators
        # and log pipelines can match on it, while the legacy
        # human-readable string stays intact after it.  The format has
        # ONE owner (explain.event_message); the duck-typed attribute
        # check keeps the import off the plain-string fast path.
        if getattr(message, "code", None) is not None:
            from karpenter_tpu_torch.solver.explain import event_message
            message = event_message(message)
        # message participates in the key: a node's reason label (e.g.
        # Unconsolidatable) can stay the same while the CAUSE changes —
        # the refreshed message must land, only true repeats drop
        key = (kind, obj_name, reason, message)
        if key in self._recent_event_set:
            return
        if len(self._recent_event_keys) == self._recent_event_keys.maxlen:
            self._recent_event_set.discard(self._recent_event_keys[0])
        self._recent_event_keys.append(key)
        self._recent_event_set.add(key)
        self.events.append((self.clock.now(), *key))
        self.event_trace_ids.append(tracing.current_trace_id())
        if len(self.events) > 5000:
            del self.events[:2500]
            del self.event_trace_ids[:2500]

    # -- convenience views ------------------------------------------------
    def pending_pods(self) -> List[Pod]:
        return self.pods.list(
            lambda p: not p.scheduled and not p.is_daemonset
            and not p.meta.deleting)

    def daemonset_pods(self) -> List[Pod]:
        return self.pods.list(lambda p: p.is_daemonset)

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return self.pods.list(lambda p: p.node_name == node_name)

    def node_for_claim(self, claim: NodeClaim) -> Optional[Node]:
        if claim.node_name is not None:
            return self.nodes.get(claim.node_name)
        for node in self.nodes.list():
            if node.provider_id and node.provider_id == claim.provider_id:
                return node
        return None

    def claim_for_node(self, node: Node) -> Optional[NodeClaim]:
        for claim in self.nodeclaims.list():
            if claim.provider_id and claim.provider_id == node.provider_id:
                return claim
        return None

    # -- eviction budget (PDB) --------------------------------------------
    def pdb_disruptions_allowed(self, pod: Pod) -> Optional[int]:
        """The tightest remaining voluntary-disruption budget covering the
        pod, or None if no PDB selects it. 'unavailable' = selected pods
        currently not Running. Per-PDB budgets are memoized against the
        cluster generation: callers check every pod on every candidate each
        reconcile, and rescanning all pods per check is O(pods²)."""
        if self._pdb_budget_gen != self.generation:
            self._pdb_budget_cache.clear()
            self._pdb_budget_gen = self.generation
        tightest: Optional[int] = None
        for pdb in self.pdbs.list():
            if not pdb.matches(pod):
                continue
            allowed = self._pdb_budget_cache.get(pdb.meta.name)
            if allowed is None:
                unavailable = sum(
                    1 for p in self.pods.list()
                    if pdb.matches(p)
                    and (p.phase != "Running" or p.meta.deleting))
                allowed = pdb.max_unavailable - unavailable
                self._pdb_budget_cache[pdb.meta.name] = allowed
            if tightest is None or allowed < tightest:
                tightest = allowed
        return tightest

    def can_evict(self, pod: Pod) -> bool:
        allowed = self.pdb_disruptions_allowed(pod)
        return allowed is None or allowed > 0
