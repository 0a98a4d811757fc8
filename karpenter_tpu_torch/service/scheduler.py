"""Tenant-aware dispatch layer between the wire and the device.

The port's copy of `karpenter_tpu/service/scheduler.py`: the same knobs
and defaults (`KARPENTER_TPU_TENANT_FUSE`, `_WEIGHTS`, `_WEIGHTS_FILE`,
`_QUEUE`, `_QUANTUM`, `_MAX_FUSE`); a fused batch is one K5 launch of B
problems on the card.

kt_solverd is a SHARED service for many clusters, not a per-cluster
sidecar (ROADMAP item 2).  The C++ batching window coalesces whatever
happens to arrive together; before this module, `handle_batch` fused
only same-fingerprint arrivals in window order, so under concurrent
multi-tenant load one heavy tenant could monopolize the single batcher
thread and incompatible arrivals serialized head-of-line.  This module
is the scheduler that sits between the parsed wire frames and the
device dispatch:

  * **Per-tenant bounded queues.**  Each tenant (the client-declared
    ``tenant`` field in the schedule frame body; default derived from
    the daemon connection id) gets its own queue, bounded at
    ``KARPENTER_TPU_TENANT_QUEUE`` requests.  Admission past the bound
    sheds the LOWEST-priority request — the incoming one, or a queued
    lower-priority one it evicts — counted on
    ``karpenter_tpu_service_tenant_shed_total{tenant,reason="admission"}``
    and answered with an explicit ``("shed", {...})`` response carrying
    the backpressure hint.  Never silent, never dropped.

  * **Weighted deficit-round-robin fairness.**  Each planning round
    credits every backlogged tenant ``quantum × weight`` deficit; a
    tenant spends one deficit per dispatched request.  Equal weights ⇒
    equal steady-state service; ``KARPENTER_TPU_TENANT_WEIGHTS``
    ("gold=4,free=1") buys a tenant a larger share.  A tenant's deficit
    resets when its queue empties (classic DRR — no hoarding credit
    while idle).

  * **Cross-tenant bucket fusion.**  Requests whose encoded problems
    land in the same padded bucket — key ``(catalog fingerprint,
    max_nodes, G bucket, E bucket)``, the exact launch-shape key the
    warmup lattice pre-traces — fuse into ONE batched ``solve_batch``
    device call even when they come from different tenants/clusters.
    The batch fills to ``max_fuse`` while matching demand and deficit
    last; fusing only WITHIN a bucket means a fused batch never drags
    its members to a bigger padded shape (no new compile cliffs).
    ``KARPENTER_TPU_TENANT_FUSE=off`` is the rollback knob: every
    request then dispatches alone, in the same DRR order.

  * **Deadline-aware dispatch order.**  The next batch normally seeds
    from the DRR rotation; when the oldest queued deadline is about to
    pass (within ~2× the dispatch-time EWMA), that request seeds the
    batch instead, so a deadline-pressed partial bucket dispatches
    early while full buckets otherwise fill.  A request whose deadline
    expires WHILE QUEUED is shed (reason="deadline"), counted, and
    answered — the daemon never burns the device for a caller that
    already gave up, and the caller gets a fast explicit answer instead
    of its timeout.

  * **Backpressure, not blind backoff.**  Every response (results and
    sheds alike) carries ``{queue_depth, eta_ms, retry_after_ms}`` —
    queue depth includes the C++ window backlog the daemon reported,
    and the ETA extrapolates from the dispatch EWMA and the observed
    fused-batch occupancy — so clients pace retries from the server's
    own estimate (service/resilience.py honors it).

Threading: the daemon calls `handle_batch` from its ONE batcher thread,
but in-process harnesses (tests/test_faults.py FakePySolverd,
service/loopback.py) may call it from several.  The scheduler is
therefore a real fan-in point: `pump()` elects one dispatcher at a time
(`_dispatch_fn_lock` — held across the device call by design, it IS the
device serialization), while `_lock` guards only queue state and is
NEVER held across a dispatch (kt-lint lock-discipline; the fixtures in
tests/test_lint.py encode exactly this split).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.solver.explain import SHED_ADMISSION, SHED_DEADLINE
from karpenter_tpu_torch.utils import metrics

# per-tenant queue bound: past it, admission sheds lowest-priority first
DEFAULT_QUEUE_BOUND = 256
# DRR credit per backlogged tenant per planning round (requests)
DEFAULT_QUANTUM = 8
# fused-batch ceiling — mirrors the daemon's --max-batch and the
# kernel's B_BUCKETS[-1] chunk, so one fused dispatch is one device call
DEFAULT_MAX_FUSE = 64
# floor under the deadline-pressure window (seconds): even with a cold
# EWMA, a request within this margin of its deadline seeds the next batch
MIN_DEADLINE_SLACK = 0.25
# tenant-state cap: connection-derived tenants ("conn-<id>") are minted
# per accept, and a reconnecting undeclared client would otherwise grow
# queues/rotation/metric series forever — past this many tenants, idle
# empty queues are garbage-collected oldest-activity-first
TENANT_GC_CAP = 256
# keep a fused batch whole when its padding waste is small: a batch of
# n dispatches un-trimmed when n >= this fraction of the tier it would
# pad to (63 compatible requests ride ONE 64-padded call; 9 would waste
# 7/16 of a padded-16 call and ships as 4+4+1 instead)
PAD_KEEP_FRACTION = 0.75


def fuse_enabled() -> bool:
    """KARPENTER_TPU_TENANT_FUSE rollback knob (default on).  Re-read
    per planning round so in-process harnesses can flip it live."""
    from karpenter_tpu_torch.utils.knobs import env_bool
    return env_bool("KARPENTER_TPU_TENANT_FUSE", default=True)


def parse_weights(spec: Optional[str]) -> Dict[str, float]:
    """"gold=4,free=1" → {"gold": 4.0, "free": 1.0}; malformed entries
    are ignored (a typo must not take the dispatch path down), weights
    clamp to a 0.1 floor so a mistyped 0 cannot starve a tenant."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            out[name.strip()] = max(0.1, float(val))
        except ValueError:
            continue
    return out


def load_weights(environ=None) -> Dict[str, float]:
    """Tenant weights from the CONFIG SURFACE (ROADMAP item 2 headroom):
    the optional weights file named by
    ``KARPENTER_TPU_TENANT_WEIGHTS_FILE`` — the operator-options /
    deploy-config surface (the supervisor's ``--tenant-weights-file``
    flag exports it to the worker) — overlaid by the
    ``KARPENTER_TPU_TENANT_WEIGHTS`` env knob, which STAYS the
    per-tenant override lever.  File grammar: the same ``tenant=weight``
    entries, one or many per line (commas or newlines), ``#`` comments;
    a missing or unreadable file degrades to the env knob alone, never
    crashes the daemon."""
    env = os.environ if environ is None else environ
    out: Dict[str, float] = {}
    path = env.get("KARPENTER_TPU_TENANT_WEIGHTS_FILE")
    if path:
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.split("#", 1)[0].strip()
                    if line:
                        out.update(parse_weights(line))
        except (OSError, UnicodeDecodeError):
            # "unreadable degrades, never crashes the daemon" covers a
            # non-UTF-8 file (binary dropped by mistake) too — not an
            # OSError subclass
            pass
    out.update(parse_weights(env.get("KARPENTER_TPU_TENANT_WEIGHTS")))
    return out


class Item:
    """One queued schedule request.  `key` is the opaque fusion-bucket
    key (hashable; the backend builds it from the catalog fingerprint,
    max_nodes, and the padded G/E buckets), `payload` is whatever the
    backend needs to rebuild the request at dispatch time, and
    `respond` is the per-request answer callback — items from different
    `handle_batch` calls can ride one fused dispatch, so each item
    carries its own way home."""

    __slots__ = ("key", "tenant", "priority", "deadline", "payload",
                 "respond", "seq", "enqueued_at", "answered")

    def __init__(self, key, tenant: str, priority: int,
                 deadline: Optional[float], payload,
                 respond: Callable[[tuple], None], seq: int,
                 enqueued_at: float):
        self.key = key
        self.tenant = tenant
        self.priority = priority
        self.deadline = deadline
        self.payload = payload
        self.respond = respond
        self.seq = seq
        self.enqueued_at = enqueued_at
        self.answered = False


class _TenantQueue:
    """One tenant's bounded queue: items kept in (priority desc, arrival)
    order, plus the tenant's DRR ledger."""

    __slots__ = ("tenant", "weight", "deficit", "items",
                 "submitted", "dispatched", "shed", "last_active")

    def __init__(self, tenant: str, weight: float):
        self.tenant = tenant
        self.weight = weight
        self.deficit = 0.0
        self.items: List[Item] = []
        self.submitted = 0
        self.dispatched = 0
        self.shed: Dict[str, int] = {}
        self.last_active = 0.0

    def insert(self, item: Item) -> None:
        # total (priority desc, arrival seq) order; the scan-from-tail
        # keeps the common same-priority append fast, and makes
        # re-inserting a tier-trimmed item (lowest seq of its band) land
        # back at its original position
        i = len(self.items)
        key = (-item.priority, item.seq)
        while i > 0 and (-self.items[i - 1].priority,
                         self.items[i - 1].seq) > key:
            i -= 1
        self.items.insert(i, item)

    def lowest_priority(self) -> Optional[Item]:
        return self.items[-1] if self.items else None

    def pop_matching(self, key) -> Optional[Item]:
        """Next item (service order) whose bucket matches `key`; None
        when nothing in this queue fuses into the batch being built."""
        for i, item in enumerate(self.items):
            if key is None or item.key == key:
                return self.items.pop(i)
        return None


class TenantScheduler:
    def __init__(self, queue_bound: Optional[int] = None,
                 quantum: Optional[float] = None,
                 max_fuse: Optional[int] = None,
                 weights: Optional[Dict[str, float]] = None,
                 batch_tiers: Tuple[int, ...] = (4, 16, 64),
                 clock: Callable[[], float] = time.time):
        env = os.environ
        self.queue_bound = int(queue_bound if queue_bound is not None
                               else env.get("KARPENTER_TPU_TENANT_QUEUE",
                                            DEFAULT_QUEUE_BOUND))
        self.quantum = float(quantum if quantum is not None
                             else env.get("KARPENTER_TPU_TENANT_QUANTUM",
                                          DEFAULT_QUANTUM))
        self.max_fuse = int(max_fuse if max_fuse is not None
                            else env.get("KARPENTER_TPU_TENANT_MAX_FUSE",
                                         DEFAULT_MAX_FUSE))
        # demand-weighted batch sizing: the kernel's batch axis pads to
        # these tiers (solve.py B_BUCKETS), so a fused batch of 8 would
        # PAD to 16 and burn half the device call — trim each dispatch
        # down to the largest tier that fits the matching demand and
        # requeue the overflow (it front-runs the next batch, usually
        # fusing with fresh arrivals)
        self.batch_tiers = tuple(sorted(batch_tiers))
        self._weights = dict(weights) if weights is not None else \
            load_weights(env)
        self._clock = clock
        # _lock guards queue/ledger state only — never held across a
        # dispatch; _dispatch_fn_lock elects the single dispatcher and
        # IS held across the device call (that is the device
        # serialization, not a critical-section smell)
        self._lock = threading.Lock()
        self._dispatch_fn_lock = threading.Lock()
        self._done_cv = threading.Condition()
        self._queues: Dict[str, _TenantQueue] = {}
        self._rotation: List[str] = []
        self._cursor = 0
        self._seq = 0
        self._wire_backlog = 0
        # dispatch-time EWMA (seconds) + fused-occupancy EWMA: the ETA
        # model behind every backpressure hint
        self._ewma_s: Optional[float] = None
        self._occ_ewma: float = 1.0
        self._batches = 0
        self._cross_tenant_batches = 0
        self._fused_requests = 0
        # seconds spent in dispatches (the device call included), summed
        self._dispatch_s = 0.0

    # -- admission ---------------------------------------------------------
    def note_backlog(self, n: int) -> None:
        """The C++ window's queue depth behind the batch being handled —
        folded into queue_depth/ETA hints so clients see the whole line,
        not just the Python-side slice of it."""
        with self._lock:
            self._wire_backlog = max(0, int(n))

    def submit(self, *, key, tenant: str, priority: int = 0,
               deadline: Optional[float] = None, payload=None,
               respond: Callable[[tuple], None]) -> Item:
        """Admission-control one request into its tenant queue.  Always
        returns the Item; when admission shed it (queue full, lowest
        priority loses), the item is already answered with the explicit
        shed response and `pump` will skip it."""
        now = self._clock()
        with self._lock:
            tq = self._queue_for(tenant)
            tq.last_active = now
            self._seq += 1
            item = Item(key, tenant, int(priority), deadline, payload,
                        respond, self._seq, now)
            tq.submitted += 1
            victim = None
            if len(tq.items) >= self.queue_bound:
                lowest = tq.lowest_priority()
                if lowest is not None and lowest.priority < item.priority:
                    # evict the queued lower-priority request to admit
                    # the higher-priority arrival
                    victim = tq.items.pop()
                    tq.insert(item)
                else:
                    victim = item
            else:
                tq.insert(item)
            if victim is not item:
                # count only ADMITTED requests: this family is the
                # fairness denominator, and an over-driving tenant's
                # rejected flood must not inflate its apparent share
                metrics.SERVICE_TENANT_REQUESTS.inc(tenant=tenant)
            shed_resp = None
            if victim is not None:
                shed_resp = self._shed_locked(victim, SHED_ADMISSION)
            self._gc_tenants_locked()
            self._set_depth_gauges_locked()
        if victim is not None:
            self._answer(victim, shed_resp)
        return item

    def _gc_tenants_locked(self) -> None:
        """Bound tenant-state cardinality: connection-derived tenants
        are minted per accept, so a reconnecting undeclared client would
        otherwise grow queues, the rotation, and metric label series
        forever.  Past the cap, idle EMPTY queues go, oldest activity
        first; their gauge series is removed, and a conn-derived
        tenant's counter series too (it can never come back — the next
        connection gets a fresh id)."""
        if len(self._queues) <= TENANT_GC_CAP:
            return
        idle = sorted((tq for tq in self._queues.values()
                       if not tq.items),
                      key=lambda tq: tq.last_active)
        for tq in idle[:len(self._queues) - TENANT_GC_CAP]:
            del self._queues[tq.tenant]
            self._rotation.remove(tq.tenant)
            metrics.SERVICE_TENANT_QUEUE_DEPTH.remove(tenant=tq.tenant)
            if tq.tenant.startswith("conn-"):
                metrics.SERVICE_TENANT_REQUESTS.remove(tenant=tq.tenant)
                for reason in list(tq.shed):
                    metrics.SERVICE_TENANT_SHED.remove(
                        tenant=tq.tenant, reason=reason)
        if self._rotation:
            self._cursor %= len(self._rotation)
        else:
            self._cursor = 0

    def shed_inline(self, tenant: str, reason: str) -> tuple:
        """Build (and count) a shed response for a request the backend
        refuses before queueing — e.g. a frame whose deadline already
        passed at ingest.  Keeps ALL shed accounting in one place."""
        with self._lock:
            tq = self._queue_for(tenant)
            tq.shed[reason] = tq.shed.get(reason, 0) + 1
            metrics.SERVICE_TENANT_SHED.inc(tenant=tenant, reason=reason)
            return ("shed", self._hint_locked(reason=reason, tenant=tenant))

    # -- the pump ----------------------------------------------------------
    def pump(self, items: List[Item],
             dispatch: Callable[[object, List[Item]], List[tuple]]) -> None:
        """Block until every item in `items` is answered.  One caller at
        a time becomes the dispatcher (the device is serial anyway) and
        drains planned batches through `dispatch(key, batch)`, which
        must return one response tuple per batch item; other callers
        wait for their items to come back on someone else's batch."""
        mine = [it for it in items if not it.answered]
        while True:
            if all(it.answered for it in mine):
                return
            if self._dispatch_fn_lock.acquire(timeout=0.05):
                try:
                    self._drain(dispatch)
                finally:
                    self._dispatch_fn_lock.release()
                continue
            # another thread is dispatching (possibly carrying our
            # items in its fused batch): wait for answers, not the lock
            with self._done_cv:
                if not all(it.answered for it in mine):
                    self._done_cv.wait(0.05)

    def _drain(self, dispatch) -> None:
        """Dispatcher role: plan and execute batches until the queues
        are empty.  Caller holds `_dispatch_fn_lock`."""
        while True:
            with self._lock:
                plan = self._plan_locked(self._clock())
            if plan is None:
                return
            key, batch, sheds = plan
            for item, resp in sheds:
                self._answer(item, resp)
            if not batch:
                continue  # the round only shed expired items
            t0 = time.perf_counter()
            try:
                results = dispatch(key, batch)
            except Exception as e:  # noqa: BLE001 — answer, never wedge
                results = [("error", f"dispatch failed: {e}")] * len(batch)
            if len(results) != len(batch):
                results = list(results) + \
                    [("error", "dispatch returned a short result list")] * \
                    (len(batch) - len(results))
            self._note_dispatch(time.perf_counter() - t0, batch)
            for item, resp in zip(batch, results):
                self._answer(item, resp)

    # -- planning (all under self._lock) -----------------------------------
    def _plan_locked(self, now: float):
        """One weighted-DRR round → (key, batch, sheds) or None when
        every queue is empty.  Expired items are shed here — the
        while-queued half of the deadline contract."""
        sheds: List[Tuple[Item, tuple]] = []
        for tq in self._queues.values():
            kept = []
            for item in tq.items:
                if item.deadline is not None and now >= item.deadline:
                    sheds.append((item, self._shed_locked(item, SHED_DEADLINE)))
                else:
                    kept.append(item)
            tq.items = kept
        active = [tq for tq in self._queues.values() if tq.items]
        if not active:
            self._set_depth_gauges_locked()
            return None if not sheds else (None, [], sheds)
        # DRR credit: when every backlogged tenant has spent its credit,
        # start a new round — quantum × weight each, capped so an
        # idle-then-bursty tenant cannot hoard unbounded credit and lock
        # the device for a whole burst.  Crediting per ROUND (not per
        # batch) is what makes weights bite: a weight-3 tenant serves
        # three requests for every one of a weight-1 peer, not merely
        # alternating with it.
        cap = 4.0 * self.quantum
        if not any(tq.deficit >= 1.0 for tq in active):
            for tq in active:
                tq.deficit = min(tq.deficit + self.quantum * tq.weight,
                                 cap * max(tq.weight, 1.0))
        fuse = fuse_enabled()
        seed_tq = self._seed_tenant_locked(active, now)
        seed = seed_tq.pop_matching(None)
        seed_tq.deficit = max(0.0, seed_tq.deficit - 1.0)
        key = seed.key if fuse else None
        batch = [seed]
        if fuse:
            charged = len(active) > 1
            if not charged:
                # single backlogged tenant: fairness is moot, so the
                # deficit gate must not fragment its wide batch (a
                # 64-sim consolidation sweep rides ONE fused call, as
                # it did before the scheduler existed)
                while len(batch) < self.max_fuse:
                    item = seed_tq.pop_matching(key)
                    if item is None:
                        break
                    if item.deadline is not None and now >= item.deadline:
                        sheds.append(
                            (item, self._shed_locked(item, SHED_DEADLINE)))
                        continue
                    batch.append(item)
            else:
                order = self._rotation_from_locked(seed_tq.tenant)
                for tq in order:
                    while tq.deficit >= 1.0 and len(batch) < self.max_fuse:
                        item = tq.pop_matching(key)
                        if item is None:
                            break
                        if item.deadline is not None \
                                and now >= item.deadline:
                            sheds.append(
                                (item, self._shed_locked(item, SHED_DEADLINE)))
                            continue  # shedding is not service: no charge
                        batch.append(item)
                        tq.deficit -= 1.0
                    if len(batch) >= self.max_fuse:
                        break
            # demand-weighted batch sizing: keep the batch whole when
            # its padding waste is small (63 requests ride one
            # 64-padded call), otherwise trim to the largest exact tier
            # and requeue the overflow at its original (priority, seq)
            # position — a 9-item batch ships as 4 now + the rest next
            # round, usually fused with fresh arrivals
            n = len(batch)
            pad_tier = next((t for t in self.batch_tiers if t >= n),
                            self.batch_tiers[-1])
            if n > self.batch_tiers[0] and n < PAD_KEEP_FRACTION * pad_tier:
                allowed = max(t for t in self.batch_tiers if t <= n)
                for item in batch[allowed:]:
                    tq = self._queues[item.tenant]
                    tq.insert(item)
                    if charged:
                        tq.deficit += 1.0  # refund: it was never served
                batch = batch[:allowed]
        for tq in self._queues.values():
            if not tq.items:
                tq.deficit = 0.0  # classic DRR: empty queue keeps no credit
        for item in batch:
            self._queues[item.tenant].dispatched += 1
        self._set_depth_gauges_locked()
        return seed.key, batch, sheds

    def _seed_tenant_locked(self, active: List[_TenantQueue],
                            now: float) -> _TenantQueue:
        """Whose request seeds the next batch: normally the DRR seat —
        the rotation cursor STAYS on a tenant while it has credit and
        backlog, then advances, so service comes in weight-proportional
        runs rather than unweighted alternation.  A deadline about to
        pass (within ~2× the dispatch EWMA) preempts the rotation so
        the pressed request ships in a partial bucket instead of
        expiring behind full ones."""
        slack = max(MIN_DEADLINE_SLACK,
                    2.0 * (self._ewma_s if self._ewma_s else 0.0))
        pressed, pressed_dl = None, None
        for tq in active:
            for item in tq.items:
                if item.deadline is not None and \
                        item.deadline - now <= slack and \
                        (pressed_dl is None or item.deadline < pressed_dl):
                    pressed, pressed_dl = tq, item.deadline
        if pressed is not None:
            return pressed
        names = {tq.tenant for tq in active}
        for _ in range(len(self._rotation)):
            name = self._rotation[self._cursor % len(self._rotation)]
            if name in names and self._queues[name].deficit >= 1.0:
                return self._queues[name]
            self._cursor = (self._cursor + 1) % len(self._rotation)
        return active[0]

    def _rotation_from_locked(self, start: str) -> List[_TenantQueue]:
        names = self._rotation
        if start in names:
            i = names.index(start)
            ordered = names[i:] + names[:i]
        else:
            ordered = list(names)
        return [self._queues[n] for n in ordered if self._queues[n].items]

    def _queue_for(self, tenant: str) -> _TenantQueue:
        tq = self._queues.get(tenant)
        if tq is None:
            tq = _TenantQueue(tenant, self._weights.get(tenant, 1.0))
            self._queues[tenant] = tq
            self._rotation.append(tenant)
        return tq

    # -- accounting / hints ------------------------------------------------
    def _shed_locked(self, item: Item, reason: str) -> tuple:
        tq = self._queue_for(item.tenant)
        tq.shed[reason] = tq.shed.get(reason, 0) + 1
        metrics.SERVICE_TENANT_SHED.inc(tenant=item.tenant, reason=reason)
        return ("shed", self._hint_locked(reason=reason, tenant=item.tenant))

    def _answer(self, item: Item, resp: tuple) -> None:
        if item.answered:
            return
        try:
            item.respond(resp)
        except Exception:  # noqa: BLE001 — answering must never kill the pump
            pass
        item.answered = True
        with self._done_cv:
            self._done_cv.notify_all()

    def _note_dispatch(self, secs: float, batch: List[Item]) -> None:
        with self._lock:
            a = 0.3
            self._ewma_s = secs if self._ewma_s is None else \
                (1 - a) * self._ewma_s + a * secs
            self._occ_ewma = (1 - a) * self._occ_ewma + a * len(batch)
            self._batches += 1
            self._fused_requests += len(batch)
            self._dispatch_s += secs
            cross = len({it.tenant for it in batch}) > 1
            if cross:
                self._cross_tenant_batches += 1
        metrics.SERVICE_FUSED_BATCHES.inc(
            cross_tenant="yes" if cross else "no")
        metrics.SERVICE_FUSED_BATCH_SIZE.observe(len(batch))

    def _depth_locked(self) -> int:
        return sum(len(tq.items) for tq in self._queues.values()) \
            + self._wire_backlog

    def _hint_locked(self, reason: Optional[str] = None,
                     tenant: Optional[str] = None) -> dict:
        depth = self._depth_locked()
        ewma_ms = (self._ewma_s or 0.0) * 1e3
        occ = max(self._occ_ewma, 1.0)
        # batches still ahead of a NEW arrival, each costing ~ewma
        eta_ms = round(ewma_ms * (depth / occ + 1.0), 3)
        hint = {"queue_depth": depth, "eta_ms": eta_ms,
                "retry_after_ms": eta_ms}
        if reason is not None:
            hint["reason"] = reason
        if tenant is not None:
            hint["tenant"] = tenant
        return hint

    def backpressure(self) -> dict:
        """The hint every successful response carries (the backend
        attaches it to each result): current depth incl. the wire
        backlog, and the EWMA-extrapolated ETA for a new arrival."""
        with self._lock:
            return self._hint_locked()

    def _set_depth_gauges_locked(self) -> None:
        for tq in self._queues.values():
            metrics.SERVICE_TENANT_QUEUE_DEPTH.set(
                len(tq.items), tenant=tq.tenant)

    def stats(self) -> dict:
        """Per-tenant + fleet dispatch state for the stats RPC and the
        dashboard merge (snapshot under the queue lock)."""
        with self._lock:
            total = sum(tq.dispatched for tq in self._queues.values())
            tenants = {
                tq.tenant: {
                    "queued": len(tq.items),
                    "weight": tq.weight,
                    "submitted": tq.submitted,
                    "dispatched": tq.dispatched,
                    "shed": dict(tq.shed),
                    "share": round(tq.dispatched / total, 4) if total else 0.0,
                } for tq in self._queues.values()}
            return {
                "fuse": fuse_enabled(),
                "tenants": tenants,
                "queue_depth": self._depth_locked(),
                "batches": self._batches,
                "cross_tenant_batches": self._cross_tenant_batches,
                "fused_requests": self._fused_requests,
                "occupancy_avg": round(
                    self._fused_requests / self._batches, 3)
                if self._batches else 0.0,
                "ewma_dispatch_ms": round((self._ewma_s or 0.0) * 1e3, 3),
                "dispatch_s": round(self._dispatch_s, 6),
            }
