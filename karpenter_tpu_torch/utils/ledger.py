"""Fleet decision ledger + cost/efficiency accounting.

The whole system exists to minimize fleet cost, yet until this module
the objective itself was invisible: the disruption controller computed
per-candidate prices and rejected not-cheaper replacements, and nothing
exported fleet $/hr, savings realized, or how far packing sits from the
allocatable envelope.  Two halves live here:

**The decision ledger** — a flight-recorder-style bounded ring (+ JSONL
spill) of every fleet-mutating decision: provisioning launch,
consolidation delete/replace, drift replacement, expiry, interruption
reclaim, termination.  Each :class:`LedgerRecord` carries the fleet
$/hr before and after the decision, the decision's own cost delta (the
exact floats the controller compared — ``cost_delta_hex`` is the
IEEE-754 form the acceptance checks diff), affected node/pod counts, a
reason CODE from the `solver/explain.py` registry (never a bare
string), and trace-id + flight-recorder-seq cross links so a ledger
row jumps to its solve record and span tree.

**Fleet cost & packing telemetry** — :func:`update_fleet_metrics`
prices every live node through the pricing provider and refreshes:

  * ``karpenter_tpu_fleet_hourly_cost{pool,capacity_type}``
  * ``karpenter_tpu_packing_efficiency_ratio{pool,resource}`` (and the
    fleet-wide variant) — requested vs allocatable
  * ``karpenter_tpu_stranded_capacity_units{pool,resource}``
  * ``karpenter_tpu_fleet_efficiency_lower_bound_ratio`` — actual spend
    vs a CHEAP greedy bound (total pod requests priced at the cheapest
    feasible $/resource-unit in the catalog).  Documented as the bound
    the future relaxed-LP scoring replaces; it ignores bin-packing
    integrality, so real optimal cost sits between bound and actual.

Knobs (env, all parsed HERE — the knob-registry single-owner rule):

  KARPENTER_TPU_LEDGER=off|0        disable the ledger (default: on —
                                    records are written per controller
                                    DECISION, not per solve, so the
                                    steady-state cost is zero)
  KARPENTER_TPU_LEDGER_BUFFER=N     ring size (default 512 records)
  KARPENTER_TPU_LEDGER_DIR=<dir>    spill each record as one JSONL line
                                    to <dir>/ledger-<pid>.jsonl (the
                                    durable spend trail a crashed
                                    process leaves behind)

The port's copy of `karpenter_tpu/utils/ledger.py`: the same knobs,
defaults, record fields and price arithmetic, so one decision gives the
same record (and the same IEEE-hex fleet $/hr) in both packages.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from karpenter_tpu_torch.utils import metrics

_ENV_GATE = "KARPENTER_TPU_LEDGER"
_ENV_BUFFER = "KARPENTER_TPU_LEDGER_BUFFER"
_ENV_DIR = "KARPENTER_TPU_LEDGER_DIR"

# the decision-source vocabulary (the `source` label of
# karpenter_tpu_ledger_records_total and every record's `source` field)
SOURCES = ("provisioning", "disruption", "drift", "expiration",
           "interruption", "termination", "preemption")


def ledger_enabled() -> bool:
    """On unless explicitly disabled — the ledger is the spend black
    box, and a record costs microseconds per controller decision."""
    from karpenter_tpu_torch.utils.knobs import env_bool
    return env_bool(_ENV_GATE, default=True)


class LedgerRecord:
    __slots__ = ("seq", "ts", "pid", "source", "action", "reason_code",
                 "detail", "pools", "capacity_types", "nodes_delta",
                 "pods_affected", "fleet_cost_before", "fleet_cost_after",
                 "cost_delta", "cost_delta_hex", "trace_id", "flight_seq")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.get(name))

    def to_dict(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


class Ledger:
    """Bounded ring + optional JSONL spill; one per process
    (module-level LEDGER).  Thread-safe — controllers write from the
    reconcile loop, the operator's HTTP thread reads tails."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self._buffer_size())
        self._seq = 0
        self._spill = None          # (path, file handle) once opened
        self._spill_failed = False  # one degrade, then best-effort off

    @staticmethod
    def _buffer_size() -> int:
        try:
            return max(1, int(os.environ.get(_ENV_BUFFER, "512")))
        except ValueError:
            return 512

    @property
    def enabled(self) -> bool:
        return ledger_enabled()

    def record(self, source: str, action: str, *,
               reason_code: str = "", detail: str = "",
               pools=(), capacity_types=(),
               nodes_delta: int = 0, pods_affected: int = 0,
               fleet_cost_before: Optional[float] = None,
               cost_delta: float = 0.0) -> Optional[LedgerRecord]:
        """One fleet-mutating decision.  ``cost_delta`` is the
        decision's OWN price arithmetic (the exact floats the
        controller compared: new-claim prices, retired-candidate
        prices), never a re-derived estimate — ``cost_delta_hex``
        preserves it bit-for-bit for the exactness checks.  The fleet
        $/hr before is the caller's independent sum over live nodes
        (:func:`fleet_cost`); after = before + delta."""
        if not self.enabled:
            return None
        assert source in SOURCES, source
        from karpenter_tpu_torch.utils import flightrecorder, tracing
        after = (None if fleet_cost_before is None
                 else fleet_cost_before + cost_delta)
        with self._lock:
            self._seq += 1
            rec = LedgerRecord(
                # capture-side provenance stamp: the hex-chain check
                # and the harness's ledger digest exclude ts/pid
                seq=self._seq, ts=time.time(), pid=os.getpid(),
                source=source, action=action, reason_code=reason_code,
                detail=detail, pools=sorted(set(pools)),
                capacity_types=sorted(set(capacity_types)),
                nodes_delta=nodes_delta, pods_affected=pods_affected,
                fleet_cost_before=fleet_cost_before,
                fleet_cost_after=after, cost_delta=cost_delta,
                cost_delta_hex=float(cost_delta).hex(),
                trace_id=tracing.current_trace_id(),
                flight_seq=flightrecorder.RECORDER.last_seq())
            self._ring.append(rec)
        metrics.LEDGER_RECORDS.inc(source=source)
        self._maybe_spill(rec)
        return rec

    def _maybe_spill(self, rec: LedgerRecord) -> None:
        d = os.environ.get(_ENV_DIR)
        if not d or self._spill_failed:
            return
        line = json.dumps(rec.to_dict(), default=str)
        try:
            with self._lock:
                path = os.path.join(d, f"ledger-{os.getpid()}.jsonl")
                if self._spill is None or self._spill[0] != path:
                    os.makedirs(d, exist_ok=True)
                    if self._spill is not None:
                        self._spill[1].close()
                    self._spill = (path, open(path, "a", encoding="utf-8"))
                f = self._spill[1]
                f.write(line + "\n")
                f.flush()
        except OSError:
            # spill is best-effort: a full disk degrades the spend
            # trail to ring-only, never fails a reconcile pass — but
            # counted: a lost trail tail must be visible
            metrics.SPILL_DEGRADED.inc(recorder="ledger")
            self._spill_failed = True

    def tail(self, n: int = 64, pool: Optional[str] = None,
             since: Optional[float] = None) -> List[dict]:
        """Newest-last record dicts; ``pool`` keeps records touching
        that nodepool, ``since`` keeps records with ts >= it."""
        if n <= 0:
            return []  # recs[-0:] would be the whole ring, not nothing
        with self._lock:
            recs = list(self._ring)
        if pool is not None:
            recs = [r for r in recs if pool in (r.pools or ())]
        if since is not None:
            recs = [r for r in recs if r.ts >= since]
        return [r.to_dict() for r in recs[-n:]]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def last_seq(self) -> Optional[int]:
        """Newest row's sequence number, or None while empty — the
        cross-link the timeline recorder stamps so a timeline event
        jumps to the ledger row of the decision that preceded it
        (mirror of FlightRecorder.last_seq)."""
        with self._lock:
            return self._seq if self._seq else None

    def reset(self) -> None:
        """Clear the ring and close any spill handle (tests)."""
        with self._lock:
            self._ring = deque(maxlen=self._buffer_size())
            self._seq = 0
            if self._spill is not None:
                try:
                    self._spill[1].close()
                except OSError:
                    pass
            self._spill = None
            self._spill_failed = False


LEDGER = Ledger()


def ensure_buffer(n: int) -> None:
    """Widen the module ledger's ring to hold at least `n` rows unless
    the caller already pinned KARPENTER_TPU_LEDGER_BUFFER — the
    owner-module seam for the rewind engine, whose hex-exact trajectory
    judge must see EVERY row of a replay (the default 512-row ring
    silently evicts a long day's head)."""
    if _ENV_BUFFER not in os.environ:
        os.environ[_ENV_BUFFER] = str(int(n))
        LEDGER.reset()


def load_records(path: str) -> List[dict]:
    """Parse one spilled ledger-<pid>.jsonl — or stitch every
    ledger-*.jsonl under a directory in (mtime, name) order; delegates
    to the flight recorder's torn-line-tolerant loader so the two
    spill formats can never drift in parse behavior (shared code path,
    multi-spill restart stitching included)."""
    from karpenter_tpu_torch.utils import flightrecorder
    return flightrecorder.load_records(path, prefix="ledger")


def summarize(records: List[dict]) -> dict:
    """Spend/savings rollup over record dicts — the one rollup every
    surface that reports the ledger uses, so no two of them can
    disagree about the same records.

    Termination records are EXCLUDED from the savings/spend headline:
    termination is the mechanical settlement of an earlier
    delete/replace decision (consolidation, expiry, interruption), and
    counting both the decision's −$ and the release's −$ would double
    every saved dollar.  They still appear in by_source and the record
    table — the settlement trail matters, just not twice."""
    by_source: Dict[str, int] = {}
    savings = 0.0
    spend_added = 0.0
    last = None
    for r in records:
        src = r.get("source", "?")
        by_source[src] = by_source.get(src, 0) + 1
        delta = r.get("cost_delta") or 0.0
        if isinstance(delta, (int, float)) and src != "termination":
            if delta < 0:
                savings += -delta
            else:
                spend_added += delta
        last = r
    out = {
        "records": len(records),
        "by_source": by_source,
        "savings_dollars_per_hr": round(savings, 6),
        "spend_added_dollars_per_hr": round(spend_added, 6),
    }
    if last is not None and last.get("fleet_cost_after") is not None:
        out["fleet_cost_after_last_decision"] = last["fleet_cost_after"]
    return out


def record_claim_delete(cluster, cp, claim, *, source: str,
                        reason_code: str, detail: str,
                        node=None, price: Optional[float] = None,
                        fleet_before: Optional[float] = None,
                        pods_affected: Optional[int] = None,
                        pass_cache: Optional[dict] = None
                        ) -> Optional[LedgerRecord]:
    """The ONE delete-decision recorder shared by every claim-deleting
    controller (expiration, interruption, termination): same pricing
    resolution, same non-daemonset pod count, same −price delta — a
    schema change lands once, not three drifting times.

    The optional precomputed arguments exist for the hot callers: a
    mass spot reclaim deletes hundreds of claims in ONE reconcile, and
    re-walking the whole fleet per record (`fleet_cost` is O(nodes),
    the pod count O(pods)) would make that drain O(deleted × fleet) —
    the interruption controller computes the fleet sum once per drain
    and advances it incrementally by each record's own delta.
    `pass_cache` (an empty dict the caller resets per reconcile/drain)
    amortizes the pod count the same way: ONE pods walk per pass
    indexed by node, not one per deleted claim."""
    if not LEDGER.enabled:
        return None
    pricing = getattr(getattr(cp, "instance_types", None),
                      "pricing", None)
    if node is None:
        node = cluster.node_for_claim(claim)
    if price is None:
        price = node_price(node, pricing) if node is not None else 0.0
    if pods_affected is None:
        if pass_cache is not None:
            counts = pass_cache.get("pods_by_node")
            if counts is None:
                counts = {}
                for p in cluster.pods.list():
                    if p.node_name and not p.is_daemonset:
                        counts[p.node_name] = counts.get(p.node_name,
                                                         0) + 1
                pass_cache["pods_by_node"] = counts
            pods_affected = (counts.get(node.name, 0)
                             if node is not None else 0)
        else:
            pods_affected = (len([p for p in
                                  cluster.pods_on_node(node.name)
                                  if not p.is_daemonset])
                             if node is not None else 0)
    if fleet_before is None:
        fleet_before = fleet_cost(cluster, pricing)["total"]
    ct = node.capacity_type if node is not None else None
    return LEDGER.record(
        source, "delete", reason_code=reason_code, detail=detail,
        pools=[claim.nodepool], capacity_types=[ct] if ct else (),
        nodes_delta=-1, pods_affected=pods_affected,
        fleet_cost_before=fleet_before, cost_delta=-price)


# -- fleet cost & packing accounting --------------------------------------
def node_price(node, pricing) -> float:
    """One live node's $/hr from its offering labels; 0.0 when the
    labels or the price are missing (an unlabeled node is free in the
    ledger rather than poisoning the sum — same posture as the
    disruption controller's `_node_price`)."""
    itype, zone, ct = node.instance_type, node.zone, node.capacity_type
    if itype and zone and ct and pricing is not None:
        p = pricing.price(itype, zone, ct)
        if p is not None:
            return p
    return 0.0


def fleet_cost(cluster, pricing) -> dict:
    """The independent sum over the cluster's live nodes: total $/hr
    plus the (pool, capacity_type) breakdown the hourly-cost gauge
    exports.  This is the cross-check surface — a ledger record's
    before/after must reconcile against exactly this sum."""
    total = 0.0
    by_key: Dict[tuple, float] = {}
    for node in cluster.nodes.list(lambda n: not n.meta.deleting):
        p = node_price(node, pricing)
        total += p
        key = (node.nodepool or "", node.capacity_type or "")
        by_key[key] = by_key.get(key, 0.0) + p
    return {"total": total, "by_pool": by_key}


# previously-exported gauge series, so vanished pools/resources drop
# their series on refresh instead of reporting stale values forever
_prev_series: Dict[str, set] = {"cost": set(), "pack": set(),
                                "fleet_pack": set(), "stranded": set()}
_series_lock = threading.Lock()


def _cheapest_unit_prices(cluster, cp) -> Dict[int, float]:
    """min over purchasable offerings of $/(resource unit), per resource
    axis index — the greedy lower bound's price vector.  O(types) per
    refresh against the provider's cached type lists."""
    best: Dict[int, float] = {}
    for pool in cluster.nodepools.list(lambda p: not p.meta.deleting):
        try:
            types = cp.get_instance_types(pool.node_class_ref)
        except Exception:  # noqa: BLE001 — discovery outage: skip pool
            continue
        for it in types:
            price = None
            for off in it.offerings:
                if off.available and (price is None or off.price < price):
                    price = off.price
            if price is None:
                continue
            for ri in range(len(it.capacity.v)):
                cap = it.capacity.v[ri]
                if cap <= 0:
                    continue
                unit = price / cap
                if ri not in best or unit < best[ri]:
                    best[ri] = unit
    return best


def update_fleet_metrics(cluster, cp, pricing=None) -> dict:
    """Refresh every cost/efficiency gauge from live cluster state and
    return the summary dict (the `fleet.cost` seed).  Called each
    provisioning pass; O(nodes + pods + types) with dict-lookup
    pricing.  Best-effort — a pricing outage degrades the gauges,
    never the reconcile loop."""
    from karpenter_tpu_torch.models.resources import RESOURCE_AXIS
    pricing = pricing if pricing is not None \
        else getattr(getattr(cp, "instance_types", None), "pricing", None)
    cost = fleet_cost(cluster, pricing)

    # fleet expected-interruption cost: Σ p × price over live
    # spot nodes under the risk model — 0 with the knob off, so the
    # gauge always reports and a knob flip shows as a step to/from zero
    from karpenter_tpu_torch.utils.knobs import spot_risk_enabled
    risk_total = 0.0
    if spot_risk_enabled():
        from karpenter_tpu_torch.scheduling import risk as riskmod
        for node in cluster.nodes.list(lambda n: not n.meta.deleting):
            risk_total += riskmod.expected_interruption_cost(
                node_price(node, pricing), node.instance_type or "",
                node.zone or "", node.capacity_type or "")
    metrics.SPOT_RISK_COST.set(risk_total)

    # spend by (pool, capacity_type), stale series removed
    new_cost_keys = set()
    for (pool, ct), dollars in cost["by_pool"].items():
        metrics.FLEET_HOURLY_COST.set(dollars, pool=pool,
                                      capacity_type=ct)
        new_cost_keys.add((pool, ct))
    with _series_lock:
        for pool, ct in sorted(_prev_series["cost"] - new_cost_keys):
            metrics.FLEET_HOURLY_COST.remove(pool=pool, capacity_type=ct)
        _prev_series["cost"] = new_cost_keys

    # packing efficiency + stranded capacity: requested vs allocatable.
    # One pass over nodes + one over pods (pods grouped by node name),
    # never pods_on_node per node — that is O(nodes x pods) and this
    # refresh runs every reconcile pass
    R = len(RESOURCE_AXIS)
    alloc_by_pool: Dict[str, List[float]] = {}
    req_by_pool: Dict[str, List[float]] = {}
    total_req = [0.0] * R
    total_alloc = [0.0] * R
    pool_of_node: Dict[str, str] = {}
    for node in cluster.nodes.list(lambda n: not n.meta.deleting):
        pool = node.nodepool or ""
        pool_of_node[node.name] = pool
        a = alloc_by_pool.setdefault(pool, [0.0] * R)
        req_by_pool.setdefault(pool, [0.0] * R)
        for ri in range(R):
            v = node.allocatable.v[ri]
            a[ri] += v
            total_alloc[ri] += v
    for pod in cluster.pods.list():
        pool = pool_of_node.get(pod.node_name) \
            if pod.node_name is not None else None
        if pool is None:
            continue
        q = req_by_pool[pool]
        for ri in range(R):
            v = pod.requests.v[ri]
            q[ri] += v
            total_req[ri] += v
    new_pack, new_stranded = set(), set()
    for pool, alloc in alloc_by_pool.items():
        req = req_by_pool[pool]
        for ri, name in enumerate(RESOURCE_AXIS):
            if alloc[ri] <= 0:
                continue
            metrics.PACKING_EFFICIENCY.set(
                round(req[ri] / alloc[ri], 6), pool=pool, resource=name)
            metrics.STRANDED_CAPACITY.set(
                round(alloc[ri] - req[ri], 3), pool=pool, resource=name)
            new_pack.add((pool, name))
            new_stranded.add((pool, name))
    new_fleet_pack = set()
    efficiency = {}
    for ri, name in enumerate(RESOURCE_AXIS):
        if total_alloc[ri] <= 0:
            continue
        ratio = round(total_req[ri] / total_alloc[ri], 6)
        metrics.FLEET_PACKING_EFFICIENCY.set(ratio, resource=name)
        new_fleet_pack.add((name,))
        efficiency[name] = ratio
    with _series_lock:
        for pool, name in sorted(_prev_series["pack"] - new_pack):
            metrics.PACKING_EFFICIENCY.remove(pool=pool, resource=name)
        for pool, name in sorted(_prev_series["stranded"] - new_stranded):
            metrics.STRANDED_CAPACITY.remove(pool=pool, resource=name)
        for (name,) in sorted(_prev_series["fleet_pack"] - new_fleet_pack):
            metrics.FLEET_PACKING_EFFICIENCY.remove(resource=name)
        _prev_series["pack"] = new_pack
        _prev_series["stranded"] = new_stranded
        _prev_series["fleet_pack"] = new_fleet_pack

    # greedy lower bound: total requests priced at the cheapest feasible
    # $/unit, per resource; the binding resource's cost is the bound.
    # Uncomputable (no spend, or no priced requests) removes the series
    # — the same no-stale-values discipline as every gauge above
    bound = None
    if cost["total"] > 0:
        units = _cheapest_unit_prices(cluster, cp)
        floors = [total_req[ri] * unit for ri, unit in units.items()
                  if total_req[ri] > 0]
        if floors:
            bound = max(floors)
            metrics.FLEET_EFFICIENCY_BOUND.set(
                round(min(1.0, bound / cost["total"]), 6))
    if bound is None:
        metrics.FLEET_EFFICIENCY_BOUND.remove()
    return {
        "hourly_cost_total": round(cost["total"], 6),
        "hourly_cost_by_pool": {
            f"{pool}/{ct}": round(v, 6)
            for (pool, ct), v in sorted(cost["by_pool"].items())},
        "packing_efficiency": efficiency,
        "greedy_lower_bound": None if bound is None else round(bound, 6),
    }
