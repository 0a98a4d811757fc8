"""Fleet telemetry aggregation.

The control plane is several processes — operator replicas, the solverd
supervisor, the solver worker — each with its own metrics registry
and flight-recorder ring.  This module is the merge point: every process
can produce a compact `local_snapshot()` of its observable state, other
in-process components (the supervisor) register themselves as snapshot
*sources*, the solverd worker's snapshot arrives through the stats RPC,
and `merge()` folds them into the ONE view `GET /debug/dashboard`
serves: solve rate, p50/p99 phase latencies, delta hit/fallback split,
queue depth, shed/retry/breaker/restart state, and the flight-recorder
tail — the aggregated-view half of the request-record + aggregated-view
split (the flight recorder is the request-record half).

Everything here is read-only over the metrics registry and best-effort:
a dashboard render must never throw into the operator's HTTP thread.

The port's copy of `karpenter_tpu/utils/telemetry.py`.  The operator's
routes that serve it (`/debug/dashboard` and the pages `html_page`
renders) are still to port, with the operator itself.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

from karpenter_tpu_torch.utils import metrics

_lock = threading.Lock()
_sources: Dict[str, Callable[[], dict]] = {}
# solve-rate window: (monotonic ts, total solves) of the previous
# snapshot, so successive dashboard scrapes see a rate, not a total
_rate_state = {"ts": None, "total": None}


def register_source(name: str, fn: Callable[[], dict]) -> None:
    """Register an in-process snapshot source (the solverd supervisor
    registers its restart/liveness state here on start()).  Last
    registration per name wins — a restarted component replaces its
    predecessor."""
    with _lock:
        _sources[name] = fn


def unregister_source(name: str, fn: Optional[Callable] = None) -> None:
    """Remove a source; with `fn` given, only when it is still the
    registered callable — a stopped component must not evict the
    replacement that took its name."""
    with _lock:
        if fn is None or _sources.get(name) is fn:
            _sources.pop(name, None)


def _series(metric) -> dict:
    """A labeled metric's samples as {label-values-joined: value};
    unlabeled metrics map the empty key.  Snapshot under the metric's
    own lock: a solve thread registering a first-time label key resizes
    the dict, and an unlocked iteration here would raise into the
    dashboard's HTTP thread."""
    vals = getattr(metric, "_values", None)
    if vals is None:
        return {}
    with metric._lock:
        items = sorted(vals.items())
    return {"/".join(k) if k else "": v for k, v in items}


def _quantile_upper(buckets, counts, total: int, q: float) -> float:
    """Histogram quantile as the upper bound of the first bucket whose
    cumulative count reaches q·total — the standard conservative read of
    a Prometheus-style histogram (exact values are gone; the bound is
    what dashboards alert on)."""
    need = q * total
    for b, c in zip(buckets, counts):
        if c >= need:
            return b
    return float("inf")


def phase_latency_summary() -> dict:
    """{phase/path: {count, p50_ms, p99_ms}} from the solver phase
    histogram — the per-request spans aggregated into the fleet view."""
    h = metrics.SOLVER_PHASE_DURATION
    out = {}
    with h._lock:  # same snapshot discipline as _series
        totals = sorted(h._totals.items())
        all_counts = {k: list(v) for k, v in h._counts.items()}
    for key, total in totals:
        counts = all_counts.get(key, [])
        out["/".join(key)] = {
            "count": total,
            "p50_ms": round(
                _quantile_upper(h.buckets, counts, total, 0.50) * 1e3, 3),
            "p99_ms": round(
                _quantile_upper(h.buckets, counts, total, 0.99) * 1e3, 3),
        }
    return out


def _explain_store_size() -> int:
    """Pods currently held by the explain store — guarded: telemetry
    must render even if the solver package is unimportable here."""
    try:
        from karpenter_tpu_torch.solver import explain
        return explain.STORE.size()
    except Exception:  # noqa: BLE001 — best-effort, never the data path
        return 0


def _cost_section(ledger_tail: int = 8) -> dict:
    """This process's cost/efficiency observables (utils/ledger.py +
    the cost metric families), read-only over the registry."""
    try:
        from karpenter_tpu_torch.utils import ledger
        tail = ledger.LEDGER.tail(ledger_tail)
    except Exception:  # noqa: BLE001 — best-effort, never the data path
        tail = []
    return {
        "fleet_hourly_cost": _series(metrics.FLEET_HOURLY_COST),
        "savings": _series(metrics.DISRUPTION_SAVINGS),
        "packing_efficiency": _series(metrics.FLEET_PACKING_EFFICIENCY),
        "stranded": _series(metrics.STRANDED_CAPACITY),
        "efficiency_lower_bound": metrics.FLEET_EFFICIENCY_BOUND.value(),
        "ledger_records": _series(metrics.LEDGER_RECORDS),
        "audit": _series(metrics.SOLVER_AUDIT),
        "ledger_tail": tail,
    }


def _timeline_section(tail: int = 8) -> dict:
    """This process's cluster-timeline observables (timeline/
    recorder.py): the per-kind event counters plus a short tail with
    trace/flight/ledger cross-links intact."""
    try:
        from karpenter_tpu_torch import timeline
        return {
            "events": _series(metrics.TIMELINE_EVENTS),
            "last_seq": timeline.RECORDER.last_seq(),
            "tail": timeline.RECORDER.tail(tail),
        }
    except Exception:  # noqa: BLE001 — best-effort, never the data path
        return {"events": {}, "last_seq": None, "tail": []}


def local_snapshot(flight_tail: int = 16) -> dict:
    """This process's observable state: the compact dict every process
    role (operator, solverd backend, supervisor CLI) can produce and the
    dashboard merges."""
    from karpenter_tpu_torch.utils import flightrecorder, tracing  # noqa: F401
    solves = _series(metrics.SOLVER_SOLVES)
    total = sum(solves.values())
    now = time.monotonic()
    rate = None
    with _lock:
        if _rate_state["ts"] is not None and now > _rate_state["ts"]:
            rate = max(0.0, (total - _rate_state["total"])
                       / (now - _rate_state["ts"]))
        _rate_state["ts"], _rate_state["total"] = now, total
    return {
        "ts": time.time(),
        "pid": os.getpid(),
        "queue_depth": metrics.SCHEDULING_QUEUE_DEPTH.value(),
        "solves": solves,
        "solves_total": total,
        "solve_rate_per_s": None if rate is None else round(rate, 3),
        "phase_latency_ms": phase_latency_summary(),
        "delta": {
            "passes": _series(metrics.SOLVER_DELTA_PASSES),
            "groups_reencoded":
                metrics.SOLVER_DELTA_GROUPS_REENCODED.value(),
            # event-driven incremental index: index-resolved
            # vs walk-resolved grouping passes, same counted discipline
            "incr_passes": _series(metrics.SOLVER_INCR_PASSES),
        },
        "service": {
            "retries": metrics.SERVICE_RETRIES.value(),
            "breaker_state": metrics.SERVICE_BREAKER_STATE.value(),
            "worker_restarts": metrics.SERVICE_WORKER_RESTARTS.value(),
        },
        # multi-tenant dispatch: per-tenant demand/queues/
        # sheds and the cross-tenant fusion counters — in the solverd
        # worker these are the live series; in other processes they stay
        # empty dicts and merge() skips them
        "tenants": {
            "queue_depth": _series(metrics.SERVICE_TENANT_QUEUE_DEPTH),
            "requests": _series(metrics.SERVICE_TENANT_REQUESTS),
            "shed": _series(metrics.SERVICE_TENANT_SHED),
            "fused_batches": _series(metrics.SERVICE_FUSED_BATCHES),
        },
        # placement provenance: per-reason unschedulable
        # verdicts, per-constraint elimination attribution, and the
        # explain store's reach — in the solverd worker the elimination
        # series is the live one (it rides the stats RPC to the
        # operator's dashboard merge); the verdict counter lives where
        # provisioning runs
        "placement": {
            "unschedulable": _series(metrics.UNSCHEDULABLE_PODS),
            "eliminations": _series(metrics.SOLVER_CONSTRAINT_ELIM),
            "explained_pods": _explain_store_size(),
        },
        # cost & efficiency: fleet spend, savings realized,
        # packing efficiency, the shadow-audit verdicts, and the
        # decision-ledger tail — the gauges live where the controllers
        # run (the operator); other process roles carry empty series and
        # merge() skips them.  Guarded like the explain-store read: a
        # telemetry snapshot must render even if the ledger module is
        # unimportable here.
        "cost": _cost_section(),
        "retraces": sum(_series(metrics.SOLVER_RETRACES).values()),
        "device_memory_peak_bytes":
            metrics.SOLVER_DEVICE_MEMORY_PEAK.value(),
        "donated_slots_in_use": metrics.SOLVER_DONATED_SLOTS.value(),
        "spans_dropped": metrics.TRACE_SPANS_DROPPED.value(),
        "flight_records": _series(metrics.FLIGHT_RECORDS),
        "flight_tail": flightrecorder.RECORDER.tail(flight_tail),
        "timeline": _timeline_section(),
    }


def collect(extra: Optional[Dict[str, Callable[[], dict]]] = None,
            flight_tail: int = 16) -> dict:
    """Gather every reachable snapshot — this process, every registered
    source (supervisor), and the caller's extra sources (the operator
    passes one that runs the solverd stats RPC) — then merge.  A source
    that throws becomes {"error": ...}: diagnostics must keep rendering
    exactly when part of the fleet is down."""
    try:
        snaps: Dict[str, dict] = {
            "operator": local_snapshot(flight_tail=flight_tail)}
    except Exception as e:  # noqa: BLE001 — the contract is absolute
        snaps = {"operator": {"error": str(e)[:200]}}
    with _lock:
        named = list(_sources.items())
    if extra:
        named += list(extra.items())
    for name, fn in named:
        try:
            snap = fn()
        except Exception as e:  # noqa: BLE001 — render what IS reachable
            snap = {"error": str(e)[:200]}
        if snap is not None:
            snaps[name] = snap
    return merge(snaps)


def merge(snapshots: Dict[str, dict]) -> dict:
    """Fold named per-process snapshots into one dashboard document:
    the raw per-process sections stay under `processes`, and the `fleet`
    rollup answers the operator's first-glance questions (is work
    flowing, is anything shedding/restarting/breaker-open, is the delta
    path engaged)."""
    def num(snap, *path, default=0.0):
        cur = snap
        for p in path:
            if not isinstance(cur, dict):
                return default
            cur = cur.get(p)
        return cur if isinstance(cur, (int, float)) else default

    fleet = {
        "queue_depth": sum(num(s, "queue_depth")
                           for s in snapshots.values()),
        "solves_total": sum(num(s, "solves_total")
                            for s in snapshots.values()),
        "shed": sum(max(num(s, "stats", "shed"), num(s, "shed"))
                    for s in snapshots.values()),
        "worker_restarts": max(
            (max(num(s, "service", "worker_restarts"),
                 num(s, "restarts")) for s in snapshots.values()),
            default=0.0),
        "breaker_state": max(
            (num(s, "service", "breaker_state")
             for s in snapshots.values()), default=0.0),
        "retries": sum(num(s, "service", "retries")
                       for s in snapshots.values()),
        "delta_passes": {},
        # the last-pass churn actually paid for, summed across
        # processes: with the index engaged this tracks the
        # dirty set, not the cluster — the first-glance O(churn) check
        "delta_groups_reencoded": sum(
            num(s, "delta", "groups_reencoded")
            for s in snapshots.values()),
        "spans_dropped": sum(num(s, "spans_dropped")
                             for s in snapshots.values()),
    }
    for s in snapshots.values():
        passes = s.get("delta", {}).get("passes") \
            if isinstance(s.get("delta"), dict) else None
        if isinstance(passes, dict):
            for k, v in passes.items():
                fleet["delta_passes"][k] = \
                    fleet["delta_passes"].get(k, 0) + v
    def items_of(sect, field):
        """A section field's dict items, or nothing — a partially
        written or foreign-schema snapshot (a worker one version
        behind) must degrade per FIELD, never raise into the
        dashboard's HTTP thread."""
        v = sect.get(field)
        return v.items() if isinstance(v, dict) else ()

    # placement rollup: per-reason unschedulable verdicts and the
    # per-constraint elimination attribution summed across processes
    # (the solverd worker's eliminations arrive via the stats RPC)
    placement = {"unschedulable": {}, "eliminations": {}}
    for s in snapshots.values():
        sect = s.get("placement")
        if not isinstance(sect, dict):
            continue
        for field in ("unschedulable", "eliminations"):
            for k, v in items_of(sect, field):
                if isinstance(v, (int, float)):
                    placement[field][k] = placement[field].get(k, 0) + v
    if placement["unschedulable"] or placement["eliminations"]:
        fleet["placement"] = placement
    # per-tenant rollup (the shared-fleet first-glance questions: who is
    # queued, who is being shed, what share of service each tenant got):
    # requests/sheds sum across processes; the fairness share normalizes
    # against the fleet total
    tenants: Dict[str, dict] = {}
    for s in snapshots.values():
        sect = s.get("tenants")
        if not isinstance(sect, dict):
            continue
        for t, v in items_of(sect, "requests"):
            if not isinstance(v, (int, float)):
                continue
            tenants.setdefault(t, {"requests": 0, "shed": 0,
                                   "queue_depth": 0})
            tenants[t]["requests"] += v
        for t, v in items_of(sect, "queue_depth"):
            if not isinstance(v, (int, float)):
                continue
            tenants.setdefault(t, {"requests": 0, "shed": 0,
                                   "queue_depth": 0})
            tenants[t]["queue_depth"] += v
        for key, v in items_of(sect, "shed"):
            if not isinstance(v, (int, float)):
                continue
            # label key is "tenant/reason" — reason never contains "/"
            t = key.rsplit("/", 1)[0]
            tenants.setdefault(t, {"requests": 0, "shed": 0,
                                   "queue_depth": 0})
            tenants[t]["shed"] += v
    total_req = sum(v["requests"] for v in tenants.values())
    for v in tenants.values():
        v["share"] = round(v["requests"] / total_req, 4) if total_req \
            else 0.0
    if tenants:
        fleet["tenants"] = tenants
    # cost & efficiency rollup: fleet $/hr and savings summed
    # across processes (only the controller-running operator carries
    # non-empty series, so the sum IS its view; a worker's empty section
    # adds nothing), audit verdicts summed, the lower-bound ratio the
    # max across reporters, packing efficiency the min (worst view).
    # Every read degrades per-field — a partial
    # or foreign-schema section must never break the dashboard.
    cost = {"hourly_total": 0.0, "hourly_by_pool": {}, "savings": {},
            "audit": {}, "packing_efficiency": {},
            "efficiency_lower_bound": None}
    cost_present = False
    for s in snapshots.values():
        sect = s.get("cost") if isinstance(s, dict) else None
        if not isinstance(sect, dict):
            continue
        cost_present = True
        for field, dest in (("fleet_hourly_cost", "hourly_by_pool"),
                            ("savings", "savings"),
                            ("audit", "audit")):
            src = sect.get(field)
            if not isinstance(src, dict):
                continue
            for k, v in src.items():
                if isinstance(v, (int, float)):
                    cost[dest][k] = cost[dest].get(k, 0) + v
        pe = sect.get("packing_efficiency")
        if isinstance(pe, dict):
            # ratios can't sum: take the MIN per resource — the
            # conservative (worst-packing) view, and deterministic when
            # two snapshots carry the same series (HA pair mid-failover,
            # stale worker), unlike last-writer-wins over dict order
            for k, v in pe.items():
                if isinstance(v, (int, float)):
                    cur = cost["packing_efficiency"].get(k)
                    cost["packing_efficiency"][k] = \
                        v if cur is None else min(cur, v)
        b = sect.get("efficiency_lower_bound")
        if isinstance(b, (int, float)) and b > 0:
            cur = cost["efficiency_lower_bound"]
            cost["efficiency_lower_bound"] = \
                b if cur is None else max(cur, b)
    if cost_present:
        cost["hourly_total"] = round(
            sum(cost["hourly_by_pool"].values()), 6)
        fleet["cost"] = cost
    return {"generated_at": time.time(),
            "processes": snapshots,
            "fleet": fleet}


# the ONE Content-Type every html-rendering debug route serves — the
# hand-rolled renderers used to each spell their own
HTML_CONTENT_TYPE = "text/html; charset=utf-8"


def _html_table(payload) -> str:
    """One escaped table: a dict renders as key/value rows; a list of
    flat dicts renders columnar (column set = union of keys in first-
    appearance order).  Non-scalar cells render as compact JSON —
    every cell value passes through html.escape (hostile reasons,
    zones, or pod names must never break the page)."""
    import html as _html
    import json as _json

    def cell(v) -> str:
        if isinstance(v, str):
            return _html.escape(v)
        return _html.escape(_json.dumps(v, default=str))

    if isinstance(payload, dict):
        rows = "".join(
            f"<tr><td>{cell(str(k))}</td><td>{cell(v)}</td></tr>"
            for k, v in sorted(payload.items(), key=lambda kv: str(kv[0])))
        return f"<table>{rows}</table>"
    cols: list = []
    for row in payload:
        for k in row:
            if k not in cols:
                cols.append(k)
    head = "".join(f"<th>{cell(str(c))}</th>" for c in cols)
    body = "".join(
        "<tr>" + "".join(f"<td>{cell(row.get(c, ''))}</td>"
                         for c in cols) + "</tr>"
        for row in payload)
    return f"<table><tr>{head}</tr>{body}</table>"


def html_page(title: str, sections) -> str:
    """The ONE debug-page renderer (`/debug/dashboard`, `/debug/explain`,
    `/debug/ledger` all render through here — they used to hand-roll
    three separate pages, drifting on charset and escaping).

    `sections` is an iterable of (heading, payload): a dict payload
    renders as a two-column table, a non-empty list of dicts as a
    columnar table, anything else as escaped pretty JSON in <pre>; a
    None heading omits the <h2>.  Serve the result with
    :data:`HTML_CONTENT_TYPE`."""
    import html as _html
    import json as _json
    parts = []
    for heading, payload in sections:
        if heading is not None:
            parts.append(f"<h2>{_html.escape(str(heading))}</h2>")
        if isinstance(payload, dict):
            parts.append(_html_table(payload))
        elif (isinstance(payload, list) and payload
              and all(isinstance(r, dict) for r in payload)):
            parts.append(_html_table(payload))
        else:
            body = _html.escape(
                _json.dumps(payload, indent=2, default=str))
            parts.append(f"<pre>{body}</pre>")
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{_html.escape(title)}</title>"
        "<style>body{font-family:monospace;margin:1.5em}"
        "table{border-collapse:collapse}"
        "td,th{border:1px solid #999;padding:2px 8px;text-align:left}"
        "pre{background:#f6f6f6;padding:8px;overflow-x:auto}</style>"
        f"</head><body><h1>{_html.escape(title)}</h1>"
        + "".join(parts) + "</body></html>")


def render_html(doc: dict) -> str:
    """One self-contained HTML page over the merged document — the
    no-tooling view (`GET /debug/dashboard?format=html`); the JSON form
    is the API."""
    fleet = {k: v for k, v in sorted(doc.get("fleet", {}).items())}
    sections = [("fleet", fleet)]
    sections += [(name, snap)
                 for name, snap in sorted(doc.get("processes", {}).items())]
    return html_page("karpenter-tpu operator dashboard", sections)


def reset() -> None:
    """Clear registered sources and the rate window (tests)."""
    with _lock:
        _sources.clear()
        _rate_state["ts"] = _rate_state["total"] = None
