"""In-process Prometheus-style metrics registry.

The reference exports its contract on :8000 via prometheus client_golang;
the metric *names* are the compatibility surface (SURVEY §5: "these metric
names are the contract for the baseline comparison") — catalogued in
website/content/en/preview/reference/metrics.md. This module provides the
same families over a dependency-free registry with Prometheus text
exposition, so dashboards written for the reference keep working.

Key families (metrics.md):
  karpenter_provisioner_scheduling_duration_seconds           :102
  karpenter_provisioner_scheduling_simulation_duration_seconds
  karpenter_provisioner_scheduling_queue_depth
  karpenter_disruption_evaluation_duration_seconds            :137
  karpenter_disruption_eligible_nodes
  karpenter_nodeclaims_{launched,registered,initialized,terminated}_total
                                                              :27-48
  karpenter_interruption_received_messages_total              :107-116
  karpenter_cloudprovider_duration_seconds   (metrics.Decorate wrapper,
                                              cmd/controller/main.go:43)
  karpenter_cloudprovider_errors_total
  karpenter_cloudprovider_batcher_batch_size (pkg/batcher/metrics.go)
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(labels[k] for k in self.label_names)

    @staticmethod
    def _esc(value) -> str:
        """Label-value escaping per the Prometheus text exposition spec:
        backslash, double-quote, and line-feed must be escaped or the
        rendered line is invalid text format (a selector value like
        `zone="us-east\\1"` would otherwise break every scraper)."""
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @classmethod
    def _fmt_labels(cls, names, values) -> str:
        if not names:
            return ""
        inner = ",".join(f'{n}="{cls._esc(v)}"' for n, v in zip(names, values))
        return "{" + inner + "}"


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, tuple(label_names))
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def remove(self, **labels) -> None:
        """Drop one series — for label values whose identity is
        process-ephemeral and can never recur (the tenant scheduler's
        connection-derived tenants), keeping the series would grow the
        exposition unboundedly; the reference deletes vanished
        per-type series the same way."""
        with self._lock:
            self._values.pop(self._key(labels), None)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        for key, v in sorted(self._values.items()):
            out.append(
                f"{self.name}{self._fmt_labels(self.label_names, key)} {v}")
        return out


class CounterFunc(Counter):
    """A counter family whose samples are read from `fn()` ({label value:
    count}, one label) when it is rendered: for counts kept elsewhere,
    which the registry would otherwise hold a second copy of."""

    def __init__(self, name, help_, label_name, fn):
        super().__init__(name, help_, (label_name,))
        self.fn = fn

    def render(self) -> List[str]:
        with self._lock:
            self._values = {(str(k),): float(v) for k, v in self.fn().items()}
        return super().render()

    def value(self, **labels) -> float:
        return float(self.fn().get(labels[self.label_names[0]], 0))


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = value
    # remove() inherited: catalog gauges delete series for vanished
    # types/offerings on rebuild, or a removed offering keeps reporting
    # stale values forever


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, tuple(label_names))
        self.buckets = tuple(buckets)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._totals: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def time(self, **labels):
        """Context manager: observe the elapsed wall time."""
        metric = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                metric.observe(time.perf_counter() - self.t0, **labels)
                return False

        return _Timer()

    def count(self, **labels) -> int:
        return self._totals.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._totals):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum = self._counts[key][i]
                names = self.label_names + ("le",)
                values = key + (repr(b),)
                out.append(f"{self.name}_bucket"
                           f"{self._fmt_labels(names, values)} {cum}")
            names = self.label_names + ("le",)
            out.append(f"{self.name}_bucket"
                       f"{self._fmt_labels(names, key + ('+Inf',))} "
                       f"{self._totals[key]}")
            lbl = self._fmt_labels(self.label_names, key)
            out.append(f"{self.name}_sum{lbl} {self._sums[key]}")
            out.append(f"{self.name}_count{lbl} {self._totals[key]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name, help_="", labels=()) -> Counter:
        return self.register(Counter(name, help_, labels))  # type: ignore

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self.register(Gauge(name, help_, labels))  # type: ignore

    def histogram(self, name, help_="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(
            Histogram(name, help_, labels, buckets))  # type: ignore

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition of every registered family."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every metric's samples. Registrations are kept — module-level
        metric objects stay live and exported; only their values clear."""
        with self._lock:
            for m in self._metrics.values():
                for attr in ("_values", "_counts", "_sums", "_totals"):
                    d = getattr(m, attr, None)
                    if d is not None:
                        d.clear()


# the process-global registry (the role of prometheus.DefaultRegisterer)
REGISTRY = Registry()


def _h(name, help_, labels=()):
    return REGISTRY.histogram(name, help_, labels)


def _c(name, help_, labels=()):
    return REGISTRY.counter(name, help_, labels)


def _g(name, help_, labels=()):
    return REGISTRY.gauge(name, help_, labels)


# -- the contract families (metrics.md) ---------------------------------
SCHEDULING_DURATION = _h(
    "karpenter_provisioner_scheduling_duration_seconds",
    "Duration of one scheduling solve.")
SCHEDULING_SIMULATION_DURATION = _h(
    "karpenter_provisioner_scheduling_simulation_duration_seconds",
    "Duration of one disruption scheduling simulation.")
PROVISIONER_BACKLOG_AGE = _g(
    "karpenter_tpu_provisioner_backlog_age_seconds",
    "Age of the oldest still-pending pod the provisioner has seen — the "
    "degraded-mode liveness signal: under oracle fallback with load "
    "shedding, a healthy backlog drains pass by pass and this converges "
    "to zero; growth means the loop is not keeping up.")
SCHEDULING_QUEUE_DEPTH = _g(
    "karpenter_provisioner_scheduling_queue_depth",
    "Pending pods awaiting a scheduling pass.")
RELAXATION_DURATION = _h(
    "karpenter_tpu_solver_relaxation_duration_seconds",
    "Wall-clock of the preference-relaxation outer loop per solve.")
RELAXATION_BUDGET_EXCEEDED = _c(
    "karpenter_tpu_solver_relaxation_budget_exceeded_total",
    "Solves whose relaxation loop hit its wall-clock budget and degraded "
    "remaining stragglers to the oracle.")
SOLVER_SHED_PODS = _c(
    "karpenter_tpu_solver_fallback_shed_pods_total",
    "Pods deferred to the next provisioning pass because the oracle "
    "fallback capped its batch (device path unavailable).")
DISRUPTION_EVALUATION_DURATION = _h(
    "karpenter_disruption_evaluation_duration_seconds",
    "Duration of one disruption evaluation pass.", ("method",))
DISRUPTION_ELIGIBLE_NODES = _g(
    "karpenter_disruption_eligible_nodes",
    "Candidates eligible for disruption in the last pass.", ("method",))
DISRUPTION_ACTIONS = _c(
    "karpenter_disruption_actions_performed_total",
    "Disruption commands executed.", ("method",))
NODECLAIMS_LAUNCHED = _c(
    "karpenter_nodeclaims_launched_total",
    "NodeClaims launched.", ("nodepool",))
NODECLAIMS_REGISTERED = _c(
    "karpenter_nodeclaims_registered_total",
    "NodeClaims whose node registered.", ("nodepool",))
NODECLAIMS_INITIALIZED = _c(
    "karpenter_nodeclaims_initialized_total",
    "NodeClaims fully initialized.", ("nodepool",))
NODECLAIMS_TERMINATED = _c(
    "karpenter_nodeclaims_terminated_total",
    "NodeClaims terminated.", ("nodepool",))
RECONCILE_ERRORS = _c(
    "karpenter_tpu_controller_reconcile_errors_total",
    "Errors a controller swallowed to keep the manager loop alive "
    "(retryable cloud outages, discovery failures), by controller. A "
    "silent swallow hides a persistent outage; this family is the "
    "kt-lint exception-hygiene contract's metrics half.", ("controller",))
INTERRUPTION_MESSAGES = _c(
    "karpenter_interruption_received_messages_total",
    "Interruption-queue messages received.", ("message_type",))
CLOUDPROVIDER_DURATION = _h(
    "karpenter_cloudprovider_duration_seconds",
    "CloudProvider method latency.", ("method",))
CLOUDPROVIDER_ERRORS = _c(
    "karpenter_cloudprovider_errors_total",
    "CloudProvider method errors.", ("method",))
BATCHER_BATCH_SIZE = REGISTRY.histogram(
    "karpenter_cloudprovider_batcher_batch_size",
    "Items per executed batch.", ("batcher",),
    buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000))
# -- device-solver observability (new vs the reference): distinguishing
# -- the device path from the split path from the oracle fallback is the
# -- only way to notice the latency SLO silently degrading 1000x
SOLVER_SOLVES = _c(
    "karpenter_tpu_solver_solves_total",
    "Scheduling solves by execution path.", ("path",))
# last_phase_ms promoted to a first-class family: the per-solve phase
# breakdown (pregroup/encode/pad/device/repair/decode) was visible only
# in bench stdout, invisible to /metrics — the opaque segments now
# dominating the solve budget must be attributable from the operator's
# scrape
SOLVER_PHASE_DURATION = _h(
    "karpenter_tpu_solver_phase_duration_seconds",
    "Per-phase wall-clock of one device solve, by execution path "
    "(solve = single-problem attempt, sweep = batched consolidation "
    "sweep).", ("phase", "path"))
# -- incremental delta solves (solver/delta.py): the O(churn) steady-state
# -- path's observable half.  outcome="delta" passes reused the cached
# -- prefix; outcome="fallback" passes ran the full solve for a
# -- conservative reason (topology, node churn, catalog change, bucket
# -- crossing, cold cache) — every fallback is counted here, never silent
SOLVER_DELTA_PASSES = _c(
    "karpenter_tpu_solver_delta_passes_total",
    "Passes through the delta-solve seam by outcome: delta = the "
    "restricted suffix solve ran (result bit-identical to a full "
    "re-solve), fallback = a conservative exactness guard sent the "
    "pass to the full path.", ("outcome",))
SOLVER_DELTA_GROUPS_REENCODED = _g(
    "karpenter_tpu_solver_delta_groups_reencoded",
    "Pod classes freshly re-encoded in the last delta pass (the churn "
    "the pass actually paid for; unchanged suffix classes reuse their "
    "cached rows).")
# -- event-driven incremental group index (solver/incr.py):
# -- the O(churn) grouping seam's observable half, same counted
# -- discipline as the delta seam — a pass where the index could have
# -- engaged either resolves the dirty set with index probes or names a
# -- conservative fallback reason and walks
SOLVER_INCR_PASSES = _c(
    "karpenter_tpu_solver_incr_passes_total",
    "Passes through the incremental-index seam by outcome: incr = the "
    "pass's groups were assembled from the event-maintained index "
    "(bit-identical to the grouping walk), fallback = a conservative "
    "index-unusable condition (cold/flood/drift/pods/nodes/order) "
    "degraded the grouping to the O(cluster) walk.", ("outcome",))
# -- speculative chunked G-axis pipeline (solver/solve.py _try_spec,
# -- the port's _try_spec): the chunked-chain seam's observable half, same counted
# -- discipline as the delta seam — a pass either chunks or names a
# -- conservative fallback reason, and every speculated chunk either
# -- commits bit-exactly or pays a counted repair re-dispatch
SOLVER_SPEC_PASSES = _c(
    "karpenter_tpu_solver_spec_passes_total",
    "Passes through the speculative-chunk seam by outcome: spec = the "
    "G axis ran as a pipelined chain of seeded chunk solves (result "
    "bit-identical to the sequential program), fallback = a "
    "conservative exactness guard sent the pass to the single-program "
    "path.", ("outcome",))
SOLVER_SPEC_CHUNKS = _c(
    "karpenter_tpu_solver_spec_chunks_total",
    "Speculated chunks by commit verdict: committed = the speculated "
    "entry seed matched the true exit state bit-for-bit (the in-flight "
    "solve IS the sequential program's), repaired = the seed diverged "
    "(or speculation was declined) and the chunk re-solved from the "
    "true seed — every divergence is counted here, never silent.",
    ("outcome",))
# -- solver-service availability: the crash-isolation story's
# -- observable half — without these, a daemon crash-loop looks identical
# -- to a healthy idle service from the operator's scrape
SERVICE_RETRIES = _c(
    "karpenter_tpu_service_retries_total",
    "Solver-service RPCs retried after a transport failure (connect/"
    "send/receive/timeout), before the breaker or the caller gave up.")
SERVICE_BREAKER_STATE = _g(
    "karpenter_tpu_service_breaker_state",
    "Solver-service circuit breaker state: 0=closed (healthy), 1=open "
    "(failing fast, control plane in degraded mode), 2=half-open (one "
    "probe in flight).")
SERVICE_WORKER_RESTARTS = _c(
    "karpenter_tpu_service_worker_restarts_total",
    "Supervised kt_solverd worker processes restarted after an "
    "unexpected exit (crash containment; a climbing series means a "
    "crash loop the backoff is absorbing).")
# -- multi-tenant solverd dispatch: the tenant-aware
# -- scheduler's observable half — per-tenant demand/fairness/shedding
# -- and the cross-tenant fusion the shared fleet's throughput rides on
SERVICE_TENANT_REQUESTS = _c(
    "karpenter_tpu_service_tenant_requests_total",
    "Schedule requests admitted to the solverd tenant scheduler, by "
    "tenant (the client-declared tenant field; connection-derived when "
    "absent). Per-tenant share of this family is the fairness "
    "denominator.", ("tenant",))
SERVICE_TENANT_SHED = _c(
    "karpenter_tpu_service_tenant_shed_total",
    "Requests the tenant scheduler shed, counted never silent: "
    "reason=admission (queue at its bound, lowest priority loses), "
    "reason=deadline (the caller's deadline passed at ingest or while "
    "queued). Every shed is answered with an explicit shed response "
    "carrying the backpressure hint.", ("tenant", "reason"))
SERVICE_TENANT_QUEUE_DEPTH = _g(
    "karpenter_tpu_service_tenant_queue_depth",
    "Requests currently waiting in one tenant's scheduler queue "
    "(excludes the C++ window backlog, which rides the backpressure "
    "hints instead).", ("tenant",))
SERVICE_FUSED_BATCHES = _c(
    "karpenter_tpu_service_fused_batches_total",
    "Fused device dispatches by whether the batch mixed tenants "
    "(cross_tenant=yes/no). A healthy shared fleet under concurrent "
    "compatible traffic runs mostly yes; all-no under multi-tenant "
    "load means buckets aren't aligning (check catalog fingerprints "
    "and the warmup lattice).", ("cross_tenant",))
SERVICE_FUSED_BATCH_SIZE = REGISTRY.histogram(
    "karpenter_tpu_service_fused_batch_size",
    "Requests per fused solverd device dispatch (the occupancy the "
    "saturation bench gates on).",
    buckets=(1, 2, 4, 8, 16, 32, 64))
SOLVER_RESIDUE_PODS = _c(
    "karpenter_tpu_solver_residue_pods_total",
    "Pods solved host-side as split-solve residue.")
# -- placement provenance: the decision-observability layer —
# -- every final unschedulable verdict carries a registry reason code
# -- (solver/explain.py, the one enum owner), and the kernel's explain
# -- aux attributes candidate eliminations to constraint classes
UNSCHEDULABLE_PODS = _c(
    "karpenter_tpu_unschedulable_pods_total",
    "Pods reported unschedulable by the provisioning pass, by registry "
    "reason code (solver/explain.py). reason=Legacy marks a plain-string "
    "reason from an unregistered producer — kt-lint's reason-literal "
    "check keeps this at zero.", ("reason",))
# -- gang scheduling: atomic multi-node placement outcomes
GANG_PLACEMENTS = _c(
    "karpenter_tpu_gang_placements_total",
    "Gang placement outcomes per provisioning pass (one increment per "
    "gang): outcome=placed when every member landed, outcome=stranded "
    "when the gang stranded whole — by the atomicity invariant there "
    "is no third outcome (a partial gang is a bug, counted on "
    "karpenter_tpu_solver_gang_repairs_total).", ("outcome",))
# -- priority & preemption
PREEMPTIONS = _c(
    "karpenter_tpu_preemptions_total",
    "Preemption plan executions (one increment per plan): "
    "outcome=evicted when every victim drained (plans are atomic — a "
    "gang victim evicts whole), outcome=blocked when any victim failed "
    "its eviction gate and the WHOLE plan was skipped, outcome=stale "
    "when the plan's victims were already gone by execution time.",
    ("outcome",))
SPOT_RISK_COST = _g(
    "karpenter_tpu_spot_risk_cost",
    "Fleet expected-interruption cost in $/hr: Σ over spot nodes of "
    "p(interruption) × price under the KARPENTER_TPU_SPOT_RISK model — "
    "the quantity the risk-weighted objective minimizes at equal "
    "coverage (0 when the knob is off or the fleet is on-demand).")
SOLVER_GANG_REPAIRS = _c(
    "karpenter_tpu_solver_gang_repairs_total",
    "Gang fills the host-side atomicity safety net rolled back "
    "(partial or cross-domain placement out of the kernel) — expected "
    "to stay at zero; any increment is a kernel gang-commit bug made "
    "visible instead of a silently split gang.")
SOLVER_HOST_REPAIRS = _c(
    "karpenter_tpu_solver_host_repairs_total",
    "Kernel placements the host-side repair nets rolled back or "
    "trimmed, by kind: whole_node = a co-location group stranded "
    "atomically (split across nodes out of the kernel), topology = "
    "placements stripped above the final skew ceiling.  Each repair "
    "is a counted degrade (the oracle rescue then re-seats the pods), "
    "never a silent rewrite.", ("kind",))
SPILL_DEGRADED = _c(
    "karpenter_tpu_spill_degraded_total",
    "Spill-to-disk writes abandoned (OSError — full disk, dead mount) "
    "by recorder: flight, ledger, timeline.  The black box degrades "
    "to ring-only and keeps serving; a non-zero rate means restart "
    "replay is losing its tail and the disk needs attention.",
    ("recorder",))
SOLVER_CONSTRAINT_ELIM = _c(
    "karpenter_tpu_solver_constraint_eliminations_total",
    "Catalog-column eliminations attributed per constraint class by the "
    "solver's explain aux (KARPENTER_TPU_EXPLAIN): compat/price are the "
    "host encode-side classes, fit/limit/topology/whole_node/slots the "
    "kernel-side ones. The fleet-level 'which constraint is binding' "
    "signal.", ("constraint",))
# -- observability substrate: the flight recorder, the
# -- device-runtime telemetry, and the trace ring's drop accounting
FLIGHT_RECORDS = _c(
    "karpenter_tpu_flight_records_total",
    "Flight-recorder records written, by record kind (solve = one "
    "single-problem attempt, delta = an engaged delta pass, spec = an "
    "engaged speculative chunk-chain pass, batch = one fused solverd "
    "batch).", ("kind",))
TIMELINE_EVENTS = _c(
    "karpenter_tpu_timeline_events_total",
    "Timeline-recorder events written, by event kind (store.<kind>.<op> "
    "informer-cache observations plus the semantic drive kinds from "
    "timeline/events.py — spot.reclaim, price.refresh, fault.inject, "
    "gang/priority arrival markers).", ("kind",))
SOLVER_RETRACES = _c(
    "karpenter_tpu_solver_retraces_total",
    "Kernel-program first uses (a new padded shape: the event that "
    "pays set-up work on the solve path), by padded shape bucket. Post-warmup steady state "
    "must hold this flat — a climbing series means a padding-bucket "
    "cliff the warm-up lattice missed.", ("bucket",))
SOLVER_DEVICE_MEMORY_PEAK = _g(
    "karpenter_tpu_solver_device_memory_peak_bytes",
    "Peak device-memory bytes in use, sampled after each solve "
    "(0 when the backend does not report — the CPU path).")
SOLVER_DONATED_SLOTS = _g(
    "karpenter_tpu_solver_donated_slots_in_use",
    "Donated upload slots currently holding a live (undeleted) device "
    "buffer in the pipelined executor's double-buffer rotation.")
TRACE_SPANS_DROPPED = _c(
    "karpenter_tpu_trace_spans_dropped_total",
    "Spans evicted from the trace collector's bounded buffers (oldest "
    "finished trace pushed out of the ring, an orphaned in-progress "
    "trace evicted, or a pathological trace hitting the per-trace span "
    "cap) — the visibility half of the ring's silent-eviction bargain.")
SOLVER_ORACLE_BACKSTOP = _c(
    "karpenter_tpu_solver_oracle_backstop_total",
    "Solves where the full-oracle backstop beat the decomposed paths "
    "under a binding pool limit.")
# -- cost & efficiency observability: the objective itself —
# -- fleet $/hr, savings realized by disruption, how far packing sits
# -- from the allocatable envelope, and the live solver-vs-oracle audit
FLEET_HOURLY_COST = _g(
    "karpenter_tpu_fleet_hourly_cost",
    "Fleet spend in $/hr by nodepool and capacity type, summed over the "
    "cluster's live nodes' offering prices (utils/ledger.py "
    "update_fleet_metrics; refreshed by the provisioning pass when the "
    "cluster changed, with a 30 s staleness bound). The "
    "fleet total is the sum over all series — the exported form of the "
    "objective the solver minimizes.", ("pool", "capacity_type"))
DISRUPTION_SAVINGS = _c(
    "karpenter_tpu_disruption_savings_dollars_total",
    "Cumulative $/hr of fleet cost removed by disruption decisions, by "
    "method (emptiness/multi_node/single_node; drift replacements are "
    "spec-motivated, not cost-motivated, and never count): sum of "
    "retired "
    "candidate prices minus the replacement price, counted at decision "
    "time (the same floats the acceptance check compares to IEEE-hex "
    "exactness).", ("method",))
PACKING_EFFICIENCY = _g(
    "karpenter_tpu_packing_efficiency_ratio",
    "Per-nodepool packing efficiency by resource: sum of resident pod "
    "requests over sum of node allocatable (1.0 = perfectly packed; "
    "only resources with nonzero allocatable export a series).",
    ("pool", "resource"))
FLEET_PACKING_EFFICIENCY = _g(
    "karpenter_tpu_fleet_packing_efficiency_ratio",
    "Fleet-wide packing efficiency by resource (requested over "
    "allocatable across every live node).", ("resource",))
STRANDED_CAPACITY = _g(
    "karpenter_tpu_stranded_capacity_units",
    "Allocatable-minus-requested units sitting idle on live nodes, by "
    "nodepool and resource (solver units: millicores, MiB, counts) — "
    "the capacity being paid for but not requested, i.e. the "
    "consolidation opportunity in resource terms.", ("pool", "resource"))
FLEET_EFFICIENCY_BOUND = _g(
    "karpenter_tpu_fleet_efficiency_lower_bound_ratio",
    "Greedy cost lower bound over actual fleet $/hr: total pod requests "
    "priced at the cheapest feasible $/resource-unit across the "
    "catalog, divided by the real fleet cost (<= 1.0; 1.0 means spend "
    "is at the naive bound). Deliberately a CHEAP bound — the seam the "
    "relaxed-LP scoring from the convex-optimization line of work "
    "replaces with a tight one (docs/observability.md).")
LEDGER_RECORDS = _c(
    "karpenter_tpu_ledger_records_total",
    "Decision-ledger records written (utils/ledger.py), by decision "
    "source (provisioning/disruption/drift/expiration/interruption/"
    "termination).", ("source",))
SOLVER_AUDIT = _c(
    "karpenter_tpu_solver_audit_total",
    "Shadow-audit verdicts over sampled production solves "
    "(solver/audit.py, KARPENTER_TPU_AUDIT): match = bit-exact oracle "
    "parity, improved = the solver beat the oracle's cost/placement, "
    "diverged = the solver answered worse than the oracle or a delta "
    "pass failed its full re-solve parity (auto-captured for "
    "kt_replay), dropped = sampler backlog full, error = the "
    "verification itself failed.", ("verdict",))
# the port's own: its hand-written CUDA kernels, launch by launch, read
# when scraped from the counts each wrapper of solver/ffd.py keeps where
# it launches (the CPU's plain versions launch nothing), so a scrape of a
# running operator shows which kernels its passes went through


def _kernel_launches() -> Dict[str, int]:
    from karpenter_tpu_torch.solver import ffd
    return ffd.launch_counts()


SOLVER_KERNEL_LAUNCHES = REGISTRY.register(CounterFunc(
    "karpenter_tpu_solver_kernel_launches_total",
    "CUDA kernel launches of the solver, by kernel instance "
    "(ffd_batch_scan, ffd_sweep_scan, ...); the scans' epilogue passes "
    "(explain_pack, explain_map, priority_witness) count the launches "
    "that carried them.", "kernel", _kernel_launches))
# per-instance-type catalog gauges (reference:
# pkg/providers/instancetype/instancetype.go:156-161,302-311 + metrics.go)
INSTANCE_TYPE_CPU = _g(
    "karpenter_cloudprovider_instance_type_cpu_cores",
    "vCPUs per instance type.", ("instance_type",))
INSTANCE_TYPE_MEMORY = _g(
    "karpenter_cloudprovider_instance_type_memory_bytes",
    "Memory per instance type.", ("instance_type",))
INSTANCE_TYPE_OFFERING_PRICE = _g(
    "karpenter_cloudprovider_instance_type_offering_price_estimate",
    "Last known price per offering.",
    ("instance_type", "zone", "capacity_type"))
INSTANCE_TYPE_OFFERING_AVAILABLE = _g(
    "karpenter_cloudprovider_instance_type_offering_available",
    "Offering availability (0 = ICE-blocked).",
    ("instance_type", "zone", "capacity_type"))


class DecoratedCloudProvider:
    """metrics.Decorate analogue (cmd/controller/main.go:43): wraps every
    public CloudProvider method with duration + error counters. Methods are
    wrapped once at construction so repeated attribute reads return the same
    callable with no per-call allocation."""

    _METHODS = ("create", "delete", "get", "list_instances",
                "get_instance_types", "is_drifted", "live")

    def __init__(self, inner):
        self._inner = inner
        for name in self._METHODS:
            setattr(self, name, self._wrap(name, getattr(inner, name)))

    @staticmethod
    def _wrap(name, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            except Exception:
                CLOUDPROVIDER_ERRORS.inc(method=name)
                raise
            finally:
                CLOUDPROVIDER_DURATION.observe(
                    time.perf_counter() - t0, method=name)

        return wrapped

    def __getattr__(self, name):
        return getattr(self._inner, name)
