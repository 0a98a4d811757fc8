"""Placement provenance vocabulary: the fit-slack epsilon, the constraint
classes, the reason codes the solve path emits, and the explain-mode gate.

The port's copy of the parts of `karpenter_tpu/solver/explain.py` that the
solve path reads: the codes the kernel strands, the oracle, the gang fill
and the preemption planner emit, the ``KARPENTER_TPU_EXPLAIN`` grammar,
and the explain engine — `build_tree` turns (encoding, kernel output,
group) into a per-group reason tree (per-constraint elimination counts,
per-nodepool verdicts, the nearest-miss column, the unblock suggestion,
and under full mode the eliminated columns the kernel's [G, O] class map
names).  Codes and constraint names are identical, so a verdict from
either package carries the same `.code` and `.tree`.  The disruption
decision vocabulary (the codes the disruption, expiration, interruption
and termination controllers name) is registered here too, as in the
reference.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

# the fit-slack epsilon: every fit test (`floor((avail + EPS) / req)` and
# the `>= -EPS` subtract-compares) uses this one value, as float32
EPS = 1e-3

# -- constraint classes (canonical order) ---------------------------------
# The kernel's aux counts rows use KERNEL_CONSTRAINTS order, and the
# reason bitset's bit i is KERNEL_CONSTRAINTS[i].
HOST_CONSTRAINTS = ("compat", "price")
KERNEL_CONSTRAINTS = ("fit", "limit", "topology", "whole_node", "slots")
CONSTRAINTS = HOST_CONSTRAINTS + KERNEL_CONSTRAINTS + ("gang", "priority")

_CONSTRAINT_HELP = {
    "compat": "label/taint/requirement incompatibility (host encode mask)",
    "price": "price cap eliminated the column (host encode mask)",
    "fit": "resource request does not fit an empty node of the column",
    "limit": "the nodepool's remaining limit cannot fund one more pod",
    "topology": "the column's domain is ineligible or at its skew ceiling",
    "whole_node": "no single node could hold the whole co-located group",
    "slots": "the solver's node-slot axis was exhausted",
    "gang": "the gang's all-or-nothing, single-domain placement failed",
    "priority": "priority-band packing or preemption planning decided "
                "the outcome",
}


# -- reason codes ----------------------------------------------------------
class ReasonSpec:
    __slots__ = ("code", "constraint", "summary")

    def __init__(self, code: str, constraint: str, summary: str):
        assert constraint in CONSTRAINTS + ("none",), constraint
        self.code = code
        self.constraint = constraint
        self.summary = summary


REGISTRY: Dict[str, ReasonSpec] = {}


def _register(code: str, constraint: str, summary: str) -> str:
    REGISTRY[code] = ReasonSpec(code, constraint, summary)
    return code


# kernel strands (solver/solve.py _unsched_reason + decode)
NO_NODEPOOL = _register(
    "NoNodepoolCompatible", "compat",
    "no nodepool's template/taints/types are compatible with the pod")
TOPOLOGY = _register(
    "TopologyUnsatisfiable", "topology",
    "every allowed domain is at its skew ceiling or out of capacity")
CAPACITY = _register(
    "CapacityExhausted", "fit",
    "every compatible node/instance-type combination is exhausted or "
    "over limits")
NO_INSTANCE_TYPES = _register(
    "NoInstanceTypes", "compat",
    "no purchasable instance types and existing capacity is full")
NO_SURVIVING_TYPE = _register(
    "NoSurvivingType", "fit",
    "no instance type survives the node's accumulated requirements")
MIN_VALUES = _register(
    "MinValuesViolated", "compat",
    "the surviving type set exposes fewer distinct label values than "
    "the nodepool's minValues")
# oracle verdicts (scheduling/oracle.py)
POOL_LIMIT = _register(
    "PoolLimitExceeded", "limit",
    "a binding nodepool limit blocked the placement (oracle authority)")
# gang scheduling verdicts of the oracle's atomic gang pre-pass, always
# for the WHOLE gang (one member's verdict is every member's verdict)
GANG_PARTIAL = _register(
    "GangPartiallyPlaceable", "gang",
    "the best adjacency domain can hold some but not all gang members "
    "— the gang strands whole rather than split (tree carries the "
    "nearest domain and the deficit)")
GANG_DOMAIN = _register(
    "GangDomainExhausted", "gang",
    "no adjacency domain can currently hold any gang member — every "
    "eligible domain is out of capacity or ineligible")
GANG_TOO_LARGE = _register(
    "GangTooLarge", "gang",
    "the gang's member count exceeds what any single adjacency domain "
    "could hold even on an empty fleet at the solver's node ceiling")
GANG_INCOMPLETE = _register(
    "GangIncomplete", "gang",
    "the pending member count (plus members already bound on live "
    "nodes) does not match the gang-size annotation (fewer: placement "
    "waits for the full gang; more: fix gang-size — an over-full gang "
    "never self-heals by waiting)")
GANG_CODES = frozenset((GANG_PARTIAL, GANG_DOMAIN, GANG_TOO_LARGE,
                        GANG_INCOMPLETE))
# priority & preemption verdicts: emitted by the decode
# reclassification (solver/solve.py) and the preemption planner
# (solver/preempt.py).
PRIORITY_BAND_EXHAUSTED = _register(
    "PriorityBandExhausted", "priority",
    "capacity ran out inside this pod's priority band while at least "
    "one strictly-lower-priority group still placed — the preemption "
    "planner's trigger condition (kernel witness: the priority aux row)")
PREEMPTED_FOR = _register(
    "PreemptedFor", "priority",
    "this pod is a planned preemption victim: its (atomic, whole-gang "
    "when ganged) eviction seats a stranded strictly-higher-priority "
    "pod named in the preempted-for annotation")
PREEMPTION_INSUFFICIENT = _register(
    "PreemptionInsufficient", "priority",
    "evicting every evictable strictly-lower-priority victim still "
    "could not seat the stranded pod — preemption cannot help; the "
    "pod waits for capacity")
PRIORITY_CODES = frozenset((PRIORITY_BAND_EXHAUSTED, PREEMPTED_FOR,
                            PREEMPTION_INSUFFICIENT))
LEGACY = "Legacy"  # unregistered plain-string reason (should not occur)

# -- disruption decision vocabulary: the controllers' fleet-mutating
# -- decisions and their rejection verdicts, registered here so every
# -- disruption event and (from slice 6) every ledger record carries a
# -- CODE, never a bare string.
# -- Constraint "none": these classify decisions, not pod eliminations.
CAPACITY_LAUNCHED = _register(
    "CapacityLaunched", "none",
    "provisioning launched new capacity for pending pods")
CONSOLIDATION_DELETE = _register(
    "ConsolidationDelete", "none",
    "consolidation deleted candidates whose pods fit on the remaining "
    "fleet (pure delete — always saves money)")
CONSOLIDATION_REPLACE = _register(
    "ConsolidationReplace", "none",
    "consolidation replaced candidates with one strictly cheaper node")
DRIFT_REPLACED = _register(
    "DriftReplaced", "none",
    "drifted capacity was replaced in kind (no cheaper-price "
    "requirement)")
NODE_EXPIRED = _register(
    "NodeExpired", "none",
    "the claim outlived its NodePool expireAfter and was deleted")
INTERRUPTION_RECLAIM = _register(
    "InterruptionReclaim", "none",
    "a cloud interruption signal (spot reclaim, maintenance, state "
    "change) deleted the claim ahead of the reclaim")
NODE_TERMINATED = _register(
    "NodeTerminated", "none",
    "the drained instance was released — the point the fleet $/hr "
    "actually falls for a prior delete/replace decision")
# rejection verdicts: why a consolidation candidate stayed up
REPLACEMENT_NOT_CHEAPER = _register(
    "ReplacementNotCheaper", "none",
    "the cheapest feasible replacement would not reduce fleet cost")
SPOT_TO_SPOT_DISABLED = _register(
    "SpotToSpotDisabled", "none",
    "spot-to-spot consolidation is behind a disabled feature gate")
SPOT_FLEXIBILITY_TOO_LOW = _register(
    "SpotFlexibilityTooLow", "none",
    "the spot replacement keeps too few instance types for reliable "
    "spot capacity (the >=15-types rule)")
CANDIDATE_NOT_RESCHEDULABLE = _register(
    "CandidateNotReschedulable", "none",
    "the candidate's pods cannot reschedule onto remaining capacity or "
    "an admissible replacement")
BUDGET_BLOCKED = _register(
    "DisruptionBudgetBlocked", "none",
    "a NodePool disruption budget (possibly cron-windowed) blocked the "
    "decision this pass")
NODEPOOL_DRIFT = _register(
    "NodePoolDrift", "none",
    "the claim's stamped NodePool hash no longer matches the live pool")

# per-nodepool cause vocabulary for the oracle's open-new cascade
# (scheduling/oracle.py `_open_new`): each blocked pool names exactly one
# of these in the reason tree
CAUSE_NO_TYPES = "NoInstanceTypes"
CAUSE_TAINTS = "TaintsNotTolerated"
CAUSE_UNKNOWN_LABEL = "UnknownLabel"
CAUSE_INCOMPATIBLE = "IncompatibleRequirements"
CAUSE_LIMITS = "LimitsExceeded"
CAUSE_NO_FIT = "NoFittingType"
CAUSE_TOPOLOGY = "TopologyUnsatisfiable"


class Reason(str):
    """An unschedulability reason: the human-readable string plus the
    structured `.code` and an optional `.tree`."""

    def __new__(cls, code: str, detail: str, tree: Optional[dict] = None):
        s = super().__new__(cls, detail)
        s.code = code
        s.tree = tree
        return s

    def __reduce__(self):
        return (Reason, (self.code, str(self), self.tree))


def make(code: str, detail: str, tree: Optional[dict] = None) -> Reason:
    """The one constructor verdict emitters use; unregistered codes raise."""
    if code not in REGISTRY:
        raise ValueError(f"unregistered reason code {code!r}")
    return Reason(code, detail, tree)


def code_of(reason) -> str:
    """The structured code of any reason value; plain strings map to
    LEGACY rather than raising."""
    return getattr(reason, "code", LEGACY)


def constraint_of(code: str) -> str:
    spec = REGISTRY.get(code)
    return spec.constraint if spec is not None else "none"


# -- the steady-state seams' fallback vocabularies ------------------------
# delta seam (solver/solve.py _delta_fallback, solver/delta.py plan and
# build): every non-engaged delta pass names one of these; an unknown
# reason is a registry violation, not a new string.  "priority" and
# "preempt": band order is global and an in-flight eviction plan frees
# capacity between passes, so both force a full pass.
DELTA_FALLBACK_REASONS = frozenset((
    "cold", "nodes", "price-cap", "limits", "small", "topology",
    "bucket", "seed", "slots", "stranded", "shape", "gang",
    "priority", "preempt"))

# speculative chunk chain (solver/solve.py _spec_fallback): the delta
# seam's exactness gates applied to the live encoding, plus the chunk
# planner's declines
SPEC_FALLBACK_REASONS = frozenset((
    "small", "bucket", "topology", "shape", "gang", "priority",
    "price-cap", "limits", "slots", "stranded", "seed"))

# incremental group index (solver/solve.py _incr_fallback, solver/incr.py
# build_groups): a pass where the index could have engaged but the
# grouping walked the cluster instead —
#   cold  — no index yet (no record, or raced away by an invalidation)
#   flood — the watch buffer overflowed or an all-dirty invalidation came
#   drift — the index's pod census disagrees with the live input
#   pods  — pod names invalidated without their objects
#   nodes — node-shaped dirt the index could not prove harmless
#   order — the index cannot prove the walk's group order
INCR_FALLBACK_REASONS = frozenset((
    "cold", "flood", "drift", "pods", "nodes", "order"))


# -- the gate --------------------------------------------------------------
MODE_OFF, MODE_COUNTS, MODE_FULL = 0, 1, 2
_ENV = "KARPENTER_TPU_EXPLAIN"
_MODE_NAMES = {MODE_OFF: "off", MODE_COUNTS: "counts", MODE_FULL: "full"}


def mode() -> int:
    """KARPENTER_TPU_EXPLAIN=off|counts|full (default counts).  Malformed
    values degrade to the default, never crash."""
    raw = os.environ.get(_ENV, "").strip().lower()
    if raw in ("off", "0", "false", "no", "none"):
        return MODE_OFF
    if raw == "full":
        return MODE_FULL
    return MODE_COUNTS


def mode_name(m: int) -> str:
    return _MODE_NAMES.get(m, "counts")


# -- explain engine --------------------------------------------------------
def counts_dict(enc, out, gi: int) -> Dict[str, int]:
    """One group's per-constraint elimination counts as {constraint:
    n_columns}: kernel aux when the solve carried it
    (`out["explain_counts"]`, KERNEL_CONSTRAINTS order), host recompute
    otherwise; the host-owned classes (compat, price) come from the
    encode-side counts (`enc.explain_host`) when armed, else from the
    final group mask alone (price folded into compat)."""
    import numpy as np
    counts: Dict[str, int] = {}
    host = getattr(enc, "explain_host", None)
    O = enc.n_columns
    if host is not None and gi < len(host):
        counts["compat"] = int(host[gi][0])
        counts["price"] = int(host[gi][1])
    else:
        counts["compat"] = int(O - np.asarray(
            enc.group_mask[gi], dtype=bool).sum())
        counts["price"] = 0
    kc = out.get("explain_counts") if isinstance(out, dict) else None
    if kc is not None and gi < len(kc):
        row = np.asarray(kc[gi])
        for i, name in enumerate(KERNEL_CONSTRAINTS):
            counts[name] = int(row[i])
    else:
        counts.update(host_counts(enc, out, gi))
    return counts


def host_counts(enc, out, gi: int) -> Dict[str, int]:
    """Numpy mirror of the kernel's aux counts for one group, computed
    against the FINAL solve state visible on the host.  Used when the
    dispatch path carried no aux (batched/sweep kernels, replay of a
    pre-explain capture) — per stranded group only, so the cost is
    bounded by the strand count, not the problem size.

    `limit` is computed against the INITIAL pool limits (the kernel's
    final budgets are not downloaded): a column counts as limit-blocked
    when its pool's configured limit cannot fund even one pod on an
    otherwise-empty budget — a lower bound on the kernel's final-state
    verdict, honest for the "is a finite limit involved at all"
    question the tree answers."""
    import numpy as np
    gmask = np.asarray(enc.group_mask[gi], dtype=bool)
    req = np.asarray(enc.group_req[gi], dtype=np.float32)
    alloc = np.asarray(enc.col_alloc, dtype=np.float32)
    daemon = np.asarray(enc.col_daemon, dtype=np.float32)
    avail = alloc - daemon - req[None, :]
    fits = np.all(avail >= -1e-3, axis=-1)
    out_c: Dict[str, int] = {
        "fit": int((gmask & ~fits).sum()),
    }
    # limit: columns of pools whose configured limit can't fund one pod
    pool_limit = np.asarray(enc.pool_limit, dtype=np.float32)
    col_pool = np.asarray(enc.col_pool)
    lim_ok = np.all(
        pool_limit[col_pool] - daemon - req[None, :] >= -1e-3, axis=-1)
    out_c["limit"] = int((gmask & fits & ~lim_ok).sum())
    # topology: only meaningful when the group carried a dynamic domain
    # constraint — blocked domains from the final dom_placed rows
    topo = 0
    dsel = int(enc.group_dsel[gi]) if enc.group_dsel is not None else 0
    if dsel and isinstance(out, dict) and "dom_placed" in out:
        D = enc.n_domains
        dbase = np.asarray(enc.group_dbase[gi][:D], dtype=np.int64)
        placed = np.asarray(out["dom_placed"][gi][:D], dtype=np.int64)
        elig = np.asarray(enc.group_delig[gi][:D], dtype=bool)
        f = dbase + placed
        skew = int(enc.group_skew[gi])
        m = int(f[elig].min()) if elig.any() else 0
        if enc.group_mindom[gi] > 0 and \
                int((f[elig] > 0).sum()) < int(enc.group_mindom[gi]):
            m = 0
        blocked = (~elig) | (f >= m + skew)
        dom_ids = np.asarray(
            enc.col_zone if dsel == 1 else enc.col_ct)
        dom_clipped = np.clip(dom_ids, 0, D - 1)
        topo = int((gmask & blocked[dom_clipped]).sum())
    out_c["topology"] = topo
    whole = bool(enc.group_whole_node is not None
                 and enc.group_whole_node[gi])
    stranded = bool(isinstance(out, dict) and "unsched" in out
                    and out["unsched"][gi] > 0)
    out_c["whole_node"] = int(gmask.sum()) if whole and stranded else 0
    slots = 0
    if isinstance(out, dict) and "num_active" in out and stranded:
        na = int(out["num_active"])
        n_axis = out["take_new"].shape[1] if "take_new" in out else 0
        slots = int(n_axis > 0 and na >= n_axis)
    out_c["slots"] = slots
    return out_c


def nearest_miss(enc, gi: int) -> Optional[dict]:
    """The closest eliminated catalog column and what would unblock it:
    the masked-in column with the smallest worst-resource deficit for a
    fit miss, or — when a price cap was folded into the mask
    (`enc.explain_price_cap`) — the cheapest FITTING column above the
    cap for a price miss (label compatibility is not re-derivable once
    the cap is folded in, so the price candidate is capacity-checked
    only).  Host numpy over [O] — called per stranded group only."""
    import numpy as np
    O = enc.n_columns
    if O == 0:
        return None
    req = np.asarray(enc.group_req[gi], dtype=np.float32)
    alloc = np.asarray(enc.col_alloc, dtype=np.float32)
    daemon = np.asarray(enc.col_daemon, dtype=np.float32)
    deficit = np.clip(req[None, :] - (alloc - daemon), 0.0, None)  # [O,R]
    worst = deficit.max(axis=-1)                                   # [O]
    gmask = np.asarray(enc.group_mask[gi], dtype=bool)
    cand = gmask & (worst > 0)
    if cand.any():
        # the masked-in column with the smallest worst-resource deficit
        idx = int(np.where(cand, worst, np.inf).argmin())
        col = enc.columns[idx]
        from karpenter_tpu_torch.models.resources import RESOURCE_AXIS
        by_res = {RESOURCE_AXIS[r]: round(float(deficit[idx][r]), 3)
                  for r in range(len(RESOURCE_AXIS))
                  if deficit[idx][r] > 0}
        return {"constraint": "fit", "instance_type": col.type_name,
                "nodepool": col.pool, "zone": col.zone,
                "deficit": by_res}
    cap = getattr(enc, "explain_price_cap", None)
    if cap is not None and enc.col_price is not None:
        price = np.asarray(enc.col_price, dtype=np.float64)
        over = (~gmask) & (price >= cap) & (worst <= 0)
        if over.any():
            idx = int(np.where(over, price, np.inf).argmin())
            col = enc.columns[idx]
            return {"constraint": "price",
                    "instance_type": col.type_name,
                    "nodepool": col.pool, "zone": col.zone,
                    "price": round(float(price[idx]), 6),
                    "price_cap": round(float(cap), 6)}
    return None


def _suggestion(counts: Dict[str, int], enc, gi: int,
                miss: Optional[dict]) -> Optional[str]:
    """The operator-facing 'what change would unblock it' line, from the
    dominant constraint class."""
    import numpy as np
    if counts.get("limit"):
        finite = [p.meta.name for pi, p in enumerate(enc.pools)
                  if np.isfinite(np.asarray(enc.pool_limit[pi])).any()]
        if finite:
            return ("raise the limit on nodepool "
                    + " or ".join(sorted(finite)))
        return "raise the binding nodepool limit"
    if counts.get("price"):
        if miss is not None and miss.get("constraint") == "price":
            return (f"raise the price cap to >= {miss['price']} "
                    f"({miss['instance_type']} is the cheapest fitting "
                    "column above it)")
        return "raise the price cap (columns were eliminated on price)"
    if counts.get("topology"):
        return ("add capacity in an under-ceiling domain or relax "
                "maxSkew")
    if counts.get("slots"):
        return "raise the solver's max_nodes ceiling"
    if counts.get("whole_node"):
        return ("no single node holds the whole co-located group — "
                "larger instance types or fewer members")
    if miss is not None:
        need = ", ".join(f"{k}+{v}" for k, v in
                         sorted(miss["deficit"].items()))
        return (f"nearest miss {miss['instance_type']}: needs {need} "
                "more allocatable")
    if counts.get("compat"):
        return ("no compatible column at all — check nodepool "
                "requirements/taints against the pod")
    return None


def _map_detail(enc, out, gi: int, limit: int = 5) -> Optional[dict]:
    """The full-mode [G, O] class map rendered as named columns: per
    kernel constraint class, up to `limit` example catalog columns it
    eliminated — the "which columns exactly" answer counts cannot give
    (present only under KARPENTER_TPU_EXPLAIN=full / replay)."""
    import numpy as np
    m = out.get("explain_map") if isinstance(out, dict) else None
    if m is None or gi >= len(m):
        return None
    row = np.asarray(m[gi][:enc.n_columns])
    detail: Dict[str, list] = {}
    for ci, name in enumerate(KERNEL_CONSTRAINTS):
        idxs = np.nonzero(row == ci + 1)[0]
        if not len(idxs):
            continue
        detail[name] = [
            {"instance_type": enc.columns[int(i)].type_name,
             "zone": enc.columns[int(i)].zone,
             "capacity_type": enc.columns[int(i)].capacity_type}
            for i in idxs[:limit]]
        if len(idxs) > limit:
            detail[name].append({"and_more": int(len(idxs) - limit)})
    return detail or None


def build_tree(enc, out, gi: int, code: str) -> dict:
    """One stranded group's reason tree: per-constraint elimination
    counts over the catalog columns, the per-nodepool compatibility
    verdicts, the nearest-miss type, and the unblock suggestion; under
    full mode, also the per-column eliminated-columns detail."""
    counts = counts_dict(enc, out, gi)
    pools = []
    merged = enc.merged_reqs[gi] if gi < len(enc.merged_reqs) else []
    for pidx, pool in enumerate(enc.pools):
        verdict = ("incompatible or taints"
                   if pidx < len(merged) and merged[pidx] is None
                   else "compatible")
        pools.append({"nodepool": pool.meta.name, "verdict": verdict})
    miss = nearest_miss(enc, gi)
    tree = {
        "code": code,
        "constraint": constraint_of(code),
        "group": gi,
        "pods": int(enc.group_count[gi]) if gi < len(enc.group_count)
        else None,
        "unplaced": (int(out["unsched"][gi])
                     if isinstance(out, dict) and "unsched" in out
                     and gi < len(out["unsched"]) else None),
        "columns_total": enc.n_columns,
        "eliminations": counts,
        "pools": pools,
    }
    if miss is not None:
        tree["nearest_miss"] = miss
    sug = _suggestion(counts, enc, gi, miss)
    if sug is not None:
        tree["suggestion"] = sug
    cols = _map_detail(enc, out, gi)
    if cols is not None:
        tree["eliminated_columns"] = cols
    return tree


# -- the per-process provenance store -------------------------------------
class ExplainStore:
    """Bounded pod → explain-entry map, the `GET /debug/explain`
    backing: the provisioning controller registers every final
    unschedulable verdict (local, degraded, or remote — the tree rides
    the pickled `Reason`), newest entry wins per (pod, trace)."""

    def __init__(self, capacity: int = 512, per_pod: int = 4):
        self._lock = threading.Lock()
        self.capacity = capacity
        self.per_pod = per_pod
        self._by_pod: "Dict[str, List[dict]]" = {}
        self._order: List[str] = []   # insertion order for eviction

    def register(self, unschedulable: Dict[str, str],
                 trace_id: Optional[str] = None,
                 source: str = "local") -> int:
        n = 0
        # debug-surface timestamp (GET /debug/explain freshness / TTL
        # eviction only): never part of a solve output or digest
        now = time.time()
        with self._lock:
            for pod, reason in unschedulable.items():
                entry = {
                    "pod": pod,
                    "ts": now,
                    "trace_id": trace_id,
                    "source": source,
                    "code": code_of(reason),
                    "constraint": constraint_of(code_of(reason)),
                    "detail": str(reason),
                    "tree": getattr(reason, "tree", None),
                }
                rows = self._by_pod.get(pod)
                if rows is None:
                    rows = self._by_pod[pod] = []
                else:
                    # LRU, not first-insertion order: a chronically
                    # re-stranded pod holds the NEWEST verdict and must
                    # neither be evicted before colder pods nor drop out
                    # of the recent() listing
                    self._order.remove(pod)
                self._order.append(pod)
                rows.insert(0, entry)
                del rows[self.per_pod:]
                n += 1
            while len(self._order) > self.capacity:
                self._by_pod.pop(self._order.pop(0), None)
        return n

    def lookup(self, pod: str,
               trace_id: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            rows = self._by_pod.get(pod)
            if not rows:
                return None
            if trace_id is not None:
                for e in rows:
                    if e["trace_id"] == trace_id:
                        return dict(e)
                return None
            return dict(rows[0])

    def recent(self, limit: int = 32) -> List[dict]:
        if limit <= 0:
            return []  # order[-0:] would be the whole list, not nothing
        with self._lock:
            pods = self._order[-limit:]
            return [
                {k: self._by_pod[p][0][k]
                 for k in ("pod", "ts", "trace_id", "code", "constraint")}
                for p in reversed(pods) if self._by_pod.get(p)]

    def size(self) -> int:
        with self._lock:
            return len(self._by_pod)

    def reset(self) -> None:
        with self._lock:
            self._by_pod.clear()
            self._order.clear()


STORE = ExplainStore()


def event_message(reason) -> str:
    """`cluster.record_event` message form: code + the legacy detail —
    '[Code] detail' when structured, the plain string otherwise."""
    code = code_of(reason)
    if code == LEGACY:
        return str(reason)
    return f"[{code}] {reason}"


def reason_table() -> List[dict]:
    """The registry as rows (docs/CLI rendering)."""
    return [{"code": s.code, "constraint": s.constraint,
             "summary": s.summary}
            for s in sorted(REGISTRY.values(), key=lambda s: s.code)]


def constraint_help(name: str) -> str:
    return _CONSTRAINT_HELP.get(name, "")
