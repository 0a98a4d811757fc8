"""Server-side solver backend, executed inside kt_solverd's embedded
CPython interpreter (native/solverd.cc).

The port's copy of `karpenter_tpu/service/backend.py`.  The worker is the
same daemon started with `--module karpenter_tpu_torch.service.backend`
(`service/supervisor.py` always passes it); its solver is a `TorchSolver`
on `utils/platform.configure()`'s device — the card unless
KARPENTER_TPU_PLATFORM=cpu or KARPENTER_TPU_FORCE_CPU asks for the CPU.
The daemon calls `reset_worker_state` right after importing this module
and before it listens, and that call builds the solver and its kernels:
a worker whose kernels do not build answers every frame with an error,
and no client's first solve pays the compiler.  A fused group is one
`solve_batch` (one K5 launch of B problems, B = 1 for a singleton); only
`UnsupportedPods` reaches the host oracle, and any other failure of the
device solve answers its frames with an error — the worker never
re-solves a failed batch on the CPU.

Requests are pickled tuples `(kind, body)`:

  ("catalog", {"fingerprint", "nodepools", "instance_types"})
      Upload + content-address a catalog. The cross-process analogue of
      the solver's device-resident catalog discipline (SURVEY §7 step 2:
      uploaded once per change, not per call): schedule requests then
      reference it by fingerprint, and because the server reuses the SAME
      list objects per fingerprint, TorchSolver's identity-keyed device
      cache holds across requests.
  ("schedule", {"fingerprint", "pods", "existing_nodes", "daemon_overhead",
                "remaining_limits", "price_cap", "tenant", "priority",
                "deadline"})
      One scheduling problem.  Schedule requests flow through the
      tenant-aware dispatcher (service/scheduler.py): bounded
      per-tenant queues with weighted deficit-round-robin fairness,
      priority-aware admission, and CROSS-TENANT fusion — requests whose
      encoded problems land in the same padded (G,E,N) bucket fuse into
      ONE batched device call even when they come from different
      clusters.  The per-(fingerprint,max_nodes) fusion that used to
      live inline here is now the inner stage of that scheduler.

Responses: ("result", ScheduleResult) | ("ok", None) |
           ("need_catalog", None) | ("error", message) |
           ("shed", {reason, tenant, queue_depth, eta_ms,
                     retry_after_ms})
The shed body doubles as the backpressure hint; successful results carry
the same hint as `result._backpressure` so clients pace retries from the
server's own queue estimate.
"""

from __future__ import annotations

import pickle
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.utils import faults

_catalogs: Dict[str, Tuple[list, dict]] = {}
_solver = None
# per-dispatch sizes of the schedule groups actually fused onto the
# device — exposed via the ("stats", _) request for tests/observability;
# bounded so a long-running daemon doesn't grow it forever.  Reset on
# worker init (reset_worker_state) and snapshotted under _state_lock:
# in-process harnesses restart the LOGICAL worker without restarting the
# process, and stats() must never report pre-restart history.
_batch_log: deque = deque(maxlen=1024)
# requests shed because their caller's deadline had already passed (at
# ingest or while queued in the tenant scheduler) or because admission
# control refused them — the daemon's half of the deadline/backpressure
# contract, reported via stats
_shed_count = 0
# the tenant-aware dispatcher (built lazily so stats-only callers never
# pay for it); guarded, like the counters above, by _state_lock
_scheduler = None
_state_lock = threading.Lock()


def reset_worker_state() -> None:
    """A fresh LOGICAL worker: clear the per-worker dispatch history
    (batch log, shed count, tenant queues/ledgers).  Called by the
    daemon right after importing this module (native/solverd.cc) and by
    in-process harnesses (service/loopback.py) on start, so a restarted
    worker never reports its predecessor's stats.  Uploaded catalogs
    survive deliberately — they are content-addressed and the
    need_catalog handshake re-validates them anyway."""
    global _shed_count, _scheduler
    with _state_lock:
        _batch_log.clear()
        _shed_count = 0
        _scheduler = None
    # the worker's boot: its solver, and on the card its kernels, built
    # before the daemon listens (never inside a client's first solve)
    _get_solver()


def _get_scheduler():
    global _scheduler
    with _state_lock:
        if _scheduler is None:
            from karpenter_tpu_torch.service.scheduler import TenantScheduler
            _scheduler = TenantScheduler()
        return _scheduler


def _get_solver():
    global _solver
    if _solver is None:
        import os
        # KARPENTER_TPU_PLATFORM / KARPENTER_TPU_FORCE_CPU choose the
        # device, the card by default; on the card configure() builds
        # every kernel (one nvcc per source) and raises if one does not
        from karpenter_tpu_torch.utils.platform import configure
        device = configure()
        from karpenter_tpu_torch.solver import TorchSolver
        # SOLVER_MESH picks the daemon's mesh story the same way the
        # operator options do; KARPENTER_TPU_MESH (read inside the
        # solver per _resolve_mesh) stays the rollback override that
        # beats whatever was configured here
        # SOLVER_DELTA configures the daemon's delta-solve story the
        # same way; KARPENTER_TPU_DELTA stays the rollback override.
        # The delta cache lives server-side (records are device-adjacent
        # and far too heavy to ship per request): the daemon's own
        # value-based diff re-validates unpickled pods/nodes per pass.
        solver = TorchSolver(
            max_nodes=int(os.environ.get("KARPENTER_TPU_MAX_NODES", "2048")),
            device=device,
            mesh=os.environ.get("SOLVER_MESH", "auto"),
            delta=os.environ.get("SOLVER_DELTA", "auto"))
        if solver.device.type == "cuda":
            import torch
            torch.cuda.init()  # the context at boot, not in a solve
        _solver = solver
    return _solver


def _worker_info() -> dict:
    """What the worker process runs on, for the stats RPC: its
    interpreter, torch build, device, the kernels' launch counts since
    the process started, and the device memory it holds."""
    import os
    import sys

    import torch

    from karpenter_tpu_torch.solver import ffd
    info = {"pid": os.getpid(), "executable": sys.executable,
            "python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": None if _solver is None else str(_solver.device),
            "launches": ffd.launch_counts()}
    if _solver is not None and _solver.device.type == "cuda":
        dev = _solver.device
        info["device_name"] = torch.cuda.get_device_name(dev)
        info["memory_allocated"] = torch.cuda.memory_allocated(dev)
        info["max_memory_reserved"] = torch.cuda.max_memory_reserved(dev)
    return info


def _solve_group(inps: List, max_nodes: Optional[int] = None) -> List:
    """Device batch with per-input fallback (never fail — SURVEY §5):
    first the whole fused batch, then per-input device/split solves, and
    only a truly unsupported input reaches the host oracle."""
    from karpenter_tpu_torch.scheduling import Scheduler
    from karpenter_tpu_torch.solver import UnsupportedPods
    try:
        # singleton groups stay on solve_batch (one K5 launch at B = 1),
        # as the reference keeps them: one launch family per deployment
        # (phase observability rides the batch path's own spans and
        # histograms instead)
        return _get_solver().solve_batch(inps, max_nodes=max_nodes)
    except UnsupportedPods:
        out = []
        for inp in inps:
            try:
                out.append(_get_solver().solve(inp))
            except UnsupportedPods:
                out.append(Scheduler(inp).solve())
        return out


def _flight_record_batch(fp: str, inps: List, results: List,
                         max_nodes, tenants=()) -> None:
    """One flight record per fused solverd batch (the daemon's half of
    the request-record split): the catalog fingerprint the requests
    referenced, per-request pod counts, the tenants the fusion mixed,
    and a bit-exact digest per result — the solver's own per-attempt
    records carry the phase detail; this row ties a wire batch to them.
    Best-effort: the black box must never fail a batch."""
    try:
        from karpenter_tpu_torch.utils import flightrecorder as fr
        from karpenter_tpu_torch.utils import metrics, tracing
        rec = fr.RECORDER
        if not rec.enabled:
            return
        solver = _solver
        metrics.FLIGHT_RECORDS.inc(kind="batch")
        rec.record(
            kind="batch",
            trace_id=tracing.current_trace_id(),
            catalog={"fingerprint": fp},
            fingerprint=fp[:16] if isinstance(fp, str) else None,
            pods=sum(len(i.pods) for i in inps),
            groups=len(inps),
            knobs={"max_nodes": max_nodes,
                   "tenants": sorted(set(tenants))},
            phase_ms=dict(getattr(solver, "last_phase_ms", {}) or {})
            if solver is not None else {},
            delta=None,
            retraces=None,
            device_memory_peak_bytes=None,
            result={"requests": len(inps),
                    "digests": [fr.result_digest(r) for r in results]},
            capture=None,
        )
    except Exception:  # noqa: BLE001 — telemetry, never the data path
        pass


def _bucket_key(fp: str, max_nodes, body: dict) -> tuple:
    """The fusion-bucket key: requests fuse only when their PADDED device
    shapes match — same catalog fingerprint, same node-axis cap (a
    static kernel shape), same padded group-count and existing-node
    buckets.  This is exactly the launch-shape key the warmup lattice
    pre-traces, so a cross-tenant fused batch reuses warmed programs
    instead of opening new compile cliffs.  The group count normally
    arrives as the client-computed `groups_hint` (so this daemon's
    single batcher thread doesn't pay a second O(pods) grouping per
    frame; a wrong hint only costs fusion efficiency — the solve
    re-groups authoritatively); hintless frames run `group_pods` here,
    and anything unexpected degrades the key to per-fingerprint
    fusion — the pre-scheduler behavior — rather than failing the
    request."""
    try:
        from karpenter_tpu_torch.solver.encode import bucket, group_pods
        from karpenter_tpu_torch.solver.solve import E_BUCKETS, G_BUCKETS
        hint = body.get("groups_hint")
        n_groups = int(hint) if isinstance(hint, int) and hint > 0 \
            else len(group_pods(body["pods"]))
        g = bucket(max(n_groups, 1), G_BUCKETS)
        e = bucket(len(body.get("existing_nodes") or []), E_BUCKETS)
    except Exception:  # noqa: BLE001 — degrade, never refuse
        g = e = None
    return (fp, max_nodes, g, e)


def _tenant_of(body: dict, conn_ids, i: int) -> str:
    """Client-declared tenant, else a per-connection identity (each
    control-plane replica's connection is its own tenant by default)."""
    tenant = body.get("tenant")
    if tenant:
        return str(tenant)
    if conn_ids is not None and i < len(conn_ids):
        return f"conn-{conn_ids[i]}"
    return "default"


def _dispatch_fused(key, batch) -> List[tuple]:
    """The inner dispatch stage: one fused (fingerprint, max_nodes,
    bucket) group → one batched device call.  Runs OUTSIDE the
    scheduler's queue lock (only the dispatcher election serializes it).
    Returns one response tuple per batch item."""
    from karpenter_tpu_torch.scheduling import ScheduleInput
    from karpenter_tpu_torch.utils import tracing
    fp, max_nodes = key[0], key[1]
    with _state_lock:
        _batch_log.append(len(batch))
        cat = _catalogs.get(fp)
    if cat is None:
        # the catalog vanished between admission and dispatch (only
        # possible through an in-process reset): the handshake recovers
        return [("need_catalog", None)] * len(batch)
    nodepools, instance_types = cat
    inps = []
    for item in batch:
        _i, body = item.payload
        inps.append(ScheduleInput(
            pods=body["pods"],
            nodepools=nodepools,
            instance_types=instance_types,
            existing_nodes=body.get("existing_nodes") or [],
            daemon_overhead=body.get("daemon_overhead") or {},
            remaining_limits=body.get("remaining_limits") or {},
            price_cap=body.get("price_cap"),
        ))
    # stitch the fused solve into the CALLER's trace: extract the
    # first traceparent in the group (a fused batch normally comes
    # from one operator client), run the solve as its child, and ship
    # the recorded spans back on each matching response — the spans
    # belong to the caller's ring buffer, not this daemon's
    tp = next((item.payload[1].get("traceparent") for item in batch
               if item.payload[1].get("traceparent")), None)
    ctx = tracing.extract(tp)
    try:
        with ctx:
            with tracing.span("solverd.solve_batch", requests=len(batch),
                              tenants=len({it.tenant for it in batch})):
                results = _solve_group(inps, max_nodes=max_nodes)
        _flight_record_batch(fp, inps, results, max_nodes,
                             tenants=[it.tenant for it in batch])
        hint = _get_scheduler().backpressure()
        spans = [s.to_dict() for s in ctx.spans]
        out: List[tuple] = []
        for item, res in zip(batch, results):
            if spans and item.payload[1].get("traceparent") == tp:
                try:
                    # exactly ONE response carries the group's spans: a
                    # fused 60-sim batch attaching (and the client
                    # adopting) the same list per result would
                    # duplicate every span ~60x in the caller's trace
                    res._remote_spans = spans
                    spans = []
                except AttributeError:
                    pass  # a slotted result type: spans are best-effort
            try:
                # explicit backpressure: the client adapts its retry
                # pacing to the daemon's own queue estimate instead of
                # blind exponential backoff
                res._backpressure = dict(hint)
            except AttributeError:
                pass
            out.append(("result", res))
        return out
    except Exception as e:  # noqa: BLE001
        return [("error", f"solve failed: {e}")] * len(batch)


def handle_batch(payloads: List[bytes], conn_ids=None,
                 backlog: int = 0) -> List[bytes]:
    """One C++ window's worth of frames.  `conn_ids` (parallel to
    `payloads`) carries the daemon's per-connection identities for the
    default-tenant derivation; `backlog` is the window queue depth
    BEHIND this batch, folded into every backpressure hint.  Both are
    optional so in-process callers (tests, FakePySolverd) keep working
    with bare payload lists."""
    global _shed_count
    from karpenter_tpu_torch.scheduling import ScheduleInput

    # fault-matrix hook (utils/faults.py): `crash` here is the
    # worker-killed-mid-batch scenario — the supervisor must restart the
    # process and clients must fail their in-flight requests fast
    faults.fire("solverd.handle_batch")

    n = len(payloads)
    responses: List[Optional[tuple]] = [None] * n
    requests: List[Optional[tuple]] = [None] * n
    for i, raw in enumerate(payloads):
        # one replica's malformed frame must never poison the coalesced
        # batch — validate shape per request, answer per request
        try:
            req = pickle.loads(raw)
            if not (isinstance(req, tuple) and len(req) == 2
                    and isinstance(req[1], dict)):
                raise ValueError("request must be a (kind, body-dict) tuple")
            requests[i] = req
        except Exception as e:  # noqa: BLE001
            responses[i] = ("error", f"unpicklable request: {e}")

    # catalog uploads first so same-batch schedule requests can use them
    for i, req in enumerate(requests):
        if req is None or responses[i] is not None:
            continue
        kind, body = req
        if kind == "catalog":
            try:
                _catalogs[body["fingerprint"]] = (
                    body["nodepools"], body["instance_types"])
                responses[i] = ("ok", None)
            except KeyError as e:
                responses[i] = ("error", f"catalog body missing {e}")
        elif kind == "stats":
            # mesh observability: remote operators (and the multichip
            # bench) see whether the daemon actually sharded, and how
            # much O-axis traffic the resident path has shipped
            mesh_info = None
            if _solver is not None and _solver._mesh_exec is not None:
                ex = _solver._mesh_exec
                mesh_info = {
                    "devices": _solver.mesh.size,
                    "o_axis_transfers": len(ex.transfers),
                    "o_axis_bytes": sum(b for _, b in ex.transfers),
                }
            # the worker's telemetry snapshot rides the stats RPC: this
            # is how the daemon's solve-rate, phase latencies, delta
            # split, retraces, and flight-recorder tail reach the
            # operator's GET /debug/dashboard without the daemon
            # exposing its own HTTP surface (utils/telemetry.py merges
            # it alongside the supervisor's and the operator's own).
            # The per-tenant scheduler section is how "one solver,
            # many clusters" stays operable: queue depth, fairness
            # share, shed and fusion counters per tenant.
            from karpenter_tpu_torch.utils import telemetry
            with _state_lock:
                batch_sizes = list(_batch_log)
                shed = _shed_count
                sched = _scheduler
            responses[i] = ("result", {"batch_sizes": batch_sizes,
                                       "catalogs": len(_catalogs),
                                       "shed": shed,
                                       "mesh": mesh_info,
                                       "scheduler":
                                           sched.stats() if sched else None,
                                       "telemetry":
                                           telemetry.local_snapshot(),
                                       "worker": _worker_info()})
        elif kind == "warmup":
            # padding-bucket precompile against an uploaded catalog: the
            # operator fires this at startup so the daemon's first real
            # schedule request meets a fully-compiled kernel lattice
            # (solve.py warmup: each bucketed launch configuration
            # launched once; the kernels were built at the worker's boot)
            deadline = body.get("deadline")
            if deadline is not None and time.time() >= deadline:
                # the shed contract covers warmup FIRST of all: it is
                # the most expensive request kind, and a queued warmup
                # whose caller already gave up would hold the single
                # batcher thread through minutes of compile while real
                # schedule requests wait behind it
                with _state_lock:
                    _shed_count += 1
                responses[i] = _get_scheduler().shed_inline(
                    _tenant_of(body, conn_ids, i), "deadline")
                continue
            fp = body.get("fingerprint")
            if fp not in _catalogs:
                responses[i] = ("need_catalog", None)
                continue
            nodepools, instance_types = _catalogs[fp]
            try:
                inp = ScheduleInput(
                    pods=body.get("pods") or [],
                    nodepools=nodepools,
                    instance_types=instance_types,
                    existing_nodes=body.get("existing_nodes") or [],
                    daemon_overhead=body.get("daemon_overhead") or {},
                    remaining_limits=body.get("remaining_limits") or {},
                )
                warmed = _get_solver().warmup(
                    inp, shapes=tuple(body.get("shapes") or ()),
                    batch_sizes=tuple(body.get("batch_sizes") or (1,)))
                responses[i] = ("result", {"warmed": warmed})
            except Exception as e:  # noqa: BLE001
                responses[i] = ("error", f"warmup failed: {e}")

    # schedule requests flow through the tenant scheduler: bounded
    # per-tenant queues → weighted-DRR planning → cross-tenant
    # bucket-fused device dispatches (_dispatch_fused is the inner
    # stage the old inline (fingerprint, max_nodes) grouping became)
    sched = None
    items = []
    for i, req in enumerate(requests):
        if req is None or responses[i] is not None:
            continue
        kind, body = req
        if kind != "schedule":
            responses[i] = ("error", f"unknown request kind {kind!r}")
            continue
        fp = body.get("fingerprint")
        if "pods" not in body:
            responses[i] = ("error", "schedule body missing pods")
            continue
        tenant = _tenant_of(body, conn_ids, i)
        deadline = body.get("deadline")
        if deadline is not None and time.time() >= deadline:
            # the caller's deadline already passed (it timed out, fell
            # back, and will re-send the pods next pass): solving now
            # burns the device for a result nobody reads, and behind a
            # restart backlog it keeps the daemon permanently late —
            # shed instead (peers share this host's clock)
            with _state_lock:
                _shed_count += 1
            responses[i] = _get_scheduler().shed_inline(tenant, "deadline")
            continue
        if fp not in _catalogs:
            responses[i] = ("need_catalog", None)
            continue
        if sched is None:
            sched = _get_scheduler()
            sched.note_backlog(backlog)

        def _respond(resp, i=i):
            if resp[0] == "shed":
                global _shed_count
                with _state_lock:
                    _shed_count += 1
            responses[i] = resp

        items.append(sched.submit(
            key=_bucket_key(fp, body.get("max_nodes"), body),
            tenant=tenant,
            priority=int(body.get("priority") or 0),
            deadline=deadline,
            payload=(i, body),
            respond=_respond))
    if items:
        sched.pump(items, _dispatch_fused)

    return [pickle.dumps(r, protocol=pickle.HIGHEST_PROTOCOL)
            for r in responses]
