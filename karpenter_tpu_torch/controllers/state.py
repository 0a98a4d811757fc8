"""Cluster-state → ScheduleInput assembly, shared by the provisioner and
the disruption simulator (SURVEY §2.2 Cluster state: one in-memory model
feeds both hot paths).

The port's copy of `karpenter_tpu/controllers/state.py`: `GatedSolver`
builds a `TorchSolver` where the reference builds a `TPUSolver`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from karpenter_tpu_torch.cloudprovider import TPUCloudProvider
from karpenter_tpu_torch.cluster import Cluster
from karpenter_tpu_torch.models.objects import InstanceType, NodePool, Pod
from karpenter_tpu_torch.models.resources import Resources
from karpenter_tpu_torch.models.taints import tolerates_all
from karpenter_tpu_torch.scheduling import ExistingNode, ScheduleInput
from karpenter_tpu_torch.scheduling.types import effective_request


class SolveCacheFeed:
    """Cluster-event half of the solver's delta SolveCache
    (solver/delta.py): subscribes a cluster watch and drains store
    mutations into (dirty pod names, dirty node names) for
    ``TorchSolver.delta_invalidate`` — only the touched groups/nodes are
    invalidated, so a steady-state pass stays O(churn).  Node-shaped
    events (nodes, nodeclaims) invalidate cached node rows; pod events
    mark their groups changed.  A ChangeMonitor gates the invalidation
    log line so a churn-heavy cluster doesn't spam per-pass."""

    _NODE_KINDS = ("nodes", "nodeclaims")

    def __init__(self, cluster: Cluster):
        from karpenter_tpu_torch.utils.logging import ChangeMonitor
        self._cluster = cluster
        self._watch = cluster.watch()
        self._monitor = ChangeMonitor()

    def drain(self):
        """(dirty pod names, dirty node names, flood).  The cluster
        Watch's bounded buffer drops OLD events on overflow — harmless
        for its level-driven consumers, but THIS consumer is
        edge-driven: a dropped node event is a lost invalidation.  A
        full drain therefore reports flood=True and the cache degrades
        to all-dirty (one counted fallback), never a silent miss."""
        pods, nodes, flood, _claims = self._drain_kinds()
        return set(pods), set(nodes), flood

    def _drain_kinds(self):
        """drain() plus the nodeclaim-kind subset of the node names —
        the incremental index absorbs claim events
        separately (a claim without a registered node row changes no
        cached row), while the walk path keeps treating them as node
        dirt."""
        events = self._watch.drain()
        # dicts, not sets: the index's member-order contract needs pod
        # names in FIRST-occurrence event order (== store-append order
        # for creations); the walk path only reads them as sets
        pods: dict = {}
        nodes: dict = {}
        claims: set = set()
        for ev in events:
            if ev.kind == "pods":
                pods.setdefault(ev.name, None)
            elif ev.kind in self._NODE_KINDS:
                nodes.setdefault(ev.name, None)
                if ev.kind == "nodeclaims":
                    claims.add(ev.name)
        flood = len(events) >= (self._watch._buffer.maxlen or 0)
        return pods, nodes, flood, claims

    def feed(self, solver) -> None:
        """Drain and forward to a solver that supports the delta seam
        (the in-process TorchSolver; the remote client's daemon runs its
        own value-based diff and needs no feed).  Each dirty name is
        resolved to its CURRENT object (None = deleted) so the
        solver's incremental index can absorb the event at feed time —
        an O(churn) store probe here replaces an O(cluster) walk per
        solve pass.  Claim-kind names resolve through the node store
        too (a registered claim shares its node's name; an unregistered
        one resolves to None and only dirties the index if a cached
        row bears the name)."""
        pods, nodes, flood, claims = self._drain_kinds()
        if not pods and not nodes and not flood:
            return
        inval = getattr(solver, "delta_invalidate", None)
        if inval is None:
            return
        cl = self._cluster
        # resolved in event order (pod_objs' insertion order carries
        # the store-append order the index's member contract needs)
        pod_objs = {n: cl.pods.get(n) for n in pods}
        node_objs = {n: cl.nodes.get(n)
                     for n in nodes if n not in claims}
        try:
            inval(pods=set(pods), nodes=set(nodes), flood=flood,
                  pod_objs=pod_objs, node_objs=node_objs,
                  claims=tuple(claims))
        except TypeError:
            # an older solver seam (remote daemon shim, test double)
            # that predates the object-bearing feed: name sets carry
            # all the walk path needs
            inval(pods=set(pods), nodes=set(nodes), flood=flood)
        from karpenter_tpu_torch.utils.logging import get_logger
        if self._monitor.has_changed(
                "delta-invalidate", (len(pods), len(nodes), flood)):
            get_logger("solver").debug(
                "delta cache invalidation", pods=len(pods),
                nodes=len(nodes), flood=flood)


class GatedSolver:
    """The device solver behind its feature gate with the CPU oracle as
    fallback — shared by the provisioner and the disruption simulator so
    they share one device catalog cache (solver down ⇒ fall back, never
    fail — SURVEY §5).

    The port's GatedSolver builds a `TorchSolver` on `device` ("cuda", the
    card, by default; the tests pass "cpu").  On the card the oracle
    answers only the pods the encoder cannot express (`UnsupportedPods`):
    a kernel that fails to build or launch, or any other error of the
    device solve or its warm-up, propagates to the caller instead of
    moving the work to the CPU unseen.  A fault armed at the
    `solver.dispatch` point (`utils/faults.py`) is such an error: on the
    card it raises too.  A solver on the CPU keeps the
    reference's degrade-to-the-oracle behaviour.

    With `options.solver_endpoint` set, `tpu` is the remote client of a
    kt_solverd worker (`service/`), as in the reference.  A failed remote
    solve records a `SolverFallback` event and enters DEGRADED MODE: an
    in-process `TorchSolver` on `device`, built at the first degraded
    solve, answers under a `solver.degraded_local` span.  It follows the
    in-process rule: on the card a failure of the degraded solve raises,
    and only `UnsupportedPods` (or a degraded solver on the CPU) reaches
    the oracle.  Neither the remote nor the degraded solver arms the
    incremental index."""

    # the in-process topology unless __init__ finds an endpoint
    _remote = False
    _local = None

    def __init__(self, options, cluster: Cluster, device="cuda"):
        self.options = options
        self.cluster = cluster
        self.device = device
        # lazily-built in-process solver used as DEGRADED MODE when the
        # remote service is down/breaker-open: better than the oracle,
        # never constructed while the service is healthy. The lock
        # guards the lazy init — the provisioner and the disruption
        # simulator share this GatedSolver and can hit the degraded path
        # concurrently, and a TorchSolver construction is too expensive
        # to duplicate.
        self._remote = bool(options.solver_endpoint)
        self._local = None
        import threading
        self._local_init_lock = threading.Lock()
        if options.solver_endpoint:
            # remote card-owning solver process (native/solverd.cc): same
            # solve/solve_batch seam, coalesced in the daemon's window.
            # The client carries the shared availability layer — bounded
            # retries with backoff, per-request deadlines shipped in the
            # frame, and the circuit breaker whose open state is what
            # "degraded mode" means operationally.
            from karpenter_tpu_torch.service import (
                CircuitBreaker,
                RetryPolicy,
                SolverServiceClient,
            )
            timeout = getattr(options, "service_request_timeout", 60.0)
            self.tpu = SolverServiceClient(
                options.solver_endpoint,
                timeout=timeout,
                retry=RetryPolicy(
                    attempts=getattr(options, "service_retry_attempts", 3),
                    deadline=timeout),
                breaker=CircuitBreaker(
                    threshold=getattr(options,
                                      "service_breaker_threshold", 5),
                    cooldown=getattr(options,
                                     "service_breaker_cooldown", 10.0)),
                # one cluster = one tenant by default, so a shared
                # solverd queues this control plane fairly against its
                # peer clusters
                tenant=getattr(options, "service_tenant", None)
                or getattr(options, "cluster_name", None),
                priority=getattr(options, "service_priority", 0))
        else:
            # SOLVER_MESH / SOLVER_DELTA configure the mesh and delta
            # stories; KARPENTER_TPU_MESH / KARPENTER_TPU_DELTA are the
            # rollback knobs, resolved inside the solver
            self.tpu = self._torch_solver(
                incr=getattr(options, "solver_incr", "auto"))
            # event-driven delta-cache invalidation: cluster watch →
            # dirty pod/node names → TorchSolver.delta_invalidate
            self._delta_feed = SolveCacheFeed(cluster)
            # the feed delivers OBJECTS with every event from here on,
            # so the solver's "auto" incremental index may trust the
            # stream — arming stays strictly tied to the feed's
            # existence; the remote/degraded solvers never arm
            self.tpu.incr_arm()
        # warm the native host-ops build at startup, never inside a
        # latency-sensitive solve (the degraded solver's host paths too)
        from karpenter_tpu_torch.native import hostops
        hostops()

    def _torch_solver(self, incr="auto"):
        from karpenter_tpu_torch.solver import TorchSolver
        return TorchSolver(
            max_nodes=self.options.solver_max_nodes,
            device=self.device,
            mesh=getattr(self.options, "solver_mesh", "auto"),
            delta=getattr(self.options, "solver_delta", "auto"),
            incr=incr)

    def _on_card(self, solver=None) -> bool:
        """True when the solver's tensors live on the card (the
        in-process solver's, or the given one's): its failures then
        propagate rather than fall back to the oracle."""
        solver = self.tpu if solver is None else solver
        return getattr(getattr(solver, "device", None), "type",
                       None) == "cuda"

    # largest pod batch one ORACLE pass will chew through when the device
    # path is down: at ~2.4k pods/s of oracle throughput this caps a
    # degraded provisioning pass near ~3 s instead of the 20 s cliff the
    # 50k headline would cost. Shed pods stay PENDING — the provisioner
    # re-batches them next pass, so a device outage degrades to
    # bounded-latency incremental progress, never a stalled loop or
    # spurious unschedulable verdicts.
    ORACLE_SHED_LIMIT = 8000

    def _local_solver(self):
        """The degraded-mode in-process solver behind the remote client.
        None when this GatedSolver IS the in-process solver (nothing to
        degrade to but the oracle) or the fallback is disabled."""
        if not self._remote or not getattr(
                self.options, "service_local_fallback", True):
            return None
        if self._local is None:
            with self._local_init_lock:
                if self._local is None:
                    self._local = self._torch_solver()
        return self._local

    def _degraded_solve(self, inp: ScheduleInput, source: str,
                        max_nodes: Optional[int]):
        """One in-process solve while the service is unavailable.
        Returns None to fall through to the oracle: for `UnsupportedPods`,
        and for any other failure of a degraded solver on the CPU; on the
        card that failure raises."""
        local = self._local_solver()
        if local is None:
            return None
        from karpenter_tpu_torch.solver import UnsupportedPods
        from karpenter_tpu_torch.utils import tracing
        try:
            with tracing.span("solver.degraded_local", source=source,
                              pods=len(inp.pods)):
                return local.solve(inp, max_nodes=max_nodes)
        except UnsupportedPods:
            return None
        except Exception as e:  # noqa: BLE001
            if self._on_card(local):
                raise
            from karpenter_tpu_torch.utils.logging import get_logger
            get_logger("solver").warn(
                "degraded-mode local solve failed; falling back to oracle",
                source=source, error=str(e)[:200])
            return None

    def solve(self, inp: ScheduleInput, source: str = "solver",
              max_nodes: Optional[int] = None):
        from karpenter_tpu_torch.scheduling import Scheduler
        from karpenter_tpu_torch.solver import UnsupportedPods
        from karpenter_tpu_torch.utils import metrics, tracing
        if self.options.feature_gates.tpu_solver:
            feed = getattr(self, "_delta_feed", None)
            if feed is not None:
                feed.feed(self.tpu)
            try:
                return self.tpu.solve(inp, max_nodes=max_nodes)
            except UnsupportedPods:
                pass  # constraints the encoder can't express yet → oracle
            except Exception as e:  # noqa: BLE001
                if not self._remote and self._on_card():
                    raise
                from karpenter_tpu_torch.utils.logging import get_logger
                get_logger("solver").warn(
                    "device solve failed; entering degraded mode"
                    if self._remote else
                    "device solve failed; falling back to the oracle",
                    source=source, error=str(e)[:200])
                self.cluster.record_event(
                    "Provisioner", source, "SolverFallback", str(e))
                res = self._degraded_solve(inp, source, max_nodes)
                if res is not None:
                    return res
        metrics.SOLVER_SOLVES.inc(path="oracle")
        # load shedding is only sound for PROVISIONING (unsolved pods stay
        # pending and retry): a disruption simulation must judge its whole
        # pod set or its feasible/infeasible verdict is meaningless
        if (source == "provisioning"
                and len(inp.pods) > self.ORACLE_SHED_LIMIT):
            import dataclasses
            shed = len(inp.pods) - self.ORACLE_SHED_LIMIT
            metrics.SOLVER_SHED_PODS.inc(shed)
            self.cluster.record_event(
                "Provisioner", source, "SolverLoadShed",
                f"oracle fallback: deferring {shed} pods to the next pass")
            inp = dataclasses.replace(
                inp, pods=inp.pods[:self.ORACLE_SHED_LIMIT])
        with tracing.span("solver.oracle", pods=len(inp.pods),
                          source=source):
            return Scheduler(inp).solve()

    def warmup(self, inp: ScheduleInput, shapes=()) -> int:
        """The solver's first-use costs paid at operator startup (never on
        the solve path): delegates to `TorchSolver.warmup`, or to the
        solverd client's remote variant.  Best-effort on the CPU and
        through the service — a warm-up failure degrades to cold first
        solves, never blocks or crashes the operator, and returns 0; for
        the in-process solver on the card a failure (a kernel that does
        not build or launch) propagates."""
        if not self.options.feature_gates.tpu_solver:
            return 0
        try:
            return self.tpu.warmup(inp, shapes=shapes)
        except Exception as e:  # noqa: BLE001
            if not self._remote and self._on_card():
                raise
            from karpenter_tpu_torch.utils.logging import get_logger
            get_logger("solver").warn(
                "solver warm-up failed; first solves run cold",
                error=str(e)[:200])
            return 0

    def solve_batch(self, inps: List[ScheduleInput],
                    source: str = "disruption",
                    max_nodes: Optional[int] = None):
        """Batched simulations sharing one cluster snapshot (consolidation's
        candidate axis). Returns an iterable: the device path is one eager
        batched call; the oracle fallback is LAZY, so a caller that stops at
        the first acceptable result (the disruption loop) never pays for the
        simulations it doesn't consume. Each simulation records one
        observation on the per-simulation duration histogram."""
        import time as _time

        from karpenter_tpu_torch.scheduling import Scheduler
        from karpenter_tpu_torch.solver import UnsupportedPods
        from karpenter_tpu_torch.utils import metrics, tracing
        if self.options.feature_gates.tpu_solver:
            try:
                t0 = _time.perf_counter()
                # both backends (in-process TorchSolver,
                # SolverServiceClient) accept the per-call kernel cap
                results = self.tpu.solve_batch(inps, max_nodes=max_nodes)
                if results:
                    per = (_time.perf_counter() - t0) / len(results)
                    for _ in results:
                        metrics.SCHEDULING_SIMULATION_DURATION.observe(per)
                return results
            except UnsupportedPods:
                # per-input retry: each simulation gets its own shot at
                # the device (solve() split-solves inexpressible groups);
                # only truly unsupported inputs reach the oracle inside.
                # The caller's kernel cap rides along
                def _per_input():
                    for inp in inps:
                        with metrics.SCHEDULING_SIMULATION_DURATION.time():
                            yield self.solve(inp, source=source,
                                             max_nodes=max_nodes)
                return _per_input()
            except Exception as e:  # noqa: BLE001
                if not self._remote and self._on_card():
                    raise
                self.cluster.record_event(
                    "Provisioner", source, "SolverFallback", str(e))
                local = self._local_solver()
                if local is not None:
                    try:
                        t0 = _time.perf_counter()
                        with tracing.span("solver.degraded_local",
                                          source=source,
                                          requests=len(inps)):
                            results = local.solve_batch(
                                inps, max_nodes=max_nodes)
                        if results:
                            per = (_time.perf_counter() - t0) / len(results)
                            for _ in results:
                                metrics.SCHEDULING_SIMULATION_DURATION \
                                    .observe(per)
                        return results
                    except UnsupportedPods:
                        # per-input retry on the LOCAL solver/oracle
                        # only: re-entering self.solve here would pay a
                        # fresh remote retry deadline per input against
                        # the service we just watched fail
                        def _per_input_degraded():
                            for inp in inps:
                                # observe BEFORE yielding: a timer held
                                # across the yield would also clock the
                                # consumer's work (and an abandoned
                                # generator's whole lifetime) into the
                                # simulation histogram
                                t0 = _time.perf_counter()
                                res = self._degraded_solve(
                                    inp, source, max_nodes)
                                if res is None:
                                    metrics.SOLVER_SOLVES.inc(
                                        path="oracle")
                                    res = Scheduler(inp).solve()
                                metrics.SCHEDULING_SIMULATION_DURATION \
                                    .observe(_time.perf_counter() - t0)
                                yield res
                        return _per_input_degraded()
                    except Exception as e2:  # noqa: BLE001
                        if self._on_card(local):
                            raise
                        from karpenter_tpu_torch.utils.logging import (
                            get_logger)
                        get_logger("solver").warn(
                            "degraded-mode local batch failed; oracle",
                            source=source, error=str(e2)[:200])

        def _lazy():
            metrics.SOLVER_SOLVES.inc(path="oracle")
            for inp in inps:
                with metrics.SCHEDULING_SIMULATION_DURATION.time():
                    yield Scheduler(inp).solve()
        return _lazy()


def daemon_overhead(cluster: Cluster, pool: NodePool) -> Resources:
    """Aggregate requests of daemonset pods a new node in this pool would
    run (daemonset overhead accounting — SURVEY §2.2 scheduler)."""
    template = pool.template_requirements()
    total = Resources()
    for pod in cluster.daemonset_pods():
        if not tolerates_all(pool.taints, pod.tolerations):
            continue
        if not template.compatible(pod.requirements):
            continue
        total += effective_request(pod)
    return total


def remaining_limit(cluster: Cluster, pool: NodePool,
                    exclude_claims: Set[str] = frozenset()) -> Optional[Resources]:
    if pool.limits is None:
        return None
    used = Resources()
    for claim in cluster.nodeclaims.list(lambda c: c.nodepool == pool.name):
        if claim.name in exclude_claims:
            continue
        # unlaunched claims have no capacity yet — charge their planned
        # requests so stalled launches still hold their limit reservation
        used += (claim.capacity if not claim.capacity.is_zero()
                 else claim.resource_requests)
    return pool.limits - used




def build_existing_nodes(
        cluster: Cluster,
        exclude_nodes: Set[str] = frozenset()) -> List[ExistingNode]:
    """Snapshot every live node as an ExistingNode. The consolidation
    sweep builds this ONCE (no exclusions) and shares the wrapper objects
    across its candidate simulations — both to avoid the O(nodes) rebuild
    per simulation and so the solver's per-batch union cache
    (SharedExistEncoding) can key work by object identity. `exclude_nodes`
    skips candidates BEFORE the resident-pod walk so single-simulation
    callers don't pay for wrappers they immediately discard."""
    existing: List[ExistingNode] = []
    for node in cluster.nodes.list(lambda n: not n.meta.deleting):
        if node.name in exclude_nodes:
            continue
        resident = cluster.pods_on_node(node.name)
        used = Resources()
        for pod in resident:
            used += effective_request(pod)
        existing.append(ExistingNode(
            node=node, available=node.allocatable - used, pods=resident))
    return existing


def build_schedule_input(
    cluster: Cluster,
    cp: TPUCloudProvider,
    pods: List[Pod],
    exclude_nodes: Set[str] = frozenset(),
    exclude_claims: Set[str] = frozenset(),
    price_cap: Optional[float] = None,
    prebuilt_existing: Optional[List[ExistingNode]] = None,
) -> ScheduleInput:
    pools: List[NodePool] = cluster.nodepools.list(
        lambda np_: not np_.meta.deleting)
    # NOTE: price_cap rides on ScheduleInput instead of pre-filtering the
    # type lists — filtering would hand the TPU solver a fresh list object
    # per simulation and thrash its device-resident catalog cache
    instance_types: Dict[str, List[InstanceType]] = {
        p.name: cp.get_instance_types(p.node_class_ref) for p in pools}

    exist_base = None
    exist_excluded = None
    if prebuilt_existing is not None:
        existing = [en for en in prebuilt_existing
                    if en.name not in exclude_nodes]
        # leave-k-out provenance for the batched sweep: the solver encodes
        # the shared snapshot once and expresses this input as exclusion
        # indices on the device (ScheduleInput.exist_base contract)
        exist_base = prebuilt_existing
        exist_excluded = tuple(
            i for i, en in enumerate(prebuilt_existing)
            if en.name in exclude_nodes)
    else:
        existing = build_existing_nodes(cluster, exclude_nodes)

    return ScheduleInput(
        pods=pods,
        nodepools=pools,
        instance_types=instance_types,
        existing_nodes=existing,
        daemon_overhead={p.name: daemon_overhead(cluster, p) for p in pools},
        remaining_limits={
            p.name: remaining_limit(cluster, p, exclude_claims) for p in pools},
        price_cap=price_cap,
        exist_base=exist_base,
        exist_excluded=exist_excluded,
    )
