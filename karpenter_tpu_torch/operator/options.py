"""Options + feature gates.

Mirrors the reference's layered flag/env config (pkg/operator/options;
settings documented at website/.../settings.md). The device solver toggle is
a feature gate (named `TPUSolver`, the reference's gate name) exactly like the reference's FEATURE_GATES string
(`SpotToSpotConsolidation=true` style — SURVEY §5 config/flag system).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class FeatureGates:
    tpu_solver: bool = True            # TPUSolver=true: device hot path on
    spot_to_spot_consolidation: bool = True
    drift: bool = True

    @classmethod
    def parse(cls, s: str) -> "FeatureGates":
        """FEATURE_GATES=TPUSolver=true,Drift=false"""
        gates = cls()
        mapping = {
            "TPUSolver": "tpu_solver",
            "SpotToSpotConsolidation": "spot_to_spot_consolidation",
            "Drift": "drift",
        }
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            key, _, val = part.partition("=")
            attr = mapping.get(key)
            if attr is not None:
                setattr(gates, attr, val.strip().lower() == "true")
        return gates


@dataclass
class Options:
    cluster_name: str = "default-cluster"
    # pod batching window (settings.md BATCH_IDLE_DURATION / BATCH_MAX_DURATION)
    batch_idle_duration: float = 1.0
    batch_max_duration: float = 10.0
    # lifecycle
    registration_ttl: float = 15 * 60.0   # never-registered GC (designs/limits.md:23-25)
    # solver
    solver_max_nodes: int = 1024
    # multi-chip: "auto" shards the solve's column axis over every local
    # device when >1 is visible (SURVEY §2.3 ICI sharding); "off" forces
    # single-device; an integer uses the first n devices
    solver_mesh: str = "auto"
    # incremental delta solves (solver/delta.py): "auto" engages on
    # steady-state repeats above the min-size gate, "on" forces, "off"
    # disables. KARPENTER_TPU_DELTA is the rollback override, resolved
    # inside the solver exactly like KARPENTER_TPU_MESH.
    solver_delta: str = "auto"
    # unix-socket path of a kt_solverd solver service (native/solverd.cc);
    # None = in-process solver. Lets control-plane replicas share one
    # device-owning process (SURVEY §2.3 leader-election note); the
    # worker is `python -m karpenter_tpu_torch.service.supervisor`.
    solver_endpoint: "str | None" = None
    # solver-service availability knobs (service/resilience.py): one
    # request deadline (also shipped in the frame so the daemon sheds
    # work its caller abandoned), bounded retries, and the circuit
    # breaker that puts the control plane into explicit degraded mode
    # (in-process solver, then oracle) when the daemon is down/wedged
    service_request_timeout: float = 60.0
    service_retry_attempts: int = 3
    service_breaker_threshold: int = 5
    service_breaker_cooldown: float = 10.0
    # degraded mode: while the breaker is open (or any remote solve
    # fails), fall back to a lazily-built in-process solver before
    # the host oracle. Disable to keep the old endpoint->oracle-only
    # behavior (e.g. a control-plane host too small for a solver).
    service_local_fallback: bool = True
    # multi-tenant solver fleet: the tenant name this control
    # plane declares on every schedule frame (None = cluster_name — one
    # cluster, one tenant), and the admission-control priority rank (the
    # daemon sheds lowest priority first when a tenant queue is full)
    service_tenant: "str | None" = None
    service_priority: int = 0
    # HA: active/passive replicas racing a shared lease (core LEADER_ELECT;
    # charts/karpenter/values.yaml:35 runs 2 replicas). lease_file names a
    # FileLease shared by replicas on one host.
    leader_elect: bool = False
    lease_file: "str | None" = None
    feature_gates: FeatureGates = field(default_factory=FeatureGates)

    @classmethod
    def from_env(cls) -> "Options":
        opts = cls()
        opts.cluster_name = os.environ.get("CLUSTER_NAME", opts.cluster_name)
        if "BATCH_IDLE_DURATION" in os.environ:
            opts.batch_idle_duration = float(os.environ["BATCH_IDLE_DURATION"])
        if "BATCH_MAX_DURATION" in os.environ:
            opts.batch_max_duration = float(os.environ["BATCH_MAX_DURATION"])
        if "FEATURE_GATES" in os.environ:
            opts.feature_gates = FeatureGates.parse(os.environ["FEATURE_GATES"])
        opts.solver_endpoint = os.environ.get(
            "SOLVER_ENDPOINT", opts.solver_endpoint)
        if "KARPENTER_TPU_SERVICE_TIMEOUT" in os.environ:
            opts.service_request_timeout = float(
                os.environ["KARPENTER_TPU_SERVICE_TIMEOUT"])
        if "KARPENTER_TPU_SERVICE_RETRIES" in os.environ:
            opts.service_retry_attempts = int(
                os.environ["KARPENTER_TPU_SERVICE_RETRIES"])
        if "KARPENTER_TPU_SERVICE_BREAKER_THRESHOLD" in os.environ:
            opts.service_breaker_threshold = int(
                os.environ["KARPENTER_TPU_SERVICE_BREAKER_THRESHOLD"])
        if "KARPENTER_TPU_SERVICE_BREAKER_COOLDOWN" in os.environ:
            opts.service_breaker_cooldown = float(
                os.environ["KARPENTER_TPU_SERVICE_BREAKER_COOLDOWN"])
        # canonical symmetric on/off grammar (utils/knobs.py); malformed
        # values degrade to the default (on) — an operator must opt OUT
        # of the fallback explicitly, never via a typo
        from karpenter_tpu_torch.utils.knobs import env_bool
        opts.service_local_fallback = env_bool(
            "KARPENTER_TPU_SERVICE_LOCAL_FALLBACK",
            default=opts.service_local_fallback)
        opts.service_tenant = os.environ.get(
            "KARPENTER_TPU_TENANT", opts.service_tenant)
        # renamed from KARPENTER_TPU_PRIORITY: that name now
        # belongs to the POD-priority scheduling rollback lever
        # (utils/knobs.py); this one ranks the control plane's own
        # requests in the solver daemon's admission queue
        if "KARPENTER_TPU_SERVICE_PRIORITY" in os.environ:
            opts.service_priority = int(
                os.environ["KARPENTER_TPU_SERVICE_PRIORITY"])
        # SOLVER_MESH configures the mesh story.  The KARPENTER_TPU_MESH
        # rollback override is deliberately NOT parsed here: its single
        # grammar owner is utils/knobs.mesh_spec, applied inside
        # TorchSolver._resolve_mesh so it reaches every solver however built —
        # including the one state.py constructs from this options value
        opts.solver_mesh = os.environ.get("SOLVER_MESH", opts.solver_mesh)
        # SOLVER_DELTA configures the delta-solve story; the
        # KARPENTER_TPU_DELTA rollback override is deliberately NOT
        # parsed here — its single grammar owner is
        # TorchSolver._resolve_delta (same discipline as the mesh knob)
        opts.solver_delta = os.environ.get("SOLVER_DELTA",
                                           opts.solver_delta)
        opts.leader_elect = os.environ.get(
            "LEADER_ELECT", "").strip().lower() in ("1", "true", "yes")
        opts.lease_file = os.environ.get("LEASE_FILE", opts.lease_file)
        return opts
