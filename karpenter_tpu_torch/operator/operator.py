"""The runnable operator process.

Mirrors the reference's boot sequence (cmd/controller/main.go:31-74 →
pkg/operator/operator.go:92-200): construct the cloud session, probe
connectivity, build every provider and controller, serve metrics and
health endpoints, then run the manager until signalled.  The provider
wiring itself lives in `karpenter_tpu_torch.env.Environment` (the reference
splits the same construction between operator.go:140-182 and
pkg/test/environment.go — ours is one container used by both the process
and the tests, so they can never drift apart).

Endpoints (settings.md: metrics :8000, health probe :8081):
  :8000 /metrics  — Prometheus text exposition of utils.metrics.REGISTRY
  :8081 /healthz  — liveness: the reconcile loop is advancing
  :8081 /readyz   — readiness: CloudProvider.live() (the aggregated
                    provider probe chain, cloudprovider.go:167-169)
  both            — the /debug/* views over the process's recorders

The port's copy of `karpenter_tpu/operator/operator.py`, with two
differences.  The environment runs on the card unless the CPU was asked
for (`utils/platform.configure`, which builds the kernels at boot).  A
reconcile pass that raises — on the card every failure of the device
solve propagates, an injected `solver.dispatch` fault included, since
nothing falls back to the CPU there — does not end the loop: it is
logged and recorded as a `ReconcileError` event, the pods stay pending,
and the next resync retries on the card (controller-runtime's answer to
a failed reconcile).
"""

from __future__ import annotations

import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from karpenter_tpu_torch.env import Environment
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.clock import RealClock


def reconcile_guarded(run, cluster, log, kind: str, name: str,
                      retry: str) -> bool:
    """Run one reconcile pass (`run()`); True when it completed.  A pass
    that raises is logged (`retry` says what comes next) and recorded as
    a `ReconcileError` event on `kind`/`name`, its pods stay pending, and
    it returns False for the caller to retry — the operator at its next
    resync, the rewind engine's manager driver by settling the tick
    again."""
    try:
        run()
        return True
    except Exception as e:  # noqa: BLE001 — the caller retries
        why = f"{type(e).__name__}: {e}"
        log.error(f"reconcile failed; {retry}", error=why[:300])
        cluster.record_event(kind, name, "ReconcileError", why)
        return False


class Operator:
    """Owns the Environment, the serving threads, and the reconcile loop."""

    def __init__(self, options: Optional[Options] = None,
                 metrics_port: int = 8000, health_port: int = 8081,
                 reconcile_interval: float = 1.0,
                 env: Optional[Environment] = None, lease=None,
                 identity: Optional[str] = None):
        self.options = options or Options.from_env()
        # env is injectable so an HA pair (or a test) can run two replicas
        # against one shared cluster store, the way two reference replicas
        # share the kube-apiserver
        if env is None:
            from karpenter_tpu_torch.utils import platform
            env = Environment(clock=RealClock(), options=self.options,
                              device=platform.configure())
        self.env = env
        self.metrics_port = metrics_port
        self.health_port = health_port
        self.reconcile_interval = reconcile_interval
        self._stop = threading.Event()
        self._last_reconcile = 0.0
        # reconcile passes that raised (each retried at the next resync)
        self.reconcile_errors = 0
        self._servers: list = []
        self.elector = None
        # leadership signal: SET while this replica holds the lease.  The
        # dedicated renewal thread (started by run()) owns the elector;
        # the reconcile loop only reads this event, so a long solve can
        # never starve renewal past lease_duration (the historical
        # dual-leader flake in test_ha)
        self._leadership = threading.Event()
        self._renewer: Optional[threading.Thread] = None
        if self.options.leader_elect or lease is not None:
            from karpenter_tpu_torch.operator.leaderelection import (
                FileLease,
                LeaderElector,
            )
            if lease is None:
                if not self.options.lease_file:
                    raise ValueError("leader_elect requires lease_file")
                lease = FileLease(self.options.lease_file)
            self.elector = LeaderElector(lease, identity=identity)
        # boot-time connectivity probe, the reference's CheckEC2Connectivity
        # (operator.go:209-218): fail fast if the cloud isn't reachable
        if not self.env.cloud.live():
            raise RuntimeError("cloud connectivity probe failed at startup")
        # build the native host-ops extension now, not inside a solve (the
        # CUDA kernels are built by `platform.configure`)
        from karpenter_tpu_torch.native import hostops
        hostops()
        # per-solve torch.profiler traces behind ENABLE_PROFILING (the
        # reference gates pprof the same way, settings.md:23)
        from karpenter_tpu_torch.utils.logging import get_logger
        from karpenter_tpu_torch.utils.profiling import maybe_start_server
        self.log = get_logger("operator")
        maybe_start_server(log=lambda m: self.log.info(m))

    # -- HTTP endpoints ----------------------------------------------------
    def _make_handler(operator_self):  # noqa: N805 - closure over operator
        op = operator_self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _respond(self, code: int, body: str,
                         ctype: str = "text/plain; charset=utf-8"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 - stdlib API
                from urllib.parse import parse_qs, urlparse
                url = urlparse(self.path)
                path = url.path
                if path == "/metrics":
                    self._respond(200, metrics.REGISTRY.render(),
                                  "text/plain; version=0.0.4")
                elif path == "/healthz":
                    # live while the loop has run recently (3 intervals of
                    # grace covers a long solve) or hasn't started yet
                    stale = (op._last_reconcile > 0 and
                             time.monotonic() - op._last_reconcile >
                             max(30.0, 3 * op.reconcile_interval +
                                 op.options.batch_max_duration))
                    self._respond(503 if stale else 200,
                                  "unhealthy\n" if stale else "ok\n")
                elif path == "/readyz":
                    ready = op.env.cloud_provider.live()
                    self._respond(200 if ready else 503,
                                  "ok\n" if ready else "not ready\n")
                elif path == "/debug/traces":
                    # recent completed traces as Chrome trace-event JSON
                    # (Perfetto / chrome://tracing loadable); ?trace_id=
                    # narrows to one — the id an event or log line
                    # stamped; ?limit= caps the trace count so a large
                    # ring never dumps unbounded JSON.  The export also
                    # carries otherData.spansDropped (the collector's
                    # eviction counter).
                    from karpenter_tpu_torch.utils import tracing
                    q = parse_qs(url.query)
                    tid = (q.get("trace_id") or [None])[0]
                    try:
                        limit = int((q.get("limit") or [""])[0])
                    except ValueError:
                        limit = None
                    self._respond(
                        200,
                        json.dumps(tracing.chrome_trace(tid, limit)) +
                        "\n", "application/json; charset=utf-8")
                elif path == "/debug/dashboard":
                    # the ONE merged fleet view (utils/telemetry.py):
                    # operator + registered sources (supervisor) + the
                    # solverd worker via its stats RPC; ?format=html for
                    # the no-tooling rendering
                    from karpenter_tpu_torch.utils import telemetry
                    doc = telemetry.collect(
                        extra={"worker": op._worker_snapshot})
                    fmt = (parse_qs(url.query).get("format")
                           or ["json"])[0]
                    if fmt == "html":
                        self._respond(200, telemetry.render_html(doc),
                                      telemetry.HTML_CONTENT_TYPE)
                    else:
                        self._respond(
                            200, json.dumps(doc, default=str) + "\n",
                            "application/json; charset=utf-8")
                elif path == "/debug/ledger":
                    # the decision ledger (utils/ledger.py): every
                    # fleet-mutating decision with before/after $/hr,
                    # reason code, and trace/flight cross-links.
                    # ?pool= narrows to one nodepool, ?since=<unix ts>
                    # to a window, ?limit= caps the count (default 64);
                    # ?format=html renders the no-tooling view.  The
                    # summary block is ledger.summarize over EXACTLY the
                    # returned records, the same rollup tools/
                    # kt_ledger.py prints — the two surfaces cannot
                    # disagree.
                    from karpenter_tpu_torch.utils import ledger as ledgerm
                    from karpenter_tpu_torch.utils import telemetry
                    q = parse_qs(url.query)
                    pool = (q.get("pool") or [None])[0]
                    try:
                        limit = int((q.get("limit") or ["64"])[0])
                    except ValueError:
                        limit = 64
                    try:
                        since = float((q.get("since") or [""])[0])
                    except ValueError:
                        since = None
                    records = ledgerm.LEDGER.tail(limit, pool=pool,
                                                  since=since)
                    doc = {"records": records,
                           "summary": ledgerm.summarize(records)}
                    fmt = (q.get("format") or ["json"])[0]
                    if fmt == "html":
                        self._respond(
                            200,
                            telemetry.html_page(
                                "karpenter-tpu decision ledger",
                                [("summary", doc["summary"]),
                                 ("records", records)]),
                            telemetry.HTML_CONTENT_TYPE)
                    else:
                        self._respond(
                            200, json.dumps(doc, default=str) + "\n",
                            "application/json; charset=utf-8")
                elif path == "/debug/flight":
                    # the flight-recorder tail (request records);
                    # ?trace_id= narrows to the records of one trace,
                    # ?limit= caps the count (default 32)
                    from karpenter_tpu_torch.utils import flightrecorder
                    q = parse_qs(url.query)
                    tid = (q.get("trace_id") or [None])[0]
                    try:
                        limit = int((q.get("limit") or ["32"])[0])
                    except ValueError:
                        limit = 32
                    self._respond(
                        200,
                        json.dumps({"records": flightrecorder.RECORDER
                                    .tail(limit, trace_id=tid)},
                                   default=str) + "\n",
                        "application/json; charset=utf-8")
                elif path == "/debug/timeline":
                    # the cluster timeline tail (timeline/recorder.py):
                    # every informer-cache mutation + semantic drive
                    # event with trace/flight/ledger cross-links.
                    # ?kind= narrows to one event kind, ?since=<seq>
                    # to events after a sequence number, ?limit= caps
                    # the count (default 64); ?format=html renders the
                    # no-tooling view.
                    from karpenter_tpu_torch import timeline
                    from karpenter_tpu_torch.timeline import events as tev
                    from karpenter_tpu_torch.utils import telemetry
                    q = parse_qs(url.query)
                    kind = (q.get("kind") or [None])[0]
                    try:
                        limit = int((q.get("limit") or ["64"])[0])
                    except ValueError:
                        limit = 64
                    try:
                        since = int((q.get("since") or [""])[0])
                    except ValueError:
                        since = None
                    evts = timeline.RECORDER.tail(limit, kind=kind,
                                                  since=since)
                    doc = {"events": evts,
                           "last_seq": timeline.RECORDER.last_seq(),
                           "kinds": tev.KINDS}
                    fmt = (q.get("format") or ["json"])[0]
                    if fmt == "html":
                        self._respond(
                            200,
                            telemetry.html_page(
                                "karpenter-tpu cluster timeline",
                                [("events", evts)]),
                            telemetry.HTML_CONTENT_TYPE)
                    else:
                        self._respond(
                            200, json.dumps(doc, default=str) + "\n",
                            "application/json; charset=utf-8")
                elif path == "/debug/explain":
                    # placement provenance: the per-pod
                    # constraint-elimination tree behind a FailedScheduling
                    # verdict.  ?pod= looks one pod up (?trace_id= pins a
                    # specific pass), no pod lists the recent stranded
                    # pods; ?format=html renders the no-tooling view.
                    from karpenter_tpu_torch.solver import explain as explainm
                    q = parse_qs(url.query)
                    pod = (q.get("pod") or [None])[0]
                    tid = (q.get("trace_id") or [None])[0]
                    try:
                        limit = int((q.get("limit") or ["32"])[0])
                    except ValueError:
                        limit = 32
                    if pod:
                        entry = explainm.STORE.lookup(pod, trace_id=tid)
                        code = 200 if entry is not None else 404
                        doc = entry if entry is not None else {
                            "error": f"no explain record for pod {pod!r}"
                                     + (f" on trace {tid}" if tid else ""),
                            "hint": "the store holds recent provisioning "
                                    "verdicts; for a past solve, replay "
                                    "its flight record with python -m "
                                    "karpenter_tpu_torch.tools.kt_explain"}
                    else:
                        code = 200
                        doc = {"pods": explainm.STORE.recent(limit),
                               "reason_codes": explainm.reason_table()}
                    fmt = (q.get("format") or ["json"])[0]
                    if fmt == "html":
                        from karpenter_tpu_torch.utils import telemetry
                        self._respond(code, op._explain_html(doc),
                                      telemetry.HTML_CONTENT_TYPE)
                    else:
                        self._respond(
                            code, json.dumps(doc, default=str) + "\n",
                            "application/json; charset=utf-8")
                elif path == "/debug/state":
                    c = op.env.cluster
                    self._respond(200, json.dumps({
                        "generation": c.generation,
                        "nodes": len(c.nodes.list()),
                        "nodeclaims": len(c.nodeclaims.list()),
                        "pods": len(c.pods.list()),
                    }) + "\n", "application/json")
                else:
                    self._respond(404, "not found\n")

        return Handler

    @staticmethod
    def _explain_html(doc: dict) -> str:
        """The no-tooling rendering of one explain document — through
        the ONE shared page renderer (utils/telemetry.html_page), the
        same styling/escaping as the dashboard and ledger pages."""
        from karpenter_tpu_torch.utils import telemetry
        title = doc.get("pod", "placement explainability")
        return telemetry.html_page(f"explain: {title}", [(None, doc)])

    def _worker_snapshot(self):
        """The solverd worker's section of the dashboard merge: its
        stats RPC response (which carries the worker-process telemetry
        snapshot — solve rate, phase latencies, delta split, flight
        tail) plus the client-side in-flight and breaker view only this
        process knows.  None in the in-process-solver topology (no
        worker to ask); raises on a dead worker and telemetry.collect
        renders the error — the dashboard must keep serving exactly
        when the fleet is degraded."""
        gs = getattr(self.env, "solver", None)
        client = getattr(gs, "tpu", None)
        if not getattr(gs, "_remote", False) or client is None:
            return None
        st = client.stats()
        snap = dict(st.pop("telemetry", None) or {})
        snap["stats"] = st
        snap["shed"] = st.get("shed", 0)
        snap["in_flight"] = len(client._pending)
        snap["breaker"] = client.breaker.state
        return snap

    def serve(self) -> None:
        if self._servers:
            return
        handler = self._make_handler()
        ports = []
        for port in (self.metrics_port, self.health_port):
            # loopback by default; a containerized replica sets
            # KARPENTER_TPU_BIND_HOST=0.0.0.0 so published ports and
            # healthchecks actually reach the server (deploy/)
            from karpenter_tpu_torch.utils.knobs import bind_host
            host = bind_host()
            srv = ThreadingHTTPServer((host, port), handler)
            ports.append(srv.server_address[1])  # resolves port 0 → actual
            t = threading.Thread(target=srv.serve_forever, daemon=True,
                                 name=f"http-{srv.server_address[1]}")
            t.start()
            self._servers.append(srv)
        self.metrics_port, self.health_port = ports

    # -- leader election ---------------------------------------------------
    def _renew_loop(self) -> None:
        """Dedicated lease-renewal heartbeat.  Renewal inline with
        reconcile would let one long pass (a cold solve building its
        kernels) starve the renew past lease_duration, and the standby
        would take over while the old leader was still mutating.  This
        thread is the elector's ONLY caller after run()
        starts; the reconcile loop consumes `_leadership` (set = this
        replica holds the lease) and never touches the lease itself."""
        e = self.elector
        while not self._stop.is_set():
            if e.try_acquire_or_renew():
                self._leadership.set()
                self._stop.wait(e.renew_interval / 2)
            else:
                self._leadership.clear()
                self._stop.wait(e.retry_period)
        self._leadership.clear()

    # -- the reconcile loop ------------------------------------------------
    def run(self) -> None:
        """manager.Start: WATCH-DRIVEN reconcile with periodic resync,
        matching controller-runtime's informer model — a store mutation
        (pod created, claim updated, node deleted) wakes the loop
        immediately instead of waiting out the poll cadence; with no
        events, the loop still resyncs every `reconcile_interval` so
        clock-driven work (batch windows, TTLs, GC) keeps advancing.
        Controllers are level-driven and idempotent, so coalesced or
        dropped watch edges are harmless."""
        self.serve()
        watch = self.env.cluster.watch()
        if self.elector is not None and self._renewer is None:
            self._renewer = threading.Thread(
                target=self._renew_loop, daemon=True,
                name=f"lease-renew-{self.elector.identity}")
            self._renewer.start()
        try:
            while not self._stop.is_set():
                if self.elector is not None \
                        and not self._leadership.is_set():
                    # standby: hold position; the renewal thread races
                    # the lease on its own cadence and flips
                    # `_leadership` the moment it wins, which ends this
                    # wait immediately (event-driven takeover, not a
                    # poll). Liveness stays green (the loop IS
                    # advancing). Drain so a takeover starts fresh.
                    watch.drain()
                    self._last_reconcile = time.monotonic()
                    self._leadership.wait(self.elector.retry_period)
                    continue
                t0 = time.monotonic()
                # run to a BOUNDED fixed point per wake: reconcile chains
                # (pod → claim → launch → register → bind) span several
                # passes, each advancing on the previous one's mutations.
                # A pass that raised ends the fixed point: the resync
                # below retries it
                for _ in range(8):
                    gen = self.env.cluster.generation
                    if not self._reconcile_once():
                        break
                    self._last_reconcile = time.monotonic()
                    if self.env.cluster.generation == gen or self._stop.is_set():
                        break
                    # the renewal thread keeps the lease fresh during a
                    # long fixed point; stop mutating the moment it
                    # reports the lease lost
                    if self.elector is not None \
                            and not self._leadership.is_set():
                        break
                # drain AFTER the fixed point: mutations made by the
                # reconcile itself (self-requeue patterns like the
                # lifecycle's ICE retry, which deliberately never settles
                # while capacity is short) must not wake the loop into a
                # zero-delay hot spin — they get the resync cadence, the
                # reference's workqueue-backoff analogue. An external edge
                # racing the reconcile is drained too; level-driven
                # controllers + resync cover it (informer discipline).
                watch.drain()
                elapsed = time.monotonic() - t0
                remaining = max(0.0, self.reconcile_interval - elapsed)
                # wake early on any store mutation; cap waits so stop()
                # and demotion stay responsive
                deadline = time.monotonic() + remaining
                while not self._stop.is_set():
                    if self.elector is not None \
                            and not self._leadership.is_set():
                        break  # demoted while idle → standby wait above
                    left = deadline - time.monotonic()
                    if left <= 0 or watch.wait(timeout=min(left, 0.25)):
                        break
                    # peer replicas' writes arrive via the store backend,
                    # not the local watch — apply them on the wait tick so
                    # a pod created through another replica wakes this
                    # loop with informer latency (applying publishes to
                    # the local watch, which the next wait() observes)
                    self.env.cluster.sync_backend()
        finally:
            self.env.cluster.unwatch(watch)
            # order matters: stop the renewal thread BEFORE releasing, or
            # it re-acquires the lease we just gave up
            self._stop.set()
            if self._renewer is not None:
                self._renewer.join(timeout=5)
            if self.elector is not None:
                self.elector.release()

    def _reconcile_once(self) -> bool:
        """One manager pass; False when it raised (see `reconcile_guarded`).
        `/healthz` goes stale only if no pass completes for its grace
        window."""
        if reconcile_guarded(self.env.manager.run_once, self.env.cluster,
                             self.log, "Operator", self.options.cluster_name,
                             "retrying at the next resync"):
            return True
        self.reconcile_errors += 1
        return False

    def stop(self, *_args) -> None:
        self._stop.set()
        for srv in self._servers:
            srv.shutdown()

    def install_signal_handlers(self) -> None:
        signal.signal(signal.SIGINT, self.stop)
        signal.signal(signal.SIGTERM, self.stop)


def main() -> int:
    import os
    import sys

    # the device, probed out of process BEFORE anything touches it (a
    # wedged card hangs its init rather than raise): the card unless
    # KARPENTER_TPU_PLATFORM=cpu or KARPENTER_TPU_FORCE_CPU asks for the
    # CPU; no card fails the boot here, with no fallback to the CPU
    from karpenter_tpu_torch.utils.platform import initialize
    try:
        device = initialize()
    except RuntimeError as e:
        print(f"karpenter-tpu operator: {e}", file=sys.stderr, flush=True)
        return 1

    # HA deployment plumbing (deploy/: 2 replicas, one store daemon, one
    # shared lease — charts/karpenter/values.yaml:35's layout):
    #   KARPENTER_TPU_STORE_SOCKET  unix socket of a StoreDaemon; this
    #                               replica's cluster becomes an informer
    #                               cache over it (docs/store-backends.md)
    #   KARPENTER_TPU_LEASE_FILE    shared file lease → leader election
    #   KARPENTER_TPU_REPLICA_ID    identity in the lease (default pid)
    backend = None
    store_sock = os.environ.get("KARPENTER_TPU_STORE_SOCKET")
    if store_sock:
        from karpenter_tpu_torch.store import RemoteBackend
        backend = RemoteBackend(store_sock)
    env = Environment(clock=RealClock(), options=Options.from_env(),
                      store_backend=backend, device=device)
    lease = None
    identity = None
    lease_file = os.environ.get("KARPENTER_TPU_LEASE_FILE")
    if lease_file:
        from karpenter_tpu_torch.operator.leaderelection import FileLease
        lease = FileLease(lease_file)
        identity = os.environ.get(
            "KARPENTER_TPU_REPLICA_ID", f"replica-{os.getpid()}")
    op = Operator(
        options=env.options,
        metrics_port=int(os.environ.get("KARPENTER_TPU_METRICS_PORT", 8000)),
        health_port=int(os.environ.get("KARPENTER_TPU_HEALTH_PORT", 8081)),
        env=env, lease=lease, identity=identity)
    op.install_signal_handlers()
    op.serve()  # bind before the banner so the printed ports are real
    print(f"karpenter-tpu operator: cluster={op.options.cluster_name} "
          f"device={device} "
          f"metrics=:{op.metrics_port} health=:{op.health_port}"
          + (f" replica={identity}" if identity else ""),
          flush=True)
    op.run()
    return 0
