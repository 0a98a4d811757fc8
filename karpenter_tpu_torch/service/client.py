"""Client for the kt_solverd solver service (native/solverd.cc).

The port's copy of `karpenter_tpu/service/client.py`: the same framing,
catalog fingerprint handshake, deadlines, tenant and priority, retry and
breaker, and the same `service.client.send`/`.recv` fault points.  Its
frames carry the port's classes (`karpenter_tpu_torch.*`), which the
worker's backend unpickles with no JAX module on its path.

Framing: u32 payload_len | u64 request_id | payload (both directions;
responses may arrive out of order). Payloads are pickled (kind, body)
tuples — see service/backend.py.

`SolverServiceClient` exposes the solver seam (`solve` / `solve_batch`)
so the control plane can point `GatedSolver` at a remote card-owning
process instead of the in-process solver. Catalogs are uploaded once per
content fingerprint (cached against the instance-type lists' identity,
the same invalidation signal TorchSolver uses) and referenced by hash
thereafter, keeping the steady-state request small: pods + cluster deltas
only. Concurrent requests coalesce in the daemon's native batch window
into one batched device call.

Resilience: every request runs under one shared
:class:`~karpenter_tpu_torch.service.resilience.RetryPolicy` — bounded
attempts, exponential backoff + jitter, and a per-request deadline that
rides the wire frame (``body["deadline"]``, absolute epoch seconds —
unix-socket peers share a clock) so the daemon sheds work its caller
has already abandoned. A shared
:class:`~karpenter_tpu_torch.service.resilience.CircuitBreaker` trips after
consecutive transport failures and fails fast while open, which is what
puts `GatedSolver` into explicit degraded mode (in-process solver, then
oracle) instead of paying a timeout per solve against a dead daemon.
Transport failures (connect/send/receive/timeout) raise
:class:`SolverServiceTransportError` and are retried; application
errors from a live daemon raise plain :class:`SolverServiceError` and
are not (the daemon answering is proof the transport works).

Multi-tenant: `tenant` and `priority` ride every schedule
frame; the daemon's fair scheduler (service/scheduler.py) queues each
tenant separately, sheds lowest-priority-first under pressure, and
fuses bucket-compatible requests ACROSS tenants into one device call.
A shed comes back as :class:`SolverServiceShed` — transport-class (so
fallbacks engage) but breaker-neutral (the daemon answering is proof of
life) — carrying the server's queue ETA, which `RetryPolicy.backoff`
uses as the retry pace instead of the blind exponential ladder.  The
latest backpressure hint is kept on `client.last_backpressure`.

Flight records: each answered `solve_batch` writes one `kind="request"`
record into this process's flight recorder (the worker writes one
`kind="batch"` record a fused dispatch), so a decision-ledger record of
the caller names the solve behind it (`flight_seq`), as with the
in-process solver; the reference's client writes none.

Mesh: the daemon owns the devices, so its mesh story is configured in
ITS environment — `SOLVER_MESH` selects (backend._get_solver), and the
`KARPENTER_TPU_MESH=off/auto/N` rollback knob overrides inside the
daemon's solver exactly as in-process. `stats()` reports the resolved
mesh (device count + resident-path O-axis transfer counters) so a remote
operator can verify which story is live without shell access to the
daemon host.
"""

from __future__ import annotations

import hashlib
import pickle
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from karpenter_tpu_torch.scheduling.types import ScheduleInput, ScheduleResult
from karpenter_tpu_torch.service.resilience import CircuitBreaker, RetryPolicy
from karpenter_tpu_torch.utils import faults, metrics, tracing

# mirror of the daemon's kMaxFrame: a length prefix past this is frame
# desynchronization (a torn write, a corrupted header), not a real
# response — kill the connection instead of trying to allocate it
_MAX_FRAME = 256 << 20


class SolverServiceError(RuntimeError):
    """Base failure; also the daemon-reported application errors."""


class SolverServiceTransportError(SolverServiceError):
    """Connect/send/receive/timeout failures — the retryable class."""


class SolverServiceUnavailable(SolverServiceError):
    """Fail-fast signal while the circuit breaker is open."""


class SolverServiceShed(SolverServiceTransportError):
    """The daemon ANSWERED but refused the request — admission control
    (tenant queue full, lowest priority loses) or a deadline that passed
    at ingest/while queued.

    Transport-class so every existing fallback path (GatedSolver's
    degraded mode, the provisioner's re-batch-next-pass discipline)
    engages unchanged, but deliberately BREAKER-NEUTRAL: a daemon that
    sheds is alive and load-managing, not down, so `_with_retries`
    counts it a breaker success.  Carries the server's backpressure hint
    (`retry_after` seconds, plus the raw `backpressure` dict) so the
    retry pacing follows the daemon's own queue ETA instead of blind
    exponential backoff."""

    def __init__(self, msg: str, reason: str = "",
                 retry_after: Optional[float] = None,
                 backpressure: Optional[dict] = None):
        super().__init__(msg)
        self.reason = reason
        self.retry_after = retry_after
        self.backpressure = backpressure or {}

    @classmethod
    def from_body(cls, body) -> "SolverServiceShed":
        if not isinstance(body, dict):
            return cls(f"request shed by solver service: {body}")
        reason = str(body.get("reason", ""))
        ra = body.get("retry_after_ms")
        return cls(
            f"request shed by solver service (reason={reason or '?'}, "
            f"queue_depth={body.get('queue_depth')}, "
            f"eta_ms={body.get('eta_ms')})",
            reason=reason,
            retry_after=(float(ra) / 1e3) if ra else None,
            backpressure=dict(body))


class SolverServiceClient:
    def __init__(self, socket_path: str, timeout: float = 60.0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 tenant: Optional[str] = None, priority: int = 0):
        self.socket_path = socket_path
        self.timeout = timeout
        # the retry policy's deadline defaults to the legacy `timeout`
        # knob so existing constructors keep their wait bound
        self.retry = retry or RetryPolicy(deadline=timeout)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # multi-tenant identity: `tenant` rides every schedule
        # frame so the daemon's fair scheduler queues this control plane
        # under its own name (unset = the daemon derives a per-connection
        # tenant); `priority` is the admission-control rank — when a
        # tenant's queue is full the LOWEST priority is shed first
        self.tenant = tenant
        self.priority = int(priority)
        # last backpressure hint the daemon shipped (on a result or a
        # shed): {queue_depth, eta_ms, retry_after_ms} — callers can
        # inspect it to pace their own submission rate
        self.last_backpressure: Optional[dict] = None
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._next_id = 0
        self._pending: Dict[int, "threading.Event"] = {}
        self._responses: Dict[int, tuple] = {}
        self._reader: Optional[threading.Thread] = None
        # instance-type list identity → (fingerprint, payload). The strong
        # refs in _strong keep `id()`-keyed invalidation sound (a freed
        # list's address could be recycled — same discipline as TorchSolver)
        self._fingerprints: Dict[tuple, Tuple[str, bytes]] = {}
        self._strong: Dict[str, tuple] = {}
        self._uploaded: set = set()
        # frame bytes each way over this client's life (headers included)
        self.bytes_sent = 0
        self.bytes_received = 0

    # -- connection -------------------------------------------------------
    def _ensure_connected(self) -> socket.socket:
        with self._lock:
            if self._sock is not None:
                return self._sock
        # connect OUTSIDE the lock: a wedged daemon would otherwise stall
        # every caller behind _lock for the full connect timeout (kt-lint
        # lock-discipline); losers of the install race close their socket
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.timeout)
        try:
            s.connect(self.socket_path)
        except OSError:
            s.close()
            raise
        with self._lock:
            if self._sock is not None:
                s.close()
                return self._sock
            self._sock = s
            # a fresh connection may face a restarted daemon with an empty
            # catalog store — re-upload on demand
            self._uploaded.clear()
            self._reader = threading.Thread(
                target=self._read_loop, args=(s,), daemon=True)
            self._reader.start()
            return s

    def close(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _read_loop(self, sock: socket.socket) -> None:
        """Reader-thread framing loop. The failure contract is absolute:
        HOWEVER this loop dies — clean EOF, mid-frame EOF, a timeout, an
        oversized length prefix, an injected fault, even an unexpected
        exception — the `finally` block fails every outstanding waiter
        fast. A waiter left to sleep out its full deadline against a
        dead connection is the bug this structure exists to prevent."""
        try:
            while True:
                faults.fire("service.client.recv")
                header = self._read_exact(sock, 12)
                if header is None:
                    break  # clean or mid-frame EOF: peer died
                plen, rid = struct.unpack("<IQ", header)
                if plen > _MAX_FRAME:
                    # frame desync/corruption: nothing after this point
                    # can be trusted — drop the connection
                    break
                payload = self._read_exact(sock, plen)
                if payload is None:
                    break
                self.bytes_received += 12 + plen
                try:
                    resp = pickle.loads(payload)
                except Exception as e:  # noqa: BLE001
                    resp = ("error", f"undecodable response: {e}")
                with self._lock:
                    ev = self._pending.get(rid)
                    if ev is not None:
                        # drop responses with no waiter (an abandoned rid
                        # after a client-side error/timeout) instead of
                        # accumulating them forever
                        self._responses[rid] = resp
                if ev is not None:
                    ev.set()
        except Exception:  # noqa: BLE001 — reader death is handled, not raised
            pass
        finally:
            # connection died: drop the socket so the next call
            # reconnects, and release every waiter
            with self._lock:
                if self._sock is sock:
                    self._sock = None
                for rid, ev in self._pending.items():
                    self._responses.setdefault(
                        rid, ("transport", "connection to solver service "
                                           "lost"))
                    ev.set()
            try:
                sock.close()
            except OSError:
                pass

    @staticmethod
    def _read_exact(sock, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- framing ----------------------------------------------------------
    def _send(self, kind: str, body: dict) -> int:
        try:
            sock = self._ensure_connected()
        except OSError as e:
            raise SolverServiceTransportError(
                f"solver service connect failed: {e}") from e
        payload = pickle.dumps((kind, body), protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = threading.Event()
            self.bytes_sent += 12 + len(payload)
        frame = struct.pack("<IQ", len(payload), rid) + payload
        try:
            out = faults.fire("service.client.send", frame)
            with self._wlock:
                # holding the write lock across sendall is load-bearing:
                # frames from concurrent senders must not interleave on
                # the shared socket — responses are matched by request id,
                # so only the WRITE needs serializing, and this is it
                sock.sendall(out)  # kt-lint: disable=lock-discipline
            if len(out) != len(frame):
                # injected truncation: the daemon now waits mid-frame for
                # bytes that will never come — kill the connection so it
                # sees EOF (the torn-write failure shape end to end)
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                raise OSError("fault-injected frame truncation")
        except (OSError, faults.FaultInjected) as e:
            with self._lock:
                self._pending.pop(rid, None)
                if self._sock is sock:
                    self._sock = None
            raise SolverServiceTransportError(
                f"solver service send failed: {e}") from e
        return rid

    def _wait(self, rid: int, deadline: Optional[float] = None) -> tuple:
        """Block for rid's response until `deadline` (absolute epoch
        seconds; defaults to now + timeout). Reader death sets a
        ("transport", msg) marker, surfaced as the retryable class."""
        if deadline is None:
            deadline = time.time() + self.timeout
        with self._lock:
            ev = self._pending[rid]
        if not ev.wait(max(0.0, deadline - time.time())):
            with self._lock:
                self._pending.pop(rid, None)
                self._responses.pop(rid, None)
            raise SolverServiceTransportError("solver service timed out")
        with self._lock:
            self._pending.pop(rid, None)
            resp = self._responses.pop(rid)
        if not (isinstance(resp, tuple) and len(resp) == 2):
            # the daemon's internal-error marker (pickled None) or any
            # other malformed response
            raise SolverServiceError("solver service internal error")
        if resp[0] == "transport":
            raise SolverServiceTransportError(
                f"solver service: {resp[1]}")
        return resp

    # -- retry/breaker ----------------------------------------------------
    def _with_retries(self, fn: Callable[[float], object]):
        """Run `fn(deadline)` under the shared policy: breaker check up
        front (fail fast while open), bounded attempts with backoff on
        transport failures, everything inside ONE deadline. Application
        errors from a live daemon count as breaker successes — a daemon
        that answers is reachable, whatever it answered."""
        br = self.breaker
        if br is not None and not br.allow():
            raise SolverServiceUnavailable(
                "solver service circuit breaker open: failing fast")
        deadline = time.time() + self.retry.deadline
        attempt = 1
        while True:
            try:
                out = fn(deadline)
            except SolverServiceShed as e:
                # the daemon answered: it is ALIVE and load-shedding, so
                # the breaker records success (tripping it would demote
                # the control plane to degraded mode exactly when the
                # shared fleet is asking clients to pace themselves)
                if br is not None:
                    br.record_success()
                remaining = deadline - time.time()
                if e.reason == "deadline" or \
                        attempt >= self.retry.attempts or remaining <= 0:
                    # a deadline shed is not retryable — the budget this
                    # request rode in on has already passed
                    raise
                metrics.SERVICE_RETRIES.inc()
                # pace to the server's queue ETA, not the blind ladder
                time.sleep(min(self.retry.backoff(
                    attempt, retry_after=e.retry_after), remaining))
                attempt += 1
                continue
            except SolverServiceTransportError:
                if br is not None:
                    br.record_failure()
                remaining = deadline - time.time()
                if attempt >= self.retry.attempts or remaining <= 0:
                    raise
                if br is not None and not br.allow():
                    # our own failures tripped it mid-loop: stop burning
                    # the remaining attempts against a known-dead peer
                    raise SolverServiceUnavailable(
                        "solver service circuit breaker open: failing "
                        "fast") from None
                metrics.SERVICE_RETRIES.inc()
                time.sleep(min(self.retry.backoff(attempt), remaining))
                attempt += 1
                continue
            except SolverServiceError:
                if br is not None:
                    br.record_success()
                raise
            except BaseException:
                # anything unexpected (a malformed response body, a
                # KeyboardInterrupt mid-wait) must still RELEASE the
                # half-open probe slot, or the breaker wedges in
                # fail-fast forever; counting it as a failure is the
                # conservative release
                if br is not None:
                    br.record_failure()
                raise
            if br is not None:
                br.record_success()
            return out

    # -- catalog fingerprinting -------------------------------------------
    def _fingerprint(self, inp: ScheduleInput) -> Tuple[str, bytes]:
        pools = sorted(inp.nodepools, key=lambda p: (-p.weight, p.meta.name))
        lists = tuple(id(inp.instance_types.get(p.name)) for p in pools)
        # key mirrors TorchSolver._catalog_encoding: list identity AND pool
        # spec content (name/weight/static hash) — a pool edit that leaves
        # the type lists untouched must still re-upload
        key = (lists,
               tuple((p.meta.name, p.weight, p.static_hash()) for p in pools))
        cached = self._fingerprints.get(key)
        if cached is None:
            if len(self._fingerprints) >= 8:
                # superseded catalogs would otherwise pin multi-MB payloads
                # and dead instance-type lists forever
                self._fingerprints.clear()
                self._strong.clear()
            payload = pickle.dumps(
                {"nodepools": pools, "instance_types": inp.instance_types},
                protocol=pickle.HIGHEST_PROTOCOL)
            fp = hashlib.sha256(payload).hexdigest()
            cached = (fp, payload)
            self._fingerprints[key] = cached
            self._strong[fp] = tuple(inp.instance_types.values())
        return cached[0], cached[1]

    def _ensure_catalog(self, fp: str, payload: bytes,
                        deadline: Optional[float] = None) -> None:
        # connect FIRST: the upload ledger is per-connection state (a
        # reconnect clears it), so consulting it before the connection is
        # established reads a stale ledger from the previous daemon and
        # skips an upload the fresh daemon never saw — the need_catalog
        # retry in solve_batch then remains as the backstop for the
        # check-then-die race, not the primary path
        try:
            self._ensure_connected()
        except OSError as e:
            raise SolverServiceTransportError(
                f"solver service connect failed: {e}") from e
        if fp in self._uploaded:
            return
        body = pickle.loads(payload)
        rid = self._send("catalog", {
            "fingerprint": fp,
            "nodepools": body["nodepools"],
            "instance_types": body["instance_types"],
        })
        kind, _ = self._wait(rid, deadline)
        if kind != "ok":
            raise SolverServiceError(f"catalog upload failed: {kind}")
        self._uploaded.add(fp)

    def stats(self) -> dict:
        """Server-side batch/coalescing counters (observability + tests).
        Deliberately outside the breaker: diagnostics must keep working
        exactly when the breaker says the data path is unhealthy."""
        rid = self._send("stats", {})
        kind, body = self._wait(rid)
        if kind != "result":
            raise SolverServiceError(f"stats failed: {body}")
        return body

    def warmup(self, inp: ScheduleInput, shapes=(),
               batch_sizes=(1,)) -> int:
        """Remote padding-bucket precompile (solve.py TorchSolver.warmup):
        ships a representative input so the daemon pre-traces the kernel
        lattice before the first latency-sensitive schedule request.
        Returns the number of programs warmed."""
        fp, payload = self._fingerprint(inp)
        return self._with_retries(
            lambda deadline: self._warmup_once(
                inp, fp, payload, shapes, batch_sizes, deadline))

    def _warmup_once(self, inp: ScheduleInput, fp: str, payload: bytes,
                     shapes, batch_sizes, deadline: float,
                     _catalog_retry: bool = True) -> int:
        self._ensure_catalog(fp, payload, deadline)
        rid = self._send("warmup", {
            "fingerprint": fp,
            "pods": inp.pods,
            "existing_nodes": inp.existing_nodes,
            "daemon_overhead": inp.daemon_overhead,
            "remaining_limits": inp.remaining_limits,
            "shapes": tuple(shapes),
            "batch_sizes": tuple(batch_sizes),
            "deadline": deadline,
        })
        kind, body = self._wait(rid, deadline)
        if kind == "need_catalog":
            # restarted-empty daemon: same ledger-invalidation-and-replay
            # discipline as solve_batch (one retry, then raise)
            self._uploaded.clear()
            if not _catalog_retry:
                raise SolverServiceError(
                    "service lost the catalog again after re-upload")
            return self._warmup_once(inp, fp, payload, shapes, batch_sizes,
                                     deadline, _catalog_retry=False)
        if kind == "shed":
            self.last_backpressure = body if isinstance(body, dict) else None
            raise SolverServiceShed.from_body(body)
        if kind != "result":
            raise SolverServiceError(f"warmup failed: {body}")
        return int(body.get("warmed", 0))

    # -- the solver seam ---------------------------------------------------
    def solve(self, inp: ScheduleInput, max_nodes: Optional[int] = None,
              priority: Optional[int] = None) -> ScheduleResult:
        return self.solve_batch([inp], max_nodes=max_nodes,
                                priority=priority)[0]

    def solve_batch(self, inps: List[ScheduleInput],
                    max_nodes: Optional[int] = None,
                    priority: Optional[int] = None) -> List[ScheduleResult]:
        """`max_nodes` rides the schedule request so the disruption
        simulator's tiny-kernel cap survives the solverd deployment — the
        shared-card shape the cap matters most for.  `priority` overrides
        the client default for THIS call (a provisioning pass can outrank
        this tenant's own background consolidation sims).

        Shed handling is PARTIAL: results that arrived before/alongside
        a shed are kept, and the retry re-sends only the still-missing
        inputs — a 64-sim batch with one admission-shed member must not
        double the offered load exactly when the daemon asked for
        pacing.  (Schedule requests are stateless, so a transport-level
        retry re-solving a kept input would also be harmless — this is
        a load question, not a correctness one.)"""
        if not inps:
            return []
        done: Dict[int, ScheduleResult] = {}

        def once(deadline):
            todo = [i for i in range(len(inps)) if i not in done]
            partial: Dict[int, ScheduleResult] = {}
            try:
                got = self._solve_batch_once(
                    [inps[i] for i in todo], max_nodes, deadline,
                    priority=priority, partial=partial)
            except SolverServiceShed:
                for j, r in partial.items():
                    done[todo[j]] = r
                raise
            for j, r in enumerate(got):
                done[todo[j]] = r
            return [done[i] for i in range(len(inps))]

        with tracing.span("service.solve_batch", requests=len(inps)):
            t0 = time.perf_counter()
            results = self._with_retries(once)
            self._flight_record(inps, results, max_nodes,
                                (time.perf_counter() - t0) * 1e3)
            return results

    def _flight_record(self, inps, results, max_nodes, rpc_ms) -> None:
        """The request half of the request-record split, in the caller's
        process: one flight record per answered `solve_batch` (the worker
        writes the batch half, `backend._flight_record_batch`), so the
        caller's decision-ledger and timeline records reference the solve
        behind them (`flight_seq`) as they do with the in-process solver.
        Best-effort: the black box must never fail a solve."""
        try:
            from karpenter_tpu_torch.utils import flightrecorder as fr
            rec = fr.RECORDER
            if not rec.enabled:
                return
            fp = self._fingerprint(inps[0])[0]
            metrics.FLIGHT_RECORDS.inc(kind="request")
            rec.record(
                kind="request",
                trace_id=tracing.current_trace_id(),
                catalog={"fingerprint": fp},
                fingerprint=fp[:16],
                pods=sum(len(i.pods) for i in inps),
                groups=len(inps),
                knobs={"max_nodes": max_nodes, "tenant": self.tenant,
                       "priority": self.priority},
                phase_ms={"rpc": round(rpc_ms, 3)},
                delta=None,
                retraces=None,
                device_memory_peak_bytes=None,
                result={"requests": len(inps),
                        "digests": [fr.result_digest(r) for r in results]},
                capture=None,
            )
        except Exception:  # noqa: BLE001 — telemetry, never the data path
            pass

    @staticmethod
    def _groups_hint(inp: ScheduleInput) -> Optional[int]:
        """Pod-class count computed CLIENT-side so the daemon's single
        batcher thread doesn't pay a second O(pods) grouping pass per
        frame just to derive the fusion-bucket key (the solve re-groups
        authoritatively anyway; a wrong hint only costs fusion
        efficiency, never correctness)."""
        try:
            from karpenter_tpu_torch.solver.encode import group_pods
            return len(group_pods(inp.pods))
        except Exception:  # noqa: BLE001 — hint only
            return None

    def _solve_batch_once(self, inps: List[ScheduleInput],
                          max_nodes: Optional[int],
                          deadline: float,
                          _catalog_retry: bool = True,
                          priority: Optional[int] = None,
                          partial: Optional[Dict[int, ScheduleResult]] = None
                          ) -> List[ScheduleResult]:
        fp, payload = self._fingerprint(inps[0])
        self._ensure_catalog(fp, payload, deadline)
        # the traceparent-style context field: the daemon extracts it, runs
        # the solve under the caller's trace, and ships its spans back on
        # the result so remote-solver phases stitch into this pass's trace
        tp = tracing.inject()
        rids = []
        for inp in inps:
            f, p = self._fingerprint(inp)
            self._ensure_catalog(f, p, deadline)
            body = {
                "fingerprint": f,
                "pods": inp.pods,
                "existing_nodes": inp.existing_nodes,
                "daemon_overhead": inp.daemon_overhead,
                "remaining_limits": inp.remaining_limits,
                "price_cap": inp.price_cap,
                "max_nodes": max_nodes,
                "traceparent": tp,
                # the daemon sheds a request whose caller's deadline has
                # already passed (peers share this host's clock)
                "deadline": deadline,
                # tenant/priority ride every frame so the daemon's fair
                # scheduler queues this cluster under its own identity
                "priority": self.priority if priority is None
                else int(priority),
                "groups_hint": self._groups_hint(inp),
            }
            if self.tenant is not None:
                body["tenant"] = self.tenant
            rids.append(self._send("schedule", body))
        results_pos: Dict[int, ScheduleResult] = {}
        shed_exc: Optional[SolverServiceShed] = None
        lost_catalog = False
        waited = 0
        try:
            for pos, rid in enumerate(rids):
                kind, body = self._wait(rid, deadline)
                waited = pos + 1
                if kind == "result":
                    remote_spans = getattr(body, "_remote_spans", None)
                    if remote_spans:
                        tracing.adopt(remote_spans)
                        try:
                            del body._remote_spans
                        except AttributeError:
                            pass
                    bp = getattr(body, "_backpressure", None)
                    if bp is not None:
                        # the daemon's queue estimate rides every result:
                        # keep the latest hint for retry pacing and for
                        # callers that adapt their own submission rate
                        self.last_backpressure = bp
                        try:
                            del body._backpressure
                        except AttributeError:
                            pass
                    results_pos[pos] = body
                elif kind == "need_catalog":
                    lost_catalog = True
                    break
                elif kind == "shed":
                    # keep DRAINING: the other frames were already sent
                    # and (mostly) answered — abandoning them would turn
                    # one shed into a whole-batch retry, doubling the
                    # offered load exactly when the daemon asked for
                    # pacing.  The first shed's hint is what we raise.
                    self.last_backpressure = body \
                        if isinstance(body, dict) else None
                    if shed_exc is None:
                        shed_exc = SolverServiceShed.from_body(body)
                else:
                    raise SolverServiceError(f"solver service error: {body}")
        finally:
            # on early exit, abandon the remaining rids so their pending
            # events and later-arriving responses don't accumulate forever
            if waited < len(rids):
                with self._lock:
                    for rid in rids[waited:]:
                        self._pending.pop(rid, None)
                        self._responses.pop(rid, None)
        if lost_catalog:
            # the daemon restarted empty: the upload ledger is stale — a
            # raise alone would leave it stale FOREVER (every later call
            # skips the upload, gets need_catalog again, and the control
            # plane stays demoted to the oracle). Invalidate and replay
            # once; schedule requests are stateless, so re-solving the
            # already-answered inputs is harmless.
            self._uploaded.clear()
            if not _catalog_retry:
                raise SolverServiceError(
                    "service lost the catalog again after re-upload")
            return self._solve_batch_once(inps, max_nodes, deadline,
                                          _catalog_retry=False,
                                          priority=priority,
                                          partial=partial)
        if shed_exc is not None:
            if partial is not None:
                partial.update(results_pos)
            raise shed_exc
        return [results_pos[i] for i in range(len(rids))]
