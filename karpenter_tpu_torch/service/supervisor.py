"""Supervised kt_solverd worker.

The port's copy of `karpenter_tpu/service/supervisor.py`.  The worker is
the repository's own daemon (`native/solverd.cc`, `native/build/kt_solverd`,
built at first use by `make -s solverd` in `native/`, as the port's
loader builds kt_hostops), and the supervisor ALWAYS starts it with
`--module karpenter_tpu_torch.service.backend`: the daemon's own default
module is the JAX package's backend.  The worker's interpreter is the
libpython the daemon was linked against; the supervisor hands it this
interpreter's import path (the repository root, then `sys.path`) in
PYTHONPATH, so the worker imports the torch this process imports.

The embedded-CPython solver daemon is the one component whose compute
path can take the whole process down (a fault in a kernel or the driver, an OOM kill, a
wedged lowering). Crash isolation means the *daemon process* is
disposable: this supervisor owns the socket path's lifecycle, runs
kt_solverd as a child WORKER process, and restarts it on any unexpected
exit with crash-loop backoff. Everything else recovers through contracts
that already exist:

  * in-flight requests — the worker's death closes its connections;
    every client's reader fails its outstanding waiters fast
    (service/client.py `_read_loop`), nothing hangs until timeout
  * catalog state — the restarted worker is empty; clients re-upload on
    demand via the `need_catalog` handshake (their upload ledger is
    per-connection and clears on reconnect)
  * build state — the kernels' libraries stay in `karpenter_tpu_torch/
    _build/`, so a restarted worker loads them instead of running nvcc

Restart policy: exponential backoff (base·2^streak, capped, jittered) on
consecutive crashes; a worker that stayed up longer than
`backoff_reset` resets the streak, so one crash a day restarts in
`backoff_base` while a crash loop decays to `backoff_max`. Each restart
increments `karpenter_tpu_service_worker_restarts_total`.

Wedge detection (optional, off by default): with `probe_interval` set,
the supervisor periodically opens a fresh connection and sends a
("stats", {}) frame; `probe_failures` consecutive probes with no answer
within `probe_timeout` get the worker killed (and therefore restarted).
The default is off because a cold kernel build legitimately blocks the
single batcher thread for minutes — enable it only with a
`probe_timeout` comfortably above the worst compile the deployment can
see, or with a warm compilation cache.

Usage (programmatic — tests, operator wiring):

    sup = SolverdSupervisor(socket_path)
    sup.start()
    ...
    sup.stop()

Usage (CLI, the deployment shape):

    python -m karpenter_tpu_torch.service.supervisor --socket /run/kt.sock \\
        [--binary native/build/kt_solverd] [-- --idle-ms 5 --max-ms 100]
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import struct
import subprocess
import threading
import time
from typing import Optional, Sequence

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
DEFAULT_BINARY = os.path.join(_NATIVE, "build", "kt_solverd")
# the backend every worker this module starts embeds
BACKEND_MODULE = "karpenter_tpu_torch.service.backend"

_build_lock = threading.Lock()


def build_binary(timeout: float = 180.0) -> str:
    """DEFAULT_BINARY, built by `make -s solverd` in native/ when missing
    (once per process, under a lock: two supervisors racing here must
    not run two makes over one output).  Raises RuntimeError with make's
    output when the daemon does not build or link — there is no other
    worker to fall back to."""
    with _build_lock:
        if not os.path.exists(DEFAULT_BINARY):
            try:
                subprocess.run(["make", "-s", "solverd"], cwd=_NATIVE,
                               timeout=timeout, check=True,
                               capture_output=True, text=True)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"make solverd exited {e.returncode}:\n{e.stdout}"
                    f"{e.stderr}") from e
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"make solverd: {e}") from e
    return DEFAULT_BINARY


def worker_env(env: Optional[dict] = None) -> dict:
    """The worker's environment: `env` (this process's by default) with
    the repository root and this interpreter's `sys.path` appended to
    PYTHONPATH, so the embedded interpreter imports this checkout's
    package and the torch this process runs."""
    import sys
    out = dict(os.environ if env is None else env)
    paths = [p for p in out.get("PYTHONPATH", "").split(os.pathsep) if p]
    for p in [_REPO, *sys.path]:
        if p and p not in paths:
            paths.append(p)
    out["PYTHONPATH"] = os.pathsep.join(paths)
    return out


class SolverdSupervisor:
    def __init__(self, socket_path: str,
                 binary: Optional[str] = None,
                 extra_args: Sequence[str] = (),
                 env: Optional[dict] = None,
                 stderr_path: Optional[str] = None,
                 backoff_base: float = 0.2,
                 backoff_max: float = 30.0,
                 backoff_reset: float = 60.0,
                 max_restarts: Optional[int] = None,
                 probe_interval: Optional[float] = None,
                 probe_timeout: float = 300.0,
                 probe_failures: int = 3):
        self.socket_path = socket_path
        self.binary = binary or DEFAULT_BINARY
        self.extra_args = list(extra_args)
        self.env = worker_env(env)
        self.stderr_path = stderr_path
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.backoff_reset = backoff_reset
        self.max_restarts = max_restarts
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.probe_failures = max(1, int(probe_failures))
        self.restarts = 0
        self.last_exit: Optional[int] = None
        self.gave_up = False
        self._log = get_logger("solverd-supervisor")
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._stop_ev = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self, wait_for_socket: bool = True,
              timeout: float = 30.0) -> None:
        if self.binary == DEFAULT_BINARY:
            build_binary()
        if not os.path.exists(self.binary):
            raise FileNotFoundError(
                f"kt_solverd binary missing: {self.binary} "
                "(build it: make -C native solverd)")
        self._stop_ev.clear()
        self.gave_up = False
        self._spawn()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="solverd-supervisor")
        self._monitor.start()
        # forward worker-lifecycle state to the operator's dashboard:
        # in the in-process topology (tests, embedded supervision) the
        # operator's GET /debug/dashboard merges this source; the
        # standalone CLI exports the same numbers via --metrics-port
        from karpenter_tpu_torch.utils import telemetry
        self._telemetry_fn = self.stats  # one bound object: unregister
        telemetry.register_source("supervisor", self._telemetry_fn)
        if wait_for_socket:
            self.wait_ready(timeout)

    def wait_ready(self, timeout: float = 30.0) -> None:
        """Block until a worker is actually ACCEPTING on the socket. A
        connect probe, not an existence check: a SIGKILLed worker never
        unlinks its socket file, so after a crash (or against a
        persistent volume) the stale file exists long before the
        replacement listens. Returns early once the supervisor has
        given up (`max_restarts`) — callers assert on `gave_up`."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.gave_up or self._stop_ev.is_set():
                return
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(0.5)
            try:
                s.connect(self.socket_path)
                return
            except OSError:
                pass
            finally:
                try:
                    s.close()
                except OSError:
                    pass
            time.sleep(0.05)
        raise TimeoutError(
            f"solverd worker never accepted on {self.socket_path}")

    def stats(self) -> dict:
        """Snapshot for the telemetry merge (utils/telemetry.py): the
        worker-lifecycle state only this process knows — restart count,
        liveness, last exit code, crash-loop give-up."""
        return {
            "restarts": self.restarts,
            "running": self.running,
            "gave_up": self.gave_up,
            "last_exit": self.last_exit,
            "worker_pid": self.worker_pid,
            "socket": self.socket_path,
        }

    def stop(self, timeout: float = 10.0) -> None:
        from karpenter_tpu_torch.utils import telemetry
        fn = getattr(self, "_telemetry_fn", None)
        if fn is not None:
            telemetry.unregister_source("supervisor", fn)
        # order matters: join the monitor FIRST (its waits are all
        # short and stop-aware), THEN kill whatever worker is current —
        # terminating before the join races a backoff-respawn and
        # leaks a live worker holding the socket
        self._stop_ev.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout)
            self._monitor = None
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            # the stopped worker's own exit code (0 on a clean SIGTERM)
            self.last_exit = proc.returncode

    def kill_worker(self) -> None:
        """SIGKILL the current worker (fault-matrix harness: sudden
        death mid-batch). The monitor restarts it through the normal
        crash path."""
        with self._lock:
            proc = self._proc
        if proc is not None and proc.poll() is None:
            proc.kill()

    @property
    def running(self) -> bool:
        with self._lock:
            proc = self._proc
        return proc is not None and proc.poll() is None

    @property
    def worker_pid(self) -> Optional[int]:
        with self._lock:
            proc = self._proc
        return proc.pid if proc is not None and proc.poll() is None else None

    # -- internals --------------------------------------------------------
    def _spawn(self) -> None:
        # the module last: the daemon takes the last --module it is given
        argv = [self.binary, "--socket", self.socket_path,
                *self.extra_args, "--module", BACKEND_MODULE]
        stderr_f = None
        try:
            if self.stderr_path:
                stderr_f = open(self.stderr_path, "ab")
            proc = subprocess.Popen(argv, env=self.env, stderr=stderr_f)
        finally:
            if stderr_f is not None:
                # Popen dup'd the fd into the child; the parent copy
                # closes so repeated restarts can't leak descriptors
                stderr_f.close()
        with self._lock:
            self._proc = proc
        self._log.info("solverd worker started", pid=proc.pid,
                       socket=self.socket_path)

    def _monitor_loop(self) -> None:
        streak = 0
        while not self._stop_ev.is_set():
            with self._lock:
                proc = self._proc
            started = time.monotonic()
            self._await_exit(proc)
            self.last_exit = proc.returncode
            if self._stop_ev.is_set():
                return
            uptime = time.monotonic() - started
            if uptime > self.backoff_reset:
                streak = 0  # it ran healthily; this is a fresh incident
            # decide give-up BEFORE counting/logging a restart: the
            # restart counter and its metric must track restarts that
            # actually happen, and a "restarting" log line for a worker
            # that never comes back misleads whoever tails it
            if self.max_restarts is not None \
                    and self.restarts >= self.max_restarts:
                self.gave_up = True
                self._log.error(
                    "solverd worker died again after max restarts; "
                    "giving up (control plane stays in degraded mode)",
                    exit_code=proc.returncode, restarts=self.restarts)
                return
            delay = min(self.backoff_base * (2 ** streak), self.backoff_max)
            delay *= 1.0 + random.uniform(-0.1, 0.1)
            self._log.warn(
                "solverd worker died; restarting",
                exit_code=proc.returncode, uptime_s=round(uptime, 3),
                backoff_s=round(delay, 3))
            if self._stop_ev.wait(max(0.0, delay)):
                return
            streak += 1
            try:
                self._spawn()
            except OSError as e:
                # binary vanished / fork failed: retry with growing
                # backoff rather than killing the supervisor thread —
                # and do NOT count it: the restart counter/metric track
                # workers that actually came back
                self._log.error("solverd worker respawn failed; will "
                                "retry", error=str(e))
                continue
            self.restarts += 1
            metrics.SERVICE_WORKER_RESTARTS.inc()

    def _await_exit(self, proc: subprocess.Popen) -> None:
        """Wait for the worker to exit; with probing enabled, interleave
        liveness probes and SIGKILL a wedged worker so the wait
        completes through the normal crash path."""
        if self.probe_interval is None:
            while not self._stop_ev.is_set():
                try:
                    proc.wait(timeout=0.5)
                    return
                except subprocess.TimeoutExpired:
                    continue
            proc.poll()
            return
        misses = 0
        last_probe = time.monotonic()
        while not self._stop_ev.is_set():
            try:
                proc.wait(timeout=0.2)
                return
            except subprocess.TimeoutExpired:
                pass
            if time.monotonic() - last_probe < self.probe_interval:
                continue
            last_probe = time.monotonic()
            if self._probe_once():
                misses = 0
            else:
                misses += 1
                self._log.warn("solverd worker probe failed",
                               consecutive=misses,
                               threshold=self.probe_failures)
                if misses >= self.probe_failures:
                    self._log.error(
                        "solverd worker wedged (no answer to stats "
                        "probe); killing for restart", misses=misses)
                    proc.kill()
                    # loop back to proc.wait() which now returns
        proc.poll()

    def _probe_once(self) -> bool:
        """One liveness probe: fresh connection, ("stats", {}) frame,
        wait for any response frame within probe_timeout."""
        payload = pickle.dumps(("stats", {}),
                               protocol=pickle.HIGHEST_PROTOCOL)
        frame = struct.pack("<IQ", len(payload), 0) + payload
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(self.probe_timeout)
        try:
            s.connect(self.socket_path)
            s.sendall(frame)
            need = 12
            buf = b""
            while len(buf) < need:
                chunk = s.recv(need - len(buf))
                if not chunk:
                    return False
                buf += chunk
            return True
        except OSError:
            return False
        finally:
            try:
                s.close()
            except OSError:
                pass


def _serve_metrics(port: int):
    """Tiny /metrics exporter for the STANDALONE supervisor CLI: the
    worker-restart counter lives in this process, and without an
    endpoint here the documented crash-loop signal would be invisible
    in the deployed topology (the operator replicas export their own
    registries on their own ports)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = metrics.REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes are not log events
            pass

    from karpenter_tpu_torch.utils.knobs import bind_host
    srv = ThreadingHTTPServer((bind_host(), port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="supervisor-metrics").start()
    return srv


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.service.supervisor",
        description="Supervise a kt_solverd worker: restart on crash "
                    "with backoff; args after -- pass through to the "
                    "worker.")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--binary", default=None)
    ap.add_argument("--stderr", default=None,
                    help="append worker stderr to this file")
    ap.add_argument("--backoff-base", type=float, default=0.2)
    ap.add_argument("--backoff-max", type=float, default=30.0)
    ap.add_argument("--probe-interval", type=float, default=None)
    ap.add_argument("--probe-timeout", type=float, default=300.0)
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics (worker restart counter) on "
                         "this port; 0 = off")
    ap.add_argument("--tenant-weights-file", default=None,
                    help="tenant-weights config file exported to the "
                         "worker as KARPENTER_TPU_TENANT_WEIGHTS_FILE "
                         "(the env knob KARPENTER_TPU_TENANT_WEIGHTS "
                         "stays the per-tenant override)")
    ap.add_argument("worker_args", nargs="*",
                    help="extra kt_solverd args (after --)")
    args = ap.parse_args(argv)
    env = dict(os.environ)
    if args.tenant_weights_file:
        # export-only, never parsed here: the worker's scheduler.py
        # (the knob's grammar owner) reads and parses the file
        env["KARPENTER_TPU_TENANT_WEIGHTS_FILE"] = (  # kt-lint: disable=env-knob
            args.tenant_weights_file)
    sup = SolverdSupervisor(
        args.socket, binary=args.binary, extra_args=args.worker_args,
        env=env,
        stderr_path=args.stderr, backoff_base=args.backoff_base,
        backoff_max=args.backoff_max, probe_interval=args.probe_interval,
        probe_timeout=args.probe_timeout)
    if args.metrics_port:
        _serve_metrics(args.metrics_port)
    sup.start(wait_for_socket=False)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        sup.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
