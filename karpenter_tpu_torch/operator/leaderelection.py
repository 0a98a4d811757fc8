"""Leader election — the active/passive replica story.

The reference deploys 2 replicas with leader election on a coordination
lease (charts/karpenter/values.yaml:35; core LEADER_ELECT, settings.md):
one replica reconciles, the standby takes over when the lease expires.
Same shape here: a `LeaderElector` per replica races `try_acquire_or_renew`
against a shared lease backend.

Backends:
  * `InMemoryLease` — replicas in one process (tests, embedded pairs).
  * `FileLease` — replicas on one host sharing a lease file; mutual
    exclusion via flock so acquire is atomic across processes. Replicas
    sharing one host is exactly the deployment `kt_solverd` enables (one
    device-owning daemon, N control planes — native/solverd.cc).

Timing mirrors client-go's LeaderElectionConfig defaults scaled down
(leaseDuration 15s / renewDeadline 10s / retryPeriod 2s).

The port's copy of `karpenter_tpu/operator/leaderelection.py` (it has
no internal imports).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class InMemoryLease:
    """A process-local lease shared by reference between replicas."""

    def __init__(self):
        self._lock = threading.Lock()
        self._holder: Optional[str] = None
        self._expiry: float = 0.0

    def try_acquire(self, identity: str, duration: float,
                    now: float) -> bool:
        with self._lock:
            if self._holder in (None, identity) or now >= self._expiry:
                self._holder = identity
                self._expiry = now + duration
                return True
            return False

    def release(self, identity: str) -> None:
        with self._lock:
            if self._holder == identity:
                self._holder = None
                self._expiry = 0.0

    def holder(self, now: float) -> Optional[str]:
        with self._lock:
            return self._holder if now < self._expiry else None


class FileLease:
    """A lease file shared by replicas on one host.

    The read-check-write critical section runs under flock on a sidecar
    lock file, so two processes can't both see an expired lease and both
    write themselves as holder. Timestamps are wall-clock (shared between
    processes; monotonic clocks are not)."""

    def __init__(self, path: str):
        self.path = path
        self._lock_path = path + ".lock"

    # bounded so a wedged peer process holding the flock demotes this
    # replica (try_acquire returns False, the elector stays standby and
    # retries) instead of freezing its run loop on an unbounded LOCK_EX
    # wait (kt-lint lock-discipline)
    FLOCK_TIMEOUT = 0.5

    def _with_flock(self, fn):
        """Run `fn` under the sidecar flock; returns None (without running
        `fn`) when the flock stays contended past FLOCK_TIMEOUT."""
        import fcntl
        fd = os.open(self._lock_path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            deadline = time.monotonic() + self.FLOCK_TIMEOUT
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        return None
                    time.sleep(0.01)
            try:
                return fn()
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)

    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write(self, rec: dict) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)

    def try_acquire(self, identity: str, duration: float,
                    now: float) -> bool:
        def attempt():
            rec = self._read()
            if rec.get("holder") in (None, identity) \
                    or now >= rec.get("expiry", 0.0):
                self._write({"holder": identity, "expiry": now + duration})
                return True
            return False
        # contended flock (None) = another replica is mid-acquire: report
        # not-acquired; the elector retries on its retry_period cadence
        return bool(self._with_flock(attempt))

    def release(self, identity: str) -> None:
        def attempt():
            rec = self._read()
            if rec.get("holder") == identity:
                self._write({})
        self._with_flock(attempt)

    def holder(self, now: float) -> Optional[str]:
        rec = self._read()
        return rec.get("holder") if now < rec.get("expiry", 0.0) else None


class LeaderElector:
    """Per-replica election state machine.

    `try_acquire_or_renew()` is called from the replica's run loop: the
    leader renews every `renew_interval`, a standby retries acquisition
    every `retry_period`. Losing the lease (renewal raced an expiry
    takeover) demotes back to standby — the replica keeps running and may
    re-acquire later, unlike client-go's process exit, because our
    controllers are idempotent against the shared store."""

    def __init__(self, lease, identity: Optional[str] = None,
                 lease_duration: float = 15.0, renew_interval: float = 5.0,
                 retry_period: float = 2.0, now=time.time):
        import uuid
        self.lease = lease
        # nodename-pid alone collides for two replicas in one process (the
        # InMemoryLease use case) and holder==identity counts as a renew —
        # a per-instance nonce keeps default identities unique
        self.identity = identity or (
            f"{os.uname().nodename}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        self.lease_duration = lease_duration
        self.renew_interval = renew_interval
        self.retry_period = retry_period
        self._now = now
        self._is_leader = False
        self._last_renew = 0.0

    @property
    def is_leader(self) -> bool:
        return self._is_leader

    def try_acquire_or_renew(self) -> bool:
        """Returns leadership after this attempt; renews at most every
        renew_interval while leading."""
        now = self._now()
        if self._is_leader and now - self._last_renew < self.renew_interval:
            return True
        ok = self.lease.try_acquire(self.identity, self.lease_duration, now)
        if ok:
            self._last_renew = now
        was = self._is_leader
        self._is_leader = ok
        if was and not ok:
            # lost the lease — another replica took over during our gap
            self._last_renew = 0.0
        return ok

    def release(self) -> None:
        if self._is_leader:
            self.lease.release(self.identity)
            self._is_leader = False
