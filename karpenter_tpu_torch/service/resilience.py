"""Shared retry/breaker policy for the solver-service client.

The port's copy of `karpenter_tpu/service/resilience.py`: the same
policy, the same metric families (in the port's registry).

The seed client had one ad-hoc `_retry` flag (the need_catalog replay).
This module is the explicit availability story KubePACS-style systems
pair with a cost-optimal scheduler:

  * :class:`RetryPolicy` — bounded attempts, exponential backoff with
    jitter, and ONE per-request deadline that also rides the wire frame
    (`body["deadline"]`, absolute epoch seconds — unix-socket peers
    share a clock) so the daemon sheds work it cannot finish in time
    instead of solving for a caller that already gave up.
  * :class:`CircuitBreaker` — trips OPEN after N consecutive transport
    failures so a dead/wedged daemon costs one fast exception per solve
    (degraded mode in GatedSolver) instead of a full timeout each pass;
    after a cooldown, ONE half-open probe is let through — success
    closes the breaker, failure re-opens it for another cooldown.

State transitions are exported on
`karpenter_tpu_service_breaker_state` (0=closed, 1=open, 2=half-open);
the client counts retries on `karpenter_tpu_service_retries_total`.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from karpenter_tpu_torch.utils import metrics

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_VALUE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter.

    `deadline` is the whole-request budget: attempts and their backoffs
    all fit inside it, and it is what the wire frame carries to the
    daemon. Jitter is a ±fraction of each backoff so a fleet of replicas
    retrying against one restarted daemon doesn't stampede in lockstep.
    """

    attempts: int = 3
    base_backoff: float = 0.05
    multiplier: float = 2.0
    max_backoff: float = 2.0
    jitter: float = 0.2
    deadline: float = 60.0

    def backoff(self, attempt: int,
                retry_after: "float | None" = None) -> float:
        """Sleep before retry number `attempt` (1-based).

        `retry_after` (seconds) is the server's backpressure hint — the
        queue-ETA the solverd scheduler ships on every shed response.
        When present it REPLACES the exponential ladder:
        the server knows its own line length, so the client paces to
        that estimate (clamped to `max_backoff`, floored at
        `base_backoff` so a zero/cold hint cannot busy-spin) instead of
        blindly doubling.  Jitter still applies either way — a fleet of
        shed clients pacing to one shared ETA would otherwise stampede
        back in lockstep."""
        if retry_after is not None and retry_after > 0:
            raw = min(max(float(retry_after), self.base_backoff),
                      self.max_backoff)
        else:
            raw = min(self.base_backoff * (self.multiplier ** (attempt - 1)),
                      self.max_backoff)
        if self.jitter <= 0:
            return raw
        span = raw * self.jitter
        return max(0.0, raw + random.uniform(-span, span))


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe.

    Thread-safe; shared by every caller of one SolverServiceClient (the
    provisioner and the disruption simulator share the client, so they
    must share its view of the service's health).
    """

    def __init__(self, threshold: int = 5, cooldown: float = 10.0,
                 clock=time.monotonic):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False
        # the gauge is written on TRANSITIONS only, never here: an
        # operator process owns one solver service, but constructing a
        # second breaker (a re-built GatedSolver, a test) must not stomp
        # a live instance's open state back to "healthy". The gauge's
        # unset default (0) already reads as closed.

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _set_state(self, state: str) -> None:
        # caller holds self._lock
        self._state = state
        metrics.SERVICE_BREAKER_STATE.set(_STATE_VALUE[state])

    def allow(self) -> bool:
        """May a request go out now? OPEN fails fast until the cooldown
        elapses, then exactly one caller becomes the half-open probe;
        everyone else keeps failing fast until the probe reports."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown:
                    return False
                self._set_state(HALF_OPEN)
                self._probing = True
                return True
            # HALF_OPEN: the probe slot is taken until it reports
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probing = False
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == HALF_OPEN:
                # the probe failed: re-open for another full cooldown
                self._opened_at = self._clock()
                self._set_state(OPEN)
            elif self._state == CLOSED and self._failures >= self.threshold:
                self._opened_at = self._clock()
                self._set_state(OPEN)
