"""Injected clock — every controller takes one, mirroring the reference's
`clock.Clock` injection (cmd/controller/main.go:47), so tests can step time
deterministically.
"""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return time.time()


class FakeClock(Clock):
    def __init__(self, start: float = 1_000_000.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def step(self, seconds: float) -> None:
        self._now += seconds

    def set(self, t: float) -> None:
        self._now = t
