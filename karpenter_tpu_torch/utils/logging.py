"""Structured logging with change-gated noise suppression.

The reference logs through zap via controller-runtime's `log.FromContext`
and gates repetitive provider logs behind `pretty.ChangeMonitor`
(pkg/providers/instancetype/instancetype.go:151-153 — the
instance-type count is logged only when it CHANGES, not every 5-minute
refresh). Same shape here: logfmt lines on stderr, level from LOG_LEVEL,
and a ChangeMonitor for polling loops.
"""

from __future__ import annotations

import os
import sys
import threading
import time

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


def _configured_level() -> int:
    return _LEVELS.get(os.environ.get("LOG_LEVEL", "info").strip().lower(), 20)


def _fmt_value(v: object) -> str:
    s = str(v)
    # newlines would split one logfmt record across lines (multi-line
    # exception messages are common kv values)
    s = s.replace("\n", "\\n").replace("\r", "\\r")
    if any(c in s for c in ' "='):
        s = '"' + s.replace('"', '\\"') + '"'
    return s


class Logger:
    """A named logfmt logger: `log.info("msg", pods=3, pool="default")` →
    `ts=... level=info logger=provisioner msg="..." pods=3 pool=default`.
    """

    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream

    def _emit(self, level: str, msg: str, kv: dict) -> None:
        if _LEVELS[level] < _configured_level():
            return
        # UTC with millisecond precision: span start/end times are wall
        # clock (utils/tracing), so log lines must carry enough timestamp
        # to line up against them — local-time whole seconds can't
        now = time.time()
        parts = [
            f"ts={time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(now))}"
            f".{int(now * 1000) % 1000:03d}Z",
            f"level={level}",
            f"logger={self.name}",
            f"msg={_fmt_value(msg)}",
        ]
        parts += [f"{k}={_fmt_value(v)}" for k, v in kv.items()]
        print(" ".join(parts), file=self.stream or sys.stderr, flush=True)

    def debug(self, msg: str, **kv) -> None:
        self._emit("debug", msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._emit("info", msg, kv)

    def warn(self, msg: str, **kv) -> None:
        self._emit("warn", msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._emit("error", msg, kv)


_loggers: dict = {}
_lock = threading.Lock()


def get_logger(name: str) -> Logger:
    with _lock:
        lg = _loggers.get(name)
        if lg is None:
            lg = _loggers[name] = Logger(name)
        return lg


class ChangeMonitor:
    """Noise gate for polling loops: `has_changed(key, value)` is True only
    when `value` differs from the last one seen for `key` (or the entry
    aged out). Mirrors the reference's pretty.ChangeMonitor — refresh
    controllers log state only on change, not on every poll."""

    def __init__(self, ttl: float = 24 * 3600.0, now=time.monotonic):
        self.ttl = ttl
        self._now = now
        self._seen: dict = {}
        self._lock = threading.Lock()
        self._next_sweep = now() + ttl

    def has_changed(self, key: str, value: object) -> bool:
        now = self._now()
        with self._lock:
            if now >= self._next_sweep:
                # opportunistic expiry sweep: per-KEY polling loops (one
                # entry per node name, pod uid, ...) otherwise grow _seen
                # forever in a long-running operator — expired entries
                # would re-log anyway, so dropping them changes nothing
                self._seen = {k: e for k, e in self._seen.items()
                              if now - e[1] < self.ttl}
                self._next_sweep = now + self.ttl
            entry = self._seen.get(key)
            if entry is not None:
                last_value, stamp = entry
                if last_value == value and now - stamp < self.ttl:
                    return False
            self._seen[key] = (value, now)
            return True
