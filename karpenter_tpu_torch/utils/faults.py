"""Repo-native fault-injection harness.

The port's copy of `karpenter_tpu/utils/faults.py`: the same points,
modes, grammar and environment variable, and the same `fault.inject`
timeline event on every `arm` (into the port's `timeline/recorder.py`).
The two packages keep separate registries: `KARPENTER_TPU_FAULTS` arms
both at their import, `arm`/`disarm` touch only the calling package's.

Named injection points sit at the seams where production breaks: the
solver-service RPC framing boundary, store I/O, and device dispatch.
Each point is a `faults.fire("<point>")` call at the site; disarmed (the
default, and the state every test starts and ends in) it costs one
module-global bool check.

Arming:

  * environment —
    `KARPENTER_TPU_FAULTS="point=mode[:arg][:times][:after],..."`
    read once at import and re-readable via `load_env()`:

        KARPENTER_TPU_FAULTS="service.client.send=delay:0.2"
        KARPENTER_TPU_FAULTS="solverd.handle_batch=crash::1,store.remote.rpc=drop"

  * programmatic — `faults.arm(point, mode, arg=..., times=...)`,
    `faults.disarm()` to clear (tests use this; the port's test files
    that arm faults disarm after every test with an autouse fixture, so
    one forgotten cleanup cannot poison the suite).

Modes (what a site does with the verdict):

  * ``delay``    — sleep ``arg`` seconds at the site, then proceed
  * ``drop``     — raise :class:`FaultInjected`; sites translate this to
                   their native failure (a dropped frame, a failed RPC)
  * ``truncate`` — for sites that pass bytes through :func:`fire`,
                   return only the first ``arg`` bytes (default: half)
                   and raise on the NEXT fire so the stream dies mid-
                   frame — the truncated-frame / mid-frame-EOF shape
  * ``crash``    — ``os._exit(arg or 137)``: sudden process death, the
                   worker-killed-mid-batch shape (only meaningful inside
                   a disposable worker process, e.g. kt_solverd's
                   backend; never arm it in the operator)
  * ``error``    — raise :class:`FaultInjected` (alias of drop for sites
                   where "drop" reads wrong, e.g. device dispatch)

``times`` bounds how often a spec fires (default: forever). A spec whose
budget is spent stops matching, so "fail the first 3 RPCs then recover"
is one arm() call.

Points the port fires (grep for ``faults.fire`` to verify):

  * ``store.remote.rpc``     — RemoteBackend RPC round trip
  * ``solver.dispatch``      — device dispatch of one padded problem
                               (the solve's `execute`, the delta seam,
                               the chunk chain), host side before the
                               upload and the launch
  * ``solver.audit.digest``  — the shadow audit's live digest, perturbed
                               before comparison (solver/audit.py)
  * ``service.client.send``  — client→solverd frame write
                               (service/client.py)
  * ``service.client.recv``  — solverd→client frame read (the client's
                               reader thread)
  * ``solverd.handle_batch`` — the worker's batch entry
                               (service/backend.py; ``crash`` kills the
                               worker mid-batch)
  * ``determinism.digest``   — the determinism harness's canonical
                               flight record (tools/determinism.py
                               `canon_flight_record`; ``error`` stamps a
                               wall-clock perturbation into it, the
                               harness's ``--drill``)
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

MODES = ("delay", "drop", "truncate", "crash", "error")

# fast-path gate: fire() returns immediately while this is False, so the
# disarmed hot path (every RPC, every solve) pays one global read
ARMED = False

_lock = threading.Lock()
_registry: Dict[str, List["_Spec"]] = {}


class FaultInjected(RuntimeError):
    """Raised at an injection site for drop/error (and the post-truncate
    stream kill). Sites either let it propagate (the caller's failure
    handling is the thing under test) or translate it to their native
    failure type."""

    def __init__(self, point: str, mode: str):
        super().__init__(f"injected fault at {point!r} ({mode})")
        self.point = point
        self.mode = mode


class _Spec:
    __slots__ = ("point", "mode", "arg", "remaining", "fired", "tripped",
                 "skip")

    def __init__(self, point: str, mode: str, arg: Optional[float],
                 times: Optional[int], after: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} (one of {MODES})")
        self.point = point
        self.mode = mode
        self.arg = arg
        self.remaining = times          # None = unbounded
        self.fired = 0
        # truncate state: first fire truncates, second kills the stream
        self.tripped = False
        # let the first `after` site hits pass through untouched: "crash
        # on the SECOND batch" is one spec, not test choreography
        self.skip = max(0, int(after))


def arm(point: str, mode: str, arg: Optional[float] = None,
        times: Optional[int] = None, after: int = 0) -> None:
    """Register one fault spec. Multiple specs may share a point (they
    fire in arm order, each consuming its own budget); `after` skips the
    first N site hits before the spec starts firing."""
    global ARMED
    spec = _Spec(point, mode, arg, times, after=after)
    with _lock:
        _registry.setdefault(point, []).append(spec)
        ARMED = True
    # the timeline's fault.inject capture point: every armed spec —
    # env-loaded, test-armed, or replayed — lands on the cluster
    # timeline so a recorded stream reproduces the fault schedule
    from karpenter_tpu_torch.timeline import events as _tev
    from karpenter_tpu_torch.timeline import recorder as _trec
    _trec.emit(_tev.FAULT_INJECT, name=point,
               data={"mode": mode, "arg": arg, "times": times,
                     "after": after})


def disarm(point: Optional[str] = None) -> None:
    """Clear one point, or everything when point is None."""
    global ARMED
    with _lock:
        if point is None:
            _registry.clear()
        else:
            _registry.pop(point, None)
        ARMED = bool(_registry)


def armed(point: Optional[str] = None) -> bool:
    if point is None:
        return ARMED
    with _lock:
        return bool(_registry.get(point))


def fire_count(point: str) -> int:
    """How many times any spec on `point` has fired (test assertions)."""
    with _lock:
        return sum(s.fired for s in _registry.get(point, ()))


def fire(point: str, payload: Optional[bytes] = None) -> Optional[bytes]:
    """The injection site call. Returns `payload` (possibly truncated);
    may sleep, raise FaultInjected, or _exit the process, per the armed
    spec. No-op (returns payload unchanged) while disarmed."""
    if not ARMED:
        return payload
    with _lock:
        specs = _registry.get(point)
        if not specs:
            return payload
        spec = None
        for s in specs:
            if s.remaining is not None and s.remaining <= 0 \
                    and not (s.mode == "truncate" and s.tripped):
                continue
            if s.skip > 0:
                s.skip -= 1
                continue
            spec = s
            break
        if spec is None:
            return payload
        # truncate's stream-kill follow-up fires even with budget spent,
        # exactly ONCE — consuming it retires the spec
        if not (spec.mode == "truncate" and spec.tripped):
            if spec.remaining is not None:
                spec.remaining -= 1
        spec.fired += 1
        mode, arg, tripped = spec.mode, spec.arg, spec.tripped
        if mode == "truncate":
            spec.tripped = not tripped
    if mode == "delay":
        time.sleep(arg if arg is not None else 0.05)
        return payload
    if mode in ("drop", "error"):
        raise FaultInjected(point, mode)
    if mode == "crash":
        os._exit(int(arg) if arg is not None else 137)
    # truncate: first fire shortens the payload (a torn frame on the
    # wire); the next fire at the same point raises, so the peer sees
    # mid-frame EOF instead of a clean boundary
    if tripped:
        raise FaultInjected(point, mode)
    if payload is None:
        raise FaultInjected(point, mode)
    cut = int(arg) if arg is not None else max(1, len(payload) // 2)
    return payload[:cut]


def load_env(value: Optional[str] = None) -> int:
    """Parse KARPENTER_TPU_FAULTS (or `value`) into armed specs on top of
    whatever is already armed. Returns the number of specs added.
    Malformed entries raise ValueError — a typo'd fault plan silently
    doing nothing is worse than failing loudly at startup."""
    s = (os.environ.get("KARPENTER_TPU_FAULTS", "")
         if value is None else value)
    added = 0
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        point, sep, rest = part.partition("=")
        if not sep or not point:
            raise ValueError(f"KARPENTER_TPU_FAULTS entry {part!r}: "
                             "expected point=mode[:arg][:times][:after]")
        bits = rest.split(":")
        mode = bits[0]
        arg = float(bits[1]) if len(bits) > 1 and bits[1] != "" else None
        times = int(bits[2]) if len(bits) > 2 and bits[2] != "" else None
        after = int(bits[3]) if len(bits) > 3 and bits[3] != "" else 0
        arm(point.strip(), mode.strip(), arg=arg, times=times, after=after)
        added += 1
    return added


# env arming at import: the operator/daemon picks up a fault plan from
# its environment without code changes. Tests run with the variable
# scrubbed (tests/conftest.py pops it before this module ever loads).
if os.environ.get("KARPENTER_TPU_FAULTS"):
    load_env()
