"""Dynamic lock-order observer: the runtime half of kt-lint's static
`lock-order` analysis.

The port's copy of `karpenter_tpu/utils/lockwatch.py`, scoped to the
port: it wraps the locks constructed inside `karpenter_tpu_torch/` and
no others, so it can run beside the JAX package's observer (each keeps
its own edges).

The static pass (hack/analyze/rules/lock_order.py) builds an
interprocedural lock-acquisition graph and flags order inversions.  This
module records the acquisition edges that REALLY happen and fails when
an observed edge contradicts the static order (or when the run itself
exhibits both directions of a pair).  `verify()` takes the static edges
and the site map as arguments (`build_model` over the port's files gives
both: its sites are repository-relative, `karpenter_tpu_torch/<file>.py:
<line>`, the format of this module's sites); without them it checks
both-directions pairs only.

Mechanism: :func:`install` replaces ``threading.Lock`` / ``RLock`` /
``Condition`` with factories.  A lock constructed from a frame inside
``karpenter_tpu_torch/`` comes back wrapped (its construction site —
``karpenter_tpu_torch/<file>.py:<line>`` — is its identity, matching the
static model's definition sites); every other caller (stdlib, torch,
tests) gets the raw primitive, so the probe costs nothing outside the
code under study.  Each observed acquire records one directed edge per
lock currently held by the acquiring thread.  ``Condition.wait``
releases and re-acquires through the wrapped lock, so held-sets stay
truthful across waits.

Edges are aggregated by construction *site*, not instance: two
instances sharing a site (every `Counter._lock`) produce self-pairs,
which are reported informationally but never failed — instance-level
ordering within one class is out of the static model's scope too.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.utils.knobs import env_bool

ENV_GATE = "KARPENTER_TPU_LOCK_OBSERVER"

# raw primitives captured at import, before any install() — the
# observer's own bookkeeping must never route through the observer
_RAW_LOCK = threading.Lock
_RAW_RLOCK = threading.RLock
_RAW_CONDITION = threading.Condition

_meta = _RAW_LOCK()                       # guards _EDGES/_installed
_tls = threading.local()                  # .held: List[(site, id(obj))]
# (site_held, site_acquired) -> first-witness thread name
_EDGES: Dict[Tuple[str, str], str] = {}
_installed = False


def armed_from_env() -> bool:
    """The opt-in gate (KARPENTER_TPU_LOCK_OBSERVER) a harness consults
    before importing the rest of the tree."""
    return env_bool(ENV_GATE)


def _held() -> List[Tuple[str, int]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _record_acquire(site: str, obj_id: int) -> None:
    held = _held()
    if held:
        name = threading.current_thread().name
        for h_site, h_id in held:
            key = (h_site, site)
            if key not in _EDGES:
                with _meta:
                    _EDGES.setdefault(key, name)
    held.append((site, obj_id))


def _record_release(site: str, obj_id: int) -> None:
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i] == (site, obj_id):
            del held[i]
            return


class _ObservedLock:
    """Proxy over a raw lock that reports acquisition edges.  Exposes
    exactly the subset `threading.Condition`'s fallbacks use
    (acquire/release/locked + context manager), so it slots in as a
    Condition's underlying lock unchanged."""

    __slots__ = ("_inner", "_site", "_reentrant", "_count")

    def __init__(self, inner, site: str, reentrant: bool = False):
        self._inner = inner
        self._site = site
        self._reentrant = reentrant
        self._count = 0  # RLock: record the edge once per outermost hold

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            if self._reentrant and self._count > 0:
                self._count += 1
            else:
                self._count += 1
                _record_acquire(self._site, id(self))
        return got

    def release(self) -> None:
        if self._count > 0:
            self._count -= 1
            if self._count == 0 or not self._reentrant:
                _record_release(self._site, id(self))
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition protocol (reentrant inners only) -----------------------
    # threading.Condition binds `_release_save`/`_acquire_restore`/
    # `_is_owned` off the lock IF PRESENT, else falls back to
    # release()/acquire() — correct for a plain Lock proxy (and it
    # routes through our bookkeeping), but WRONG for a wrapped RLock:
    # the fallback `_is_owned` does acquire(False), which succeeds for
    # the owning thread of a reentrant lock, so wait()/notify() would
    # raise "cannot wait on un-acquired lock", and the fallback release
    # drops only one level of a recursive hold.  Expose the protocol
    # via __getattr__ so a plain-Lock proxy still raises AttributeError
    # (keeping the tested fallback path) while an RLock proxy forwards
    # with held-set bookkeeping kept truthful across the wait.
    def __getattr__(self, name: str):
        if self._reentrant:
            if name == "_release_save":
                return self._reentrant_release_save
            if name == "_acquire_restore":
                return self._reentrant_acquire_restore
            if name == "_is_owned":
                return self._inner._is_owned
        raise AttributeError(name)

    def _reentrant_release_save(self):
        state = self._inner._release_save()
        depth = self._count
        self._count = 0
        if depth:
            _record_release(self._site, id(self))
        return (state, depth)

    def _reentrant_acquire_restore(self, saved) -> None:
        state, depth = saved
        self._inner._acquire_restore(state)
        self._count = depth
        if depth:
            _record_acquire(self._site, id(self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<ObservedLock {self._site} {self._inner!r}>"


def _creation_site() -> Optional[str]:
    """`karpenter_tpu_torch/<path>:<line>` of the frame constructing the lock,
    or None when the construction is outside the package (unobserved).
    A construction from inside `threading.py` itself (the inner lock of
    an Event/Timer/Barrier) is deliberately unobserved: those are not
    lock *definitions* in the static model, and instrumenting every
    pending-response Event would tax the hot paths for edges the model
    can't anchor."""
    f = sys._getframe(2)
    if f is None:
        return None
    fn = f.f_code.co_filename.replace(os.sep, "/")
    if os.path.basename(fn) in ("threading.py", "lockwatch.py"):
        return None
    marker = "/karpenter_tpu_torch/"
    i = fn.rfind(marker)
    if i < 0:
        return None
    return f"karpenter_tpu_torch/{fn[i + len(marker):]}:{f.f_lineno}"


def _lock_factory():
    site = _creation_site()
    if site is None:
        return _RAW_LOCK()
    return _ObservedLock(_RAW_LOCK(), site)


def _rlock_factory():
    site = _creation_site()
    if site is None:
        return _RAW_RLOCK()
    return _ObservedLock(_RAW_RLOCK(), site, reentrant=True)


def _condition_factory(lock=None):
    # a Condition's acquisition identity IS its underlying lock's: pass
    # an observed lock through (aliasing — the static model does the
    # same for `Condition(self._lock)`), mint one for a bare Condition()
    if lock is None:
        site = _creation_site()
        lock = _ObservedLock(_RAW_LOCK(), site) if site else _RAW_LOCK()
    return _RAW_CONDITION(lock)


def install() -> None:
    """Patch the `threading` factories.  Idempotent.  Must run before
    the modules under study construct their locks (conftest arms it
    before importing the modules it should observe)."""
    global _installed
    with _meta:
        if _installed:
            return
        _installed = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory


def uninstall() -> None:
    global _installed
    with _meta:
        if not _installed:
            return
        _installed = False
    threading.Lock = _RAW_LOCK
    threading.RLock = _RAW_RLOCK
    threading.Condition = _RAW_CONDITION


def installed() -> bool:
    return _installed


def reset() -> None:
    with _meta:
        _EDGES.clear()


def edges() -> Dict[Tuple[str, str], str]:
    with _meta:
        return dict(_EDGES)


def verify(static_edges=None, site_to_id=None) -> dict:
    """Check the observed edges for inversions.

    * **dynamic inversion** — both (A,B) and (B,A) were observed in this
      run with A≠B: a textbook order inversion witnessed live.
    * **contradicts static** — the static graph orders A before B
      (edge A→B, no B→A), and this run observed B held while acquiring
      A: exactly the edge the static analysis calls inverted.

    `static_edges` is a set of (lock_id, lock_id); `site_to_id` maps
    construction sites (`path:line`) to the static model's lock ids
    (both from hack.analyze.rules.lock_order.build_model).  Same-site
    pairs are reported under `self_pairs`, never failed.  Returns
    {"inversions": [...], "self_pairs": [...], "edges": n,
    "unmodeled": n}.
    """
    snap = edges()
    inversions: List[dict] = []
    self_pairs: List[dict] = []
    unmodeled = 0
    for (a, b), thread in sorted(snap.items()):
        if a == b:
            self_pairs.append({"site": a, "thread": thread})
            continue
        if (b, a) in snap and a < b:
            inversions.append({
                "kind": "dynamic-inversion", "pair": (a, b),
                "detail": f"observed {a} -> {b} (thread {thread}) AND "
                          f"{b} -> {a} (thread {snap[(b, a)]})"})
    if static_edges is not None and site_to_id is not None:
        for (a, b), thread in sorted(snap.items()):
            ida, idb = site_to_id.get(a), site_to_id.get(b)
            if ida is None or idb is None:
                unmodeled += 1
                continue
            if ida == idb:
                continue
            if (idb, ida) in static_edges and (ida, idb) not in static_edges:
                inversions.append({
                    "kind": "contradicts-static", "pair": (a, b),
                    "detail": f"observed {ida} ({a}) held while acquiring "
                              f"{idb} ({b}) in thread {thread}, but the "
                              f"static graph orders {idb} before {ida}"})
    return {"inversions": inversions, "self_pairs": self_pairs,
            "edges": len(snap), "unmodeled": unmodeled}
