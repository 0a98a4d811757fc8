"""One process-wide count of first-use events on the solve path.

A solve at a shape the process has not met yet pays set-up work the next
solve at that shape does not: the kernel libraries are built and loaded,
the catalog's tensors are uploaded, the pinned staging slots of the
batched paths are allocated, a kernel meets a launch configuration (its
entry point and shape: on the card the module's first launch and the
per-shape attributes; under a mesh the cluster-occupancy check) for the
first time, and the mesh's mask-row table grows to a new capacity tier.
`TorchSolver.warmup` exists to pay these before the first real solve; the
count is its check, the counterpart of the JAX package's trace counter:
after a warm-up, a solve at a warmed shape must leave `total()` where it
was.

Kinds: "build" (a kernel library compiled, or loaded into the process),
"catalog" (a catalog encoding uploaded), "pinned" (a pinned staging slot
allocated or grown), "launch" (a kernel wrapper or the mesh executor
meeting a new launch configuration), "table" (the mesh's mask-row table
allocated at a new capacity tier).
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable

KINDS = ("build", "catalog", "pinned", "launch", "table")

_lock = threading.Lock()
COUNTS: Dict[str, int] = {k: 0 for k in KINDS}
_seen: set = set()


def note(kind: str, n: int = 1) -> None:
    """Count `n` first-use events of `kind`."""
    if kind not in COUNTS:
        raise ValueError(f"unknown first-use kind {kind!r}")
    with _lock:
        COUNTS[kind] += n


def first(kind: str, key: Hashable) -> bool:
    """Count one event of `kind` the first time this process meets `key`;
    True when it was new."""
    with _lock:
        if (kind, key) in _seen:
            return False
        _seen.add((kind, key))
    note(kind)
    return True


def total() -> int:
    """Every first-use event so far."""
    with _lock:
        return sum(COUNTS.values())


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(COUNTS)
