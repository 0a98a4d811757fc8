"""Timeline event-kind registry.

This module is the ONE place a timeline event kind may be spelled as a
string literal — the same single-owner discipline the reason-code
registry (solver/explain.py) enforces for event reasons.  Everything else
imports the constants (or builds store kinds through `store_event`),
so renaming a kind is a one-file change and `KINDS` is always the
complete catalogue the docs table and `/debug/timeline?kind=` filter
can trust.

Two families:

  * **drive kinds** — replayable inputs.  A recorded or synthetic
    stream of these, applied in order by `timeline/rewind.py`, is
    sufficient to reproduce a cluster trajectory: pod arrivals and
    departures, spot reclaims, price refreshes, fault injections,
    worker crash/restart schedule points, and the gang/priority
    arrival markers the generators stamp for scenario bookkeeping.
  * **store kinds** — observations.  The recorder hook inside
    `Cluster.mutated` captures every informer-cache mutation as
    `store.<kind>.<op>` (e.g. `store.nodeclaims.added`); they document
    what the controllers DID and are skipped by the rewind engine
    (replaying them would double-apply the controllers' own work),
    with one exception: `store.pods.added/deleted` carry enough spec
    to be promoted to `pod.add`/`pod.remove` when replaying a recorded
    (rather than synthetic) stream.

The port's copy of `karpenter_tpu/timeline/events.py`: the same kinds,
spelled the same, so the two packages' streams compare kind for kind.
"""

from __future__ import annotations

from typing import Dict

# --- drive kinds (replayable) -------------------------------------------
POD_ADD = "pod.add"
POD_REMOVE = "pod.remove"
SPOT_RECLAIM = "spot.reclaim"
PRICE_REFRESH = "price.refresh"
FAULT_INJECT = "fault.inject"
WORKER_CRASH = "worker.crash"
WORKER_RESTART = "worker.restart"
GANG_ARRIVAL = "gang.arrival"
PRIORITY_ARRIVAL = "priority.arrival"
CHECKPOINT = "checkpoint"

DRIVE_KINDS: Dict[str, str] = {
    POD_ADD: "a pending pod entered the cluster (data carries the "
             "dense request vector + annotations for replay)",
    POD_REMOVE: "a pod left the cluster (completion or deletion)",
    SPOT_RECLAIM: "the cloud reclaimed a spot instance "
                  "(KubePACS-style interruption)",
    PRICE_REFRESH: "the pricing catalog was refreshed",
    FAULT_INJECT: "a fault-matrix point was armed "
                  "(utils/faults.py)",
    WORKER_CRASH: "schedule point: crash the solve worker "
                  "(replayed as a one-shot solver.dispatch fault)",
    WORKER_RESTART: "schedule point: the crashed worker came back "
                    "(replayed as faults.disarm)",
    GANG_ARRIVAL: "first member of a gang arrived (marker; the "
                  "members themselves are pod.add events)",
    PRIORITY_ARRIVAL: "first pod of a priority band arrived (marker)",
    CHECKPOINT: "state-digest checkpoint marker (seek anchor)",
}

# --- store kinds (observations) -----------------------------------------
STORE_PREFIX = "store."
STORE_KINDS = ("pods", "nodes", "nodeclaims", "nodepools", "nodeclasses")
STORE_OPS = ("added", "modified", "deleting", "deleted")


def store_event(kind: str, op: str) -> str:
    """`store.<kind>.<op>` — the observation kind for one informer-cache
    mutation.  The only sanctioned way to build one outside this module."""
    return STORE_PREFIX + kind + "." + op


KINDS: Dict[str, str] = dict(DRIVE_KINDS)
for _k in STORE_KINDS:
    for _op in STORE_OPS:
        KINDS[store_event(_k, _op)] = (
            f"informer-cache mutation: {_k} {_op} (observation)")


def is_drive(kind: str) -> bool:
    """True for kinds the rewind engine applies as inputs."""
    return kind in DRIVE_KINDS


def is_store(kind: str) -> bool:
    """True for recorded informer-cache observations."""
    return isinstance(kind, str) and kind.startswith(STORE_PREFIX)


def describe(kind: str) -> str:
    return KINDS.get(kind, "(unregistered kind)")
