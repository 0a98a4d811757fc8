"""Deterministic controller manager.

The reference runs controllers on watch-driven workqueues under a
controller-runtime manager with leader election (cmd/controller/main.go:73).
Our in-process analogue runs each controller's reconcile() in rounds until
the cluster reaches a fixed point — equivalent observable behavior, fully
deterministic for tests (the role envtest + eventually() plays in the
reference's suites).
"""

from __future__ import annotations

from typing import List, Protocol

from karpenter_tpu_torch.cluster import Cluster


class Controller(Protocol):
    name: str

    def reconcile(self) -> None: ...


class ControllerManager:
    def __init__(self, cluster: Cluster, controllers: List[Controller]):
        self.cluster = cluster
        self.controllers = list(controllers)

    def run_once(self) -> None:
        # peer replicas' writes land in the informer cache before any
        # reconciler reads it (no-op on the in-memory backend)
        self.cluster.sync_backend()
        for c in self.controllers:
            c.reconcile()

    def run_until_idle(self, max_rounds: int = 50) -> int:
        """Reconcile all controllers until nothing mutates the cluster.
        Returns the number of rounds taken; raises if no fixed point is
        reached (a reconcile livelock is a bug)."""
        for round_ in range(max_rounds):
            gen = self.cluster.generation
            self.run_once()
            if self.cluster.generation == gen:
                return round_ + 1
        raise RuntimeError(
            f"controllers did not settle in {max_rounds} rounds")
