"""Batched cloud API — the provider-side users of the batcher.

Wraps any cloud implementing the FakeCloud API surface and coalesces the
three hot fleet calls behind reference-tuned windows
(pkg/batcher/{createfleet,describeinstances,terminateinstances}.go):

  terminate_instances  many callers' ids merge into ONE underlying call
  describe_instances   identical tag-filter queries share ONE call + result
  create_fleet         requests ride one batch window and fan out together
                       under a bounded worker pool (the reference fans out
                       ≤100 errgroup workers per batch, batcher.go:166-183)

Everything else delegates to the inner cloud unchanged, so this drops into
TPUCloudProvider's ``cloud`` seam transparently.

The port's copy of `karpenter_tpu/providers/batched_cloud.py`.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.utils.batcher import (
    Batcher,
    CREATE_FLEET_WINDOW,
    DESCRIBE_INSTANCES_WINDOW,
    TERMINATE_INSTANCES_WINDOW,
)

_MAX_FANOUT_WORKERS = 100  # reference errgroup cap (batcher.go:95)


class BatchedCloud:
    def __init__(self, cloud, fanout_workers: int = 8):
        self._inner = cloud
        self._pool = ThreadPoolExecutor(
            max_workers=min(fanout_workers, _MAX_FANOUT_WORKERS),
            thread_name_prefix="fleet-fanout")
        idle, mx, items = TERMINATE_INSTANCES_WINDOW
        self.terminate_batcher: Batcher[str, str] = Batcher(
            self._exec_terminate, idle, mx, items, name="terminate_instances")
        idle, mx, items = DESCRIBE_INSTANCES_WINDOW
        self.describe_batcher: Batcher[tuple, List] = Batcher(
            self._exec_describe, idle, mx, items,
            hasher=lambda req: req, name="describe_instances")
        idle, mx, items = CREATE_FLEET_WINDOW
        self.fleet_batcher: Batcher[tuple, tuple] = Batcher(
            self._exec_fleet, idle, mx, items, name="create_fleet")

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- terminate: merge ids into one call ------------------------------
    def terminate_instances(self, instance_ids: List[str]) -> List[str]:
        # enqueue every id before blocking so one caller's list shares a
        # single window (and coalesces with concurrent callers')
        pendings = [self.terminate_batcher.submit(iid)
                    for iid in instance_ids]
        results = [self.terminate_batcher.wait(p) for p in pendings]
        return [iid for iid, ok in zip(instance_ids, results) if ok]

    def _exec_terminate(self, ids: List[str]) -> List[bool]:
        done = set(self._inner.terminate_instances(list(dict.fromkeys(ids))))
        return [iid in done for iid in ids]

    # -- describe: identical filters share one call ----------------------
    def describe_instances(self, tag_filter: Optional[Dict[str, str]] = None,
                           states: Tuple[str, ...] = ("running",)) -> List:
        key = (tuple(sorted((tag_filter or {}).items())), states)
        return self.describe_batcher.add(key)

    def _exec_describe(self, keys: List[tuple]) -> List[List]:
        # same-hash bucket ⇒ all keys identical ⇒ one underlying call
        tag_items, states = keys[0]
        out = self._inner.describe_instances(
            tag_filter=dict(tag_items) or None, states=states)
        return [out] * len(keys)

    # -- create_fleet: shared window, bounded parallel fan-out -----------
    def create_fleet(self, candidates, tags) -> tuple:
        return self.fleet_batcher.add((candidates, tags))

    def _exec_fleet(self, requests: List[tuple]) -> List[tuple]:
        futures = [
            self._pool.submit(self._inner.create_fleet, cands, tags)
            for cands, tags in requests
        ]
        return [f.result() for f in futures]

    def flush(self) -> None:
        for b in (self.terminate_batcher, self.describe_batcher,
                  self.fleet_batcher):
            b.flush()
