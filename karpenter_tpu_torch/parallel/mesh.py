"""The mesh: the column-sharded solve's resident state and dispatch.

The port of `karpenter_tpu/parallel/mesh.py`.  The reference splits the
offering-column axis O (and the (pool,type) axis PT in lockstep, on whole
blocks) over the devices of a `jax.sharding.Mesh`, runs the FFD scan under
`shard_map` with the group-scan state replicated, and keeps what has a
column axis resident per device: the catalog, uploaded once per catalog
identity as pre-partitioned shards, and a content-addressed table of
group-mask rows.  A steady-state solve ships only its replicated problem
rows.  `MeshExecutor.transfers` logs every host-to-device commit of
column-axis bytes, so the residency contract can be asserted.

On one card a mesh of S shards is one launch of K7 (`solver/ffd.py`
`sharded_scan`): S thread blocks in one thread-block cluster, block r
reading only shard r of every column-axis array; the reference's
collectives (max, shard 0's leading block, an integer sum) are exchanges
through distributed shared memory.  A sharded array is one device tensor
[S, ...] whose [r] is shard r, contiguous, filled from its own host slice.

Axis name: "cat", the offering-column (catalog) axis.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver import ffd, firstuse

# mask-row table capacity tiers (rows); past the last tier the registry
# cycles (steady-state clusters hold a bounded set of pod classes)
MASK_ROW_BUCKETS = (64, 256, 1024, 4096)
# delta-upload padding tiers (new rows per flush)
MASK_UPLOAD_BUCKETS = (1, 8, 64)


def _bucket(n: int, tiers) -> int:
    for t in tiers:
        if n <= t:
            return t
    # beyond the last tier, power-of-two growth rather than a hard cap
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class Mesh:
    """S shards of the column axis `axis` on `device` (on one card, the S
    blocks of one thread-block cluster)."""
    size: int
    axis: str
    device: torch.device


def make_mesh(n: int, device="cuda", axis: str = "cat") -> Mesh:
    """A mesh of `n` column shards on `device` (the reference's
    `make_mesh`, which takes the first `n` devices)."""
    if n < 1 or n > ffd.MAX_SHARDS:
        raise ValueError(f"a mesh of {n} shards: one cluster holds 1 to "
                         f"{ffd.MAX_SHARDS} blocks")
    return Mesh(int(n), axis, torch.device(device))


class MeshExecutor:
    """Resident sharded state and dispatch for one solver's mesh: the
    pre-partitioned upload path, the launch configurations (cached by the
    same statics as the reference's `_program`/`_delta_program`: the flat
    layout, and on a card the cluster's fit checked once), and the transfer
    log that makes "no column-axis bytes per steady-state solve" testable.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.axis = mesh.axis
        # (kind, nbytes) per host-to-device commit of a COLUMN-AXIS array:
        # "catalog" (once per catalog identity), "mask-rows" (content
        # deltas and table growth), "delta-seed" (one seed-mask commit per
        # delta suffix solve) and "spec-seed" (one per chunk of the chain).
        # Per-solve problem rows have no column axis and are not logged.
        self.transfers: List[Tuple[str, int]] = []
        # launch configurations by static shape: {"lay": the flat layout,
        # "clusters": how many clusters of S blocks the card holds at once
        # (None off the card)}
        self._configs: Dict[tuple, Dict] = {}

    @property
    def clusters(self) -> Dict[tuple, int]:
        """The clusters each launch shape seen so far fits on the card."""
        return {k: c["clusters"] for k, c in self._configs.items()}

    # -- pre-partitioned uploads -----------------------------------------
    def put_sharded(self, shards: Sequence[np.ndarray],
                    kind: str) -> torch.Tensor:
        """Commit S host shards as one [S, ...] device tensor, each shard
        copied from its own host slice into its own contiguous [r] (never
        staged as the full array); logs the bytes under `kind`."""
        if len(shards) != self.mesh.size:
            raise ValueError(f"{len(shards)} shards on a mesh of "
                             f"{self.mesh.size}")
        out = torch.empty((len(shards),) + shards[0].shape,
                          dtype=torch.from_numpy(shards[0][:0]).dtype,
                          device=self.mesh.device)
        self.commit(list(out), shards, kind)
        return out

    def commit(self, dsts: Sequence[torch.Tensor],
               shards: Sequence[np.ndarray], kind: str) -> None:
        """Copy each host shard into its device slice `dsts[r]` (pinned,
        asynchronous on a card) and log the bytes under `kind`."""
        cuda = self.mesh.device.type == "cuda"
        for dst, sh in zip(dsts, shards):
            host = torch.from_numpy(np.ascontiguousarray(sh))
            dst.copy_(host.pin_memory() if cuda else host, non_blocking=cuda)
        self.transfers.append((kind, int(sum(sh.nbytes for sh in shards))))

    def put_replicated(self, arr: np.ndarray) -> torch.Tensor:
        """An array every shard reads whole (on one card, one copy)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.mesh.device)

    # -- dispatch -----------------------------------------------------------
    def _config(self, key: tuple, prob, table, cat, N: int, explain: int,
                with_gang: int, with_priority: int, seed) -> Dict:
        """The launch configuration of one static shape, built once: its
        flat layout, and on a card the check that one cluster of S blocks
        fits (cudaOccupancyMaxActiveClusters); a shape that does not
        raises, and is never run some other way."""
        cfg = self._configs.get(key)
        if cfg is None:
            firstuse.note("launch")
            lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, explain,
                                  with_priority=with_priority)
            n = None
            if self.mesh.device.type == "cuda":
                n = ffd.sharded_clusters(prob, table, cat, N, lay,
                                         with_gang, seed)
                if n < 1:
                    raise RuntimeError(
                        f"a cluster of {self.mesh.size} blocks does not fit "
                        f"the card for this launch (max active clusters "
                        f"{n}): the mesh cannot run at this size")
            cfg = self._configs[key] = {"lay": lay, "clusters": n}
        return cfg

    def _launch(self, cfg: Dict, prob, table, cat, max_nodes: int,
                with_gang: int = 0, seed=None) -> torch.Tensor:
        flat = torch.empty(cfg["lay"]["total"][1], dtype=torch.float32,
                           device=self.mesh.device)
        limits = torch.empty((prob.P, ffd.R), dtype=torch.float32,
                             device=self.mesh.device)
        ffd.sharded_scan(prob, table, cat, max_nodes, flat, cfg["lay"],
                         limits, with_gang, seed)
        return flat

    def solve(self, prob, table, cat, max_nodes: int, explain: int = 0,
              with_gang: int = 0, with_priority: int = 0) -> torch.Tensor:
        """One resident-path solve: `prob` the replicated problem rows (its
        mask_bits the [G] table rows), `table` the mask-table snapshot
        `MaskRowRegistry.ensure` returned with them, `cat` the resident
        ShardedCatalog.  Returns the flat result row (not synchronised)."""
        key = ("solve", prob.G, prob.E, prob.D, prob.P, table.shape[1],
               max_nodes, explain, with_gang, with_priority)
        cfg = self._config(key, prob, table, cat, max_nodes, explain,
                           with_gang, with_priority, None)
        return self._launch(cfg, prob, table, cat, max_nodes, with_gang)

    def solve_delta(self, prob, seed, table, cat, max_nodes: int,
                    explain: int = 0) -> torch.Tensor:
        """One seeded solve (the delta suffix, or one chunk of the chain):
        the seed's column words arrive per shard (the caller committed them
        through `put_sharded`, logged); everything else with a column axis
        is resident."""
        key = ("delta", prob.G, prob.E, prob.D, prob.P, table.shape[1],
               max_nodes, explain, seed.A)
        cfg = self._config(key, prob, table, cat, max_nodes, explain, 0, 0,
                           seed)
        return self._launch(cfg, prob, table, cat, max_nodes, seed=seed)


def _table_update(ex: MeshExecutor, table: torch.Tensor, rows: np.ndarray,
                  start: int) -> torch.Tensor:
    """Write the uploaded mask rows `rows` [k, O] bool at row `start` of
    the resident table [S, C, W_s] — the reference's `dynamic_update_slice`
    of new rows (mesh.py:303), no arithmetic: one pinned host-to-device
    copy into each shard's slice, logged as "mask-rows"."""
    shards = ffd.shard_words(rows, ex.mesh.size)
    ex.commit([table[r, start:start + len(rows)] for r in range(len(shards))],
              shards, "mask-rows")
    return table


class MaskRowRegistry:
    """Content-addressed device residency for [*, O] group-mask rows.

    Rows are keyed by their packed bytes (group masks are not a pure
    function of the pod class: whole-node groups fold the count in, price
    caps AND in per solve), so the device row IS the host row.  Repeat
    solves re-hit their rows and upload nothing; unseen rows travel once as
    a padded delta.  Row 0 is the all-false mask, which padded group slots
    index.  The table is [S, C, W_s] words, each shard packing its own
    columns.
    """

    def __init__(self, ex: MeshExecutor, O: int):
        self.ex = ex
        self.O = O
        # ensure() returns the table snapshot its row ids are valid
        # against; every registry mutation happens under this lock
        self._lock = threading.Lock()
        self._ids: Dict[bytes, int] = {}
        self._host = np.zeros((MASK_ROW_BUCKETS[0], O), dtype=bool)
        self.table = None     # device [S, C_pad, W_s] int32
        self.resets = 0       # capacity cycles
        zero = np.zeros((1, O), dtype=bool)
        self._register(zero, [np.packbits(zero[0]).tobytes()])
        self._flush()

    @property
    def n_rows(self) -> int:
        return len(self._ids)

    def _register(self, rows: np.ndarray, keys) -> np.ndarray:
        """Row ids for `rows` ([g] i32), new rows into the host shadow
        (`_flush` ships them)."""
        idx = np.empty(len(rows), dtype=np.int32)
        for i, key in enumerate(keys):
            row = self._ids.get(key)
            if row is None:
                row = len(self._ids)
                if row >= self._host.shape[0]:
                    grown = np.zeros(
                        (_bucket(row + 1, MASK_ROW_BUCKETS), self.O),
                        dtype=bool)
                    grown[:row] = self._host[:row]
                    self._host = grown
                self._ids[key] = row
                self._host[row] = rows[i]
            idx[i] = row
        return idx

    def ensure(self, rows: np.ndarray):
        """(row ids [g] i32 for `rows` [g, O] bool, the device table those
        ids index): callers dispatch with the RETURNED table."""
        packed = np.packbits(rows, axis=-1)
        keys = [packed[i].tobytes() for i in range(len(rows))]
        with self._lock:
            # DISTINCT unseen rows (padded group slots repeat row 0)
            n_unseen = len(set(keys) - self._ids.keys())
            have = self.table.shape[1] if self.table is not None else 0
            # cycle only when growth would cross both the last tier and the
            # live capacity, and only with something unseen
            if (n_unseen
                    and len(self._ids) + n_unseen
                    > max(MASK_ROW_BUCKETS[-1], have)
                    and n_unseen <= MASK_ROW_BUCKETS[-1]):
                self.resets += 1
                self._ids = {}
                self._host = np.zeros((MASK_ROW_BUCKETS[0], self.O), bool)
                self.table = None
                zero = np.zeros((1, self.O), dtype=bool)
                self._register(zero, [np.packbits(zero[0]).tobytes()])
            have = self.table.shape[1] if self.table is not None else 0
            filled = len(self._ids)
            idx = self._register(rows, keys)
            if len(self._ids) == filled and self.table is not None:
                return idx, self.table  # a pure cache hit: nothing uploads
            if len(self._ids) > have or self.table is None:
                self._realloc()
            else:
                self._flush(start=filled)
            return idx, self.table

    def _realloc(self):
        """(Re)allocate the device table at the current capacity tier and
        ship every registered row, shard by shard."""
        cap = _bucket(len(self._ids), MASK_ROW_BUCKETS)
        firstuse.note("table")
        full = np.zeros((cap, self.O), dtype=bool)
        full[:len(self._ids)] = self._host[:len(self._ids)]
        self.table = self.ex.put_sharded(
            ffd.shard_words(full, self.ex.mesh.size), kind="mask-rows")

    def _flush(self, start: int = 0):
        """Ship rows [start:] — the content delta — into the resident
        table, padded to an upload tier, the pad clamped to the table's
        remaining capacity."""
        n_new = len(self._ids) - start
        if self.table is None:
            self._realloc()
            return
        if n_new <= 0:
            return
        kb = min(_bucket(n_new, MASK_UPLOAD_BUCKETS),
                 self.table.shape[1] - start)
        rows = np.zeros((kb, self.O), dtype=bool)
        rows[:n_new] = self._host[start:start + n_new]
        self.table = _table_update(self.ex, self.table, rows, start)


def shard_problem(prob: tuple, cat_arrays: Dict, S: int, device,
                  seed: tuple = None):
    """A problem tuple and its padded catalog arrays (numpy, as
    `ffd.problem_from_numpy` takes them) on a fresh mesh of S shards, for
    kernel-level checks: (the problem tensors — mask_bits its [G] rows of
    the mask table —, the table, the ShardedCatalog, the executor); with
    `seed` = (used [N, R], pool [N], active [N], colmask [A, O] bool) also
    the DeltaSeed, its column words committed per shard."""
    ex = MeshExecutor(make_mesh(S, device))
    cat = ffd.sharded_catalog_tensors(cat_arrays, S, ex)
    reg = MaskRowRegistry(ex, cat.O)
    rows, table = reg.ensure(np.asarray(prob[2], bool))
    prob = tuple(prob[:2]) + (rows,) + tuple(prob[3:])
    if seed is None:
        return ffd.problem_tensors(prob, cat.O, device), table, cat, ex
    used, pool, active, colmask = seed
    p, sd = ffd.delta_tensors(prob, used, pool, active, None, cat.O, device)
    sd.seed_colmask = ex.put_sharded(ffd.shard_words(colmask, S),
                                     "delta-seed")
    return p, sd, table, cat, ex
