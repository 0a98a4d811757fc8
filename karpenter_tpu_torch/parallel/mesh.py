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

On a host of S cards (a mesh of cards, `Mesh.devices`) a mesh of S shards
is one launch of K7x (`solver/ffd.py` `card_scan`), one block a card,
every rank enqueued by one call into the kernel library: card r holds
only shard r of the catalog, of the mask-row table and of the seed words,
and its own replica of the problem rows (copied from card 0's upload by
the launch) and of the carry; a sharded array is a tuple whose [r] lives
on card r, and the collectives are exchanges between the cards' kernels
over NVLink.  `resolve_mesh` is the rule that
turns a mesh spec into one of the two forms.

Axis name: "cat", the offering-column (catalog) axis.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, fields
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
    """S shards of the column axis `axis`: on `device` alone (on one card,
    the S blocks of one thread-block cluster), or across `devices`, shard
    r on devices[r] (the cards form: one rank a card).  `device` is the
    first device either way."""
    size: int
    axis: str
    device: torch.device
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if not self.devices:
            object.__setattr__(self, "devices", (self.device,))
        elif len(self.devices) != self.size or \
                self.devices[0] != self.device:
            raise ValueError(f"a mesh of {self.size} shards across "
                             f"{self.devices} (first {self.device})")

    @property
    def cards(self) -> bool:
        """One shard a device (K7x), rather than S blocks on one."""
        return len(self.devices) > 1


def make_mesh(n: int, device="cuda", axis: str = "cat") -> Mesh:
    """A mesh of `n` column shards on `device` alone (K7's cluster on one
    card)."""
    if n < 1 or n > ffd.MAX_SHARDS:
        raise ValueError(f"a mesh of {n} shards: one cluster holds 1 to "
                         f"{ffd.MAX_SHARDS} blocks")
    return Mesh(int(n), axis, torch.device(device))


def card_mesh(devices: Sequence, axis: str = "cat") -> Mesh:
    """A mesh of one shard a device across `devices` (the reference's
    `make_mesh` over the first n devices, `devs[:n]`, mesh.py:63-68)."""
    devs = tuple(torch.device(d) for d in devices)
    if not 2 <= len(devs) <= ffd.MAX_CARDS:
        raise ValueError(f"a mesh of {len(devs)} cards: K7x takes 2 to "
                         f"{ffd.MAX_CARDS}")
    return Mesh(len(devs), axis, devs[0], devs)


def probe_cards() -> Tuple[int, Tuple[Tuple[bool, ...], ...]]:
    """(the CUDA device count, the peer-access matrix: [i][j] true when
    card i can reach card j's memory, true on the diagonal)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return n, tuple(tuple(i == j or torch.cuda.can_device_access_peer(i, j)
                          for j in range(n)) for i in range(n))


def resolve_mesh(spec, count: int, peer, device) -> "Mesh | None":
    """The mesh a solver on `device` takes for `spec` on a host of `count`
    cards whose peer-access matrix is `peer` (`probe_cards`); None is the
    single-device path.  The reference's grammar:

      * None, 0, False, "off", "": the single-device path;
      * a `Mesh`: taken as it is (one of size 1 is the single-device path);
      * "auto": every card when the solver is on the card and the host has
        more than one, as the reference's `mesh="auto"` shards over every
        local device; otherwise the single-device path;
      * an integer n (malformed: 0): n <= 1 the single-device path; on the
        card with 2 <= n <= count the first n cards; otherwise K7's n
        blocks on `device` alone (on the CPU the plain version of K7).

    A mesh of cards must have peer access between every ordered pair of
    its cards: a pair without raises, naming it (there is no path staged
    through the host)."""
    device = torch.device(device)
    if isinstance(spec, Mesh):
        mesh = spec if spec.size > 1 else None
    elif spec in (None, 0, False, "off", ""):
        return None
    else:
        cuda = device.type == "cuda"
        if spec == "auto":
            n = count if cuda else 1
            cards = n > 1
        else:
            try:
                n = int(spec)
            except (TypeError, ValueError):
                n = 0
            cards = cuda and 1 < n <= count
        if n <= 1:
            return None
        mesh = (card_mesh([torch.device("cuda", i) for i in range(n)])
                if cards else make_mesh(n, device))
    if mesh is not None and mesh.cards:
        for a in mesh.devices:
            for b in mesh.devices:
                if (a != b and a.type == "cuda" and b.type == "cuda"
                        and not peer[a.index][b.index]):
                    raise RuntimeError(
                        f"cards {a.index} and {b.index} cannot reach each "
                        f"other (no peer access): the column-sharded solve "
                        f"across cards needs peer access between every "
                        f"pair of its cards")
    return mesh


def _rows(table) -> int:
    """The rows of a mask table: [S, C, W_s], or a tuple of [C, W_s]."""
    return table[0].shape[0] if isinstance(table, tuple) else table.shape[1]


class MeshExecutor:
    """Resident sharded state and dispatch for one solver's mesh: the
    pre-partitioned upload path, the launch configurations (cached by the
    same statics as the reference's `_program`/`_delta_program`: the flat
    layout, and on a card the cluster's fit — across cards each rank's
    block's fit on its card — checked once), and the transfer log that
    makes "no column-axis bytes per steady-state solve" testable.  Across
    cards the process's card exchange over its cards is made with it
    (peer access enabled for every ordered pair).
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.axis = mesh.axis
        if mesh.cards and mesh.device.type == "cuda":
            # the card exchange, made now: peer access on for every pair
            ffd.card_exchange(mesh.devices)
        # (kind, nbytes) per host-to-device commit of a COLUMN-AXIS array:
        # "catalog" (once per catalog identity), "mask-rows" (content
        # deltas and table growth), "delta-seed" (one seed-mask commit per
        # delta suffix solve) and "spec-seed" (one per chunk of the chain).
        # Per-solve problem rows have no column axis and are not logged.
        self.transfers: List[Tuple[str, int]] = []
        # launch configurations by static shape: {"lay": the flat layout,
        # "clusters": how many clusters of S blocks the card holds at once
        # (None off the card and across cards), across cards "blocks":
        # how many rank blocks each card holds at once and "plan": K7x's
        # ffd.CardLaunch for the resident catalog (made at its first
        # launch)}
        self._configs: Dict[tuple, Dict] = {}

    @property
    def clusters(self) -> Dict[tuple, int]:
        """The clusters each launch shape seen so far fits on the card."""
        return {k: c["clusters"] for k, c in self._configs.items()}

    # -- pre-partitioned uploads -----------------------------------------
    def put_sharded(self, shards: Sequence[np.ndarray], kind: str):
        """Commit S host shards as one [S, ...] device tensor, each shard
        copied from its own host slice into its own contiguous [r] (never
        staged as the full array) — across cards as a tuple whose [r] is
        shard r on card r; logs the bytes under `kind`."""
        if len(shards) != self.mesh.size:
            raise ValueError(f"{len(shards)} shards on a mesh of "
                             f"{self.mesh.size}")
        dtype = torch.from_numpy(shards[0][:0]).dtype
        if self.mesh.cards:
            out = tuple(torch.empty(sh.shape, dtype=dtype, device=d)
                        for sh, d in zip(shards, self.mesh.devices))
        else:
            out = torch.empty((len(shards),) + shards[0].shape, dtype=dtype,
                              device=self.mesh.device)
        self.commit(list(out), shards, kind)
        return out

    def commit(self, dsts: Sequence[torch.Tensor],
               shards: Sequence[np.ndarray], kind: str) -> None:
        """Copy each host shard into its device slice `dsts[r]` (pinned,
        asynchronous on a card; across cards each on its own card) and log
        the bytes under `kind`."""
        for dst, sh in zip(dsts, shards):
            cuda = dst.device.type == "cuda"
            host = torch.from_numpy(np.ascontiguousarray(sh))
            dst.copy_(host.pin_memory() if cuda else host, non_blocking=cuda)
        self.transfers.append((kind, int(sum(sh.nbytes for sh in shards))))

    def put_replicated(self, arr: np.ndarray):
        """An array every shard reads whole: on one card one copy, across
        cards a tuple of one copy a card."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self.mesh.cards:
            return tuple(host.to(d) for d in self.mesh.devices)
        return host.to(self.mesh.device)

    def gather_full(self, cat: "ffd.CardCatalog") -> "ffd.FFDCatalog":
        """The full-width catalog on card 0, gathered card to card from the
        shards (the unsharded kernels — K5 and K4, the batched and sweep
        paths under a mesh — read it), once per catalog identity: kept as
        `cat.full` and logged under "catalog".  The pool column bits are
        packed on card 0 from the gathered column pools."""
        if cat.full is not None:
            return cat.full
        dev = self.mesh.device

        def gather(ts):
            return torch.cat([t.to(dev) for t in ts])
        col_pool = gather(cat.col_pool)
        P, O = cat.pool_daemon[0].shape[0], col_pool.shape[0]
        W = (O + 31) // 32
        cols = torch.zeros((P, W * 32), dtype=torch.int64, device=dev)
        cols[:, :O] = (col_pool[None, :] == torch.arange(
            P, dtype=torch.int32, device=dev)[:, None]).to(torch.int64)
        words = (cols.view(P, W, 32) << torch.arange(
            32, dtype=torch.int64, device=dev)).sum(-1)
        pool_bits = (words - (words >= 2 ** 31).to(torch.int64)
                     * 2 ** 32).to(torch.int32)
        full = ffd.FFDCatalog(
            gather(cat.col_alloc), gather(cat.col_daemon),
            gather(cat.pt_alloc), col_pool, cat.pool_daemon[0], pool_bits,
            gather(cat.col_zone), gather(cat.col_ct), zc=cat.zc)
        cat.full = full
        self.transfers.append(("catalog", sum(
            t.numel() * t.element_size() for t in (
                full.col_alloc, full.col_daemon, full.pt_alloc,
                full.col_pool, full.col_zone, full.col_ct))))
        return full

    def rank_args(self, prob, seed=None):
        """The cards form's arguments of one launch, one a rank, for
        kernel-level checks (`shard_problem`; the executor's own launches
        hand card 0's rows to `ffd.card_scan`, whose launch copies them):
        the problem rows on the first card (and the seed's rows) copied
        card to card to every rank, each rank's seed with its own column
        words (`seed.seed_colmask`, a tuple, rank r's on card r).  Returns
        (problems, seeds or None)."""
        if seed is None:
            return [r[0] for r in self._replicas(prob)], None
        reps = self._replicas(prob, ffd.DeltaSeed(
            seed.seed_used, seed.seed_pool, seed.seed_active, None))
        return ([p for p, _ in reps],
                [ffd.DeltaSeed(s.seed_used, s.seed_pool, s.seed_active, w)
                 for (_, s), w in zip(reps, seed.seed_colmask)])

    def _replicas(self, *objs) -> List[tuple]:
        """Each dataclass of tensors in `objs` on every card: [(objs on
        card 0), (on card 1), ...], card 0 the objects themselves.
        Tensors that share a storage (one upload buffer) travel as one
        card-to-card copy of it."""
        out = [objs]
        for d in self.mesh.devices[1:]:
            copies = {}

            def move(t):
                if t is None or t.device == d:
                    return t
                st = t.untyped_storage()
                key = st.data_ptr()
                if key not in copies:
                    copies[key] = torch.empty(
                        0, dtype=torch.uint8, device=t.device).set_(st).to(
                            d, non_blocking=True).untyped_storage()
                return torch.empty(0, dtype=t.dtype, device=d).set_(
                    copies[key], t.storage_offset(), t.size(), t.stride())
            out.append(tuple(
                None if o is None else type(o)(**{
                    f.name: move(getattr(o, f.name)) for f in fields(o)})
                for o in objs))
        return out

    # -- dispatch -----------------------------------------------------------
    def _config(self, key: tuple, prob, table, cat, N: int, explain: int,
                with_gang: int, with_priority: int, seed) -> Dict:
        """The launch configuration of one static shape, built once: its
        flat layout, and on a card the check that one cluster of S blocks
        fits (cudaOccupancyMaxActiveClusters) — across cards that rank r's
        block fits card r (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
        a shape that does not raises, and is never run some other way."""
        cfg = self._configs.get(key)
        if cfg is None:
            firstuse.note("launch")
            lay = ffd.flat_layout(prob.G, prob.E, N, prob.D, explain,
                                  with_priority=with_priority)
            cfg = {"lay": lay, "clusters": None}
            if self.mesh.device.type == "cuda" and self.mesh.cards:
                blocks = ffd.card_blocks(prob, table, cat, N, lay, with_gang,
                                         seed)
                if min(blocks) < 1:
                    raise RuntimeError(
                        f"a rank's block does not fit its card for this "
                        f"launch (blocks each card holds {blocks}): the "
                        f"mesh cannot run at this size")
                cfg["blocks"] = blocks
            elif self.mesh.device.type == "cuda":
                n = ffd.sharded_clusters(prob, table, cat, N, lay,
                                         with_gang, seed)
                if n < 1:
                    raise RuntimeError(
                        f"a cluster of {self.mesh.size} blocks does not fit "
                        f"the card for this launch (max active clusters "
                        f"{n}): the mesh cannot run at this size")
                cfg["clusters"] = n
            self._configs[key] = cfg
        return cfg

    def _launch(self, cfg: Dict, prob, table, cat, max_nodes: int,
                with_gang: int = 0, seed=None) -> torch.Tensor:
        """One launch: K7's cluster, or across cards K7x's S ranks
        (`ffd.card_scan` through the configuration's `ffd.CardLaunch`, one
        call into the kernel library: card 0's rows copied to every rank,
        every rank enqueued before anything waits, tied by CUDA events —
        card 0's stream waits on every card's completion, each launch
        after the last one on every card).  Returns rank 0's flat row on
        the first device."""
        flat = torch.empty(cfg["lay"]["total"][1], dtype=torch.float32,
                           device=self.mesh.device)
        limits = torch.empty((prob.P, ffd.R), dtype=torch.float32,
                             device=self.mesh.device)
        if not self.mesh.cards:
            ffd.sharded_scan(prob, table, cat, max_nodes, flat, cfg["lay"],
                             limits, with_gang, seed)
            return flat
        plan = cfg.get("plan")
        if plan is not None and plan.cat is not cat:
            plan = None  # another resident catalog: its scratch goes too
        cfg["plan"] = ffd.card_scan(prob, table, cat, max_nodes, flat,
                                    cfg["lay"], limits, with_gang, seed,
                                    plan=plan)
        return flat

    def solve(self, prob, table, cat, max_nodes: int, explain: int = 0,
              with_gang: int = 0, with_priority: int = 0) -> torch.Tensor:
        """One resident-path solve: `prob` the replicated problem rows on
        the first device (its mask_bits the [G] table rows; across cards
        the launch copies them to every rank), `table` the mask-table
        snapshot `MaskRowRegistry.ensure` returned with them, `cat` the
        resident ShardedCatalog (CardCatalog).  Returns the flat result
        row (not synchronised)."""
        key = ("solve", prob.G, prob.E, prob.D, prob.P, _rows(table),
               max_nodes, explain, with_gang, with_priority)
        cfg = self._config(key, prob, table, cat, max_nodes, explain,
                           with_gang, with_priority, None)
        return self._launch(cfg, prob, table, cat, max_nodes, with_gang)

    def solve_delta(self, prob, seed, table, cat, max_nodes: int,
                    explain: int = 0) -> torch.Tensor:
        """One seeded solve (the delta suffix, or one chunk of the chain):
        the seed's column words arrive per shard (the caller committed them
        through `put_sharded`, logged; across cards a tuple, rank r's on
        card r, and the seed's rows travel with the problem rows);
        everything else with a column axis is resident."""
        key = ("delta", prob.G, prob.E, prob.D, prob.P, _rows(table),
               max_nodes, explain, seed.A)
        cfg = self._config(key, prob, table, cat, max_nodes, explain, 0, 0,
                           seed)
        return self._launch(cfg, prob, table, cat, max_nodes, seed=seed)


def _table_update(ex: MeshExecutor, table, rows: np.ndarray, start: int):
    """Write the uploaded mask rows `rows` [k, O] bool at row `start` of
    the resident table [S, C, W_s] (across cards each card's [C, W_s]) —
    the reference's `dynamic_update_slice` of new rows (mesh.py:303), no
    arithmetic: one pinned host-to-device copy into each shard's slice, on
    that shard's card, logged as "mask-rows"."""
    shards = ffd.shard_words(rows, ex.mesh.size)
    ex.commit([table[r][start:start + len(rows)] for r in range(len(shards))],
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
    columns — across cards a tuple of S [C, W_s] tables, one on each card.
    """

    def __init__(self, ex: MeshExecutor, O: int):
        self.ex = ex
        self.O = O
        # ensure() returns the table snapshot its row ids are valid
        # against; every registry mutation happens under this lock
        self._lock = threading.Lock()
        self._ids: Dict[bytes, int] = {}
        self._host = np.zeros((MASK_ROW_BUCKETS[0], O), dtype=bool)
        self.table = None     # device [S, C_pad, W_s] int32 (or per card)
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
            have = _rows(self.table) if self.table is not None else 0
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
            have = _rows(self.table) if self.table is not None else 0
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
                 _rows(self.table) - start)
        rows = np.zeros((kb, self.O), dtype=bool)
        rows[:n_new] = self._host[start:start + n_new]
        self.table = _table_update(self.ex, self.table, rows, start)


def shard_problem(prob: tuple, cat_arrays: Dict, S, device=None,
                  seed: tuple = None):
    """A problem tuple and its padded catalog arrays (numpy, as
    `ffd.problem_from_numpy` takes them) on a fresh mesh of S shards on
    `device` (or on `S` itself, a Mesh: the cards form when it spans
    several devices), for kernel-level checks: (the problem tensors —
    mask_bits its [G] rows of the mask table —, the table, the
    ShardedCatalog, the executor); with `seed` = (used [N, R], pool [N],
    active [N], colmask [A, O] bool) also the DeltaSeed, its column words
    committed per shard.  In the cards form the problem and the seed are
    lists, one a rank on its card, the table a tuple and the catalog a
    CardCatalog."""
    mesh = S if isinstance(S, Mesh) else make_mesh(S, device)
    S, dev = mesh.size, mesh.device
    ex = MeshExecutor(mesh)
    cat = ffd.sharded_catalog_tensors(cat_arrays, S, ex)
    reg = MaskRowRegistry(ex, cat.O)
    rows, table = reg.ensure(np.asarray(prob[2], bool))
    prob = tuple(prob[:2]) + (rows,) + tuple(prob[3:])
    if seed is None:
        p = ffd.problem_tensors(prob, cat.O, dev)
        if mesh.cards:
            p, _ = ex.rank_args(p)
        return p, table, cat, ex
    used, pool, active, colmask = seed
    p, sd = ffd.delta_tensors(prob, used, pool, active, None, cat.O, dev)
    sd.seed_colmask = ex.put_sharded(ffd.shard_words(colmask, S),
                                     "delta-seed")
    if mesh.cards:
        p, sd = ex.rank_args(p, sd)
    return p, sd, table, cat, ex
