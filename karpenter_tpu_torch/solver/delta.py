"""Incremental delta solves: O(churn) steady-state passes.

Production traffic is a warm cluster where a few hundred pods churn per
reconcile loop, not 50k cold pods a pass, yet the full path re-encodes
and re-solves the whole snapshot every time.  This module holds the
solver-side half of the delta machinery (a copy of the JAX package's
`solver/delta.py`, whose host replays it keeps op for op):

  * ``SolveCache`` — a bounded per-catalog-identity store of the previous
    solve (``DeltaRecord``: the ``EncodedProblem``, the kernel's decoded
    output rows, group identity keys, and per-node fingerprints), plus
    the event-driven dirty sets a watch feed delivers through
    ``TorchSolver.delta_invalidate``.
  * ``plan()`` — diff the new pass against the record: the longest
    common PREFIX of the FFD group order is bit-reusable (the kernel is
    a deterministic sequential scan, so a group's fill depends only on
    the fills before it), everything after is the restricted SUFFIX.
  * ``build()`` — encode only the suffix (unchanged suffix groups reuse
    their cached rows; truly new/changed groups re-encode) and REPLAY
    the prefix's state host-side: consumed exist_remaining, per-node
    used vectors, and surviving-column masks, mirroring the kernel's
    float32 arithmetic op-for-op (the `_np_fit_count` discipline) so the
    seeded scan is bit-identical to the full solve's suffix steps.
  * ``merge()`` — stitch the cached prefix rows and the seeded suffix
    output back into one (enc, out) pair; the ordinary ``_decode`` then
    produces a result exactly equal to the full re-solve's.

Exactness is the contract: any condition that could break it — topology
constraints, resident required anti-affinity, finite pool limits, price
caps, node churn, catalog change, a suffix that crosses the padding
bucket of the full problem — is a conservative FALLBACK to the full
solve, counted by the solver with a reason of
``explain.DELTA_FALLBACK_REASONS``, so no fallback is ever silent.

The kernel-side half (the seeded scan, K6) lives in solver/ffd.py
(`delta_scan`, `solve_ffd_delta`); the dispatch plumbing in
solver/solve.py (`_try_delta`).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.resources import RESOURCE_AXIS
from karpenter_tpu_torch.scheduling.types import (
    effective_request,
    gang_of,
    priority_of,
)
from karpenter_tpu_torch.solver.explain import EPS
from karpenter_tpu_torch.solver.encode import (
    BIG,
    EncodedProblem,
    _has_required_anti,
    _label_matrix,
    _np_fit_count,
    _Vocab,
    bucket,
    exist_group_ok,
    group_column_mask,
)

R = len(RESOURCE_AXIS)

# below this many groups the full solve is already sub-millisecond on a
# warm device and a delta pass would only add its host replay;
# "auto" mode disengages, "on" forces (unit tests, tiny deployments)
DELTA_MIN_GROUPS = 24
# padding tiers for the seeded node-slot axis (the [A_pad, O] seed
# column-mask upload is padded like every other axis)
SEED_BUCKETS = (16, 64, 256, 1024, 2048, 4096)
# dirty-set flood bound: past this the per-name bookkeeping costs more
# than the fallback it prevents — collapse to "everything dirty"
_DIRTY_CAP = 50_000


@dataclass
class _NodeFP:
    """Value snapshot of one ExistingNode at record time.  Compared by
    VALUE on the next pass (never by object identity — the controller
    rebuilds wrappers per pass, and a remote caller unpickles fresh
    objects per request), so in-place label/taint/readiness mutations
    and remote round-trips are both handled."""
    name: str
    labels: dict
    taints: list
    ready: bool
    deleting: bool
    avail: np.ndarray           # [R] f32 — must match bit-for-bit
    res_anti: bool              # any resident pod carries required anti
    # the Node object's own allocatable (event-time comparable): the
    # incremental index (solver/incr.py) absorbs a node watch event as
    # spurious iff labels/taints/readiness/deleting/allocatable all
    # match — available capacity moves via resident pod events, which
    # the index tracks separately, so it is NOT part of this check
    alloc: Optional[np.ndarray] = None


@dataclass
class DeltaRecord:
    """One cached solve: everything the next pass needs to reuse the
    unchanged prefix and seed the suffix."""
    cat: object                 # CatalogEncoding (strong ref: keys stay valid)
    enc: EncodedProblem
    groups: List[list]          # enc.groups (FFD order)
    gkeys: List[Tuple[int, tuple]]   # per group: (gid, member-name tuple)
    out_te: np.ndarray          # [G, E] f32 take_exist (dense, unpadded)
    out_tn: np.ndarray          # [G, NA] f32 take_new (dense, unpadded)
    node_pool: np.ndarray       # [NA] i32
    num_active: int
    node_fps: List[_NodeFP]
    res_anti_any: bool
    # placement-provenance prefix attribution: the solve's
    # kernel aux counts rows ([G, EXPLAIN_C], KERNEL_CONSTRAINTS order)
    # — a delta pass reuses the prefix rows and stitches the suffix's
    # fresh aux after them, exactly like the take rows.  None when the
    # record was built with explain off.
    explain_counts: Optional[np.ndarray] = None
    # lazy caches, carried forward across delta passes while the catalog
    # and node set hold: the per-call existing-node label matrices and
    # the per-class opener feasibility rows
    exist_tables: Optional[tuple] = None
    feas_cache: Dict[int, np.ndarray] = field(default_factory=dict)
    # lazy member-name → group-row index: maps a
    # dirty pod name to the ONE record row it can invalidate, so plan()
    # resolves a small dirty set in O(churn) dict probes instead of the
    # O(cluster × members) per-name scans the prefix walk used to pay
    name_rows: Optional[Dict[str, int]] = None
    # adjacency-gang node pins: the kernel's winning domain
    # per new node ([NA] i32, -1 = unpinned), recorded so build() can
    # replay a prefix gang's domain-narrowed colmask and merge() can
    # stitch the pins back into the output — without them the seeded
    # merge rebuilt node_zone/ct as -1 and every adjacency gang was a
    # counted "gang" fallback forever
    node_zone: Optional[np.ndarray] = None
    node_ct: Optional[np.ndarray] = None
    # whether any resident pod carried an in-flight eviction plan at
    # record time: lets an index-resolved plan() answer the preempt
    # check without the per-pass O(residents) annotation scan (node
    # events — including resident pod changes — retire the index first)
    preempt_any: bool = False

    @property
    def n_groups(self) -> int:
        return len(self.groups)


@dataclass
class DeltaPlan:
    record: DeltaRecord
    m: int                      # common-prefix length (FFD order)
    new_prefix: List[list]      # groups[:m] of the NEW pass (live pods)
    suffix: List[list]          # groups[m:] of the NEW pass
    reuse: List[Optional[int]]  # per suffix group: prior row index or None


class SolveCache:
    """Bounded per-(catalog-identity) store of DeltaRecords plus the
    dirty sets fed by cluster events.  One per TorchSolver; a watch
    feed drains events into ``invalidate`` via
    ``TorchSolver.delta_invalidate``.
    """

    def __init__(self, capacity: int = 4):
        import threading
        self.capacity = capacity
        # the provisioner and the disruption simulator share one
        # solver, so solves — and the watch
        # feed's invalidations — can race; all structural mutation
        # happens under this lock.  Records themselves are effectively
        # immutable once published (the lazy tables are idempotent).
        self._lock = threading.Lock()
        self._records: "OrderedDict[int, DeltaRecord]" = OrderedDict()
        self.dirty_pods: set = set()
        self.dirty_nodes: set = set()
        self.all_dirty = False   # dirty-set flood: force one fallback
        # invalidation generation: bumped on every invalidate() so a
        # store can tell whether NEW dirt arrived after the snapshot
        # its solve consumed (put must never discard such dirt)
        self._gen = 0
        # observability for tests/debug: the last pass's verdict
        self.last_outcome: Optional[str] = None
        self.last_reason: Optional[str] = None
        # the last delta pass's dirty-set size, suffix re-encode count,
        # and group-reuse fraction — set by _try_delta
        self.last_dirty: Optional[int] = None
        self.last_reencoded: Optional[int] = None
        self.last_reuse: Optional[float] = None
        # event-driven incremental index (solver/incr.py):
        # built lazily at put() time once the solver engages INCR mode
        # (incr_enabled), maintained at invalidate() time from resolved
        # objects, retired whole whenever a generation check fails
        self.incr = None
        self.incr_enabled = False
        self.last_incr_reason: Optional[str] = None

    def get(self, cat) -> Optional[DeltaRecord]:
        with self._lock:
            rec = self._records.get(id(cat))
            if rec is not None:
                self._records.move_to_end(id(cat))
            return rec

    def get_any(self) -> Optional[DeltaRecord]:
        """Most-recently stored record regardless of catalog identity —
        introspection/tests only (the solve path always keys by cat)."""
        with self._lock:
            for rec in reversed(self._records.values()):
                return rec
            return None

    def put(self, cat, rec: DeltaRecord, consumed=None,
            incr_carry: bool = False) -> None:
        """Publish a fresh record.  `consumed` is the dirty SNAPSHOT the
        solve that built it observed (dirty_snapshot()): only that dirt
        is retired — invalidations that arrived mid-solve (another
        thread's feed) stay dirty, or the next pass could engage
        against state an event flagged and values can't disprove.
        consumed=None retires nothing (pure conservatism: stale dirt
        costs one counted fallback, whose full solve then retires it).

        The incremental index follows the same generation discipline,
        but retirement is all-or-nothing: it only (re)builds when NO
        invalidation raced the solve (`gen == self._gen`) — a partial
        carry could mis-map a racing event's name to the wrong row,
        and unlike the name sets there is no value-check backstop.  A
        raced index drops whole; the next pass is a counted "cold"/
        "drift" whose walk rebuilds it.  `incr_carry=True` marks a
        record produced FROM the index's own view (an index-resolved
        delta pass), allowing the O(churn) structural advance instead
        of the O(cluster) rebuild."""
        with self._lock:
            # identity-keyed LRU looked up by `is`-the-same-catalog,
            # never iterated into outputs: eviction order is insertion
            # order, so address values cannot leak into any solve
            self._records[id(cat)] = rec
            self._records.move_to_end(id(cat))
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)
            raced = True
            if consumed is not None:
                pods, nodes, flood, gen = consumed
                self.dirty_pods -= pods
                self.dirty_nodes -= nodes
                raced = gen != self._gen
                if flood and not raced:
                    # no invalidation landed since the snapshot: the
                    # flood the solve observed is fully absorbed
                    self.all_dirty = False
            if self.incr_enabled:
                if raced:
                    self.incr = None
                elif (incr_carry and self.incr is not None
                        and self.incr.advance(rec)):
                    pass
                else:
                    from karpenter_tpu_torch.solver import incr as incrmod
                    self.incr = incrmod.index_from_record(rec)

    def invalidate(self, pods=(), nodes=(), flood: bool = False,
                   pod_objs=None, node_objs=None, claims=()) -> None:
        """Accumulate event dirt.  `pods`/`nodes` are the classic name
        sets the walk-based plan consumes.  `pod_objs`/`node_objs`
        (name → resolved store object or None) and `claims` (nodeclaim
        names) additionally feed the incremental index; a names-only
        call marks the index stale (counted "pods" on its next use) —
        the walk path never needed objects and keeps working as-is."""
        with self._lock:
            self._gen += 1
            self.dirty_pods.update(pods)
            self.dirty_nodes.update(nodes)
            if flood or (len(self.dirty_pods) > _DIRTY_CAP
                         or len(self.dirty_nodes) > _DIRTY_CAP):
                self.all_dirty = True
                self.dirty_pods.clear()
                self.dirty_nodes.clear()
            idx = self.incr
            if idx is None:
                return
            if flood or self.all_dirty:
                idx.note_flood()
                return
            if pod_objs is not None:
                for name in pod_objs:
                    idx.apply_pod(name, pod_objs[name])
                if any(n not in pod_objs for n in pods):
                    idx.note_names_only()
            elif pods:
                idx.note_names_only()
            if node_objs is not None:
                for name in node_objs:
                    idx.apply_node(name, node_objs[name])
                if any(n not in node_objs and n not in claims
                       for n in nodes):
                    idx.nodes_dirty = True
            elif nodes:
                # names-only node dirt: conservative, same verdict the
                # walk's fingerprint sweep would reach for a real event
                idx.nodes_dirty = True
            for name in claims:
                idx.apply_claim(name)

    def dirty_snapshot(self):
        """(dirty_pods, dirty_nodes, all_dirty, gen) as one consistent
        view — plan() must not watch the sets mutate mid-diff, and
        put() retires exactly this view."""
        with self._lock:
            return (frozenset(self.dirty_pods),
                    frozenset(self.dirty_nodes), self.all_dirty,
                    self._gen)

    def incr_snapshot(self):
        """(index snapshot | None, classic dirty snapshot) taken under
        ONE lock acquisition: the index-resolved pass must consume the
        same generation the index view reflects, or put() could retire
        dirt the group build never saw."""
        with self._lock:
            classic = (frozenset(self.dirty_pods),
                       frozenset(self.dirty_nodes), self.all_dirty,
                       self._gen)
            idx = self.incr
            snap = idx.snapshot() if idx is not None else None
            dirty_count = idx.dirty_count() if idx is not None else 0
            return snap, classic, dirty_count

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dirty_pods.clear()
            self.dirty_nodes.clear()
            self.all_dirty = False
            self.incr = None


def _fingerprint(en) -> _NodeFP:
    node = en.node
    return _NodeFP(
        name=en.name,
        labels=dict(node.labels),
        taints=list(node.taints),
        ready=node.ready,
        deleting=node.meta.deleting,
        avail=np.array(en.available.v, dtype=np.float32),
        res_anti=_has_required_anti(en.pods),
        alloc=np.array(node.allocatable.v, dtype=np.float32),
    )


def _nodes_unchanged(rec: DeltaRecord, existing, dirty_nodes) -> bool:
    """Every existing node matches its stored fingerprint by VALUE
    (labels, taints, readiness, available capacity, resident required
    anti-affinity).  Any mismatch — including an event-marked dirty
    node, whose fingerprint may be stale in ways values can't show —
    fails the whole check; node churn is a counted fallback, not a
    partial re-encode (prefix fills depend on the full node tensor)."""
    fps = rec.node_fps
    if len(existing) != len(fps):
        return False
    for en, fp in zip(existing, fps):
        if en.name != fp.name or en.name in dirty_nodes:
            return False
        if en.charge_pool is not None:
            return False
        node = en.node
        if node.meta.deleting != fp.deleting or node.ready != fp.ready:
            return False
        if node.labels != fp.labels or node.taints != fp.taints:
            return False
        av = np.asarray(en.available.v, dtype=np.float32)
        if not np.array_equal(av, fp.avail):
            return False
        if _has_required_anti(en.pods) != fp.res_anti:
            return False
    return True


def _same_group(g, prev_g, names) -> bool:
    """One pod class unchanged: same member count and member names, in
    order.  The list == fast path covers identical objects (the common
    in-process case) at C speed; the name walk covers re-unpickled pods
    (a remote caller's case)."""
    if len(g) != len(names):
        return False
    if g == prev_g:
        return True
    return all(p.meta.name == n for p, n in zip(g, names))


def plan(rec: Optional[DeltaRecord], inp, groups, dirty,
         min_groups: int, g_buckets, hints=None) -> "DeltaPlan | str":
    """Diff the new pass against the record.  `dirty` is the caller's
    SolveCache.dirty_snapshot() — taken once per pass so put() can
    retire exactly what this diff observed.  Returns a DeltaPlan, or a
    fallback-reason string (every string return is counted).

    With `hints` (an IncrHints from the event-driven index)
    the per-pass cluster walks vanish: the prefix length and suffix
    reuse map are precomputed from O(churn) probes, node cleanliness
    was proven at event time (only the O(1) count check remains), and
    the resident preempt-annotation scan collapses to the record's
    cached flag.  Everything O(groups) — band, topology, gang, bucket
    — still verifies live: those checks are cluster-size-independent
    and each guards an exactness contract."""
    if len({priority_of(g[0]) for g in groups}) > 1:
        # multi-band pass: the full path appends the
        # group_prio row and runs with_priority=1; the seeded delta
        # kernel runs with_priority=0 by contract, so band packing and
        # the inversion witness would be silently lost — fall back
        # whole (counted).  Checked before "cold" so the reason names
        # the cause.
        return "priority"
    if hints is None:
        if any(wellknown.PREEMPT_PLAN_ANNOTATION in p.meta.annotations
               for en in inp.existing_nodes for p in en.pods):
            # an in-flight eviction plan: the stamped victims' capacity
            # frees between this pass and the next, so a prefix seeded
            # against the pre-eviction base would replay stale headroom
            # — full pass until the preemption controller settles
            # (counted)
            return "preempt"
    elif rec is not None and rec.preempt_any:
        # same verdict from the record's cached flag: the index only
        # resolves a pass when zero node/resident events arrived, so
        # the record-time scan is still the truth
        return "preempt"
    if rec is None:
        return "cold"
    dirty_pods, dirty_nodes, all_dirty, _gen = dirty
    if all_dirty:
        return "nodes"
    if inp.price_cap is not None:
        return "price-cap"
    if any(lim is not None
           for lim in (inp.remaining_limits or {}).values()):
        return "limits"
    if len(groups) < min_groups:
        return "small"
    gang_specs = [gang_of(g[0]) for g in groups]
    for g in groups:
        rep = g[0]
        if rep.topology_spread or rep.pod_affinities or rep.preferences:
            return "topology"
    if rec.res_anti_any:
        return "topology"
    if hints is None:
        if not _nodes_unchanged(rec, inp.existing_nodes, dirty_nodes):
            return "nodes"
    elif len(inp.existing_nodes) != len(rec.node_fps):
        return "nodes"

    if hints is not None:
        # index-resolved prefix: groups[:m] ARE rec.groups[:m] by
        # reference (the index hands back the record's own lists), so
        # the per-member walk below would only re-prove identity
        m = min(hints.m, len(groups), rec.n_groups)
        suffix = groups[m:]
        reuse: List[Optional[int]] = list(hints.reuse)
    else:
        # dirty-set short-circuit: resolve the
        # dirty names to record ROWS once via the lazily-built name
        # index — O(churn) dict probes.  A dirty name the record never
        # saw needs no row: its group (new/renamed member) fails
        # _same_group on its own.  This replaces the per-group
        # any(n in dirty_pods) scans that made even a single-dirty-pod
        # pass O(cluster × members).
        dirty_rows: "frozenset | set" = frozenset()
        if dirty_pods:
            idx = rec.name_rows
            if idx is None:
                idx = {}
                for i, (_gid, names) in enumerate(rec.gkeys):
                    for n in names:
                        idx[n] = i
                rec.name_rows = idx
            dirty_rows = {idx[n] for n in dirty_pods if n in idx}

        prev_groups, prev_keys = rec.groups, rec.gkeys
        m = 0
        limit = min(len(groups), rec.n_groups)
        while m < limit:
            gid, names = prev_keys[m]
            g = groups[m]
            if g[0].scheduling_group_id() != gid:
                break
            if m in dirty_rows:
                break
            if not _same_group(g, prev_groups[m], names):
                break
            m += 1
        suffix = groups[m:]
    if any(gang_specs[m + j] is not None
           for j in range(len(suffix))):
        # a gang in the suffix — a dirty gang member, or any gang
        # behind the first changed group: the seeded kernel runs
        # with_gang=0 by contract, so the whole gang's prefix reuse is
        # invalidated and the pass falls back whole (counted).  A
        # DOMAIN-STABLE gang (no member churn, ahead of the churn) sits
        # in the prefix and replays via its recorded node pins — only
        # domain-churned gangs still pay this fallback.
        return "gang"
    if suffix and (bucket(len(suffix), g_buckets)
                   >= bucket(len(groups), g_buckets)):
        # the restricted slab would pad to the full problem's bucket —
        # no win, and a fresh seeded program compile for nothing
        return "bucket"

    if hints is None:
        prev_by_gid = {prev_keys[i][0]: i for i in range(m, rec.n_groups)}
        reuse = []
        for g in suffix:
            i = prev_by_gid.get(g[0].scheduling_group_id())
            if i is not None:
                _, names = prev_keys[i]
                if (i not in dirty_rows
                        and _same_group(g, prev_groups[i], names)):
                    reuse.append(i)
                    continue
            reuse.append(None)
    return DeltaPlan(record=rec, m=m, new_prefix=groups[:m],
                     suffix=suffix, reuse=reuse)


def _exist_tables(rec: DeltaRecord):
    """Per-call existing-node label matrices, built lazily ONCE per node
    set (nodes are value-stable while the record engages) — the same
    vocab/matrix construction encode() performs per full pass, so a
    fresh suffix group's exist row is bit-identical to what the full
    encode would produce."""
    if rec.exist_tables is None:
        existing = rec.enc.existing
        vocab = _Vocab()
        keys = sorted({k for en in existing for k in en.node.labels})
        matrices = _label_matrix(vocab, keys,
                                 [en.node.labels for en in existing])
        rec.exist_tables = (vocab, matrices)
    return rec.exist_tables


def _exist_row(rec: DeltaRecord, rep) -> np.ndarray:
    """encode()'s per-group existing-node allowance row for a fresh
    group, on the cached matrices and the SHARED eligibility verdict
    (encode.exist_group_ok — one definition, no drift); topology-inert,
    so ecap is BIG where the node qualifies, exactly the
    inactive-encoder shape."""
    existing = rec.enc.existing
    vocab, matrices = _exist_tables(rec)
    ok = exist_group_ok(rep, vocab, matrices, existing)
    return np.where(ok, BIG, 0).astype(np.int32)


def _feas_row(rec: DeltaRecord, cat, gi: int) -> np.ndarray:
    """The kernel's open-new column feasibility for prior group `gi`:
    group_mask ∧ (one pod fits a fresh node of the column) — the
    `cols_p` term of the opener's colmask, cached per class id."""
    gid, _ = rec.gkeys[gi]
    row = rec.feas_cache.get(gid)
    if row is None:
        fit = _np_fit_count(cat.col_alloc - cat.col_daemon,
                            rec.enc.group_req[gi])
        row = rec.enc.group_mask[gi] & (fit >= 1)
        if len(rec.feas_cache) > 4096:
            rec.feas_cache.clear()
        rec.feas_cache[gid] = row
    return row


@dataclass
class SuffixProblem:
    """The restricted problem build()'s output: unpadded suffix rows +
    the replayed prefix seed state."""
    group_req: np.ndarray
    group_count: np.ndarray
    group_mask: np.ndarray      # [Gd, O_real] bool
    exist_cap: np.ndarray       # [Gd, E] i32
    merged_reqs: List[list]
    exist_remaining: np.ndarray  # [E, R] f32 — consumed by the prefix
    seed_used: np.ndarray       # [A, R] f32
    seed_pool: np.ndarray       # [A] i32
    seed_colmask: np.ndarray    # [A, O_real] bool
    A: int                      # seeded (prefix-opened) node count
    reencoded: int              # suffix groups that needed a fresh encode


def build(plan_: DeltaPlan, cat) -> "SuffixProblem | None":
    """Encode the suffix and replay the prefix seed state.  Every
    float32 step mirrors the kernel's arithmetic op-for-op (same
    operand order, same EPS) so the seeded scan reproduces the full
    solve's suffix bit-for-bit.  Returns None when the cached output
    violates a replay invariant (paranoia guard → counted fallback)."""
    rec = plan_.record
    enc = rec.enc
    m = plan_.m
    E = len(enc.existing)
    O_real = len(cat.columns)
    Gd = len(plan_.suffix)
    req = enc.group_req

    # -- suffix rows: reuse cached encodings, re-encode only the churn --
    group_req = np.zeros((Gd, R), dtype=np.float32)
    group_count = np.zeros(Gd, dtype=np.int32)
    group_mask = np.zeros((Gd, O_real), dtype=bool)
    exist_cap = np.zeros((Gd, E), dtype=np.int32)
    merged_reqs: List[list] = []
    reenc = 0
    for j, (g, ridx) in enumerate(zip(plan_.suffix, plan_.reuse)):
        if ridx is not None:
            group_req[j] = req[ridx]
            group_count[j] = enc.group_count[ridx]
            group_mask[j] = enc.group_mask[ridx]
            if E:
                exist_cap[j] = enc.exist_cap[ridx]
            merged_reqs.append(enc.merged_reqs[ridx])
        else:
            reenc += 1
            rep = g[0]
            group_req[j] = np.array(effective_request(rep).v,
                                    dtype=np.float32)
            group_count[j] = len(g)
            gmask, merged = group_column_mask(cat, rep)
            group_mask[j] = gmask
            merged_reqs.append(merged)
            if E:
                exist_cap[j] = _exist_row(rec, rep)

    # -- prefix replay: exist_remaining after the prefix's fills --------
    # same per-group sequential order and the same two ops (product,
    # subtract) as the kernel's scan step, so rounding agrees exactly
    er = enc.exist_remaining.copy()
    te = rec.out_te
    for g in range(m):
        row = te[g]
        if row.any():
            er -= row[:, None] * req[g]

    # -- prefix replay: seeded node slots -------------------------------
    tn = rec.out_tn
    NA = rec.num_active
    if NA:
        nz = tn[:, :NA] > 0
        if not nz.any(axis=0).all():
            return None  # an active node nobody filled: replay invariant
        opener = nz.argmax(axis=0)
        if (np.diff(opener) < 0).any():
            return None  # node order not monotone in opener group
        A = int(np.searchsorted(opener, m))
    else:
        opener = np.zeros(0, dtype=np.int64)
        A = 0

    # adjacency-gang pin replay: a prefix gang with dsel>0
    # filled its new nodes inside ONE winning domain, and the kernel's
    # gang branch narrowed those nodes' colmask by the domain's columns
    # (dcols) at open AND touch time.  Recover each gang's winner from
    # the recorded node pins and replay the same narrowing — the host
    # dcols over real columns equals the kernel's slot-expanded mask
    # because cat.col_zone/col_ct ARE the per-column domain ids.
    gang_dcols: Dict[int, np.ndarray] = {}
    gg = enc.group_gang
    if gg is not None and A and np.asarray(gg[:m]).any():
        for g in np.nonzero(np.asarray(gg[:m]))[0]:
            dsel = int(enc.group_dsel[g])
            if dsel == 0:
                continue        # domain-free gang: dcols is all-true
            sel = tn[g, :A] > 0
            if not sel.any():
                continue        # exist-only fill: no colmask narrowing
            pins = rec.node_zone if dsel == 1 else rec.node_ct
            if pins is None:
                return None     # pre-pin record: replay invariant
            doms = np.unique(pins[:A][sel])
            if doms.size != 1 or int(doms[0]) < 0:
                return None     # inconsistent pins: replay invariant
            w = int(doms[0])
            gang_dcols[int(g)] = ((cat.col_zone == w) if dsel == 1
                                  else (cat.col_ct == w))

    seed_used = np.zeros((A, R), dtype=np.float32)
    seed_pool = rec.node_pool[:A].astype(np.int32, copy=True)
    seed_colmask = np.zeros((A, O_real), dtype=bool)
    if A:
        pool_rows = cat.pool_daemon[seed_pool]          # [A, R] f32
        opener_a = opener[:A]
        # opener colmask base: cols_p of the opening group ∩ the node's
        # pool (the kernel's step-3 new_colmask, before capacity); a
        # gang opener additionally intersects its winning domain's
        # columns, exactly the kernel's `& dcols`
        for gi in np.unique(opener_a):
            feas = _feas_row(rec, cat, int(gi))
            sel = opener_a == gi
            base = (feas[None, :]
                    & (cat.col_pool[None, :] == seed_pool[sel, None]))
            d = gang_dcols.get(int(gi))
            if d is not None:
                base &= d[None, :]
            seed_colmask[sel] = base
        for g in range(m):
            row = tn[g, :A]
            sel = row > 0
            if not sel.any():
                continue
            prod = row[:, None] * req[g]                # f32, like the kernel
            opened = sel & (opener_a == g)
            touched = sel & ~opened
            if opened.any():
                # the kernel SETS pool_daemon + k·req at open time
                seed_used[opened] = pool_rows[opened] + prod[opened]
            if touched.any():
                seed_used[touched] = seed_used[touched] + prod[touched]
                # in-flight touch narrows the mask to the group's columns
                # (a gang touch also narrows to its winning domain)
                narrow = enc.group_mask[g]
                d = gang_dcols.get(g)
                if d is not None:
                    narrow = narrow & d
                seed_colmask[touched] &= narrow[None, :]
        # final capacity mask: pt-granular fit against the final used
        # vector (the kernel applies it every step; used only grows, so
        # the final application is the binding one)
        zc = max(cat.zc, 1)
        PT = O_real // zc
        ok_pt = np.all(
            cat.pt_alloc[None, :, :] - seed_used[:, None, :] >= -EPS,
            axis=-1)                                    # [A, PT]
        seed_colmask &= np.broadcast_to(
            ok_pt[:, :, None], (A, PT, zc)).reshape(A, O_real)

    return SuffixProblem(
        group_req=group_req, group_count=group_count,
        group_mask=group_mask, exist_cap=exist_cap,
        merged_reqs=merged_reqs, exist_remaining=er,
        seed_used=seed_used, seed_pool=seed_pool,
        seed_colmask=seed_colmask, A=A, reencoded=reenc)


def merge(plan_: DeltaPlan, sp: SuffixProblem, cat, inp,
          out_s: Optional[dict], Gd: int):
    """Stitch the cached prefix rows and the seeded suffix output into
    one (EncodedProblem, out) pair for the ordinary decode.  With an
    empty suffix (pure reuse / tail removal) out_s is None and the
    merged output is the prefix alone — no kernel ran at all."""
    rec = plan_.record
    enc_p = rec.enc
    m = plan_.m
    E = len(enc_p.existing)
    D = enc_p.n_domains
    A = sp.A
    G = m + Gd

    if out_s is None:
        num_active = A
        te = rec.out_te[:m]
        tn = rec.out_tn[:m, :A]
        used = sp.seed_used
        node_pool = sp.seed_pool
        # prefix gang pins survive the merge: the recorded
        # winning-domain per node is the seed's truth — without it the
        # repair pass and decode's claim pinning would see -1 and
        # strand every adjacency gang the prefix replayed
        if rec.node_zone is not None:
            node_zone = rec.node_zone[:A].copy()
            node_ct = rec.node_ct[:A].copy()
        else:
            node_dom = np.full(A, -1, dtype=np.int32)
            node_zone, node_ct = node_dom, node_dom
    else:
        num_active = int(out_s["num_active"])
        te = np.concatenate(
            [rec.out_te[:m], out_s["take_exist"][:Gd, :E]], axis=0)
        tn_pref = np.zeros((m, num_active), dtype=rec.out_tn.dtype)
        tn_pref[:, :A] = rec.out_tn[:m, :A]
        tn = np.concatenate(
            [tn_pref, out_s["take_new"][:Gd, :num_active]], axis=0)
        used = out_s["used"]
        node_pool = out_s["node_pool"]
        node_zone = out_s["node_zone"]
        node_ct = out_s["node_ct"]
        if A and rec.node_zone is not None:
            # seeded slots re-enter the suffix kernel with node_zone/ct
            # at their init (-1) — the suffix is gang- and topology-free
            # by plan() contract, so it never writes them; restore the
            # prefix's recorded pins over the first A slots
            node_zone = np.asarray(node_zone, dtype=np.int32).copy()
            node_ct = np.asarray(node_ct, dtype=np.int32).copy()
            node_zone[:A] = rec.node_zone[:A]
            node_ct[:A] = rec.node_ct[:A]

    out_m = dict(
        take_exist=te,
        take_new=tn,
        new_overflow=False,
        unsched=np.zeros(G, dtype=np.float32),
        dom_placed=np.zeros((G, D), dtype=np.float32),
        used=used,
        node_pool=np.asarray(node_pool, dtype=np.int32),
        node_zone=np.asarray(node_zone, dtype=np.int32),
        node_ct=np.asarray(node_ct, dtype=np.int32),
        num_active=num_active,
    )
    # prefix-attribution reuse: stitch the record's cached
    # aux rows with the suffix solve's fresh ones, like the take rows —
    # present only when BOTH sides carried aux (a mode flip mid-cache
    # simply drops the merged attribution for one pass)
    kc_prev = rec.explain_counts
    kc_suf = out_s.get("explain_counts") if out_s is not None else None
    if kc_prev is not None and (out_s is None or kc_suf is not None):
        prefix_rows = np.asarray(kc_prev)[:m]
        if out_s is None:
            out_m["explain_counts"] = prefix_rows.copy()
        else:
            out_m["explain_counts"] = np.concatenate(
                [prefix_rows, np.asarray(kc_suf)[:Gd]], axis=0)

    def cc(a, b):
        return np.concatenate([a, b], axis=0) if Gd else a.copy()

    inert_i = np.zeros(Gd, dtype=np.int32)
    groups_m = list(plan_.suffix)
    # host-side attribution stitches the same way (price column is 0 by
    # contract: the delta path falls back on any price cap)
    eh_prev = getattr(enc_p, "explain_host", None)
    explain_host = None
    if eh_prev is not None:
        if Gd:
            suf_host = np.stack(
                [len(cat.columns)
                 - sp.group_mask.sum(axis=1, dtype=np.int64),
                 np.zeros(Gd, dtype=np.int64)], axis=1)
            explain_host = np.concatenate(
                [np.asarray(eh_prev)[:m], suf_host], axis=0)
        else:
            explain_host = np.asarray(eh_prev)[:m].copy()
    enc_m = EncodedProblem(
        group_req=cc(enc_p.group_req[:m], sp.group_req),
        group_count=cc(enc_p.group_count[:m], sp.group_count),
        group_mask=cc(enc_p.group_mask[:m], sp.group_mask),
        exist_cap=cc(enc_p.exist_cap[:m], sp.exist_cap),
        # the ORIGINAL capacities — replay always restarts from them
        exist_remaining=enc_p.exist_remaining,
        col_alloc=cat.col_alloc,
        col_daemon=cat.col_daemon,
        col_price=cat.col_price,
        col_pool=cat.col_pool,
        pool_limit=enc_p.pool_limit,
        group_ncap=cc(enc_p.group_ncap[:m],
                      np.full(Gd, BIG, dtype=np.int32)),
        group_dsel=cc(enc_p.group_dsel[:m], inert_i),
        group_dbase=cc(enc_p.group_dbase[:m],
                       np.zeros((Gd, D), dtype=np.int32)),
        group_dcap=cc(enc_p.group_dcap[:m],
                      np.full((Gd, D), BIG, dtype=np.int32)),
        group_skew=cc(enc_p.group_skew[:m],
                      np.full(Gd, BIG, dtype=np.int32)),
        group_mindom=cc(enc_p.group_mindom[:m], inert_i),
        group_delig=cc(enc_p.group_delig[:m],
                       np.zeros((Gd, D), dtype=bool)),
        group_whole_node=cc(enc_p.group_whole_node[:m],
                            np.zeros(Gd, dtype=bool)),
        # gang rows stitch like every other group tensor; plan()
        # guarantees the SUFFIX is gang-free (counted "gang" fallback
        # otherwise), so the suffix side is always zeros — prefix gangs
        # (fully placed at record time; adjacency gangs replay their
        # recorded domain pins through build/merge) reuse bit-exactly
        group_gang=cc(enc_p.group_gang[:m], np.zeros(Gd, dtype=bool)),
        col_zone=cat.col_zone,
        col_ct=cat.col_ct,
        exist_zone=enc_p.exist_zone,
        exist_ct=enc_p.exist_ct,
        zone_values=enc_p.zone_values,
        ct_values=enc_p.ct_values,
        n_domains=D,
        static_allowed=(list(enc_p.static_allowed[:m])
                        + [{wellknown.ZONE_LABEL: None,
                            wellknown.CAPACITY_TYPE_LABEL: None}
                           for _ in range(Gd)]),
        residue=[],
        explain_host=explain_host,
        groups=list(plan_.new_prefix) + groups_m,
        columns=cat.columns,
        existing=list(inp.existing_nodes),
        pools=cat.pools,
        merged_reqs=list(enc_p.merged_reqs[:m]) + sp.merged_reqs,
    )
    return enc_m, out_m


def tables_reusable(old: DeltaRecord, new: DeltaRecord) -> bool:
    """Whether `old`'s lazily-built exist tables are valid for `new`:
    the label matrices key on each node's labels/taints/readiness in
    order, so any node-set difference invalidates them (available
    capacity and resident anti flags don't participate)."""
    if len(old.node_fps) != len(new.node_fps):
        return False
    for a, b in zip(old.node_fps, new.node_fps):
        if (a.name != b.name or a.labels != b.labels
                or a.taints != b.taints or a.ready != b.ready
                or a.deleting != b.deleting):
            return False
    return True


def make_record(cat, enc: EncodedProblem, out: dict, inp,
                carry=None) -> Optional[DeltaRecord]:
    """Build a DeltaRecord from a finished solve, or None when the
    solve is ineligible as a delta base: anything stranded, any
    topology activity in the encoding, synthetic charge-pool nodes, or
    finite pool limits (their device arithmetic has no exact host
    mirror).  Gang groups are the ONE dsel>0 shape admitted:
    their fills carry recorded node pins that build()/merge() replay
    bit-exactly, so domain-stable gangs stop costing an eternal "cold".

    `carry=(prev_record, plan_)` marks a record built by an ENGAGED
    delta pass: the group keys stitch from the previous record along
    the plan's prefix/reuse map (O(groups + churn) instead of the
    O(cluster) name walk), and the node fingerprints carry whole — the
    pass only engaged because the node set was verified unchanged, by
    value (walk) or by event (index)."""
    G = enc.n_groups
    E = len(enc.existing)
    if G == 0:
        return None
    unsched = np.asarray(out["unsched"])[:G]
    if unsched.sum() > 0:
        return None
    if inp.price_cap is not None:
        return None
    if any(lim is not None
           for lim in (inp.remaining_limits or {}).values()):
        return None
    gg = enc.group_gang
    gang_rows = (np.asarray(gg[:G], dtype=bool) if gg is not None
                 else np.zeros(G, dtype=bool))
    if ((np.asarray(enc.group_dsel[:G]) != 0) & ~gang_rows).any() or \
            (enc.group_ncap[:G] < BIG).any() or \
            enc.group_whole_node[:G].any():
        return None
    if any(v is not None for d in enc.static_allowed for v in d.values()):
        return None
    if any(en.charge_pool is not None for en in enc.existing):
        return None

    na = int(out["num_active"])
    te = np.ascontiguousarray(
        np.asarray(out["take_exist"])[:G, :E], dtype=np.float32)
    tn = np.ascontiguousarray(
        np.asarray(out["take_new"])[:G, :na], dtype=np.float32)
    node_pool = np.ascontiguousarray(
        np.asarray(out["node_pool"])[:na], dtype=np.int32)
    node_zone = np.ascontiguousarray(
        np.asarray(out["node_zone"])[:na], dtype=np.int32)
    node_ct = np.ascontiguousarray(
        np.asarray(out["node_ct"])[:na], dtype=np.int32)
    if carry is not None:
        prev, plan_ = carry
        m = plan_.m
        gkeys = list(prev.gkeys[:m])
        for g, ridx in zip(plan_.suffix, plan_.reuse):
            if ridx is not None:
                gkeys.append(prev.gkeys[ridx])
            else:
                gkeys.append((g[0].scheduling_group_id(),
                              tuple(p.meta.name for p in g)))
        node_fps = prev.node_fps
        res_anti_any = prev.res_anti_any
        preempt_any = prev.preempt_any
    else:
        gkeys = [(g[0].scheduling_group_id(),
                  tuple(p.meta.name for p in g)) for g in enc.groups]
        node_fps = [_fingerprint(en) for en in enc.existing]
        res_anti_any = any(fp.res_anti for fp in node_fps)
        preempt_any = any(
            wellknown.PREEMPT_PLAN_ANNOTATION in p.meta.annotations
            for en in enc.existing for p in en.pods)
    kc = out.get("explain_counts")
    explain_counts = (np.ascontiguousarray(np.asarray(kc)[:G])
                      if kc is not None else None)
    return DeltaRecord(
        cat=cat, enc=enc, groups=list(enc.groups), gkeys=gkeys,
        out_te=te, out_tn=tn, node_pool=node_pool, num_active=na,
        node_fps=node_fps,
        res_anti_any=res_anti_any,
        explain_counts=explain_counts,
        node_zone=node_zone, node_ct=node_ct,
        preempt_any=preempt_any)


# ---------------------------------------------------------------------------
# Speculative chunked G-axis pipeline (solver/solve.py _try_spec)
# ---------------------------------------------------------------------------
# The suffix replay above proves the scan can be re-entered mid-stream
# from host-replayed state.  The speculative pipeline generalizes the
# same discipline from "one suffix behind a cached prefix" to ARBITRARY
# chunk boundaries of a single pass: cut the G axis into K chunks, solve
# each as a seeded solve whose entry seed is the previous chunk's exit
# state, and let chunk k+1 dispatch EARLY from a cheap open-new-only
# projection of chunk k's exit (`project_chunk`).  When chunk k's true
# output lands, `fold_chunk` materializes the bit-exact exit seed (used
# and pool straight from the kernel; exist_remaining and colmask by the
# same op-for-op float32 replay `build` performs) and `seed_digest`
# compares it against what the speculation dispatched — equal digests
# mean the in-flight successor consumed IDENTICAL kernel inputs, so its
# result is the sequential scan's by construction; unequal digests cost
# one counted re-dispatch, never correctness.

# below this many pod classes a chunked pass can't beat the single
# program (the smallest split still pays an extra dispatch + seed
# replay); "auto" mode declines, "on" forces (tests, benches)
SPEC_MIN_GROUPS = 129


@dataclass
class ChunkSeed:
    """Mid-scan kernel state at a chunk boundary — exactly the seed
    operand set of `solve_ffd_delta` (plus the consumed
    exist_remaining, which rides the problem tuple).  Two ChunkSeeds
    with equal `seed_digest` produce bit-identical seeded solves."""
    er: np.ndarray       # [E, R] f32 — exist_remaining after the prefix
    used: np.ndarray     # [A, R] f32
    pool: np.ndarray     # [A] i32
    colmask: np.ndarray  # [A, O_real] bool
    A: int               # open node slots so far


def chunk_entry_seed(enc: EncodedProblem) -> ChunkSeed:
    """The scan's initial state: no open nodes, untouched existing
    capacity — chunk 0's entry seed."""
    O_real = enc.group_mask.shape[1]
    return ChunkSeed(
        er=enc.exist_remaining.copy(),
        used=np.zeros((0, R), dtype=np.float32),
        pool=np.zeros(0, dtype=np.int32),
        colmask=np.zeros((0, O_real), dtype=bool), A=0)


def _chunk_feas(enc: EncodedProblem, cat, g: int, cache: dict):
    """`_feas_row`'s chunk-boundary twin — the kernel's open-new column
    feasibility (group_mask ∧ one-pod-fits) PLUS the per-column fit
    vector, for group `g` of a LIVE encoding (no DeltaRecord: the spec
    path seeds from the pass's own enc).  Cached per group index —
    fold and project both consult it, and a repair re-folds the same
    groups."""
    hit = cache.get(g)
    if hit is None:
        fit = _np_fit_count(cat.col_alloc - cat.col_daemon,
                            enc.group_req[g])
        hit = (enc.group_mask[g] & (fit >= 1), fit)
        cache[g] = hit
    return hit


def _apply_pt_capacity(colmask: np.ndarray, used: np.ndarray, cat
                       ) -> np.ndarray:
    """The kernel's pt-granular capacity mask against a used matrix:
    colmask ∧ (every resource of the (pool,type) block still fits).
    Applied to the FINAL used rows — the kernel re-applies it every
    step, but used only grows, so the last application is the binding
    one (same argument as build())."""
    n, O_real = colmask.shape
    if n == 0:
        return colmask
    zc = max(cat.zc, 1)
    PT = O_real // zc
    ok_pt = np.all(
        cat.pt_alloc[None, :, :] - used[:, None, :] >= -EPS,
        axis=-1)                                         # [n, PT]
    return colmask & np.broadcast_to(
        ok_pt[:, :, None], (n, PT, zc)).reshape(n, O_real)


def fold_chunk(seed: ChunkSeed, enc: EncodedProblem, cat, lo: int,
               hi: int, out: dict, feas_cache: dict
               ) -> "ChunkSeed | None":
    """The TRUE exit state of groups [lo, hi) given the chunk's kernel
    output: `used`/`pool` come straight from the kernel (bit-exact, no
    replay), `exist_remaining` and the surviving-column masks replay
    host-side with build()'s op-for-op float32 discipline.  Returns
    None when the output violates a replay invariant (every active
    node opened by some group, openers monotone) — the caller falls
    back whole, counted."""
    req = enc.group_req
    Gd = hi - lo
    E = seed.er.shape[0]
    O_real = len(cat.columns)

    # exist_remaining: same per-group order and the same two ops
    # (product, subtract) as the kernel's scan step
    er = seed.er.copy()
    if E:
        te = np.asarray(out["take_exist"], dtype=np.float32)
        for j in range(Gd):
            row = te[j, :E]
            if row.any():
                er -= row[:, None] * req[lo + j]

    na = int(out["num_active"])
    A0 = seed.A
    if na < A0:
        return None  # the kernel never closes a slot: replay invariant
    used = np.ascontiguousarray(
        np.asarray(out["used"])[:na], dtype=np.float32)
    node_pool = np.ascontiguousarray(
        np.asarray(out["node_pool"])[:na], dtype=np.int32)
    tn = np.asarray(out["take_new"], dtype=np.float32)[:Gd, :na]

    colmask = np.zeros((na, O_real), dtype=bool)
    colmask[:A0] = seed.colmask
    opener_full = np.full(na, -1, dtype=np.int64)
    if na > A0:
        nz = tn[:, A0:] > 0
        if not nz.any(axis=0).all():
            return None  # an active node nobody filled
        opener = nz.argmax(axis=0)
        if (np.diff(opener) < 0).any():
            return None  # node order not monotone in opener group
        opener_full[A0:] = opener
        # opener colmask base: cols_p of the opening group ∩ the
        # node's pool (the kernel's step-3 new_colmask, pre-capacity)
        for gi in np.unique(opener):
            feas, _ = _chunk_feas(enc, cat, lo + int(gi), feas_cache)
            sel = np.zeros(na, dtype=bool)
            sel[A0:] = opener == gi
            colmask[sel] = (feas[None, :]
                            & (cat.col_pool[None, :]
                               == node_pool[sel, None]))
    for j in range(Gd):
        touched = (tn[j] > 0) & (opener_full != j)
        if touched.any():
            # in-flight touch narrows the mask to the group's columns
            colmask[touched] &= enc.group_mask[lo + j][None, :]
    colmask = _apply_pt_capacity(colmask, used, cat)
    return ChunkSeed(er=er, used=used, pool=node_pool,
                     colmask=colmask, A=na)


def project_chunk(seed: ChunkSeed, enc: EncodedProblem, cat, lo: int,
                  hi: int, max_nodes: int, feas_cache: dict
                  ) -> "ChunkSeed | None":
    """SPECULATED exit state of groups [lo, hi): the open-new-only
    greedy lower bound — every group opens fresh nodes on its first
    feasible pool, mirroring the kernel's step-3 arithmetic exactly
    (same fit counts, same ceil-split node fan-out, same float32
    daemon+k·req order), and predicts NO existing-node or in-flight
    fills.  When the true scan also places open-new-only (the cold
    megascale shape), the projection is bit-exact and the speculation
    commits; any fill it failed to predict surfaces as a digest
    mismatch and a counted repair — a wrong guess can cost latency,
    never correctness.  Returns None to DECLINE speculating (existing
    capacity would absorb pods, no feasible pool, node slots
    exhausted): the chain then waits for the true seed."""
    req = enc.group_req
    E = seed.er.shape[0]
    O_real = len(cat.columns)
    P = len(cat.pools)
    opened_used: List[np.ndarray] = []
    opened_pool: List[np.ndarray] = []
    opened_mask: List[np.ndarray] = []
    opened = 0
    for g in range(lo, hi):
        cnt = int(enc.group_count[g])
        if cnt <= 0:
            continue
        if E:
            ecap = enc.exist_cap[g]
            if ecap.any():
                cap_e = np.minimum(_np_fit_count(seed.er, req[g]), ecap)
                if (cap_e > 0).any():
                    return None  # step 1 would fill an existing node
        feas, fit = _chunk_feas(enc, cat, g, feas_cache)
        cols_p = None
        for p in range(P):
            sel = feas & (cat.col_pool == p)
            if sel.any():
                cols_p = sel
                break
        if cols_p is None:
            return None  # would strand — let the true solve decide
        k_full = int(fit[cols_p].max())
        m = -(-cnt // k_full)
        if seed.A + opened + m > max_nodes:
            return None  # slot budget: the truth cascades or strands
        k_node = np.full(m, k_full, dtype=np.int64)
        k_node[m - 1] = cnt - (m - 1) * k_full
        # the kernel's new_used: pool_daemon[p] + k·req, k cast to f32
        # BEFORE the product — same operand order, same rounding
        prod = k_node.astype(np.float32)[:, None] * req[g][None, :]
        opened_used.append(cat.pool_daemon[p][None, :] + prod)
        opened_pool.append(np.full(m, p, dtype=np.int32))
        opened_mask.append(np.repeat(cols_p[None, :], m, axis=0))
        opened += m
    if not opened:
        return ChunkSeed(er=seed.er, used=seed.used, pool=seed.pool,
                         colmask=seed.colmask, A=seed.A)
    used_new = np.concatenate(opened_used).astype(np.float32)
    mask_new = _apply_pt_capacity(
        np.concatenate(opened_mask), used_new, cat)
    return ChunkSeed(
        er=seed.er,  # no exist fills predicted (declined above)
        used=np.concatenate([seed.used, used_new]),
        pool=np.concatenate([seed.pool, np.concatenate(opened_pool)]),
        colmask=np.concatenate([seed.colmask, mask_new]),
        A=seed.A + opened)


def seed_digest(seed: ChunkSeed) -> bytes:
    """Value fingerprint of a chunk-boundary seed: equal digests ⇒ the
    seeded solves they feed consume bit-identical operands ⇒ identical
    outputs (the kernel is deterministic) — the commit-time check that
    makes a committed speculation exact BY CONSTRUCTION."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(seed.A).tobytes())
    h.update(np.ascontiguousarray(seed.er).tobytes())
    h.update(np.ascontiguousarray(seed.used).tobytes())
    h.update(np.ascontiguousarray(seed.pool).tobytes())
    h.update(np.packbits(seed.colmask).tobytes())
    return h.digest()
