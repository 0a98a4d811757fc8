"""Event-driven incremental group index: O(churn) steady-state grouping.

The delta path (solver/delta.py) makes the device solve O(suffix), but a
warm pass still pays O(cluster) on the host to DISCOVER the suffix: the
full ``group_pods`` walk, the per-group ``_same_group`` prefix scan, and
the per-node fingerprint sweep all touch every pod/node to resolve a 1%
dirty set.  This module (a copy of the JAX package's `solver/incr.py`)
maintains those answers incrementally off the watch stream instead:

  * ``IncrIndex`` — pod name → group key (``scheduling_group_id``) →
    dense kernel row, plus per-node value fingerprints, updated at
    watch-EVENT time (``SolveCache.invalidate`` with resolved objects).
    A churn pass then resolves its dirty set with O(churn) dict probes.
  * ``build_groups`` — assemble the pass's FFD group list from the
    index: clean rows reuse the record's member lists by reference,
    dirty rows rebuild from survivors + event-carried additions, and
    the result ships with ``IncrHints`` (prefix length + suffix reuse
    map) so ``delta.plan`` skips its per-pass cluster walks entirely.

The index TRUSTS the event stream ("armed" contract): it only engages
when the deployment wires a watch feed (``TorchSolver.incr_arm``) or the
INCR knob forces it — the walk-based delta plan stays the value-verified
default for callers that mutate inputs without events (a remote caller,
direct library use).  Every condition the index cannot follow is a
COUNTED fallback to the existing walk (``INCR_FALLBACK_REASONS`` in
solver/explain.py, counted per solver in ``incr_passes``):

  * ``cold``   — no index yet (first pass, eviction, racing retirement)
  * ``flood``  — watch-drain overflow / dirty-set flood: all-dirty
  * ``drift``  — the live pending set disagrees with the event-tracked
    view (pod count mismatch, record replaced under the index)
  * ``pods``   — a names-only invalidation (no objects) the index
    cannot apply, from a caller that predates the object-bearing feed
  * ``nodes``  — any node-set/node-value event dirt: the walk's full
    fingerprint sweep is the authority on node churn
  * ``order``  — the FFD order invariant can't be proven by probes
    alone: a brand-new group key, a representative swap that breaks the
    strict (size, name) descending order, or a priority-band change

All fallbacks are transient: the walk pass that absorbs one publishes a
fresh record, and ``SolveCache.put`` rebuilds the index from it (the
"rebuilt from snapshot" path) under the same generation guard the
classic dirty sets use — an invalidation racing the solve keeps the
index retired rather than ever carrying a stale view.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from karpenter_tpu_torch.scheduling.types import priority_of
from karpenter_tpu_torch.solver.encode import group_order_key


@dataclass
class IncrHints:
    """What an index-resolved pass hands ``delta.plan`` so the plan is
    pure lookups: the record the index mirrors, the group list built
    from it (prefix rows are the record's lists BY REFERENCE), the
    precomputed prefix length and suffix reuse map, and the classic
    dirty snapshot taken ATOMICALLY with the index snapshot (put()
    retires exactly this view)."""
    rec: object
    groups: List[list]
    m: int
    reuse: List[Optional[int]]
    consumed: tuple              # (dirty_pods, dirty_nodes, all_dirty, gen)
    dirty_size: int              # event-dirty names observed (flight stamp)


@dataclass
class _IndexSnapshot:
    """One consistent view of the index for a single pass, copied under
    the cache lock (group assembly then runs lock-free)."""
    rec: object
    base_groups: List[list]
    gid_order: List[int]
    gid_row: Dict[int, int]
    order_keys: List[tuple]
    band: int
    n_pods: int
    dirty_gids: Set[int]
    added: Dict[int, Dict[str, object]]
    removed: Set[str]
    nodes_dirty: bool
    flood: bool
    broken: Optional[str]


class IncrIndex:
    """The event-maintained mirror of one DeltaRecord.  All mutation
    happens under the owning SolveCache's lock (invalidate / put /
    snapshot all hold it); the solver only ever sees `_IndexSnapshot`
    copies."""

    def __init__(self, rec, name_gid: Dict[str, int], n_pods: int,
                 band: int, node_fp: Dict[str, object]):
        self.rec = rec
        self.name_gid = name_gid            # pod name -> gid (all rows)
        self.n_pods = n_pods
        self.band = band
        self.node_fp = node_fp              # node name -> _NodeFP
        # O(G) row structures, rebuilt per record
        self.gid_order: List[int] = []
        self.gid_row: Dict[int, int] = {}
        self.order_keys: List[tuple] = []
        self._index_rows(rec)
        # accumulated event dirt (consumed per engaged pass)
        self.dirty_gids: Set[int] = set()
        self.added: Dict[int, Dict[str, object]] = {}
        self.added_gid: Dict[str, int] = {}
        self.removed: Set[str] = set()
        self.nodes_dirty = False
        self.flood = False
        self.broken: Optional[str] = None

    def _index_rows(self, rec) -> None:
        self.gid_order = [gid for gid, _names in rec.gkeys]
        self.gid_row = {gid: i for i, gid in enumerate(self.gid_order)}
        self.order_keys = [group_order_key(g[0]) for g in rec.groups]

    # -- event application (under the cache lock) -----------------------

    def note_names_only(self) -> None:
        """A names-only invalidation: the index has no objects to apply,
        so its membership view is stale until the next rebuild."""
        self.broken = self.broken or "pods"

    def note_flood(self) -> None:
        self.flood = True

    def _present(self, name: str) -> bool:
        return ((name in self.name_gid and name not in self.removed)
                or name in self.added_gid)

    def _retract_added(self, name: str) -> None:
        """Forget a pending ADD the index is still carrying —
        ordinary absorption of a delete/bind event for a pod that
        never reached a record, not a degrade path (the group it
        touched stays dirty and rebuilds exactly)."""
        gid = self.added_gid.pop(name, None)
        if gid is not None:
            self.added.get(gid, {}).pop(name, None)
            self.dirty_gids.add(gid)

    def apply_pod(self, name: str, obj) -> None:
        """One resolved pod event.  `obj` is the store's CURRENT object
        (None = deleted).  A pod bound to a node has left the pending
        set AND moved its node's capacity — node churn is the walk's
        business, so any bind/unknown-deletion marks nodes dirty.

        MEMBER-ORDER contract: group_pods keeps members in INPUT
        (store) order, so the index may only absorb events whose store
        position it can prove.  A brand-new name appends at the store
        end — mirrored by the added dict's insertion order (events
        arrive in mutation order).  A pending event for a name already
        tracked is ambiguous: an in-place modify KEEPS its position
        while a delete+create MOVES to the end, and the coalesced feed
        cannot tell them apart — counted "order" fallback."""
        present = self._present(name)
        pending = obj is not None and obj.node_name is None
        if pending:
            if present:
                self.broken = self.broken or "order"
                return
            gid = obj.scheduling_group_id()
            self.added.setdefault(gid, {})[name] = obj
            self.added_gid[name] = gid
            self.dirty_gids.add(gid)
            self.n_pods += 1
        else:
            self._retract_added(name)
            if obj is not None:
                self.nodes_dirty = True      # bound: node capacity moved
            if name in self.name_gid and name not in self.removed:
                self.removed.add(name)
                self.dirty_gids.add(self.name_gid[name])
            elif not present and obj is None:
                # deletion of a name the index never tracked: most
                # likely a resident pod freeing node capacity
                self.nodes_dirty = True
            if present:
                self.n_pods -= 1

    def apply_node(self, name: str, obj) -> None:
        """One resolved node event: absorb as spurious iff every value
        the encoding reads off the Node object is unchanged (labels,
        taints, readiness, deletion mark, allocatable).  Available
        capacity is NOT on the object — it moves via resident pod
        binds/deletes, which `apply_pod` marks separately — so value
        equality here means the event was a resync touch."""
        fp = self.node_fp.get(name)
        if obj is None or fp is None:
            self.nodes_dirty = True
            return
        alloc = getattr(fp, "alloc", None)
        if (obj.meta.deleting != fp.deleting or obj.ready != fp.ready
                or obj.labels != fp.labels or obj.taints != fp.taints
                or alloc is None
                or not np.array_equal(
                    np.asarray(obj.allocatable.v, dtype=np.float32),
                    alloc)):
            self.nodes_dirty = True

    def apply_claim(self, name: str) -> None:
        """A nodeclaim event dirties the index only when its name
        shadows an existing node — the same effect the name has on the
        walk's `_nodes_unchanged` check."""
        if name in self.node_fp:
            self.nodes_dirty = True

    # -- snapshot / lifecycle (under the cache lock) --------------------

    def snapshot(self) -> _IndexSnapshot:
        return _IndexSnapshot(
            rec=self.rec, base_groups=self.rec.groups,
            gid_order=self.gid_order, gid_row=self.gid_row,
            order_keys=self.order_keys, band=self.band,
            n_pods=self.n_pods, dirty_gids=set(self.dirty_gids),
            added={g: dict(d) for g, d in self.added.items() if d},
            removed=set(self.removed), nodes_dirty=self.nodes_dirty,
            flood=self.flood, broken=self.broken)

    def dirty_count(self) -> int:
        return (len(self.removed) + len(self.added_gid)
                + len(self.dirty_gids))

    def advance(self, rec) -> bool:
        """Structural O(churn) carry after an index-resolved pass: the
        new record's membership is exactly base ∘ (removed, added) by
        construction, so name_gid updates by the event dirt alone and
        only the O(G) row structures rebuild.  Returns False when the
        O(G) count cross-check disagrees — the caller then pays the
        full rebuild (which a fallback pass pays anyway)."""
        if self.broken or self.flood or self.nodes_dirty:
            return False
        for n in self.removed:
            self.name_gid.pop(n, None)
        self.name_gid.update(self.added_gid)
        expect = sum(len(names) for _gid, names in rec.gkeys)
        if len(self.name_gid) != expect:
            return False
        self.rec = rec
        self.n_pods = expect
        self._index_rows(rec)
        self.dirty_gids.clear()
        self.added.clear()
        self.added_gid.clear()
        self.removed.clear()
        return True


def index_from_record(rec, node_fps=None) -> Optional[IncrIndex]:
    """Full O(cluster) index build from a published DeltaRecord — the
    rebuild-from-snapshot path, paid only on passes that were already
    O(cluster) (cold solves and counted fallbacks).  Returns None for
    records the index cannot mirror (multi-band group lists: the strict
    in-band order invariant is per band, and steady-state churn across
    bands is the walk's business)."""
    bands = {priority_of(g[0]) for g in rec.groups}
    if len(bands) > 1:
        return None
    name_gid: Dict[str, int] = {}
    n_pods = 0
    for gid, names in rec.gkeys:
        for n in names:
            name_gid[n] = gid
        n_pods += len(names)
    node_fp = {fp.name: fp for fp in (node_fps or rec.node_fps)}
    return IncrIndex(rec, name_gid, n_pods,
                     next(iter(bands)), node_fp)


def build_groups(snap: _IndexSnapshot, inp
                 ) -> "Tuple[List[list], int, List[Optional[int]]] | str":
    """Assemble the pass's FFD group list from an index snapshot, or a
    fallback-reason string (every string return is counted by the
    caller).  Clean rows reuse the record's lists by reference; dirty
    rows rebuild as survivors (record order) + event additions
    (store-append order); emptied rows drop.  The FFD order invariant is then proved
    by an O(groups) strict-descending sweep of the (size, name) keys —
    never by re-sorting, which would silently mask a wrong probe."""
    if snap.broken:
        return snap.broken
    if snap.flood:
        return "flood"
    if snap.nodes_dirty:
        return "nodes"
    if snap.n_pods != len(inp.pods):
        return "drift"
    for gid in snap.dirty_gids:
        if gid not in snap.gid_row:
            return "order"      # a brand-new group key appeared
    groups: List[list] = []
    keys: List[tuple] = []
    src_rows: List[Optional[int]] = []   # base row per new row, None=dirty
    m = -1                               # set at the FIRST dirty base row:
    for i, g in enumerate(snap.base_groups):   # a drop shifts every later
        gid = snap.gid_order[i]                # row, so it ends the prefix
        if gid in snap.dirty_gids:             # exactly like a rebuild
            if m < 0:
                m = len(groups)
            members = [p for p in g if p.meta.name not in snap.removed]
            adds = snap.added.get(gid)
            if adds:
                # insertion order IS store-append order (apply_pod's
                # member-order contract) — matching group_pods' input
                # order without sorting
                members.extend(adds.values())
            if not members:
                continue         # emptied class: row drops whole
            rep = members[0]
            if priority_of(rep) != snap.band:
                return "order"   # band flip rides the walk
            groups.append(members)
            keys.append(group_order_key(rep))
            src_rows.append(None)
        else:
            groups.append(g)
            keys.append(snap.order_keys[i])
            src_rows.append(i)
    for i in range(1, len(keys)):
        if not keys[i - 1] > keys[i]:
            return "order"       # strict (size, name) descending broken
    if m < 0:
        m = len(groups)
    reuse = src_rows[m:]
    return groups, m, reuse
