"""Host-side tensor encoding of a scheduling problem.

Turns a `ScheduleInput` into dense numpy arrays for the device kernel:

  columns  [O]    one per (nodepool, instance type, zone, capacity-type)
                  offering, ordered by nodepool priority (weight desc) —
                  column order IS pool preference order
  groups   [G]    pod equivalence classes in FFD order (size desc)
  group_mask [G,O]  label/taint compatibility of a group's pods with each
                  column (vectorized over the interned label vocabulary —
                  the Python set algebra runs once per (group × key), not
                  per (group × column))
  exist_cap [G,E]   per-existing-node pod allowance (0 = blocked; also
                  carries hostname-spread / anti-affinity per-node caps)
  + capacity/price/limit arrays

The encoding is cached against the instance-type list identity and catalog
seqnums by the caller; only group/existing arrays change call to call.

The port's copy of `karpenter_tpu/solver/encode.py` for the single-problem
solve and the consolidation sweep: host numpy, with the grouping on the
native fast path when `karpenter_tpu_torch.native` loads it.  `SharedExistEncoding` and `SweepTopologyTables` are
the sweep's per-batch caches of the shared cluster snapshot.
`encode(..., split=True)` collects the groups the tensors cannot express
into `.residue` for the host oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import InstanceType, NodePool, Pod
from karpenter_tpu_torch.models.requirements import Requirements
from karpenter_tpu_torch.models.resources import RESOURCE_AXIS, Resources
from karpenter_tpu_torch.models.taints import tolerates_all
from karpenter_tpu_torch.scheduling.topology import TopologyTracker, node_domains_for
from karpenter_tpu_torch.solver.explain import EPS
from karpenter_tpu_torch.scheduling.types import (
    ExistingNode,
    ScheduleInput,
    effective_request,
    gang_of,
    gang_trial_order,
    priority_of,
)

R = len(RESOURCE_AXIS)
_ABSENT = -1
BIG = 2 ** 29  # "unbounded" cap that still fits i32 arithmetic on device
D_BUCKETS = (2, 4, 8, 16, 32, 64, 128)
_DOM_KEYS = (wellknown.ZONE_LABEL, wellknown.CAPACITY_TYPE_LABEL)
_TOPO_KEYS = (wellknown.HOSTNAME_LABEL,) + _DOM_KEYS


class Unsupported(Exception):
    """A group's topology constraints can't be expressed in the tensor
    encoding (cross-group coupling, required pod affinity, custom topology
    keys) — the caller falls back to the CPU oracle."""


@dataclass
class Column:
    pool: str
    pool_idx: int
    type_name: str
    zone: str
    capacity_type: str
    price: float
    labels: Dict[str, str]
    allocatable: Resources
    instance_type: InstanceType


@dataclass
class EncodedProblem:
    # device inputs
    group_req: np.ndarray       # [G, R] f32 — effective per-pod request
    group_count: np.ndarray     # [G] i32
    group_mask: np.ndarray      # [G, O] bool
    exist_cap: np.ndarray       # [G, E] i32 — per-node allowance (0 = blocked)
    exist_remaining: np.ndarray # [E, R] f32
    col_alloc: np.ndarray       # [O, R] f32
    col_daemon: np.ndarray      # [O, R] f32 — pool daemonset overhead per column
    col_price: np.ndarray       # [O] f32
    col_pool: np.ndarray        # [O] i32
    pool_limit: np.ndarray      # [P, R] f32 (inf = unlimited)
    # topology tensors (see solver/ffd.py docstring)
    group_ncap: np.ndarray = None    # [G] i32 per-new-node cap
    group_dsel: np.ndarray = None    # [G] i32 0 none / 1 zone / 2 capacity-type
    group_dbase: np.ndarray = None   # [G, D] i32
    group_dcap: np.ndarray = None    # [G, D] i32
    group_skew: np.ndarray = None    # [G] i32
    group_mindom: np.ndarray = None  # [G] i32
    group_delig: np.ndarray = None   # [G, D] bool
    # [G] bool — hostname co-location seeding: ALL members must land on
    # one node.  Encode-time column/row fit enforces it against original
    # capacity; the post-solve whole-node repair (solve.py) strands the
    # group atomically if the dynamic fill still split it
    group_whole_node: np.ndarray = None
    # [G] bool — gang unit: atomic K-node, single-adjacency-
    # domain placement.  For gang groups, group_dsel names the adjacency
    # axis (1 zone/slice, 2 capacity-type/rack, 0 none) and group_dbase
    # carries the lexicographic domain trial RANK (gang_trial_order),
    # not spread base counts; skew/mindom/dcap stay inert.
    group_gang: np.ndarray = None
    # [G] i32 — effective priority per group.  The groups
    # list is already in band order (group_pods' host-side stable
    # re-sort, highest band first); this row is the kernel's witness
    # input (with_priority inversion aux) and decode's band map.
    group_priority: np.ndarray = None
    # [O] f32 — decode RANKING price (= col_price unless the spot-risk
    # objective is on; see CatalogEncoding.col_price_eff)
    col_price_eff: np.ndarray = None
    col_zone: np.ndarray = None      # [O] i32
    col_ct: np.ndarray = None        # [O] i32
    exist_zone: np.ndarray = None    # [E] i32
    exist_ct: np.ndarray = None      # [E] i32
    zone_values: List[str] = field(default_factory=list)  # id → zone
    ct_values: List[str] = field(default_factory=list)    # id → capacity type
    n_domains: int = 1
    # per group: static allowed-domain id sets (None = unrestricted) — folded
    # into the column masks for the solve AND into claim requirements at
    # decode, so launch can't drift into a statically-forbidden domain
    static_allowed: List[Dict[str, Optional[set]]] = field(default_factory=list)
    # split mode (encode(split=True)): groups whose constraints the tensor
    # encoding can't express, with the reason — solved host-side AFTER the
    # device solve instead of abandoning the whole batch
    residue: List[Tuple[List[Pod], str]] = field(default_factory=list)
    # placement provenance (solver/explain.py HOST_CONSTRAINTS): per
    # group, columns eliminated by [compat mask, price cap] — filled by
    # the solver's _encode_checked when KARPENTER_TPU_EXPLAIN is armed
    # (the cap is folded into group_mask before the kernel ever sees it,
    # so the split must be taken host-side)
    explain_host: Optional[np.ndarray] = None   # [G, 2] i64
    # the price cap that was folded into group_mask (None = uncapped) —
    # the explainer's price nearest-miss needs the value back out
    explain_price_cap: Optional[float] = None
    # host metadata for decode
    groups: List[List[Pod]] = field(default_factory=list)
    columns: List[Column] = field(default_factory=list)
    existing: List[ExistingNode] = field(default_factory=list)
    pools: List[NodePool] = field(default_factory=list)
    merged_reqs: List[List[Optional[Requirements]]] = field(default_factory=list)  # [G][P]

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_columns(self) -> int:
        return len(self.columns)


class _Vocab:
    """Interns label strings per key into dense int arrays."""

    def __init__(self) -> None:
        self._ids: Dict[str, Dict[str, int]] = {}
        self._rev_cache: Dict[str, Dict[int, str]] = {}

    def id(self, key: str, value: str) -> int:
        vals = self._ids.setdefault(key, {})
        out = vals.get(value)
        if out is None:
            out = len(vals)
            vals[value] = out
            self._rev_cache.pop(key, None)
        return out

    def lookup(self, key: str, value: str) -> int:
        return self._ids.get(key, {}).get(value, _ABSENT - 1)  # never matches

    def reverse(self, key: str) -> Dict[int, str]:
        rev = self._rev_cache.get(key)
        if rev is None:
            rev = {i: v for v, i in self._ids.get(key, {}).items()}
            self._rev_cache[key] = rev
        return rev


def _label_matrix(
    vocab: _Vocab, keys: Sequence[str], label_dicts: Sequence[Dict[str, str]]
) -> Dict[str, np.ndarray]:
    out = {}
    for key in keys:
        out[key] = np.array(
            [vocab.id(key, d[key]) if key in d else _ABSENT for d in label_dicts],
            dtype=np.int32,
        )
    return out


def _eval_requirements(
    reqs: Requirements,
    vocab: _Vocab,
    matrices: Dict[str, np.ndarray],
    n: int,
) -> np.ndarray:
    """Vectorized `matched_by_labels` over n label-dicts (closed world)."""
    ok = np.ones(n, dtype=bool)
    for req in reqs:
        vals = matrices.get(req.key)
        if vals is None:
            # key absent from every candidate
            if not req.matches_absent():
                return np.zeros(n, dtype=bool)
            continue
        absent = vals == _ABSENT
        if req.is_finite():
            allowed = np.array(
                sorted(vocab.lookup(req.key, v) for v in req.values()),
                dtype=np.int32,
            )
            match = np.isin(vals, allowed)
        else:
            # complement / bounds: evaluate per distinct id (few)
            ids = np.unique(vals[~absent])
            rev = vocab.reverse(req.key)
            good = np.array(
                [i for i in ids if i in rev and req.matches(rev[i])],
                dtype=np.int32,
            )
            match = np.isin(vals, good)
        if req.matches_absent():
            match = match | absent
        else:
            match = match & ~absent
        ok &= match
    return ok


def exist_group_ok(rep: Pod, vocab: "_Vocab",
                   matrices: Dict[str, np.ndarray],
                   existing: Sequence[ExistingNode]) -> np.ndarray:
    """Per-existing-node eligibility verdict for one pod class:
    requirements-matched ∧ not-deleting ∧ ready ∧ taints-tolerated.
    ONE definition shared by encode()'s per-group loop and the delta
    path's re-encode of a changed group (solver/delta.py) — the delta
    contract is bit-parity with a full re-solve, so the two must never
    drift."""
    ok = _eval_requirements(rep.requirements, vocab, matrices,
                            len(existing))
    for ei, en in enumerate(existing):
        if not ok[ei]:
            continue
        node = en.node
        if node.meta.deleting or not node.ready:
            ok[ei] = False
        elif not tolerates_all(node.taints, rep.tolerations):
            ok[ei] = False
    return ok


def group_pods(pods: List[Pod]) -> List[List[Pod]]:
    """Equivalence classes in FFD order (size desc, then name for stability),
    then stably re-sorted into priority bands.

    The C++ fast path (`native/hostops.cc` `group_pods`, loaded by
    `karpenter_tpu_torch.native`) carries the identical contract; at 50k
    pods the Python loop costs more than the device solve.
    `group_pods_py` is the fallback and the differential-test oracle."""
    from karpenter_tpu_torch.native import hostops
    native = hostops()
    groups = (native.group_pods(pods) if native is not None
              else group_pods_py(pods))
    return _priority_band_sort(groups)


def _priority_band_sort(groups: List[List[Pod]]) -> List[List[Pod]]:
    """Stable re-sort of equivalence classes into strict priority-band
    order, highest band first: the kernel scans groups in
    list order, so putting a band's groups first IS the packing policy —
    higher bands consume existing capacity, pool limits, and node slots
    before lower bands see them.  Applied AFTER either grouping path
    (native or Python) as a host-side post-pass: the stable sort keeps
    the FFD order (size desc, name) intact WITHIN each band, and an
    all-one-band problem (every effective priority equal — the
    priority-free common case) comes back ordered exactly as it went in,
    preserving bit parity with the pre-priority pipeline.  Groups are
    priority-homogeneous by construction (the effective priority joins
    the scheduling key)."""
    prios = [priority_of(g[0]) for g in groups]
    if len(set(prios)) <= 1:
        return groups
    order = sorted(range(len(groups)), key=lambda i: -prios[i])
    return [groups[i] for i in order]


def group_order_key(rep: Pod) -> tuple:
    """The FFD ordering key of one equivalence class, read off its
    representative: size descending with the representative's name as
    the deterministic tiebreak.  The ONE definition shared by the
    grouping sort below, the native fast path's contract, and the
    event-driven index (solver/incr.py) — the index proves the order
    invariant by comparing these keys, so a private copy drifting in
    either place would let an out-of-order group list engage the
    seeded replay."""
    return (rep.requests.sort_key(), rep.meta.name)


def group_pods_py(pods: List[Pod]) -> List[List[Pod]]:
    byid: Dict[int, List[Pod]] = {}
    for pod in pods:
        byid.setdefault(pod.scheduling_group_id(), []).append(pod)
    groups = list(byid.values())
    # members keep INPUT order (deterministic: both solver paths group the
    # same list, and pods within a class are interchangeable) — the old
    # per-member name sort was ~40% of grouping cost at 50k pods for a
    # purely cosmetic ordering
    groups.sort(key=lambda g: group_order_key(g[0]), reverse=True)
    return groups


@dataclass
class CatalogEncoding:
    """The catalog-side (per-call-invariant) half of the encoding: columns,
    interned label matrices, and capacity/price arrays. Cached by the solver
    across calls — it only changes when the instance-type provider's seqnum
    discipline hands out a new list (SURVEY §7 step 2: uploaded once per
    change, not per call)."""
    pools: List[NodePool]
    columns: List[Column]
    vocab: _Vocab
    col_matrices: Dict[str, np.ndarray]
    col_alloc: np.ndarray
    col_daemon: np.ndarray
    col_price: np.ndarray
    col_pool: np.ndarray
    pool_daemon: np.ndarray
    templates: List[Requirements]
    # per pool: column index array, per-key sliced label matrices, and the
    # set of keys its columns actually provide (non-absent somewhere)
    pool_cols: List[np.ndarray] = field(default_factory=list)
    pool_matrices: List[Dict[str, np.ndarray]] = field(default_factory=list)
    pool_provides: List[set] = field(default_factory=list)
    # topology domain interning (zone / capacity-type → dense id)
    zone_ids: Dict[str, int] = field(default_factory=dict)
    ct_ids: Dict[str, int] = field(default_factory=dict)
    col_zone: np.ndarray = None  # [O] i32
    col_ct: np.ndarray = None    # [O] i32
    # capacity dedup: allocatable varies only per (pool, instance type) —
    # the column axis is a fixed-stride grid of ZC (zone, capacity-type)
    # pairs per (pool,type) block, so the kernel's fit math runs at
    # [N,PT] (= [N,O/ZC]) via pure reshapes. Grid combos with no
    # available offering are masked out by col_valid.
    zc: int = 1                  # grid stride (len of the zone×ct grid)
    pt_alloc: np.ndarray = None  # [PT, R] f32 (PT = O // zc)
    col_valid: np.ndarray = None # [O] bool
    # [O] f32 — the RANKING price: equal to col_price unless
    # the KARPENTER_TPU_SPOT_RISK objective is on, in which case spot
    # columns carry price*(1+λ·p_interrupt) (scheduling/risk.py).  A
    # ranking key ONLY — col_price, Column.price, claims, and the ledger
    # always keep the real offering price.  Cache-safe: risk.model_key()
    # joins the solver's catalog-encoding cache key, so an interruption
    # observation rebuilds this encoding rather than mutating it.
    col_price_eff: np.ndarray = None
    # real offerings / grid columns — how much of the column axis is
    # masked-out inflation; layout is "grid" or "dense" (the fallback)
    fill_factor: float = 1.0
    layout: str = "grid"
    device_args: Optional[dict] = None  # device-resident padded arrays
    # under a mesh: the column-sharded catalog (device_args is then its
    # full-width view) and the resident group-mask row table
    mesh_args: Optional[object] = None
    mask_registry: Optional[object] = None


def encode_catalog(inp: ScheduleInput) -> CatalogEncoding:
    """Column layout is a FIXED-STRIDE grid: for every (pool, type) block,
    one column per (zone, capacity-type) pair of the global grid, in grid
    order — combos with no available offering become masked-out columns
    (col_valid False, price inf) instead of being skipped. The uniform
    stride ZC is what lets the kernel run its capacity math at (pool,type)
    granularity with pure reshapes (no scatter/segment ops): allocatable
    only varies per type, so zones × capacity-types were repeating the
    same fit computation ~ZC times."""
    pools = sorted(inp.nodepools, key=lambda np_: (-np_.weight, np_.meta.name))
    vocab = _Vocab()
    zc_pairs = sorted({
        (o.zone, o.capacity_type)
        for p in pools for it in inp.instance_types.get(p.name, [])
        for o in it.offerings})
    # grid fill factor: the global (zone, ct) pair set replicates per
    # (pool,type) block, so zone-disjoint pools / capacity-type-disjoint
    # types inflate O with masked-out columns (ADVICE r3). When the grid
    # would be mostly dead, fall back to a DENSE layout — one column per
    # real offering, zc=1 — which keeps every downstream reshape valid
    # (PT == O) at the cost of per-column instead of per-block fit math.
    n_blocks = sum(len(inp.instance_types.get(p.name, [])) for p in pools)
    n_real = sum(len(it.offerings)
                 for p in pools for it in inp.instance_types.get(p.name, []))
    grid_cols = n_blocks * max(len(zc_pairs), 1)
    fill = (n_real / grid_cols) if grid_cols else 1.0
    dense = grid_cols > 512 and fill < 0.5
    columns: List[Column] = []
    col_valid_list: List[bool] = []
    for pidx, pool in enumerate(pools):
        for it in inp.instance_types.get(pool.name, []):
            base_labels: Dict[str, str] = {}
            for req in it.requirements:
                if req.is_finite() and len(req.values()) == 1:
                    (base_labels[req.key],) = req.values()
            offmap = {(o.zone, o.capacity_type): o for o in it.offerings}
            alloc = it.allocatable()
            pairs = (sorted(offmap) if dense else zc_pairs)
            for zone, ct in pairs:
                o = offmap.get((zone, ct))
                labels = dict(base_labels)
                labels[wellknown.ZONE_LABEL] = zone
                labels[wellknown.CAPACITY_TYPE_LABEL] = ct
                labels[wellknown.NODEPOOL_LABEL] = pool.name
                labels.update(pool.labels)
                columns.append(Column(
                    pool=pool.name, pool_idx=pidx, type_name=it.name,
                    zone=zone, capacity_type=ct,
                    price=(o.price if o is not None else float("inf")),
                    labels=labels, allocatable=alloc,
                    instance_type=it,
                ))
                col_valid_list.append(o is not None and o.available)
    col_keys = sorted({k for c in columns for k in c.labels})
    col_matrices = _label_matrix(vocab, col_keys, [c.labels for c in columns])
    O = len(columns)
    col_alloc = np.array([c.allocatable.v for c in columns],
                         dtype=np.float32).reshape(O, R)
    col_daemon = np.zeros((O, R), dtype=np.float32)
    for ci, c in enumerate(columns):
        d = inp.daemon_overhead.get(c.pool)
        if d is not None:
            col_daemon[ci] = np.array(d.v, dtype=np.float32)
    col_price = np.array([c.price for c in columns], dtype=np.float32)
    from karpenter_tpu_torch.utils.knobs import spot_risk_enabled
    if spot_risk_enabled():
        from karpenter_tpu_torch.scheduling import risk
        col_price_eff = np.array(
            [risk.effective_price(c.price, c.type_name, c.zone,
                                  c.capacity_type)
             for c in columns], dtype=np.float32)
    else:
        col_price_eff = col_price
    col_pool = np.array([c.pool_idx for c in columns], dtype=np.int32)
    pool_daemon = np.stack([
        np.array(inp.daemon_overhead.get(p.name, Resources()).v, dtype=np.float32)
        for p in pools]) if pools else np.zeros((1, R), np.float32)
    pool_cols, pool_matrices, pool_provides = [], [], []
    for pidx in range(len(pools)):
        sel = np.nonzero(col_pool == pidx)[0]
        sliced = {k: v[sel] for k, v in col_matrices.items()}
        pool_cols.append(sel)
        pool_matrices.append(sliced)
        pool_provides.append({k for k, v in sliced.items() if (v != _ABSENT).any()})
    zone_ids: Dict[str, int] = {}
    ct_ids: Dict[str, int] = {}
    for c in columns:
        zone_ids.setdefault(c.zone, len(zone_ids))
        ct_ids.setdefault(c.capacity_type, len(ct_ids))
    col_zone = np.array([zone_ids[c.zone] for c in columns], dtype=np.int32)
    col_ct = np.array([ct_ids[c.capacity_type] for c in columns], dtype=np.int32)
    zc = 1 if dense else max(len(zc_pairs), 1)
    pt_alloc = (col_alloc[::zc].copy() if O
                else np.zeros((0, R), dtype=np.float32))
    col_valid = np.array(col_valid_list, dtype=bool)
    return CatalogEncoding(
        pools=pools, columns=columns, vocab=vocab, col_matrices=col_matrices,
        col_alloc=col_alloc, col_daemon=col_daemon, col_price=col_price,
        col_pool=col_pool, pool_daemon=pool_daemon,
        templates=[p.template_requirements() for p in pools],
        pool_cols=pool_cols, pool_matrices=pool_matrices,
        pool_provides=pool_provides,
        zone_ids=zone_ids, ct_ids=ct_ids, col_zone=col_zone, col_ct=col_ct,
        zc=zc, pt_alloc=pt_alloc, col_valid=col_valid,
        col_price_eff=col_price_eff,
        fill_factor=round(fill, 4), layout=("dense" if dense else "grid"),
    )


def _matches(sel: Dict[str, str], labels: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in sel.items())


def _has_required_anti(pods) -> bool:
    """Whether any resident pod's required anti-affinity can constrain
    pending pods (the only way existing state constrains otherwise-
    unconstrained pods — the k8s symmetry rule). ONE definition shared by
    the union cache, its divergent-wrapper fallback, and the per-sim
    topology encoder: these must never disagree."""
    return any(t.required and t.anti
               for p in pods for t in p.pod_affinities)


class SharedExistEncoding:
    """Union cache of existing-node encodings for ONE solve_batch call.

    The consolidation sweep encodes ~N
    near-identical node sets N times — at 2k candidates × 2k nodes the
    per-simulation label interning and per-node Python checks dominate
    the whole sweep (profiled: ~85% of wall-clock). Everything determined
    by the Node object alone — label matrices, readiness, zone/ct ids,
    per-group requirement+toleration verdicts — is computed once over
    the union of nodes and gathered per simulation by row index.

    Sound only within one batch: TorchSolver.solve_batch's contract is
    that all inputs come from the same cluster snapshot, so a node
    object's labels/taints/readiness — and its resident-pod set, which
    the required-anti activity check reads — are fixed for the batch.
    """

    def __init__(self, cat: "CatalogEncoding"):
        self._index: Dict[int, int] = {}
        # strong refs: id() keys stay unambiguous while the cache lives
        self._nodes: List = []
        self._wrappers: List[ExistingNode] = []
        self._res_anti: List[bool] = []
        self.zone_ids = dict(cat.zone_ids)
        self.ct_ids = dict(cat.ct_ids)
        self._frozen = False

    def add_input(self, inp: ScheduleInput) -> None:
        self.add_nodes(inp.existing_nodes)

    def add_nodes(self, existing: Sequence[ExistingNode]) -> None:
        """Register wrappers directly — the sweep path seeds the cache
        from the shared snapshot list (ScheduleInput.exist_base) instead
        of per-input node sets, so union row i == snapshot row i."""
        assert not self._frozen
        for en in existing:
            node = en.node
            if id(node) in self._index:
                continue
            # identity-keyed row lookup, never iterated: row order is
            # add_nodes() call order (the shared snapshot's), so
            # addresses cannot order anything
            self._index[id(node)] = len(self._nodes)
            self._nodes.append(node)
            self._wrappers.append(en)
            self._res_anti.append(_has_required_anti(en.pods))

    def freeze(self) -> None:
        if self._frozen:
            return
        self._frozen = True
        nodes = self._nodes
        self.vocab = _Vocab()
        keys = sorted({k for n in nodes for k in n.labels})
        self.matrices = _label_matrix(
            self.vocab, keys, [n.labels for n in nodes])
        self.usable = np.array(
            [not n.meta.deleting and n.ready for n in nodes], dtype=bool)
        for n in nodes:
            z = n.labels.get(wellknown.ZONE_LABEL)
            if z is not None:
                self.zone_ids.setdefault(z, len(self.zone_ids))
            t = n.labels.get(wellknown.CAPACITY_TYPE_LABEL)
            if t is not None:
                self.ct_ids.setdefault(t, len(self.ct_ids))
        self.zone = np.array(
            [self.zone_ids.get(n.labels.get(wellknown.ZONE_LABEL), -1)
             for n in nodes], dtype=np.int32)
        self.ct = np.array(
            [self.ct_ids.get(n.labels.get(wellknown.CAPACITY_TYPE_LABEL), -1)
             for n in nodes], dtype=np.int32)
        self.res_anti = np.array(self._res_anti, dtype=bool)
        # nodes with taints are rare; only they need the per-group loop
        self._tainted = [i for i, n in enumerate(nodes) if n.taints]
        self._group_ok: Dict[int, np.ndarray] = {}
        # available-capacity rows keyed by the WRAPPER seen at add time:
        # sims that share ExistingNode objects (the sweep's common case)
        # skip the 2k-row nested-list conversion; a sim carrying a fresh
        # wrapper for a known node gets its row rebuilt from its own
        # values, so a differing snapshot can never be silently shadowed
        self._avail = np.array([en.available.v for en in self._wrappers],
                               dtype=np.float32).reshape(len(nodes), R)
        self._wrapper_id = [id(en) for en in self._wrappers]

    def exist_remaining(self, existing: Sequence[ExistingNode],
                        rows: np.ndarray) -> np.ndarray:
        out = self._avail[rows]
        wid = self._wrapper_id
        for j, en in enumerate(existing):
            if id(en) != wid[rows[j]]:
                out[j] = en.available.v
        return out

    def res_anti_any(self, existing: Sequence[ExistingNode],
                     rows: np.ndarray) -> bool:
        """Whether any resident pod carries required anti-affinity — with
        the same wrapper-divergence guard as exist_remaining: a sim whose
        fresh wrapper carries a different resident set than the snapshot
        must be judged on ITS pods, not the cached flag."""
        wid = self._wrapper_id
        for j, en in enumerate(existing):
            if id(en) == wid[rows[j]]:
                if self.res_anti[rows[j]]:
                    return True
            elif _has_required_anti(en.pods):
                return True
        return False

    def rows(self, existing: Sequence[ExistingNode]) -> np.ndarray:
        """Union row index per ExistingNode (identity-keyed on .node)."""
        # identity-keyed lookup in caller-supplied order — see add_nodes
        return np.fromiter((self._index[id(en.node)] for en in existing),
                           dtype=np.int64, count=len(existing))

    def group_ok(self, rep: Pod) -> np.ndarray:
        """Usable ∧ requirements-matched ∧ taints-tolerated over the
        union, cached per pod equivalence class."""
        gid = rep.scheduling_group_id()
        ok = self._group_ok.get(gid)
        if ok is None:
            ok = _eval_requirements(rep.requirements, self.vocab,
                                    self.matrices, len(self._nodes))
            ok = ok & self.usable
            for i in self._tainted:
                if ok[i] and not tolerates_all(self._nodes[i].taints,
                                               rep.tolerations):
                    ok[i] = False
            self._group_ok[gid] = ok
        return ok


class SweepTopologyTables:
    """Per-class topology tables for the consolidation sweep's HEAVY lane.

    The sweep's whole point is that per-simulation host work stays O(pods),
    never O(cluster): the shared snapshot's per-node facts upload once.
    Topology-constrained pods used to hole out to the generic batched path
    (paying the per-sim [E,*] encode the sweep exists to kill); this class
    precomputes, ONCE per sweep, everything their kernel tensors need —
    per-(selector, key) per-node matching-resident counts, per-class
    hostname clamps, eligible-domain masks — so a simulation's dynamic
    tensors (dbase/dcap after ITS exclusions) are O(X) arithmetic.

    Supported per-class shapes mirror the kernel's dynamic machinery
    (_solve_ffd_impl's heavy branch): at most ONE dynamic self-matching
    zone/capacity-type term (DoNotSchedule spread with maxSkew/minDomains,
    or required anti-affinity), plus self-matching hostname spread/anti as
    ncap + per-node clamps.  Everything else raises `Unsupported` and the
    simulation stays a hole for the generic path: non-self-match selectors
    (static allowed-set math), required co-location (seed pin needs
    per-sim state), preferences (host relaxation ladder).
    """

    def __init__(self, base: Sequence, zone_arr: np.ndarray,
                 ct_arr: np.ndarray, zone_ids: Dict[str, int],
                 ct_ids: Dict[str, int]):
        self.base = base
        self.zone_arr = zone_arr          # [E] zone id per snapshot node
        self.ct_arr = ct_arr              # [E] ct id per snapshot node
        self.zone_ids = zone_ids
        self.ct_ids = ct_ids
        self.D = max(len(zone_ids), len(ct_ids), 1)
        self.E = len(base)
        self._counts: Dict[tuple, np.ndarray] = {}
        self._class_topo: Dict[int, dict] = {}
        # resident required-anti index (ONE scan): (key, selector) →
        # [E] bool, node holds a resident whose required anti-affinity
        # carries that (key, selector).  Classes matched by a selector
        # get those nodes'/domains' placements blocked (the oracle's
        # symmetric_anti_blocked_domains, sweep-shaped) — without this,
        # one anti-affinity pod anywhere in the cluster would disable
        # the whole sweep.
        self._res_anti: Dict[tuple, np.ndarray] = {}
        for ei, en in enumerate(base):
            for p in en.pods:
                for t in p.pod_affinities:
                    if not (t.required and t.anti):
                        continue
                    k = (t.topology_key,
                         tuple(sorted(t.label_selector.items())))
                    flags = self._res_anti.get(k)
                    if flags is None:
                        flags = np.zeros(self.E, dtype=bool)
                        self._res_anti[k] = flags
                    flags[ei] = True

    def counts_per_node(self, selector: Dict[str, str]) -> np.ndarray:
        """Matching resident pods per snapshot node ([E] i32), cached per
        selector — the one O(cluster) scan, paid once per distinct
        selector per sweep."""
        key = tuple(sorted(selector.items()))
        out = self._counts.get(key)
        if out is None:
            out = np.zeros(self.E, dtype=np.int32)
            for ei, en in enumerate(self.base):
                out[ei] = sum(1 for p in en.pods
                              if _matches(selector, p.meta.labels))
            self._counts[key] = out
        return out

    def _dom_total(self, counts: np.ndarray, dom_arr: np.ndarray) -> np.ndarray:
        total = np.zeros(self.D, dtype=np.int32)
        valid = dom_arr >= 0
        np.add.at(total, dom_arr[valid], counts[valid])
        return total

    def class_topo(self, rep: Pod) -> dict:
        """Class-level topology info (cached): static parts of the kernel
        tensors plus the per-node count arrays the per-sim math needs.
        Raises Unsupported for shapes the sweep can't express."""
        gid = rep.scheduling_group_id()
        info = self._class_topo.get(gid)
        if info is not None:
            if isinstance(info, Unsupported):
                raise info
            return info
        try:
            info = self._build_class_topo(rep)
        except Unsupported as e:
            self._class_topo[gid] = e
            raise
        self._class_topo[gid] = info
        return info

    def _build_class_topo(self, rep: Pod) -> dict:
        my = rep.meta.labels
        ncap = BIG
        hostcap = np.full(self.E, BIG, dtype=np.int32)
        dyn = None  # (key, dsel, anti flag, selector, skew, mindom)

        def set_dyn(key, anti, sel, skew=BIG, mindom=0):
            nonlocal dyn
            if dyn is not None:
                raise Unsupported("multiple dynamic topology terms")
            dsel = 1 if key == wellknown.ZONE_LABEL else 2
            dyn = dict(key=key, dsel=dsel, anti=anti, selector=dict(sel),
                       skew=skew, mindom=mindom)

        for c in rep.topology_spread:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue  # best-effort never blocks (encoder parity)
            key = c.topology_key
            if key not in _TOPO_KEYS:
                raise Unsupported(f"spread topology key {key}")
            if not _matches(c.label_selector, my):
                raise Unsupported("non-self-match spread in sweep")
            counts = self.counts_per_node(c.label_selector)
            if key == wellknown.HOSTNAME_LABEL:
                ncap = min(ncap, c.max_skew)
                hostcap = np.minimum(hostcap,
                                     np.maximum(c.max_skew - counts, 0))
            else:
                set_dyn(key, False, c.label_selector, skew=c.max_skew,
                        mindom=c.min_domains or 0)
        for t in rep.pod_affinities:
            if not t.required:
                continue
            if not t.anti:
                raise Unsupported("required co-location in sweep")
            key = t.topology_key
            if key not in _TOPO_KEYS:
                raise Unsupported(f"affinity topology key {key}")
            if not _matches(t.label_selector, my):
                raise Unsupported("non-self-match anti in sweep")
            counts = self.counts_per_node(t.label_selector)
            if key == wellknown.HOSTNAME_LABEL:
                ncap = min(ncap, 1)
                hostcap = np.minimum(hostcap, np.maximum(1 - counts, 0))
            else:
                set_dyn(key, True, t.label_selector)

        # symmetric anti: resident required-anti terms whose selector
        # matches THIS class block the holding node (hostname key) or the
        # holding node's domain (zone/ct key) — per-sim, because an
        # excluded node's residents stop blocking
        sym_key = None
        sym_flags = None
        for (key, sel_t), flags in self._res_anti.items():
            if not _matches(dict(sel_t), my):
                continue
            if key == wellknown.HOSTNAME_LABEL:
                hostcap = np.where(flags, 0, hostcap).astype(np.int32)
            elif key in _DOM_KEYS:
                if sym_key is not None and sym_key != key:
                    raise Unsupported(
                        "symmetric anti on two domain keys")
                sym_key = key
                sym_flags = (flags if sym_flags is None
                             else (sym_flags | flags))
            else:
                raise Unsupported(f"symmetric anti-affinity on {key}")
        if sym_key is not None:
            if dyn is None:
                # borrow the dynamic slot: dcap 0 on blocked domains,
                # skew unbounded — pure domain blocking
                set_dyn(sym_key, True, {})
                dyn["counts"] = np.zeros(self.E, dtype=np.int32)
                dyn["sym_only"] = True
            elif dyn["key"] != sym_key:
                raise Unsupported(
                    "symmetric anti key differs from dynamic key")
            dyn["sym_flags"] = sym_flags

        delig = np.zeros(self.D, dtype=bool)
        dsel = 0
        if dyn is not None:
            dsel = dyn["dsel"]
            ids = (self.zone_ids if dyn["dsel"] == 1 else self.ct_ids)
            req = rep.requirements.get(dyn["key"])
            for d, i in ids.items():
                if req is None or req.matches(d):
                    delig[i] = True
            dom_arr = self.zone_arr if dyn["dsel"] == 1 else self.ct_arr
            if "counts" not in dyn:
                dyn["counts"] = self.counts_per_node(dyn["selector"])
            dyn["dom_total"] = self._dom_total(dyn["counts"], dom_arr)
            dyn["dom_arr"] = dom_arr
            if dyn.get("sym_flags") is not None:
                dyn["sym_idx"] = np.nonzero(dyn["sym_flags"])[0]
        return dict(ncap=ncap, hostcap=hostcap, dyn=dyn, dsel=dsel,
                    delig=delig)

    def sim_tensors(self, info: dict, excl: Sequence[int]):
        """(dbase, dcap) for ONE simulation: the class totals minus the
        excluded nodes' contributions, plus symmetric-anti domain
        blocking over the KEPT flagged nodes — O(X + flagged), never
        O(E)."""
        dbase = np.zeros(self.D, dtype=np.int32)
        dcap = np.full(self.D, BIG, dtype=np.int32)
        dyn = info["dyn"]
        if dyn is None:
            return dbase, dcap
        after = dyn["dom_total"].copy()
        for e in excl:
            if 0 <= e < self.E:
                d = dyn["dom_arr"][e]
                if d >= 0:
                    after[d] -= dyn["counts"][e]
        if dyn.get("sym_only"):
            pass  # pure symmetric blocking: no own-term counts
        elif dyn["anti"]:
            # at most one matching pod per domain (encoder parity:
            # dcap = 1 - counts, dbase untouched)
            dcap = np.maximum(1 - after, 0).astype(np.int32)
        else:
            dbase = after
        if dyn.get("sym_flags") is not None:
            excl_set = set(int(e) for e in excl)
            for e in dyn["sym_idx"]:
                if int(e) not in excl_set:
                    d = dyn["dom_arr"][e]
                    if d >= 0:
                        dcap[d] = 0
        return dbase, dcap


class _TopologyEncoder:
    """Classifies each group's spread / (anti-)affinity constraints and
    produces the kernel's topology tensors; raises `Unsupported` for shapes
    the tensor encoding can't express — custom topology keys, hostname
    co-location seeding, and selectors that couple pending groups (their
    counts would change with other groups' placements mid-solve) — so the
    caller falls back to the CPU oracle.  Required pod affinity on
    zone/capacity-type encodes as static domain restrictions (populated
    domains, or a host-side seed pin for the self-selector first-placement
    case). Mirrors scheduling/topology.py; reference surface:
    website/content/en/preview/concepts/scheduling.md:209-417.
    """

    def __init__(self, inp: ScheduleInput, cat: "CatalogEncoding",
                 groups: List[List[Pod]], split_mode: bool = False,
                 shared: Optional[SharedExistEncoding] = None,
                 shared_rows: Optional[np.ndarray] = None):
        # split mode: groups that raise Unsupported become host-side
        # residue solved AFTER the device solve, so the victim-side
        # coupling check (another pending group's anti matching this one)
        # can be skipped — the anti's OWNER always lands in the residue
        # (its own selector-couples-pending check fires), and the oracle
        # registers the device placements before placing it, which
        # enforces the symmetry.
        self.split_mode = split_mode
        self.cat = cat  # for the seed-domain pick (column prices)
        self.dense_layout = cat.layout == "dense"
        # seeding the tracker walks every resident pod — skip it entirely
        # when no pending pod carries a constraint and no resident pod
        # carries required anti-affinity (the only way existing state can
        # constrain unconstrained pods). This keeps consolidation's batched
        # per-candidate encodes O(pods), not O(cluster).
        has_constraints = any(
            g[0].topology_spread or g[0].pod_affinities for g in groups)
        if shared is not None:
            self.active = has_constraints or shared.res_anti_any(
                inp.existing_nodes, shared_rows)
        else:
            self.active = has_constraints or any(
                _has_required_anti(en.pods) for en in inp.existing_nodes)
        self.tracker = TopologyTracker()
        if self.active:
            for en in inp.existing_nodes:
                domains = node_domains_for(en.node.labels, en.node.name)
                for key, dom in domains.items():
                    self.tracker.observe_domains(key, {dom})
                for pod in en.pods:
                    self.tracker.register(pod, domains)
            self.tracker.observe_domains(
                wellknown.ZONE_LABEL, {c.zone for c in cat.columns})
            self.tracker.observe_domains(
                wellknown.CAPACITY_TYPE_LABEL,
                {c.capacity_type for c in cat.columns})
        # domain vocab: catalog ids first (stable across calls), existing-node
        # domains appended per call (union-wide when a batch cache is shared,
        # so every simulation in the batch agrees on D)
        self.existing = inp.existing_nodes
        if shared is not None:
            self.zone_ids = shared.zone_ids
            self.ct_ids = shared.ct_ids
            self.exist_zone = shared.zone[shared_rows]
            self.exist_ct = shared.ct[shared_rows]
        else:
            self.zone_ids = dict(cat.zone_ids)
            self.ct_ids = dict(cat.ct_ids)
            for en in inp.existing_nodes:
                z = en.node.labels.get(wellknown.ZONE_LABEL)
                if z is not None:
                    self.zone_ids.setdefault(z, len(self.zone_ids))
                t = en.node.labels.get(wellknown.CAPACITY_TYPE_LABEL)
                if t is not None:
                    self.ct_ids.setdefault(t, len(self.ct_ids))
            self.exist_zone = np.array(
                [self.zone_ids.get(en.node.labels.get(wellknown.ZONE_LABEL), -1)
                 for en in self.existing], dtype=np.int32).reshape(len(self.existing))
            self.exist_ct = np.array(
                [self.ct_ids.get(en.node.labels.get(wellknown.CAPACITY_TYPE_LABEL), -1)
                 for en in self.existing], dtype=np.int32).reshape(len(self.existing))
        self.group_labels = [g[0].meta.labels for g in groups]
        # gang units: per-group gang specs + the gang-name →
        # group-index map for the heterogeneous-gang check (two pod
        # classes sharing one gang name would break gang-level
        # atomicity in the per-group kernel — the oracle handles them)
        self.gangs = {}
        self._gang_groups: Dict[str, list] = {}
        for i, g in enumerate(groups):
            sp = gang_of(g[0])
            if sp is not None:
                self.gangs[i] = sp
                self._gang_groups.setdefault(sp.name, []).append(i)
        # gang names with members already BOUND on live nodes: their
        # pending remainder is a RESIDUAL placement (a recreated member
        # of a running gang) — completeness counts the bound members
        # and the ranks must join their domain, which the per-group
        # kernel unit can't express; _encode_gang routes these to the
        # oracle.  Only scanned when the problem has gangs at all.
        self._bound_gangs: set = set()
        if self.gangs:
            for en in self.existing:
                for p in en.pods:
                    bsp = gang_of(p)
                    if bsp is not None:
                        self._bound_gangs.add(bsp.name)
        self.D = max(len(self.zone_ids), len(self.ct_ids), 1)
        self._sel_cache: Dict[tuple, set] = {}
        # pending groups' required anti terms (for the symmetry coupling check)
        self.pending_anti: List[tuple] = [
            (i, dict(t.label_selector))
            for i, g in enumerate(groups)
            for t in g[0].pod_affinities if t.required and t.anti
        ]

    def _matching_groups(self, selector: Dict[str, str]) -> set:
        key = tuple(sorted(selector.items()))
        out = self._sel_cache.get(key)
        if out is None:
            out = {i for i, lbls in enumerate(self.group_labels)
                   if _matches(selector, lbls)}
            self._sel_cache[key] = out
        return out

    def _dom_ids(self, key: str) -> Dict[str, int]:
        return self.zone_ids if key == wellknown.ZONE_LABEL else self.ct_ids

    def _seed_domain(self, rep: Pod, key: str,
                     already_allowed: Optional[set]) -> Optional[str]:
        """The domain a self-matching required-affinity group seeds when
        no matching pod exists anywhere.  The oracle seeds wherever its
        first FFD placement lands — existing nodes first, then the
        cheapest new node — so prefer the domain with the most free
        existing CPU, tiebreak by cheapest compatible catalog column,
        then lexicographic for determinism.  A wrong pick can strand the
        group (capacity missing in the pinned domain); the solver's
        rescue path re-seeds those pods through the oracle."""
        ids = self._dom_ids(key)
        cand = set(ids)
        if already_allowed is not None:
            cand &= {d for d, i in ids.items() if i in already_allowed}
        elig = self.tracker.eligible_domains(rep, key)
        if elig:
            cand &= set(elig)
        if not cand:
            return None
        cap_by = {d: 0.0 for d in sorted(cand)}
        for en in self.existing:
            d = en.node.labels.get(key)
            if d in cap_by:
                cap_by[d] += max(float(en.available.get("cpu") or 0.0), 0.0)
        price_by = {d: float("inf") for d in sorted(cand)}
        gmask, _ = group_column_mask(self.cat, rep)
        for o_idx in np.nonzero(gmask)[0]:
            col = self.cat.columns[o_idx]
            d = (col.zone if key == wellknown.ZONE_LABEL
                 else col.capacity_type)
            if d in price_by and col.price < price_by[d]:
                price_by[d] = col.price
        return sorted(cand, key=lambda d: (-cap_by[d], price_by[d], d))[0]

    def _static_gmin(self, rep: Pod, key: str, counts, mindom) -> int:
        eligible = self.tracker.eligible_domains(rep, key)
        if not eligible:
            return 0
        gmin = min(counts.get(d, 0) for d in eligible)
        if mindom is not None:
            populated = sum(1 for d in eligible if counts.get(d, 0) > 0)
            if populated < mindom:
                gmin = 0
        return gmin

    def _encode_gang(self, gi: int, rep: Pod, spec) -> dict:
        """Gang-unit tensors: dsel names the adjacency axis,
        dbase the lexicographic domain trial rank (the SAME order the
        oracle's trial loop walks — scheduling.types.gang_trial_order),
        delig the domains the gang may try.  Everything else stays the
        inactive-encoder constants: the kernel's gang branch owns all
        fill-time restriction, so no static mask narrowing happens
        here.  Shapes the tensor encoding can't express atomically —
        gangs combined with other topology constraints, soft terms, or
        a gang spanning several pod classes — raise Unsupported and the
        gang rides the residue to the (gang-aware) oracle."""
        if rep.topology_spread or rep.pod_affinities or rep.preferences:
            raise Unsupported(
                "gang combined with topology/soft constraints")
        if len(self._gang_groups.get(spec.name, ())) > 1:
            raise Unsupported("gang spans multiple pod classes")
        if spec.name in self._bound_gangs:
            raise Unsupported("gang has bound members")
        E = len(self.existing)
        out = dict(
            ncap=BIG, ecap=np.full(E, BIG, dtype=np.int32), dsel=0,
            dbase=np.zeros(self.D, dtype=np.int32),
            dcap=np.full(self.D, BIG, dtype=np.int32), skew=BIG,
            mindom=0, delig=np.zeros(self.D, dtype=bool),
            allowed={k: None for k in _DOM_KEYS},
            requires={k: False for k in _DOM_KEYS},
            whole_node=False, gang=True)
        if spec.domain_key is None:
            # domain-free gang: one global trial domain (the kernel
            # maps every column/node to domain 0 when dsel == 0)
            out["delig"][0] = True
            return out
        if self.dense_layout:
            # the gang branch reads a column's domain from its grid
            # slot (ffd zc_dom), same invariant as dynamic spread
            raise Unsupported("gang adjacency on a dense catalog layout")
        out["dsel"] = 1 if spec.domain_key == wellknown.ZONE_LABEL else 2
        ids = self._dom_ids(spec.domain_key)
        req = rep.requirements.get(spec.domain_key)
        for pos, d in enumerate(gang_trial_order(ids)):
            i = ids[d]
            out["dbase"][i] = pos
            if req is None or req.matches(d):
                out["delig"][i] = True
        # no eligible domain ⇒ the kernel strands the gang whole
        # (GangDomainExhausted) — exactly the oracle's empty-trial-list
        # verdict, so no Unsupported here
        return out

    def encode_group(self, gi: int, rep: Pod) -> dict:
        spec = self.gangs.get(gi)
        if spec is not None:
            # gangs bypass the inactive-encoder fast path: their domain
            # tensors are needed even when no spread/affinity is active
            return self._encode_gang(gi, rep, spec)
        E = len(self.existing)
        if not self.active:
            return dict(
                ncap=BIG, ecap=np.full(E, BIG, dtype=np.int32), dsel=0,
                dbase=np.zeros(self.D, dtype=np.int32),
                dcap=np.full(self.D, BIG, dtype=np.int32), skew=BIG, mindom=0,
                delig=np.zeros(self.D, dtype=bool),
                allowed={k: None for k in _DOM_KEYS},
                requires={k: False for k in _DOM_KEYS},
                whole_node=False)
        ncap = BIG
        ecap = np.full(E, BIG, dtype=np.int32)
        whole_node = False
        allowed: Dict[str, Optional[set]] = {k: None for k in _DOM_KEYS}
        requires: Dict[str, bool] = {k: False for k in _DOM_KEYS}
        dyn_key: Optional[str] = None
        dbase = np.zeros(self.D, dtype=np.int32)
        dcap = np.full(self.D, BIG, dtype=np.int32)
        skew = BIG
        mindom = 0
        my = rep.meta.labels

        def clamp_hosts(cap_of_host):
            for ei, en in enumerate(self.existing):
                c = cap_of_host(en.node.name)
                if c < ecap[ei]:
                    ecap[ei] = max(int(c), 0)

        def restrict(key, dom_names: set):
            ids = self._dom_ids(key)
            sid = {ids[d] for d in dom_names if d in ids}
            allowed[key] = sid if allowed[key] is None else (allowed[key] & sid)

        for c in rep.topology_spread:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue  # ScheduleAnyway is best-effort, never blocks
            key = c.topology_key
            if key not in _TOPO_KEYS:
                raise Unsupported(f"spread topology key {key}")
            if self._matching_groups(c.label_selector) - {gi}:
                raise Unsupported("spread selector couples pending groups")
            self_match = _matches(c.label_selector, my)
            counts = self.tracker.counts_for(key, c.label_selector)
            if key == wellknown.HOSTNAME_LABEL:
                # a fresh hostname domain is always available, so the global
                # minimum is 0 and maxSkew is a per-node ceiling (slightly
                # conservative when every candidate node holds matching pods)
                if self_match:
                    ncap = min(ncap, c.max_skew)
                    clamp_hosts(lambda h: c.max_skew - counts.get(h, 0))
                else:
                    clamp_hosts(
                        lambda h: BIG if counts.get(h, 0) + 1 <= c.max_skew else 0)
            elif self_match:
                if dyn_key is not None and dyn_key != key:
                    raise Unsupported("two dynamic topology keys on one pod")
                if skew != BIG:
                    raise Unsupported("multiple dynamic spread constraints")
                dyn_key = key
                skew = c.max_skew
                mindom = c.min_domains or 0
                ids = self._dom_ids(key)
                for d, n in counts.items():
                    if d in ids:
                        dbase[ids[d]] = n
            else:
                # counts never change with this group's placements → the
                # allowed-domain set is static; fold it into the masks
                gmin = self._static_gmin(rep, key, counts, c.min_domains)
                ok = {d for d in self._dom_ids(key)
                      if counts.get(d, 0) + 1 - gmin <= c.max_skew}
                restrict(key, ok)
                requires[key] = True

        for t in rep.pod_affinities:
            if not t.required:
                continue  # preferred terms are not consumed (oracle parity)
            key = t.topology_key
            if key not in _TOPO_KEYS:
                raise Unsupported(f"affinity topology key {key}")
            if self._matching_groups(t.label_selector) - {gi}:
                raise Unsupported("affinity selector couples pending groups")
            self_match = _matches(t.label_selector, my)
            counts = self.tracker.counts_for(key, t.label_selector)
            if not t.anti:
                # required CO-LOCATION affinity (oracle:
                # topology.affinity_allowed_domains) — three shapes:
                #   populated domains exist → each member restricted to
                #     them (static: counts can't shrink mid-solve);
                #   none populated + self-matching → the group seeds ONE
                #     domain; the oracle seeds wherever its first FFD
                #     placement lands, the device path pre-pins the
                #     domain host-side (most free existing capacity,
                #     then cheapest compatible column);
                #   none populated + not self-matching → nothing is
                #     allowed (kube semantics), encoded as an empty
                #     domain restriction.
                populated = {d for d, n in counts.items() if n > 0}
                if key == wellknown.HOSTNAME_LABEL:
                    if populated:
                        # members must share a host with a match; fresh
                        # nodes have none, so new-node placement is off
                        ncap = 0
                        clamp_hosts(
                            lambda h: BIG if h in populated else 0)
                    elif self_match:
                        # all members on ONE node, fresh or existing:
                        # "exactly one node" is not a column-model
                        # concept, but "every candidate must hold the
                        # WHOLE group" is — flag it for the caller,
                        # which owns the column/row capacity math (the
                        # group count lives there).  Encode-time
                        # eligibility is against ORIGINAL capacity, so
                        # the fill can still split the group when an
                        # earlier group consumed an eligible node —
                        # the post-solve whole-node repair strands such
                        # groups atomically and the rescue hands them
                        # to the oracle (its seed-then-strand is the
                        # reference semantics).
                        whole_node = True
                    else:
                        # no populated host and the selector does NOT
                        # match the group itself: nothing satisfies the
                        # required term (kube semantics — same verdict
                        # as the zone/ct branch's restrict(key, set()))
                        ncap = 0
                        clamp_hosts(lambda h: 0)
                elif populated:
                    restrict(key, populated)
                    requires[key] = True
                elif self_match:
                    pin = self._seed_domain(rep, key, allowed[key])
                    restrict(key, {pin} if pin is not None else set())
                    requires[key] = True
                else:
                    restrict(key, set())
                    requires[key] = True
                continue
            if key == wellknown.HOSTNAME_LABEL:
                if self_match:
                    ncap = min(ncap, 1)
                    clamp_hosts(lambda h: 1 - counts.get(h, 0))
                else:
                    clamp_hosts(lambda h: 0 if counts.get(h, 0) else BIG)
            elif self_match:
                if dyn_key is not None and dyn_key != key:
                    raise Unsupported("two dynamic topology keys on one pod")
                dyn_key = key
                ids = self._dom_ids(key)
                for d, i in ids.items():
                    dcap[i] = min(int(dcap[i]), max(0, 1 - counts.get(d, 0)))
            else:
                blocked = {d for d, n in counts.items() if n > 0}
                restrict(key, set(self._dom_ids(key)) - blocked)
                requires[key] = True

        # symmetry: already-placed pods' required anti-affinity blocks this
        # group (oracle `_affinity_ok` tail); label-absent nodes pass
        for key in self.tracker.anti_topology_keys():
            blocked = self.tracker.symmetric_anti_blocked_domains(rep, key)
            if not blocked:
                continue
            if key == wellknown.HOSTNAME_LABEL:
                clamp_hosts(lambda h: 0 if h in blocked else BIG)
            elif key in _DOM_KEYS:
                if dyn_key == key:
                    ids = self._dom_ids(key)
                    for d in sorted(blocked):
                        if d in ids:
                            dcap[ids[d]] = 0
                else:
                    restrict(key, set(self._dom_ids(key)) - blocked)
            else:
                raise Unsupported(f"symmetric anti-affinity on {key}")
        # pending groups' anti terms matching this group couple dynamically
        if not self.split_mode:
            for gj, sel in self.pending_anti:
                if gj != gi and _matches(sel, my):
                    raise Unsupported("another pending group's anti-affinity "
                                      "matches this group")

        dsel = 0
        delig = np.zeros(self.D, dtype=bool)
        if dyn_key is not None:
            if self.dense_layout:
                # the kernel's heavy branch reads a column's domain from
                # its slot index (ffd.py zc_dom = col_dom[:zc], valid only
                # for the fixed-stride grid); the dense fallback breaks
                # that invariant, so domain-spread groups go to the oracle
                raise Unsupported(
                    "domain spread on a dense catalog layout")
            dsel = 1 if dyn_key == wellknown.ZONE_LABEL else 2
            ids = self._dom_ids(dyn_key)
            for d in self.tracker.eligible_domains(rep, dyn_key):
                if d in ids:
                    delig[ids[d]] = True
            if allowed[dyn_key] is not None:
                # statically-blocked domains stay in the skew minimum but
                # can't take placements
                for d, i in ids.items():
                    if i not in allowed[dyn_key]:
                        dcap[i] = 0
                allowed[dyn_key] = None
        if whole_node and dsel > 0:
            # the kernel's ALL-or-nothing fill lives in the light branch;
            # the heavy (domain-partitioned) branch's per-domain fills
            # would split the group and strand it wholesale — the host
            # oracle handles both constraints coherently instead
            raise Unsupported(
                "whole-node co-location combined with dynamic spread")
        return dict(ncap=ncap, ecap=ecap, dsel=dsel, dbase=dbase, dcap=dcap,
                    skew=skew, mindom=mindom, delig=delig,
                    allowed=allowed, requires=requires,
                    whole_node=whole_node)


def _np_fit_count(avail: np.ndarray, req: np.ndarray) -> np.ndarray:
    """Host mirror of the kernel's _fit_count (ffd.py:60): how many pods
    of per-pod request `req` [R] fit in `avail` [..., R].  Same EPS so a
    host-side whole-group-fit verdict never disagrees with the device
    fill."""
    safe = np.where(req > 0, req, 1.0)
    counts = np.floor((avail + EPS) / safe)
    counts = np.where(req > 0, counts, float(2 ** 30))
    return np.clip(counts.min(axis=-1), 0, 2 ** 30).astype(np.int64)


def group_column_mask(cat: "CatalogEncoding", rep: Pod):
    """Per-pod-class catalog column mask + per-pool merged requirements —
    a pure function of (catalog, pod class), shared by the per-problem
    encoder and the batched sweep path (which caches it per class across
    thousands of simulations). Dead grid combos (no available offering)
    are folded in via col_valid."""
    O = len(cat.columns)
    merged_per_pool: List[Optional[Requirements]] = []
    gmask = np.zeros(O, dtype=bool)
    for pidx, pool in enumerate(cat.pools):
        if not tolerates_all(pool.taints, rep.tolerations):
            merged_per_pool.append(None)
            continue
        template = cat.templates[pidx]
        if not template.compatible(rep.requirements):
            merged_per_pool.append(None)
            continue
        merged = template.intersection(rep.requirements)
        merged_per_pool.append(merged)
        sel = cat.pool_cols[pidx]
        if len(sel) == 0:
            continue
        # Split merged requirements three ways (oracle's open-world type
        # check, tensorized):
        #   column-provided key   → vectorized closed-world check
        #   template-provided key → already validated by the template ∩
        #                           pod intersection; the node itself
        #                           will carry the label
        #   neither               → satisfiable only by absence
        col_checked = Requirements()
        feasible = True
        for req_ in merged:
            if req_.key in cat.pool_provides[pidx]:
                col_checked.add(req_)
            elif template.get(req_.key) is not None:
                continue
            elif not req_.matches_absent():
                feasible = False
                break
        if not feasible:
            continue
        ok = _eval_requirements(col_checked, cat.vocab,
                                cat.pool_matrices[pidx], len(sel))
        gmask[sel[ok]] = True
    return gmask & cat.col_valid, merged_per_pool


def encode(inp: ScheduleInput, cat: Optional[CatalogEncoding] = None,
           groups: Optional[List[List[Pod]]] = None,
           split: bool = False,
           exist_shared: Optional[SharedExistEncoding] = None
           ) -> EncodedProblem:
    """split=False: raise Unsupported on the first inexpressible group
    (caller falls back wholesale).  split=True: collect inexpressible
    groups into `.residue` and encode the rest — the solver runs the
    device kernel on the supported majority and hands only the residue to
    the host oracle (a 50k-pod problem with one affinity pod must not
    abandon the device).  exist_shared: a frozen per-batch union cache of
    existing-node encodings (the consolidation sweep's simulations share
    one snapshot's node objects, so the per-simulation node work collapses
    to row gathers)."""
    cat = cat or encode_catalog(inp)
    if any(en.charge_pool is not None for en in inp.existing_nodes):
        # synthetic claim-nodes (split/rescue augment outputs) charge the
        # pool limit per placement — the kernel's existing-node fills
        # don't, so such inputs must stay on the host oracle
        raise Unsupported(
            "existing nodes with charge_pool need host-side limit "
            "accounting")
    pools = cat.pools
    vocab = cat.vocab
    columns = cat.columns
    col_matrices = cat.col_matrices
    if groups is None:
        groups = group_pods(inp.pods)

    O = len(columns)
    E = len(inp.existing_nodes)
    G = len(groups)

    shared_rows = (exist_shared.rows(inp.existing_nodes)
                   if exist_shared is not None else None)
    topo = _TopologyEncoder(inp, cat, groups, split_mode=split,
                            shared=exist_shared, shared_rows=shared_rows)
    D = topo.D

    if exist_shared is None:
        # existing-node labels (hostnames are per-node-unique) go into a
        # per-call vocab so node churn can't grow the cached catalog vocab
        exist_vocab = _Vocab()
        exist_keys = sorted({k for en in inp.existing_nodes
                             for k in en.node.labels})
        exist_matrices = _label_matrix(
            exist_vocab, exist_keys,
            [en.node.labels for en in inp.existing_nodes])

    group_req = np.zeros((G, R), dtype=np.float32)
    group_count = np.zeros(G, dtype=np.int32)
    group_mask = np.zeros((G, O), dtype=bool)
    exist_cap = np.zeros((G, E), dtype=np.int32)
    group_ncap = np.zeros(G, dtype=np.int32)
    group_dsel = np.zeros(G, dtype=np.int32)
    group_dbase = np.zeros((G, D), dtype=np.int32)
    group_dcap = np.zeros((G, D), dtype=np.int32)
    group_skew = np.zeros(G, dtype=np.int32)
    group_mindom = np.zeros(G, dtype=np.int32)
    group_delig = np.zeros((G, D), dtype=bool)
    group_whole_node = np.zeros(G, dtype=bool)
    group_gang = np.zeros(G, dtype=bool)
    group_priority = np.zeros(G, dtype=np.int32)
    static_allowed: List[Dict[str, Optional[set]]] = []
    merged_reqs: List[List[Optional[Requirements]]] = []

    _avail_rows = [None]

    def exist_avail() -> np.ndarray:
        """[E, R] remaining capacity, built once on first use — the same
        rows the kernel's exist fill sees (shared snapshot when present),
        so the whole-node verdicts can't disagree with the fill."""
        if _avail_rows[0] is None:
            if exist_shared is not None:
                _avail_rows[0] = exist_shared.exist_remaining(
                    inp.existing_nodes, shared_rows)
            else:
                _avail_rows[0] = np.array(
                    [en.available.v for en in inp.existing_nodes],
                    dtype=np.float32).reshape(E, R)
        return _avail_rows[0]

    pool_col = cat.col_pool
    dom_arrays = {wellknown.ZONE_LABEL: (cat.col_zone, topo.exist_zone),
                  wellknown.CAPACITY_TYPE_LABEL: (cat.col_ct, topo.exist_ct)}

    residue: List[Tuple[List[Pod], str]] = []
    dropped: List[int] = []
    for gi, g in enumerate(groups):
        rep = g[0]
        group_req[gi] = np.array(effective_request(rep).v, dtype=np.float32)
        group_count[gi] = len(g)
        group_priority[gi] = priority_of(rep)
        try:
            t = topo.encode_group(gi, rep)
        except Unsupported as e:
            if not split:
                raise  # → oracle fallback for the whole batch
            residue.append((g, str(e)))
            dropped.append(gi)
            continue
        group_ncap[gi] = t["ncap"]
        group_dsel[gi] = t["dsel"]
        group_dbase[gi] = t["dbase"]
        group_dcap[gi] = t["dcap"]
        group_skew[gi] = t["skew"]
        group_mindom[gi] = t["mindom"]
        group_delig[gi] = t["delig"]
        group_whole_node[gi] = t["whole_node"]
        group_gang[gi] = t.get("gang", False)

        gmask, merged_per_pool = group_column_mask(cat, rep)
        # static topology domain restrictions → column mask
        for key, (col_ids, _) in dom_arrays.items():
            al = t["allowed"][key]
            if al is not None:
                gmask = gmask & np.isin(col_ids, list(al))
        if t["whole_node"]:
            # hostname co-location seeding: every candidate column must
            # hold the WHOLE group (greedy fill then never splits it)
            gmask = gmask & (_np_fit_count(
                cat.col_alloc - cat.col_daemon,
                group_req[gi]) >= len(g))
        gang_incomplete = False
        if t.get("gang"):
            sp = topo.gangs[gi]
            if sp.size and len(g) != sp.size:
                # incomplete (or over-declared) gang: placement waits
                # for exactly the declared membership — zero the column
                # mask and the exist rows so the kernel strands the
                # gang WHOLE (decode emits GangIncomplete).  The oracle
                # applies the identical verdict, so parity holds.
                gmask = np.zeros_like(gmask)
                gang_incomplete = True
        static_allowed.append(t["allowed"])
        group_mask[gi] = gmask
        merged_reqs.append(merged_per_pool)

        if E:
            if exist_shared is not None:
                # union verdict cached per pod class; usable+taints folded in
                ok = exist_shared.group_ok(rep)[shared_rows]
            else:
                ok = exist_group_ok(rep, exist_vocab, exist_matrices,
                                    inp.existing_nodes)
            cap_row = np.where(ok, t["ecap"], 0).astype(np.int32)
            # static topology domain restrictions → per-node allowance
            for key, (_, ex_ids) in dom_arrays.items():
                al = t["allowed"][key]
                if al is not None:
                    ok_dom = np.isin(ex_ids, list(al))
                    if not t["requires"][key]:
                        ok_dom |= ex_ids < 0  # label-absent passes (symmetry)
                    cap_row = np.where(ok_dom, cap_row, 0)
            if t["whole_node"]:
                # all-or-nothing rows: only nodes whose remaining
                # capacity absorbs the full group stay eligible
                cap_row = np.where(
                    _np_fit_count(exist_avail(), group_req[gi]) >= len(g),
                    cap_row, 0)
            if gang_incomplete:
                cap_row = np.zeros_like(cap_row)
            exist_cap[gi] = cap_row

    if dropped:
        keep = np.ones(G, dtype=bool)
        keep[dropped] = False
        group_req = group_req[keep]
        group_count = group_count[keep]
        group_mask = group_mask[keep]
        exist_cap = exist_cap[keep]
        group_ncap = group_ncap[keep]
        group_dsel = group_dsel[keep]
        group_dbase = group_dbase[keep]
        group_dcap = group_dcap[keep]
        group_skew = group_skew[keep]
        group_mindom = group_mindom[keep]
        group_delig = group_delig[keep]
        group_whole_node = group_whole_node[keep]
        group_gang = group_gang[keep]
        group_priority = group_priority[keep]
        groups = [g for gi, g in enumerate(groups) if keep[gi]]
        # static_allowed / merged_reqs were only appended for kept groups

    exist_remaining = exist_avail()

    pool_limit = np.full((max(len(pools), 1), R), np.inf, dtype=np.float32)
    for pidx, pool in enumerate(pools):
        lim = inp.remaining_limits.get(pool.name)
        if lim is not None:
            pool_limit[pidx] = np.array(lim.v, dtype=np.float32)

    zone_values = [None] * len(topo.zone_ids)
    for z, i in topo.zone_ids.items():
        zone_values[i] = z
    ct_values = [None] * len(topo.ct_ids)
    for ct, i in topo.ct_ids.items():
        ct_values[i] = ct

    return EncodedProblem(
        group_req=group_req,
        group_count=group_count,
        group_mask=group_mask,
        exist_cap=exist_cap,
        exist_remaining=exist_remaining,
        col_alloc=cat.col_alloc,
        col_daemon=cat.col_daemon,
        col_price=cat.col_price,
        col_pool=pool_col,
        pool_limit=pool_limit,
        group_ncap=group_ncap,
        group_dsel=group_dsel,
        group_dbase=group_dbase,
        group_dcap=group_dcap,
        group_skew=group_skew,
        group_mindom=group_mindom,
        group_delig=group_delig,
        group_whole_node=group_whole_node,
        group_gang=group_gang,
        group_priority=group_priority,
        col_price_eff=cat.col_price_eff,
        col_zone=cat.col_zone,
        col_ct=cat.col_ct,
        exist_zone=topo.exist_zone,
        exist_ct=topo.exist_ct,
        zone_values=zone_values,
        ct_values=ct_values,
        n_domains=D,
        static_allowed=static_allowed,
        residue=residue,
        groups=groups,
        columns=columns,
        existing=list(inp.existing_nodes),
        pools=pools,
        merged_reqs=merged_reqs,
    )


def bucket(n: int, buckets: Tuple[int, ...]) -> int:
    """Round up to a fixed shape tier to avoid XLA recompiles
    (ragged-size discipline per SURVEY §7 hard-parts)."""
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))
