"""The plain reference of what one solve answers: grouped first-fit
decreasing with Karpenter's semantics, in NumPy.

It reads the benchmark's plain inputs (`generate.py`: pods as request
rows, zone pins and tolerations; NodePools; the catalog table; existing
nodes) and returns the answer a cluster operator acts on, in canonical
form (`Answer`): every new node claim in the order it was opened, with
its NodePool, its instance types ranked cheapest first, its price and
the names of the pods on it; every pod placed on an existing node; the
unschedulable pods.  It imports nothing of the program.

The semantics it holds the program to, stage by stage:

  * grouping: pods with the same requests, zone pin and tolerations form
    one class; classes go in decreasing (cpu, memory) order, ties by the
    first member's name, decreasing; members keep their input order;
  * columns: one per (NodePool, instance type, zone, capacity type) on the
    grid of every (zone, capacity type) pair, NodePools by decreasing
    weight then name; a pair with no available offering is dead; a
    class may use a column when the NodePool's taints are tolerated, the
    NodePool's requirements and the pod's intersect, the column's labels
    meet both, and (with a price cap) its price is below the cap;
  * placement, class by class: existing nodes first, in their order; then
    the nodes this solve opened, in order, each holding as many more pods
    as its largest surviving (NodePool, type) block allows; then new
    nodes, NodePool by NodePool, each sized to the class's largest
    fitting column; a node's surviving columns are those of every class
    on it that still fit what it holds; at most `max_nodes` new nodes;
  * the claim: the surviving instance types of the node's NodePool, in
    (price, name) order of their cheapest surviving offering, and that
    offering's price.

Capacities, requests and fits are float32 with the program's tolerance of
1e-3 (resource values of a catalog are not whole numbers in MiB), as the
operator's published solver computes them; counts are whole numbers.
`work` counts the fits and all-fits tests these inputs need, the
operation count of a kernel's roofline (`kernels/`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EPS = np.float32(1e-3)
CAP = 2 ** 30          # the largest count a fit may give
BIG = 2 ** 29          # an existing node's allowance when nothing caps it
R = 6                  # cpu, memory, ephemeral-storage, pods, gpu, volumes
_F32 = np.float32

ZONE = "topology.kubernetes.io/zone"
CAPACITY_TYPE = "karpenter.sh/capacity-type"
NODEPOOL = "karpenter.sh/nodepool"
_AXIS = {"cpu": 0, "memory": 1, "ephemeral-storage": 2, "pods": 3,
         "gpu": 4, "volumes": 5}


def _vec(m: Dict[str, float]) -> np.ndarray:
    v = np.zeros(R, dtype=np.float64)
    for k, x in m.items():
        v[_AXIS[k]] = float(x)
    return v


def fit_count(avail: np.ndarray, req: np.ndarray) -> np.ndarray:
    """How many pods of request `req` [R] fit in `avail` [..., R]:
    floor((avail + EPS) / req) over the axes the pod asks for, in
    float32, clipped to [0, CAP]."""
    safe = np.where(req > 0, req, _F32(1.0)).astype(_F32)
    counts = np.floor((avail + EPS) / safe).astype(_F32)
    counts = np.where(req > 0, counts, _F32(CAP))
    return np.clip(counts.min(axis=-1), 0, CAP).astype(np.int64)


def fits(x: np.ndarray) -> np.ndarray:
    return (x >= -EPS).all(axis=-1)


def prefix_fill(cap: np.ndarray, want: int) -> np.ndarray:
    before = np.cumsum(cap) - cap
    return np.clip(np.minimum(cap, want - before), 0, None)


def tolerated(taints: Sequence[Sequence[str]],
              tolerations: Sequence[Sequence[str]]) -> bool:
    """Every NoSchedule / NoExecute taint [key, value, effect] is met by a
    toleration [key, operator, value, effect]."""
    for key, value, effect in taints:
        if effect == "PreferNoSchedule":
            continue
        ok = False
        for tkey, op, tval, teff in tolerations:
            if teff and teff != effect:
                continue
            if tkey == "":
                ok = op == "Exists"
            elif tkey == key:
                ok = op == "Exists" or tval == value
            if ok:
                break
        if not ok:
            return False
    return True


class Columns:
    """The column grid of one catalog table under a list of NodePools."""

    def __init__(self, table: Dict, pools: List[Dict]):
        self.pools = sorted(pools, key=lambda p: (-p.get("weight", 0),
                                                  p["name"]))
        types = table["types"]
        pairs = sorted({(o[0], o[1]) for t in types
                        for o in t["offerings"]})
        P = len(self.pools)
        n_real = P * sum(len(t["offerings"]) for t in types)
        grid = P * len(types) * max(len(pairs), 1)
        dense = grid > 512 and (n_real / grid if grid else 1.0) < 0.5
        pool, tid, zone, ct, price, valid, alloc = [], [], [], [], [], [], []
        self.type_names = [t["name"] for t in types]
        self.type_labels = [t["labels"] for t in types]
        for pi, _ in enumerate(self.pools):
            for ti, t in enumerate(types):
                offs = {(o[0], o[1]): o for o in t["offerings"]}
                a = _vec(t["capacity"]) - _vec(t["overhead"])
                for z, c in (sorted(offs) if dense else pairs):
                    o = offs.get((z, c))
                    pool.append(pi)
                    tid.append(ti)
                    zone.append(z)
                    ct.append(c)
                    price.append(o[2] if o is not None else float("inf"))
                    valid.append(o is not None and bool(o[3]))
                    alloc.append(a)
        self.zc = 1 if dense else max(len(pairs), 1)
        self.col_pool = np.array(pool, dtype=np.int64)
        self.col_type = np.array(tid, dtype=np.int64)
        self.col_zone = np.array(zone, dtype=object)
        self.col_ct = np.array(ct, dtype=object)
        self.price = np.array(price, dtype=np.float64)
        self.price32 = self.price.astype(_F32)
        self.valid = np.array(valid, dtype=bool)
        self.alloc = np.array(alloc, dtype=_F32).reshape(-1, R)
        self.O = len(pool)
        self.pt_alloc = self.alloc[::self.zc]
        self.PT = self.O // self.zc if self.zc else 0
        # the decode's walk: price ascending, ties by the exact price and
        # the type's name
        self.porder = np.array(sorted(
            range(self.O), key=lambda i: (float(self.price32[i]),
                                          float(self.price[i]),
                                          self.type_names[self.col_type[i]])),
            dtype=np.int64)
        self._masks: Dict[tuple, np.ndarray] = {}

    def _label(self, i: int, key: str) -> Optional[str]:
        if key == ZONE:
            return self.col_zone[i]
        if key == CAPACITY_TYPE:
            return self.col_ct[i]
        pool = self.pools[self.col_pool[i]]
        if key == NODEPOOL:
            return pool["name"]
        if key in pool.get("labels", {}):
            return pool["labels"][key]
        return self.type_labels[self.col_type[i]].get(key)

    def class_mask(self, reqs: Dict[str, Tuple[str, ...]],
                   tolerations: Tuple) -> np.ndarray:
        """[O] bool: the columns a class may open (before any price cap)."""
        key = (tuple(sorted(reqs.items())), tolerations)
        hit = self._masks.get(key)
        if hit is not None:
            return hit
        mask = np.zeros(self.O, dtype=bool)
        for pi, pool in enumerate(self.pools):
            if not tolerated(pool.get("taints", []), tolerations):
                continue
            template = {NODEPOOL: (pool["name"],)}
            template.update({k: (v,) for k, v in
                             pool.get("labels", {}).items()})
            for k, v in pool.get("requirements", {}).items():
                template[k] = tuple(v)
            merged = dict(template)
            ok = True
            for k, v in reqs.items():
                if k in merged:
                    both = tuple(x for x in merged[k] if x in v)
                    if not both:
                        ok = False
                        break
                    merged[k] = both
                else:
                    merged[k] = v
            if not ok:
                continue
            cols = np.nonzero(self.col_pool == pi)[0]
            keep = np.ones(len(cols), dtype=bool)
            for k, allowed in merged.items():
                vals = [self._label(int(i), k) for i in cols]
                if all(v is None for v in vals):
                    if k in template:
                        continue          # the node will carry the label
                    keep[:] = False       # no column offers the key
                    break
                keep &= np.array([v is not None and v in allowed
                                  for v in vals], dtype=bool)
            mask[cols[keep]] = True
        mask &= self.valid
        self._masks[key] = mask
        return mask


@dataclass
class Answer:
    """One solve's answer in canonical form."""
    claims: List[Tuple[str, Tuple[str, ...], float, Tuple[str, ...]]]
    existing: Dict[str, str]
    unschedulable: List[str]
    work: Dict[str, int] = field(default_factory=dict)


def group(pods: Dict) -> List[Tuple[tuple, np.ndarray]]:
    """Pod classes in FFD order: (class key, member indices in input
    order).  A class key is (request row, zone pin, tolerations)."""
    req = np.asarray(pods["requests"], dtype=np.float64)
    zone = list(pods["zone"])
    tol = list(pods["tolerate"])
    names = pods["name"]
    members: Dict[tuple, List[int]] = {}
    for i in range(len(names)):
        members.setdefault((tuple(req[i]), zone[i], tol[i]), []).append(i)
    order = sorted(members.items(), key=lambda kv: (
        kv[0][0][0], kv[0][0][1], names[kv[1][0]]), reverse=True)
    return [(k, np.array(v, dtype=np.int64)) for k, v in order]


CONTROLS = ("order", "first_fit")


def solve(prob: Dict, cols: Columns, control: Optional[str] = None
          ) -> Answer:
    """The answer to one plain problem (`generate.py`'s form).

    `control` names a guarantee to break, for the check's control: with
    "order" classes go in the input order of their first member instead
    of decreasing size (first-fit without the decreasing); with
    "first_fit" existing nodes fill from the last instead of the first,
    the steps a faster solver might be tempted to take."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    pods = prob["pods"]
    names = pods["name"]
    classes = group(pods)
    if control == "order":
        classes.sort(key=lambda kv: kv[1][0])
    ex = prob.get("existing") or {"name": [], "labels": [], "available":
                                  np.zeros((0, R))}
    E = len(ex["name"])
    exist_rem = np.asarray(ex["available"], dtype=_F32).reshape(E, R)
    tolerations = {True: tuple(tuple(t) for t in prob.get(
        "tolerations", ())), False: ()}
    price_cap = prob.get("price_cap")
    N = int(prob["max_nodes"])
    P, O, PT, zc = len(cols.pools), cols.O, cols.PT, cols.zc
    used = np.zeros((N, R), dtype=_F32)
    colmask = np.zeros((N, O), dtype=bool)
    node_pool = np.zeros(N, dtype=np.int64)
    node_groups: List[List[int]] = [[] for _ in range(N)]
    node_members: List[List[np.ndarray]] = [[] for _ in range(N)]
    na = 0
    work = {"fit": 0, "test": 0}
    existing: Dict[str, str] = {}
    unsched: List[str] = []
    gmasks = []
    col_avail = cols.alloc          # no daemonset overhead in these cells
    for gi, ((reqrow, zone, tol), mem) in enumerate(classes):
        req = np.array(reqrow, dtype=np.float64)
        req[3] += 1.0               # the pod slot a pod occupies
        req = req.astype(_F32)
        cnt = len(mem)
        reqs = {ZONE: (zone,)} if zone is not None else {}
        gmask = cols.class_mask(reqs, tolerations[bool(tol)]).copy()
        if price_cap is not None:
            gmask &= cols.price32 < _F32(price_cap)
        gmasks.append(gmask)
        cursor = 0
        # 1. existing nodes, in order
        if E:
            elig = np.ones(E, dtype=bool)
            for k, allowed in reqs.items():
                elig &= np.array([lab.get(k) in allowed
                                  for lab in ex["labels"]], dtype=bool)
            cap_e = np.where(elig, np.minimum(fit_count(exist_rem, req), BIG),
                             0)
            if control == "first_fit":
                take_e = prefix_fill(cap_e[::-1], cnt)[::-1]
            else:
                take_e = prefix_fill(cap_e, cnt)
            exist_rem = exist_rem - take_e[:, None].astype(_F32) * req
            order = np.nonzero(take_e)[0]
            for ei in (order[::-1] if control == "first_fit" else order):
                k = int(take_e[ei])
                for m in mem[cursor:cursor + k]:
                    existing[names[m]] = ex["name"][ei]
                cursor += k
            work["fit"] += E
        c1 = cnt - cursor
        # 2. the nodes this solve opened
        work["fit"] += 4 * P + int(gmask.sum())
        work["test"] += P
        if na:
            act = slice(0, na)
            cap_npt = fit_count(cols.pt_alloc[None] - used[act, None], req)
            elig_pt = (colmask[act] & gmask[None]).reshape(
                na, PT, zc).any(axis=-1)
            best = np.where(elig_pt, cap_npt, 0).max(axis=1)
            work["fit"] += int(elig_pt.sum())
            take_n = prefix_fill(np.minimum(best, CAP), c1)
            used[act] = used[act] + take_n[:, None].astype(_F32) * req
            touched = take_n > 0
            work["test"] += int((elig_pt & touched[:, None]).sum())
            colmask[act] = np.where(touched[:, None],
                                    colmask[act] & gmask[None], colmask[act])
            ok_pt = fits(cols.pt_alloc[None] - used[act, None])
            colmask[act] &= np.repeat(ok_pt, zc, axis=1)
            for ni in np.nonzero(touched)[0]:
                k = int(take_n[ni])
                node_groups[ni].append(gi)
                node_members[ni].append(mem[cursor:cursor + k])
                cursor += k
        c_rem = cnt - cursor
        # 3. new nodes, NodePool by NodePool
        per_col = np.minimum(fit_count(col_avail, req), BIG)
        col_feas = gmask & (per_col >= 1)
        for p in range(P):
            cols_p = col_feas & (cols.col_pool == p)
            if c_rem <= 0 or not cols_p.any():
                continue
            k_full = int(np.where(cols_p, per_col, 0).max())
            m = min(-(-c_rem // k_full), N - na)
            taken = min(c_rem, m * k_full)
            blocks = int(cols_p.reshape(PT, zc).any(axis=-1).sum())
            work["test"] += m * blocks
            for j in range(m):
                ni = na + j
                k = k_full if j < m - 1 else taken - (m - 1) * k_full
                used[ni] = _F32(k) * req
                ok_pt = fits(cols.pt_alloc - used[ni][None])
                colmask[ni] = cols_p & np.repeat(ok_pt, zc)
                node_pool[ni] = p
                node_groups[ni].append(gi)
                node_members[ni].append(mem[cursor:cursor + k])
                cursor += k
            na += m
            c_rem -= taken
        unsched.extend(names[m] for m in mem[cursor:])
    # 4. claims
    claims = []
    shape: Dict[tuple, tuple] = {}
    for ni in range(na):
        gis = tuple(node_groups[ni])
        key = (int(node_pool[ni]), gis, used[ni].tobytes())
        got = shape.get(key)
        if got is None:
            po = cols.porder[cols.col_pool[cols.porder] == node_pool[ni]]
            keep = fits(cols.alloc[po] - used[ni][None])
            for gi in gis:
                keep &= gmasks[gi][po]
            idx = po[keep]
            ranked, seen = [], set()
            for i in idx:
                t = cols.col_type[i]
                if t not in seen:
                    seen.add(t)
                    ranked.append(cols.type_names[t])
            got = (cols.pools[node_pool[ni]]["name"], tuple(ranked),
                   float(cols.price[idx[0]]) if len(idx) else None)
            shape[key] = got
        pod_names = tuple(names[m] for seg in node_members[ni] for m in seg)
        if got[2] is None:          # no surviving type: the pods strand
            unsched.extend(pod_names)
            continue
        claims.append((got[0], got[1], got[2], pod_names))
    work.update(groups=len(classes), opened=na,
                existing_used=len(set(existing.values())))
    return Answer(claims=claims, existing=existing,
                  unschedulable=sorted(unsched), work=work)
