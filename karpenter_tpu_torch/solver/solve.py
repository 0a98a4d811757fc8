"""TorchSolver — the cold provisioning solve on the card.

encode (host, numpy) → the light FFD scan and the result pack (CUDA
kernels, solver/ffd.py) → decode (host).  The port of
`karpenter_tpu/solver/solve.py` `TPUSolver` for problems the light scan
expresses; everything else raises `UnsupportedPods`, naming the slice of
the port that brings it:

  * zone/capacity-type spread and anti-affinity groups (the heavy scan
    branch), gangs, more than one priority band, soft terms that need the
    relaxation loop;
  * groups the encoding cannot express (the reference's split path hands
    them to the host oracle);
  * pods the scan strands on a real solve (the reference's oracle rescue
    and pool-limit backstop).

A result is therefore always the reference's result: no path here returns
an answer the JAX package would not.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.requirements import Requirement, Requirements
from karpenter_tpu_torch.models.resources import RESOURCE_AXIS, Resources
from karpenter_tpu_torch.scheduling.types import (
    NewNodeClaim,
    ScheduleInput,
    ScheduleResult,
    min_values_violation,
)
from karpenter_tpu_torch.solver import explain as explainmod
from karpenter_tpu_torch.solver import ffd
from karpenter_tpu_torch.solver.encode import (
    BIG,
    D_BUCKETS,
    EncodedProblem,
    Unsupported,
    bucket,
    encode,
    encode_catalog,
    group_pods,
)

R = len(RESOURCE_AXIS)

G_BUCKETS = (1, 4, 8, 16, 32, 128, 512, 2048)
E_BUCKETS = (0, 16, 64, 128, 256, 512, 1024, 2048, 4096)
PT_ALIGN = 64  # (pool,type) axis padding; column axis O = PT_pad × ZC


class UnsupportedPods(Exception):
    """Raised when this port cannot solve the batch on the card; the
    message names the slice that brings the missing path."""


class TorchSolver:
    def __init__(self, max_nodes: int = 1024, device="cuda"):
        """`device`: where the kernels run — "cuda" (the default, the
        card) or "cpu" (the kernels' plain PyTorch versions; the tests
        use it).  With "cuda" and no CUDA device, `solve` raises
        RuntimeError rather than run anywhere else."""
        self.max_nodes = max_nodes
        self.device = torch.device(device)
        self._cat_entry = None
        self._last_active: Optional[int] = None  # node-axis warm start
        # take_new compaction warm start: the previous solve's max
        # per-group new-node fan-out (None = dense until measured)
        self._last_new_segments: Optional[int] = None
        self._last_slots_exhausted = False
        self._pregroup_ms = 0.0
        self._explain_resolved: Optional[int] = None
        # per-solve host/device phase breakdown (ms), refreshed by
        # _solve_attempt: encode, pad, dispatch, device, pull, repair,
        # decode — the keys of the reference's last_phase_ms
        self.last_phase_ms: Dict[str, float] = {}
        # per-solve provenance summary from the kernel's explain counts
        self.last_explain: Optional[Dict] = None

    def _check_device(self) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver(device='cuda'): no CUDA device is available "
                "(pass device='cpu' to run the kernels' plain versions)")

    def _explain_mode(self) -> int:
        """KARPENTER_TPU_EXPLAIN resolved once per solver, clamped to
        counts: the per-column map of "full" mode is not ported yet."""
        if self._explain_resolved is None:
            self._explain_resolved = min(explainmod.mode(),
                                         explainmod.MODE_COUNTS)
        return self._explain_resolved

    # -- catalog ---------------------------------------------------------
    def _catalog_encoding(self, inp: ScheduleInput):
        """Cache the catalog-side encoding and its device tensors.  The
        instance-type provider returns the identical list object until a
        seqnum changes, so object identity is the invalidation signal."""
        pools = sorted(inp.nodepools, key=lambda p: (-p.weight, p.meta.name))
        lists = tuple(inp.instance_types.get(p.name) for p in pools)
        from karpenter_tpu_torch.scheduling import risk
        key = (
            lists,
            tuple((p.meta.name, p.weight, p.static_hash()) for p in pools),
            tuple(sorted((k, tuple(v.v))
                         for k, v in inp.daemon_overhead.items())),
            risk.model_key(),
        )

        def _same(a, b):
            return (a is not None and b is not None
                    and len(a[0]) == len(b[0])
                    and all(x is y for x, y in zip(a[0], b[0]))
                    and a[1:] == b[1:])
        entry = self._cat_entry
        if entry is not None and _same(key, entry[0]):
            return entry[1]
        cat = encode_catalog(inp)
        # the column axis is a PT×ZC grid: padding whole (pool,type)
        # blocks keeps the stride uniform.  Padded blocks carry zero
        # allocatable (fit nothing) and are in no group mask.
        ZC = cat.zc
        PT = len(cat.columns) // ZC if ZC else 0
        PT_pad = max(-(-PT // PT_ALIGN) * PT_ALIGN, PT_ALIGN)
        O = PT_pad * ZC
        cat.device_args = ffd.catalog_tensors(dict(
            col_alloc=self._pad(cat.col_alloc, 0, O),
            col_daemon=self._pad(cat.col_daemon, 0, O),
            pt_alloc=self._pad(cat.pt_alloc, 0, PT_pad),
            col_pool=self._pad(cat.col_pool, 0, O),
            pool_daemon=cat.pool_daemon,
            zc=ZC), self.device)
        self._cat_entry = (key, cat)
        return cat

    @staticmethod
    def _pad(arr: np.ndarray, axis: int, to: int, value=0) -> np.ndarray:
        pad = to - arr.shape[axis]
        if pad <= 0:
            return arr
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(arr, widths, constant_values=value)

    def _encode_checked(self, inp: ScheduleInput, cat,
                        groups=None) -> EncodedProblem:
        enc = encode(inp, cat, groups=groups)
        # host-owned provenance classes: the label/taint compat mask and
        # the price cap are folded into group_mask before the kernel sees
        # it, so their elimination counts are taken here
        exc = self._explain_mode()
        pre = (enc.group_mask.sum(axis=1, dtype=np.int64) if exc else None)
        if inp.price_cap is not None:
            # consolidation price cap as a column mask — the cached
            # catalog encoding stays untouched
            enc.group_mask &= (cat.col_price < inp.price_cap)[None, :]
        if exc:
            post = (enc.group_mask.sum(axis=1, dtype=np.int64)
                    if inp.price_cap is not None else pre)
            enc.explain_host = np.stack(
                [enc.n_columns - pre, pre - post], axis=1)
            enc.explain_price_cap = inp.price_cap
        return enc

    def _problem_args(self, enc: EncodedProblem, G: int, E: int, Db: int,
                      O: int):
        """The per-problem kernel arguments, padded: the reference's exact
        17-slot tuple (18 with a priority-band row), numpy."""
        gmask = self._pad(self._pad(enc.group_mask, 1, O), 0, G)
        prob = (
            self._pad(enc.group_req, 0, G),
            self._pad(enc.group_count, 0, G),
            gmask,
            self._pad(self._pad(enc.exist_cap, 1, E), 0, G),
            self._pad(enc.exist_remaining, 0, E),
            enc.pool_limit,
            self._pad(enc.group_ncap, 0, G),
            self._pad(enc.group_dsel, 0, G),
            self._pad(self._pad(enc.group_dbase, 1, Db), 0, G),
            # pad domains take no quota (cap 0) and stay out of the skew min
            self._pad(self._pad(enc.group_dcap, 1, Db), 0, G),
            self._pad(enc.group_skew, 0, G),
            self._pad(enc.group_mindom, 0, G),
            self._pad(self._pad(enc.group_delig, 1, Db), 0, G),
            self._pad(enc.group_whole_node, 0, G),
            self._pad(enc.group_gang, 0, G),
            self._pad(enc.exist_zone, 0, E, value=-1),
            self._pad(enc.exist_ct, 0, E, value=-1),
        )
        gp = enc.group_priority
        if gp is not None and len(np.unique(gp[:len(enc.groups)])) > 1:
            prob = prob + (self._pad(gp, 0, G),)
        return prob

    # -- the solve -------------------------------------------------------
    def solve(self, inp: ScheduleInput,
              max_nodes: Optional[int] = None) -> ScheduleResult:
        """One scheduling problem.  `max_nodes` caps the node axis (a
        consolidation simulation); a capped solve that runs out of node
        slots returns its strands, as the reference does."""
        self._check_device()
        res = self._solve_relaxed(inp, max_nodes=max_nodes)
        if res.unschedulable and not (max_nodes is not None
                                      and self._last_slots_exhausted):
            raise UnsupportedPods(
                f"{len(res.unschedulable)} pod(s) stranded by the scan: "
                "the host oracle rescue and the pool-limit backstop come "
                "with slice 2")
        return res

    def _attempt_or_split(self, inp: ScheduleInput,
                          max_nodes: Optional[int] = None,
                          groups=None) -> ScheduleResult:
        """The device attempt.  Where the reference falls back to its
        split path (device for the expressible groups, host oracle for
        the residue), this port reports the batch: the oracle is slice 2."""
        try:
            return self._solve_attempt(inp, max_nodes=max_nodes,
                                       groups=groups)
        except Unsupported as e:
            raise UnsupportedPods(
                f"{e}: the split path (host oracle for inexpressible "
                "groups) comes with slice 2") from e

    def _solve_relaxed(self, inp: ScheduleInput,
                       max_nodes: Optional[int] = None) -> ScheduleResult:
        """Group, then solve.  Pods with soft terms (preferences, preferred
        affinity, ScheduleAnyway spread) need the reference's relaxation
        loop around the solve, which comes with slice 2."""
        t0 = time.perf_counter()
        groups = group_pods(inp.pods)
        # grouping belongs to the encode phase (folded in by
        # _solve_attempt)
        self._pregroup_ms = (time.perf_counter() - t0) * 1e3
        if any(g[0].preferences
               or ((g[0].pod_affinities or g[0].topology_spread)
                   and g[0].has_soft_terms())
               for g in groups):
            raise UnsupportedPods(
                "soft scheduling terms need the relaxation loop "
                "(slice 2)")
        return self._attempt_or_split(inp, max_nodes=max_nodes,
                                      groups=groups)

    def _adaptive_max_nodes(self) -> int:
        """Node-axis warm start from the previous solve's active count with
        30% headroom, bucketed; slot exhaustion retries once at the full
        ceiling (_solve_attempt), so correctness never depends on it."""
        last = self._last_active
        if last is None:
            return self.max_nodes
        need = max(64, int(last * 1.3) + 1)
        for b in (64, 256, 1024):
            if b >= need and b < self.max_nodes:
                return b
        return self.max_nodes

    # take_new compaction tiers: K bounds the max per-group new-node
    # fan-out, known only after the solve, so K warm-starts from the
    # previous solve and the pack's nnz row detects a miss
    NSEG_BUCKETS = (8, 32, 128, 512)

    def _pick_sparse_n(self, N_pad: int) -> int:
        """K for the top-K take_new compaction (0 = dense): the previous
        solve's max fan-out with 2x headroom, engaged only when the
        compacted rows are smaller than the dense row."""
        last = self._last_new_segments
        if last is None:
            return 0
        Kn = bucket(min(max(2 * last, 1), max(N_pad, 1)), self.NSEG_BUCKETS)
        return Kn if (2 * Kn + 1) * 2 <= N_pad else 0

    @staticmethod
    def _check_light(enc: EncodedProblem) -> None:
        """Raise for groups only the later slices' paths can run."""
        n = enc.n_groups
        if (enc.group_dsel[:n] > 0).any():
            raise UnsupportedPods(
                "zone/capacity-type spread or anti-affinity groups need "
                "the heavy scan branch (slice 2)")
        if enc.group_gang is not None and enc.group_gang[:n].any():
            raise UnsupportedPods("gang groups need the gang fill (slice 2)")
        gp = enc.group_priority
        if gp is not None and len(np.unique(gp[:n])) > 1:
            raise UnsupportedPods(
                "more than one priority band needs the priority witness "
                "(slice 2)")

    def _solve_attempt(self, inp: ScheduleInput,
                       max_nodes: Optional[int] = None,
                       groups=None) -> ScheduleResult:
        mn = max_nodes or self._adaptive_max_nodes()
        self._last_slots_exhausted = False
        t0 = time.perf_counter()
        cat = self._catalog_encoding(inp)
        enc = self._encode_checked(inp, cat, groups=groups)
        t1 = time.perf_counter()
        self.last_phase_ms = {
            "encode": (t1 - t0) * 1e3 + self._pregroup_ms}
        self._pregroup_ms = 0.0
        if enc.n_groups == 0:
            return ScheduleResult()
        self._check_light(enc)
        if enc.n_columns == 0:
            # no purchasable capacity — existing nodes can still absorb
            # pods, exactly as the oracle fills them first
            return self._existing_only(enc)

        G = bucket(enc.n_groups, G_BUCKETS)
        E = bucket(len(enc.existing), E_BUCKETS)
        Db = bucket(enc.n_domains, D_BUCKETS)
        dev = cat.device_args
        prob = self._problem_args(enc, G, E, Db, dev.O)
        exc = self._explain_mode()
        t2 = time.perf_counter()
        kn = self._pick_sparse_n(mn)
        disp_s = dev_s = pull_s = 0.0
        cuda = self.device.type == "cuda"

        def execute(n, k):
            # dispatch (one upload, the kernel launches), then wait for
            # the device, then pull + unpack — timed separately
            nonlocal disp_s, dev_s, pull_s
            t_a = time.perf_counter()
            ptens = ffd.problem_tensors(prob, dev.O, self.device)
            flat = ffd.solve_ffd(ptens, dev, n, sparse_n=k, explain=exc)
            t_b = time.perf_counter()
            if cuda:
                torch.cuda.synchronize(self.device)
            t_c = time.perf_counter()
            out_ = ffd.unpack(flat.cpu().numpy(), G, E, n, R, Db,
                              sparse_n=k, explain=exc)
            t_d = time.perf_counter()
            disp_s += t_b - t_a
            dev_s += t_c - t_b
            pull_s += t_d - t_c
            return out_

        out = execute(mn, kn)
        if kn and out["new_overflow"]:
            # the warm-started fan-out estimate was low: redo dense
            out = execute(mn, 0)
        if (max_nodes is None and mn < self.max_nodes
                and out["unsched"].sum() > 0
                and out["num_active"] >= mn):
            # the warm-start bucket ran out of node slots: redo at the
            # configured ceiling, dense
            mn = self.max_nodes
            out = execute(mn, 0)
        self._last_slots_exhausted = bool(
            out["unsched"].sum() > 0 and out["num_active"] >= mn)
        if max_nodes is None:
            # capped sims (tiny explicit N) must not poison the warm-start
            na = self._last_active = int(out["num_active"])
            segs = (int((out["take_new"][:enc.n_groups, :na] > 0)
                        .sum(axis=1).max()) if na and enc.n_groups else 0)
            self._last_new_segments = max(segs, 1)
        t3 = time.perf_counter()
        self._repair_whole_node(enc, out)
        t4 = time.perf_counter()
        res = self._decode(enc, out)
        t5 = time.perf_counter()
        if max_nodes is None:
            self._note_explain(enc, out)
        self.last_phase_ms.update(
            pad=(t2 - t1) * 1e3, dispatch=disp_s * 1e3,
            device=dev_s * 1e3, pull=pull_s * 1e3,
            repair=(t4 - t3) * 1e3, decode=(t5 - t4) * 1e3)
        return res

    def _note_explain(self, enc: EncodedProblem, out: Dict) -> None:
        """The solve's elimination totals per constraint class, from the
        host compat/price counts and the kernel's explain counts."""
        exc = self._explain_mode()
        if not exc:
            self.last_explain = None
            return
        G = enc.n_groups
        totals: Dict[str, int] = {}
        host = enc.explain_host
        if host is not None:
            hs = np.asarray(host[:G]).sum(axis=0)
            for i, name in enumerate(explainmod.HOST_CONSTRAINTS):
                totals[name] = int(hs[i])
        kc = out.get("explain_counts")
        if kc is not None:
            ks = np.asarray(kc[:G]).sum(axis=0)
            for i, name in enumerate(explainmod.KERNEL_CONSTRAINTS):
                totals[name] = int(ks[i])
        self.last_explain = {
            "mode": explainmod.mode_name(exc),
            "groups": G,
            "eliminations": totals,
            "kernel_aux": kc is not None,
        }

    def _existing_only(self, enc: EncodedProblem) -> ScheduleResult:
        """Host-side step-1-only fill when there are no columns to buy."""
        res = ScheduleResult()
        remaining = enc.exist_remaining.copy()
        for gi, pods in enumerate(enc.groups):
            req = enc.group_req[gi]
            cursor = 0
            for ei in range(len(enc.existing)):
                if cursor >= len(pods) or enc.exist_cap[gi, ei] <= 0:
                    continue
                with np.errstate(divide="ignore", invalid="ignore"):
                    per = np.where(
                        req > 0,
                        np.floor((remaining[ei] + explainmod.EPS)
                                 / np.where(req > 0, req, 1)),
                        np.inf)
                k = int(min(np.min(per), enc.exist_cap[gi, ei],
                            len(pods) - cursor))
                if k <= 0:
                    continue
                for pod in pods[cursor:cursor + k]:
                    res.existing_assignments[pod.meta.name] = \
                        enc.existing[ei].name
                remaining[ei] -= k * req
                cursor += k
            for pod in pods[cursor:]:
                res.unschedulable[pod.meta.name] = explainmod.make(
                    explainmod.NO_INSTANCE_TYPES,
                    "no instance types available")
        return res

    # -- host repair -----------------------------------------------------
    def _repair_whole_node(self, enc: EncodedProblem,
                           out: Dict[str, np.ndarray]) -> None:
        """Whole-node (hostname co-location) enforcement: the encoder's
        fit is against ORIGINAL capacity, but the scan fills groups in
        order — an earlier group can leave this group's members SPLIT
        across nodes.  Strand such a group whole here."""
        gw = enc.group_whole_node
        if gw is None or not gw.any():
            return
        Er = len(enc.existing)
        num_active = int(out["num_active"])
        for gi in np.nonzero(gw[:enc.n_groups])[0]:
            te = out["take_exist"][gi, :Er]
            tn = out["take_new"][gi, :num_active]
            if int((te > 0).sum()) + int((tn > 0).sum()) <= 1:
                continue
            self._strand_group(enc, out, gi, te, tn)

    @staticmethod
    def _strand_group(enc: EncodedProblem, out: Dict[str, np.ndarray],
                      gi: int, te: np.ndarray, tn: np.ndarray) -> None:
        """Mark every taken member of group `gi` unschedulable and release
        its consumption on new nodes: decode rebuilds each node's
        surviving columns from used[ni], which must hold only the pods
        that stay."""
        out["unsched"][gi] += te.sum() + tn.sum()
        req = enc.group_req[gi]
        for ni in np.nonzero(tn > 0)[0]:
            out["used"][ni] -= int(tn[ni]) * req
        te[:] = 0
        tn[:] = 0

    # -- decode ----------------------------------------------------------
    def _decode(self, enc: EncodedProblem,
                out: Dict[str, np.ndarray]) -> ScheduleResult:
        res = ScheduleResult()
        Gr = enc.n_groups
        Er = len(enc.existing)
        num_active = int(out["num_active"])
        node_pool = out["node_pool"]
        node_zone = out["node_zone"]
        node_ct = out["node_ct"]
        used = out["used"]
        col_pool = enc.col_pool
        col_alloc = enc.col_alloc

        # distribute each group's pods: existing nodes first (scan order),
        # then new nodes, then unschedulable — the kernel's accounting
        take_exist = out["take_exist"][:Gr, :Er].astype(int)
        take_new = out["take_new"][:Gr, :].astype(int)
        unsched = out["unsched"][:Gr].astype(int)
        node_pods: Dict[int, List] = {}
        node_groups: Dict[int, List[int]] = {}
        for gi, pods in enumerate(enc.groups):
            cursor = 0
            for ei in np.nonzero(take_exist[gi])[0]:
                k = take_exist[gi, ei]
                for pod in pods[cursor:cursor + k]:
                    res.existing_assignments[pod.meta.name] = \
                        enc.existing[ei].name
                cursor += k
            for ni in np.nonzero(take_new[gi, :num_active])[0]:
                k = take_new[gi, ni]
                node_pods.setdefault(int(ni), []).extend(
                    pods[cursor:cursor + k])
                node_groups.setdefault(int(ni), []).append(gi)
                cursor += k
            if unsched[gi] > 0:
                reason = self._unsched_reason(enc, gi)
                for pod in pods[cursor:cursor + unsched[gi]]:
                    res.unschedulable[pod.meta.name] = reason

        # claim metadata depends only on (pool, resident groups, used row,
        # pinned domains): hundreds of nodes share a handful of shapes
        claim_cache: Dict[tuple, tuple] = {}
        req_cache: Dict[int, Resources] = {}
        fit_rows: Dict[tuple, np.ndarray] = {}
        used_id: List[int] = []
        if num_active > 0:
            seen: Dict[bytes, int] = {}
            used_id = [seen.setdefault(used[ni].tobytes(), len(seen))
                       for ni in range(num_active)]
            used_f = used[:num_active, :R].astype(float)
        # catalog-pure scaffolding, cached by identity of the catalog
        # encoding's columns list:
        #   porder     price-ascending column walk, (price, type) ties
        #   col_tid    dense (pool, type name) id per column
        #   base_masks (pidx, zi, ci) -> price-ordered columns of the
        #              subspace and their allocatable rows
        cat_cached = getattr(self, "_catalog_shape_cache", None)
        if cat_cached is not None and cat_cached[0] is enc.columns:
            _, porder, col_tid, tid_names, tid_types, base_masks = cat_cached
        else:
            cols = enc.columns
            # rank by the EFFECTIVE price (= the real price unless the
            # spot-risk objective is on)
            eff = (enc.col_price_eff if enc.col_price_eff is not None
                   else enc.col_price)
            porder = np.fromiter(
                sorted(range(len(cols)),
                       key=lambda i: (float(eff[i]), cols[i].price,
                                      cols[i].type_name)),
                dtype=np.intp, count=len(cols))
            tid_of: Dict[tuple, int] = {}
            tid_names: List[str] = []
            tid_types: List = []
            col_tid = np.empty(len(cols), dtype=np.int32)
            for i, c in enumerate(cols):
                k = (c.pool_idx, c.type_name)
                t = tid_of.get(k)
                if t is None:
                    t = len(tid_names)
                    tid_of[k] = t
                    tid_names.append(c.type_name)
                    tid_types.append(c.instance_type)
                col_tid[i] = t
            base_masks = {}
            self._catalog_shape_cache = (
                enc.columns, porder, col_tid, tid_names, tid_types,
                base_masks)

        def _claim_shape(pidx, gis, zi, ci, uid, ni):
            """One claim SHAPE — (violation | None, prototype claim
            __dict__ | None) — shared by every node with the same key."""
            pool = enc.pools[pidx]
            sub = base_masks.get((pidx, zi, ci))
            if sub is None:
                base = col_pool == pidx
                if zi >= 0:
                    base &= enc.col_zone == zi
                if ci >= 0:
                    base &= enc.col_ct == ci
                bporder = porder[base[porder]]
                sub = (bporder, np.ascontiguousarray(col_alloc[bporder]))
                base_masks[(pidx, zi, ci)] = sub
            bporder, alloc_sub = sub
            fkey = (pidx, zi, ci, uid)
            fit = fit_rows.get(fkey)
            if fit is None:
                fit = np.all(alloc_sub - used[ni][None, :R]
                             >= -explainmod.EPS, axis=-1)
                fit_rows[fkey] = fit
            keep = fit
            for gi in gis:
                keep = keep & enc.group_mask[gi][bporder]
            idxs = bporder[keep]  # price-ascending survivors
            if len(idxs) == 0:
                return (explainmod.make(explainmod.NO_SURVIVING_TYPE,
                                        "no surviving instance type"),
                        None)
            reqs = pool.template_requirements()
            for gi in gis:
                merged = enc.merged_reqs[gi][pidx]
                if merged is not None:
                    reqs = reqs.intersection(merged)
            if zi >= 0:
                reqs = reqs.intersection(Requirements(Requirement.make(
                    wellknown.ZONE_LABEL, "In", enc.zone_values[zi])))
            if ci >= 0:
                reqs = reqs.intersection(Requirements(Requirement.make(
                    wellknown.CAPACITY_TYPE_LABEL, "In",
                    enc.ct_values[ci])))
            # static allowed-domain sets restrict launch the same way
            for gi in gis:
                for key, al in enc.static_allowed[gi].items():
                    if al is None:
                        continue
                    values = (enc.zone_values
                              if key == wellknown.ZONE_LABEL
                              else enc.ct_values)
                    names = [values[i] for i in sorted(al)]
                    if names:
                        reqs = reqs.intersection(Requirements(
                            Requirement.make(key, "In", *names)))
            # the walk is (price, name)-ordered: the first occurrence per
            # type is its cheapest column and the ranked list
            utids, first_pos = np.unique(col_tid[idxs], return_index=True)
            ulist = utids[np.argsort(first_pos, kind="stable")].tolist()
            ranked = [tid_names[t] for t in ulist]
            violation = min_values_violation(
                reqs, [tid_types[t] for t in ulist])
            if violation is not None:
                return (explainmod.make(explainmod.MIN_VALUES, violation),
                        None)
            requests = req_cache.get(uid)
            if requests is None:
                requests = Resources(used_f[ni].tolist())
                req_cache[uid] = requests
            return (None, {
                "nodepool": pool.name,
                "node_class_ref": pool.node_class_ref,
                "requirements": reqs,
                "pods": None,
                "requests": requests,
                "instance_type_names": ranked,
                "price": enc.columns[int(idxs[0])].price,
                "taints": list(pool.taints),
                "startup_taints": list(pool.startup_taints),
                "hostname": "",
            })

        if num_active > 0:
            node_pool_l = node_pool[:num_active].tolist()
            node_zone_l = node_zone[:num_active].tolist()
            node_ct_l = node_ct[:num_active].tolist()
        for ni in range(num_active):
            pods = node_pods.get(ni)
            if not pods:
                continue
            gis = tuple(node_groups.get(ni, ()))
            pidx = node_pool_l[ni]
            zi, ci = node_zone_l[ni], node_ct_l[ni]
            ckey = (pidx, gis, zi, ci, used_id[ni])
            cached = claim_cache.get(ckey)
            if cached is None:
                cached = _claim_shape(pidx, gis, zi, ci, ckey[4], ni)
                claim_cache[ckey] = cached
            violation, proto = cached
            if violation is not None:
                for pod in pods:
                    res.unschedulable[pod.meta.name] = violation
                continue
            claim = NewNodeClaim.__new__(NewNodeClaim)
            d = dict(proto)
            d["pods"] = pods
            d["hostname"] = f"tpu-solver-node-{ni}"
            claim.__dict__ = d
            res.new_claims.append(claim)
        return res

    def _unsched_reason(self, enc: EncodedProblem, gi: int) -> str:
        """One stranded group's verdict as a registry `Reason`."""
        if (not enc.group_mask[gi].any()
                and not (enc.exist_cap[gi] > 0).any()):
            details = []
            for pidx, pool in enumerate(enc.pools):
                if enc.merged_reqs[gi][pidx] is None:
                    details.append(
                        f"nodepool {pool.name}: incompatible or taints")
                else:
                    details.append(f"nodepool {pool.name}: no instance "
                                   "type fits/compatible")
            return explainmod.make(
                explainmod.NO_NODEPOOL,
                "no nodepool can schedule pod: " + "; ".join(details))
        # attribute to topology only when the encoder enforced a
        # constraint for this group
        if (enc.group_dsel[gi] > 0 or enc.group_ncap[gi] < BIG
                or any(v is not None
                       for v in enc.static_allowed[gi].values())):
            return explainmod.make(
                explainmod.TOPOLOGY,
                "topology constraints unsatisfiable: every allowed "
                "domain is at its skew ceiling or out of capacity")
        return explainmod.make(
            explainmod.CAPACITY,
            "no capacity: every compatible node/instance-type "
            "combination is exhausted or over limits")
