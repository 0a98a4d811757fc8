"""TorchSolver — the provisioning solve and the consolidation sweep on the
card.

`solve`: encode (host, numpy) → the FFD scan (K5 at B=1, its heavy step
for classes with a zone or capacity-type spread or anti-affinity) and the
result pack (CUDA kernels, solver/ffd.py) → host repair (whole-node,
topology skew) → decode (host).  `solve_batch`: many simulations of one
cluster snapshot — the leave-k-out sweep (K4, light and heavy lanes) for
inputs that carry the snapshot's provenance, the generic batched scan (K5)
for the rest, a chunk of up to 64 problems per launch, pipelined.  The
port of `karpenter_tpu/solver/solve.py` `TPUSolver`, with its host paths
around the device solve:

  * the split path: groups the encoding cannot express (custom topology
    keys, two dynamic keys, coupled selectors) go to the host oracle
    (`scheduling/oracle.py`) after the device solve of the rest;
  * the rescue: pods the scan strands on a real solve are re-judged by
    the oracle against the device placements;
  * the pool-limit backstop: when pods strand on a binding pool limit, one
    oracle solve of the whole input, kept if it strands fewer.

What the port does not run yet raises `UnsupportedPods`, naming the slice
that brings it: gangs, more than one priority band (and a stranded pod
that outranks a resident one, which the reference's preemption planner
would act on), and soft terms that need the relaxation loop.  A result is
therefore always the reference's result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import Node, ObjectMeta, Pod
from karpenter_tpu_torch.models.requirements import Requirement, Requirements
from karpenter_tpu_torch.models.resources import RESOURCE_AXIS, Resources
from karpenter_tpu_torch.scheduling.oracle import (
    PreemptionNotPorted,
    Scheduler,
    preemption_would_plan,
)
from karpenter_tpu_torch.scheduling.types import (
    ExistingNode,
    NewNodeClaim,
    ScheduleInput,
    ScheduleResult,
    effective_request,
    gang_of,
    min_values_violation,
)
from karpenter_tpu_torch.solver import explain as explainmod
from karpenter_tpu_torch.solver import ffd
from karpenter_tpu_torch.solver import pipeline as pipelining
from karpenter_tpu_torch.solver.encode import (
    BIG,
    D_BUCKETS,
    EncodedProblem,
    SharedExistEncoding,
    SweepTopologyTables,
    Unsupported,
    _matches,
    bucket,
    encode,
    encode_catalog,
    group_column_mask,
    group_pods,
)
from karpenter_tpu_torch.utils.knobs import priority_enabled

R = len(RESOURCE_AXIS)

B_BUCKETS = (4, 16, 64)  # simulate-batch axis: problems per launch
G_BUCKETS = (1, 4, 8, 16, 32, 128, 512, 2048)
E_BUCKETS = (0, 16, 64, 128, 256, 512, 1024, 2048, 4096)
PT_ALIGN = 64  # (pool,type) axis padding; column axis O = PT_pad × ZC


class UnsupportedPods(Exception):
    """Raised when this port cannot solve the batch; the message names the
    slice that brings the missing path."""


class _SplitNeeded(Exception):
    """The device attempt cannot take this input as a whole: the split
    path decides (the reference's UnsupportedPods inside the solver)."""


def _oracle_solve(inp: ScheduleInput) -> ScheduleResult:
    """The host oracle on `inp`; UnsupportedPods where the reference's
    oracle would plan preemptions."""
    try:
        return Scheduler(inp).solve()
    except PreemptionNotPorted as e:
        raise UnsupportedPods(f"{e} (slice 2b)") from e


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
        self._last_slots_exhausted = False
        self._pregroup_ms = 0.0
        self._explain_resolved: Optional[int] = None
        # per-solve host/device phase breakdown (ms), refreshed by
        # _solve_attempt: encode, pad, dispatch, device, pull, repair,
        # decode — the keys of the reference's last_phase_ms
        self.last_phase_ms: Dict[str, float] = {}
        # per-solve provenance summary from the kernel's explain counts
        self.last_explain: Optional[Dict] = None
        # per-solve host help: whether the split/rescue/backstop oracle
        # ran, the pods it was handed (deduplicated per solve), and the
        # pods the current attempt's split oracle already judged
        self._used_split = False
        self._residue_counted: set = set()
        self.last_residue_pods = 0
        self._last_oracle_judged: set = set()
        # the sweep's decode caches its shared existing-node names while
        # it runs (released on every exit)
        self._exist_names_cache = None
        self._in_sweep_decode = False

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
            col_zone=self._pad_tiled(cat.col_zone, O, ZC),
            col_ct=self._pad_tiled(cat.col_ct, O, ZC),
            pool_daemon=cat.pool_daemon,
            zc=ZC), self.device)
        self._cat_entry = (key, cat)
        return cat

    @staticmethod
    def _pad_tiled(a: np.ndarray, O: int, ZC: int) -> np.ndarray:
        """Pad a per-column domain id to O columns with the TILED per-block
        pattern (the reference's `_pad_tiled`): the heavy step's real
        domain count reads the maximum id over every column, padding
        included."""
        out = np.empty(O, a.dtype)
        n = len(a)
        out[:n] = a
        if O > n and ZC:
            pat = a[:ZC] if n >= ZC else np.zeros(ZC, a.dtype)
            reps = -(-(O - n) // ZC)
            out[n:] = np.tile(pat, reps)[:O - n]
        return out

    @staticmethod
    def _pad(arr: np.ndarray, axis: int, to: int, value=0) -> np.ndarray:
        pad = to - arr.shape[axis]
        if pad <= 0:
            return arr
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, pad)
        return np.pad(arr, widths, constant_values=value)

    def _encode_checked(self, inp: ScheduleInput, cat, groups=None,
                        exist_shared=None) -> EncodedProblem:
        enc = encode(inp, cat, groups=groups, exist_shared=exist_shared)
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
        self._used_split = False
        self._residue_counted = set()
        self.last_residue_pods = 0
        res = self._solve_relaxed(inp, max_nodes=max_nodes)
        if res.unschedulable and not (max_nodes is not None
                                      and self._last_slots_exhausted):
            # rescue unless the caller's explicit node cap was itself the
            # binding constraint: a slot-exhausted consolidation sim wants
            # the cheap reject, but a capped sim stranded for capacity or
            # topology reasons may be feasible
            res = self._rescue_stranded(inp, res)
        if max_nodes is None:
            # the backstop ignores node caps, so a capped solve never
            # takes it
            res = self._oracle_backstop_on_limits(inp, res)
        if (max_nodes is None and res.unschedulable and priority_enabled()
                and preemption_would_plan(inp, res)):
            raise UnsupportedPods(
                "a stranded pod outranks an evictable resident pod: the "
                "preemption planner comes with slice 2b")
        return res

    # pods beyond this, the backstop oracle's O(pods) wall-clock isn't
    # worth a limits-edge improvement
    _ORACLE_BACKSTOP_MAX_PODS = 2000

    def _oracle_backstop_on_limits(self, inp: ScheduleInput,
                                   res: ScheduleResult) -> ScheduleResult:
        """Full-oracle fallback when pods strand on a BINDING pool limit.
        The decomposed paths (device-then-residue split, rescue) spend a
        shared pool budget sequentially, so whichever sub-solve runs first
        can starve the later one even when a joint solve fits everyone.
        Runs only when the oracle's own verdict names a pool limit,
        bounded by pod count; keeps whichever result strands fewer pods."""
        if not res.unschedulable or len(inp.pods) > \
                self._ORACLE_BACKSTOP_MAX_PODS:
            return res
        if not any(lim is not None
                   for lim in (inp.remaining_limits or {}).values()):
            return res
        if not any(explainmod.code_of(reason) == explainmod.POOL_LIMIT
                   for reason in res.unschedulable.values()):
            return res
        orc = _oracle_solve(inp)
        if len(orc.unschedulable) < len(res.unschedulable):
            self._used_split = True  # host help happened
            return orc
        return res

    def _count_residue(self, pods: List[Pod]) -> None:
        """Count the pods handed to the host oracle, once per solve: the
        split path can meet the same pods again."""
        fresh = [p for p in pods if p.meta.name not in self._residue_counted]
        self._residue_counted.update(p.meta.name for p in fresh)
        self.last_residue_pods += len(fresh)

    def _rescue_stranded(self, inp: ScheduleInput,
                         dev_res: ScheduleResult) -> ScheduleResult:
        """One host-side oracle pass for pods the kernel stranded: the
        kernel's per-domain quotas are planned against capacity
        ESTIMATES, and the water-fill is cost-blind, so stranded pods are
        re-judged by the oracle against the residual state via the split
        path's augment+merge machinery.  They either place or the verdict
        carries oracle authority."""
        by_name = {p.meta.name: p for p in inp.pods}
        # pods the final attempt's split oracle already judged carry
        # oracle authority: re-judging them would repeat the same pass
        seen = self._last_oracle_judged
        stranded = [by_name[n] for n in dev_res.unschedulable
                    if n in by_name and n not in seen]
        if not stranded:
            return dev_res
        placed = [p for p in inp.pods
                  if p.meta.name not in dev_res.unschedulable]
        self._count_residue(stranded)
        self._used_split = True
        aug = self._augment_with_claims(inp, stranded, placed, dev_res)
        orc_res = _oracle_solve(aug)
        # the oracle's verdict replaces the kernel's for the rescued set;
        # the kernel's reason tree, where one was attached, is kept under
        # "kernel"
        kernel_trees = {
            p.meta.name: getattr(
                dev_res.unschedulable.get(p.meta.name), "tree", None)
            for p in stranded}
        for p in stranded:
            dev_res.unschedulable.pop(p.meta.name, None)
        merged = self._merge_split(inp, dev_res, orc_res, stranded)
        for name, kt in kernel_trees.items():
            r = merged.unschedulable.get(name)
            if r is None or kt is None:
                continue
            code = explainmod.code_of(r)
            if code == explainmod.LEGACY:
                continue
            tree = dict(getattr(r, "tree", None)
                        or {"code": code,
                            "constraint": explainmod.constraint_of(code)})
            tree.setdefault("kernel", kt)
            merged.unschedulable[name] = explainmod.make(
                code, str(r), tree)
        return merged

    def _attempt_or_split(self, inp: ScheduleInput,
                          max_nodes: Optional[int] = None,
                          groups=None) -> ScheduleResult:
        """Device attempt; on inexpressible groups, the split path for
        THIS exact input."""
        try:
            return self._solve_attempt(inp, max_nodes=max_nodes,
                                       groups=groups)
        except (Unsupported, _SplitNeeded):
            self._pregroup_ms = 0.0
            res = self._solve_split(inp, max_nodes=max_nodes)
            self._used_split = True
            return res

    def _solve_split(self, inp: ScheduleInput,
                     max_nodes: Optional[int] = None) -> ScheduleResult:
        """Device solve of the expressible groups, then the host oracle for
        the residue against the device placements."""
        cat = self._catalog_encoding(inp)
        try:
            probe = encode(inp, cat, split=True)
        except Unsupported as e:  # a non-group-level limitation
            raise UnsupportedPods(str(e)) from e
        if not probe.residue:
            # the plain path failed for a reason splitting can't fix
            raise UnsupportedPods("no residue groups; plain solve failed")
        residue_pods = [p for g, _ in probe.residue for p in g]
        supported_pods = [p for g in probe.groups for p in g]
        self._count_residue(residue_pods)

        if supported_pods:
            dev_res = self._solve_relaxed(
                dataclasses.replace(inp, pods=supported_pods),
                max_nodes=max_nodes)
        else:
            dev_res = ScheduleResult()
        aug = self._augment_with_claims(inp, residue_pods, supported_pods,
                                        dev_res)
        orc_res = _oracle_solve(aug)

        # budget starvation retry: under a binding pool limit the device
        # pass (solved first) can spend budget the residue needed.
        # Reserve the residue's aggregate requests out of the device
        # pass's budget and retry once; keep whichever split strands
        # fewer pods overall.
        residue_names = {p.meta.name for p in residue_pods}
        has_limit = any(lim is not None
                        for lim in (inp.remaining_limits or {}).values())
        if supported_pods and has_limit and any(
                n in residue_names
                and explainmod.code_of(r) == explainmod.POOL_LIMIT
                for n, r in orc_res.unschedulable.items()):
            reserve = Resources()
            for p in residue_pods:
                reserve = reserve + effective_request(p)
            reduced = {pool: (lim - reserve if lim is not None else None)
                       for pool, lim in inp.remaining_limits.items()}
            dev2 = self._solve_relaxed(
                dataclasses.replace(inp, pods=supported_pods,
                                    remaining_limits=reduced),
                max_nodes=max_nodes)
            aug2 = self._augment_with_claims(inp, residue_pods,
                                             supported_pods, dev2)
            orc2 = _oracle_solve(aug2)
            if (len(dev2.unschedulable) + len(orc2.unschedulable)
                    < len(dev_res.unschedulable)
                    + len(orc_res.unschedulable)):
                dev_res, orc_res = dev2, orc2

        # union after internal sub-solves: a nested split already recorded
        # its oracle's verdicts
        self._last_oracle_judged = (self._last_oracle_judged
                                    | set(orc_res.unschedulable))
        return self._merge_split(inp, dev_res, orc_res, residue_pods)

    def _augment_with_claims(self, inp: ScheduleInput,
                             residue_pods: List[Pod],
                             supported_pods: List[Pod],
                             dev_res: ScheduleResult) -> ScheduleInput:
        """The residue oracle's input: the original cluster state with the
        device solve's placements folded in — existing nodes lose the
        capacity the device assigned onto them, and each new claim becomes
        a synthetic existing node (pinned to a concrete zone and capacity
        type so the residue's topology terms count its pods)."""
        by_pod = {p.meta.name: p for p in supported_pods}
        assigned: Dict[str, List[Pod]] = {}
        for pod_name, node_name in dev_res.existing_assignments.items():
            assigned.setdefault(node_name, []).append(by_pod[pod_name])

        existing: List = []
        for en in inp.existing_nodes:
            extra = assigned.get(en.name)
            if not extra:
                existing.append(en)
                continue
            avail = en.available.copy()
            for pod in extra:
                avail = avail - effective_request(pod)
            existing.append(dataclasses.replace(
                en, available=avail, pods=list(en.pods) + extra))

        types_by_pool = {
            pool: {it.name: it for it in lst}
            for pool, lst in inp.instance_types.items()}
        used_by_pool: Dict[str, Resources] = {}
        for claim in dev_res.new_claims:
            self._pin_claim(claim, types_by_pool.get(claim.nodepool, {}))
            it = types_by_pool.get(claim.nodepool, {}).get(
                claim.instance_type_names[0]) if claim.instance_type_names \
                else None
            if it is None:
                continue
            labels = {r.key: next(iter(r.values()))
                      for r in claim.requirements
                      if r.is_finite() and len(r.values()) == 1}
            labels[wellknown.NODEPOOL_LABEL] = claim.nodepool
            labels[wellknown.INSTANCE_TYPE_LABEL] = \
                claim.instance_type_names[0]
            alloc = it.allocatable()
            # synthetic nodes are PURCHASES: pods the oracle folds onto
            # them still consume the pool limit (charge_pool)
            existing.append(ExistingNode(
                node=Node(meta=ObjectMeta(name=claim.hostname,
                                          labels=labels),
                          allocatable=alloc, taints=list(claim.taints),
                          ready=True),
                available=alloc - claim.requests,
                pods=list(claim.pods),
                charge_pool=claim.nodepool))
            u = used_by_pool.setdefault(claim.nodepool, Resources())
            used_by_pool[claim.nodepool] = u + claim.requests

        limits = dict(inp.remaining_limits)
        for pool, used in used_by_pool.items():
            lim = limits.get(pool)
            if lim is not None:
                limits[pool] = lim - used

        return dataclasses.replace(
            inp, pods=residue_pods, existing_nodes=existing,
            remaining_limits=limits)

    @staticmethod
    def _best_offering(it, requirements):
        """Cheapest available offering of `it` consistent with the claim's
        zone/capacity-type requirements (None when nothing qualifies)."""
        zreq = requirements.get(wellknown.ZONE_LABEL)
        creq = requirements.get(wellknown.CAPACITY_TYPE_LABEL)
        zones = zreq.values() if zreq is not None and zreq.is_finite() \
            else None
        cts = creq.values() if creq is not None and creq.is_finite() \
            else None
        best = None
        for o in it.offerings:
            if not o.available:
                continue
            if zones is not None and o.zone not in zones:
                continue
            if cts is not None and o.capacity_type not in cts:
                continue
            if best is None or o.price < best.price:
                best = o
        return best

    @classmethod
    def _pin_claim(cls, claim, types_by_name: Dict[str, object]) -> None:
        """Narrow a claim to one concrete (zone, capacity-type): the
        cheapest available offering of its top-ranked type consistent with
        its requirements."""
        if not claim.instance_type_names:
            return
        it = types_by_name.get(claim.instance_type_names[0])
        if it is None:
            return
        best = cls._best_offering(it, claim.requirements)
        if best is None:
            return
        reqs = claim.requirements
        reqs = reqs.intersection(Requirements(Requirement.make(
            wellknown.ZONE_LABEL, "In", best.zone)))
        reqs = reqs.intersection(Requirements(Requirement.make(
            wellknown.CAPACITY_TYPE_LABEL, "In", best.capacity_type)))
        claim.requirements = reqs
        claim.price = best.price

    def _merge_split(self, inp: ScheduleInput, dev_res: ScheduleResult,
                     orc_res: ScheduleResult,
                     residue_pods: List[Pod]) -> ScheduleResult:
        """One result from the device result and the residue oracle's:
        pods the oracle placed on a synthetic claim-node join that claim,
        whose ranked types and price are refreshed."""
        res = ScheduleResult()
        res.existing_assignments = dict(dev_res.existing_assignments)
        res.unschedulable = {**dev_res.unschedulable,
                             **orc_res.unschedulable}
        claims_by_host = {c.hostname: c for c in dev_res.new_claims}
        pod_by_name = {p.meta.name: p for p in residue_pods}
        types_by_pool = {
            pool: {it.name: it for it in lst}
            for pool, lst in inp.instance_types.items()}
        for pod_name, node_name in orc_res.existing_assignments.items():
            claim = claims_by_host.get(node_name)
            if claim is None:
                res.existing_assignments[pod_name] = node_name
                continue
            pod = pod_by_name[pod_name]
            claim.pods.append(pod)
            claim.requests = claim.requests + effective_request(pod)
            # heavier usage can invalidate smaller types in the ranked
            # list; the top-ranked type always still fits
            tbn = types_by_pool.get(claim.nodepool, {})
            claim.instance_type_names = [
                t for t in claim.instance_type_names
                if t in tbn and claim.requests.fits(tbn[t].allocatable())]
            if claim.instance_type_names:
                best = self._best_offering(
                    tbn[claim.instance_type_names[0]], claim.requirements)
                if best is not None:
                    claim.price = best.price
        res.new_claims = list(dev_res.new_claims) + list(orc_res.new_claims)
        return res

    def _solve_relaxed(self, inp: ScheduleInput,
                       max_nodes: Optional[int] = None) -> ScheduleResult:
        """Group, then solve.  Pods with soft terms (preferences, preferred
        affinity, ScheduleAnyway spread) need the reference's relaxation
        loop around the solve, and gangs the gang fill: both come with
        slice 2b."""
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
                "(slice 2b)")
        if any(gang_of(g[0]) is not None for g in groups):
            # refused whether the encoder would express the gang (the
            # device gang fill) or hand it to the split path's oracle:
            # the gang repair and its verdicts come together
            raise UnsupportedPods(
                "gang groups need the gang fill (slice 2b)")
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

    @staticmethod
    def _check_supported(enc: EncodedProblem) -> None:
        """Raise for groups only a later slice's path can run."""
        n = enc.n_groups
        if enc.group_gang is not None and enc.group_gang[:n].any():
            raise UnsupportedPods(
                "gang groups need the gang fill (slice 2b)")
        gp = enc.group_priority
        if gp is not None and len(np.unique(gp[:n])) > 1:
            raise UnsupportedPods(
                "more than one priority band needs the priority witness "
                "(slice 2b)")

    def _solve_attempt(self, inp: ScheduleInput,
                       max_nodes: Optional[int] = None,
                       groups=None) -> ScheduleResult:
        mn = max_nodes or self._adaptive_max_nodes()
        # a pure-device attempt carries no oracle verdicts
        self._last_oracle_judged = set()
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
        self._check_supported(enc)
        if enc.n_columns == 0:
            # no purchasable capacity — existing nodes can still absorb
            # pods, exactly as the oracle fills them first.  The host fill
            # enforces per-node caps but not the per-domain quotas, so
            # domain-constrained groups go to the split path instead
            if (enc.group_dsel[:enc.n_groups] > 0).any():
                raise _SplitNeeded(
                    "zone/capacity-type-constrained pods with no "
                    "purchasable capacity")
            return self._existing_only(enc)

        G = bucket(enc.n_groups, G_BUCKETS)
        E = bucket(len(enc.existing), E_BUCKETS)
        Db = bucket(enc.n_domains, D_BUCKETS)
        dev = cat.device_args
        prob = self._problem_args(enc, G, E, Db, dev.O)
        exc = self._explain_mode()
        t2 = time.perf_counter()
        disp_s = dev_s = pull_s = 0.0
        cuda = self.device.type == "cuda"

        def execute(n):
            # dispatch (one upload, the kernel launches), then wait for
            # the device, then pull + unpack — timed separately
            nonlocal disp_s, dev_s, pull_s
            t_a = time.perf_counter()
            ptens = ffd.problem_tensors(prob, dev.O, self.device)
            flat = ffd.solve_ffd(ptens, dev, n, explain=exc)
            t_b = time.perf_counter()
            if cuda:
                torch.cuda.synchronize(self.device)
            t_c = time.perf_counter()
            out_ = ffd.unpack(flat.cpu().numpy(), G, E, n, R, Db,
                              explain=exc)
            t_d = time.perf_counter()
            disp_s += t_b - t_a
            dev_s += t_c - t_b
            pull_s += t_d - t_c
            return out_

        out = execute(mn)
        if (max_nodes is None and mn < self.max_nodes
                and out["unsched"].sum() > 0
                and out["num_active"] >= mn):
            # the warm-start bucket ran out of node slots: redo at the
            # configured ceiling
            mn = self.max_nodes
            out = execute(mn)
        self._last_slots_exhausted = bool(
            out["unsched"].sum() > 0 and out["num_active"] >= mn)
        if max_nodes is None:
            # capped sims (tiny explicit N) must not poison the warm-start
            self._last_active = int(out["num_active"])
        t3 = time.perf_counter()
        self._repair_whole_node(enc, out)
        self._repair_topology(enc, out)
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

    # -- the batched paths: the consolidation simulator ------------------
    # sweep-path bucket tiers: pod classes per sweep and exclusion indices
    # per simulation are tiny in practice; padding keeps the launch shapes
    # few across reconcile passes
    C_BUCKETS = (4, 16, 64, 256)
    X_BUCKETS = (1, 2, 4, 8)
    # top-K take_exist compaction tiers: K bounds the per-group node
    # fan-out, i.e. the max group COUNT in the batch — sweep sims carry one
    # candidate node's pods, so the smallest tier almost always holds
    K_BUCKETS = (8, 32, 128)

    def _pick_sparse_k(self, max_cnt: int, E_pad: int) -> int:
        """K for the top-K take_exist result compaction (0 = dense):
        bucket the max group count so the compaction is lossless, engage
        only when it shrinks the row past the padded existing axis.
        Shared by the sweep and the generic batched path."""
        Ks = bucket(min(max_cnt, max(E_pad, 1)), self.K_BUCKETS)
        return Ks if (E_pad > 0 and 2 * Ks < E_pad) else 0

    def _chunk_io(self):
        """(pipeline on, upload, pull, wait) for a batched chunk loop: with
        the pipeline on a card, the staging buffers' pinned upload, async
        pull and per-chunk event; otherwise one upload and a blocking pull
        per chunk."""
        pipe = pipelining.pipeline_enabled(self.device)
        if pipe and self.device.type == "cuda":
            st = pipelining.ChunkStaging()
            return pipe, st.upload, st.pull, st.wait

        def wait(flat):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return flat.cpu().numpy()
        return pipe, ffd._upload, (lambda flat: flat), wait

    def _try_sweep(self, inps: List[ScheduleInput], cat, mn: int,
                   explicit_cap: bool) -> Optional[List[ScheduleResult]]:
        """The leave-k-out fast path for the consolidation sweep: every
        input is 'the shared snapshot minus a few candidate nodes'
        (ScheduleInput.exist_base provenance).  The snapshot's node rows
        and per-class column masks upload ONCE; each simulation ships only
        its group rows, exclusion indices, price cap and pool budgets.

        Returns None when the batch-global preconditions fail (no base, no
        columns, synthetic charge-pool nodes); otherwise a result list with
        None HOLES for per-input-ineligible simulations (over-wide
        exclusion sets, inexpressible topology, gangs, preferences) — the
        caller solves the holes generically.

        Two kernel lanes: constraint-light sims take K4's light lane; sims
        whose every group is sweep-expressible (self-match dynamic zone/ct
        spread or anti, hostname caps — SweepTopologyTables) take the heavy
        lane with real per-sim topology tensors.
        """
        base = next((inp.exist_base for inp in inps if inp.exist_base),
                    None)
        if not base:
            return None
        if len(cat.columns) == 0:
            return None
        if any(en.charge_pool is not None for en in base):
            return None
        # per-INPUT eligibility: the shared snapshot, a bounded exclusion
        # set, no soft terms.  Ineligible inputs stay None in the result
        cand: List[int] = []
        for i, inp in enumerate(inps):
            if inp.exist_base is not base or inp.exist_excluded is None:
                continue
            if len(inp.exist_excluded) > self.X_BUCKETS[-1]:
                continue
            if any(p.preferences for p in inp.pods):
                continue  # relaxation ladder is host-driven
            cand.append(i)
        if not cand:
            return None

        t0 = time.perf_counter()
        shared = SharedExistEncoding(cat)
        shared.add_nodes(base)
        shared.freeze()
        E = len(base)
        Eb = bucket(E, E_BUCKETS)
        dev = cat.device_args
        O = dev.O
        O_real = len(cat.columns)
        tables = SweepTopologyTables(base, shared.zone, shared.ct,
                                     shared.zone_ids, shared.ct_ids)
        D = tables.D
        Db = bucket(D, D_BUCKETS)
        # resident required-anti terms block matching classes via the
        # tables (symmetric anti); when present, even constraint-free
        # classes need the topology check
        has_res_anti = bool(tables._res_anti)

        # per-class tables, interned by scheduling group id; topology
        # classes carry their static topology info alongside (hostname
        # clamps fold into the class's per-node cap row)
        class_row: Dict[int, int] = {}
        class_masks: List[np.ndarray] = []
        class_caps: List[np.ndarray] = []
        class_merged: List[list] = []
        class_topo: List[Optional[dict]] = []
        class_trivial: List[bool] = []

        def class_of(rep: Pod) -> int:
            gid = rep.scheduling_group_id()
            row = class_row.get(gid)
            if row is None:
                if gang_of(rep) is not None:
                    # gang units need the atomic K-node fill: the sim
                    # holes out to the generic batched path
                    raise Unsupported("gang unit in sweep")
                info = None
                if (has_res_anti or rep.topology_spread
                        or rep.pod_affinities):
                    info = tables.class_topo(rep)  # may raise Unsupported
                gmask, merged = group_column_mask(cat, rep)
                ok = shared.group_ok(rep)
                cap = np.where(ok, BIG, 0).astype(np.int32)
                if info is not None:
                    cap = np.minimum(cap, info["hostcap"])
                row = len(class_masks)
                class_row[gid] = row
                class_masks.append(gmask)
                class_caps.append(cap)
                class_merged.append(merged)
                class_topo.append(info)
                class_trivial.append(
                    info is None or (info["dyn"] is None
                                     and info["ncap"] >= BIG
                                     and bool((info["hostcap"] >= BIG).all())))
            return row

        # per-sim group rows (variable G, padded per chunk); lane chosen
        # by class triviality — a sim whose every class is untouched by
        # topology takes the light lane
        sims = {}
        plain: List[int] = []
        topo: List[int] = []
        for i in cand:
            groups = group_pods(inps[i].pods)
            try:
                # a DoNotSchedule spread or required affinity selector
                # matching another pending group's labels couples their
                # placements mid-solve — hole
                for g in groups:
                    if not (g[0].topology_spread or g[0].pod_affinities):
                        continue
                    for sel in ([c.label_selector
                                 for c in g[0].topology_spread
                                 if c.when_unsatisfiable == "DoNotSchedule"]
                                + [t.label_selector
                                   for t in g[0].pod_affinities
                                   if t.required]):
                        for h in groups:
                            if h is not g and _matches(
                                    sel, h[0].meta.labels):
                                raise Unsupported(
                                    "selector couples pending groups")
                gcls = np.array([class_of(g[0]) for g in groups],
                                dtype=np.int32)
            except Unsupported:
                continue  # stays a hole for the generic path
            heavy_sim = any(not class_trivial[c] for c in gcls)
            if heavy_sim and cat.layout != "grid":
                # the heavy step reads a column's domain from its grid
                # slot — dense layouts hole out
                continue
            greq = np.stack([
                np.asarray(effective_request(g[0]).v, dtype=np.float32)
                for g in groups]) if groups else np.zeros((0, R), np.float32)
            gcount = np.array([len(g) for g in groups], dtype=np.int32)
            sims[i] = (groups, gcls, greq, gcount)
            (topo if heavy_sim else plain).append(i)
        eligible = plain + topo
        if not eligible:
            return None

        G = bucket(max((len(s[0]) for s in sims.values()), default=1),
                   G_BUCKETS)
        Xb = bucket(max((len(inps[i].exist_excluded) for i in eligible),
                        default=1), self.X_BUCKETS)
        C = bucket(len(class_masks), self.C_BUCKETS)
        P = max(len(cat.pools), 1)

        class_mask = np.zeros((C, O), dtype=bool)
        class_cap = np.zeros((C, Eb), dtype=np.int32)
        if class_masks:
            class_mask[:len(class_masks), :O_real] = np.stack(class_masks)
            class_cap[:len(class_caps), :E] = np.stack(class_caps)
        exist_remaining = np.zeros((Eb, R), dtype=np.float32)
        exist_remaining[:E] = shared._avail
        exist_zone = np.full(Eb, -1, dtype=np.int32)
        exist_zone[:E] = shared.zone
        exist_ct = np.full(Eb, -1, dtype=np.int32)
        exist_ct[:E] = shared.ct
        # the host class_mask stays dense: decode rebuilds each sim's
        # EncodedProblem from it; the card gets column bits
        shared_dev = ffd.sweep_shared_tensors(dict(
            class_mask=class_mask, class_cap=class_cap,
            exist_remaining=exist_remaining, exist_zone=exist_zone,
            exist_ct=exist_ct,
            col_price=self._pad(cat.col_price.astype(np.float32), 0, O,
                                value=np.inf)), O, self.device)
        encode_ms = (time.perf_counter() - t0) * 1000.0

        device_ms = 0.0
        decode_ms = 0.0
        out_results: List[Optional[ScheduleResult]] = [None] * len(inps)
        zone_values = [None] * len(shared.zone_ids)
        for z, i in shared.zone_ids.items():
            zone_values[i] = z
        ct_values = [None] * len(shared.ct_ids)
        for ctv, i in shared.ct_ids.items():
            ct_values[i] = ctv

        # top-K result compaction: a group of c pods touches at most c
        # existing nodes, so K = bucket(max group count) makes the packed
        # take_exist row lossless at a fraction of the dense G*Eb size
        max_cnt = 1
        for i in eligible:
            gcount_i = sims[i][3]
            if gcount_i.size:
                max_cnt = max(max_cnt, int(gcount_i.max()))
        sparse_k = self._pick_sparse_k(max_cnt, Eb)

        def decode_chunk(idxs, packed, pcap, plims, heavy, topo_rows):
            nonlocal decode_ms
            t2 = time.perf_counter()
            # every sim decodes against the SAME shared list — let _decode
            # cache its name list while this chunk decodes (the cache
            # itself is released when the sweep returns)
            self._in_sweep_decode = True
            try:
                for bi, i in enumerate(idxs):
                    groups, cls_i, greq_i, gcount_i = sims[i]
                    out = ffd.unpack(packed[bi], G, Eb, mn, R,
                                     Db if heavy else 1, sparse_k=sparse_k)
                    exhausted = bool(out["unsched"].sum() > 0
                                     and out["num_active"] >= mn)
                    g = len(groups)
                    keep = np.ones(E, dtype=bool)
                    ex = [e for e in inps[i].exist_excluded if e < E]
                    keep[ex] = False
                    if heavy:
                        tr = topo_rows
                        dn = Db
                        ncap_i = tr["group_ncap"][bi, :g]
                        dsel_i = tr["group_dsel"][bi, :g]
                        dbase_i = tr["group_dbase"][bi, :g]
                        dcap_i = tr["group_dcap"][bi, :g]
                        skew_i = tr["group_skew"][bi, :g]
                        mindom_i = tr["group_mindom"][bi, :g]
                        delig_i = tr["group_delig"][bi, :g]
                    else:
                        dn = 1
                        ncap_i = np.full(g, BIG, dtype=np.int32)
                        dsel_i = np.zeros(g, dtype=np.int32)
                        dbase_i = np.zeros((g, 1), dtype=np.int32)
                        dcap_i = np.full((g, 1), BIG, dtype=np.int32)
                        skew_i = np.full(g, BIG, dtype=np.int32)
                        mindom_i = np.zeros(g, dtype=np.int32)
                        delig_i = np.zeros((g, 1), dtype=bool)
                    enc = EncodedProblem(
                        group_req=greq_i,
                        group_count=gcount_i,
                        group_mask=(class_mask[cls_i, :O_real]
                                    & (cat.col_price < pcap[bi])[None, :]
                                    if g else np.zeros((0, O_real), bool)),
                        exist_cap=(class_cap[cls_i, :E] * keep[None, :]
                                   if g else np.zeros((0, E), np.int32)),
                        exist_remaining=shared._avail * keep[:, None],
                        col_alloc=cat.col_alloc,
                        col_daemon=cat.col_daemon,
                        col_price=cat.col_price,
                        col_pool=cat.col_pool,
                        pool_limit=plims[bi],
                        group_ncap=ncap_i,
                        group_dsel=dsel_i,
                        group_dbase=dbase_i,
                        group_dcap=dcap_i,
                        group_skew=skew_i,
                        group_mindom=mindom_i,
                        group_delig=delig_i,
                        col_zone=cat.col_zone,
                        col_ct=cat.col_ct,
                        exist_zone=shared.zone,
                        exist_ct=shared.ct,
                        zone_values=zone_values,
                        ct_values=ct_values,
                        n_domains=dn,
                        static_allowed=[
                            {wellknown.ZONE_LABEL: None,
                             wellknown.CAPACITY_TYPE_LABEL: None}
                            for _ in range(g)],
                        groups=groups,
                        columns=cat.columns,
                        existing=base,
                        pools=cat.pools,
                        merged_reqs=[class_merged[c] for c in cls_i],
                    )
                    if heavy:
                        # per-domain quotas are planned against a capacity
                        # estimate: a starved domain hands pods to another
                        self._repair_topology(enc, out)
                    res = self._decode(enc, out)
                    if res.unschedulable and not (explicit_cap and exhausted):
                        # a stranding WITHOUT slot pressure earns the oracle
                        # rescue; only an explicit caller cap earns the
                        # cheap slot-exhaustion reject
                        self._residue_counted = set()
                        self._last_oracle_judged = set()
                        res = self._rescue_stranded(inps[i], res)
                    out_results[i] = res
            finally:
                self._in_sweep_decode = False
            decode_ms += (time.perf_counter() - t2) * 1000.0

        chunk_size = B_BUCKETS[-1]
        # the chunk pipeline (solver/pipeline.py): on a card, chunk i+1
        # builds, uploads and launches while chunk i runs; then chunk i
        # pulls and decodes
        pipe, upload, pull, wait = self._chunk_io()
        chunk_items = [(lane, members[start:start + chunk_size])
                       for lane, members in (("light", plain),
                                             ("heavy", topo))
                       for start in range(0, len(members), chunk_size)]

        def dispatch_chunk(item):
            # stage 1: build the per-sim rows, upload, launch — never
            # block on device results
            nonlocal device_ms
            lane, idxs = item
            t1 = time.perf_counter()
            B = bucket(len(idxs), B_BUCKETS)
            greq = np.zeros((B, G, R), dtype=np.float32)
            gcount = np.zeros((B, G), dtype=np.int32)
            gcls = np.zeros((B, G), dtype=np.int32)
            excl = np.full((B, Xb), -1, dtype=np.int32)
            pcap = np.full(B, np.inf, dtype=np.float32)
            plim = np.full((B, P, R), np.inf, dtype=np.float32)
            rows = dict(group_req=greq, group_count=gcount,
                        group_class=gcls, exclude_idx=excl, price_cap=pcap,
                        pool_limit=plim)
            topo_rows = None
            if lane == "heavy":
                topo_rows = dict(
                    group_ncap=np.full((B, G), BIG, dtype=np.int32),
                    group_dsel=np.zeros((B, G), dtype=np.int32),
                    group_dbase=np.zeros((B, G, Db), dtype=np.int32),
                    group_dcap=np.zeros((B, G, Db), dtype=np.int32),
                    group_skew=np.full((B, G), BIG, dtype=np.int32),
                    group_mindom=np.zeros((B, G), dtype=np.int32),
                    group_delig=np.zeros((B, G, Db), dtype=bool),
                )
                rows.update(topo_rows)
            for bi, i in enumerate(idxs):
                groups, cls_i, greq_i, gcount_i = sims[i]
                g = len(groups)
                greq[bi, :g] = greq_i
                gcount[bi, :g] = gcount_i
                gcls[bi, :g] = cls_i
                ex = inps[i].exist_excluded
                excl[bi, :len(ex)] = ex
                if inps[i].price_cap is not None:
                    pcap[bi] = inps[i].price_cap
                for pidx, pool in enumerate(cat.pools):
                    lim = inps[i].remaining_limits.get(pool.name)
                    if lim is not None:
                        plim[bi, pidx] = np.asarray(lim.v,
                                                    dtype=np.float32)
                if lane == "heavy":
                    for grow, c in enumerate(cls_i):
                        info = class_topo[c]
                        if info is None:
                            # topology-free group in a topo sim: BIG dcap
                            # keeps the heavy step inert
                            topo_rows["group_dcap"][bi, grow, :] = BIG
                            continue
                        dbase_g, dcap_g = tables.sim_tensors(info, ex)
                        topo_rows["group_ncap"][bi, grow] = info["ncap"]
                        topo_rows["group_dsel"][bi, grow] = info["dsel"]
                        topo_rows["group_dbase"][bi, grow, :D] = dbase_g
                        topo_rows["group_dcap"][bi, grow, :D] = dcap_g
                        dyn = info["dyn"]
                        topo_rows["group_skew"][bi, grow] = (
                            dyn["skew"] if dyn is not None else BIG)
                        topo_rows["group_mindom"][bi, grow] = (
                            dyn["mindom"] if dyn is not None else 0)
                        topo_rows["group_delig"][bi, grow, :D] = \
                            info["delig"]
            sw = ffd.sweep_tensors(rows, shared_dev, self.device,
                                   upload=upload)
            handle = pull(ffd.solve_ffd_sweep(sw, dev, mn, sparse_k))
            device_ms += (time.perf_counter() - t1) * 1000.0
            return (handle, pcap, plim, topo_rows)

        def complete_chunk(item, handle):
            # stage 2: wait for this chunk's rows (the wait overlaps the
            # NEXT chunk's device run when the pipeline is on) and decode
            nonlocal device_ms
            lane, idxs = item
            h, pcap, plim, topo_rows = handle
            t1 = time.perf_counter()
            packed = wait(h)
            device_ms += (time.perf_counter() - t1) * 1000.0
            decode_chunk(idxs, packed, pcap, plim, lane == "heavy",
                         topo_rows)

        try:
            pipelining.run_pipeline(chunk_items, dispatch_chunk,
                                    complete_chunk, enabled=pipe)
        finally:
            # the exist-names cache exists for THIS sweep's shared list;
            # keeping it past the return — an exception exit included —
            # would pin the whole node+pod snapshot in the solver
            self._exist_names_cache = None
            self._in_sweep_decode = False
        self.last_phase_ms = {
            "encode": encode_ms, "device": device_ms, "decode": decode_ms,
            "per_sim": ((encode_ms + device_ms + decode_ms) / len(eligible)
                        if eligible else 0.0)}
        return out_results

    def solve_batch(self, inps: List[ScheduleInput],
                    max_nodes: Optional[int] = None) -> List[ScheduleResult]:
        """Evaluate many scheduling problems that share one catalog — the
        consolidation simulator's candidate axis: one launch per chunk of
        up to 64 problems, one thread block each; per-problem pods,
        existing nodes and limits batch, the catalog is shared.

        All inputs must come from the same cluster snapshot (same
        nodepools and instance-type lists); `price_cap` may differ per
        input.  Inputs that carry the snapshot's provenance
        (`exist_base`/`exist_excluded`) take the leave-k-out sweep, the
        rest the generic batched solve, and what neither expresses the
        single-problem `solve`.

        `max_nodes` caps the new-node axis for THIS call: consolidation
        rejects any simulation needing more than one replacement node, so
        the simulator passes a tiny cap; a slot-exhausted sim reports
        unschedulable.  Gangs and more than one priority band raise
        UnsupportedPods (slice 2b).
        """
        if not inps:
            return []
        self._check_device()
        return self._solve_batch_inner(inps, max_nodes=max_nodes)

    def _solve_batch_inner(self, inps: List[ScheduleInput],
                           max_nodes: Optional[int] = None
                           ) -> List[ScheduleResult]:
        mn = max_nodes or self.max_nodes
        # soft-term pods: batch the common first round — every soft term
        # ENFORCED as hard (relaxed(0)) — and re-solve only the stragglers
        # whose enforced terms left pods unschedulable, individually
        soft = [i for i, inp in enumerate(inps)
                if any(p.has_soft_terms() for p in inp.pods)]
        if soft:
            round0 = list(inps)
            for i in soft:
                round0[i] = dataclasses.replace(
                    inps[i],
                    pods=[p.relaxed(0) for p in inps[i].pods])
            out = self.solve_batch(round0, max_nodes=max_nodes)
            for i in soft:
                r = out[i]
                if r is not None and r.unschedulable and any(
                        p.relax_levels() for p in inps[i].pods):
                    # the ORIGINAL input: relaxation starts from the pod's
                    # true soft ladder (solve raises until slice 2b)
                    out[i] = self.solve(inps[i], max_nodes=max_nodes)
            return out
        cat = self._catalog_encoding(inps[0])
        sweep = self._try_sweep(inps, cat, mn,
                                explicit_cap=max_nodes is not None)
        if sweep is not None:
            # PARTIAL sweep: ineligible inputs come back as None holes and
            # solve through the generic path below
            holes = [i for i, r in enumerate(sweep) if r is None]
            if holes:
                # the holes' nested solves overwrite last_phase_ms; the
                # sweep's timings are the ones to report
                sweep_phases = self.last_phase_ms
                rest = self.solve_batch([inps[i] for i in holes],
                                        max_nodes=max_nodes)
                self.last_phase_ms = sweep_phases
                for i, r in zip(holes, rest):
                    sweep[i] = r
            return sweep
        # per-input encoding: an inexpressible input routes through the
        # individual solve (split path) WITHOUT demoting the rest of the
        # batch.  A per-batch union cache of existing-node encodings serves
        # simulations that share one snapshot's node OBJECTS; when sharing
        # does not materialize (the union balloons) the cache is dropped
        shared = SharedExistEncoding(cat)
        for inp in inps:
            shared.add_input(inp)
        max_e = max((len(inp.existing_nodes) for inp in inps), default=0)
        if max_e == 0 or len(shared._nodes) > 2 * max_e:
            shared = None
        else:
            shared.freeze()
        encs: List = []          # (orig_index, EncodedProblem)
        singles: List[int] = []  # orig indices needing individual solves
        for i, inp in enumerate(inps):
            try:
                encs.append((i, self._encode_checked(
                    inp, cat, exist_shared=shared)))
            except Unsupported:
                singles.append(i)
        if len(cat.columns) == 0:
            return [self.solve(inp, max_nodes=max_nodes) for inp in inps]

        out_results: List[Optional[ScheduleResult]] = [None] * len(inps)
        for i in singles:
            out_results[i] = self.solve(inps[i], max_nodes=max_nodes)
        if not encs:
            return out_results
        for _, e in encs:
            self._check_supported(e)
        G = bucket(max(e.n_groups for _, e in encs), G_BUCKETS)
        E = bucket(max(len(e.existing) for _, e in encs), E_BUCKETS)
        Db = bucket(max(e.n_domains for _, e in encs), D_BUCKETS)
        dev = cat.device_args
        O = dev.O
        # the same top-K result compaction as the sweep path
        max_cnt = 1
        for _, e in encs:
            for pods in e.groups:
                max_cnt = max(max_cnt, len(pods))
        sparse_k = self._pick_sparse_k(max_cnt, E)
        # the explain counts for UNCAPPED batches only (real provisioning
        # requests); capped consolidation sims stay aux-free
        exc_b = min(self._explain_mode(), 1) if max_nodes is None else 0
        pipe, upload, pull, wait = self._chunk_io()
        chunk_size = B_BUCKETS[-1]
        chunks = [encs[s:s + chunk_size]
                  for s in range(0, len(encs), chunk_size)]

        def dispatch(chunk):
            # stage 1: build + upload + launch, never block
            B = bucket(len(chunk), B_BUCKETS)
            probs = [self._problem_args(e, G, E, Db, O) for _, e in chunk]
            # pad the batch axis with empty problems (zero groups = no
            # work), so repeat calls see few launch shapes
            while len(probs) < B:
                probs.append(tuple(np.zeros_like(a) for a in probs[0]))
            batch = ffd.batch_tensors(probs, O, self.device, upload=upload)
            return pull(ffd.solve_ffd_batch(batch, dev, mn, exc_b,
                                            sparse_k))

        def complete(chunk, handle):
            # stage 2: wait for this chunk's rows, repair and decode
            packed = wait(handle)
            for bi, (i, enc) in enumerate(chunk):
                out = ffd.unpack(packed[bi], G, E, mn, R, Db,
                                 sparse_k=sparse_k, explain=exc_b)
                if exc_b:
                    self._note_explain(enc, out)
                # judged BEFORE topology repair, as solve() judges it
                exhausted = bool(out["unsched"].sum() > 0
                                 and out["num_active"] >= mn)
                self._repair_whole_node(enc, out)
                self._repair_topology(enc, out)
                res = self._decode(enc, out)
                if res.unschedulable and not (
                        max_nodes is not None and exhausted):
                    # a sim the kernel strands WITHOUT slot pressure gets
                    # the oracle rescue; only an EXPLICIT caller cap earns
                    # the cheap slot-exhaustion reject, as in solve()
                    self._residue_counted = set()
                    self._last_oracle_judged = set()
                    res = self._rescue_stranded(inps[i], res)
                out_results[i] = res

        pipelining.run_pipeline(chunks, dispatch, complete, enabled=pipe)
        return out_results

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

    def _repair_topology(self, enc: EncodedProblem,
                         out: Dict[str, np.ndarray]) -> None:
        """The kernel's per-domain quotas are planned against a capacity
        ESTIMATE (new-node slots and pool budgets are shared across
        domains); when a domain achieves less than planned, another may end
        above the final skew ceiling.  Strip the excess placements here so
        every emitted placement is skew-valid (DoNotSchedule is a hard
        constraint) — the stripped pods report unschedulable, as the
        oracle does when capacity starves a domain."""
        Er = len(enc.existing)
        num_active = int(out["num_active"])
        for gi in range(enc.n_groups):
            dsel = int(enc.group_dsel[gi])
            skew = int(enc.group_skew[gi])
            if dsel == 0 or skew >= BIG:
                continue
            D = enc.n_domains
            elig = enc.group_delig[gi]
            if not elig.any():
                continue
            placed = out["dom_placed"][gi][:D].astype(np.int64)
            f = enc.group_dbase[gi].astype(np.int64) + placed
            m = int(f[elig].min())
            if (enc.group_mindom[gi] > 0
                    and int((f[elig] > 0).sum()) < int(enc.group_mindom[gi])):
                m = 0
            limit = m + skew
            node_dom = out["node_zone"] if dsel == 1 else out["node_ct"]
            ex_dom = enc.exist_zone if dsel == 1 else enc.exist_ct
            req = enc.group_req[gi]
            for d in np.nonzero(elig & (f > limit))[0]:
                excess = int(f[d] - limit)
                removed = 0
                # strip new nodes last-first (the partial node empties
                # first)
                for ni in range(num_active - 1, -1, -1):
                    if removed >= excess:
                        break
                    if node_dom[ni] != d:
                        continue
                    k = int(out["take_new"][gi, ni])
                    if k <= 0:
                        continue
                    r = min(k, excess - removed)
                    out["take_new"][gi, ni] -= r
                    out["used"][ni] -= r * req
                    removed += r
                for ei in range(Er - 1, -1, -1):
                    if removed >= excess:
                        break
                    if ex_dom[ei] != d:
                        continue
                    k = int(out["take_exist"][gi, ei])
                    if k <= 0:
                        continue
                    r = min(k, excess - removed)
                    out["take_exist"][gi, ei] -= r
                    removed += r
                out["unsched"][gi] += removed

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

        # the sweep decodes its simulations against the SAME shared
        # existing list: cache its names by identity while it runs
        cached = self._exist_names_cache
        if cached is not None and cached[0] is enc.existing:
            exist_names = cached[1]
        else:
            exist_names = [en.name for en in enc.existing]
            if self._in_sweep_decode:
                self._exist_names_cache = (enc.existing, exist_names)
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
                name = exist_names[ei]
                for pod in pods[cursor:cursor + k]:
                    res.existing_assignments[pod.meta.name] = name
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
