"""TorchSolver — the provisioning solve and the consolidation sweep on the
card.

`solve`: encode (host, numpy) → the FFD scan (K5 at B=1, its heavy step
for classes with a zone or capacity-type spread or anti-affinity, its gang
instance for problems that hold a gang, the priority inversion witness for
problems with more than one priority band, the explain rows in its
epilogue; CUDA kernels, solver/ffd.py) → host repair (whole-node, gang
atomicity, topology skew) → decode (host), each stranded group's verdict a
reason code with its reason tree → the preemption planner
(`solver/preempt.py`) for pods that outrank evictable residents.
`solve_batch`: many simulations of one cluster snapshot — the
leave-k-out sweep (K4, light and heavy lanes) for inputs that carry the
snapshot's provenance, the generic batched scan (K5) for the rest, a
chunk of up to 64 problems per launch, pipelined.  The port of `karpenter_tpu/solver/solve.py` `TPUSolver`, with
its host paths around the device solve:

  * the steady-state seams of a real solve (solver/delta.py,
    solver/incr.py): the delta pass reuses the unchanged prefix of the
    previous solve's FFD order and runs only the changed suffix, seeded
    with the prefix's replayed state, through K6 (`_try_delta`); a cold
    pass of many pod classes runs as a chain of seeded chunk solves whose
    successors dispatch from a speculated entry state (`_try_spec`); and
    with a live watch feed the incremental group index replaces the
    grouping walk (`_try_incr_groups`).  Each is bit-identical to the full
    solve or a counted fallback to it;

  * the split path: groups the encoding cannot express (custom topology
    keys, two dynamic keys, coupled selectors) go to the host oracle
    (`scheduling/oracle.py`) after the device solve of the rest;
  * the rescue: pods the scan strands on a real solve are re-judged by
    the oracle against the device placements;
  * the pool-limit backstop: when pods strand on a binding pool limit, one
    oracle solve of the whole input, kept if it strands fewer.

Soft terms (preferences, preferred affinity, ScheduleAnyway spread) go
through the reference's bounded relaxation loop around the solve
(`_solve_relaxed`).  `UnsupportedPods` is left for inputs that neither the
device solve nor the split path can take, as in the reference.
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
from karpenter_tpu_torch.scheduling.oracle import Scheduler
from karpenter_tpu_torch.native import hostops
from karpenter_tpu_torch.scheduling.types import (
    ExistingNode,
    NewNodeClaim,
    PodSegments,
    ScheduleInput,
    ScheduleResult,
    effective_request,
    gang_of,
    min_values_violation,
)
from karpenter_tpu_torch.scheduling.types import priority_of
from karpenter_tpu_torch.solver import delta as deltam
from karpenter_tpu_torch.solver import explain as explainmod
from karpenter_tpu_torch.solver import ffd, firstuse
from karpenter_tpu_torch.solver import pipeline as pipelining
from karpenter_tpu_torch.solver.encode import (
    BIG,
    D_BUCKETS,
    EncodedProblem,
    SharedExistEncoding,
    SweepTopologyTables,
    Unsupported,
    _has_required_anti,
    _matches,
    _np_fit_count,
    bucket,
    encode,
    encode_catalog,
    group_column_mask,
    group_pods,
)
from karpenter_tpu_torch.utils import faults, knobs, metrics, tracing
from karpenter_tpu_torch.utils.knobs import priority_enabled

R = len(RESOURCE_AXIS)

B_BUCKETS = (4, 16, 64)  # simulate-batch axis: problems per launch
G_BUCKETS = (1, 4, 8, 16, 32, 128, 512, 2048)
E_BUCKETS = (0, 16, 64, 128, 256, 512, 1024, 2048, 4096)
PT_ALIGN = 64  # (pool,type) axis padding; column axis O = PT_pad × ZC
# the chunk chain's soft cap on chunks per pass (see _plan_spec_chunks)
SPEC_MAX_CHUNKS = 8

# synthetic claim hostnames, interned: the decode stamps one per active
# node per solve (the native claim loop reads this list)
_HOSTNAME_CACHE: List[str] = []


def _hostname(ni: int) -> str:
    cache = _HOSTNAME_CACHE
    if ni >= len(cache):
        cache.extend(f"tpu-solver-node-{i}"
                     for i in range(len(cache), ni + 256))
    return cache[ni]


def _knob(name: str, spec):
    """One steady-state knob resolved, in the reference's grammar: the
    environment variable `name` (KARPENTER_TPU_DELTA, _SPEC, _INCR) —
    "off"/"0"/"false"/"none", "on"/"1"/"true"/"yes" or "auto" — overrides
    the constructed `spec`; unset or malformed leaves it.  Returns False
    (disabled), "on" (forced) or "auto"."""
    import os
    raw = os.environ.get(name, "").strip().lower()
    if raw in ("off", "0", "false", "none"):
        spec = None
    elif raw in ("on", "1", "true", "yes"):
        spec = "on"
    elif raw == "auto":
        spec = "auto"
    if spec in (None, 0, False, "off", ""):
        return False
    return "on" if spec == "on" else "auto"


class UnsupportedPods(Exception):
    """Raised when this port cannot solve the batch; the message names the
    slice that brings the missing path."""


class _SplitNeeded(Exception):
    """The device attempt cannot take this input as a whole: the split
    path decides (the reference's UnsupportedPods inside the solver)."""


class TorchSolver:
    def __init__(self, max_nodes: int = 1024, device="cuda", delta="auto",
                 spec="auto", incr="auto", mesh="auto"):
        """`device`: where the kernels run — "cuda" (the default, the
        card) or "cpu" (the kernels' plain PyTorch versions; the tests
        use it).  With "cuda" and no CUDA device, `solve` raises
        RuntimeError rather than run anywhere else.

        The steady-state knobs, as the reference's: `delta` — "auto"
        engages the delta pass on repeats of problems with at least
        `delta.DELTA_MIN_GROUPS` pod classes, "on" regardless of size,
        "off"/None never; `spec` — "auto" chunks passes of at least
        `delta.SPEC_MIN_GROUPS` classes, "on" any size, "off"/None never;
        `incr` — "auto" engages the incremental group index once
        `incr_arm()` declares a live watch feed, "on" always, "off"/None
        never.  KARPENTER_TPU_DELTA, KARPENTER_TPU_SPEC and
        KARPENTER_TPU_INCR (on/off/auto) override the constructed values;
        each is resolved once, at the first solve.

        `mesh`: the column-sharded solve (`parallel.resolve_mesh`) — an
        integer S > 1 splits the catalog's offering columns over S shards:
        on the first S cards, one rank a card (K7x), when the host has at
        least S, else K7's S thread blocks in one cluster on one card;
        "auto" takes every card when there is more than one (on "cpu", or
        on one card, the single-device path, as the reference's); a
        `parallel.Mesh` is taken as it is; "off"/None/0 is the
        single-device path.  Cards without peer access between them raise.
        KARPENTER_TPU_MESH (off/0, auto, an integer) overrides it; resolved
        once."""
        self.max_nodes = max_nodes
        self.device = torch.device(device)
        self._mesh_spec = mesh
        self._mesh = None
        self._mesh_resolved = False
        self._mesh_exec = None  # parallel.MeshExecutor once resolved
        self._delta_spec, self._delta_resolved = delta, None
        self._spec_spec, self._spec_resolved = spec, None
        self._incr_spec, self._incr_resolved = incr, None
        self._incr_armed = False
        self._incr_hints = None
        self._delta_cache = deltam.SolveCache()
        self._delta_consumed = None
        # every pass through a seam, counted (the reference's
        # solver_{delta,spec,incr}_passes metrics): {"delta"|"spec"|"incr"
        # | "fallback": n} and the fallbacks by reason; the chain's chunk
        # boundaries by verdict (committed / repaired)
        self.delta_passes: Dict[str, int] = {}
        self.delta_fallbacks: Dict[str, int] = {}
        self.spec_passes: Dict[str, int] = {}
        self.spec_fallbacks: Dict[str, int] = {}
        self.spec_chunks: Dict[str, int] = {}
        self.incr_passes: Dict[str, int] = {}
        self.incr_fallbacks: Dict[str, int] = {}
        # the last chain's verdict ({"outcome": "spec", "chunks": K,
        # "committed": c, "repaired": r} or {"outcome": "fallback",
        # "reason": ...}), None when the seam was off
        self.last_spec: Optional[Dict] = None
        self._cat_entry = None
        self._last_active: Optional[int] = None  # node-axis warm start
        # the widest new-node fan-out of one group in the last real solve
        # (the flight record's `topk_segments` knob) and the last chain's
        # chunk count (0 on every non-chunked path)
        self._last_new_segments: Optional[int] = None
        self._last_spec_chunks = 0
        # the flight record's prelude, set by each _solve_attempt: the
        # first-use count at its start and the full capture's path
        self._flight_fu0 = 0
        self._flight_capture: Optional[str] = None
        self._last_slots_exhausted = False
        self._pregroup_ms = 0.0
        self._explain_resolved: Optional[int] = None
        # per-pod reason trees: built for REAL solves only (a capped
        # consolidation sim strands by design)
        self._explain_trees = False
        # gang groups the host atomicity net stranded (never expected:
        # the gang fill commits all-or-nothing)
        self.gang_repairs = 0
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
        # pinned staging slots by depth (`_staging`)
        self._stagings: Dict[int, "pipelining.ChunkStaging"] = {}
        # the relaxation loop's wall-clock budget per solve (None =
        # unbounded), the outermost call's deadline, and its counts (the
        # reference's RELAXATION_* metrics): solves that relaxed, rounds
        # run, budget exits
        self.relax_budget_s = knobs.relax_budget_s()
        self._relax_deadline: Optional[float] = None
        self.relax_counts: Dict[str, int] = {
            "solves": 0, "rounds": 0, "budget_exceeded": 0}

    def _check_device(self) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver(device='cuda'): no CUDA device is available "
                "(pass device='cpu' to run the kernels' plain versions)")

    def _explain_mode(self) -> int:
        """KARPENTER_TPU_EXPLAIN (off, counts or full: 0, 1, 2), resolved
        once per solver."""
        if self._explain_resolved is None:
            self._explain_resolved = explainmod.mode()
        return self._explain_resolved

    def _explain_kernel_mode(self) -> int:
        """The explain level the solve's kernels run at: the resolved
        mode, clamped to counts under a mesh (the [G, O] class map has no
        sharded form, ffd.py:374)."""
        exc = self._explain_mode()
        if exc >= 2 and self._resolve_mesh() is not None:
            return 1
        return exc

    # -- the mesh ----------------------------------------------------------
    @property
    def mesh(self):
        """The resolved mesh (None = single-device)."""
        return self._resolve_mesh()

    def _resolve_mesh(self):
        if self._mesh_resolved:
            return self._mesh
        self._mesh_resolved = True
        from karpenter_tpu_torch.parallel import (MeshExecutor, probe_cards,
                                                  resolve_mesh)
        spec = knobs.mesh_spec(self._mesh_spec)
        count, peer = (probe_cards() if self.device.type == "cuda"
                       else (0, ()))
        mesh = resolve_mesh(spec, count, peer, self.device)
        if mesh is not None:
            self._mesh_exec = MeshExecutor(mesh)
        self._mesh = mesh
        return mesh

    def _pt_align(self) -> int:
        """The (pool,type) axis pads to lcm(PT_ALIGN, mesh size), so the
        column axis O = PT_pad x ZC splits over the shards on whole
        (pool,type) blocks, for every mesh size (6 included)."""
        mesh = self._resolve_mesh()
        if mesh is None:
            return PT_ALIGN
        import math
        return PT_ALIGN * mesh.size // math.gcd(PT_ALIGN, mesh.size)

    # -- the steady-state knobs ------------------------------------------
    def _resolve_delta(self):
        """The delta mode: False, "auto" (min-size gated) or "on"."""
        if self._delta_resolved is None:
            self._delta_resolved = _knob("KARPENTER_TPU_DELTA",
                                         self._delta_spec)
        return self._delta_resolved

    def _resolve_spec(self):
        """The chunk-chain mode: False, "auto" (min-size gated) or "on"."""
        if self._spec_resolved is None:
            self._spec_resolved = _knob("KARPENTER_TPU_SPEC",
                                        self._spec_spec)
        return self._spec_resolved

    def _resolve_incr(self):
        """The incremental-index mode: False, "auto" (armed-gated) or
        "on"."""
        if self._incr_resolved is None:
            self._incr_resolved = _knob("KARPENTER_TPU_INCR",
                                        self._incr_spec)
        return self._incr_resolved

    def incr_arm(self) -> None:
        """Declare the event feed live: every pod/node/claim mutation
        reaches `delta_invalidate` with objects from now on, so the "auto"
        incremental index may trust the stream.  Callers that solve
        without a feed never arm, and auto mode stays on the walk."""
        self._incr_armed = True

    def delta_invalidate(self, pods=(), nodes=(), flood: bool = False,
                         pod_objs=None, node_objs=None, claims=()) -> None:
        """The event feed: pod names whose groups must re-encode, node
        names whose cached rows can no longer be trusted; flood=True when
        the event stream may have dropped entries (everything is dirty
        until a full solve refreshes the record).  `pod_objs`/`node_objs`
        map event names to their current objects (None = deleted) and
        `claims` lists nodeclaim event names: they feed the incremental
        group index; names without objects degrade the index to a counted
        fallback.  Thread-safe."""
        self._delta_cache.invalidate(
            pods=pods, nodes=nodes, flood=flood, pod_objs=pod_objs,
            node_objs=node_objs, claims=claims)

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
        firstuse.note("catalog")
        # the column axis is a PT×ZC grid: padding whole (pool,type)
        # blocks keeps the stride uniform.  Padded blocks carry zero
        # allocatable (fit nothing) and are in no group mask.
        ZC = cat.zc
        PT = len(cat.columns) // ZC if ZC else 0
        align = self._pt_align()
        PT_pad = max(-(-PT // align) * align, align)
        O = PT_pad * ZC
        arrays = dict(
            col_alloc=self._pad(cat.col_alloc, 0, O),
            col_daemon=self._pad(cat.col_daemon, 0, O),
            pt_alloc=self._pad(cat.pt_alloc, 0, PT_pad),
            col_pool=self._pad(cat.col_pool, 0, O),
            col_zone=self._pad_tiled(cat.col_zone, O, ZC),
            col_ct=self._pad_tiled(cat.col_ct, O, ZC),
            pool_daemon=cat.pool_daemon,
            zc=ZC)
        mesh = self._resolve_mesh()
        if mesh is None:
            cat.device_args = ffd.catalog_tensors(arrays, self.device)
        else:
            # pre-partitioned shards, uploaded once per catalog identity
            # and resident (logged in the executor's transfers); the
            # batched and sweep paths read the same arrays at full width
            from karpenter_tpu_torch.parallel import MaskRowRegistry
            cat.mesh_args = ffd.sharded_catalog_tensors(
                arrays, mesh.size, self._mesh_exec)
            # across cards the full width is a card-to-card gather onto
            # card 0, once per catalog identity (logged)
            cat.device_args = (self._mesh_exec.gather_full(cat.mesh_args)
                               if mesh.cards else cat.mesh_args.full())
            cat.mask_registry = MaskRowRegistry(self._mesh_exec, O)
        self._cat_entry = (key, cat)
        return cat

    @staticmethod
    def _pad_tiled(a: np.ndarray, O: int, ZC: int) -> np.ndarray:
        """Pad a per-column domain id to O columns with the TILED per-block
        pattern (the reference's `_pad_tiled`): the heavy step's real
        domain count reads the maximum id over every column, padding
        included, and a mesh shard made only of padding blocks still holds
        the global slot->domain pattern."""
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

    def _problem_args_mesh(self, enc: EncodedProblem, G: int, E: int,
                           Db: int, O: int, registry):
        """The mesh path's `_problem_args`: the same tuple, with slot 2 the
        groups' [G] rows of the resident mask table instead of the [G, O]
        mask (padded group slots index the all-false row 0), so no
        column-axis array travels per solve once the rows are resident.
        Returns (prob, table): dispatch uses the returned table snapshot."""
        prob = self._problem_args(enc, G, E, Db, O)
        rows, table = registry.ensure(prob[2])
        return prob[:2] + (rows,) + prob[3:], table

    # -- the solve -------------------------------------------------------
    def solve(self, inp: ScheduleInput,
              max_nodes: Optional[int] = None) -> ScheduleResult:
        """One scheduling problem.  `max_nodes` caps the node axis (a
        consolidation simulation); a capped solve that runs out of node
        slots returns its strands, as the reference does."""
        self._check_device()
        with tracing.span("solver.solve", pods=len(inp.pods)) as _sp:
            self._used_split = False
            self._residue_counted = set()
            self.last_residue_pods = 0
            res = self._solve_relaxed(inp, max_nodes=max_nodes)
            if res.unschedulable and not (max_nodes is not None
                                          and self._last_slots_exhausted):
                # rescue unless the caller's explicit node cap was itself
                # the binding constraint: a slot-exhausted consolidation
                # sim wants the cheap reject, but a capped sim stranded
                # for capacity or topology reasons may be feasible
                res = self._rescue_stranded(inp, res)
            if max_nodes is None:
                # the backstop ignores node caps, so a capped solve never
                # takes it
                res = self._oracle_backstop_on_limits(inp, res)
            if (max_nodes is None and res.unschedulable
                    and priority_enabled()):
                # the preemption pre-pass: plans for stranded
                # higher-priority pods whose seat lower-band evictions
                # could free — the SAME planner the oracle's solve()
                # runs.  Capped sims never plan.
                from karpenter_tpu_torch.solver import preempt
                preempt.attach(inp, res)
            path = "split" if self._used_split else "device"
            metrics.SOLVER_SOLVES.inc(path=path)
            if _sp is not None:
                _sp.attrs["path"] = path
                _sp.attrs["unschedulable"] = len(res.unschedulable)
            # shadow audit (solver/audit.py): sample REAL solves for
            # background oracle/full-re-solve re-verification.  Disarmed
            # (the default) this is one env read; capped sims are never
            # eligible (the oracle does not model the node cap)
            from karpenter_tpu_torch.solver import audit as auditmod
            auditmod.SAMPLER.maybe_submit(inp, res, solver=self,
                                          max_nodes=max_nodes)
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
        orc = Scheduler(inp).solve()
        if len(orc.unschedulable) < len(res.unschedulable):
            metrics.SOLVER_ORACLE_BACKSTOP.inc()
            self._used_split = True  # host help happened
            return orc
        return res

    def _count_residue(self, pods: List[Pod]) -> None:
        """Count the pods handed to the host oracle, once per solve: the
        split path can meet the same pods again."""
        fresh = [p for p in pods if p.meta.name not in self._residue_counted]
        self._residue_counted.update(p.meta.name for p in fresh)
        self.last_residue_pods += len(fresh)
        if fresh:
            metrics.SOLVER_RESIDUE_PODS.inc(len(fresh))

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
        orc_res = Scheduler(aug).solve()
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
        orc_res = Scheduler(aug).solve()

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
            orc2 = Scheduler(aug2).solve()
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
        """Group, then solve, with soft-term relaxation: preferred node
        affinity, preferred pod affinity and ScheduleAnyway spread are
        enforced as required (`Pod.relaxed`), and pods that stay
        unschedulable get their weakest term dropped and the whole problem
        re-solved.  Bounded by the total count of soft terms (at most 64
        extra rounds) and by a per-solve wall-clock deadline
        (KARPENTER_TPU_RELAX_BUDGET) that the split path's nested solves
        inherit; past it, the stragglers go to the caller's rescue oracle
        on their original soft semantics."""
        wall0 = time.time()
        t0 = time.perf_counter()
        # the incremental index replaces the grouping walk when it can
        # resolve this pass; real solves only — a capped consolidation sim
        # carries hypothetical pod sets the index never saw
        groups = (self._try_incr_groups(inp)
                  if max_nodes is None else None)
        if groups is None:
            groups = group_pods(inp.pods)
        # grouping belongs to the encode phase (folded in by
        # _solve_attempt); the histogram keeps it a phase of its own
        self._pregroup_ms = (time.perf_counter() - t0) * 1e3
        metrics.SOLVER_PHASE_DURATION.observe(
            self._pregroup_ms / 1e3, phase="pregroup", path="solve")
        tracing.record_span("solver.phase.pregroup", wall0,
                            self._pregroup_ms / 1e3, pods=len(inp.pods))
        # soft terms are part of the scheduling key, so one representative
        # per class decides
        if not any(g[0].preferences
                   or ((g[0].pod_affinities or g[0].topology_spread)
                       and g[0].has_soft_terms())
                   for g in groups):
            return self._attempt_or_split(inp, max_nodes=max_nodes,
                                          groups=groups)
        by_name = {p.meta.name: p for p in inp.pods}
        relax: Dict[str, int] = {}
        # bound by the TOTAL soft terms (capped), not the deepest ladder:
        # one pod's relaxation can un-place another in a later round
        rounds = 1 + min(sum(p.relax_levels() for p in inp.pods), 64)
        # the deadline is per solve: the split path re-enters here on
        # sub-problems, which inherit the outermost call's clock (and only
        # the outermost call observes the duration metric)
        t0 = time.perf_counter()
        outer = self._relax_deadline is None
        if outer:
            self.relax_counts["solves"] += 1
            self._relax_deadline = (
                time.perf_counter() + self.relax_budget_s
                if self.relax_budget_s is not None else float("inf"))
        res = ScheduleResult()
        try:
            for _ in range(rounds):
                self.relax_counts["rounds"] += 1
                variants = [p.relaxed(relax.get(p.meta.name, 0))
                            for p in inp.pods]
                res = self._attempt_or_split(
                    dataclasses.replace(inp, pods=variants),
                    max_nodes=max_nodes)
                bump = [n for n in res.unschedulable
                        if n in by_name
                        and relax.get(n, 0) < by_name[n].relax_levels()]
                if not bump:
                    return res
                if time.perf_counter() > self._relax_deadline:
                    if outer:
                        self.relax_counts["budget_exceeded"] += 1
                        metrics.RELAXATION_BUDGET_EXCEEDED.inc()
                    # a split verdict reached with preferences still
                    # promoted to required carries no authority for pods
                    # with relaxation headroom: the rescue re-judges them
                    self._last_oracle_judged = (self._last_oracle_judged
                                                - set(bump))
                    return res
                for n in bump:
                    relax[n] = relax.get(n, 0) + 1
            return res
        finally:
            if outer:
                self._relax_deadline = None
                metrics.RELAXATION_DURATION.observe(
                    time.perf_counter() - t0)

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
    def _statics(enc: EncodedProblem):
        """(with_gang, with_priority) of one encoded problem, as the
        reference derives its statics: the gang instance only for a
        problem that holds a gang group, the witness only for one with
        more than one priority band — every other problem keeps the
        program it had before either existed."""
        n = enc.n_groups
        wg = int(enc.group_gang is not None
                 and bool(np.asarray(enc.group_gang)[:n].any()))
        gp = enc.group_priority
        wp = int(gp is not None
                 and len(np.unique(np.asarray(gp)[:n])) > 1)
        return wg, wp

    def _solve_attempt(self, inp: ScheduleInput,
                       max_nodes: Optional[int] = None,
                       groups=None) -> ScheduleResult:
        mn = max_nodes or self._adaptive_max_nodes()
        # a pure-device attempt carries no oracle verdicts
        self._last_oracle_judged = set()
        self._last_slots_exhausted = False
        # the flight recorder's prelude: the first-use count at the start
        # (the record reports this attempt's set-up events) and, in
        # full-capture mode, the problem pickled BEFORE the solve — a
        # crash mid-solve still leaves the repro input on disk
        from karpenter_tpu_torch.utils import flightrecorder as fr
        self._flight_fu0 = firstuse.total()
        self._flight_capture = fr.RECORDER.capture_problem(
            {"inp": inp, "max_nodes": max_nodes,
             "solver_max_nodes": self.max_nodes}) \
            if fr.RECORDER.capture_enabled() else None
        wall0 = time.time()
        t0 = time.perf_counter()
        cat = self._catalog_encoding(inp)
        if max_nodes is None and groups is not None:
            # the delta seam: an engaged pass returns a result equal to
            # the full re-solve's; every other pass is a counted fallback
            res = self._try_delta(inp, cat, groups)
            if res is not None:
                return res
            # the seam's check is not encode time
            wall0 = time.time()
            t0 = time.perf_counter()
        enc = self._encode_checked(inp, cat, groups=groups)
        t1 = time.perf_counter()
        self.last_phase_ms = {
            "encode": (t1 - t0) * 1e3 + self._pregroup_ms}
        self._pregroup_ms = 0.0
        if enc.n_groups == 0:
            return ScheduleResult()
        if enc.n_columns == 0:
            # no purchasable capacity — existing nodes can still absorb
            # pods, exactly as the oracle fills them first.  The host fill
            # enforces per-node caps but neither the per-domain quotas nor
            # the gangs' atomic fills, so those groups go to the split
            # path instead
            if (enc.group_dsel[:enc.n_groups] > 0).any() or (
                    enc.group_gang is not None
                    and enc.group_gang[:enc.n_groups].any()):
                raise _SplitNeeded(
                    "zone/capacity-type-constrained or gang pods with no "
                    "purchasable capacity")
            return self._existing_only(enc)

        if max_nodes is None and groups is not None:
            # the speculative chunk chain: equal to the single program when
            # it runs, a counted fallback (and the program below) otherwise
            res = self._try_spec(inp, cat, enc, groups,
                                 wall0 + (t1 - t0), t1)
            if res is not None:
                return res

        G = bucket(enc.n_groups, G_BUCKETS)
        E = bucket(len(enc.existing), E_BUCKETS)
        Db = bucket(enc.n_domains, D_BUCKETS)
        dev = cat.device_args
        mesh = self._resolve_mesh()
        if mesh is not None:
            prob, table = self._problem_args_mesh(enc, G, E, Db, dev.O,
                                                  cat.mask_registry)
        else:
            prob = self._problem_args(enc, G, E, Db, dev.O)
        exc = self._explain_kernel_mode()
        wg, wp = self._statics(enc)
        # per-pod reason trees only for REAL solves: a consolidation sim
        # (explicit max_nodes cap) strands by design
        self._explain_trees = bool(exc) and max_nodes is None
        t2 = time.perf_counter()
        disp_s = dev_s = pull_s = 0.0
        cuda = self.device.type == "cuda"

        def execute(n):
            # dispatch (one upload, the kernel launches), then wait for
            # the device, then pull + unpack — timed separately
            nonlocal disp_s, dev_s, pull_s
            # fault-matrix hook: `error` here is a failed device dispatch
            # (GatedSolver must fall back), `delay` a slow device — host
            # side, before the upload and the launch
            faults.fire("solver.dispatch")
            t_a = time.perf_counter()
            ptens = ffd.problem_tensors(prob, dev.O, self.device)
            if mesh is not None:
                # K7: one cluster of S blocks over the resident shards (K7x:
                # one rank a card)
                flat = self._mesh_exec.solve(
                    ptens, table, cat.mesh_args, n, explain=exc,
                    with_gang=wg, with_priority=wp)
            else:
                flat = ffd.solve_ffd(ptens, dev, n, explain=exc,
                                     with_gang=wg, with_priority=wp)
            t_b = time.perf_counter()
            if cuda:
                torch.cuda.synchronize(self.device)
            t_c = time.perf_counter()
            out_ = ffd.unpack(flat.cpu().numpy(), G, E, n, R, Db,
                              explain=exc, explain_o=dev.O,
                              with_priority=wp)
            t_d = time.perf_counter()
            disp_s += t_b - t_a
            dev_s += t_c - t_b
            pull_s += t_d - t_c
            return out_

        from karpenter_tpu_torch.utils.profiling import trace_solve
        with trace_solve("ffd-solve"):
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
            na = self._last_active = int(out["num_active"])
            self._last_new_segments = self._new_segments(
                out["take_new"], enc.n_groups, na)
        t3 = time.perf_counter()
        self._repair_whole_node(enc, out)
        self._repair_gang(enc, out)
        self._repair_topology(enc, out)
        t4 = time.perf_counter()
        res = self._decode(enc, out)
        t5 = time.perf_counter()
        if max_nodes is None:
            self._note_explain(enc, out)
        if max_nodes is None and groups is not None:
            # a finished full solve is the next pass's delta base
            self._delta_store(inp, cat, enc, out, groups)
        self.last_phase_ms.update(
            pad=(t2 - t1) * 1e3, dispatch=disp_s * 1e3,
            device=dev_s * 1e3, pull=pull_s * 1e3,
            repair=(t4 - t3) * 1e3, decode=(t5 - t4) * 1e3)
        # per-phase histograms + spans; the histogram's `encode` is the
        # pure encode interval (pregroup is its own phase; last_phase_ms
        # keeps folding it into encode).  dispatch/device/pull are laid
        # out sequentially from t2 — exact for the single-dispatch common
        # case, aggregate across retries
        mesh_size = mesh.size if mesh is not None else 0
        for phase, lo, dur in (
                ("encode", t0, t1 - t0), ("pad", t1, t2 - t1),
                ("dispatch", t2, disp_s), ("device", t2 + disp_s, dev_s),
                ("pull", t2 + disp_s + dev_s, pull_s),
                ("repair", t3, t4 - t3), ("decode", t4, t5 - t4)):
            metrics.SOLVER_PHASE_DURATION.observe(
                dur, phase=phase, path="solve")
            attrs = ({"mesh_devices": mesh_size}
                     if mesh_size and phase in ("dispatch", "pull") else {})
            tracing.record_span(f"solver.phase.{phase}",
                                wall0 + (lo - t0), dur, **attrs)
        self._flight_record(inp, cat, enc, res, "solve")
        return res

    @staticmethod
    def _new_segments(take_new, n_groups: int, na: int) -> int:
        """The widest new-node fan-out of one group (at least 1): the
        reference's sparse take_new estimate, which its flight record
        carries as the `topk_segments` knob."""
        if not na or not n_groups:
            return 1
        tn = np.asarray(take_new)[:n_groups, :na]
        return max(int((tn > 0).sum(axis=1).max()), 1)

    def _flight_record(self, inp: ScheduleInput, cat, enc,
                       res: ScheduleResult, kind: str) -> None:
        """One black-box record per solve attempt: what the solve saw
        (catalog identity, problem fingerprint, resolved knobs), what it
        paid (phase timings, first-use events as `retraces`, the
        device-memory watermark), and what it answered (bit-exact result
        digest).  Fingerprint-only by default — budgeted under 1% of the
        headline p50; the full-capture path (`KARPENTER_TPU_FLIGHT_CAPTURE`)
        pickled the input before the solve ran (`_solve_attempt`)."""
        from karpenter_tpu_torch.utils import flightrecorder as fr
        from karpenter_tpu_torch.utils.profiling import device_memory_peak
        # the device-runtime gauges are independent of the recorder gate:
        # KARPENTER_TPU_FLIGHT=off must not freeze /metrics at the last
        # sampled watermark
        mem = device_memory_peak()
        if mem:
            metrics.SOLVER_DEVICE_MEMORY_PEAK.set(mem)
        metrics.SOLVER_DONATED_SLOTS.set(
            sum(st.occupancy() for st in self._stagings.values()))
        rec = fr.RECORDER
        if not rec.enabled:
            return
        mesh = self._mesh if self._mesh_resolved else None
        delta_mode = self._resolve_delta()
        cache = self._delta_cache
        metrics.FLIGHT_RECORDS.inc(kind=kind)
        rec.record(
            kind=kind,
            trace_id=tracing.current_trace_id(),
            catalog=fr.catalog_identity(cat),
            fingerprint=fr.problem_fingerprint(enc),
            pods=len(inp.pods),
            groups=enc.n_groups,
            knobs={
                "max_nodes": self.max_nodes,
                "mesh": mesh.size if mesh is not None else 0,
                "delta": delta_mode if delta_mode else "off",
                "pipeline": pipelining.pipeline_enabled(self.device),
                "topk_segments": self._last_new_segments,
                "explain": explainmod.mode_name(self._explain_mode()),
                # the resolved gang knob: a replay pins it so gang solves
                # reproduce bit for bit whatever the replaying shell says
                "gang": knobs.gang_enabled(),
                # the resolved spec knob + this attempt's chunk count (0
                # on any non-chunked path)
                "spec": (self._resolve_spec() or "off"),
                "spec_chunks": self._last_spec_chunks,
                "incr": (self._resolve_incr() or "off"),
            },
            phase_ms={k: round(v, 3)
                      for k, v in self.last_phase_ms.items()},
            # the churn self-description: the dirty-set size is stamped
            # on EVERY pass through the delta seam; groups re-encoded and
            # the reuse fraction only when the seeded merge engaged
            delta={"outcome": cache.last_outcome,
                   "reason": cache.last_reason,
                   "dirty": cache.last_dirty,
                   "reencoded": cache.last_reencoded,
                   "reuse": cache.last_reuse,
                   "incr": cache.last_incr_reason},
            # first-use events (solver/firstuse.py) over this attempt: the
            # port's counterpart of the reference's retrace count
            retraces=firstuse.total() - self._flight_fu0,
            device_memory_peak_bytes=mem,
            result=fr.result_digest(res),
            capture=self._flight_capture,
        )

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
        for name, n in totals.items():
            if n:
                metrics.SOLVER_CONSTRAINT_ELIM.inc(n, constraint=name)
        self.last_explain = {
            "mode": explainmod.mode_name(exc),
            "groups": G,
            "eliminations": totals,
            "kernel_aux": kc is not None,
        }

    # -- the steady-state seams ------------------------------------------
    @staticmethod
    def _count(counter: Dict[str, int], key: str) -> None:
        counter[key] = counter.get(key, 0) + 1

    def _delta_fallback(self, reason: str) -> None:
        """Count one non-engaged pass through the delta seam: every pass
        is "delta" or "fallback" with a reason of the closed vocabulary,
        never silent."""
        assert reason in explainmod.DELTA_FALLBACK_REASONS, reason
        cache = self._delta_cache
        cache.last_outcome, cache.last_reason = "fallback", reason
        self._count(self.delta_passes, "fallback")
        self._count(self.delta_fallbacks, reason)
        metrics.SOLVER_DELTA_PASSES.inc(outcome="fallback")
        return None

    def _incr_fallback(self, reason: str) -> None:
        """Count one walk-resolved pass through the incr seam (every pass
        where the index could have engaged is "incr" or "fallback")."""
        assert reason in explainmod.INCR_FALLBACK_REASONS, reason
        self._delta_cache.last_incr_reason = reason
        self._count(self.incr_passes, "fallback")
        self._count(self.incr_fallbacks, reason)
        metrics.SOLVER_INCR_PASSES.inc(outcome="fallback")
        return None

    def _try_incr_groups(self, inp: ScheduleInput):
        """This pass's groups from the event-driven index (solver/incr.py):
        clean rows reused by reference from the cached record, dirty ones
        rebuilt from O(churn) membership edits, no cluster walk.  None (the
        walk) when the seam is off or unarmed (silent: those callers never
        see the seam) or on a counted index-unusable condition; otherwise
        the groups `group_pods(inp.pods)` would give, with IncrHints
        stashed for the delta plan."""
        self._incr_hints = None
        mode = self._resolve_incr()
        if not mode or (mode == "auto" and not self._incr_armed):
            return None
        from karpenter_tpu_torch.solver import incr as incrmod
        cache = self._delta_cache
        # index maintenance starts with the first engaged pass: users with
        # the knob off or unarmed pay nothing
        cache.incr_enabled = True
        cache.last_incr_reason = None
        snap, consumed, dirty = cache.incr_snapshot()
        if snap is None:
            return self._incr_fallback("cold")
        built = incrmod.build_groups(snap, inp)
        if isinstance(built, str):
            return self._incr_fallback(built)
        groups, m, reuse = built
        self._count(self.incr_passes, "incr")
        metrics.SOLVER_INCR_PASSES.inc(outcome="incr")
        self._incr_hints = incrmod.IncrHints(
            rec=snap.rec, groups=groups, m=m, reuse=reuse,
            consumed=consumed, dirty_size=dirty)
        return groups

    def _seeded_problem_args(self, req, count, mask, ecap, er, enc,
                             G: int, E: int, Db: int, O: int):
        """The padded 17-slot tuple of one seeded solve (the delta suffix,
        or one chunk of the chain) — `_problem_args`' layout, dtypes and
        pad values — from its group rows, the consumed exist_remaining
        `er` and `enc`'s pool limits and existing-node domains, with the
        inactive encoder's topology constants: both seams engage only on
        topology-free problems."""
        Gd = len(count)
        D = enc.n_domains
        return (
            self._pad(req, 0, G),
            self._pad(count, 0, G),
            self._pad(self._pad(mask, 1, O), 0, G),
            self._pad(self._pad(ecap, 1, E), 0, G),
            self._pad(er, 0, E),
            enc.pool_limit,
            self._pad(np.full(Gd, BIG, dtype=np.int32), 0, G),
            np.zeros(G, dtype=np.int32),
            np.zeros((G, Db), dtype=np.int32),
            self._pad(self._pad(
                np.full((Gd, D), BIG, dtype=np.int32), 1, Db), 0, G),
            self._pad(np.full(Gd, BIG, dtype=np.int32), 0, G),
            np.zeros(G, dtype=np.int32),
            np.zeros((G, Db), dtype=bool),
            np.zeros(G, dtype=bool),
            np.zeros(G, dtype=bool),   # group_gang: gang-free by contract
            self._pad(enc.exist_zone, 0, E, value=-1),
            self._pad(enc.exist_ct, 0, E, value=-1),
        )

    def _run_delta(self, prob, seed: "deltam.ChunkSeed", O_real: int,
                   O: int, mn: int, dev, upload=ffd._upload,
                   kind: str = "delta-seed"):
        """Upload one seeded solve — the padded problem tuple and the seed
        (used and pool padded to the node axis, the first `seed.A` slots
        active, the colmask padded to the SEED_BUCKETS tier A_pad) — and
        launch K6, the explain counts in its epilogue: shared by the delta
        pass and every chunk of the chain.  Explain is clamped to counts: a
        suffix's [G, O] map would stitch against prefix rows that never had
        one.
        Under a mesh the group masks go through the resident row table and
        the seed's column words are committed per shard (logged as `kind`,
        "delta-seed" or "spec-seed"; across cards each shard to its own
        card), and K7's (K7x's) seeded instance runs.
        Returns the flat result row on the device (not synchronised)."""
        A_pad = min(bucket(max(seed.A, 1), deltam.SEED_BUCKETS), mn)
        cm = np.zeros((A_pad, O), dtype=bool)
        cm[:seed.A, :O_real] = seed.colmask
        exc = min(self._explain_mode(), 1)
        mesh = self._resolve_mesh()
        if mesh is not None:
            cat = self._cat_entry[1]
            rows, table = cat.mask_registry.ensure(prob[2])
            p, sd = ffd.delta_tensors(
                prob[:2] + (rows,) + prob[3:], self._pad(seed.used, 0, mn),
                self._pad(seed.pool, 0, mn), np.arange(mn) < seed.A,
                None, dev.O, self.device, upload=upload)
            ex = self._mesh_exec
            sd.seed_colmask = ex.put_sharded(
                ffd.shard_words(cm, mesh.size), kind)
            return ex.solve_delta(p, sd, table, cat.mesh_args, mn,
                                  explain=exc)
        p, sd = ffd.delta_tensors(
            prob, self._pad(seed.used, 0, mn), self._pad(seed.pool, 0, mn),
            np.arange(mn) < seed.A, cm, O, self.device, upload=upload)
        return ffd.solve_ffd_delta(p, sd, dev, mn, explain=exc)

    def _try_delta(self, inp: ScheduleInput, cat,
                   groups) -> Optional[ScheduleResult]:
        """The delta pass: diff against the cached record, seed the
        restricted suffix solve, merge, decode.  None on any conservative
        fallback (counted): the caller then runs the ordinary full path,
        whose finished solve refills the cache."""
        self._delta_consumed = None  # never consume a stale snapshot
        # index-resolved hints are valid only for the exact (groups,
        # record) pair they were computed against
        hints = self._incr_hints
        self._incr_hints = None
        if hints is not None and hints.groups is not groups:
            hints = None
        mode = self._resolve_delta()
        if not mode or not groups:
            return None
        if len(cat.columns) == 0:
            return self._delta_fallback("shape")
        cache = self._delta_cache
        wall0 = time.time()
        t0 = time.perf_counter()
        rec = cache.get(cat)
        if hints is not None and hints.rec is not rec:
            hints = None
        # ONE dirty snapshot per pass: plan diffs against it, and the
        # record store (here or _delta_store after a fallback) retires
        # exactly it — invalidations that arrive mid-solve stay dirty
        self._delta_consumed = (hints.consumed if hints is not None
                                else cache.dirty_snapshot())
        cache.last_dirty = (hints.dirty_size if hints is not None else
                            len(self._delta_consumed[0])
                            + len(self._delta_consumed[1]))
        cache.last_reencoded = cache.last_reuse = None
        ming = 0 if mode == "on" else deltam.DELTA_MIN_GROUPS
        plan = deltam.plan(rec, inp, groups, self._delta_consumed, ming,
                           G_BUCKETS, hints=hints)
        if isinstance(plan, str):
            return self._delta_fallback(plan)
        sp = deltam.build(plan, cat)
        if sp is None:
            return self._delta_fallback("seed")
        mn = self._adaptive_max_nodes()
        if sp.A >= mn:
            mn = self.max_nodes
        if sp.A >= mn:
            return self._delta_fallback("slots")
        Gd = len(plan.suffix)
        dev = cat.device_args
        exc = min(self._explain_mode(), 1)
        out_s = None
        disp_s = dev_s = pull_s = 0.0
        t1 = time.perf_counter()
        if Gd:
            Gp = bucket(Gd, G_BUCKETS)
            E = bucket(len(inp.existing_nodes), E_BUCKETS)
            Db = bucket(plan.record.enc.n_domains, D_BUCKETS)
            prob = self._seeded_problem_args(
                sp.group_req, sp.group_count, sp.group_mask, sp.exist_cap,
                sp.exist_remaining, plan.record.enc, Gp, E, Db, dev.O)
            seed = deltam.ChunkSeed(er=sp.exist_remaining,
                                    used=sp.seed_used, pool=sp.seed_pool,
                                    colmask=sp.seed_colmask, A=sp.A)
            t1 = time.perf_counter()
            # fault-matrix hook, same point as the full path's dispatch
            faults.fire("solver.dispatch")
            flat = self._run_delta(prob, seed, len(cat.columns), dev.O, mn,
                                   dev)
            t_b = time.perf_counter()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t_c = time.perf_counter()
            out_s = ffd.unpack(flat.cpu().numpy(), Gp, E, mn, R, Db,
                               explain=exc)
            t_d = time.perf_counter()
            disp_s, dev_s, pull_s = t_b - t1, t_c - t_b, t_d - t_c
            if out_s["unsched"][:Gd].sum() > 0:
                # stranded pods need the full path's rescue and retry
                # machinery; the kernel time is wasted, the verdict never
                return self._delta_fallback("stranded")
        t2 = time.perf_counter()
        enc_m, out_m = deltam.merge(plan, sp, cat, inp, out_s, Gd)
        self._repair_whole_node(enc_m, out_m)
        self._repair_gang(enc_m, out_m)
        self._repair_topology(enc_m, out_m)
        self._explain_trees = bool(self._explain_mode())
        res = self._decode(enc_m, out_m)
        self._note_explain(enc_m, out_m)
        t3 = time.perf_counter()
        # warm-start continuity: the next solve adapts as after a full pass
        na = self._last_active = int(out_m["num_active"])
        self._last_new_segments = self._new_segments(
            out_m["take_new"], enc_m.n_groups, na)
        # an engaged pass stitches the new record from the old one along
        # the plan's reuse map — O(groups + churn), no cluster walk
        new_rec = deltam.make_record(cat, enc_m, out_m, inp,
                                     carry=(plan.record, plan))
        if new_rec is not None:
            # nodes and catalog held: the lazily-built exist tables and
            # opener feasibility rows stay valid
            new_rec.exist_tables = plan.record.exist_tables
            new_rec.feas_cache = plan.record.feas_cache
            cache.put(cat, new_rec, consumed=self._delta_consumed,
                      incr_carry=(hints is not None))
        cache.last_outcome, cache.last_reason = "delta", None
        Gt = plan.m + len(plan.suffix)
        cache.last_reencoded = int(sp.reencoded)
        cache.last_reuse = round(1.0 - sp.reencoded / max(Gt, 1), 4)
        self._count(self.delta_passes, "delta")
        metrics.SOLVER_DELTA_PASSES.inc(outcome="delta")
        metrics.SOLVER_DELTA_GROUPS_REENCODED.set(sp.reencoded)
        self.last_phase_ms = {
            "delta_encode": (t1 - t0) * 1e3 + self._pregroup_ms,
            "dispatch": disp_s * 1e3, "device": dev_s * 1e3,
            "pull": pull_s * 1e3, "decode": (t3 - t2) * 1e3}
        self._pregroup_ms = 0.0
        for phase, lo, dur in (
                ("delta_encode", t0, t1 - t0), ("dispatch", t1, disp_s),
                ("device", t1 + disp_s, dev_s),
                ("pull", t1 + disp_s + dev_s, pull_s),
                ("decode", t2, t3 - t2)):
            metrics.SOLVER_PHASE_DURATION.observe(
                dur, phase=phase, path="solve")
            tracing.record_span(f"solver.phase.{phase}",
                                wall0 + (lo - t0), dur,
                                groups_reencoded=sp.reencoded)
        self._flight_record(inp, cat, enc_m, res, "delta")
        return res

    def _delta_store(self, inp: ScheduleInput, cat, enc, out,
                     groups) -> None:
        """Cache a finished FULL solve as the next pass's delta base;
        read-only on the solve's outputs."""
        mode = self._resolve_delta()
        if not mode or groups is None:
            return
        if mode != "on" and len(groups) < deltam.DELTA_MIN_GROUPS:
            return
        rec = deltam.make_record(cat, enc, out, inp)
        if rec is not None:
            old = self._delta_cache.get(cat)
            if old is not None:
                # feasibility rows key on (catalog, class id): always
                # valid; the exist tables key on the node set and must not
                # survive node churn
                rec.feas_cache = old.feas_cache
                if deltam.tables_reusable(old, rec):
                    rec.exist_tables = old.exist_tables
            # retire only the dirt this pass's snapshot observed (None
            # retires nothing)
            self._delta_cache.put(cat, rec, consumed=self._delta_consumed)
            self._delta_consumed = None

    def _spec_fallback(self, reason: str) -> None:
        """Count one non-chunked pass through the spec seam."""
        assert reason in explainmod.SPEC_FALLBACK_REASONS, reason
        self.last_spec = {"outcome": "fallback", "reason": reason}
        self._count(self.spec_passes, "fallback")
        self._count(self.spec_fallbacks, reason)
        metrics.SOLVER_SPEC_PASSES.inc(outcome="fallback")
        return None

    def _spec_repair_count(self, outcomes) -> None:
        """Count the chain's per-boundary verdicts: every chunk after the
        first committed (the speculated seed matched the true exit bit for
        bit) or repaired (re-dispatched from the true seed)."""
        for oc in outcomes:
            self._count(self.spec_chunks, oc)
            metrics.SOLVER_SPEC_CHUNKS.inc(outcome=oc)

    @staticmethod
    def _plan_spec_chunks(n_groups: int, mode):
        """Contiguous [lo, hi) chunks of the G axis, each one G_BUCKETS tier
        below the full problem's (every chunk pads to the same tier): the
        SMALLEST tier that keeps the chunk count within SPEC_MAX_CHUNKS,
        else the largest tier below the full bucket.  A reason string when
        chunking cannot win: "small" under the auto floor, "bucket" when no
        tier below the full problem's gives two chunks."""
        if mode != "on" and n_groups < deltam.SPEC_MIN_GROUPS:
            return "small"
        gb = bucket(n_groups, G_BUCKETS)
        cb = 0
        for b in G_BUCKETS:
            if b < gb and -(-n_groups // b) <= SPEC_MAX_CHUNKS:
                cb = b
                break
        if cb == 0:
            for b in G_BUCKETS:
                if b < gb:
                    cb = b
        if cb < 1 or -(-n_groups // cb) < 2:
            return "bucket"
        return [(lo, min(lo + cb, n_groups))
                for lo in range(0, n_groups, cb)]

    def _try_spec(self, inp: ScheduleInput, cat, enc, groups,
                  wall0: float, t0: float) -> Optional[ScheduleResult]:
        """The speculative chunk chain: cut the scan into K seeded chunk
        solves (K6) and run them as a chain in which chunk k+1 dispatches
        from a SPECULATED exit seed (the open-new-only projection) while
        chunk k is still on the card; commit compares the speculation with
        the true replayed exit state bit for bit, and a divergence
        re-solves from the truth (counted), so the stitched result equals
        the single program's.  None on any conservative fallback
        (counted).  The gates are the delta seam's, on the live encoding:
        topology-, gang- and limit-free, one band, no price cap.  `wall0`
        and `t0` are the wall and perf clocks at the end of the caller's
        encode (the phase spans' origin)."""
        self._last_spec_chunks = 0
        self.last_spec = None
        mode = self._resolve_spec()
        if not mode:
            return None
        G = enc.n_groups
        if enc.group_gang is not None and \
                np.asarray(enc.group_gang)[:G].any():
            return self._spec_fallback("gang")
        if len({priority_of(g[0]) for g in enc.groups}) > 1:
            return self._spec_fallback("priority")
        if inp.price_cap is not None:
            return self._spec_fallback("price-cap")
        if any(lim is not None
               for lim in (inp.remaining_limits or {}).values()):
            return self._spec_fallback("limits")
        if (enc.group_dsel[:G] != 0).any():
            return self._spec_fallback("topology")
        if any(g[0].topology_spread or g[0].pod_affinities
               or g[0].preferences for g in enc.groups):
            return self._spec_fallback("topology")
        if any(_has_required_anti(en.pods) for en in enc.existing):
            return self._spec_fallback("topology")
        if (enc.group_ncap[:G] < BIG).any() or \
                enc.group_whole_node[:G].any():
            return self._spec_fallback("shape")
        if any(v is not None for d in enc.static_allowed
               for v in d.values()):
            return self._spec_fallback("shape")
        if any(en.charge_pool is not None for en in enc.existing):
            return self._spec_fallback("shape")
        chunks = self._plan_spec_chunks(G, mode)
        if isinstance(chunks, str):
            return self._spec_fallback(chunks)
        K = len(chunks)
        # the chain rides the plain path's node-axis warm start; slot
        # exhaustion aborts it as a counted "slots" fallback and the plain
        # path's own exhaustion retry takes over
        mn = self._adaptive_max_nodes()
        Gp = chunks[0][1] - chunks[0][0]   # the planner's bucket tier
        E_real = len(enc.existing)
        E = bucket(E_real, E_BUCKETS)
        Db = bucket(enc.n_domains, D_BUCKETS)
        dev = cat.device_args
        O_real = len(cat.columns)
        exc = min(self._explain_mode(), 1)
        cuda = self.device.type == "cuda"
        if cuda:
            # one pinned slot per in-flight chunk each way: a slot is
            # rewritten only after the copy that last read it completed
            st = self._staging(pipelining.SPEC_DEPTH)
            upload, pull, wait = st.upload, st.pull, st.wait
        else:
            upload, pull = ffd._upload, (lambda flat: flat)
            wait = lambda flat: flat.numpy()  # noqa: E731
        t1 = time.perf_counter()
        feas: Dict[int, tuple] = {}
        outs: List[Optional[dict]] = [None] * K
        disp_s = dev_s = pull_s = repair_s = 0.0
        abort = [None]
        seen: set = set()
        repair_ks: set = set()

        def dispatch(k, seed):
            nonlocal disp_s, repair_s
            if k in seen:
                repair_ks.add(k)
            seen.add(k)
            lo, hi = chunks[k]
            t_a = time.perf_counter()
            prob = self._seeded_problem_args(
                enc.group_req[lo:hi], enc.group_count[lo:hi],
                enc.group_mask[lo:hi], enc.exist_cap[lo:hi], seed.er, enc,
                Gp, E, Db, dev.O)
            faults.fire("solver.dispatch")
            handle = pull(self._run_delta(prob, seed, O_real, dev.O, mn,
                                          dev, upload=upload,
                                          kind="spec-seed"))
            d = time.perf_counter() - t_a
            if k in repair_ks:
                repair_s += d
            else:
                disp_s += d
            return handle

        def commit(k, seed, handle):
            nonlocal dev_s, pull_s, repair_s
            lo, hi = chunks[k]
            Gd = hi - lo
            t_a = time.perf_counter()
            host = wait(handle)
            t_b = time.perf_counter()
            out = ffd.unpack(host, Gp, E, mn, R, Db, explain=exc)
            t_c = time.perf_counter()
            if k in repair_ks:
                repair_s += t_c - t_a
            else:
                dev_s += t_b - t_a
                pull_s += t_c - t_b
            if out["unsched"][:Gd].sum() > 0:
                abort[0] = ("slots" if int(out["num_active"]) >= mn
                            else "stranded")
                return None
            outs[k] = out
            folded = deltam.fold_chunk(seed, enc, cat, lo, hi, out, feas)
            if folded is None:
                abort[0] = "seed"
            return folded

        def project(k, seed):
            lo, hi = chunks[k]
            return deltam.project_chunk(seed, enc, cat, lo, hi, mn, feas)

        def match(a, b):
            return deltam.seed_digest(a) == deltam.seed_digest(b)

        from karpenter_tpu_torch.utils.profiling import trace_solve
        with trace_solve("ffd-spec-chain"):
            ok, outcomes, flushed = pipelining.run_spec_chain(
                K, deltam.chunk_entry_seed(enc), dispatch, project, commit,
                match, depth=min(K, pipelining.SPEC_DEPTH))
        if cuda and flushed:
            # flushed chunks' launches and copies were never read; their
            # buffers are released only once the stream has passed them
            torch.cuda.current_stream(self.device).synchronize()
        del flushed
        self._spec_repair_count(outcomes)
        if not ok:
            return self._spec_fallback(abort[0] or "stranded")
        t2 = time.perf_counter()
        # stitch the chunk outputs into one full-problem output: take rows
        # concatenate in group order, node rows come from the LAST chunk
        # (its carry holds the whole chain's nodes)
        na = int(outs[-1]["num_active"])
        D = enc.n_domains
        te = np.concatenate(
            [np.asarray(outs[k]["take_exist"])[:hi - lo, :E_real]
             for k, (lo, hi) in enumerate(chunks)], axis=0)
        tn = np.concatenate(
            [np.asarray(outs[k]["take_new"])[:hi - lo, :na]
             for k, (lo, hi) in enumerate(chunks)], axis=0)
        out_m = dict(
            take_exist=te, take_new=tn, new_overflow=False,
            unsched=np.zeros(G, dtype=np.float32),
            dom_placed=np.zeros((G, D), dtype=np.float32),
            used=outs[-1]["used"],
            node_pool=np.asarray(outs[-1]["node_pool"], dtype=np.int32),
            node_zone=np.asarray(outs[-1]["node_zone"], dtype=np.int32),
            node_ct=np.asarray(outs[-1]["node_ct"], dtype=np.int32),
            num_active=na)
        if exc and all(o.get("explain_counts") is not None for o in outs):
            out_m["explain_counts"] = np.concatenate(
                [np.asarray(outs[k]["explain_counts"])[:hi - lo]
                 for k, (lo, hi) in enumerate(chunks)], axis=0)
        self._repair_whole_node(enc, out_m)
        self._repair_gang(enc, out_m)
        self._repair_topology(enc, out_m)
        self._explain_trees = bool(self._explain_mode())
        res = self._decode(enc, out_m)
        self._note_explain(enc, out_m)
        t3 = time.perf_counter()
        self._last_slots_exhausted = False
        # warm-start continuity and the delta-base store: the chain's
        # output IS the full solve's
        self._last_active = na
        self._last_new_segments = self._new_segments(tn, G, na)
        self._delta_store(inp, cat, enc, out_m, groups)
        self._last_spec_chunks = K
        self.last_spec = {
            "outcome": "spec", "chunks": K,
            "committed": outcomes.count("committed"),
            "repaired": outcomes.count("repaired")}
        self._count(self.spec_passes, "spec")
        metrics.SOLVER_SPEC_PASSES.inc(outcome="spec")
        # `encode` was stamped before the seam; dispatch/device/pull
        # aggregate over the chain's chunks, and spec_repair is the
        # re-dispatched chunks' wall share (0.0 on a clean chain)
        self.last_phase_ms.update(
            pad=(t1 - t0) * 1e3, dispatch=disp_s * 1e3,
            device=dev_s * 1e3, pull=pull_s * 1e3,
            decode=(t3 - t2) * 1e3, spec_repair=repair_s * 1e3)
        for phase, lo_t, dur in (
                ("pad", t0, t1 - t0), ("dispatch", t1, disp_s),
                ("device", t1 + disp_s, dev_s),
                ("pull", t1 + disp_s + dev_s, pull_s),
                ("spec_repair", max(t2 - repair_s, t1), repair_s),
                ("decode", t2, t3 - t2)):
            metrics.SOLVER_PHASE_DURATION.observe(
                dur, phase=phase, path="solve")
            tracing.record_span(f"solver.phase.{phase}",
                                wall0 + (lo_t - t0), dur, spec_chunks=K)
        self._flight_record(inp, cat, enc, res, "spec")
        return res

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
        only when it shrinks the row past the padded existing axis, and
        honour the dense-rollback knob (KARPENTER_TPU_SWEEP_TOPK=0).
        Shared by the sweep and the generic batched path."""
        Ks = bucket(min(max_cnt, max(E_pad, 1)), self.K_BUCKETS)
        if not knobs.sweep_topk_enabled():
            return 0
        return Ks if (E_pad > 0 and 2 * Ks < E_pad) else 0

    def _staging(self, depth: int) -> "pipelining.ChunkStaging":
        """The solver's pinned staging slots of `depth` (two for the
        batched pipeline, SPEC_DEPTH for the chunk chain), kept across
        calls so a warmed solver allocates none in its solves."""
        st = self._stagings.get(depth)
        if st is None:
            st = self._stagings[depth] = pipelining.ChunkStaging(depth)
        return st

    def _chunk_io(self):
        """(pipeline on, upload, pull, wait) for a batched chunk loop: with
        the pipeline on a card, the staging buffers' pinned upload, async
        pull and per-chunk event; otherwise one upload and a blocking pull
        per chunk."""
        pipe = pipelining.pipeline_enabled(self.device)
        if pipe and self.device.type == "cuda":
            st = self._staging(2)
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
            # sims strand by design: codes without trees
            self._explain_trees = False
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
        for phase, ms in (("encode", encode_ms), ("device", device_ms),
                          ("decode", decode_ms)):
            metrics.SOLVER_PHASE_DURATION.observe(
                ms / 1e3, phase=phase, path="sweep")
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
        unschedulable.  A gang unit takes the generic batched solve
        (the sweep's lanes have no gang fill), as in the reference.
        """
        if not inps:
            return []
        self._check_device()
        with tracing.span("solver.solve_batch", sims=len(inps)):
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
                    # true soft ladder, through solve's relaxation loop
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
        wall0 = time.time()
        t_enc0 = time.perf_counter()
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
        encode_s = time.perf_counter() - t_enc0
        if len(cat.columns) == 0:
            return [self.solve(inp, max_nodes=max_nodes) for inp in inps]

        out_results: List[Optional[ScheduleResult]] = [None] * len(inps)
        for i in singles:
            out_results[i] = self.solve(inps[i], max_nodes=max_nodes)
        if not encs:
            return out_results
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
        # the statics for the whole batch: one gang-carrying input arms the
        # gang instance (gang-free entries still take their own steps), one
        # multi-band input the witness (single-band entries ride with a
        # zero priority row, inert)
        statics = [self._statics(e) for _, e in encs]
        wg_b = int(any(wg for wg, _ in statics))
        wp_b = int(any(wp for _, wp in statics))
        pipe, upload, pull, wait = self._chunk_io()
        chunk_size = B_BUCKETS[-1]
        chunks = [encs[s:s + chunk_size]
                  for s in range(0, len(encs), chunk_size)]
        pad_s = device_s = repair_s = decode_s = 0.0

        def dispatch(chunk):
            # stage 1: build + upload + launch, never block
            nonlocal pad_s, device_s
            t_pad0 = time.perf_counter()
            B = bucket(len(chunk), B_BUCKETS)
            probs = [self._problem_args(e, G, E, Db, O) for _, e in chunk]
            # pad the batch axis with empty problems (zero groups = no
            # work), so repeat calls see few launch shapes
            while len(probs) < B:
                probs.append(tuple(np.zeros_like(a) for a in probs[0]))
            batch = ffd.batch_tensors(probs, O, self.device, upload=upload)
            t_dev0 = time.perf_counter()
            pad_s += t_dev0 - t_pad0
            handle = pull(ffd.solve_ffd_batch(batch, dev, mn, exc_b,
                                              sparse_k, with_gang=wg_b,
                                              with_priority=wp_b))
            device_s += time.perf_counter() - t_dev0
            return handle

        def complete(chunk, handle):
            # stage 2: wait for this chunk's rows, repair and decode
            nonlocal device_s, repair_s, decode_s
            t_pull0 = time.perf_counter()
            packed = wait(handle)
            device_s += time.perf_counter() - t_pull0
            # capped sims: codes without trees; an uncapped batch entry is
            # a real provisioning request and gets its trees
            self._explain_trees = (bool(self._explain_mode())
                                   and max_nodes is None)
            for bi, (i, enc) in enumerate(chunk):
                t_dec0 = time.perf_counter()
                out = ffd.unpack(packed[bi], G, E, mn, R, Db,
                                 sparse_k=sparse_k, explain=exc_b,
                                 with_priority=wp_b)
                if exc_b:
                    self._note_explain(enc, out)
                # judged BEFORE topology repair, as solve() judges it
                exhausted = bool(out["unsched"].sum() > 0
                                 and out["num_active"] >= mn)
                self._repair_whole_node(enc, out)
                self._repair_gang(enc, out)
                self._repair_topology(enc, out)
                t_dec1 = time.perf_counter()
                repair_s += t_dec1 - t_dec0
                res = self._decode(enc, out)
                if res.unschedulable and not (
                        max_nodes is not None and exhausted):
                    # a sim the kernel strands WITHOUT slot pressure gets
                    # the oracle rescue; only an EXPLICIT caller cap earns
                    # the cheap slot-exhaustion reject, as in solve()
                    self._residue_counted = set()
                    self._last_oracle_judged = set()
                    res = self._rescue_stranded(inps[i], res)
                decode_s += time.perf_counter() - t_dec1
                out_results[i] = res

        pipelining.run_pipeline(chunks, dispatch, complete, enabled=pipe)
        # the generic batch's phases (path="batch"): unpack + repair as
        # `repair`, grouping inside `encode`; the spans lay out
        # sequentially from the batch's start — exact for one chunk,
        # aggregate across chunks otherwise
        t_cursor = wall0
        for phase, secs in (("encode", encode_s), ("pad", pad_s),
                            ("device", device_s), ("repair", repair_s),
                            ("decode", decode_s)):
            metrics.SOLVER_PHASE_DURATION.observe(
                secs, phase=phase, path="batch")
            tracing.record_span(f"solver.phase.{phase}", t_cursor, secs,
                                path="batch")
            t_cursor += secs
        return out_results

    # -- warm-up ------------------------------------------------------------
    def warmup(self, inp: ScheduleInput, *, shapes=(),
               max_nodes_list=None, batch_sizes=(),
               delta_shapes=()) -> int:
        """Pay the first-use costs of the solves a workload shaped like
        `inp` will make before the first of them (operator startup, never
        on the solve path), so that a solve at a warmed shape meets no
        first-use event (`solver/firstuse.py`): the kernel libraries built
        and loaded (all at once, one nvcc per source), the catalog's
        tensors uploaded, each bucketed launch configuration launched once,
        the pinned staging slots of the batched paths and of the chunk
        chain allocated at their bucket sizes, and under a mesh the
        executor's launch configurations checked and the mask-row table
        sized by the real encoding's rows.

        The lattice, as the reference's: the (G, E, Db) buckets of `inp`,
        extended by `shapes` — extra (n_groups, n_existing) points, each
        rounded to its bucket — crossed with the node-axis ladder of
        `_adaptive_max_nodes` (`max_nodes_list` overrides it), with the
        gang instance when `inp` holds a gang and the witness when it holds
        more than one priority band.  `batch_sizes` also warms the generic
        batched solve at those problem counts (both explain variants its
        lane launches) at the node ceiling; `delta_shapes` —
        (suffix_groups, seeded_nodes) points — warms the seeded scan at
        those tiers over the ladder, when the delta seam is on; with the
        chunk chain on, its program family at the ceiling.

        Values are zeros: a launch configuration depends only on shapes,
        so a warm-up launch costs one scan of masked no-ops.  Returns the
        number of launches made.  Solver state other than the caches above
        is untouched (no warm start, no delta record)."""
        self._check_device()
        cuda = self.device.type == "cuda"
        if cuda:
            from karpenter_tpu_torch.solver import _cuda
            _cuda.load()
        cat = self._catalog_encoding(inp)
        if not inp.pods or len(cat.columns) == 0:
            return 0
        try:
            enc = self._encode_checked(inp, cat,
                                       groups=group_pods(inp.pods))
        except Unsupported:
            return 0
        if enc.n_groups == 0:
            return 0
        dev = cat.device_args
        baseG = bucket(enc.n_groups, G_BUCKETS)
        baseE = bucket(len(enc.existing), E_BUCKETS)
        Db = bucket(enc.n_domains, D_BUCKETS)
        # the real encoding's own arguments fix the dtypes; under a mesh
        # this also registers its mask rows, sizing the resident table at
        # its steady-state tier
        mesh = self._resolve_mesh()
        if mesh is not None:
            proto, table = self._problem_args_mesh(
                enc, baseG, baseE, Db, dev.O, cat.mask_registry)
        else:
            proto, table = self._problem_args(enc, baseG, baseE, Db,
                                              dev.O), None
        G_AX = (0, 1, 2, 3, 6, 7, 8, 9, 10, 11, 12, 13, 14, 17)

        def zeros_at(i, a, G2, E2):
            shp = list(a.shape)
            if i in G_AX:
                shp[0] = G2
            if i == 3:
                shp[1] = E2
            if i in (4, 15, 16):
                shp[0] = E2
            return np.zeros(shp, dtype=a.dtype)

        def done(flat):
            if cuda:
                torch.cuda.synchronize(self.device)
            return flat

        if max_nodes_list is None:
            ladder = sorted({b for b in (64, 256, 1024)
                             if b < self.max_nodes} | {self.max_nodes})
        else:
            ladder = sorted(set(max_nodes_list))
        targets = {(baseG, baseE)} | {
            (bucket(max(int(g), 1), G_BUCKETS),
             bucket(max(int(e), 0), E_BUCKETS)) for g, e in shapes}
        exc = self._explain_kernel_mode()
        # the gang instance and the witness are separate launch
        # configurations: warm them when the input holds a gang or more
        # than one priority band, both with and without
        gang_variants = (0, 1) if bool(np.asarray(proto[14]).any()) else (0,)
        prio_variants = (0, 1) if len(proto) > 17 else (0,)
        warmed = 0
        for (G2, E2) in sorted(targets):
            prob2 = tuple(zeros_at(i, a, G2, E2)
                          for i, a in enumerate(proto))
            for wg in gang_variants:
                for wp in prio_variants:
                    probv = prob2 if wp else prob2[:17]
                    for mn in ladder:
                        ptens = ffd.problem_tensors(probv, dev.O,
                                                    self.device)
                        if mesh is not None:
                            done(self._mesh_exec.solve(
                                ptens, table, cat.mesh_args, mn,
                                explain=exc, with_gang=wg,
                                with_priority=wp))
                        else:
                            done(ffd.solve_ffd(ptens, dev, mn, explain=exc,
                                               with_gang=wg,
                                               with_priority=wp))
                        warmed += 1
        if batch_sizes:
            # the batched solve reads the dense [G, O] masks at full width,
            # mesh or not
            proto_b = (self._problem_args(enc, baseG, baseE, Db, dev.O)
                       if mesh is not None else proto)
            prob0 = tuple(zeros_at(i, a, baseG, baseE)
                          for i, a in enumerate(proto_b))
            sk = self._pick_sparse_k(max(len(p) for p in enc.groups), baseE)
            _, upload, pull, wait = self._chunk_io()
            for bsz in batch_sizes:
                B = bucket(max(int(bsz), 1), B_BUCKETS)
                for exb in sorted({0, min(self._explain_mode(), 1)}):
                    for wg in gang_variants:
                        batch = ffd.batch_tensors([prob0] * B, dev.O,
                                                  self.device, upload=upload)
                        flat = ffd.solve_ffd_batch(
                            batch, dev, self.max_nodes, exb, sk,
                            with_gang=wg, with_priority=int(len(prob0) > 17))
                        wait(pull(flat))
                        warmed += 1
            if cuda and pipelining.pipeline_enabled(self.device):
                self._staging(2).reserve()
        O_real = len(cat.columns)

        def seeded(Gd, A, mn, upload=ffd._upload, kind="delta-seed"):
            prob = self._seeded_problem_args(
                np.zeros((0, R), np.float32), np.zeros(0, np.int32),
                np.zeros((0, O_real), bool),
                np.zeros((0, len(enc.existing)), np.int32),
                np.zeros((baseE, R), np.float32), enc, Gd, baseE, Db, dev.O)
            seed = deltam.ChunkSeed(
                er=np.zeros((baseE, R), np.float32),
                used=np.zeros((A, R), np.float32),
                pool=np.zeros(A, np.int32),
                colmask=np.zeros((A, O_real), bool), A=A)
            return self._run_delta(prob, seed, O_real, dev.O, mn, dev,
                                   upload=upload, kind=kind)

        if delta_shapes and self._resolve_delta():
            for g, a in delta_shapes:
                Gd = bucket(max(int(g), 1), G_BUCKETS)
                for mn in ladder:
                    done(seeded(Gd, min(max(int(a), 1), mn), mn))
                    warmed += 1
        spec_mode = self._resolve_spec()
        if spec_mode:
            plan = self._plan_spec_chunks(enc.n_groups, spec_mode)
            if not isinstance(plan, str):
                # the chain pads every chunk to the planner's one G tier and
                # walks the seed tiers as A grows, at the ceiling
                Gp = plan[0][1] - plan[0][0]
                mn = self.max_nodes
                st = self._staging(pipelining.SPEC_DEPTH) if cuda else None
                for A in sorted({min(b, mn) for b in deltam.SEED_BUCKETS}):
                    if st is not None:
                        st.wait(st.pull(seeded(Gp, A, mn, upload=st.upload,
                                               kind="spec-seed")))
                    else:
                        seeded(Gp, A, mn, kind="spec-seed")
                    warmed += 1
                if st is not None:
                    st.reserve()
        return warmed

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
            metrics.SOLVER_HOST_REPAIRS.inc(kind="whole_node")
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

    def _repair_gang(self, enc: EncodedProblem,
                     out: Dict[str, np.ndarray]) -> None:
        """Gang atomicity safety net: every gang group must be either
        FULLY placed inside one adjacency domain or fully stranded.  The
        gang fill commits all-or-nothing by construction, so this host
        check is defense in depth — a partial or cross-domain gang is
        rolled back here (takes zeroed, used released, members stranded
        whole) rather than split, and counted in `gang_repairs`."""
        gg = enc.group_gang
        if gg is None or not gg.any():
            return
        Er = len(enc.existing)
        num_active = int(out["num_active"])
        for gi in np.nonzero(gg[:enc.n_groups])[0]:
            te = out["take_exist"][gi, :Er]
            tn = out["take_new"][gi, :num_active]
            placed = int(te.sum()) + int(tn.sum())
            if placed == 0:
                continue
            ok = placed == int(enc.group_count[gi])
            dsel = int(enc.group_dsel[gi])
            if ok and dsel > 0:
                ex_dom = (enc.exist_zone if dsel == 1 else enc.exist_ct)
                nd = (out["node_zone"] if dsel == 1 else out["node_ct"])
                doms = {int(ex_dom[ei]) for ei in np.nonzero(te > 0)[0]}
                doms |= {int(nd[ni]) for ni in np.nonzero(tn > 0)[0]}
                ok = len(doms) <= 1
            if ok:
                continue
            self.gang_repairs += 1
            metrics.SOLVER_GANG_REPAIRS.inc()
            self._strand_group(enc, out, gi, te, tn)

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
                if removed:
                    metrics.SOLVER_HOST_REPAIRS.inc(kind="topology")
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
        # then new nodes, then unschedulable — the kernel's accounting.
        # The C++ fast path (native/hostops.cc distribute) walks the same
        # rows without per-pod Python frames and returns per-node
        # (group list, start, count) SEGMENTS, wrapped in PodSegments; the
        # loop below is the fallback and the differential-test oracle.
        native = hostops()
        if native is not None and isinstance(enc.groups, list):
            node_pods, node_groups, unsched_by_group = native.distribute(
                enc.groups,
                np.ascontiguousarray(out["take_exist"][:Gr, :Er],
                                     dtype=np.int64),
                np.ascontiguousarray(out["take_new"][:Gr, :num_active],
                                     dtype=np.int64),
                np.ascontiguousarray(out["unsched"][:Gr], dtype=np.int64),
                exist_names, num_active, res.existing_assignments)
            pod_wrap = PodSegments
            for gi, pods in unsched_by_group.items():
                reason = self._unsched_reason(enc, gi, out)
                for pod in pods:
                    res.unschedulable[pod.meta.name] = reason
        else:
            pod_wrap = None
            take_exist = out["take_exist"][:Gr, :Er].astype(int)
            take_new = out["take_new"][:Gr, :].astype(int)
            unsched = out["unsched"][:Gr].astype(int)
            node_pods = {}
            node_groups = {}
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
                    reason = self._unsched_reason(enc, gi, out)
                    for pod in pods[cursor:cursor + unsched[gi]]:
                        res.unschedulable[pod.meta.name] = reason

        # claim metadata depends only on (pool, resident groups, used row,
        # pinned domains): hundreds of nodes share a handful of shapes
        claim_cache: Dict[tuple, tuple] = {}
        req_cache: Dict[int, Resources] = {}
        fit_rows: Dict[tuple, np.ndarray] = {}
        used_id: List[int] = []
        if num_active > 0:
            if native is not None:
                used_id = native.row_ids(
                    np.ascontiguousarray(used[:num_active]), num_active)
            else:
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

        if pod_wrap is not None:
            # the per-node claim stamping in C (native/hostops.cc
            # build_claims): Python runs once per distinct claim shape
            if num_active > 0:
                _hostname(num_active - 1)  # pre-extend the shared cache
                native.build_claims(
                    node_pods, node_groups,
                    np.ascontiguousarray(node_pool[:num_active],
                                         dtype=np.int64),
                    np.ascontiguousarray(node_zone[:num_active],
                                         dtype=np.int64),
                    np.ascontiguousarray(node_ct[:num_active],
                                         dtype=np.int64),
                    used_id, _HOSTNAME_CACHE, PodSegments, NewNodeClaim,
                    lambda ni: _claim_shape(
                        int(node_pool[ni]), node_groups.get(ni, ()),
                        int(node_zone[ni]), int(node_ct[ni]),
                        used_id[ni], ni),
                    res.new_claims, res.unschedulable)
            return res
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
            d["hostname"] = _hostname(ni)
            claim.__dict__ = d
            res.new_claims.append(claim)
        return res

    def _gang_reason(self, enc: EncodedProblem, gi: int,
                     out: Optional[Dict]) -> str:
        """One stranded GANG's verdict: the whole gang strands with one
        of the gang codes, and the reason tree always carries the per-gang
        breakdown — nearest adjacency domain, how many members it could
        hold, the member deficit and the estimated node deficit."""
        pods = enc.groups[gi]
        spec = gang_of(pods[0]) if pods else None
        cnt = int(enc.group_count[gi])
        dsel = int(enc.group_dsel[gi])
        D = enc.n_domains
        delig = np.asarray(enc.group_delig[gi][:D], dtype=bool)
        placed_d = None
        if isinstance(out, dict) and "dom_placed" in out \
                and gi < len(out["dom_placed"]):
            placed_d = np.asarray(out["dom_placed"][gi][:D],
                                  dtype=np.int64)
        best = 0
        best_dom = None
        if placed_d is not None and delig.any():
            masked = np.where(delig, placed_d, -1)
            bi = int(masked.argmax())
            best = max(int(masked[bi]), 0)
            values = (enc.zone_values if dsel == 1
                      else enc.ct_values if dsel == 2 else [])
            if dsel > 0 and bi < len(values):
                best_dom = values[bi]
        # best per-node fan-out over the gang's admitted columns — the
        # deficit-node estimate and the too-large bound both need it
        gmask = np.asarray(enc.group_mask[gi], dtype=bool)
        per = _np_fit_count(
            np.asarray(enc.col_alloc, dtype=np.float32)
            - np.asarray(enc.col_daemon, dtype=np.float32),
            np.asarray(enc.group_req[gi], dtype=np.float32))
        best_fit = int(per[gmask].max()) if gmask.any() else 0
        n_axis = (out["take_new"].shape[1]
                  if isinstance(out, dict) and "take_new" in out
                  else self.max_nodes)
        exist_fit = 0
        if len(enc.existing):
            exist_fit = int(_np_fit_count(
                np.asarray(enc.exist_remaining, dtype=np.float32),
                np.asarray(enc.group_req[gi],
                           dtype=np.float32)).sum())
        name = spec.name if spec is not None else "?"
        if spec is not None and spec.size and len(pods) != spec.size:
            code = explainmod.GANG_INCOMPLETE
            detail = (f"gang {name}: {len(pods)} member(s) pending of "
                      f"{spec.size} declared — "
                      + ("waiting for the full gang"
                         if len(pods) < spec.size
                         else "more members than declared; fix "
                              "gang-size"))
        elif best <= 0:
            if cnt > best_fit * n_axis + exist_fit:
                # a sound global upper bound over every domain: the gang
                # could not fit even on an empty fleet at the node
                # ceiling
                code = explainmod.GANG_TOO_LARGE
                detail = (f"gang {name}: {cnt} members exceed any "
                          "single adjacency domain's possible capacity "
                          f"(≤{best_fit} pods/node × {n_axis} node "
                          "slots)")
            else:
                code = explainmod.GANG_DOMAIN
                detail = (f"gang {name}: no adjacency domain can "
                          "currently hold any member")
        else:
            code = explainmod.GANG_PARTIAL
            detail = (f"gang {name}: best domain holds {best} of {cnt} "
                      "members — stranded whole rather than split")
        deficit = max(cnt - best, 0)
        gang_tree = {
            "name": name,
            "declared_size": spec.size if spec is not None else 0,
            "members_pending": len(pods),
            "domain_axis": ("zone" if dsel == 1
                            else "capacity-type" if dsel == 2
                            else "none"),
            "nearest_domain": best_dom,
            "nearest_domain_members": best,
            "deficit_members": deficit,
            "deficit_nodes": (-(-deficit // best_fit)
                              if best_fit else None),
        }
        tree = {"code": code, "constraint": explainmod.constraint_of(code),
                "gang": gang_tree}
        if self._explain_trees:
            full = explainmod.build_tree(enc, out or {}, gi, code)
            full["gang"] = gang_tree
            tree = full
        return explainmod.make(code, detail, tree)

    def _unsched_reason(self, enc: EncodedProblem, gi: int,
                        out: Optional[Dict] = None) -> str:
        """One stranded group's verdict as a registry `Reason`, with its
        reason tree when explain is armed on a REAL solve
        (`_explain_trees`)."""
        if enc.group_gang is not None and gi < len(enc.group_gang) \
                and enc.group_gang[gi]:
            return self._gang_reason(enc, gi, out)
        # priority reclassification, gated on the kernel's inversion
        # witness: prio_inv[h] marks a group that placed pods after a
        # higher-priority group stranded, so this group's strand is a
        # band-order capacity loss (preemption could seat it), not a plain
        # capacity verdict.  Only for hostable groups: a group no column
        # or existing node can ever carry keeps its real verdict.
        gp = enc.group_priority
        pi = None if out is None else out.get("prio_inv")
        if gp is not None and pi is not None and (
                enc.group_mask[gi].any() or (enc.exist_cap[gi] > 0).any()):
            Gr = enc.n_groups
            gprow = np.asarray(gp)[:Gr]
            pirow = np.asarray(pi)[:Gr]
            later = np.arange(Gr) > gi
            if bool((later & pirow & (gprow < gprow[gi])).any()):
                code = explainmod.PRIORITY_BAND_EXHAUSTED
                detail = ("priority band exhausted: capacity went to "
                          "lower-priority pods placed after this group "
                          "stranded — eviction could seat it")
                tree = None
                if self._explain_trees:
                    tree = explainmod.build_tree(enc, out or {}, gi, code)
                return explainmod.make(code, detail, tree)
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
            code = explainmod.NO_NODEPOOL
            detail = "no nodepool can schedule pod: " + "; ".join(details)
        # attribute to topology only when the encoder enforced a
        # constraint for this group
        elif (enc.group_dsel[gi] > 0 or enc.group_ncap[gi] < BIG
                or any(v is not None
                       for v in enc.static_allowed[gi].values())):
            code = explainmod.TOPOLOGY
            detail = ("topology constraints unsatisfiable: every allowed "
                      "domain is at its skew ceiling or out of capacity")
        else:
            code = explainmod.CAPACITY
            detail = ("no capacity: every compatible node/instance-type "
                      "combination is exhausted or over limits")
        tree = None
        if self._explain_trees:
            tree = explainmod.build_tree(enc, out or {}, gi, code)
        return explainmod.make(code, detail, tree)
