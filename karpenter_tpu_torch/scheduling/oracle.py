"""The CPU oracle scheduler — first-fit-decreasing with Karpenter semantics.

Algorithm (reference: designs/bin-packing.md:28-42 + core scheduler behavior
per the reference scheduler's core behavior):
  1. Sort pending pods by requested resources, non-increasing (cpu-major).
  2. Per pod: try existing cluster nodes, then in-flight simulated nodes
     opened earlier in this solve, then open a new simulated node from the
     highest-weight compatible NodePool.
  3. A new sim-node starts with every instance type that is compatible with
     (template ∩ pod) requirements, fits the pod plus daemonset overhead, and
     has an available offering; each later pod added to the node re-filters
     that candidate list (so the node's type set only narrows).
  4. At the end each sim-node ranks its surviving types cheapest-offering
     first — the NodeClaim's ranked launch list.

Topology spread, pod (anti-)affinity, taints, and NodePool weight/limits are
honored; `minValues` is enforced at finalize. This implementation is the
correctness reference and the fallback path; the TPU solver replicates its
decisions in tensor form (solver-unavailable ⇒ fall back here, never fail
provisioning).

The port's copy of `karpenter_tpu/scheduling/oracle.py`: stranded pods go
to the shared preemption planner (`solver/preempt.py`), as in the
reference.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.models import wellknown
from karpenter_tpu_torch.models.objects import InstanceType, NodePool, Pod
from karpenter_tpu_torch.models.requirements import Requirement, Requirements
from karpenter_tpu_torch.models.resources import Resources
from karpenter_tpu_torch.models.taints import tolerates_all
from karpenter_tpu_torch.scheduling.topology import (
    TopologyTracker,
    _matches,
    _sel,
    node_domains_for,
)
from karpenter_tpu_torch.scheduling.types import (
    ExistingNode,
    NewNodeClaim,
    ScheduleInput,
    ScheduleResult,
    effective_request,
    gang_of,
    gang_trial_order,
    min_values_violation,
    priority_of,
)
# the reason-code registry (jax-free: the solver package resolves its
# heavy exports lazily) — every oracle verdict carries a structured code
# so the solver's oracle-vs-kernel discrimination is a code comparison,
# never a substring match
from karpenter_tpu_torch.solver import explain as explainmod

_sim_counter = itertools.count(1)


# topology keys the scheduler narrows on new nodes (hostname is always
# per-node-unique and handled separately)
_NARROWABLE_KEYS = (wellknown.ZONE_LABEL, wellknown.CAPACITY_TYPE_LABEL)


class _ExistingSim:
    def __init__(self, en: ExistingNode):
        self.en = en
        self.remaining = en.available.copy()
        self.hostname = en.node.name
        self.domains = node_domains_for(en.node.labels, en.node.name)
        # interned group ids (objects.py scheduling_group_id) of pod
        # equivalence classes that failed against this node since its
        # last mutation — identical pods skip the full re-check (the same
        # memoization the reference gets from batching identical pods)
        self.failed_keys: set = set()

    @property
    def name(self) -> str:
        return self.en.name


class _NewSim:
    def __init__(
        self,
        pool: NodePool,
        requirements: Requirements,
        candidates: List[InstanceType],
        daemon_overhead: Resources,
    ):
        self.pool = pool
        self.requirements = requirements
        self.candidates = candidates
        self.requests = daemon_overhead.copy()
        self.pods: List[Pod] = []
        self.failed_keys: set = set()
        self.last_key = None  # group id (interned int) of the last pod added
        self.hostname = f"new-node-{next(_sim_counter)}"
        # topology domains already determined for this node
        self.domains: Dict[str, str] = {
            wellknown.HOSTNAME_LABEL: self.hostname,
            wellknown.NODEPOOL_LABEL: pool.name,
        }
        self._sync_fixed_domains()

    def _sync_fixed_domains(self) -> bool:
        """A requirement narrowed to a single value fixes that domain.
        Returns True when a new domain was determined — the caller must
        then invalidate the tracker's domain caches, because this sim's
        already-registered pods now count in the new domain."""
        changed = False
        for key in _NARROWABLE_KEYS:
            req = self.requirements.get(key)
            if req is not None and req.is_finite() and len(req.values()) == 1:
                (v,) = req.values()
                if self.domains.get(key) != v:
                    self.domains[key] = v
                    changed = True
        return changed

    def finite_values(self, key: str, fallback: Set[str]) -> Set[str]:
        req = self.requirements.get(key)
        if req is not None and req.is_finite():
            return set(req.values())
        return set(fallback)


class Scheduler:
    def __init__(self, inp: ScheduleInput):
        if inp.price_cap is not None:
            import dataclasses
            from karpenter_tpu_torch.scheduling.types import price_capped_types
            inp = dataclasses.replace(inp, instance_types={
                k: price_capped_types(v, inp.price_cap)
                for k, v in inp.instance_types.items()})
        self.inp = inp
        self.tracker = TopologyTracker()
        self.existing = [_ExistingSim(en) for en in inp.existing_nodes]
        self.new_sims: List[_NewSim] = []
        self.result = ScheduleResult()
        self._remaining_limits: Dict[str, Optional[Resources]] = {
            np.name: (inp.remaining_limits.get(np.name).copy()
                      if inp.remaining_limits.get(np.name) is not None else None)
            for np in inp.nodepools
        }
        # seed topology state from resident pods and cluster geography —
        # every live node contributes its domains even when empty (an empty
        # zone pins the spread minimum at 0, forcing spreading toward it)
        for sim in self.existing:
            for key, dom in sim.domains.items():
                self.tracker.observe_domains(key, {dom})
            for pod in sim.en.pods:
                self.tracker.register(pod, sim.domains)
        zones: Set[str] = set()
        for types in inp.instance_types.values():
            for it in types:
                for o in it.offerings:
                    if o.available:
                        zones.add(o.zone)
        self.tracker.observe_domains(wellknown.ZONE_LABEL, zones)
        self.tracker.observe_domains(
            wellknown.CAPACITY_TYPE_LABEL,
            {o.capacity_type for types in inp.instance_types.values()
             for it in types for o in it.offerings if o.available})
        self._all_zones = zones

    # ------------------------------------------------------------------
    def solve(self) -> ScheduleResult:
        res = self._solve()
        # preemption pre-pass: the SAME shared planner the
        # solver's tail runs, so both engines propose identical victim
        # sets.  Consolidation sims (price_cap set) strand by design and
        # never want plans; trials re-enter through _solve, so the
        # planner can never recurse back here.
        if res.unschedulable and self.inp.price_cap is None:
            from karpenter_tpu_torch.utils.knobs import priority_enabled
            if priority_enabled():
                from karpenter_tpu_torch.solver import preempt
                preempt.attach(self.inp, res)
        return res

    def _solve(self) -> ScheduleResult:
        # priority-band-major FFD: higher bands pack first, so
        # a priority-free input (every pod in one band — the constant
        # prefix) sorts exactly as before; within a band the order stays
        # requests-desc then name, the pre-priority discipline.
        pods = sorted(
            self.inp.pods,
            key=lambda p: (priority_of(p), p.requests.sort_key(),
                           p.meta.name),
            reverse=True,
        )
        # gang pre-scan: members of one gang place ATOMICALLY
        # at the position of their first member in FFD order — all or
        # none, in one adjacency domain — instead of pod by pod.  The
        # map is keyed by gang name so even heterogeneous gangs (several
        # pod classes sharing a name — inexpressible for the kernel,
        # which hands them here via the residue path) stay atomic.
        gang_members: Dict[str, List[Pod]] = {}
        for pod in pods:
            sp = gang_of(pod)
            if sp is not None:
                gang_members.setdefault(sp.name, []).append(pod)
        done_gangs: set = set()
        for pod in pods:
            sp = gang_of(pod)
            if sp is None:
                self._schedule_one(pod)
            elif sp.name not in done_gangs:
                done_gangs.add(sp.name)
                self._schedule_gang(sp, gang_members[sp.name])
        self._finalize()
        return self.result

    # -- gang scheduling ------------------------------------
    def _snapshot(self) -> tuple:
        """Value snapshot of every mutable piece a gang trial can touch.
        Resources/Requirements are rebound (never mutated in place) by
        the placement paths, so object references suffice for them;
        lists/sets/dicts that mutate are copied or length-recorded."""
        ex = [(sim.remaining, set(sim.failed_keys))
              for sim in self.existing]
        new = [(sim.requirements, sim.candidates, sim.requests,
                len(sim.pods), sim.last_key, dict(sim.domains),
                set(sim.failed_keys))
               for sim in self.new_sims]
        return (ex, new, len(self.new_sims),
                dict(self._remaining_limits),
                dict(self.result.existing_assignments),
                dict(self.result.unschedulable),
                len(self.result.new_claims),
                self.tracker.snapshot())

    def _restore(self, snap: tuple) -> None:
        (ex, new, n_new, limits, assigns, unsched, n_claims,
         tsnap) = snap
        for sim, (rem, fk) in zip(self.existing, ex):
            sim.remaining = rem
            sim.failed_keys = fk
        del self.new_sims[n_new:]
        for sim, (reqs, cands, requests, npods, lk, doms, fk) in zip(
                self.new_sims, new):
            sim.requirements = reqs
            sim.candidates = cands
            sim.requests = requests
            del sim.pods[npods:]
            sim.last_key = lk
            # the tracker holds this dict BY REFERENCE — restore its
            # contents in place, never rebind it
            sim.domains.clear()
            sim.domains.update(doms)
            sim.failed_keys = fk
        self._remaining_limits = limits
        self.result.existing_assignments.clear()
        self.result.existing_assignments.update(assigns)
        self.result.unschedulable.clear()
        self.result.unschedulable.update(unsched)
        del self.result.new_claims[n_claims:]
        self.tracker.restore(tsnap)

    def _schedule_gang(self, spec, members: List[Pod]) -> None:
        """All-or-nothing multi-node gang placement: try each adjacency
        domain in the SHARED deterministic order (gang_trial_order —
        the rank the device encoder folds into dbase), placing every
        member restricted to that domain; the first domain that takes
        the whole gang commits, any failure rolls the trial back
        bit-exactly via the state snapshot.  No domain ⇒ the gang
        strands WHOLE with a gang reason code.  Soft terms on gang
        members are ignored (gangs never enter the relaxation ladder);
        a gang with fewer/more pending members than its declared size
        waits (GangIncomplete) — the same verdict the encoder applies,
        so kernel-vs-oracle parity covers the incomplete case too."""
        import dataclasses
        cnt = len(members)
        # members already BOUND on live nodes count toward completeness
        # (a recreated member of a running gang
        # must not strand GangIncomplete forever — the residual must
        # rejoin its gang), and their nodes pin the adjacency domain
        # the pending ranks must land in
        bound = 0
        bound_nodes = []
        for en in self.inp.existing_nodes:
            n = 0
            for p in en.pods:
                bsp = gang_of(p)
                if bsp is not None and bsp.name == spec.name:
                    n += 1
            if n:
                bound += n
                bound_nodes.append(en)
        if spec.size and cnt + bound != spec.size:
            reason = explainmod.make(
                explainmod.GANG_INCOMPLETE,
                f"gang {spec.name}: {cnt} member(s) pending"
                + (f" + {bound} bound" if bound else "")
                + f" of {spec.size} declared — "
                + ("waiting for the full gang" if cnt + bound < spec.size
                   else "more members than declared; fix gang-size"),
                {"code": explainmod.GANG_INCOMPLETE,
                 "constraint": "gang",
                 "gang": {"name": spec.name, "declared_size": spec.size,
                          "members_pending": cnt,
                          "members_bound": bound}})
            for m in members:
                self.result.unschedulable[m.meta.name] = reason
            return
        key = spec.domain_key
        if key is None:
            domains: List[Optional[str]] = [None]
        else:
            if bound_nodes:
                # residual gang: the ONLY candidate domains are where
                # the bound members already run (rank adjacency is to
                # the RUNNING ranks, not to any domain with capacity);
                # an unlabeled bound node contributes nothing and an
                # empty set strands GangDomainExhausted below
                cand = {d for d in (en.node.labels.get(key)
                                    for en in bound_nodes)
                        if d is not None}
            else:
                cand = self.tracker.known_domains.get(key, set())
            domains = [
                d for d in gang_trial_order(cand)
                if all((m.requirements.get(key) is None
                        or m.requirements.get(key).matches(d))
                       for m in members)]
        best_placed = 0
        best_domain: Optional[str] = None
        for d in domains:
            snap = self._snapshot()
            placed = 0
            for m in members:
                variant = m
                if d is not None:
                    variant = dataclasses.replace(
                        m, requirements=m.requirements.intersection(
                            Requirements(
                                Requirement.make(key, "In", d))))
                if self._place(variant, effective_request(m)) is None:
                    placed += 1
                else:
                    break
            if placed == cnt:
                return  # the whole gang committed in domain d
            if placed > best_placed:
                best_placed, best_domain = placed, d
            self._restore(snap)
        # node-deficit estimate on the kernel tree's basis (allocatable
        # minus daemon overhead, best catalog column): how many MORE
        # nodes the nearest domain would need — the actionable number
        # for a stranded tightly-coupled job
        deficit = cnt - best_placed
        best_fit = 0
        mreq = effective_request(members[0])
        for pool in self.inp.nodepools:
            daemon = self.inp.daemon_overhead.get(pool.name, Resources())
            for it in self.inp.instance_types.get(pool.name, []):
                avail = it.allocatable() - daemon
                fit = None
                for i, r in enumerate(mreq.v):
                    # host float-noise guards for the nearest-miss
                    # SUGGESTION count, deliberately tighter than the
                    # kernel's fit EPS: this never gates a placement,
                    # so aligning it to EPS would only blur the hint
                    if r > 1e-9:
                        k = int((avail.v[i] + 1e-9) // r)
                        fit = k if fit is None else min(fit, k)
                best_fit = max(best_fit, fit or 0)
        if best_placed <= 0:
            if best_fit == 0 and not any(
                    mreq.fits(en.available)
                    for en in self.inp.existing_nodes):
                # no purchasable type and no live node can hold even ONE
                # member: the gang can NEVER fit — the kernel's
                # GangTooLarge verdict, kept here so _rescue_stranded's
                # oracle re-judgement doesn't demote it to the
                # wait-might-help GangDomainExhausted
                code = explainmod.GANG_TOO_LARGE
                detail = (f"gang {spec.name}: no instance type or "
                          "existing node can hold a single member — "
                          "the gang cannot fit at any capacity")
            else:
                code = explainmod.GANG_DOMAIN
                detail = (f"gang {spec.name}: no adjacency domain can "
                          "currently hold any member")
        else:
            code = explainmod.GANG_PARTIAL
            detail = (f"gang {spec.name}: best domain holds "
                      f"{best_placed} of {cnt} members — stranded "
                      "whole rather than split")
        reason = explainmod.make(code, detail, {
            "code": code, "constraint": "gang",
            "gang": {"name": spec.name, "declared_size": spec.size,
                     "members_pending": cnt,
                     "domain_axis": (
                         "zone" if key == wellknown.ZONE_LABEL
                         else "capacity-type" if key is not None
                         else "none"),
                     "nearest_domain": best_domain,
                     "nearest_domain_members": best_placed,
                     "deficit_members": deficit,
                     "deficit_nodes": (-(-deficit // best_fit)
                                       if best_fit else None)}})
        for m in members:
            self.result.unschedulable[m.meta.name] = reason

    # ------------------------------------------------------------------
    def _schedule_one(self, pod: Pod) -> None:
        """Soft terms (preferred node affinity, preferred pod affinity,
        ScheduleAnyway spread) are enforced as required and relaxed one
        term at a time when the pod cannot place (reference scheduler
        preference handling, scheduling.md:282-379) — a bounded outer loop
        around the placement attempt. Soft terms
        thus shape placement when satisfiable and never block."""
        req = effective_request(pod)
        reason: Optional[str] = None
        for level in range(pod.relax_levels() + 1):
            variant = pod.relaxed(level)
            reason = self._place(variant, req)
            if reason is None:
                return
        self.result.unschedulable[pod.meta.name] = reason

    def _place(self, pod: Pod, req: Resources) -> Optional[str]:
        # interned int, not the deep tuple: the failed-key memo is probed
        # per (pod, sim) and deep-tuple hashing (Resources + Requirements
        # members) was ~60% of the oracle's 50k wall-clock; the int id
        # follows the same immutable-spec/intern-epoch discipline the
        # grouped solver already relies on (objects.py:249)
        key = pod.scheduling_group_id()
        # topology-sensitive pods can't reuse failure memos: the tracker
        # state they were checked against changes with every placement
        stateful = bool(pod.topology_spread or pod.pod_affinities
                        or self.tracker.anti_topology_keys())

        # negative memos stay valid across placements: capacity only shrinks
        # and requirements only narrow, so a failed class can only fail harder
        for sim in self.existing:
            if not stateful and key in sim.failed_keys:
                continue
            if self._fits_existing(pod, req, sim):
                sim.remaining = sim.remaining - req
                self.result.existing_assignments[pod.meta.name] = sim.name
                self.tracker.register(pod, sim.domains)
                # synthetic claim-nodes are purchases: placements charge
                # the pool limit (real existing nodes are free capacity)
                cp = sim.en.charge_pool
                if cp is not None:
                    limit = self._remaining_limits.get(cp)
                    if limit is not None:
                        self._remaining_limits[cp] = limit - req
                return None
            sim.failed_keys.add(key)

        for sim in self.new_sims:
            if not stateful and key in sim.failed_keys:
                continue
            if self._try_add_to_new(pod, req, sim, commit=True):
                return None
            sim.failed_keys.add(key)

        return self._open_new(pod, req)

    # -- existing nodes --------------------------------------------------
    def _fits_existing(self, pod: Pod, req: Resources, sim: _ExistingSim) -> bool:
        node = sim.en.node
        if node.meta.deleting or not node.ready:
            return False
        if not tolerates_all(node.taints, pod.tolerations):
            return False
        if not pod.requirements.matched_by_labels(node.labels):
            return False
        if not req.fits(sim.remaining):
            return False
        if sim.en.charge_pool is not None:
            # a synthetic claim-node placement is a purchase: the pool's
            # remaining limit must cover it
            limit = self._remaining_limits.get(sim.en.charge_pool)
            if limit is not None and not req.fits(limit):
                return False
        return self._topology_ok_fixed(pod, sim.domains, sim)

    def _topology_ok_fixed(self, pod: Pod, domains: Dict[str, str],
                           sim: object) -> bool:
        """Topology checks when every relevant domain is already determined
        (existing nodes, or new sims whose keys are narrowed)."""
        for c in pod.topology_spread:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue  # ScheduleAnyway is best-effort, never blocks
            d = domains.get(c.topology_key)
            if d is None:
                return False  # DoNotSchedule requires the topology key
            if d not in self.tracker.spread_allowed_domains(pod, c, {d}):
                return False
        return self._affinity_ok(pod, domains)

    def _affinity_ok(self, pod: Pod, domains: Dict[str, str]) -> bool:
        for term in pod.pod_affinities:
            if not term.required:
                continue
            d = domains.get(term.topology_key)
            if d is None:
                return False
            if term.anti:
                if d in self.tracker.anti_affinity_blocked_domains(
                        pod, term.topology_key, term.label_selector):
                    return False
            else:
                if d not in self.tracker.affinity_allowed_domains(
                        pod, {d}, term.topology_key, term.label_selector):
                    return False
        # symmetry: placed pods' anti-affinity blocks this pod
        for tkey in self.tracker.anti_topology_keys():
            d = domains.get(tkey)
            if d is not None and d in self.tracker.symmetric_anti_blocked_domains(pod, tkey):
                return False
        return True

    # -- in-flight new nodes ---------------------------------------------
    @staticmethod
    def _unknown_required_key(pod: Pod, template: Requirements) -> Optional[str]:
        """A pod requirement on a label that is neither well-known (derivable
        from instance types/offerings) nor provided by the NodePool template
        can never be satisfied by a new node (reference: scheduling
        Requirements allowUndefined discipline — pods may only require labels
        with known values)."""
        for r in pod.requirements:
            if r.key in wellknown.WELL_KNOWN_LABELS:
                continue
            if template.get(r.key) is not None:
                continue
            if not r.matches_absent():
                return r.key
        return None

    def _try_add_to_new(self, pod: Pod, req: Resources, sim: _NewSim,
                        commit: bool) -> bool:
        key = pod.scheduling_group_id()  # interned int — see _place
        stateful = bool(pod.topology_spread or pod.pod_affinities
                        or self.tracker.anti_topology_keys())
        total = sim.requests + req
        limit = self._remaining_limits.get(sim.pool.name)
        if limit is not None and not req.fits(limit):
            return False

        if key == sim.last_key and not stateful:
            # identical pod, no topology state: requirements can't change,
            # only capacity can — re-check fit alone
            merged = sim.requirements
            survivors = [it for it in sim.candidates
                         if total.fits(it.allocatable())]
            if not survivors:
                return False
        else:
            if not tolerates_all(sim.pool.taints, pod.tolerations):
                return False
            if self._unknown_required_key(
                    pod, sim.pool.template_requirements()) is not None:
                return False
            if not sim.requirements.compatible(pod.requirements):
                return False
            merged = sim.requirements.intersection(pod.requirements)
            survivors = self._filter_types(sim.candidates, merged, total)
            if not survivors:
                return False
            narrowed = self._resolve_topology(pod, sim, merged, survivors)
            if narrowed is None:
                return False
            merged, survivors = narrowed

        if not commit:
            return True

        sim.requirements = merged
        sim.candidates = survivors
        sim.requests = total
        sim.pods.append(pod)
        sim.last_key = key
        if sim._sync_fixed_domains() and sim.pods[:-1]:
            # the claim just pinned a domain: resident pods placed while it
            # was undetermined must count there (affinity co-location)
            self.tracker.invalidate_counts()
        self.tracker.register(pod, sim.domains)
        if limit is not None:
            self._remaining_limits[sim.pool.name] = limit - req
        return True

    def _resolve_topology(
        self, pod: Pod, sim: _NewSim, merged: Requirements,
        survivors: List[InstanceType],
    ) -> Optional[Tuple[Requirements, List[InstanceType]]]:
        """Check spread/affinity for a candidate placement on a new node,
        narrowing the claim's zone/capacity-type requirement when a
        constraint forces a single domain. Returns updated (requirements,
        candidates) or None if no domain works.
        """
        # start from the claim's currently-possible domains per key
        offer_zones = {o.zone for it in survivors for o in it.offerings if o.available}
        offer_cts = {o.capacity_type for it in survivors for o in it.offerings if o.available}
        possible: Dict[str, Set[str]] = {
            wellknown.ZONE_LABEL: sim.finite_values(wellknown.ZONE_LABEL, offer_zones) & offer_zones,
            wellknown.CAPACITY_TYPE_LABEL: sim.finite_values(
                wellknown.CAPACITY_TYPE_LABEL, offer_cts) & offer_cts,
            wellknown.HOSTNAME_LABEL: {sim.hostname},
            wellknown.NODEPOOL_LABEL: {sim.pool.name},
        }
        for key in _NARROWABLE_KEYS:
            preq = merged.get(key)
            if preq is not None:
                # filter by the requirement whatever its form — a complement
                # (NotIn/Gt/Lt) must also exclude domains, or spread could
                # pin the claim to a forbidden zone
                possible[key] = {d for d in possible[key] if preq.matches(d)}
            if not possible[key]:
                return None

        constrained_keys: Set[str] = set()
        for c in pod.topology_spread:
            if c.when_unsatisfiable != "DoNotSchedule":
                continue  # best-effort
            key = c.topology_key
            if key not in possible:
                return None  # unknown topology key on a new node
            allowed = self.tracker.spread_allowed_domains(pod, c, possible[key])
            if not allowed:
                return None
            possible[key] = allowed
            if key != wellknown.HOSTNAME_LABEL:
                constrained_keys.add(key)
        for term in pod.pod_affinities:
            if not term.required:
                continue
            key = term.topology_key
            if key not in possible:
                return None
            if term.anti:
                blocked = self.tracker.anti_affinity_blocked_domains(
                    pod, key, term.label_selector)
                # a new sim node holding a matching pod blocks via register()
                allowed = possible[key] - blocked
            else:
                allowed = self.tracker.affinity_allowed_domains(
                    pod, possible[key], key, term.label_selector)
                if not allowed and any(
                        _matches(_sel(term.label_selector), p.meta.labels)
                        for p in sim.pods):
                    # no determined domain holds a match, but THIS sim
                    # does: co-locate here — the narrowing below pins the
                    # claim's domain, and the pin re-registers its
                    # residents so later pods see a populated domain
                    allowed = set(possible[key])
            if not allowed:
                return None
            possible[key] = allowed
            if key != wellknown.HOSTNAME_LABEL:
                constrained_keys.add(key)
        for tkey in self.tracker.anti_topology_keys():
            if tkey in possible:
                blocked = self.tracker.symmetric_anti_blocked_domains(pod, tkey)
                remaining = possible[tkey] - blocked
                if not remaining:
                    return None
                if remaining != possible[tkey]:
                    possible[tkey] = remaining
                    if tkey != wellknown.HOSTNAME_LABEL:
                        constrained_keys.add(tkey)

        # narrow the claim where a constraint engaged: pick the least-loaded
        # allowed domain so spreading continues to balance
        out_reqs = merged
        for key in sorted(constrained_keys & set(_NARROWABLE_KEYS)):
            cur = out_reqs.get(key)
            if cur is not None and cur.is_finite() and cur.values() <= possible[key] \
                    and len(cur.values()) == 1:
                continue  # already pinned to an allowed domain
            counts = None
            for c in pod.topology_spread:
                if c.topology_key == key:
                    counts = self.tracker.ensure_spread_counter(c)
                    break
            chosen = min(
                sorted(possible[key]),
                key=lambda d: (counts.get(d, 0) if counts is not None else 0, d),
            )
            out_reqs = out_reqs.intersection(
                Requirements(Requirement.make(key, "In", chosen)))

        survivors = self._filter_types(survivors, out_reqs, None)
        if not survivors:
            return None
        return out_reqs, survivors

    # -- opening a new node ----------------------------------------------
    def _open_new(self, pod: Pod, req: Resources) -> Optional[str]:
        # per-pool (cause, pool name, text) verdicts: the text keeps the
        # legacy log line; the cause + pool name feed the structured
        # reason tree and decide the overall code (a binding limit
        # anywhere ⇒ PoolLimitExceeded, the verdict the solver's oracle
        # backstop keys on)
        reasons: List[Tuple[str, str, str]] = []
        pools = sorted(self.inp.nodepools,
                       key=lambda np: (-np.weight, np.meta.name))
        for pool in pools:
            types = self.inp.instance_types.get(pool.name, [])
            if not types:
                reasons.append((explainmod.CAUSE_NO_TYPES, pool.name,
                                f"nodepool {pool.name}: no instance types"))
                continue
            if not tolerates_all(pool.taints, pod.tolerations):
                reasons.append((explainmod.CAUSE_TAINTS, pool.name,
                                f"nodepool {pool.name}: taints not tolerated"))
                continue
            template = pool.template_requirements()
            unknown = self._unknown_required_key(pod, template)
            if unknown is not None:
                reasons.append((
                    explainmod.CAUSE_UNKNOWN_LABEL, pool.name,
                    f"nodepool {pool.name}: label {unknown} has no known values"))
                continue
            if not template.compatible(pod.requirements):
                key = template.conflict_key(pod.requirements)
                reasons.append((
                    explainmod.CAUSE_INCOMPATIBLE, pool.name,
                    f"nodepool {pool.name}: incompatible on {key}"))
                continue
            merged = template.intersection(pod.requirements)
            daemon = self.inp.daemon_overhead.get(pool.name, Resources())
            total = daemon + req
            limit = self._remaining_limits.get(pool.name)
            # a new node charges pod + daemonset overhead against the limit
            if limit is not None and not total.fits(limit):
                reasons.append((explainmod.CAUSE_LIMITS, pool.name,
                                f"nodepool {pool.name}: limits exceeded"))
                continue
            survivors = self._filter_types(types, merged, total)
            if not survivors:
                reasons.append((
                    explainmod.CAUSE_NO_FIT, pool.name,
                    f"nodepool {pool.name}: no instance type fits/compatible"))
                continue
            sim = _NewSim(pool, merged, survivors, daemon)
            narrowed = self._resolve_topology(pod, sim, merged, survivors)
            if narrowed is None:
                reasons.append((
                    explainmod.CAUSE_TOPOLOGY, pool.name,
                    f"nodepool {pool.name}: topology unsatisfiable"))
                continue
            sim.requirements, sim.candidates = narrowed
            sim.requests = total
            sim.pods.append(pod)
            sim._sync_fixed_domains()
            self.new_sims.append(sim)
            self.tracker.register(pod, sim.domains)
            if limit is not None:
                self._remaining_limits[pool.name] = limit - total
            return None
        detail = ("; ".join(t for _, _, t in reasons) if reasons
                  else "no nodepools configured")
        code = (explainmod.POOL_LIMIT
                if any(c == explainmod.CAUSE_LIMITS for c, _, _ in reasons)
                else explainmod.NO_NODEPOOL)
        tree = {"code": code,
                "constraint": explainmod.constraint_of(code),
                "pools": [{"nodepool": name, "cause": c, "detail": t}
                          for c, name, t in reasons]}
        return explainmod.make(
            code, f"no nodepool can schedule pod: {detail}", tree)

    # -- shared filters ---------------------------------------------------
    @staticmethod
    def _filter_types(
        types: List[InstanceType],
        reqs: Requirements,
        total_requests: Optional[Resources],
    ) -> List[InstanceType]:
        out = []
        for it in types:
            if not it.requirements.compatible(reqs):
                continue
            if total_requests is not None and not total_requests.fits(it.allocatable()):
                continue
            if not it.available_offerings(reqs):
                continue
            out.append(it)
        return out

    # -- finalize ----------------------------------------------------------
    def _finalize(self) -> None:
        from karpenter_tpu_torch.utils.knobs import spot_risk_enabled
        risk_on = spot_risk_enabled()
        if risk_on:
            from karpenter_tpu_torch.scheduling import risk as riskmod
            # spot claims already finalized this solve, by (type, zone):
            # each repeat in the same pool pays the diversification
            # penalty, steering later nodes toward uncorrelated capacity
            spot_seen: Dict[Tuple[str, str], int] = {}
        for sim in self.new_sims:
            reqs = sim.requirements
            if risk_on:
                def _rank(it):
                    o = it.cheapest_offering(reqs)
                    eff = riskmod.effective_price(
                        o.price, it.name, o.zone, o.capacity_type)
                    if o.capacity_type == wellknown.CAPACITY_TYPE_SPOT:
                        eff += (riskmod.DIVERSIFY_PENALTY * o.price
                                * spot_seen.get((it.name, o.zone), 0))
                    # real price then name break effective-price ties, so
                    # risk-neutral catalogs keep the pre-risk order
                    return (eff, o.price, it.name)
                ranked = sorted(sim.candidates, key=_rank)
            else:
                ranked = sorted(
                    sim.candidates,
                    key=lambda it: (it.cheapest_offering(reqs).price,
                                    it.name),
                )
            violation = min_values_violation(reqs, ranked)
            if violation is not None:
                reason = explainmod.make(explainmod.MIN_VALUES, violation)
                for pod in sim.pods:
                    self.result.unschedulable[pod.meta.name] = reason
                continue
            cheapest = ranked[0].cheapest_offering(reqs)
            if risk_on and cheapest.capacity_type == \
                    wellknown.CAPACITY_TYPE_SPOT:
                k = (ranked[0].name, cheapest.zone)
                spot_seen[k] = spot_seen.get(k, 0) + 1
            self.result.new_claims.append(NewNodeClaim(
                nodepool=sim.pool.name,
                node_class_ref=sim.pool.node_class_ref,
                requirements=reqs,
                pods=list(sim.pods),
                requests=sim.requests.copy(),
                instance_type_names=[it.name for it in ranked],
                price=cheapest.price,
                taints=list(sim.pool.taints),
                startup_taints=list(sim.pool.startup_taints),
                hostname=sim.hostname,
            ))

