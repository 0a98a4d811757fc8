"""The preemption planner — minimal lowest-priority victim
sets that seat otherwise-unschedulable higher-priority pods.

Pure planning: nothing here evicts.  ``attach(inp, res)`` runs after a
solve as a pre-pass on the final verdicts — for every stranded pod (or
stranded GANG, which seats atomically or not at all) it walks the ONE
shared victim order (:func:`scheduling.types.preemption_victim_order`,
ascending effective priority, then deletion cost, then name) and
greedily accumulates victims until an existing-capacity-only oracle
trial seats the target, then prunes the set back to minimality.  Both
engines (the solver's ``solve()`` tail and the oracle Scheduler)
attach through this module, so kernel-vs-oracle parity covers the
chosen victims by construction.  The port's copy of
`karpenter_tpu/solver/preempt.py`, on the port's oracle and types: the
same victim order, trials and plan ids.

Victim discipline mirrors the disruption controller's evictability
rules: daemonsets and ``do-not-disrupt`` pods are never victims, and a
gang victim is the WHOLE gang (evicting part of a gang leaves a broken
gang running).  Targets whose band has no
strictly-lower-priority victim keep their original verdict; targets
that stay stranded after every candidate victim is hypothetically
evicted get ``PreemptionInsufficient``.

The trial input carries NO nodepools: a pod a new node could seat does
not need preemption (the main solve would have bought the node), so
seating must come from freed existing capacity.  Plans land on
``ScheduleResult.preemptions``; executing them — annotating victims,
draining them through the termination path, recording the ledger rows —
is a controller's job, not the planner's.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Set, Tuple

from karpenter_tpu_torch.models.objects import Pod
from karpenter_tpu_torch.scheduling.types import (
    ExistingNode,
    PreemptionPlan,
    ScheduleInput,
    ScheduleResult,
    VictimUnit,
    effective_request,
    gang_of,
    preemption_victim_order,
    priority_of,
)
from karpenter_tpu_torch.solver import explain as explainmod


def _victim_units(inp: ScheduleInput) -> List[VictimUnit]:
    """Evictable resident pods as atomic units: singles, and whole
    gangs (all members, across however many nodes they span)."""
    by_gang: Dict[str, List[Tuple[Pod, str]]] = {}
    singles: List[Tuple[Pod, str]] = []
    for en in inp.existing_nodes:
        # synthetic nodes (charge_pool set — the split/rescue paths
        # present planned claims as existing nodes) hold pods that are
        # not actually running anywhere; they are never victims
        if en.node.meta.deleting or en.charge_pool is not None:
            continue
        for p in en.pods:
            if p.is_daemonset or p.do_not_disrupt():
                continue
            g = gang_of(p)
            if g is not None:
                by_gang.setdefault(g.name, []).append((p, en.name))
            else:
                singles.append((p, en.name))
    units = [VictimUnit(
        name=p.meta.name, priority=priority_of(p), cost=p.deletion_cost(),
        pod_names=(p.meta.name,), node_names=(nn,),
    ) for p, nn in singles]
    for gname, members in by_gang.items():
        units.append(VictimUnit(
            name=f"gang:{gname}",
            priority=max(priority_of(p) for p, _ in members),
            cost=sum(p.deletion_cost() for p, _ in members),
            pod_names=tuple(p.meta.name for p, _ in members),
            node_names=tuple(sorted({nn for _, nn in members})),
            gang=gname,
        ))
    return units


def _target_units(inp: ScheduleInput,
                  res: ScheduleResult) -> List[List[Pod]]:
    """Stranded pods as seat-atomic units (gangs whole), highest
    effective priority first; pods already targeted by an attached plan
    are skipped so re-attachment is idempotent."""
    already = {n for pl in res.preemptions for n in pl.target_pods}
    by_name = {p.meta.name: p for p in inp.pods}
    gangs: Dict[str, List[Pod]] = {}
    targets: List[List[Pod]] = []
    for name in res.unschedulable:
        p = by_name.get(name)
        if p is None or name in already:
            continue
        g = gang_of(p)
        if g is not None:
            gangs.setdefault(g.name, []).append(p)
        else:
            targets.append([p])
    targets.extend(gangs.values())
    targets.sort(key=lambda pods: (-max(priority_of(p) for p in pods),
                                   min(p.meta.name for p in pods)))
    return targets


def _trial_seat(inp: ScheduleInput, res: ScheduleResult,
                target_pods: List[Pod], evicted: Set[str]) -> bool:
    """Would ``target_pods`` seat on EXISTING capacity with ``evicted``
    pod names gone?  Existing-only oracle trial — same engine semantics
    (taints, requirements, topology) as the verdict being overturned,
    via the oracle's internal entry so the trial can never re-plan."""
    from karpenter_tpu_torch.scheduling.oracle import Scheduler
    by_name = {p.meta.name: p for p in inp.pods}
    assigned: Dict[str, List[Pod]] = {}
    for pod_name, node in res.existing_assignments.items():
        p = by_name.get(pod_name)
        if p is not None:
            assigned.setdefault(node, []).append(p)
    exist2 = []
    for en in inp.existing_nodes:
        if en.node.meta.deleting:
            continue
        avail = en.available
        pods2 = []
        for p in en.pods:
            if p.meta.name in evicted:
                avail = avail + effective_request(p)
            else:
                pods2.append(p)
        # this pass's own placements consume headroom too
        for p in assigned.get(en.name, ()):
            if p.meta.name not in evicted:
                avail = avail - effective_request(p)
                pods2.append(p)
        exist2.append(ExistingNode(node=en.node, available=avail,
                                   pods=pods2, charge_pool=en.charge_pool))
    trial = ScheduleInput(
        pods=list(target_pods), nodepools=[], instance_types={},
        existing_nodes=exist2)
    tres = Scheduler(trial)._solve()
    return not tres.unschedulable


def plan(inp: ScheduleInput, res: ScheduleResult
         ) -> Tuple[List[PreemptionPlan], Dict[str, str]]:
    """Plans for every plannable stranded target, plus the
    ``PreemptionInsufficient`` verdicts for targets no victim set can
    seat.  Pure — ``res`` is read, never written."""
    plans: List[PreemptionPlan] = []
    insufficient: Dict[str, str] = {}
    targets = _target_units(inp, res)
    if not targets:
        return plans, insufficient
    units = _victim_units(inp)
    consumed = {u.name for pl in res.preemptions for u in pl.victims}
    evicted: Set[str] = {n for pl in res.preemptions
                         for n in pl.victim_pod_names()}
    for pods in targets:
        tp = max(priority_of(p) for p in pods)
        cands = preemption_victim_order(
            u for u in units
            if u.name not in consumed and u.priority < tp)
        if not cands:
            # nothing strictly below this band is evictable: a plain
            # capacity strand, not a preemption case — keep the verdict
            continue
        chosen: List[VictimUnit] = []
        names = set(evicted)
        seated = False
        for u in cands:
            chosen.append(u)
            names.update(u.pod_names)
            if _trial_seat(inp, res, pods, names):
                seated = True
                break
        if not seated:
            reason = explainmod.make(
                explainmod.PREEMPTION_INSUFFICIENT,
                "preemption insufficient: evicting every lower-priority "
                "pod still cannot seat this pod")
            for p in pods:
                insufficient[p.meta.name] = reason
            continue
        # prune back to minimality: drop any victim whose eviction the
        # seat does not actually need (greedy order can overshoot when a
        # later, larger victim alone frees the decisive node)
        for u in list(chosen):
            rest = set(evicted)
            for w in chosen:
                if w is not u:
                    rest.update(w.pod_names)
            if _trial_seat(inp, res, pods, rest):
                chosen.remove(u)
        target_names = sorted(p.meta.name for p in pods)
        pid = "preempt-" + hashlib.sha1(
            "|".join(target_names).encode()).hexdigest()[:12]
        plans.append(PreemptionPlan(
            plan_id=pid, target_pods=target_names, target_priority=tp,
            victims=list(chosen)))
        for u in chosen:
            consumed.add(u.name)
            evicted.update(u.pod_names)
    return plans, insufficient


def attach(inp: ScheduleInput, res: ScheduleResult) -> ScheduleResult:
    """The pre-pass both engines run on final verdicts: attach plans to
    ``res.preemptions`` and rewrite exhausted targets' verdicts to
    ``PreemptionInsufficient``.  No-op when priority is disabled or
    nothing stranded."""
    from karpenter_tpu_torch.utils.knobs import priority_enabled
    if not res.unschedulable or not priority_enabled():
        return res
    plans, insufficient = plan(inp, res)
    res.preemptions.extend(plans)
    for name, reason in insufficient.items():
        res.unschedulable[name] = reason
    return res
