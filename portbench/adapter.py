"""Plain inputs (`generate.py`) into the program's objects, and the
program's answers back into the reference's canonical form.

This is the only module of the harness that knows the program's model
classes.  One `Adapter` serves one run: it loads each catalog table once
through the program's own loader, so every input of the run shares one
instance-type list (the solver's catalog cache keys on its identity, as
the operator's instance-type provider hands out one list per catalog
version).
"""

from __future__ import annotations

from typing import Dict, List

from karpenter_tpu_torch.models import (
    Node,
    NodePool,
    ObjectMeta,
    Pod,
    Requirement,
    Requirements,
    Resources,
    Taint,
    Toleration,
)
from karpenter_tpu_torch.providers.catalog import catalog_from_table
from karpenter_tpu_torch.scheduling import ExistingNode, ScheduleInput

from portbench import catalog
from portbench.reference.ffd import Answer


class Adapter:
    def __init__(self):
        self._tables: Dict[str, list] = {}
        self._pools: Dict[int, List[NodePool]] = {}
        self._fleets: Dict[int, List[ExistingNode]] = {}

    def instance_types(self, table: str) -> list:
        its = self._tables.get(table)
        if its is None:
            its = self._tables[table] = catalog_from_table(
                catalog.load_table(table))
        return its

    def pools(self, plain: List[Dict]) -> List[NodePool]:
        got = self._pools.get(id(plain))
        if got is None:
            got = []
            for p in plain:
                reqs = Requirements(*(Requirement.make(k, "In", *v)
                                      for k, v in p.get("requirements",
                                                        {}).items()))
                got.append(NodePool(
                    meta=ObjectMeta(name=p["name"]),
                    weight=int(p.get("weight", 0)), requirements=reqs,
                    taints=[Taint(k, v, e) for k, v, e in p.get("taints",
                                                                 [])]))
            self._pools[id(plain)] = got
        return got

    @staticmethod
    def pods(plain: Dict, tolerations) -> List[Pod]:
        out = []
        tols = [Toleration(key=k, operator=op, value=v, effect=e)
                for k, op, v, e in tolerations]
        for name, row, zone, tol in zip(plain["name"], plain["requests"],
                                        plain["zone"], plain["tolerate"]):
            p = Pod(meta=ObjectMeta(name=name),
                    requests=Resources([float(x) for x in row]))
            if zone is not None:
                p.requirements = Requirements(Requirement.make(
                    catalog.ZONE, "In", zone))
            if tol:
                p.tolerations = list(tols)
            out.append(p)
        return out

    def schedule_input(self, prob: Dict) -> ScheduleInput:
        pools = self.pools(prob["pools"])
        its = self.instance_types(prob["table"])
        return ScheduleInput(
            pods=self.pods(prob["pods"], prob.get("tolerations", [])),
            nodepools=pools, instance_types={p.meta.name: its
                                             for p in pools},
            price_cap=prob.get("price_cap"))

    def fleet(self, fl: Dict) -> List[ExistingNode]:
        """The fleet's nodes, each with its one pod, built once a run."""
        got = self._fleets.get(id(fl))
        if got is not None:
            return got
        got = []
        req = [float(x) for x in fl["pod_requests"]]
        for name, labels, alloc, pod in zip(fl["name"], fl["labels"],
                                            fl["allocatable"], fl["pods"]):
            n = Node(meta=ObjectMeta(name=name, labels=dict(labels)),
                     allocatable=Resources([float(x) for x in alloc]),
                     ready=True)
            p = Pod(meta=ObjectMeta(name=pod), requests=Resources(list(req)),
                    node_name=name)
            got.append(ExistingNode(node=n,
                                    available=n.allocatable - p.requests,
                                    pods=[p]))
        self._fleets[id(fl)] = got
        return got

    def simulations(self, cfg: Dict, fl: Dict,
                    cand_sets: List[List[int]]) -> List[ScheduleInput]:
        """One call's simulations as the disruption controller builds
        them: each candidate set's pods against the shared snapshot minus
        the candidates, with the snapshot's provenance."""
        nodes = self.fleet(fl)
        pools = self.pools(cfg["pools"])
        its = self.instance_types(cfg["catalog"])
        types = {p.meta.name: its for p in pools}
        out = []
        for cands in cand_sets:
            rest, lo = [], 0
            for i in sorted(cands):
                rest += nodes[lo:i]
                lo = i + 1
            rest += nodes[lo:]
            out.append(ScheduleInput(
                pods=[p for i in cands for p in nodes[i].pods],
                nodepools=pools, instance_types=types,
                existing_nodes=rest,
                price_cap=cfg.get("price_cap"),
                exist_base=nodes, exist_excluded=tuple(cands)))
        return out


def canonical(res) -> Answer:
    """The program's answer (a `ScheduleResult`) in the reference's
    canonical form."""
    claims = [(c.nodepool, tuple(c.instance_type_names), float(c.price),
               tuple(p.meta.name for p in c.pods)) for c in res.new_claims]
    return Answer(claims=claims, existing=dict(res.existing_assignments),
                  unschedulable=sorted(res.unschedulable))

