"""The port's encoder against the JAX package's: the same scheduling input,
built once with each package's classes, must encode to array-equal
problems — columns, group masks, existing-node caps, pool limits and the
topology tensors."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest


def _pkg(root):
    return SimpleNamespace(
        M=importlib.import_module(f"{root}.models"),
        prov=importlib.import_module(f"{root}.providers"),
        cat=importlib.import_module(f"{root}.providers.catalog"),
        S=importlib.import_module(f"{root}.scheduling.types"),
        enc=importlib.import_module(f"{root}.solver.encode"),
    )


JAX = _pkg("karpenter_tpu")
PORT = _pkg("karpenter_tpu_torch")


def scenario(ns, kind, n=120):
    """One scheduling input built from `ns`'s classes (deterministic)."""
    M, S = ns.M, ns.S
    wk = M.wellknown
    catalog = ns.prov.generate_catalog(ns.cat.CatalogSpec(max_types=48))
    zones = ["tpu-west-1a", "tpu-west-1b", "tpu-west-1c"]
    sizes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"),
             ("2", "4Gi"), ("4", "8Gi")]

    def pod(name, i, **kw):
        cpu, mem = sizes[i % len(sizes)]
        return M.Pod(meta=M.ObjectMeta(name=name,
                                       labels=kw.pop("labels", {})),
                     requests=M.Resources.parse({"cpu": cpu, "memory": mem}),
                     **kw)

    pools = [M.NodePool(meta=M.ObjectMeta(name="default"))]
    pods = [pod(f"p{i}", i) for i in range(n)]
    kw = {}
    if kind == "selectors-taints-pools":
        pools = [
            M.NodePool(meta=M.ObjectMeta(name="general"), weight=10),
            M.NodePool(meta=M.ObjectMeta(name="spot-only"),
                       requirements=M.Requirements(M.Requirement.make(
                           wk.CAPACITY_TYPE_LABEL, "In", "spot"))),
            M.NodePool(meta=M.ObjectMeta(name="dedicated"), weight=5,
                       taints=[M.Taint("team", "ml")]),
        ]
        for i, p in enumerate(pods):
            if i % 3 == 0:
                p.requirements = M.Requirements(M.Requirement.make(
                    wk.ZONE_LABEL, "In", zones[i % len(zones)]))
            if i % 7 == 0:
                p.tolerations = [M.Toleration(key="team",
                                              operator="Exists")]
        kw["daemon_overhead"] = {
            "general": M.Resources.parse({"cpu": "100m", "memory": "128Mi"}),
            "dedicated": M.Resources.parse({"cpu": "250m"})}
        room = {"pods": "100000", "ephemeral-storage": "1000Ti",
                "nvidia.com/gpu": "1000", "volumes": "100000"}
        kw["remaining_limits"] = {
            "general": M.Resources.parse(
                dict(room, cpu="120", memory="480Gi")),
            "spot-only": M.Resources.parse(
                dict(room, cpu="800", memory="3200Gi")),
            "dedicated": None}
    elif kind == "existing-nodes":
        existing = []
        for i in range(6):
            alloc = M.Resources.parse({"cpu": "8", "memory": "32Gi",
                                       "pods": "58"})
            node = M.Node(meta=M.ObjectMeta(name=f"n{i}", labels={
                wk.ZONE_LABEL: zones[i % 3],
                wk.CAPACITY_TYPE_LABEL: "on-demand",
                wk.NODEPOOL_LABEL: "default",
                wk.ARCH_LABEL: "amd64", wk.OS_LABEL: "linux",
                wk.HOSTNAME_LABEL: f"n{i}"}),
                allocatable=alloc, ready=(i != 5),
                taints=[M.Taint("gpu", "yes")] if i == 4 else [])
            resident = M.Pod(meta=M.ObjectMeta(name=f"r{i}"),
                             requests=M.Resources.parse(
                                 {"cpu": "1", "memory": "2Gi"}),
                             node_name=f"n{i}")
            existing.append(S.ExistingNode(
                node=node, available=alloc - resident.requests,
                pods=[resident]))
        kw["existing_nodes"] = existing
        kw["daemon_overhead"] = {
            "default": M.Resources.parse({"cpu": "200m", "memory": "256Mi"})}
    elif kind == "whole-node-and-hostname":
        for i in range(6):
            pods.append(pod(f"w{i}", 1, labels={"app": "w"},
                            pod_affinities=[M.PodAffinityTerm(
                                label_selector={"app": "w"},
                                topology_key=wk.HOSTNAME_LABEL)]))
        for i in range(9):
            pods.append(pod(f"h{i}", 2, labels={"app": "h"},
                            topology_spread=[M.TopologySpreadConstraint(
                                topology_key=wk.HOSTNAME_LABEL, max_skew=2,
                                label_selector={"app": "h"})]))
        for i in range(4):
            pods.append(pod(f"a{i}", 0, labels={"app": "a"},
                            pod_affinities=[M.PodAffinityTerm(
                                label_selector={"app": "a"},
                                topology_key=wk.HOSTNAME_LABEL,
                                anti=True)]))
    elif kind == "zone-spread":
        for i in range(12):
            pods.append(pod(f"z{i}", 1, labels={"app": "z"},
                            topology_spread=[M.TopologySpreadConstraint(
                                topology_key=wk.ZONE_LABEL, max_skew=1,
                                label_selector={"app": "z"})]))
    else:
        raise ValueError(kind)
    return S.ScheduleInput(pods=pods, nodepools=pools,
                           instance_types={p.name: catalog for p in pools},
                           **kw)


def _reqs(r):
    if r is None:
        return None
    return tuple(sorted((q.key, tuple(sorted(q.vals)), q.complement,
                         q.greater_than, q.less_than, q.requires_existence,
                         q.min_values) for q in r))


ARRAYS = ("group_req", "group_count", "group_mask", "exist_cap",
          "exist_remaining", "col_alloc", "col_daemon", "col_price",
          "col_pool", "pool_limit", "group_ncap", "group_dsel",
          "group_dbase", "group_dcap", "group_skew", "group_mindom",
          "group_delig", "group_whole_node", "group_gang",
          "group_priority", "col_price_eff", "col_zone", "col_ct",
          "exist_zone", "exist_ct")


def _encode(ns, kind):
    inp = scenario(ns, kind)
    cat = ns.enc.encode_catalog(inp)
    return cat, ns.enc.encode(inp, cat)


@pytest.mark.parametrize("kind", ["selectors-taints-pools", "existing-nodes",
                                  "whole-node-and-hostname", "zone-spread"])
def test_encode_matches_reference(kind):
    jcat, je = _encode(JAX, kind)
    tcat, te = _encode(PORT, kind)
    for name in ARRAYS:
        a, b = getattr(je, name), getattr(te, name)
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name
    assert te.n_domains == je.n_domains
    assert te.zone_values == je.zone_values
    assert te.ct_values == je.ct_values
    assert te.static_allowed == je.static_allowed
    assert ([[p.meta.name for p in g] for g in te.groups]
            == [[p.meta.name for p in g] for g in je.groups])
    assert ([(c.pool, c.type_name, c.zone, c.capacity_type, c.price)
             for c in te.columns]
            == [(c.pool, c.type_name, c.zone, c.capacity_type, c.price)
                for c in je.columns])
    assert [e.name for e in te.existing] == [e.name for e in je.existing]
    assert [p.name for p in te.pools] == [p.name for p in je.pools]
    assert ([[_reqs(r) for r in row] for row in te.merged_reqs]
            == [[_reqs(r) for r in row] for row in je.merged_reqs])
    for name in ("pt_alloc", "col_valid", "pool_daemon"):
        assert np.array_equal(getattr(tcat, name), getattr(jcat, name)), name
    assert (tcat.zc, tcat.layout) == (jcat.zc, jcat.layout)


def test_scenarios_exercise_the_encoder():
    """The encode cases cover what they claim: weighted pools with finite
    limits and daemon overhead, existing rows with blocked nodes, whole-
    node and hostname-capped groups, a zone-spread group."""
    _, e = _encode(PORT, "selectors-taints-pools")
    assert len(e.pools) == 3 and np.isfinite(e.pool_limit).any()
    assert (e.col_daemon > 0).any() and not e.group_mask.all()
    _, e = _encode(PORT, "existing-nodes")
    assert e.exist_cap.shape[1] == 6 and (e.exist_cap == 0).any()
    _, e = _encode(PORT, "whole-node-and-hostname")
    assert e.group_whole_node.any() and (e.group_ncap < PORT.enc.BIG).any()
    _, e = _encode(PORT, "zone-spread")
    assert (e.group_dsel == 1).any()


@pytest.mark.parametrize("n,buckets", [(0, (0, 16)), (5, (4, 8)),
                                       (16, (1, 16)), (3000, (8, 2048))])
def test_bucket_matches(n, buckets):
    assert PORT.enc.bucket(n, buckets) == JAX.enc.bucket(n, buckets)
