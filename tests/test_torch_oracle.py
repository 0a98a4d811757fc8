"""The port's host oracle (`karpenter_tpu_torch.scheduling.Scheduler`)
against the JAX package's (`karpenter_tpu.scheduling.Scheduler`).

The same scheduling input, built once with each package's classes, must
schedule to the same canonical result (claims with their pins, existing
assignments, unschedulable pods with their reason codes).  The oracle is
pure Python on both sides; the port's copy differs only where the
reference would plan preemptions, which it refuses.
"""

import pytest

from karpenter_tpu_torch.scheduling.oracle import PreemptionNotPorted
from tests.test_torch_encode import JAX, PORT, scenario
from tests.test_torch_solve import canon, headline


def _sched(ns):
    import importlib
    return importlib.import_module(
        f"{ns.M.__name__.rsplit('.', 1)[0]}.scheduling").Scheduler


def _pool_limit(ns):
    inp = headline(ns, 120)
    inp.remaining_limits = {"default": ns.M.Resources.parse(
        {"cpu": "24", "memory": "96Gi", "pods": "1000",
         "ephemeral-storage": "100Ti", "nvidia.com/gpu": "100",
         "volumes": "1000"})}
    return inp


def _price_cap(ns):
    inp = headline(ns, 60)
    inp.price_cap = 0.5
    return inp


def _gang(ns):
    wk = ns.M.wellknown
    inp = scenario(ns, "zone-spread", n=24)
    for p in inp.pods[:4]:
        p.meta.annotations.update({wk.GANG_NAME_ANNOTATION: "g1",
                                   wk.GANG_SIZE_ANNOTATION: "4"})
    return inp


INPUTS = {
    "headline": lambda ns: headline(ns, 300),
    "zone-spread": lambda ns: scenario(ns, "zone-spread"),
    "existing-nodes": lambda ns: scenario(ns, "existing-nodes", n=80),
    "whole-node-and-hostname": lambda ns: scenario(
        ns, "whole-node-and-hostname"),
    "selectors-taints-pools": lambda ns: scenario(
        ns, "selectors-taints-pools", n=150),
    "pool-limit": _pool_limit,
    "price-cap": _price_cap,
    "gang": _gang,
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_oracle_matches_reference(name):
    ref = _sched(JAX)(INPUTS[name](JAX)).solve()
    got = _sched(PORT)(INPUTS[name](PORT)).solve()
    assert canon(got) == canon(ref)
    if name == "pool-limit":
        codes = {getattr(r, "code", None)
                 for r in got.unschedulable.values()}
        assert "PoolLimitExceeded" in codes


def test_oracle_refuses_where_the_reference_would_preempt():
    """A stranded pod that outranks an evictable resident pod: the
    reference plans a preemption; the port raises rather than return a
    result without the plan."""
    def build(ns):
        M, wk = ns.M, ns.M.wellknown
        node = M.Node(meta=M.ObjectMeta(name="n1", labels={
            wk.HOSTNAME_LABEL: "n1", wk.ZONE_LABEL: "tpu-west-1a"}),
            allocatable=M.Resources.parse({"cpu": "2", "memory": "4Gi",
                                           "pods": "10"}), ready=True)
        resident = M.Pod(meta=M.ObjectMeta(name="low"),
                         requests=M.Resources.parse({"cpu": "2"}),
                         node_name="n1")
        high = M.Pod(meta=M.ObjectMeta(
            name="high", annotations={wk.PRIORITY_ANNOTATION: "100"}),
            requests=M.Resources.parse({"cpu": "1"}))
        return ns.S.ScheduleInput(
            pods=[high], nodepools=[], instance_types={},
            existing_nodes=[ns.S.ExistingNode(
                node=node, available=M.Resources.parse({"memory": "4Gi"}),
                pods=[resident])])
    ref = _sched(JAX)(build(JAX)).solve()
    assert "high" in ref.unschedulable and ref.preemptions
    with pytest.raises(PreemptionNotPorted):
        _sched(PORT)(build(PORT)).solve()
