"""TorchSolver(device="cpu") against the JAX package's TPUSolver.

The same scheduling input, built once with each package's classes, must
solve to the same canonical result: the claims (pool, pods, ranked
instance types, price as a float hex, the zone and capacity-type values
the claim is pinned to), the existing-node assignments and the
unschedulable pods with their reason codes.  Inputs the port does not run
yet must raise UnsupportedPods, never return a result.
"""

import json

import numpy as np
import pytest

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu_torch.solver import TorchSolver
from karpenter_tpu_torch.solver import ffd as tffd
from tests.test_torch_encode import JAX, PORT, scenario


def _pins(claim, key):
    """The sorted values a claim's requirement on `key` allows (None when
    the claim does not constrain the key)."""
    for r in claim.requirements:
        if r.key == key:
            return (tuple(sorted(r.values())) if r.is_finite()
                    else ("not-in",) + tuple(sorted(r.values())))
    return None


def canon(res):
    wk = PORT.M.wellknown
    return (sorted((c.nodepool, tuple(sorted(p.meta.name for p in c.pods)),
                    tuple(c.instance_type_names), float(c.price).hex(),
                    _pins(c, wk.ZONE_LABEL),
                    _pins(c, wk.CAPACITY_TYPE_LABEL))
                   for c in res.new_claims),
            sorted(res.existing_assignments.items()),
            sorted((k, getattr(v, "code", None))
                   for k, v in res.unschedulable.items()),
            float(res.total_price()).hex())


def default_catalog(ns):
    """The 605-type default catalog, loaded afresh from `ns`'s generated
    table: `generate_catalog()` returns one memoized list per process,
    which other test files on the same worker may mutate (prices)."""
    with open(ns.cat.GENERATED_CATALOG_PATH) as f:
        return ns.cat.catalog_from_table(json.load(f))


def headline(ns, n):
    """The headline workload (bench.py build_input) at n pods."""
    M = ns.M
    catalog = default_catalog(ns)
    sizes = [
        {"cpu": "250m", "memory": "512Mi"}, {"cpu": "500m", "memory": "1Gi"},
        {"cpu": "1", "memory": "2Gi"}, {"cpu": "2", "memory": "8Gi"},
        {"cpu": "4", "memory": "8Gi"}, {"cpu": "500m", "memory": "2Gi"},
        {"cpu": "1", "memory": "4Gi"},
        {"cpu": "8", "memory": "16Gi", "nvidia.com/gpu": 1}]
    pods = [M.Pod(meta=M.ObjectMeta(name=f"p{i}"),
                  requests=M.Resources.parse(sizes[i % len(sizes)]))
            for i in range(n)]
    pool = M.NodePool(meta=M.ObjectMeta(name="default"))
    return ns.S.ScheduleInput(pods=pods, nodepools=[pool],
                              instance_types={"default": catalog})


def jax_solver():
    return TPUSolver(mesh="off", delta="off", spec="off", incr="off")


INPUTS = {
    "headline-2k": lambda ns: headline(ns, 2000),
    "selectors-taints-pools": lambda ns: scenario(
        ns, "selectors-taints-pools", n=300),
    "existing-nodes": lambda ns: scenario(ns, "existing-nodes", n=150),
    "whole-node-and-hostname": lambda ns: scenario(
        ns, "whole-node-and-hostname"),
    "small-pool": lambda ns: scenario(ns, "existing-nodes", n=40),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_solve_matches_reference(name):
    build = INPUTS[name]
    ref = jax_solver().solve(build(JAX))
    port = TorchSolver(device="cpu")
    got = port.solve(build(PORT))
    assert canon(got) == canon(ref)
    assert got.new_claims and not got.unschedulable
    assert set(port.last_phase_ms) == {"encode", "pad", "dispatch",
                                       "device", "pull", "repair",
                                       "decode"}
    assert port.last_explain["kernel_aux"]


def test_warm_solve_matches_reference():
    """The second solve of a solver warm-starts the node axis (64 slots
    for the first solve's active count) and still gives the reference's
    answer."""
    jax_s, port = jax_solver(), TorchSolver(device="cpu")
    jinp, tinp = headline(JAX, 240), headline(PORT, 240)
    assert canon(port.solve(tinp)) == canon(jax_s.solve(jinp))
    assert port._adaptive_max_nodes() == 64
    assert canon(port.solve(tinp)) == canon(jax_s.solve(jinp))


def test_slot_exhaustion_reruns_at_the_ceiling(monkeypatch):
    """A warm-start node axis too small for the solve runs out of slots
    with pods stranded, and the solve re-runs at the configured ceiling."""
    calls = []
    real = tffd.solve_ffd

    def spy(prob, cat, max_nodes, explain=0, **statics):
        calls.append(max_nodes)
        return real(prob, cat, max_nodes, explain=explain, **statics)

    monkeypatch.setattr(tffd, "solve_ffd", spy)
    port = TorchSolver(device="cpu")
    port._last_active = 30             # node-axis estimate far too low
    got = port.solve(headline(PORT, 6000))
    assert calls == [64, 1024]
    assert got.node_count() > 64
    assert canon(got) == canon(jax_solver().solve(headline(JAX, 6000)))


def test_capped_solve_returns_slot_strands():
    """A consolidation-style capped solve that runs out of node slots
    returns its strands (codes and all) exactly like the reference."""
    ref = jax_solver().solve(headline(JAX, 600), max_nodes=4)
    port = TorchSolver(device="cpu")
    got = port.solve(headline(PORT, 600), max_nodes=4)
    assert got.unschedulable and got.node_count() == 4
    assert port._last_slots_exhausted
    assert canon(got) == canon(ref)


def _unsupported_inputs():
    def zone_spread(ns):
        return scenario(ns, "zone-spread")

    def gang(ns):
        wk = ns.M.wellknown
        inp = headline(ns, 40)
        for p in inp.pods[:4]:
            p.meta.annotations.update({wk.GANG_NAME_ANNOTATION: "g1",
                                       wk.GANG_SIZE_ANNOTATION: "4"})
        return inp

    def priority_bands(ns):
        wk = ns.M.wellknown
        inp = headline(ns, 40)
        for p in inp.pods[:10]:
            p.meta.annotations[wk.PRIORITY_ANNOTATION] = "100"
        return inp

    def stranded(ns):
        inp = headline(ns, 200)
        inp.remaining_limits = {"default": ns.M.Resources.parse(
            {"cpu": "4"})}
        return inp

    def soft_terms(ns):
        M, wk = ns.M, ns.M.wellknown
        inp = headline(ns, 40)
        inp.pods[0].preferences = [(10, M.Requirements(M.Requirement.make(
            wk.ZONE_LABEL, "In", "tpu-west-1a")))]
        return inp

    def custom_topology_key(ns):
        M = ns.M
        inp = headline(ns, 40)
        for p in inp.pods[:3]:
            p.meta.labels["app"] = "c"
            p.topology_spread = [M.TopologySpreadConstraint(
                topology_key="example.com/rack", max_skew=1,
                label_selector={"app": "c"})]
        return inp

    # the port runs each since slice 2 and must give the reference's
    # answer (the scan's heavy step for the spread, the
    # oracle rescue for the strands, the split path for the custom key,
    # since slice 2b the gang fill and the priority witness, since slice
    # 2c the relaxation loop)
    return {"zone-spread": zone_spread,
            "gang": gang,
            "priority-bands": priority_bands,
            "stranded": stranded,
            "soft-terms": soft_terms,
            "custom-topology-key": custom_topology_key}


UNSUPPORTED = _unsupported_inputs()


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_inputs_raise(name):
    """The inputs slice 1 refused: zone spread, stranded pods and custom
    topology keys (slice 2a), gangs and priority bands (slice 2b) and soft
    terms (slice 2c, the relaxation loop) now solve to the reference's
    answer."""
    build = UNSUPPORTED[name]
    port, ref_solver = TorchSolver(device="cpu"), jax_solver()
    got = port.solve(build(PORT))
    assert canon(got) == canon(ref_solver.solve(build(JAX)))
    assert port._used_split == ref_solver._used_split
    if name in ("zone-spread", "stranded", "custom-topology-key"):
        assert port._used_split == (name != "zone-spread")


def test_headline_50k_matches_reference():
    """The 50k headline: 782 nodes, none unschedulable, the JAX package's
    price to the bit."""
    ref = jax_solver().solve(headline(JAX, 50_000))
    port = TorchSolver(device="cpu")
    got = port.solve(headline(PORT, 50_000))
    assert got.node_count() == 782 and not got.unschedulable
    assert float(got.total_price()).hex() == "0x1.c192b9cb6848bp+12"
    assert canon(got) == canon(ref)
    assert np.isfinite([c.price for c in got.new_claims]).all()
