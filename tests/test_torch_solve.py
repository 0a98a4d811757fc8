"""TorchSolver(device="cpu") against the JAX package's TPUSolver.

The same scheduling input, built once with each package's classes, must
solve to the same canonical result: the claims (pool, pods, ranked
instance types, price as a float hex), the existing-node assignments and
the unschedulable pods with their reason codes.  Inputs the port does
not run yet must raise UnsupportedPods, never return a result.
"""

import numpy as np
import pytest

from karpenter_tpu.solver import TPUSolver
from karpenter_tpu_torch.solver import TorchSolver, UnsupportedPods
from karpenter_tpu_torch.solver import ffd as tffd
from tests.test_torch_encode import JAX, PORT, scenario


def canon(res):
    return (sorted((c.nodepool, tuple(sorted(p.meta.name for p in c.pods)),
                    tuple(c.instance_type_names), float(c.price).hex())
                   for c in res.new_claims),
            sorted(res.existing_assignments.items()),
            sorted((k, getattr(v, "code", None))
                   for k, v in res.unschedulable.items()),
            float(res.total_price()).hex())


def headline(ns, n):
    """The headline workload (bench.py build_input) at n pods."""
    M = ns.M
    catalog = ns.prov.generate_catalog()
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


def test_warm_solve_with_compaction_matches_reference():
    """The second solve of a solver warm-starts the node axis and the
    take_new compaction (sparse_n > 0)."""
    jax_s, port = jax_solver(), TorchSolver(device="cpu")
    jinp, tinp = headline(JAX, 240), headline(PORT, 240)
    assert canon(port.solve(tinp)) == canon(jax_s.solve(jinp))
    assert port._pick_sparse_n(port._adaptive_max_nodes()) > 0
    assert canon(port.solve(tinp)) == canon(jax_s.solve(jinp))


def test_compaction_overflow_reruns_dense(monkeypatch):
    """A take_new compaction too small for the solve is detected by the
    pack's nonzero count and the solve re-runs dense."""
    calls = []
    real = tffd.solve_ffd

    def spy(prob, cat, max_nodes, sparse_n=0, explain=0):
        calls.append(sparse_n)
        return real(prob, cat, max_nodes, sparse_n=sparse_n,
                    explain=explain)

    monkeypatch.setattr(tffd, "solve_ffd", spy)
    port = TorchSolver(device="cpu")
    port._last_new_segments = 1        # fan-out estimate far too low
    port._last_active = 30
    got = port.solve(headline(PORT, 3000))
    assert calls[0] > 0 and calls[1:] == [0]
    assert canon(got) == canon(jax_solver().solve(headline(JAX, 3000)))


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
    M = PORT.M
    wk = M.wellknown

    def zone_spread():
        return scenario(PORT, "zone-spread")

    def gang():
        inp = headline(PORT, 40)
        for p in inp.pods[:4]:
            p.meta.annotations.update({wk.GANG_NAME_ANNOTATION: "g1",
                                       wk.GANG_SIZE_ANNOTATION: "4"})
        return inp

    def priority_bands():
        inp = headline(PORT, 40)
        for p in inp.pods[:10]:
            p.meta.annotations[wk.PRIORITY_ANNOTATION] = "100"
        return inp

    def stranded():
        inp = headline(PORT, 200)
        inp.remaining_limits = {"default": M.Resources.parse({"cpu": "4"})}
        return inp

    def soft_terms():
        inp = headline(PORT, 40)
        inp.pods[0].preferences = [(10, M.Requirements(M.Requirement.make(
            wk.ZONE_LABEL, "In", "tpu-west-1a")))]
        return inp

    def custom_topology_key():
        inp = headline(PORT, 40)
        for p in inp.pods[:3]:
            p.meta.labels["app"] = "c"
            p.topology_spread = [M.TopologySpreadConstraint(
                topology_key="example.com/rack", max_skew=1,
                label_selector={"app": "c"})]
        return inp

    return {"zone-spread": (zone_spread, "heavy"),
            "gang": (gang, "gang"),
            "priority-bands": (priority_bands, "priority"),
            "stranded": (stranded, "stranded"),
            "soft-terms": (soft_terms, "relaxation"),
            "custom-topology-key": (custom_topology_key, "split")}


UNSUPPORTED = _unsupported_inputs()


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_inputs_raise(name):
    build, match = UNSUPPORTED[name]
    with pytest.raises(UnsupportedPods, match=match):
        TorchSolver(device="cpu").solve(build())


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
